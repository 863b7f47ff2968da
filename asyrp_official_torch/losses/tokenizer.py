"""CLIP BPE tokenizer — the port's copy of the JAX package's
`losses/tokenizer.py` (`SimpleTokenizer`, `HashTokenizer`, `tokenize`).

Byte-level BPE over lower-cased, whitespace-cleaned text with word-boundary
`</w>` markers and SOT/EOT specials 49406/49407, as `clip.tokenize`. The
merges data (`bpe_simple_vocab_16e6.txt.gz`) is an OpenAI asset that is not
in the repository. Supply it via:
  * `vocab_path=` argument, or
  * `ASYRP_TPU_CLIP_BPE` environment variable, or
  * `asyrp_official_torch/assets/bpe_simple_vocab_16e6.txt.gz`.

Without the merges file `SimpleTokenizer` raises; `HashTokenizer` is the
explicit test-only fallback (deterministic, vocabulary-compatible shapes,
NOT CLIP-compatible semantics).
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional

import numpy as np

__all__ = ["SimpleTokenizer", "HashTokenizer", "tokenize", "default_vocab_path"]

CONTEXT_LENGTH = 77


def default_vocab_path() -> Optional[str]:
    env = os.environ.get("ASYRP_TPU_CLIP_BPE")
    if env and os.path.exists(env):
        return env
    here = os.path.join(
        os.path.dirname(__file__), "..", "assets", "bpe_simple_vocab_16e6.txt.gz"
    )
    return here if os.path.exists(here) else None


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte → printable-unicode map (avoids BPE on raw control
    bytes). Standard byte-level-BPE construction."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


try:  # CLIP's pattern uses unicode word classes — needs the regex module
    import regex as _re

    _WORD_PAT = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII fallback (non-ASCII prompts tokenize differently)
    _WORD_PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


class SimpleTokenizer:
    """Byte-level BPE with merges loaded from the OpenAI vocab file."""

    def __init__(self, vocab_path: Optional[str] = None):
        vocab_path = vocab_path or default_vocab_path()
        if vocab_path is None:
            raise FileNotFoundError(
                "CLIP BPE merges file not found; set ASYRP_TPU_CLIP_BPE or place "
                "bpe_simple_vocab_16e6.txt.gz under asyrp_official_torch/assets/"
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not word:
            return token + "</w>"

        def get_pairs(word):
            return {(a, b) for a, b in zip(word[:-1], word[1:])}

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _WORD_PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens: List[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


class HashTokenizer:
    """Deterministic test-only fallback: maps words to stable ids in
    [1000, 49000) via crc32 (process-independent — Python's built-in hash()
    is salted per interpreter). Shape-compatible with CLIP tokenization;
    NOT semantically CLIP-compatible — for tests and offline smoke runs."""

    sot = 49406
    eot = 49407

    def encode(self, text: str) -> List[int]:
        import zlib

        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        return [1000 + (zlib.crc32(w.encode()) % 48000) for w in words if w]


def tokenize(
    texts, tokenizer=None, context_length: int = CONTEXT_LENGTH
) -> np.ndarray:
    """`clip.tokenize` equivalent: [N, 77] int32 with SOT/EOT framing."""
    if isinstance(texts, str):
        texts = [texts]
    if tokenizer is None:
        try:
            tokenizer = SimpleTokenizer()
        except FileNotFoundError:
            import warnings

            warnings.warn(
                "CLIP BPE vocab unavailable — falling back to HashTokenizer "
                "(test-only semantics)", stacklevel=2
            )
            tokenizer = HashTokenizer()
    sot = getattr(tokenizer, "sot", None)
    eot = getattr(tokenizer, "eot", None)
    if sot is None:
        sot = tokenizer.encoder["<|startoftext|>"]
        eot = tokenizer.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = [sot] + tokenizer.encode(text) + [eot]
        if len(toks) > context_length:  # clip.tokenize(truncate=False) raises;
            toks = toks[: context_length - 1] + [eot]  # we truncate, keeping EOT
        out[i, : len(toks)] = toks
    return out
