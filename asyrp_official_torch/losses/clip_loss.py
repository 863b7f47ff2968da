"""The CLIP losses — the port of the JAX package's `losses/clip_loss.py`:
`clip_preprocess`, `CLIPContext`, the directional loss of Δ-training
(`directional_loss`, `train_clip_term`), and the global, angle, texture
(RN50 features) and patch-directional terms.

Text features never change during training: they are computed once, and
the text direction is detached. The image side is differentiable, so the
loss reaches the DeltaBlock through x0_t.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from asyrp_official_torch.losses import clip_model, clip_resnet, tokenizer as tok
from asyrp_official_torch.utils.assets import clip_templates

__all__ = ["CLIPContext", "clip_preprocess", "directional_loss", "global_loss", "angle_loss",
           "texture_loss", "patch_directional_loss", "train_clip_term"]

# CLIP normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@functools.lru_cache(maxsize=None)
def _torch_bicubic_matrix(n_in: int, n_out: int, a: float = -0.75) -> np.ndarray:
    """[n_out, n_in] matrix of `F.interpolate(mode="bicubic",
    align_corners=False)` — no antialiasing, Keys kernel a=-0.75, replicated
    borders: the tensor path of the reference's CLIP preprocess."""

    def w(t):
        at = abs(t)
        if at <= 1.0:
            return ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
        if at < 2.0:
            return a * (((at - 5.0) * at + 8.0) * at - 4.0)
        return 0.0

    scale = n_in / n_out
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        f = int(np.floor(src))
        t = src - f
        for k in range(-1, 3):
            m[i, min(max(f + k, 0), n_in - 1)] += w(t - k)
    return m.astype(np.float32)


def clip_preprocess(img, resolution: int = 224):
    """GAN-range image [B, H, W, 3] in [-1, 1] → CLIP input: to [0, 1], one
    bicubic resize of the square image (two interpolation matmuls), CLIP
    mean/std. No clamp, as the reference's tensor pipeline. Differentiable."""
    x = (img + 1.0) * 0.5
    _, h, w, _ = x.shape
    if (h, w) != (resolution, resolution):
        rh = torch.from_numpy(_torch_bicubic_matrix(h, resolution)).to(x.device, x.dtype)
        rw = torch.from_numpy(_torch_bicubic_matrix(w, resolution)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", rh, x)
        x = torch.einsum("pw,bhwc->bhpc", rw, x)
    mean = torch.from_numpy(CLIP_MEAN).to(x.device, x.dtype)
    std = torch.from_numpy(CLIP_STD).to(x.device, x.dtype)
    return (x - mean) / std


@dataclasses.dataclass
class CLIPContext:
    """A frozen CLIP module, its config and tokenizer: text features on the
    module's device, and the differentiable image encoder. A context may
    hold the RN50 tower (`clip_resnet.ModifiedResNet` and its config)
    instead, for the texture loss: it encodes images only."""

    model: Union[clip_model.CLIP, clip_resnet.ModifiedResNet]
    cfg: Union[clip_model.CLIPConfig, clip_resnet.RN50Config]
    bpe: object = None  # SimpleTokenizer | HashTokenizer | None → auto

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def tokenize(self, texts) -> torch.Tensor:
        if self.bpe is None:
            try:
                self.bpe = tok.SimpleTokenizer()
            except FileNotFoundError:
                warnings.warn("CLIP BPE vocab unavailable — falling back to HashTokenizer "
                              "(test-only semantics)", stacklevel=2)
                self.bpe = tok.HashTokenizer()
        ids = tok.tokenize(texts, self.bpe, self.cfg.context_length)
        return torch.from_numpy(ids.astype(np.int64)).to(self.device)

    @torch.no_grad()
    def encode_text(self, texts, norm: bool = True) -> torch.Tensor:
        feats = self.model.encode_text(self.tokenize(texts))
        if norm:
            feats = feats / feats.norm(dim=-1, keepdim=True)
        return feats

    def get_text_features(self, class_str: str) -> torch.Tensor:
        """Normalized features, one row per ImageNet template prompt."""
        return self.encode_text([t.format(class_str)
                                 for t in clip_templates()["imagenet_templates"]])

    def text_cosine(self, src_txts, trg_txts) -> float:
        """Cosine of the plain (template-free) source and target prompts'
        features; it scales the interval thresholds and the L1 loss."""
        fs = self.encode_text(src_txts, norm=False)
        ft = self.encode_text(trg_txts, norm=False)
        fs = fs / (fs.norm(dim=1, keepdim=True) + 1e-6)
        ft = ft / (ft.norm(dim=1, keepdim=True) + 1e-6)
        return float((fs * ft).sum(dim=1).mean())

    def compute_text_direction(self, source_class: str, target_class: str) -> torch.Tensor:
        sf = self.get_text_features(source_class)
        tf = self.get_text_features(target_class)
        d = (tf - sf).mean(dim=0, keepdim=True)
        return d / d.norm(dim=-1, keepdim=True)

    def encode_images(self, imgs, norm: bool = True):
        """Image features (normalized with `norm`), differentiable with
        respect to `imgs`; the RN50 tower's when the context holds it."""
        feats = self.model.encode_image(clip_preprocess(imgs, self.cfg.image_resolution))
        return feats / feats.norm(dim=-1, keepdim=True) if norm else feats


def directional_loss(ctx: CLIPContext, src_img, trg_img, target_direction,
                     batch_mean: Callable = torch.mean):
    """1 − cos(edit direction, text direction), mean over the batch
    (`batch_mean`: over the global batch under data parallelism,
    `parallel.mesh.Mesh.batch_mean`)."""
    edit = ctx.encode_images(trg_img) - ctx.encode_images(src_img)
    edit = edit / (edit.norm(dim=-1, keepdim=True) + 1e-7)
    return batch_mean(1.0 - (edit * target_direction).sum(dim=-1))


def global_loss(ctx: CLIPContext, img, text_features):
    """(1 − logits / 100), mean; `text_features` normalized."""
    logits = ctx.model.logit_scale.exp() * ctx.encode_images(img) @ text_features.T
    return (1.0 - logits / 100.0).mean()


def angle_loss(ctx: CLIPContext, src_img, trg_img, src_text_features, trg_text_features):
    """L1 between the image pairs' and the text pairs' cosines."""
    cos_text = trg_text_features @ src_text_features.T
    si = ctx.encode_images(src_img)[:, :, None]
    ti = ctx.encode_images(trg_img)[:, None, :]
    cos_img = (ti @ si).clamp(-1.0, 1.0)
    return (cos_img - cos_text[None]).abs().mean()


def texture_loss(ctx_cnn: CLIPContext, src_img, trg_img):
    """MSE between the unnormalized features of a context holding the RN50
    tower."""
    sf = ctx_cnn.encode_images(src_img, norm=False)
    tf = ctx_cnn.encode_images(trg_img, norm=False)
    return ((sf - tf) ** 2).mean()


def patch_directional_loss(ctx: CLIPContext, src_img, trg_img, patch_text_directions,
                           generator: Optional[torch.Generator] = None, patch_size: int = 510,
                           num_patches: int = 1, centers: Optional[Tuple] = None):
    """The directional loss on square patches, weighted by the softmax of
    the patch edits against `patch_text_directions` [K, D]. `centers=(cx,
    cy)` gives the patch centers (one per sample and patch); without them
    they are drawn from `generator` (not the JAX package's draw). A patch
    that would leave the image is moved inside it, as `dynamic_slice`
    clamps."""
    b, h, w, _ = src_img.shape
    half, n = patch_size // 2, b * num_patches
    if centers is not None:
        cx, cy = (np.asarray(c).reshape(-1).tolist() for c in centers)
    else:
        cx = torch.randint(half, w - half, (n,), generator=generator).tolist()
        cy = torch.randint(half, h - half, (n,), generator=generator).tolist()

    def grab(img):
        out = []
        for i in range(n):
            y0 = min(max(int(cy[i]) - half, 0), h - patch_size)
            x0 = min(max(int(cx[i]) - half, 0), w - patch_size)
            out.append(img[i // num_patches, y0:y0 + patch_size, x0:x0 + patch_size])
        return torch.stack(out)

    edit = ctx.encode_images(grab(trg_img)) - ctx.encode_images(grab(src_img))
    edit = edit / edit.norm(dim=-1, keepdim=True)
    cos_d = 1.0 - (edit[:, None, :] * patch_text_directions[None]).sum(-1)
    return (cos_d * torch.softmax(edit @ patch_text_directions.T, dim=-1)).mean()


def train_clip_term(ctx: CLIPContext, source_class: str, target_class: str,
                    clip_loss_w: float = 1.0, batch_mean: Callable = torch.mean) -> Callable:
    """The training loop's CLIP term clip_w · (−log((2 − L_dir) / 2)), as
    `extra(x0, x0_t, x0_t_origin)` for `pipelines.train.default_loss`. The
    term is not a mean of per-image terms (the log of a batch mean), so
    under data parallelism `batch_mean` takes the global batch's mean."""
    target_direction = ctx.compute_text_direction(source_class, target_class).detach()

    def extra(x0, x0_t, x0_t_origin=None):
        ld = directional_loss(ctx, x0, x0_t, target_direction, batch_mean)
        return clip_loss_w * (-torch.log((2.0 - ld) / 2.0))

    return extra
