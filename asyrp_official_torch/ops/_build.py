"""Build and load the hand-written CUDA kernels in `csrc/`.

Route: `nvcc` compiles each `csrc/<name>.cu` (plain C entry points, no
PyTorch headers) into a shared library for `sm_90a`, which `ctypes` loads.
The build runs at first use, in the calling process, into `csrc/build/`
(listed in `.gitignore`); the library name carries a hash of its source, so
an edited kernel is rebuilt and a stale one is never loaded.

Each C entry point takes device pointers and the CUDA stream as `void *`
and returns `cudaGetLastError()` after its launches; `check` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

__all__ = ["CSRC_DIR", "BUILD_DIR", "load_library", "check", "build_log"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_log(name: str) -> str:
    """What nvcc printed (`-Xptxas -v`: registers, shared memory, spills)
    for the current source of `name`, or '' if it has not been built."""
    log = _lib_path(name)[: -len(".so")] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its hashed library is missing, then load it."""
    out = _lib_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(out[: -len(".so")] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
