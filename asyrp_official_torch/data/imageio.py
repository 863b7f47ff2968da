"""Image grid writing — the port's copy of the JAX package's
`data/imageio.py` (torchvision `make_grid` + `save_image` layout)."""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

__all__ = ["make_grid", "save_image"]


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 1,
              pad_value: float = 0.0) -> np.ndarray:
    """images: [N, H, W, C] in [0, 1] float → [GH, GW, C] grid, nrow
    images per row."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.full((nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
                   pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return grid


def save_image(img, path: str, *, nrow: int = 8, padding: int = 1, pm1: bool = False) -> None:
    """Save a [H,W,C] image or an [N,H,W,C] batch (gridded); `pm1=True`
    reads the input as [-1, 1], else [0, 1]."""
    arr = np.asarray(img, np.float32)
    if pm1:
        arr = (arr + 1.0) * 0.5
    if arr.ndim == 4:
        arr = make_grid(arr, nrow=nrow, padding=padding)
    arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
