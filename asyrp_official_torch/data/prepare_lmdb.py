"""Multi-resolution LMDB builder — the port of the JAX package's
`data/prepare_lmdb.py` (the reference's utils/prepare_lmdb_data.py,
stylegan2 layout: keys '{res}-{idx:05d}' + 'length'), which
`data/datasets.py` `CelebAHQLMDB` reads. `lmdb` is imported only when
`prepare` runs; JPEG encoding runs in a process pool.

    python -m asyrp_official_torch.data.prepare_lmdb --out DB --path IMAGES
"""
from __future__ import annotations

import argparse
import io
import os
from functools import partial
import multiprocessing
from typing import List, Sequence

from PIL import Image

__all__ = ["prepare", "resize_and_encode"]


def resize_and_encode(
    path: str, sizes: Sequence[int] = (128, 256, 512, 1024), quality: int = 100
) -> List[bytes]:
    img = Image.open(path).convert("RGB")
    out = []
    for size in sizes:
        resized = img.resize((size, size), Image.LANCZOS)
        buf = io.BytesIO()
        resized.save(buf, format="jpeg", quality=quality)
        out.append(buf.getvalue())
    return out


def prepare(
    out_path: str,
    image_dir: str,
    *,
    n_worker: int = 8,
    sizes: Sequence[int] = (128, 256, 512, 1024),
    map_size: int = 1024 ** 4,
) -> int:
    try:
        import lmdb
    except ImportError as e:
        raise ImportError("LMDB preparation requires the `lmdb` package") from e

    files = sorted(
        os.path.join(image_dir, f)
        for f in os.listdir(image_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
    )
    with lmdb.open(out_path, map_size=map_size, readahead=False) as env:
        with multiprocessing.get_context("spawn").Pool(n_worker) as pool:
            worker = partial(resize_and_encode, sizes=sizes)
            for i, blobs in enumerate(pool.imap(worker, files)):
                with env.begin(write=True) as txn:
                    for size, blob in zip(sizes, blobs):
                        key = f"{size}-{str(i).zfill(5)}".encode()
                        txn.put(key, blob)
        with env.begin(write=True) as txn:
            txn.put(b"length", str(len(files)).encode())
    return len(files)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--path", required=True)
    ap.add_argument("--n_worker", type=int, default=8)
    ap.add_argument("--size", type=str, default="128,256,512,1024")
    a = ap.parse_args()
    n = prepare(
        a.out, a.path, n_worker=a.n_worker,
        sizes=[int(s) for s in a.size.split(",")],
    )
    print(f"wrote {n} images")
