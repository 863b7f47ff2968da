"""Datasets — the port's copy of the readers of the JAX package's
`data/datasets.py` (PIL + numpy, NHWC float32 images in [-1, 1]):

  * ImageFolderDataset — a folder of images in directory-listing order,
    resized to (S, S) bilinear (the CUSTOM category; FFHQ and MetFACE, the
    last 500 files their test split);
  * AFHQDataset — `{root}/{mode}/dog/*.png`;
  * CelebAHQLMDB / LSUNLMDB — stylegan2-layout LMDB readers (need the
    `lmdb` package);
  * CelebADialogDataset — paired images by attribute intensity;
  * ImageNetDataset — one class's `{root}/{mode}/{wnid}/{wnid}/*` images
    (`--target_class_num`), the ADM preprocessing: BOX halvings, then
    BICUBIC, then a random (Python `random`) or center crop.
"""
from __future__ import annotations

import json
import math
import os
import random
from glob import glob
from io import BytesIO
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from asyrp_official_torch.utils.assets import ASSETS_DIR

__all__ = ["ImageFolderDataset", "AFHQDataset", "ImageNetDataset", "CelebAHQLMDB", "LSUNLMDB",
           "CelebADialogDataset", "get_dataset", "imagenet_classes", "center_crop_arr",
           "random_crop_arr"]


def imagenet_classes() -> Dict[str, Tuple[str, str]]:
    """Class number (a string) -> (wnid, class name), from the port's copy
    of `assets/imagenet_classes.json`."""
    with open(os.path.join(ASSETS_DIR, "imagenet_classes.json")) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


def _to_pm1(img: Image.Image) -> np.ndarray:
    return np.asarray(img.convert("RGB"), np.float32) / 127.5 - 1.0


class ImageFolderDataset:
    def __init__(self, img_dir: str, image_size: int = 256, test_nums: Optional[int] = None,
                 train: bool = True, resample=Image.BILINEAR):
        self.img_dir = img_dir
        files = os.listdir(img_dir)
        if test_nums is not None:
            files = files[:-test_nums] if train else files[-test_nums:]
        self.files = files
        self.image_size = image_size
        self.resample = resample

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx) -> np.ndarray:
        img = Image.open(os.path.join(self.img_dir, self.files[idx]))
        # torchvision Resize((S, S)) is bilinear
        img = img.convert("RGB").resize((self.image_size, self.image_size), self.resample)
        return _to_pm1(img)


class AFHQDataset:
    def __init__(self, root: str, mode: str = "train", animal_class: str = "dog",
                 image_size: int = 256):
        self.paths = glob(os.path.join(root, mode, animal_class, "*.png"))
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx) -> np.ndarray:
        img = Image.open(self.paths[idx]).resize((self.image_size, self.image_size))
        return _to_pm1(img)


def center_crop_arr(pil_image: Image.Image, image_size: int) -> np.ndarray:
    """BOX-downsample by powers of two then BICUBIC, center crop
    (datasets/IMAGENET_dataset.py:69-86 — the ADM preprocessing)."""
    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX
        )
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC
    )
    arr = np.array(pil_image)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy : cy + image_size, cx : cx + image_size]


def random_crop_arr(
    pil_image: Image.Image, image_size: int, min_crop_frac=0.8, max_crop_frac=1.0
) -> np.ndarray:
    min_dim = math.ceil(image_size / max_crop_frac)
    max_dim = math.ceil(image_size / min_crop_frac)
    dim = random.randrange(min_dim, max_dim + 1)
    while min(*pil_image.size) >= 2 * dim:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX
        )
    scale = dim / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC
    )
    arr = np.array(pil_image)
    cy = random.randrange(arr.shape[0] - image_size + 1)
    cx = random.randrange(arr.shape[1] - image_size + 1)
    return arr[cy : cy + image_size, cx : cx + image_size]


class ImageNetDataset:
    """One class of an ImageNet tree, `{root}/{mode}/{wnid}/{wnid}/*.jpeg`
    for train and `*.JPEG` otherwise, sorted; a random crop (from Python's
    `random`, which the CLI seeds with --seed) or a center crop, an optional
    random horizontal flip."""

    def __init__(self, root: str, mode: str = "val", class_num: Optional[int] = None,
                 image_size: int = 256, random_crop: bool = True, random_flip: bool = False):
        if class_num is None:
            raise ValueError("class_num is required (reference exits without it)")
        wnid = imagenet_classes()[str(class_num)][0]
        pat = os.path.join(root, mode, wnid, wnid, "*.jpeg" if mode == "train" else "*.JPEG")
        self.paths = sorted(glob(pat))
        self.image_size = image_size
        self.random_crop = random_crop
        self.random_flip = random_flip

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx) -> np.ndarray:
        img = Image.open(self.paths[idx])
        img.load()
        img = img.convert("RGB")
        arr = (random_crop_arr(img, self.image_size) if self.random_crop
               else center_crop_arr(img, self.image_size))
        if self.random_flip and random.random() < 0.5:
            arr = arr[:, ::-1]
        return arr.astype(np.float32) / 127.5 - 1.0


def _open_lmdb(path: str, max_readers: int):
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(f"reading the LMDB at {path} requires the `lmdb` package") from e
    return lmdb.open(path, max_readers=max_readers, readonly=True, lock=False,
                     readahead=False, meminit=False)


class CelebAHQLMDB:
    """stylegan2 multi-resolution LMDB (keys '{res}-{idx:05d}', 'length')."""

    def __init__(self, path: str, image_size: int = 256):
        self.env = _open_lmdb(path, 32)
        self.path = path
        with self.env.begin(write=False) as txn:
            raw = txn.get(b"length")
        if raw is None:
            raise ValueError(f"{path}: no 'length' key — not a stylegan2-layout LMDB")
        self.length = int(raw.decode())
        self.image_size = image_size

    def close(self):
        if self.env is not None:
            self.env.close()
            self.env = None

    def __len__(self):
        return self.length

    def __getitem__(self, idx) -> np.ndarray:
        key = f"{self.image_size}-{str(idx).zfill(5)}".encode()
        with self.env.begin(write=False) as txn:
            img_bytes = txn.get(key)
        if img_bytes is None:
            raise KeyError(f"{self.path}: no image at resolution {self.image_size} "
                           f"(key {key.decode()!r})")
        return _to_pm1(Image.open(BytesIO(img_bytes)))


class LSUNLMDB:
    """LSUN LMDB (webp blobs keyed by hash): resize the short side to S
    (bilinear), then centre-crop S."""

    def __init__(self, path: str, image_size: int = 256):
        self.env = _open_lmdb(path, 1)
        with self.env.begin(write=False) as txn:
            self.length = txn.stat()["entries"]
            self.keys = [k for k in txn.cursor().iternext(keys=True, values=False)]
        self.image_size = image_size

    def close(self):
        if self.env is not None:
            self.env.close()
            self.env = None

    def __len__(self):
        return self.length

    def __getitem__(self, idx) -> np.ndarray:
        with self.env.begin(write=False) as txn:
            img_bytes = txn.get(self.keys[idx])
        img = Image.open(BytesIO(img_bytes)).convert("RGB")
        w, h = img.size
        size = self.image_size
        scale = size / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        return _to_pm1(img.crop((left, top, left + size, top + size)))


def _read_attr_list(path: str, columns: Sequence[str]):
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= len(columns):
                rows.append({c: (parts[i] if i == 0 else int(parts[i])) for i, c in enumerate(columns)})
    return rows


DIALOG_COLUMNS = ("file_name", "Bangs", "Eyeglasses", "No_Beard", "Smiling", "Young")


class CelebADialogDataset:
    """Pairs (attr == 0, attr == 5) images for one attribute, from
    `{root}/train_attr_list.txt` (or `val_attr_list.txt`)."""

    def __init__(self, root: str, train: bool = True, guid: str = "Young", image_size: int = 256,
                 attr_list_path: Optional[str] = None):
        name = "train_attr_list.txt" if train else "val_attr_list.txt"
        rows = _read_attr_list(attr_list_path or os.path.join(root, name), DIALOG_COLUMNS)
        zeros = [r for r in rows if r[guid] == 0]
        fives = [r for r in rows if r[guid] == 5]
        self.min_num = min(len(zeros), len(fives))
        self.zeros = zeros[: self.min_num]
        self.fives = fives[: self.min_num]
        self.root = root
        self.image_size = image_size

    def __len__(self):
        return self.min_num

    def _load(self, fname: str) -> np.ndarray:
        img = Image.open(os.path.join(self.root, fname))
        return _to_pm1(img.convert("RGB").resize((self.image_size, self.image_size), Image.BILINEAR))

    def __getitem__(self, idx):
        return self._load(self.zeros[idx]["file_name"]), self._load(self.fives[idx]["file_name"])


def get_dataset(dataset_type: str, dataset_paths: Dict[str, str], *, category: str = "",
                image_size: int = 256, target_class_num: Optional[int] = None):
    """Returns (train_dataset, test_dataset)."""
    if category == "CUSTOM":
        return (ImageFolderDataset(dataset_paths["custom_train"], image_size),
                ImageFolderDataset(dataset_paths["custom_test"], image_size))
    if dataset_type == "AFHQ":
        root = dataset_paths["AFHQ"]
        return (AFHQDataset(root, "train", "dog", image_size),
                AFHQDataset(root, "test", "dog", image_size))
    if dataset_type == "LSUN":
        root = dataset_paths["LSUN"]
        return (LSUNLMDB(os.path.join(root, f"{category}_train_lmdb"), image_size),
                LSUNLMDB(os.path.join(root, f"{category}_val_lmdb"), image_size))
    if dataset_type == "CelebA_HQ":
        root = dataset_paths["CelebA_HQ"]
        return (CelebAHQLMDB(os.path.join(root, "LMDB_train"), image_size),
                CelebAHQLMDB(os.path.join(root, "LMDB_test"), image_size))
    if dataset_type == "CelebA_HQ_Dialog":
        root = dataset_paths["CelebA_HQ_Dialog"]
        val = os.path.exists(os.path.join(root, "val_attr_list.txt"))
        return (CelebADialogDataset(root, train=True, image_size=image_size),
                CelebADialogDataset(root, train=False, image_size=image_size) if val else None)
    if dataset_type == "IMAGENET":
        root = dataset_paths["IMAGENET"]
        return (ImageNetDataset(root, "train", target_class_num, image_size),
                ImageNetDataset(root, "val", target_class_num, image_size))
    if dataset_type in ("MetFACE", "FFHQ"):
        d = dataset_paths[dataset_type]
        if dataset_type == "MetFACE":
            d = os.path.join(d, "images")
        return (ImageFolderDataset(d, image_size, test_nums=500, train=True),
                ImageFolderDataset(d, image_size, test_nums=500, train=False))
    raise ValueError(f"unknown dataset type {dataset_type}")
