"""Dataset path registry — the port's copy of `DATASET_PATHS` from the JAX
package's `configs/paths.py`. Edit for your machine, or set the
ASYRP_TPU_DATA environment variable (the name the JAX package reads)."""
import os

_DATA = os.environ.get("ASYRP_TPU_DATA", "./data")

DATASET_PATHS = {
    "CelebA_HQ": f"{_DATA}/celeba_hq",
    "AFHQ": f"{_DATA}/afhq",
    "FFHQ": f"{_DATA}/ffhq",
    "LSUN": f"{_DATA}/lsun",
    "IMAGENET": f"{_DATA}/imagenet",
    "MetFACE": f"{_DATA}/metfaces",
    "CelebA_HQ_Dialog": f"{_DATA}/celeba_dialog",
    "custom_train": "./train_images",
    "custom_test": "./test_images",
}
