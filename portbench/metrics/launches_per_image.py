"""launches_per_image: device kernels per edited image."""
from portbench.readers import kernels_per


def read(run):
    return kernels_per(run, "image")
