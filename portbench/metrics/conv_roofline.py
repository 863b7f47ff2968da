"""conv_roofline: the convolutions' and GEMMs' bound over their kernels'
time (cuDNN's and cuBLAS's kernels, cuDNN's layout conversions included)."""
from portbench.readers import roofline_share


def read(run):
    return roofline_share(run, ("gemm",), ("gemm", "layout"))
