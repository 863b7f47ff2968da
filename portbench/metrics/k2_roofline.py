"""k2_roofline: attention's bound (the larger of its products over the
peak and its bytes over the memory rate, call by call) over the time of
K2's kernels (attn_fwd, attn_bwd)."""
from portbench.readers import roofline_share


def read(run):
    return roofline_share(run, ("k2",), ("k2",))
