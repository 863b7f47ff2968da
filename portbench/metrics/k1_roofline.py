"""k1_roofline: GroupNorm's bytes (each input byte read once, each output
byte written once; 3n for the backward) over the time of K1's kernels
(gn_fwd, gn_bwd) at the memory rate."""
from portbench.readers import roofline_share


def read(run):
    return roofline_share(run, ("k1",), ("k1",))
