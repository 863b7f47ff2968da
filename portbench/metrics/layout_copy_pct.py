"""layout_copy_pct: the share of the traced requests' kernel time spent in
cuDNN's NCHW <-> NHWC conversion kernels."""


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0:
        return None
    return 100.0 * t.family_s.get("layout", 0.0) / t.kernel_s
