"""mfu: the whole step's share of the card's peak in the cell's precision
(67 TFLOP/s f32 without TF32, 989 bf16): the benchmark's count of every
convolution, GEMM and attention product per unit of work, times the
units, over the seconds of the window's requests that come after the
traced ones (the host's clock). Those run without the profiler, whose
cost on the host would otherwise count as the step's."""
from portbench import counting


def read(run):
    c, w = run.counts, run.window
    if run.trace is None or c is None:
        return None
    seconds = sum(w.request_s[run.traced_requests:])
    work = w.work - run.traced_work
    if work <= 0 or seconds <= 0:
        return None
    return 100.0 * c.flops() * work / (seconds * counting.PEAK_FLOPS[run.dtype])
