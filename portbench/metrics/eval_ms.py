"""eval_ms: the mean device time of one UNet eval without an edit (an
`asyrp.eval` span, the program's own, at the cell's batch), in ms."""
from portbench import spans


def read(run):
    rec = spans.recorded(run)
    return None if rec is None else spans.eval_ms(rec[0], edited=False)
