"""dual_eval_ms: the mean device time of one edited UNet eval (an
`asyrp.eval` span with an edit: the encoder, the DeltaBlock and both
decodes, split at batch 1 and stacked above), in ms."""
from portbench import spans


def read(run):
    rec = spans.recorded(run)
    return None if rec is None else spans.eval_ms(rec[0], edited=True)
