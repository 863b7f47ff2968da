"""weight_casts_per_image: conv and linear weights converted to the
activation dtype at use (the program's `weight_casts` counter) over the
images of the traced requests."""
from portbench import spans


def read(run):
    rec = spans.recorded(run)
    if rec is None or run.unit != "image" or run.traced_work <= 0:
        return None
    return rec[1].get(spans.WEIGHT_CASTS, 0) / run.traced_work
