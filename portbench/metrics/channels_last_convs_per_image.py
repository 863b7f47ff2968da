"""channels_last_convs_per_image: convolutions handed a channels-last input
(the program's `channels_last_convs` counter) over the images of the traced
requests. None where the program keeps no such counter (a commit before it
was added) or counted no such convolution."""
from portbench import spans

CHANNELS_LAST_CONVS = "channels_last_convs"


def read(run):
    rec = spans.recorded(run)
    if rec is None or run.unit != "image" or run.traced_work <= 0:
        return None
    n = rec[1].get(CHANNELS_LAST_CONVS)
    return None if n is None else n / run.traced_work
