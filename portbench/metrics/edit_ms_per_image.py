"""edit_ms_per_image: the window's milliseconds over the images it edited
(the window ends with its last request)."""


def read(run):
    if run.unit != "image":
        return None
    return run.window.time_per_unit() * 1e3
