"""edit_images_per_s: the images edited over the window's seconds (the
window ends with its last request)."""


def read(run):
    if run.unit != "image":
        return None
    return run.window.rate()
