"""sort_s: the measured window (first sort's start to last sort's end) over the sorts completed in it."""


def read(run):
    w = run.window
    return w["seconds"] / w["sorts"] if w and w["sorts"] else None
