"""samples_per_s: the camera samples of every unit of work the window
completed, over the window's time (host clock, each unit ending in a
synchronisation)."""


def read(run):
    return run.samples / run.window_s
