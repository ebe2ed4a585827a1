"""Input samples (or voxels) of every request completed in the window, over
the window's seconds, in millions a second."""


def read(run):
    return run.units / run.window_s / 1e6
