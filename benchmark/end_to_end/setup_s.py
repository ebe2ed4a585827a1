"""Seconds from the process's start to the window's start: imports, the
program's kernels loaded (built in a checkout's first run), the inputs
made and the cell's shapes warmed up."""


def read(run):
    return run.setup_s
