"""The share of the traced slice in which nothing ran on the device, in %:
one less the union of the trace's kernels, copies and fills over the
slice's length."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
