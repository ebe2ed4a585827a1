"""Device time a request of torch's copy kernels (``.contiguous()`` on a
transposed view), in ms, from the traced slice."""


def _is_copy(name):
    return "copy_kernel" in name


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    seconds = run.trace.device_seconds(_is_copy)
    return seconds / run.trace.requests * 1e3 if seconds else None
