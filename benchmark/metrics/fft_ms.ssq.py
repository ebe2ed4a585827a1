"""Device time a request of cuFFT's kernels, in ms, from the traced slice:
every kernel whose name holds "fft" and that is not one of torch's own."""


def _is_fft(name):
    return "fft" in name.lower() and "at::native" not in name


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    seconds = run.trace.device_seconds(_is_fft)
    return seconds / run.trace.requests * 1e3 if seconds else None
