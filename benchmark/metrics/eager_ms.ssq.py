"""Device time a request of torch's eager elementwise kernels (the product
with the bank, the phase transform, the threshold and the bin index), in
ms, from the traced slice: every kernel whose name holds
"elementwise_kernel"."""


def _is_eager(name):
    return "elementwise_kernel" in name


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    seconds = run.trace.device_seconds(_is_eager)
    return seconds / run.trace.requests * 1e3 if seconds else None
