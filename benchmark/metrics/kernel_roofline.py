"""The port's hand-written kernels against their roofline, in %: the least
time the card could take for the kernels' work of the traced slice's
requests (``benchmark/roofline.py``, for each kernel the cell launches in
the window by the program's launch counters and that the trace lists),
over the device time the trace gives those kernels."""
from benchmark import roofline


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    seen = {roofline.kernel_of(name) for _, _, name in run.trace.device}
    work = [(k, b, f) for k, b, f in run.kernel_work if k in seen and run.launches.get(k)]
    if not work:
        return None
    kernels = {k for k, _, _ in work}
    busy = run.trace.device_seconds(lambda name: roofline.kernel_of(name) in kernels)
    return 100.0 * sum(roofline.bound_s(b, f) for _, b, f in work) / busy
