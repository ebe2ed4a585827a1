"""The program's own spans and counters, for the per-layer metrics that read
them.

While a slice is traced, ``jwave_tpu_torch.utils.profiling`` records a span
at each of the program's layer boundaries: ``(name, parent, request,
start_ns, end_ns, args, counts)``, stamped with ``time.time_ns()``. A span
opened with none open is a root (``Transform.forward``, ``modwt``,
``sliding.update`` ...); it takes a new request number, which the spans
inside it share, and its ``counts`` are the counters' changes over its
life. Nothing else records, so in a ``--trace 1`` run the buffer holds the
traced slice alone. The readers reach it in the same process, through
``profiling.spans()`` and ``profiling.counts()``.

The profiler's Chrome trace runs on the same clock: an event's ``ts`` in us
is ``(t_ns - base) / 1000``, with ``base`` Kineto's, the Unix time rounded
down to a multiple of :data:`TRIMONTH_S` seconds. :func:`records` converts
the stamps so, then checks the clock: every root must lie inside the
``bench.call`` span of its request, within :data:`BRACKET_US`. Where that
fails, or where the program records no spans (an older program), the
readers return None.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import NamedTuple

#: Kineto rounds a trace's base time down to a multiple of this many seconds
TRIMONTH_S = 7_889_238
#: how far a root span may stick out of its request's ``bench.call``, in us
BRACKET_US = 20.0


class Span(NamedTuple):
    name: str
    parent: str | None
    request: int
    start: float  # us, on the trace's clock
    end: float
    args: dict
    counts: dict


def _profiling():
    """The program's tracing module, or None where it records no spans."""
    try:
        from jwave_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "counts") else None


def base_ns(t_ns: int) -> int:
    """Kineto's base time for a trace taken at Unix time ``t_ns``."""
    period = TRIMONTH_S * 10**9
    return t_ns // period * period


def convert(raw) -> list[Span]:
    """The program's span records on the trace's clock, in us."""
    if not raw:
        return []
    base = base_ns(raw[0][3])
    return [Span(n, p, q, (a - base) / 1e3, (b - base) / 1e3, args, c)
            for n, p, q, a, b, args, c in raw]


def bracketed(spans: list[Span], trace) -> bool:
    """Whether every root lies inside a ``bench.call`` of the trace (the one
    that starts last before it), within :data:`BRACKET_US`."""
    calls = sorted((a, b) for a, b, n in trace.spans if n == "call")
    starts = [a for a, _ in calls]
    roots = [s for s in spans if s.parent is None]
    if not calls or not roots:
        return False
    for s in roots:
        k = bisect.bisect_right(starts, s.start + BRACKET_US) - 1
        if k < 0:
            return False
        a, b = calls[k]
        if s.start < a - BRACKET_US or s.end > b + BRACKET_US:
            return False
    return True


def records(run) -> list[Span] | None:
    """The traced slice's program spans, converted and checked; None where
    the run was not traced, the program records none or the clock check
    fails."""
    prof = _profiling()
    if run.trace is None or prof is None:
        return None
    spans = convert(prof.spans())
    return spans if bracketed(spans, run.trace) else None


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs, ys) -> float:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_program(run) -> float | None:
    """The share of the traced slice, in %, in which the device was idle
    while the host was inside a root program span."""
    spans = records(run)
    if spans is None:
        return None
    tr = run.trace
    roots = _union((max(s.start, tr.t0), min(s.end, tr.t1))
                   for s in spans if s.parent is None and s.end > tr.t0 and s.start < tr.t1)
    return 100.0 * _overlap(tr.gaps(), roots) / (tr.t1 - tr.t0)


def median_child_us(run, root: str, child: str) -> float | None:
    """Median over ``root`` requests of the us in their ``child`` spans (0
    in a request with none)."""
    spans = records(run)
    if spans is None:
        return None
    total = {s.request: 0.0 for s in spans if s.parent is None and s.name == root}
    for s in spans:
        if s.name == child and s.request in total:
            total[s.request] += s.end - s.start
    return statistics.median(total.values()) if total else None


def median_root_count(run, root: str, counter: str) -> float | None:
    """Median over ``root`` requests of the change in ``counter`` over each."""
    spans = records(run)
    if spans is None:
        return None
    values = [s.counts.get(counter, 0) for s in spans if s.parent is None and s.name == root]
    return statistics.median(values) if values else None


def load_seconds() -> float | None:
    """Seconds of the kernel libraries' first loads in the process (the
    ``library.<name>.load_s`` counters), None where there are none."""
    prof = _profiling()
    if prof is None:
        return None
    loads = [v for k, v in prof.counts().items()
             if k.startswith("library.") and k.endswith(".load_s")]
    return float(sum(loads)) if loads else None


def idle_by_span(run, top: int = 12) -> list[list] | None:
    """Idle device seconds of the traced slice by the innermost program span
    open at the middle of each gap ("outside" where none is), as the
    harness's ``Trace.idle_by_span`` does with its own spans."""
    spans = records(run)
    if spans is None:
        return None
    ordered = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in ordered]
    width = max((s.end - s.start for s in ordered), default=0.0)
    total: dict[str, float] = defaultdict(float)
    for a, b in run.trace.gaps():
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid)
        lo = bisect.bisect_left(starts, mid - width)
        inner = None
        for s in ordered[lo:k]:
            if s.end >= mid and (inner is None or s.end - s.start < inner.end - inner.start):
                inner = s
        total[inner.name if inner else "outside"] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
