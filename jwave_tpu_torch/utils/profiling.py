"""Profiling and timing helpers.

The reference has no product tracing, only test-side System.nanoTime
wrappers (PerformanceTestUtils.java:72-140). This module gives the port's
observability: a torch.profiler trace of host and card activity written as
a Chrome trace, a timer that waits for the card after every call (torch
returns before the card has finished), and :func:`median_ms`, the card's
time of a call between CUDA events with a cold L2 cache.

The port's own spans and counters live here too. :func:`span` marks a layer
boundary (the facade, the transforms, the ndim passes, the sliding update,
each kernel launch). While a torch profiler records, a span is a
:class:`SpanRecord` stamped with ``time.time_ns()``, the clock of the
profiler's Chrome trace (its ``ts`` in us is ``(t_ns -
baseTimeNanoseconds) / 1000``); :func:`trace` writes the spans of its run
into its Chrome trace as ``jw.<name>`` annotations beside the kernels they
launched. Otherwise a span is one shared null context: no clock read, no
record. :func:`count` adds to named counters, always on; :func:`counts`
gives them with the kernels' launch counts.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

#: bytes written before each timed run of :func:`median_ms`: more than the
#: H100's 50 MB L2, so that each run starts cold, as with fresh data
FLUSH_BYTES = 128 * 2**20
#: cycles of the GPU spin before each device-timed run, ~5 ms on an H100
SPIN_CYCLES = 10_000_000
#: span records the buffer holds; later ones are dropped and counted as
#: ``spans.dropped``
SPAN_CAP = 2**20


class SpanRecord(NamedTuple):
    """One span of the port, recorded while a profiler recorded."""
    name: str
    parent: str | None  # the enclosing span's name; None for a root
    request: int  # a root's number, shared by every span inside it
    start_ns: int  # time.time_ns() on entering and on leaving
    end_ns: int
    args: dict
    counts: dict  # a root's nonzero counter changes over its life; {} below a root


#: counter name -> value; the upload counters are always listed
_COUNTS: dict = {"upload.calls": 0, "upload.bytes": 0}
#: the fields of every span recorded, flat, seven a span, with None for an
#: empty ``args`` or ``counts``: each object a record keeps counts towards the
#: garbage collector's next pass, and a tuple and two dicts a span set off a
#: full collection more in a traced slice, which stalled the host 30-66 ms
#: (PERF.md)
_SPANS: list = []
_FIELDS = len(SpanRecord._fields)
_OFF = contextlib.nullcontext()
_OPEN = threading.local()  # .stack: the spans open in this thread
_REQUESTS = itertools.count(1)
_recording = torch._C._autograd._profiler_enabled


def span(name: str, **args):
    """A context for one span of the port: while a torch profiler records, a
    :class:`SpanRecord` (with ``args``); otherwise one shared null context.
    It opens no profiler event: under a profiler of the card one costs the
    host more than the span itself (PERF.md)."""
    if not _recording():
        return _OFF
    return _Span(name, args)


def spanned(name: str):
    """Decorator: each call of the function is one :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Span:
    __slots__ = ("name", "args", "parent", "request", "before", "start")

    def __init__(self, name, args):
        self.name, self.args = name, args or None

    def __enter__(self):
        try:
            stack = _OPEN.stack
        except AttributeError:
            stack = _OPEN.stack = []
        if stack:
            top = stack[-1]
            self.parent, self.request, self.before = top.name, top.request, None
        else:
            self.parent, self.request = None, next(_REQUESTS)
            self.before = dict(_COUNTS), _launch_counts()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.stack.pop()
        changed = None
        if self.before is not None:
            registry, launches = self.before
            changed = {k: v - registry.get(k, 0) for k, v in _COUNTS.items()
                       if v != registry.get(k, 0)}
            changed.update((f"launch.{k}", v - launches[k])
                           for k, v in _launch_counts().items() if v != launches[k])
            changed = changed or None
        if len(_SPANS) < SPAN_CAP * _FIELDS:
            _SPANS.extend((self.name, self.parent, self.request, self.start, end, self.args,
                           changed))
        else:
            count("spans.dropped")
        return False


def spans() -> list[SpanRecord]:
    """The recorded spans, oldest first (a span is recorded when it ends, so
    a parent follows its children); reading leaves them in place."""
    return [SpanRecord(name, parent, request, start, end, args or {}, changed or {})
            for name, parent, request, start, end, args, changed
            in zip(*(iter(_SPANS),) * _FIELDS)]


def reset_spans():
    """Empty the span buffer."""
    _SPANS.clear()


def count(name: str, n=1):
    """Add ``n`` to counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


@functools.cache
def _ops():
    from .. import ops  # imported at first use: ops imports this module

    return ops


def _launch_counts() -> dict:
    return _ops().launch_counts()


def counts() -> dict:
    """The counters with the launch counts of K1-K9 as ``launch.K1`` ...:
    ``upload.calls``/``upload.bytes`` (host-to-device copies the port makes
    from host memory), ``library.<name>.load_s`` (a kernel library's first
    load in the process: hash, ``nvcc`` if it ran, dlopen),
    ``K1.whole_row_launches``/``K2.whole_row_launches`` (the launches of K1
    and K2 that keep whole rows in a block), ``ssq.chunks`` (the chunks of
    rows ``ssq_cwt`` ran), ``ssq.constant_builds``/``cwt.constant_builds``
    (device constants built on a cache miss) and ``spans.dropped``."""
    out = dict(_COUNTS)
    out.update((f"launch.{k}", v) for k, v in _launch_counts().items())
    return out


def reset_counts():
    """Set every counter and launch count to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0
    _ops().reset_launch_counts()


def count_upload(t: torch.Tensor) -> torch.Tensor:
    """Count ``t`` as an upload where it landed on a card; returns it."""
    if t.is_cuda:
        _COUNTS["upload.calls"] += 1
        _COUNTS["upload.bytes"] += t.numel() * t.element_size()
    return t


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code with torch.profiler: host operators always,
    CUDA kernels and copies when a card is in use. On exit the card is
    synchronised and a Chrome trace (``trace.json``, for chrome://tracing or
    Perfetto) is written into ``log_dir``, the port's spans of the run in it
    as ``jw.<name>`` annotations; the profile is yielded for
    ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(_SPANS) // _FIELDS
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _wait()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _annotate(path, spans()[first:])


def _annotate(path: str, records: list):
    """Add span ``records`` to the Chrome trace at ``path`` as ``jw.<name>``
    user annotations of this thread, on the trace's clock."""
    if not records:
        return
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds")
    if base is None:  # Kineto's base: the Unix time rounded down to 7,889,238 s
        period = 7_889_238 * 10**9
        base = records[0].start_ns // period * period
    pid, tid = os.getpid(), threading.get_native_id()
    data["traceEvents"].extend(
        {"ph": "X", "cat": "user_annotation", "name": "jw." + name, "pid": pid, "tid": tid,
         "ts": (start - base) / 1e3, "dur": (end - start) / 1e3, "args": {**args, **changed}}
        for name, _, _, start, end, args, changed in records)
    with open(path, "w") as f:
        json.dump(data, f)


def _wait():
    """Wait for the card once CUDA is in use (torch returns before the card
    has finished); on the CPU there is nothing to wait for."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Mean seconds per call of ``fn(*args)``, waiting for the card after each
    call."""
    for _ in range(warmup):
        fn(*args)
        _wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        _wait()
    return (time.perf_counter() - t0) / iters


def throughput(fn, *args, samples: int, **kw) -> float:
    """Msamples/s for a transform processing ``samples`` per call."""
    return samples / time_fn(fn, *args, **kw) / 1e6


def median_ms(fn, reps: int = 25, device: bool = False, card: bool = True) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, after three warm-up
    runs.

    On the card (``card``), each run is timed between two CUDA events after
    :data:`FLUSH_BYTES` are written. With ``device``, a ~5 ms GPU spin after
    the flush lets the host enqueue fn's launches (an autograd backward's
    too) before the first event, so the interval is device time alone: for a
    call that enqueues in under ~5 ms and never waits for the stream. Without
    it, a host slower than the flush shows up in the interval (wall time).
    With ``card=False`` the runs are timed by the host clock
    (``time.perf_counter``) and ``device`` changes nothing: that is a time of
    the CPU, not of a card."""
    for _ in range(3):
        fn()
    if not card:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.fill_(1.0)
        if device:
            torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))
