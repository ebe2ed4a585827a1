"""Profiling and timing helpers.

The reference has no product tracing, only test-side System.nanoTime
wrappers (PerformanceTestUtils.java:72-140). This module gives the port's
observability: a torch.profiler trace of host and card activity written as
a Chrome trace, a timer that waits for the card after every call (torch
returns before the card has finished), and :func:`median_ms`, the card's
time of a call between CUDA events with a cold L2 cache.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

#: bytes written before each timed run of :func:`median_ms`: more than the
#: H100's 50 MB L2, so that each run starts cold, as with fresh data
FLUSH_BYTES = 128 * 2**20
#: cycles of the GPU spin before each device-timed run, ~5 ms on an H100
SPIN_CYCLES = 10_000_000


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code with torch.profiler: host operators always,
    CUDA kernels and copies when a card is in use. On exit the card is
    synchronised and a Chrome trace (``trace.json``, for chrome://tracing or
    Perfetto) is written into ``log_dir``; the profile is yielded for
    ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _wait()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
