"""Profiling and timing helpers.

The reference has no product tracing, only test-side System.nanoTime
wrappers (PerformanceTestUtils.java:72-140). This module gives the port's
observability: a torch.profiler trace of host and card activity written as
a Chrome trace, and a timer that waits for the card after every call (torch
returns before the card has finished).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


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
