"""95th percentile latency of all requests of the window (not a median of
chunks), from a request's start to its answer on the host, in ms."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3 if run.latencies_s else None
