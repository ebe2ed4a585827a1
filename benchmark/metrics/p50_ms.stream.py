"""Median latency of all updates of the sliding cell's window, from an
update's start to its new columns on the host, in ms. Per layer, not end
to end: from run to run of one seed it spreads by 13-17% of itself, wider
than the largest bound allows (PERF.md, section 2)."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 50)) * 1e3 if run.latencies_s else None
