"""Median host time of a request's calls into the program, in us: the
benchmark's own host-clock span around them in the measured window of the
traced run (the profiler off); a read-back to the host is not in it."""
import statistics


def read(run):
    return statistics.median(run.host_s) * 1e6 if run.host_s else None
