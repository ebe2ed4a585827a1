"""Seconds of set-up in which the program loaded its kernel libraries: the
sum of its ``library.<name>.load_s`` counters, each a library's first load
in the process (the sources' hash, ``nvcc`` where it ran, the dlopen)."""
from benchmark import program_spans


def read(run):
    return program_spans.load_seconds()
