"""Median over the traced slice's ``ssq_cwt`` calls of the chunks of rows
that took K6's fused form (the phase transform and the bin index inside
the kernel): the change of the program's ``ssq.fused_chunks`` counter over
each root (``benchmark/program_spans.py``); None for a program that lists
no such counter."""
from benchmark import program_spans

COUNTER = "ssq.fused_chunks"


def read(run):
    prof = program_spans._profiling()
    if prof is None or COUNTER not in prof.counts():
        return None
    return program_spans.median_root_count(run, "ssq_cwt", COUNTER)
