"""Median over the traced slice's ``ssq_cwt`` calls of the host us in their
``ssq.phase`` spans together: each chunk's threshold, phase transform and bin
index, queued as eager elementwise kernels (``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_child_us(run, "ssq_cwt", "ssq.phase")
