"""Median over the traced slice's ``ssq_cwt`` calls of the host us in their
``ssq.cwt`` spans together: each chunk's FFT, product with the stacked bank
and inverse FFT (``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_child_us(run, "ssq_cwt", "ssq.cwt")
