"""Median over the traced slice's ``wpt2d`` calls (the wavelet packet
facade's 2D forward) of the host us in their ``wpt`` spans together: each
axis pass's packet transform, its chunk schedule and its K8 launches
(``benchmark/program_spans.py``); None for a program that records no such
root."""
from benchmark import program_spans


def read(run):
    return program_spans.median_child_us(run, "wpt2d", "wpt")
