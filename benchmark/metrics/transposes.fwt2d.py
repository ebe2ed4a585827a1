"""Median over the traced slice's ``fwt2d`` calls (the fast wavelet
transform's 2D forward) of the transposing copies the separable ``ndim``
path made: the change of the program's ``ndim.transposes`` counter over each
root (``benchmark/program_spans.py``); None for a program that records no
such root."""
from benchmark import program_spans


def read(run):
    return program_spans.median_root_count(run, "fwt2d", "ndim.transposes")
