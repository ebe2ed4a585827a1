"""Median over the traced slice's ``ssq_cwt`` calls of the host-to-device
copies the program made in each: the change of its ``upload.calls`` counter
over each root (``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_root_count(run, "ssq_cwt", "upload.calls")
