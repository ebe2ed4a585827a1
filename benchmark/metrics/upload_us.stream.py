"""Median over the traced slice's sliding updates of the us in the update's
``sliding.upload`` span: the new samples made a tensor on the card from
the host's array (``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_child_us(run, "sliding.update", "sliding.upload")
