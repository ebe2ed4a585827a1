"""Median over the traced slice's sliding updates of the us in the update's
``sliding.taps`` span: the conv1d filter pair made from the wavelet's taps
and put on the card (``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_child_us(run, "sliding.update", "sliding.taps")
