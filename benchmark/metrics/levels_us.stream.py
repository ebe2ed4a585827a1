"""Median over the traced slice's sliding updates of the us in the update's
``sliding.level`` spans together: each level's ``cat`` and ``conv1d``
(``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_child_us(run, "sliding.update", "sliding.level")
