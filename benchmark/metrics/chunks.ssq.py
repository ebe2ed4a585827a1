"""Median over the traced slice's ``ssq_cwt`` calls of the chunks of rows
each ran: the change of the program's ``ssq.chunks`` counter over each root
(``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    return program_spans.median_root_count(run, "ssq_cwt", "ssq.chunks")
