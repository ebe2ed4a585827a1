"""Median over the traced slice's ``Transform.forward`` calls of the volume's
axis passes that stored their output rotated, (rows, n) as (n, rows), so
that no transposing copy is left: the change of the program's
``ndim.rotated_passes`` counter over each root
(``benchmark/program_spans.py``); None for a program that lists no such
counter."""
from benchmark import program_spans

COUNTER = "ndim.rotated_passes"


def read(run):
    prof = program_spans._profiling()
    if prof is None or COUNTER not in prof.counts():
        return None
    return program_spans.median_root_count(run, "Transform.forward", COUNTER)
