"""Median over the traced slice's ``fwt2d`` calls (the fast wavelet
transform's 2D forward) of the axis passes that stored their output rotated
within each frame, (rows, n) as (n, rows), so that no transposing copy is
left: the change of the program's ``ndim.rotated_passes`` counter over each
root (``benchmark/program_spans.py``); 0 where the transform copies instead,
None for a program that lists no such counter or records no such root."""
from benchmark import program_spans

COUNTER = "ndim.rotated_passes"


def read(run):
    prof = program_spans._profiling()
    if prof is None or COUNTER not in prof.counts():
        return None
    return program_spans.median_root_count(run, "fwt2d", COUNTER)
