"""The share of the traced slice, in %, in which nothing ran on the device
while the host was inside one of the program's root spans (a call into the
facade or a transform): the gaps of ``idle_share.batch`` against the union
of the program's root spans, on the profiler's clock
(``benchmark/program_spans.py``). The rest of the idle time is the
harness's own."""
from benchmark import program_spans


def read(run):
    return program_spans.idle_in_program(run)
