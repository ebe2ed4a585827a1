"""Host us a request in the fast wavelet transform's 2D calls: the median
over the traced slice's ``fwt2d`` roots of their us plus the same over its
``ifwt2d`` roots (each the whole call: the route's rule, its two axis
passes and their launches; ``benchmark/program_spans.py``); None for a
program that records no such roots."""
import statistics

from benchmark import program_spans


def read(run):
    spans = program_spans.records(run)
    if spans is None:
        return None
    us = {name: [s.end - s.start for s in spans if s.parent is None and s.name == name]
          for name in ("fwt2d", "ifwt2d")}
    if not all(us.values()):
        return None
    return sum(statistics.median(v) for v in us.values())
