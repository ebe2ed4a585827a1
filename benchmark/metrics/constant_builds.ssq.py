"""Times the traced slice's ``ssq_cwt`` calls built their device constants
(the stacked bank, the grids, the weights): the changes of the program's
``ssq.constant_builds`` counter over each root, summed; 0 once set-up has
warmed the cell (``benchmark/program_spans.py``)."""
from benchmark import program_spans


def read(run):
    spans = program_spans.records(run)
    if spans is None:
        return None
    roots = [s for s in spans if s.parent is None and s.name == "ssq_cwt"]
    return sum(s.counts.get("ssq.constant_builds", 0) for s in roots) if roots else None
