"""The sliding cell's reading of ``host_us.batch``: the same reader, a file of
its own so that the metric has its own name and ``moves``."""
from benchmark import harness

read = harness.load_reader("per_layer", "host_us.batch").read
