"""The sliding cell's reading of ``idle_in_program.batch``: the same reader, a
file of its own so that the metric has its own name and ``moves``."""
from benchmark import harness

read = harness.load_reader("per_layer", "idle_in_program.batch").read
