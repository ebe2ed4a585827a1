"""Per-layer metric readers, one file a metric, found by its name. Each
``read(run)`` returns the metric from a run, or None where the run holds
nothing to read (the metric is then left out of the result)."""
