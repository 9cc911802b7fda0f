"""Arrival generators, one file per kind, found by the ``arrivals.kind`` of
a cell's workload file; ``prompts.py`` makes the requests they send."""
