"""first_branch_p90_s: the 90th percentile, on queue_wait_p50_s's basis,
of the time from a request's arrival at the scheduler to its first
seated branch (``Request.first_branch_s``, its first token sampled).
Layer: the scheduler (core/scheduler.py)."""
from bench.lib.program_trace import stamp_waits
from bench.lib.record import percentile


def read(run, name):
    waits = stamp_waits(run, "first_branch_s")
    return None if waits is None else percentile(waits, 90)
