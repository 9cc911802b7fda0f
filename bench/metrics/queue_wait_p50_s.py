"""queue_wait_p50_s: the median, over every request the program's
scheduler stamped as arriving in the window (``Request.arrival_s``, at
submit), of its wait to admission (``admitted_s``, the first
begin_prefill); one not admitted by the window's end counts at its age
then. Unlike admit_wait_p50_s it leaves out the harness's release delay.
Layer: the scheduler (core/scheduler.py)."""
from bench.lib.program_trace import stamp_waits
from bench.lib.record import percentile


def read(run, name):
    waits = stamp_waits(run, "admitted_s")
    return None if waits is None else percentile(waits, 50)
