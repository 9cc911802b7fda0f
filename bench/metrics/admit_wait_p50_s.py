"""admit_wait_p50_s: the median, over every request due in the window, of
the time until the scheduler admits it (its begin_prefill call) less its
due time; one not admitted by the window's end counts at its age then.
Layer: the scheduler (core/scheduler.py)."""
import math

from bench.lib.record import percentile


def read(run, name):
    end = run.window[1]
    return percentile([(r.admit if not math.isnan(r.admit)
                        and r.admit <= end else end) - r.due
                       for r in run.due_in_window()], 50)
