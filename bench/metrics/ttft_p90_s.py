"""ttft_p90_s: the 90th percentile, over every request due in the window,
of the time of its first branch token less its due time; a request with
no token by the window's end counts at its age then."""
import math

from bench.lib.record import percentile


def read(run, name):
    end = run.window[1]
    return percentile([(r.first_token if not math.isnan(r.first_token)
                        and r.first_token <= end else end) - r.due
                       for r in run.due_in_window()], 90)
