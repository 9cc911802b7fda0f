"""answer_p90_s: the 90th percentile, over every request answered in the
window, of its answer time less its due time (host clock)."""
from bench.lib.record import percentile


def read(run, name):
    a, b = run.window
    return percentile([r.answer - r.due for r in run.records
                       if a <= r.answer <= b], 90)
