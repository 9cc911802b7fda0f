"""itl_p95_ms: the 95th percentile, over every output token sampled in the
window, of the wall time since the same branch's previous token; mixed
steps and the pauses of window-boundary pruning included."""
from bench.lib.record import percentile


def read(run, name):
    v = percentile(run.itl_samples(), 95)
    return None if v is None else v * 1e3
