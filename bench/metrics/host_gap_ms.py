"""host_gap_ms.<serve|batch>: the mean wall gap from the end of one
decode_step to the start of the next over the window (what the
scheduler, the PRM and the bookkeeping take on the host between steps).
"""


def read(run, name):
    steps = run.window_steps()
    gaps = [b.t0 - a.t1 for a, b in zip(steps, steps[1:])]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
