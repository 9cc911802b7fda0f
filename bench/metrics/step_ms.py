"""step_ms.<serve|batch>: the mean wall time of Engine.decode_step over the
window (the host clock around the call, which ends in its one sync):
the engine step, serving/engine.py and serving/step_graph.py."""


def read(run, name):
    steps = run.window_steps()
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
