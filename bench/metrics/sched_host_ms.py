"""sched_host_ms.<serve|batch>: the scheduler's host milliseconds per step
over the host window: the self time of the ``sched.*`` spans of the
program's tracer (core/: admission, polling, completions, the window's
PRM scoring and pruning, finalisation) less their ``engine.*`` and
``host.gc`` children, over the ``engine.decode_step`` spans there."""
from bench.lib.program_trace import program


def read(run, name):
    pt = program(run)
    return None if pt is None else pt.host_ms("sched", *run.host_window)
