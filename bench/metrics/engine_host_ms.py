"""engine_host_ms.<serve|batch>: the engine's host milliseconds per step
over the host window: the self time of every ``engine.*`` span of the
program's tracer (serving/engine.py, serving/step_graph.py) less its
``engine.launch``, ``engine.sync`` and ``host.gc`` children, over the
``engine.decode_step`` spans there. Nothing to read without the
program's trace (bench/lib/program_trace.py)."""
from bench.lib.program_trace import program


def read(run, name):
    pt = program(run)
    return None if pt is None else pt.host_ms("engine", *run.host_window)
