"""idle_engine.<serve|batch>: the share of the traced slice in which the
device ran nothing while the innermost program span open on the host
was the engine's host work (an ``engine.*`` span other than
``engine.launch`` and ``engine.sync``); device intervals and the
program's ``record_function`` ranges by exact interval intersection."""
from bench.lib.program_trace import program


def read(run, name):
    pt = program(run)
    return None if pt is None else pt.idle_share("engine")
