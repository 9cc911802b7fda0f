"""idle_sched.<serve|batch>: the share of the traced slice in which the
device ran nothing while the innermost program span open on the host
was a ``sched.*`` span (the scheduler, the PRM, pruning)."""
from bench.lib.program_trace import program


def read(run, name):
    pt = program(run)
    return None if pt is None else pt.idle_share("sched")
