"""device_ms.<kind>.<serve|batch>: the device milliseconds per step in the
interval of ``kind`` (``attention``: K1, K3 and K2's lanes; ``head``: the
final norm, unembed and sampling; ``moe_route``: the MoE router, top-k,
dispatch and combine), from the device marks of the program's step
graphs, over the host window's steps. Nothing to read without marks (the
CPU, a program without the tracer, graphs captured with it off)."""
from bench.lib.program_trace import program


def read(run, name):
    pt = program(run)
    by_kind = None if pt is None else pt.device_ms(*run.host_window)
    return None if by_kind is None else by_kind[name.split(".")[1]]
