"""Runs one cell with the program's tracer on and prints what it reads.

    python3 bench/trace_program.py --workload <cell> --seed <n> \\
        --seconds <s> [--check 1]

A ``bench/run.py --trace 1`` run (the same set-up, window and traced
slice) with ``repro_torch.spans`` enabled before the engine is built, so
the warm-up captures the step graphs with their device marks. After the
window the tracer's records and the traced slice's profiler intervals
become the run's ``program`` (``bench/lib/program_trace.py``), and the
program's per-layer readers (``PROGRAM_METRICS``) read it. The output
check is skipped unless ``--check 1``.

Standard error gets ``program notes`` (idle seconds of the traced slice
by innermost span, host ms per step by span, device ms per step by kind,
the pruned-branch share, page-pool use, collections) and ``program
checks`` (each split beside its whole); the last line of standard output
is run.py's result line with the program's metrics added under
``program``. Exits 3 without a CUDA card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the program's per-layer readers: every cell's, then ``device_ms`` of
# each device mark of the configuration's family, then the open loop's
PROGRAM_METRICS = ("engine_host_ms", "sched_host_ms", "idle_engine",
                   "idle_sched")
SERVE_ONLY = ("queue_wait_p50_s", "first_branch_p90_s")


def metric_names(cell) -> list:
    from bench.lib import spec
    serve = "itl_p95_ms" in {m["name"] for m in cell.end_to_end}
    tag = ".serve" if serve else ".batch"
    names = [m + tag for m in PROGRAM_METRICS]
    names += [f"device_ms.{k}{tag}"
              for k in spec.family_module(cell).DEVICE_MARKS]
    if serve:
        names += list(SERVE_ONLY)
    return names


def trace_cell(cell, seed: int, seconds: float, device: str,
               t_start: float, check: bool = False):
    """``run.run_cell`` with the tracer on. Returns (result line, run,
    notes, program line)."""
    from bench import run as bench_run
    from bench.lib import program_trace as pt
    from bench.lib import spec
    from bench.lib import trace as tr
    from repro_torch import spans

    kept = {}
    reduce = tr.reduce

    def reduce_keeping(prof, window_s):
        kept["intervals"] = pt.profiler_intervals(prof)
        return reduce(prof, window_s)

    spans.enable(capacity=1 << 20)
    tr.reduce = reduce_keeping
    try:
        out, run, notes = bench_run.run_cell(cell, seed, seconds, True,
                                             device, t_start, check=check)
        snap = spans.snapshot()
    finally:
        tr.reduce = reduce
        spans.disable()
    window_s = run.trace.window_s if run.trace is not None else 0.0
    dev, ranges = kept.get("intervals", ([], []))
    idle = None
    if dev:
        idle = {k: v / 1e6 for k, v in pt.attribute_idle(
            dev, ranges, 0.0, window_s * 1e6).items()}
    run.program = pt.ProgramTrace(snap, idle, window_s)
    metrics = {}
    for name in metric_names(cell):
        metrics[name] = spec.read_metric(name, run, cell.root)
    return out, run, notes, {"metrics": metrics,
                             "notes": program_notes(run),
                             "checks": checks(run)}


def program_notes(run) -> dict:
    from bench.lib import program_trace as pt
    from bench.lib.record import percentile
    p = run.program
    a, b = run.host_window
    steps = p.steps(a, b)
    seated = p.counter("engine.spawn_branch", "seated", a, b).sum()
    pruned = p.counter("sched.prune", "pruned", a, b).sum()
    pages = p.counter("engine.decode_step", "pages_used", a, b)
    i = p.records(a, b)
    gc_i = i[p.snap["name"][i] == "host.gc"]
    gc_s = (p.snap["t1_ns"][gc_i] - p.snap["t0_ns"][gc_i]) / 1e9
    gen = p.snap["counters"][gc_i, 0]
    num_pages = run.workload["engine"]["num_pages"]
    finish = pt.stamp_waits(run, "finish_s")
    per_step = {f"{name}.{c}": float(p.counter(name, c, a, b).sum()
                                      / max(len(steps), 1))
                for name, c in (("engine.decode_step", "rows"),
                                ("engine.decode_step", "ctx"),
                                ("engine.decode_step", "chunk_tokens"),
                                ("engine.pages", "cows"),
                                ("engine.pack", "lanes"),
                                ("sched.prm", "branches"))}
    completed = p.counter("sched.finalize", "completed", a, b)
    return {
        "program_idle_s": p.idle_s,
        "host_ms_by_span": p.host_ms_by_span(a, b),
        "device_ms_by_kind": p.device_ms(a, b),
        "pruned_share": float(pruned / seated) if seated else None,
        "branches_seated": int(seated), "branches_pruned": int(pruned),
        "pages_used_mean": float(pages.mean()) if len(pages) else None,
        "pages_used_share": (float(pages.mean()) / num_pages
                             if len(pages) else None),
        "gc_s": float(gc_s.sum()),
        "gc_by_generation": {int(g): [int((gen == g).sum()),
                                      float(gc_s[gen == g].sum()),
                                      float(gc_s[gen == g].max())]
                             for g in sorted(set(gen.tolist()))},
        "preemptions": int(p.counter("sched.preempt", "victims", a,
                                     b).sum()),
        "evictions": int(p.counter("sched.evict", "victims", a, b).sum()),
        "per_step": per_step,
        "completed_per_answer": (float(completed.mean()) if len(completed)
                                 else None),
        "finish_p90_s": (percentile(finish, 90) if finish is not None
                         else None),
        "host_window_steps": int(len(steps)),
        "records_dropped": int(p.snap["dropped"]),
    }


def checks(run) -> dict:
    """Each split beside its whole: the idle parts of the traced slice
    against ``device_idle``; the engine's host ms plus ``engine.launch``
    and ``engine.sync`` per step against ``step_ms``; the device ms of
    the traced slice's steps against the profiler's busy seconds."""
    p = run.program
    a, b = run.host_window
    by_span = p.host_ms_by_span(a, b) or {}
    steps = run.window_steps()
    step_ms = (sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
               if steps else None)
    out_c = {"step_ms": step_ms,
             "engine_host_launch_sync_ms": (
                 p.host_ms("engine", a, b) or 0.0)
             + by_span.get("engine.launch", 0.0)
             + by_span.get("engine.sync", 0.0)}
    if p.idle_s is not None and p.window_s > 0:
        out_c["idle_parts_pct"] = {
            k: 100.0 * v / p.window_s for k, v in p.idle_s.items()}
        out_c["idle_sum_pct"] = 100.0 * sum(p.idle_s.values()) / p.window_s
        out_c["device_idle_pct"] = 100.0 * (1 - run.trace.busy_s
                                            / run.trace.window_s)
    dev = p.snap["device"]
    traced = p.snap["seq"][p.steps(run.host_window[1], math.inf)]
    keep = np.isin(dev["seq"], traced)
    if keep.any() and run.trace is not None:
        out_c["traced_marked_device_s"] = float(dev["ms"][keep].sum() / 1e3)
        out_c["traced_busy_s"] = run.trace.busy_s
        out_c["traced_steps_marked"] = int(keep.sum())
    return out_c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--check", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from bench.lib import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("trace_program: needs a CUDA card", file=sys.stderr)
        return 3
    out, run, notes, prog = trace_cell(cell, args.seed, args.seconds,
                                       "cuda", T_START,
                                       check=bool(args.check))
    print("bench notes " + json.dumps(notes), file=sys.stderr)
    print("program notes " + json.dumps(prog["notes"]), file=sys.stderr)
    print("program checks " + json.dumps(prog["checks"]), file=sys.stderr)
    sys.stderr.flush()
    out["program"] = prog["metrics"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
