"""Runs one cell of the benchmark on the card and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (counted in ``setup_s``): the model and its weights from
``--seed`` on the card, as the configuration's family
(``bench/families/<family>.py``) builds them, the engine and its KV
pool, one step of every variant the traffic uses (each captures its
CUDA graph; a checkout's first run also builds the kernels, into
``build/`` inside the checkout), then the cell's traffic from the
schedule's start until the window opens at steady occupancy.
The window then measures for ``--seconds``; ``--trace 1`` profiles its
last seconds. After the window the program's state is freed and the
served tokens are checked against the plain reference (``correct``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``check``, the number compared beside its
limit (also the last line of standard error). Exits 3 with no result
without a CUDA card, and 1 if a JAX module is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose top-level name, before the
    first dot, is one of ``FORBIDDEN``, compared whole (``repro_torch``
    passes)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def backlog(records, t: float) -> int:
    """Requests due by ``t`` with no branch seated by ``t``."""
    return sum(1 for r in records if r.due <= t
               and not (r.first_token <= t))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False, check: bool = True):
    """Serves the cell and checks it. Returns (result line dict, the run's
    record, notes for standard error)."""
    import torch

    from bench.lib import check as chk
    from bench.lib import driver, spec
    from bench.lib import trace as tr
    from bench.lib.model import DTYPES
    from bench.lib.record import Run, percentile
    from bench.work.step_bytes import step_bytes
    from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
    from repro_torch.data import tasks
    from repro_torch.models import Model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    marks = {"imports": time.perf_counter() - t_start}
    cfg_file, wl = cell.config, cell.workload
    family = spec.family_module(cell)
    mc = family.model_config(cfg_file)
    dtype = DTYPES[cfg_file["serve_dtype"]]
    params = family.make_params(mc, seed, device, dtype)
    model = Model(mc, dtype=dtype, device=device)
    model.load_params(params)
    e, smp = wl["engine"], wl["sampling"]
    engine = Engine(model, params, EngineConfig(
        page_size=e["page_size"], num_pages=e["num_pages"],
        max_slots=e["max_slots"],
        max_pages_per_branch=e["max_pages_per_branch"],
        eos_id=cfg_file["eos_token_id"],
        sampling=SamplingParams(temperature=smp["temperature"],
                                top_p=smp["top_p"]),
        seed=seed, prefill_chunk=e["prefill_chunk"],
        mixed_step_kernel=e["mixed_step_kernel"],
        decode_kernel=e["decode_kernel"],
        step_token_budget=e["step_token_budget"],
        prefix_cache=e["prefix_cache"]))
    marks["weights_and_pool"] = time.perf_counter() - t_start
    driver.warm_up(engine, mc.vocab_size, seed, profiler=trace)
    marks["shapes_warm"] = time.perf_counter() - t_start
    warm = float(wl["warmup_s"])
    traffic = spec.traffic_module(cell).make(wl, mc.vocab_size, seed,
                                             warm + seconds + 30)
    t0 = time.perf_counter()
    ws = t0 + warm
    we = ws + seconds
    trace_at = max(ws, we - wl["trace"]["seconds"]) if trace else None
    proxy = driver.Proxy(engine, traffic, t0, we, trace_at, window_at=ws)
    s = wl["sart"]
    sch = Scheduler(proxy, OraclePRM(tasks.oracle_grader,
                                     noise=wl["prm_noise"], seed=seed + 1),
                    SchedulerConfig(policy=s["policy"], n=s["n"], m=s["m"],
                                    alpha=s["alpha"], beta=s["beta"],
                                    window=s["window"],
                                    max_tokens=s["max_tokens"]),
                    answer_fn=tasks.extract_answer)
    driver.serve(proxy, sch)
    cuda = engine.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = None
    if proxy.prof is not None:
        summary = tr.reduce(proxy.prof, proxy.stopped - proxy.trace_started)
    stats = engine.prefix_cache_stats()
    run = Run(cfg_file, wl, proxy.records, proxy.steps, proxy.spawns,
              (ws, we), (ws, proxy.trace_started or we), ws - t_start,
              torch.cuda.get_device_name() if cuda else device, summary,
              (proxy.stats_at_window, stats) if stats is not None else None,
              family)
    attempted = len(run.due_in_window())
    failed = sum(1 for r in run.due_in_window() if r.req.quarantined)
    faults = dict(sch.fault_counters)
    notes = {
        "steps_in_window": len(run.window_steps(host=False)),
        "released": len(proxy.records),
        "answered_in_window": sum(1 for r in proxy.records
                                  if ws <= r.answer <= we),
        "backlog_at_open": backlog(proxy.records, ws),
        "backlog_at_close": backlog(proxy.records, we),
        "rows_at_open": next((s.tokens for s in proxy.steps if s.t0 >= ws),
                             None),
        "release_late_p99_s": percentile(proxy.late, 99),
        "out_of_pages": proxy.oop,
        "step_faults": faults["step_faults"],
        "quarantined": faults["quarantined"],
        "graph_replays": engine.graph_replays,
        "graphs_captured": engine.graphs_captured,
        "setup_marks_s": marks,
    }
    steps = run.window_steps(host=False)
    peaks = run.peaks()
    if steps and peaks:
        # the least a step could take: its bytes at the card's bandwidth
        notes["byte_bound_ms"] = 1e3 * sum(
            step_bytes(family, cfg_file, params, s.ctx, s.tokens)
            for s in steps) / len(steps) / peaks["hbm_bytes_per_s"]
    # the program's state goes before the reference runs: its peak is read
    del sch, engine, model
    proxy.inner = proxy._graphs = proxy.prof = None
    driver.release_device_memory()
    result_check = None
    if check:
        picked = chk.sample(proxy.records, seed, wl["check"]["requests"])
        if picked:
            result_check = chk.compare(spec.reference_module(cell), cfg_file,
                                       params, proxy.ring, picked,
                                       control=control)
        notes.update(result_check or {"check": "no answered request"})
        notes["check_s"] = time.perf_counter() - proxy.stopped
    verdict = chk.verdict(result_check, wl["check"]["limits"],
                          "control_fp8" if control else "program")
    correct = (check and failed == 0 and faults["step_faults"] == 0
               and all(v["value"] <= v["limit"] for v in verdict.values()))
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        v = spec.read_metric(m["name"], run, cell.root)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": run.device_kind, "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["check"] = verdict
    return out, run, notes


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="hold the float8 control's gaps to the limits in "
                         "the program's place (for setting the limits; the "
                         "benchmark's runs leave it off)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench.lib import spec
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    import torch
    chips = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); {have} "
              "available", file=sys.stderr)
        return 3
    out, run, notes = run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START,
                               control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 1
    print("bench notes " + json.dumps(notes), file=sys.stderr)
    for name, v in out["check"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
