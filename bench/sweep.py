"""Finds a fixed-rate cell's knee: the cell served at each of a list of
rates, one after another in one process, printing per rate the backlog
(requests due with no branch seated yet) when the window opens and when
it closes, with the latencies and the step time.

    python3 bench/sweep.py --workload r1-distill-14b.sart-steady \\
        --rates 2.0,2.5,3.0 --seed 1 --seconds 20

The knee is the highest rate whose backlog does not grow over the
window. The cell's workload file then takes 0.8 x the knee as a number;
nothing here writes it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from bench import run  # noqa: E402
from bench.lib import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated requests per second")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    base = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    if base.workload["arrivals"]["kind"] != "open_poisson":
        print("sweep: the cell's arrivals are not at a fixed rate",
              file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.workload["arrivals"]["rate_per_s"] = rate
        out, rec, notes = run.run_cell(cell, args.seed, args.seconds, False,
                                       "cuda", time.perf_counter(),
                                       check=False)
        m = {k: v["value"] for k, v in out["metrics"].items()}
        steps = rec.window_steps()
        print("sweep " + json.dumps({
            "rate_per_s": rate,
            "backlog_at_open": notes["backlog_at_open"],
            "backlog_at_close": notes["backlog_at_close"],
            "answered_in_window": notes["answered_in_window"],
            "out_of_pages": notes["out_of_pages"],
            "step_ms": (sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
                        if steps else None),
            "rows_mean": (sum(s.tokens for s in steps) / len(steps)
                          if steps else None),
            **m}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
