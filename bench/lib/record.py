"""What a finished run hands the metric readers.

Times are on the host clock (``time.perf_counter``). ``window`` is the
measured window; ``host_window`` is the part of it that the per-layer
readers of host spans use, which leaves out a traced slice at its end
(the profiler slows those steps).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional, Tuple

import numpy as np

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


@dataclasses.dataclass
class Run:
    config: dict
    workload: dict
    records: list                 # driver.ReqRecord, in release order
    steps: list                   # driver.StepRecord
    spawns: list                  # driver.SpawnRecord
    window: Tuple[float, float]
    host_window: Tuple[float, float]
    setup_s: float
    device_kind: str
    trace: Optional[object] = None          # trace.TraceSummary
    prefix_stats: Optional[Tuple[dict, dict]] = None  # window start, end
    family: Optional[ModuleType] = None     # bench/families/<family>.py

    def peaks(self) -> Optional[dict]:
        """The card's published peaks by its name, or None for a device
        the table does not hold."""
        with open(PEAKS) as f:
            return json.load(f).get(self.device_kind)

    def window_steps(self, host: bool = True) -> list:
        a, b = self.host_window if host else self.window
        return [s for s in self.steps if s.t0 >= a and s.t1 <= b]

    def due_in_window(self) -> list:
        a, b = self.window
        return [r for r in self.records if a <= r.due < b]

    def itl_samples(self) -> List[float]:
        """Seconds since the same branch's previous token, for every
        token sampled by a decode step that ends in the window: for a
        branch seated before the step, the time since the previous step
        ended; for one seated since, the time since its first token (the
        step after a branch is seated is its first)."""
        a, b = self.window
        new_at = {}
        for sp in self.spawns:
            # a branch pruned before any step sampled nothing more
            if len(sp.handle.tokens) > 1:
                new_at.setdefault(sp.step, []).append(sp.t)
        out: List[float] = []
        for k, s in enumerate(self.steps):
            if not (a <= s.t1 <= b) or k == 0:
                continue
            fresh = new_at.get(k, [])
            out.extend([s.t1 - self.steps[k - 1].t1]
                       * (s.tokens - len(fresh)))
            out.extend(s.t1 - t for t in fresh)
        return out

    def tokens_in_window(self) -> int:
        """Branch tokens sampled in the window: each decode row's token,
        and each branch's first, sampled when it is seated."""
        a, b = self.window
        return (sum(s.tokens for s in self.steps if a <= s.t1 <= b)
                + sum(1 for sp in self.spawns if a <= sp.t <= b))


def percentile(values, q: float) -> Optional[float]:
    """numpy's linear percentile, or None with no values."""
    return float(np.percentile(values, q)) if len(values) else None
