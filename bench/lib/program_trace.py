"""The program's own spans, counters and device marks over a finished run.

The port's tracer (``repro_torch.spans``) records host spans on
``time.perf_counter_ns`` and, per replayed step, device ms by kind; while
the profiler runs each span is also a ``record_function`` range, on the
device trace's clock. Two readings come from that:

* host, over the run's host window (the window less its traced slice):
  each record's self time, its duration less its direct children's,
  by span name, per step (an ``engine.decode_step`` record inside the
  host window);
* idle, over the traced slice: the profiler's device intervals laid
  against the program's ranges by exact interval intersection, each
  idle instant given to the innermost program span open on the host
  then; ``outside``, counted apart, is the idle time no span covers.

The engine's host time is the self time of every ``engine.*`` span but
``engine.launch`` (load and replay) and ``engine.sync`` (the wait on the
step); the scheduler's is that of the ``sched.*`` spans. ``host.gc`` is
its own, and so is ``host.tracer``, the tracer's read-out after each
step. Against a program that has no tracer every reading is None.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bench.lib.trace import _merge

# the names of the program's spans, by their first part
PREFIXES = ("engine.", "sched.", "host.")
NOT_ENGINE_HOST = ("engine.launch", "engine.sync")
OUTSIDE = "outside"


def layer_of(name: str) -> str:
    """``engine`` (the engine's host work), ``sched`` or the span's own
    name (``engine.launch``, ``engine.sync``, ``host.gc``, ``host.tracer``,
    ``outside``)."""
    if name.startswith("engine.") and name not in NOT_ENGINE_HOST:
        return "engine"
    if name.startswith("sched."):
        return "sched"
    return name


@dataclasses.dataclass
class ProgramTrace:
    snap: dict                            # repro_torch.spans.snapshot()
    idle_s: Optional[Dict[str, float]]    # traced slice, by innermost span
    window_s: float = 0.0                 # the traced slice's length

    def records(self, a: float, b: float) -> np.ndarray:
        """Indices of the closed records that start at or after ``a`` and
        end by ``b`` (``time.perf_counter`` seconds)."""
        s = self.snap
        return np.flatnonzero((s["t0_ns"] >= a * 1e9) & (s["t1_ns"] >= 0)
                              & (s["t1_ns"] <= b * 1e9))

    def steps(self, a: float, b: float) -> np.ndarray:
        i = self.records(a, b)
        return i[self.snap["name"][i] == "engine.decode_step"]

    def self_ns(self) -> np.ndarray:
        """Each record's duration less its direct children's."""
        s = self.snap
        dur = np.where(s["t1_ns"] >= 0, s["t1_ns"] - s["t0_ns"], 0)
        own = dur.astype(np.float64)
        pos = np.searchsorted(s["seq"], s["parent"])
        kept = (s["parent"] >= 0) & (pos < len(s["seq"]))
        kept[kept] = s["seq"][pos[kept]] == s["parent"][kept]
        np.subtract.at(own, pos[kept], dur[kept])
        return own

    def host_ms_by_span(self, a: float, b: float) -> Optional[dict]:
        """Self ms per step by span name over [a, b]."""
        steps = self.steps(a, b)
        if not len(steps):
            return None
        i = self.records(a, b)
        own = self.self_ns()[i]
        out: Dict[str, float] = {}
        for name, ns in zip(self.snap["name"][i], own):
            out[name] = out.get(name, 0.0) + ns
        return {k: v / 1e6 / len(steps) for k, v in sorted(out.items())}

    def host_ms(self, layer: str, a: float, b: float) -> Optional[float]:
        """Self ms per step of the spans of ``layer`` (``layer_of``)."""
        by = self.host_ms_by_span(a, b)
        if by is None:
            return None
        return sum(v for k, v in by.items() if layer_of(k) == layer)

    def counter(self, name: str, counter: str, a: float, b: float
                ) -> np.ndarray:
        """One counter of every ``name`` record in [a, b]."""
        i = self.records(a, b)
        i = i[self.snap["name"][i] == name]
        col = self.snap["counter_names"][name].index(counter)
        return self.snap["counters"][i, col]

    def device_ms(self, a: float, b: float) -> Optional[Dict[str, float]]:
        """Device ms per step by kind, over the steps in [a, b] that
        carry a row (None where none does)."""
        dev = self.snap["device"]
        steps = self.snap["seq"][self.steps(a, b)]
        keep = np.isin(dev["seq"], steps)
        if not keep.any():
            return None
        return dict(zip(dev["kinds"], dev["ms"][keep].mean(0).tolist()))

    def idle_share(self, layer: str) -> Optional[float]:
        """% of the traced slice the device was idle while the innermost
        program span belonged to ``layer``."""
        if self.idle_s is None or self.window_s <= 0:
            return None
        return 100.0 * sum(v for k, v in self.idle_s.items()
                           if layer_of(k) == layer) / self.window_s


def innermost(ranges: Sequence[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """The host's time cut into pieces, each labelled with the innermost
    range open over it (ranges of one thread nest; a range that closes out
    of turn is dropped from wherever it sits). Times where no range is
    open are left out."""
    events = []
    for k, (a, b, _) in enumerate(ranges):
        if b > a:
            events.append((a, 1, k))
            events.append((b, 0, k))     # at a tie, closes come first
    events.sort()
    out: List[Tuple[float, float, str]] = []
    stack: List[int] = []
    at = None
    for t, opening, k in events:
        if stack and t > at:
            out.append((at, t, ranges[stack[-1]][2]))
        at = t
        if opening:
            stack.append(k)
        elif stack and stack[-1] == k:
            stack.pop()
        elif k in stack:
            stack.remove(k)
    return out


def attribute_idle(device: Sequence[Tuple[float, float]],
                   ranges: Sequence[Tuple[float, float, str]],
                   lo: float, hi: float) -> Dict[str, float]:
    """The idle time of [lo, hi] (no device interval running), in the
    units given, by the innermost of ``ranges`` open then (``OUTSIDE``
    where none is)."""
    busy = [(max(a, lo), min(b, hi)) for a, b in _merge(device)
            if b > lo and a < hi]
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    pieces = innermost(ranges)
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            x, y, name = pieces[k]
            cut = min(b, y) - max(a, x)
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut
            k += 1
    # counted on its own, from the ranges' union: the parts then add up
    # to the idle time only where ``innermost`` lost or doubled no time
    held = _merge([(a, b) for a, b, _ in ranges if b > a])
    out[OUTSIDE] = sum(b - a for a, b in gaps) - _overlap(gaps, held)
    return out


def _overlap(xs: Sequence[Tuple[float, float]],
             ys: Sequence[Tuple[float, float]]) -> float:
    """The length the two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def profiler_intervals(prof) -> Tuple[list, list]:
    """From ``prof.events()`` (microseconds from the trace's start, host
    and device on one clock): the device's operation intervals, and the
    program's ranges on the host as (start, end, name)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, ranges = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.is_user_annotation:
                device.append((a, b))
        elif e.name.startswith(PREFIXES):
            ranges.append((a, b, e.name))
    return device, ranges


def program(run) -> Optional[ProgramTrace]:
    """The run's program trace, or None where the run holds none."""
    return getattr(run, "program", None)


def stamp_waits(run, stamp: str) -> Optional[List[float]]:
    """For every request the program's scheduler stamped as arriving in
    the window, its ``stamp`` (a ``Request`` wall-clock field) less its
    arrival; one not stamped by the window's end counts at its age then.
    None where the program's requests carry no stamps."""
    a, b = run.window
    out = []
    for r in run.records:
        t0 = getattr(r.req, "arrival_s", None)
        if t0 is None:
            return None
        if a <= t0 < b:
            t = getattr(r.req, stamp)
            out.append((t if t <= b else b) - t0)    # nan <= b is False
    return out
