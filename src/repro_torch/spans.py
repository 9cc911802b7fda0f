"""The port's tracer: named host spans and counters, and device marks
inside the step graphs. Off by default.

Off, ``span(...)`` returns one shared no-op context manager (it allocates
nothing and makes no torch call) and ``device_mark(...)`` does nothing.
``enable()`` turns it on for the process:

* A span records its name, its start and end on
  ``time.perf_counter_ns()`` (the clock the benchmark's host stamps use),
  the sequence number of the span open around it (-1 at the top), a
  request id (-1 where there is none) and up to four integer counters,
  named per span in ``COUNTERS`` and set with ``Span.set``. Records go
  into a preallocated ring of ``capacity`` records, which wraps and counts
  what it drops. The host loop that serves is one thread; spans opened by
  another thread would nest into its spans.
* While a ``torch.profiler`` is active each span also opens a
  ``torch.profiler.record_function`` of its name, which puts the spans on
  the device trace's clock.
* A ``gc.callbacks`` hook records a ``host.gc`` span for each collection,
  its generation as a counter.
* With ``marks=True`` (the default), a step variant captured as a CUDA
  graph while the tracer is on records a timing event at each
  ``device_mark(kind)`` of its body (``StepGraph``): the events become
  event nodes of the graph. Each mark starts an interval of its kind that
  runs to the next mark; the body's last mark, ``END``, closes the step.
  After a step's sync the engine adds each interval's time into one row
  of device ms by kind (``KINDS``), keyed to the step's
  ``engine.decode_step`` record; that read-out, and the step's counters,
  are the span ``host.tracer``, after the step's own. A graph captured while the tracer is off
  has no event node; on the CPU, in eager steps and on fake tensors the
  marks do nothing.

``snapshot()`` returns the records as arrays; nothing is written to a
file.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# the intervals a step's device time is split into (``device_mark``)
KINDS = ("dense", "attention", "moe_route", "moe_experts", "ssm", "head")
END = "end"          # the mark that closes a step; it starts no interval
_KIND_INDEX = {k: i for i, k in enumerate(KINDS)}

# the counters each span sets, in the order of its record's four
COUNTERS: Dict[str, Tuple[str, ...]] = {
    "engine.decode_step": ("rows", "ctx", "chunk_tokens", "pages_used"),
    "engine.pages": ("cows",),
    "engine.pack": ("lanes",),
    "engine.spawn_branch": ("seated",),
    "sched.prm": ("branches",),
    "sched.prune": ("pruned",),
    "sched.finalize": ("completed",),
    "sched.evict": ("victims",),
    "sched.preempt": ("victims",),
    "host.gc": ("generation",),
}
N_COUNTERS = 4

_profiling = torch.autograd._profiler_enabled


class _Noop:
    """What ``span`` returns while the tracer is off: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return None

    def __bool__(self):
        return False

    def set(self, **counters) -> None:
        pass


NOOP = _Noop()


class _Ring:
    """The records: one preallocated array per field, a record's slot its
    sequence number modulo the capacity."""

    def __init__(self, capacity: int, marks: bool):
        self.capacity = capacity
        self.marks = marks
        self.name = np.zeros(capacity, np.int32)
        self.t0 = np.zeros(capacity, np.int64)
        self.t1 = np.zeros(capacity, np.int64)
        self.parent = np.zeros(capacity, np.int64)
        self.req = np.zeros(capacity, np.int64)
        self.counters = np.zeros((capacity, N_COUNTERS), np.int64)
        self.n = 0                         # records opened so far
        self.open_seqs: List[int] = []     # the spans open now, innermost last
        self.names: List[str] = []
        self.ids: Dict[str, int] = {}
        # a step's record comes with its six parts' records, so a quarter
        # of the ring in step rows outlasts the records they are keyed to
        self.dev_capacity = max(1, capacity // 4)
        self.dev_seq = np.zeros(self.dev_capacity, np.int64)
        self.dev_ms = np.zeros((self.dev_capacity, len(KINDS)), np.float64)
        self.dev_n = 0
        self.gc_open: List["Span"] = []

    def open(self, name: str, req: int) -> int:
        seq = self.n
        self.n = seq + 1
        i = seq % self.capacity
        nid = self.ids.get(name)
        if nid is None:
            nid = self.ids[name] = len(self.names)
            self.names.append(name)
        self.name[i] = nid
        self.parent[i] = self.open_seqs[-1] if self.open_seqs else -1
        self.req[i] = req
        self.counters[i] = 0
        self.t1[i] = -1
        self.open_seqs.append(seq)
        self.t0[i] = time.perf_counter_ns()
        return seq

    def close(self, seq: int) -> None:
        t = time.perf_counter_ns()
        # spans close innermost first; one left open by an exception that
        # skipped its exit closes with it
        while self.open_seqs and self.open_seqs.pop() != seq:
            pass
        if seq >= self.n - self.capacity:   # not yet overwritten
            self.t1[seq % self.capacity] = t

    def set(self, seq: int, name: str, counters: dict) -> None:
        if seq < self.n - self.capacity:
            return
        names = COUNTERS[name]
        row = self.counters[seq % self.capacity]
        for k, v in counters.items():
            row[names.index(k)] = v

    def add_device(self, seq: int, ms: np.ndarray) -> None:
        i = self.dev_n % self.dev_capacity
        self.dev_seq[i] = seq
        self.dev_ms[i] = ms
        self.dev_n += 1


_ring: Optional[_Ring] = None


class Span:
    """One open span (``span`` returns it while the tracer is on)."""
    __slots__ = ("_ring", "_name", "_req", "seq", "_rf")

    def __init__(self, ring: _Ring, name: str, req: int):
        self._ring, self._name, self._req = ring, name, req
        self.seq = -1
        self._rf = None

    def __enter__(self):
        self.seq = self._ring.open(self._name, self._req)
        if _profiling():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        return self

    def __exit__(self, typ, val, tb):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._ring.close(self.seq)

    def __bool__(self):
        return True

    def set(self, **counters) -> None:
        """The span's counters, by the names ``COUNTERS`` gives it."""
        self._ring.set(self.seq, self._name, counters)

    def device(self, ms_by_kind: np.ndarray) -> None:
        """One step's device ms by kind, keyed to this span."""
        self._ring.add_device(self.seq, ms_by_kind)


def span(name: str, req: int = -1):
    """A span of ``name`` (``with span(...) as sp:``); the shared no-op,
    which is falsy, while the tracer is off."""
    ring = _ring
    if ring is None:
        return NOOP
    return Span(ring, name, req)


def enabled() -> bool:
    return _ring is not None


def enable(capacity: int = 1 << 18, marks: bool = True) -> None:
    """Turn the tracer on with an empty ring of ``capacity`` span records
    (and a quarter of that in step rows of device ms). ``marks=False``
    leaves the device marks out of graphs captured from now on."""
    global _ring
    disable()
    _ring = _Ring(capacity, marks)
    gc.callbacks.append(_on_gc)


def disable() -> None:
    """Turn the tracer off; its records are dropped."""
    global _ring
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _ring = None


def _on_gc(phase: str, info: dict) -> None:
    ring = _ring
    if ring is None:
        return
    if phase == "start":
        sp = Span(ring, "host.gc", -1)
        sp.__enter__()
        sp.set(generation=info.get("generation", -1))
        ring.gc_open.append(sp)
    elif ring.gc_open:
        ring.gc_open.pop().__exit__(None, None, None)


def snapshot() -> dict:
    """The records still in the ring, oldest first: ``name`` (str per
    record), ``t0_ns``, ``t1_ns`` (-1: still open), ``parent`` and
    ``seq`` (sequence numbers), ``req``, ``counters`` [n, 4] (their names
    per span in ``counter_names``), ``dropped``; and ``device``: the
    steps' rows, ``seq`` (the ``engine.decode_step`` record), ``ms`` [n,
    len(KINDS)], ``kinds``, ``dropped``. Empty with the tracer off."""
    ring = _ring
    if ring is None:
        return {}
    lo = max(0, ring.n - ring.capacity)
    seq = np.arange(lo, ring.n, dtype=np.int64)
    i = seq % ring.capacity
    names = np.array(ring.names + [""], dtype=object)
    dlo = max(0, ring.dev_n - ring.dev_capacity)
    j = np.arange(dlo, ring.dev_n) % ring.dev_capacity
    return {
        "seq": seq, "name": names[ring.name[i]] if len(i) else
        np.array([], dtype=object),
        "t0_ns": ring.t0[i].copy(), "t1_ns": ring.t1[i].copy(),
        "parent": ring.parent[i].copy(), "req": ring.req[i].copy(),
        "counters": ring.counters[i].copy(), "dropped": lo,
        "counter_names": dict(COUNTERS),
        "device": {"seq": ring.dev_seq[j].copy(),
                   "ms": ring.dev_ms[j].copy(), "kinds": KINDS,
                   "dropped": dlo},
    }


# ---------------------------------------------------------------- device


class DeviceMarks:
    """One step variant's timing events and their kinds, in the order its
    body records them. Made at the variant's warm-up (each event created
    and recorded eagerly there), then recorded again, in the same order,
    while the body is captured: each becomes an event node of the graph
    and is recorded at every replay. A mark of the kind already running
    records nothing."""

    def __init__(self):
        self.kinds: List[str] = []
        self.events: List[torch.cuda.Event] = []
        self._at = 0

    def mark(self, kind: str) -> None:
        if self._at and self.kinds[self._at - 1] == kind:
            return
        if self._at < len(self.events):
            if self.kinds[self._at] != kind:
                raise RuntimeError(
                    f"device mark {self._at} is {kind!r}, it was "
                    f"{self.kinds[self._at]!r} at the warm-up")
            ev = self.events[self._at]
        else:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            self.kinds.append(kind)
            self.events.append(ev)
        ev.record()
        self._at += 1

    def elapsed_ms(self) -> np.ndarray:
        """Device ms by kind of the last run of the marks (call after a
        sync that covers it)."""
        out = np.zeros(len(KINDS))
        for k, a, b in zip(self.kinds, self.events, self.events[1:]):
            out[_KIND_INDEX[k]] += a.elapsed_time(b)
        return out


_armed: Optional[DeviceMarks] = None


def device_mark(kind: str) -> None:
    """Start a device interval of ``kind`` (``KINDS``, or ``END``) in the
    step body being captured; nothing otherwise."""
    marks = _armed
    if marks is not None:
        marks.mark(kind)


def new_marks() -> Optional[DeviceMarks]:
    """A variant's marks, or None where its capture takes none: the
    tracer off, or on with ``marks=False``."""
    ring = _ring
    return DeviceMarks() if ring is not None and ring.marks else None


@contextlib.contextmanager
def armed(marks: Optional[DeviceMarks]):
    """``device_mark`` records into ``marks`` (None: nowhere) inside the
    block, from its first mark."""
    global _armed
    prev = _armed
    if marks is not None:
        marks._at = 0
    _armed = marks
    try:
        yield marks
    finally:
        _armed = prev
