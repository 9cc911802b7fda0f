"""Serves a cell's traffic through the port and records it on the host clock.

The window drives ``repro_torch.core.scheduler.Scheduler.run`` (SART,
Algorithm 1) over ``repro_torch.serving.engine.Engine``. The scheduler's
clock is ticks, so a ``Proxy`` sits between the two, as the port's
``serving/faults.py:FaultInjector`` does: it forwards every call, and

* releases each request at its due time on the host clock, through
  ``Scheduler.submit(..., arrival=sch.clock)``, from inside the calls the
  scheduler makes (the open schedule keeps running while a step runs);
* stamps the wall time of the calls into each layer (``decode_step``,
  ``begin_prefill``, ``finish_prefill``, ``spawn_branch``,
  ``free_branch``) and the moment each request is answered (the
  scheduler's finalisation releases its prefix);
* after each step, writes the argmax of the step's own logits rows (the
  step graph's static output) into a ring on the device, for the output
  check after the window;
* once the window has closed, raises ``Stop``, which ends ``run``.

These are the benchmark's own spans around calls into the program's
layers; nothing is added inside the program.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kv import OutOfPagesError

# the steps whose logits argmax the ring holds; beyond it nothing is kept
RING_STEPS = 16384


class Stop(BaseException):
    """Ends ``Scheduler.run`` once the window has closed. A BaseException,
    so the scheduler's fault handling, which catches ``Exception``, lets
    it through."""


@dataclasses.dataclass(eq=False)
class ReqRecord:
    index: int                    # the traffic's request index
    due: float                    # host clock the request was due
    req: object                   # the scheduler's Request
    prompt_len: int
    admit: float = math.nan       # first successful begin_prefill
    first_token: float = math.nan  # first branch seated (token sampled)
    answer: float = math.nan      # finalised (prefix released)
    argmax0: object = None        # device scalar: argmax of prefill logits
    branches: List[object] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SpawnRecord:
    handle: object                # the engine's BranchHandle
    step: int                     # index of the branch's first decode step
    t: float                      # host clock its first token was sampled


@dataclasses.dataclass
class StepRecord:
    t0: float
    t1: float
    tokens: int                   # decode-row tokens sampled
    ctx: int                      # context tokens the decode rows attend
    chunk_tokens: int             # prompt tokens the chunk lanes advanced
    chunk_ctx: int                # context tokens those chunk rows attend
    traced: bool = False
    tables: Optional[list] = None  # traced: [(pages, length)] per branch


class Proxy:
    """Forwards the engine interface to ``inner`` and records the run.

    ``traffic`` gives (due seconds, index) pairs and the requests; ``t0``
    is the host clock the schedule starts at; ``window_at`` and
    ``stop_at`` the clocks the window opens and closes at; ``trace_at``
    the clock the traced slice starts at (None: no trace)."""

    def __init__(self, engine, traffic, t0: float, stop_at: float,
                 trace_at: Optional[float] = None,
                 window_at: Optional[float] = None):
        self.inner = engine
        self.traffic = traffic
        self.t0 = t0
        self.stop_at = stop_at
        self.trace_at = trace_at
        self.window_at = t0 if window_at is None else window_at
        # the prefix cache's counters when the window opens
        self.stats_at_window: Optional[dict] = None
        self._stats_taken = False
        self.sch = None                      # set by ``attach``
        self.records: List[ReqRecord] = []
        self.steps: List[StepRecord] = []
        self.spawns: List[SpawnRecord] = []
        self.late: List[float] = []          # release - due, seconds
        self.oop = 0                         # OutOfPages raised by steps
        self._due: List[Tuple[float, int]] = []
        self._by_prompt: Dict[int, ReqRecord] = {}
        self._by_state: Dict[int, ReqRecord] = {}
        self._by_blocks: Dict[int, ReqRecord] = {}
        self._by_request: Dict[int, ReqRecord] = {}
        self._pending: List[object] = []     # prefill states in flight
        self._graphs = engine.step_graphs
        n = engine.cfg.max_slots
        self.ring = torch.zeros((RING_STEPS, n), dtype=torch.long,
                                device=engine.device)
        self.prof = None
        self.trace_started: Optional[float] = None
        self.stopped: Optional[float] = None
        self._schedule(traffic.first())

    def attach(self, sch) -> None:
        self.sch = sch

    def __getattr__(self, name):
        # only reached for names not set on the proxy itself
        return getattr(self.inner, name)

    # ------------------------------------------------------------ arrivals
    def _schedule(self, pairs) -> None:
        self._due.extend((self.t0 + d, i) for d, i in pairs)
        self._due.sort(reverse=True)         # the next due last

    def next_due(self) -> float:
        return self._due[-1][0] if self._due else math.inf

    def release(self, now: float) -> None:
        """Submit every request due by ``now`` to the scheduler."""
        while self._due and self._due[-1][0] <= now:
            due, i = self._due.pop()
            prompt, problem = self.traffic.requests.get(i)
            req = self.sch.submit(prompt, payload=problem,
                                  arrival=self.sch.clock)
            rec = ReqRecord(i, due, req, len(prompt))
            self.records.append(rec)
            self.late.append(now - due)
            self._by_prompt[id(req.prompt)] = rec
            self._by_request[req.request_id] = rec

    def _check(self) -> float:
        now = time.perf_counter()
        if now >= self.stop_at:
            self.stopped = now
            raise Stop
        if self._due and self._due[-1][0] <= now:
            self.release(now)
        return now

    @property
    def num_active(self) -> int:
        """The engine's count; an idle scheduler waits here, without
        spinning, for the next request due."""
        self._check()
        n = self.inner.num_active
        sch = self.sch
        while (n == 0 and not sch.prefilling and not sch.request_queue
               and not sch.branch_queue and not sch.suspended):
            time.sleep(max(0.0, min(self.next_due(), self.stop_at)
                           - time.perf_counter()))
            self._check()
        return n

    # --------------------------------------------------------------- steps
    def decode_step(self):
        now = self._check()
        if not self._stats_taken and now >= self.window_at:
            self.stats_at_window = self.inner.prefix_cache_stats()
            self._stats_taken = True
        traced = False
        if self.trace_at is not None and now >= self.trace_at:
            if self.prof is None:
                self._start_trace()
            traced = True
        pending = [(st, st.next_pos) for st in self._pending]
        before = {k: g.replays + g.eager_runs for k, g in self._graphs.items()}
        executed = self.inner.decode_steps_executed
        t0 = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function("bench.decode_step"):
                    out = self.inner.decode_step()
            else:
                out = self.inner.decode_step()
        except OutOfPagesError:    # the scheduler evicts; count it
            self.oop += 1
            raise
        t1 = time.perf_counter()
        if self.inner.decode_steps_executed == executed:
            return out
        k = len(self.steps)
        for name, g in self._graphs.items():
            if g.replays + g.eager_runs != before.get(name, 0):
                if k < RING_STEPS:
                    n = self.ring.shape[1]
                    torch.argmax(g.outputs[2][:n], dim=-1, out=self.ring[k])
                break
        ch_tok = ch_ctx = 0
        for st, pos in pending:
            adv = st.next_pos - pos
            ch_tok += adv
            # rows pos .. pos + adv - 1 attend pos + 1 .. pos + adv keys
            ch_ctx += adv * pos + adv * (adv + 1) // 2
        rec = StepRecord(t0, t1, len(out), self.inner.live_tokens(),
                         ch_tok, ch_ctx, traced)
        if traced:
            rec.tables = [(list(h.blocks.pages), h.blocks.length)
                          for h in self.inner.slots if h is not None]
        self.steps.append(rec)
        return out

    # ----------------------------------------------------------- admission
    def _span(self, name):
        if self.prof is not None:
            return torch.profiler.record_function(name)
        return _NULL

    def begin_prefill(self, prompt):
        t = time.perf_counter()
        with self._span("bench.begin_prefill"):
            st = self.inner.begin_prefill(prompt)
        rec = self._by_prompt.get(id(prompt))
        if rec is not None:
            if math.isnan(rec.admit):
                rec.admit = t
            self._by_state[id(st)] = rec
        if not st.done:
            self._pending.append(st)
        return st

    def finish_prefill(self, st):
        with self._span("bench.finish_prefill"):
            out = self.inner.finish_prefill(st)
        if st in self._pending:
            self._pending.remove(st)
        rec = self._by_state.pop(id(st), None)
        if rec is not None:
            rec.argmax0 = torch.argmax(out[1])
            self._by_blocks[id(out[0])] = rec
        return out

    def abort_prefill(self, st):
        if st in self._pending:
            self._pending.remove(st)
        self._by_state.pop(id(st), None)
        return self.inner.abort_prefill(st)

    def spawn_branch(self, request_id, *args, **kwargs):
        with self._span("bench.spawn_branch"):
            h = self.inner.spawn_branch(request_id, *args, **kwargs)
        if h is not None:
            t = time.perf_counter()
            self.spawns.append(SpawnRecord(h, len(self.steps), t))
            rec = self._by_request.get(request_id)
            if rec is not None:
                rec.branches.append(self.spawns[-1])
                if math.isnan(rec.first_token):
                    rec.first_token = t
        return h

    def free_branch(self, h):
        with self._span("bench.free_branch"):
            return self.inner.free_branch(h)

    def release_prefix(self, blocks):
        with self._span("bench.release_prefix"):
            self.inner.release_prefix(blocks)
        rec = self._by_blocks.pop(id(blocks), None)
        if rec is not None:
            rec.answer = time.perf_counter()
            self._schedule(self.traffic.answered(rec.index,
                                                 rec.answer - self.t0))

    # --------------------------------------------------------------- trace
    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.inner.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.trace_started = time.perf_counter()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def serve(proxy: Proxy, sch) -> None:
    """Drive the scheduler until the proxy stops it. ``run`` returns early
    when every request released so far is done; the next one is then
    waited for and released, and the run resumes."""
    proxy.attach(sch)
    try:
        while True:
            now = time.perf_counter()
            if now >= proxy.stop_at:
                proxy.stopped = now
                break
            wait = min(proxy.next_due(), proxy.stop_at) - now
            if not sch.requests or all(
                    r.done or r.quarantined for r in sch.requests.values()):
                time.sleep(max(0.0, wait))
                proxy.release(time.perf_counter())
                if not sch.requests:
                    continue
            sch.run(max_steps=1 << 62)
    except Stop:
        pass
    if proxy.prof is not None:
        torch.cuda.synchronize() if proxy.inner.device.type == "cuda" \
            else None
        proxy.prof.stop()


def warm_up(engine, vocab: int, seed: int, profiler: bool = False) -> None:
    """Runs every step variant the traffic uses once, outside the window:
    a prompt that fills the largest chunk bucket and then the smallest
    (each mixed variant), then one decode step of a branch forked off it
    (the decode variant). On the card each first run captures its CUDA
    graph. Everything is released afterwards. With ``profiler`` the
    profiler is started and stopped once too: its first start sets up
    the device tracing, seconds that would otherwise fall in the window."""
    g = torch.Generator().manual_seed(int(seed) + 7)
    buckets = sorted({max(engine.cfg.prefill_chunk // 2, 1),
                      engine.cfg.prefill_chunk})
    n = buckets[-1] + buckets[0]
    prompt = torch.randint(0, vocab, (n,), generator=g).tolist()
    blocks, logits, ssm = engine.prefill(prompt)
    h = engine.spawn_branch(-1, blocks, logits, ssm, len(prompt))
    engine.decode_step()
    torch.argmax(logits)
    engine.free_branch(h)
    engine.release_prefix(blocks)
    if profiler:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.argmax(logits)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def release_device_memory() -> None:
    """Collects what the caller dropped and returns the cached blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
