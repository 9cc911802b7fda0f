"""Trace-driven serving simulator for paper-scale experiments.

The CPU container can only run tiny live models, but the paper's end-to-end
claims (Fig. 5/6/7) are about *scheduling* at realistic response lengths
(thousands of tokens) and arrival rates. ``SimEngine`` implements the exact
host-side interface of ``repro_torch.serving.Engine`` — including the real
``PageAllocator`` for KV memory accounting — but branches play back sampled
length/quality traces instead of running a model. The unmodified
``repro_torch.core.Scheduler`` (Algorithm 1 and every baseline policy)
drives it, so the scheduling logic under test is byte-identical to the
live engine's.

Length model: mixture of a lognormal body and an over-thinking tail
(paper §3 Obs. 1: lengths vary substantially per request; correctness is
weakly related to length). Reward model: the PRM's discriminability is
parameterized — rewards drift toward 1 (right-thinking) or 0 (wrong) as the
branch progresses, with noise.

A copy of ``repro.serving.simulator`` over the port's engine helpers
(``BranchHandle``, ``ChunkedPrefillState``, ``StepVariant``,
``derive_lane_configs``, ``pack_chunk_lanes``), its ``PageAllocator`` and
``PrefixCache`` and its tokenizer. It runs on the host only and touches no
tensor: its streams are numpy's, so a run equals the reference's bit for
bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from ..data import tokenizer as tk
from ..kv import (BranchBlocks, OutOfPagesError, PageAllocator,
                  PrefixCache)
from .engine import (BranchHandle, ChunkedPrefillState, StepVariant,
                     derive_lane_configs,
                     pack_chunk_lanes)


@dataclasses.dataclass(frozen=True)
class SimWorkload:
    """Distribution of branch behaviour for one experiment."""
    mean_len: float = 2000.0          # lognormal body, tokens
    sigma_len: float = 0.6
    overthink_p: float = 0.12         # probability of the long-tail mode
    overthink_mult: float = 4.0       # tail length multiplier
    correct_p: float = 0.55           # P(branch reaches a correct answer)
    prm_drift: float = 3.0            # reward drift magnitude (discriminability)
    prm_noise: float = 0.12
    prompt_len: int = 64
    # Last ``prompt_tail`` prompt tokens are request-distinct (the rest is
    # a shared few-shot header) — the workload shape prefix caching
    # exploits. 0 keeps the legacy identical prompts.
    prompt_tail: int = 0
    # NOTE: correctness is sampled independently of length (paper Obs. 1)


@dataclasses.dataclass(frozen=True)
class SimEngineConfig:
    max_slots: int = 64               # decode batch B
    page_size: int = 16
    num_pages: int = 65536            # models HBM KV capacity
    eos_id: int = tk.EOS
    prefill_chunk: int = 64           # prompt tokens prefilled per step
    chunked_prefill: bool = True      # piggyback chunks on decode steps
    # Token-budget lane scheduling, mirroring EngineConfig: a decode step
    # carries up to this many chunk-row tokens drawn from multiple pending
    # prefills (0 = legacy single-lane FIFO, one chunk per step). The sim
    # has a single bucket (prefill_chunk), so the lane count per step is
    # at most step_token_budget // prefill_chunk.
    step_token_budget: int = 0
    prefill_starvation_bound: int = 4
    # Radix page-hash prompt prefix cache, mirroring EngineConfig: warm
    # admission skips the cached page-aligned prefix's chunk steps (and
    # pages), so ttfb under shared-header workloads improves. Off by
    # default (timing-identical to the seed).
    prefix_cache: bool = False


@dataclasses.dataclass
class _BranchSpec:
    length: int                       # tokens this branch will generate
    correct: bool
    quality: float                    # asymptotic PRM reward


@dataclasses.dataclass
class SimTask:
    answer: int = 7                   # the request's true answer digit


class SimEngine:
    """Drop-in Engine substitute: plays back sampled branch traces."""

    def __init__(self, cfg: SimEngineConfig, workload: SimWorkload,
                 seed: int = 0):
        self.cfg = cfg
        self.workload = workload
        # branch destinies and PRM noise draw from SEPARATE streams: spec
        # draws then depend only on spawn order, so scheduling/timing changes
        # (or policy choice, at equal seed) never re-roll the workload —
        # tail-latency comparisons stay paired instead of re-sampled
        self.rng = np.random.default_rng(seed)
        self.noise_rng = np.random.default_rng(seed + 0x5AB7)
        self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)
        self.slots: List[Optional[BranchHandle]] = [None] * cfg.max_slots
        self._specs: Dict[int, _BranchSpec] = {}
        self.tasks: Dict[int, SimTask] = {}   # request_id -> SimTask
        self._next_branch_id = 0
        self.decode_steps_executed = 0
        self.prefill_chunk_steps = 0
        self.mixed_steps_executed = 0
        self._pending_prefills: List[ChunkedPrefillState] = []
        if cfg.step_token_budget > 0 and not cfg.chunked_prefill:
            raise ValueError("step_token_budget requires chunked_prefill "
                             "(mirror of the Engine contract)")
        self._lane_configs = derive_lane_configs(
            (), cfg.step_token_budget, cfg.prefill_chunk)
        if cfg.prefix_cache and not cfg.chunked_prefill:
            raise ValueError("prefix_cache requires chunked_prefill "
                             "(mirror of the Engine contract)")
        self.prefix_cache = (PrefixCache(self.allocator)
                             if cfg.prefix_cache else None)

    # ----------------------------------------------------- engine interface
    @property
    def free_slots(self) -> List[int]:
        """Unoccupied decode-slot indices, ascending."""
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def num_active(self) -> int:
        """Occupied decode slots."""
        return sum(s is not None for s in self.slots)

    def live_tokens(self) -> int:
        """Total tokens resident in the KV pool (paper Fig. 3)."""
        return sum(s.blocks.length for s in self.slots if s is not None)

    def prefill(self, prompt: List[int]):
        """Legacy synchronous prefill: allocate the prompt's pages in one
        shot. Returns ``(blocks, last_logits, ssm_state)`` — the latter two
        are None (the sim plays back traces, no model runs)."""
        blocks = self.allocator.alloc_prefix(len(prompt))
        return blocks, None, None

    # ------------------------------------------- chunked admission interface
    def begin_prefill(self, prompt: List[int]) -> ChunkedPrefillState:
        """Mirror of Engine.begin_prefill: allocate the prompt's pages up
        front, then account one ``prefill_chunk``-token chunk per decode
        step. With the prefix cache, the longest cached page-aligned
        prefix is increfed into the block list and chunk accounting starts
        at the first uncached token (warm hits skip those chunk steps and
        pages). With chunking disabled the state completes immediately
        (the scheduler then charges the legacy synchronous prefill
        tick)."""
        if self.prefix_cache is None:
            blocks, cached = self.allocator.alloc_prefix(len(prompt)), 0
        else:
            # the two acquisitions sit in exclusive branches, and each is
            # all-or-nothing on its own
            blocks, _ = self.prefix_cache.admit(prompt)  # reprolint: disable=REP002
            cached = blocks.num_shared * self.cfg.page_size
        st = ChunkedPrefillState(prompt=list(prompt), blocks=blocks,
                                 next_pos=cached, cached_tokens=cached)
        if not self.cfg.chunked_prefill:
            st.next_pos = len(prompt)
            st.done = True
            return st
        self._pending_prefills.append(st)
        return st

    def finish_prefill(self, st: ChunkedPrefillState):
        """Harvest a completed chunked prefill: ownership of its pages
        passes to the branches forked off it (mirror of
        ``Engine.finish_prefill``)."""
        assert st.done, "prefill still has pending chunks"
        st.harvested = True
        return st.blocks, st.last_logits, st.ssm_state

    def abort_prefill(self, st: ChunkedPrefillState) -> None:
        """Mirror of Engine.abort_prefill: harvested states no longer own
        their pages (branches fork off them), so only unharvested aborts
        release."""
        if st in self._pending_prefills:
            self._pending_prefills.remove(st)
        if not st.harvested:
            self.allocator.release(st.blocks)
        st.done = True

    @property
    def has_pending_prefill(self) -> bool:
        """True while any admitted prompt still has chunks to account."""
        return bool(self._pending_prefills)

    @property
    def admission_capacity(self) -> int:
        """Mirror of Engine.admission_capacity: max chunk lanes one step
        can carry under the token budget (1 = legacy FIFO)."""
        return self._lane_configs[-1]

    def step_variants(self) -> List[StepVariant]:
        """Mirror of ``Engine.step_variants`` for the name/lane_buckets
        enumeration (``args=None`` — the simulator has no step program).
        The simulator has a single bucket (``prefill_chunk``), so the
        variant set is 1 + len(lane_configs), a projection of the
        port Engine's enumeration (``tests/test_torch_simulator.py``)."""
        variants = [StepVariant("decode", ())]
        bucket = self.cfg.prefill_chunk
        for n in self._lane_configs:
            variants.append(
                StepVariant(f"mixed:b{bucket}xl{n}", (bucket,) * n))
        return variants

    def prefix_cache_stats(self):
        """Mirror of Engine.prefix_cache_stats (None with the cache off)."""
        return (self.prefix_cache.stats()
                if self.prefix_cache is not None else None)

    def match_cached_tokens(self, prompt: List[int]) -> int:
        """Mirror of Engine.match_cached_tokens: non-mutating LPM probe
        (the sim plays back traces, so no SSM gating applies)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.match_tokens(prompt)

    def _advance_pending_prefill(self) -> None:
        """Account the chunk lanes riding this decode step: the same
        ``pack_chunk_lanes`` the live engine uses selects which pending
        prefills advance (oldest-first under ``step_token_budget``, with
        the starvation bound), each by one ``prefill_chunk``."""
        lanes, _ = pack_chunk_lanes(
            self._pending_prefills, budget=self.cfg.step_token_budget,
            chunk_bucket=lambda st: self.cfg.prefill_chunk,
            lane_configs=self._lane_configs,
            starvation_bound=self.cfg.prefill_starvation_bound)
        if lanes:
            self.mixed_steps_executed += 1
        for st in lanes:
            st.next_pos = min(st.next_pos + self.cfg.prefill_chunk,
                              len(st.prompt))
            self.prefill_chunk_steps += 1
            if st.next_pos >= len(st.prompt):
                st.done = True
                self._pending_prefills.remove(st)
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(st.prompt, st.blocks.pages)

    def _sample_spec(self) -> _BranchSpec:
        w = self.workload
        ln = self.rng.lognormal(math.log(w.mean_len), w.sigma_len)
        if self.rng.random() < w.overthink_p:
            ln *= w.overthink_mult    # over-thinking dilemma tail
        correct = bool(self.rng.random() < w.correct_p)
        quality = 0.85 if correct else 0.25
        return _BranchSpec(length=max(int(ln), 4), correct=correct,
                           quality=quality)

    def spawn_branch(self, request_id: int, prefix_blocks: BranchBlocks,
                     last_logits, ssm_state, prompt_len: int,
                     prompt_tokens: Optional[List[int]] = None
                     ) -> Optional[BranchHandle]:
        """Seat a new branch sharing the request's prefix pages, sampling
        its destiny (length/correctness/quality) from the workload.
        Returns None when no decode slot is free. ``prompt_tokens``
        mirrors Engine.spawn_branch: it keys the branch's generated full
        pages into the prefix cache at completion and page-aligned decode
        boundaries."""
        free = self.free_slots
        if not free:
            return None
        slot = free[0]
        blocks = self.allocator.fork(prefix_blocks)
        h = BranchHandle(branch_id=self._next_branch_id,
                         request_id=request_id, slot=slot, blocks=blocks,
                         tokens=[tk.STEP], prompt_len=prompt_len,
                         prompt_tokens=(list(prompt_tokens)
                                        if prompt_tokens is not None
                                        else None))
        self._next_branch_id += 1
        self._specs[h.branch_id] = self._sample_spec()
        self.slots[slot] = h
        return h

    def fork_branch(self, parent: BranchHandle) -> Optional[BranchHandle]:
        """Seat a copy-on-write child of a live branch (rebase expansion):
        shares all parent pages, inherits its tokens, resamples the
        remaining destiny. Returns None when no slot is free."""
        free = self.free_slots
        if not free:
            return None
        slot = free[0]
        blocks = self.allocator.fork(parent.blocks)
        h = BranchHandle(branch_id=self._next_branch_id,
                         request_id=parent.request_id, slot=slot,
                         blocks=blocks, tokens=list(parent.tokens),
                         prompt_len=parent.prompt_len,
                         prompt_tokens=(list(parent.prompt_tokens)
                                        if parent.prompt_tokens is not None
                                        else None))
        self._next_branch_id += 1
        # child inherits progress; resamples its remaining destiny
        self._specs[h.branch_id] = self._sample_spec()
        self.slots[slot] = h
        return h

    def pages_needed_for_step(self) -> int:
        """Worst-case fresh pages the next decode step may allocate
        (boundary pages + CoW copies) — the admission-control pre-check
        ``decode_step`` runs before touching the allocator."""
        ps = self.cfg.page_size
        need = 0
        for h in self.slots:
            if h is None:
                continue
            b = h.blocks
            if self.allocator.needs_cow(b):
                need += 1
            if b.length % ps == 0 and b.length // ps == len(b.pages):
                need += 1
        return need

    def decode_step(self) -> Dict[int, int]:
        """One simulated decode step: account a page per active branch,
        advance pending prefill chunk lanes, and emit each branch's next
        trace token. Returns {slot: token} (mirror of
        ``Engine.decode_step``)."""
        if self.num_active == 0 and not self._pending_prefills:
            return {}
        if self.pages_needed_for_step() > self.allocator.free_pages:
            raise OutOfPagesError("sim KV pool exhausted")
        self._advance_pending_prefill()   # chunk piggybacks on this step
        out = {}
        # the pages_needed_for_step pre-check above reserves this loop's
        # worst case (mirror of Engine)
        for slot, h in enumerate(self.slots):
            if h is None:
                continue
            self.allocator.append_token(h.blocks)  # reprolint: disable=REP002
            spec = self._specs[h.branch_id]
            gen = len(h.tokens)
            if gen >= spec.length:
                # emit the answer tail then EOS
                task = self.tasks.get(h.request_id, SimTask())
                ans = task.answer if spec.correct else (task.answer + 1) % 10
                if h.tokens[-1] != tk.ANSWER and not tk.is_digit(h.tokens[-1]):
                    tok = tk.ANSWER
                elif h.tokens[-1] == tk.ANSWER:
                    tok = tk.digit(ans)
                else:
                    tok = tk.EOS
            else:
                tok = tk.STEP
            h.tokens.append(tok)
            out[slot] = tok
            if (self.prefix_cache is not None
                    and h.prompt_tokens is not None
                    and h.blocks.length % self.cfg.page_size == 0):
                # page-aligned decode boundary: publish generated full
                # pages without waiting for completion (Engine mirror)
                self._insert_generated(h)
        self.decode_steps_executed += 1
        return out

    def suspend_branch(self, h: BranchHandle) -> None:
        """Vacate a branch's decode slot, keeping its pages (preemption);
        ``resume_branch`` reseats it."""
        assert self.slots[h.slot] is h
        self.slots[h.slot] = None
        h.slot = -1

    def resume_branch(self, h: BranchHandle) -> bool:
        """Reseat a suspended branch; False when no slot is free."""
        free = self.free_slots
        if not free:
            return False
        h.slot = free[0]
        self.slots[h.slot] = h
        return True

    def _insert_generated(self, h: BranchHandle) -> None:
        """Mirror of Engine._insert_generated: key the branch's generated
        full pages into the prefix cache by prompt + generated tokens (the
        trailing partial page keeps private CoW semantics)."""
        if self.prefix_cache is None or h.prompt_tokens is None:
            return
        written = h.blocks.length - h.prompt_len
        if written <= 0:
            return
        key = list(h.prompt_tokens) + h.tokens[:written]
        self.prefix_cache.insert(key, h.blocks.pages)

    def free_branch(self, h: BranchHandle):
        """Eagerly release a terminated branch's pages and its slot
        (inserting its generated full pages into the prefix cache first,
        so they park warm on the LRU instead of freeing)."""
        self._insert_generated(h)
        self.allocator.release(h.blocks)
        if h.slot >= 0:
            self.slots[h.slot] = None
        self._specs.pop(h.branch_id, None)
        h.done = True

    def release_prefix(self, prefix_blocks: BranchBlocks):
        """Drop the request's own reference on its prompt pages (the last
        sibling's release then frees or LRU-parks them)."""
        self.allocator.release(prefix_blocks)

    # ------------------------------------------------------------ PRM model
    def reward_of(self, h: BranchHandle) -> float:
        """Simulated PRM reward: drifts from 0.5 toward the branch's
        latent quality as generation progresses, plus noise, in [0, 1]."""
        spec = self._specs.get(h.branch_id)
        if spec is None:
            return 0.5
        w = self.workload
        progress = min(len(h.tokens) / spec.length, 1.0)
        # reward drifts from neutral 0.5 toward the branch's quality as the
        # PRM sees more of the trajectory (discriminability = prm_drift)
        logit = math.log(spec.quality / (1 - spec.quality)) \
            * progress * w.prm_drift / 2
        r = 1 / (1 + math.exp(-logit)) + self.noise_rng.normal(0, w.prm_noise)
        return float(np.clip(r, 0.0, 1.0))


class SimPRM:
    """PRM protocol over SimEngine's reward model."""

    def __init__(self, engine: SimEngine):
        self.engine = engine

    def score(self, request, handles) -> List[float]:
        """Reward per handle from the engine's simulated PRM model."""
        return [self.engine.reward_of(h) for h in handles]


def poisson_burst_arrivals(num_requests: int, *, burst_gap: int,
                           burst_mean: float, seed: int = 7) -> List[int]:
    """Arrival clocks for bursts every ``burst_gap`` decode steps, each of
    1 + Poisson(burst_mean) simultaneous requests — the bursty workload
    the token-budget chunk lanes are sized for (docs/scheduling.md)."""
    rng = np.random.default_rng(seed)
    times, t = [], 0
    while len(times) < num_requests:
        times += [t] * (1 + int(rng.poisson(burst_mean)))
        t += burst_gap
    return sorted(times[:num_requests])


def adversarial_shared_header_mix(num_warm: int = 6, num_cold: int = 8, *,
                                  prompt_len: int = 512,
                                  header_len: int = 448,
                                  burst_at: int = 160, seed: int = 0):
    """Workload for cache-aware admission studies: ``(prompts, arrivals)``.

    A seeder request (arrival 0) plants a shared few-shot header in the
    radix prefix cache; once it finishes, its pages idle on the cache's
    LRU free-list. Then one burst arrives in which ``num_cold`` fully
    distinct prompts are *submitted ahead of* the ``num_warm``
    header-sharing ones — adversarial for FIFO admission under page
    pressure: the colds' prompt allocations drain the free list and evict
    the idle header pages before the warms are admitted, so the warms
    miss. LPM ordering probes the cache, admits the warm matches first,
    and thereby *pins* the header pages (increfed = not evictable) while
    the colds queue behind. Size ``num_pages`` tight enough that the
    colds actually force eviction (see ``benchmarks/fig5_e2e.py``).
    """
    rng = np.random.default_rng(seed + 0x11A)
    tail = prompt_len - header_len
    hdr = [tk.BOS] + [tk.digit(0)] * (header_len - 1)
    prompts = [hdr + [tk.digit(9)] * (tail - 1) + [tk.EQUALS]]   # seeder
    times = [0]
    for _ in range(num_cold):
        prompts.append([tk.BOS] + [tk.digit(int(d)) for d in
                                   rng.integers(0, 10, size=prompt_len - 2)]
                       + [tk.EQUALS])
        times.append(burst_at)
    for i in range(num_warm):
        prompts.append(hdr + [tk.digit(1 + i % 8)] * (tail - 1)
                       + [tk.EQUALS])
        times.append(burst_at)
    return prompts, times


def mixed_deadline_workload(num_loose: int = 6, num_tight: int = 4, *,
                            loose_slack: int = 800, tight_slack: int = 100,
                            tight_lag: int = 2):
    """Workload for SLO-aware admission studies: ``(arrivals, deadlines)``.

    ``num_loose`` requests with a generous deadline arrive first (and are
    submitted first), then ``num_tight`` urgent requests arrive
    ``tight_lag`` ticks later with a tight absolute deadline. Under
    serialized admission (single chunk lane), FIFO serves the loose
    backlog first and the tight requests blow their deadlines waiting;
    EDF reorders the arrived set by deadline and meets them."""
    times = [0] * num_loose + [tight_lag] * num_tight
    deadlines = [t + loose_slack for t in times[:num_loose]] + \
                [t + tight_slack for t in times[num_loose:]]
    return times, deadlines


def run_sim_experiment(policy: str, n: int, *, num_requests: int = 40,
                       arrival_gap: int = 0, workload: SimWorkload = None,
                       engine_cfg: SimEngineConfig = None, window: int = 400,
                       max_tokens: int = 1 << 30, seed: int = 0,
                       m: int = 0, alpha: float = 0.5, beta: int = 0,
                       arrival_times: Optional[List[int]] = None,
                       admission_policy: str = "fifo",
                       deadlines: Optional[List[Optional[int]]] = None,
                       priorities: Optional[List[int]] = None,
                       prompts: Optional[List[List[int]]] = None,
                       max_steps: int = 200_000_000,
                       fault_plan=None):
    """One simulated serving run; returns (metrics, accuracy).

    ``arrival_gap`` is the decode-step gap between request arrivals (the
    decode-step analogue of the paper's 1 vs 4 requests/second rates).
    ``arrival_times`` overrides it with an explicit per-request arrival
    clock (e.g. Poisson bursts for the chunk-lane ttfb experiments).

    ``admission_policy`` selects the ordering over the arrived set
    (``repro_torch.core.policies``); ``deadlines`` (absolute clocks) and
    ``priorities`` annotate requests for edf/priority ordering and the
    SLO-attainment metrics. ``prompts`` overrides the built-in
    shared-header prompt builder with explicit per-request token lists
    (e.g. adversarial warm/cold mixes for cache-aware policy studies).
    Accuracy counts only finished requests but divides by all submitted,
    so an overload run (``max_steps``) scores what it actually served.

    ``fault_plan`` (a ``repro_torch.serving.FaultPlan``) wraps the SimEngine in
    a seeded ``FaultInjector`` for chaos runs — the scheduler then drives
    the wrapper through the identical duck-typed interface, so fault-free
    plans stay bit-exact with the unwrapped engine.
    """
    from ..core import Scheduler, SchedulerConfig
    from ..data.tasks import extract_answer
    from .faults import FaultInjector

    workload = workload or SimWorkload()
    engine_cfg = engine_cfg or SimEngineConfig()
    engine = SimEngine(engine_cfg, workload, seed=seed)
    prm = SimPRM(engine)
    driven = (FaultInjector(engine, fault_plan)
              if fault_plan is not None else engine)
    cfg = SchedulerConfig(policy=policy, n=n, m=m, alpha=alpha, beta=beta,
                          window=window, max_tokens=max_tokens,
                          admission_policy=admission_policy)
    sch = Scheduler(driven, prm, cfg, answer_fn=extract_answer)
    rng = np.random.default_rng(seed + 1)
    for i in range(num_requests):
        task = SimTask(answer=int(rng.integers(0, 10)))
        if prompts is not None:
            prompt = list(prompts[i])
        else:
            # shared few-shot header + (optionally) a request-distinct
            # tail — the prefix-caching workload shape; prompt_tail=0
            # keeps the legacy identical prompts
            tail = min(workload.prompt_tail, workload.prompt_len - 2)
            prompt = [tk.BOS] \
                + [tk.digit(0)] * (workload.prompt_len - 2 - tail) \
                + [tk.digit(i % 10)] * tail + [tk.EQUALS]
        arrival = (arrival_times[i] if arrival_times is not None
                   else i * arrival_gap)
        req = sch.submit(prompt, payload=task, arrival=arrival,
                         deadline=deadlines[i] if deadlines else None,
                         priority=priorities[i] if priorities else 0)
        engine.tasks[req.request_id] = task
    metrics = sch.run(max_steps=max_steps)
    correct = sum(
        1 for r in metrics["requests"]
        if r["answer"] is not None
        and r["answer"] == engine.tasks[r["request_id"]].answer)
    accuracy = correct / max(len(metrics["requests"]), 1)
    return metrics, accuracy
