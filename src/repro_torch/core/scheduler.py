"""SART's scheduling workflow (paper Algorithm 1) + baseline policies.

Time base: one decode step of the fixed-size branch batch is one clock tick
(decoding is memory-bound, so step latency is ~independent of how full the
batch is — the quantity SART optimizes is the *number* of steps a request
spans, plus the steps it waits in queue). Prefill counts one tick. The clock
also advances while the system is idle waiting for arrivals.

Policies (all sharing the engine + continuous batching, as the paper does for
fair comparison):
  * ``vanilla``        — N=1, no early stop, no pruning.
  * ``sc``             — Self-Consistency: N branches, wait for all N,
                         majority vote.
  * ``sart``           — redundant sampling (N>M) + early stop at M
                         completions + two-phase pruning; best-of-N by reward.
  * ``sart_noprune``   — ablation (paper Fig. 6): early stop only.
  * ``rebase``         — reward-guided tree search baseline (fork strong
                         leaves, cull weak ones, ≤N live leaves).

Public contracts (documented in docs/architecture.md and
docs/scheduling.md, which deep-link here):

  * **Engine-agnostic**: the scheduler drives anything implementing the
    engine interface (``repro_torch.serving.Engine`` live, ``SimEngine``
    traced) through the same code path — policies compare on identical
    control flow.
  * **Admission keeps the chunk lanes fed**: ``_admit_one`` keeps up to
    ``engine.admission_capacity`` prefills in flight (1 for legacy
    single-lane engines); ``_poll_prefills`` harvests finished prefills
    every tick and, when the engine packs multiple lanes, tops the
    in-flight set back up from the arrival queue (the scheduler half of
    token-budget lane scheduling).
  * **Admission order is a pluggable policy**: each admission
    opportunity, ``_arrived`` hands the *whole* arrived set to the
    configured ``AdmissionPolicy`` (``repro_torch.core.policies``) — ``fifo``
    (default, legacy order), ``lpm`` (longest cached prompt prefix
    first, probed non-mutatingly via ``probe_cached_tokens``), ``edf``
    (earliest ``Request.deadline``), ``priority``, and compositions —
    under a starvation bound so no request is passed over unboundedly.
  * **Eager release**: completions, prunes and early stops free engine
    slots and pages the moment they happen; ``metrics()`` is only valid
    because ``_finalize`` releases the request's prefix exactly once.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..kv import OutOfPagesError
from ..serving.engine import BranchHandle, Engine
from .ensemble import best_of_n, majority_vote
from .policies import make_policy, select_next
from .pruning import PruningConfig, RequestMeta, TwoPhasePruner
from .prm import PRM

POLICIES = ("vanilla", "sc", "sart", "sart_noprune", "rebase")


class EvictionStallError(RuntimeError):
    """Raised (into the engine-fault path) when ``OutOfPagesError``
    pressure cannot be relieved: force-completing every live branch freed
    zero allocator pages — the pre-fix scheduler span forever here."""


class SchedulerFaultError(RuntimeError):
    """Engine faults exhausted ``max_engine_restarts``: the failure is
    persistent, so it propagates out of ``run()`` with the last cause
    chained instead of restarting forever."""


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "sart"
    n: int = 8                    # branches sampled per request
    m: int = 0                    # early-stop count (0 -> N//2, paper default)
    alpha: float = 0.5            # phase-1 prune threshold
    beta: int = 0                 # phase-1 prune cap (0 -> N//2)
    window: int = 16              # T: decode steps between pruning rounds
    max_tokens: int = 256         # per-branch generation cap
    rebase_temp: float = 0.2      # softmax temperature for rebase expansion
    preempt: bool = False         # beyond-paper: preemptible scheduling —
                                  # suspend the weakest running branch to
                                  # admit a waiting request's prefill
                                  # (the paper lists this as future work)
    # Admission-ordering policy over the arrived set ("fifo", "lpm",
    # "edf", "priority", or compositions like "priority+lpm" — see
    # repro_torch.core.policies). "fifo" is bit-exact legacy behavior.
    admission_policy: str = "fifo"
    # Pass-overs by younger requests a waiting request tolerates before
    # it preempts the policy ordering (mirrors the chunk-lane packer's
    # prefill_starvation_bound, one layer up).
    admission_starvation_bound: int = 4
    # Failure-domain isolation (docs/robustness.md). Attributable
    # admission faults retry up to retry_budget times with exponential
    # backoff (retry_backoff * 2**(retries-1) ticks) before the request
    # is quarantined; step_fault_tolerance consecutive non-attributable
    # decode faults trigger an engine restart, bounded by
    # max_engine_restarts before the fault propagates out of run().
    retry_budget: int = 3
    retry_backoff: int = 4
    step_fault_tolerance: int = 3
    max_engine_restarts: int = 8

    def resolve(self) -> "SchedulerConfig":
        """Normalized copy with policy-dependent defaults applied:
        vanilla forces n=m=1, sc/rebase keep all n branches, and m<=0
        becomes the paper's N//2 early-stop default (clamped to [1, n])."""
        n, m = self.n, self.m
        if self.policy == "vanilla":
            n, m = 1, 1
        elif self.policy in ("sc", "rebase"):
            m = n
        elif m <= 0:
            m = max(n // 2, 1)
        return dataclasses.replace(self, n=n, m=max(min(m, n), 1))


# eq=False: scheduler queues (prefilling, waiting) test membership and
# remove by identity — two requests with equal fields are still distinct
# requests (reprolint REP004)
@dataclasses.dataclass(eq=False)
class Request:
    request_id: int
    prompt: List[int]
    arrival: int
    payload: object = None        # task object (answer key, oracle grader)
    deadline: Optional[int] = None  # absolute clock the SLO wants finish by
    priority: int = 0             # tier (higher = more urgent)
    # runtime state
    passed_over: int = 0          # admissions of younger requests ahead of us
    meta: Optional[RequestMeta] = None
    prefill_state: object = None  # ChunkedPrefillState while chunks pend
    prefix_blocks: object = None
    last_logits: object = None
    ssm_state: object = None
    live: Dict[int, BranchHandle] = dataclasses.field(default_factory=dict)
    pending: int = 0              # branches awaiting a slot
    cached_tokens: int = 0        # prompt tokens served warm at admission
    completed: List = dataclasses.field(default_factory=list)
    first_service: int = -1
    first_branch: int = -1        # clock when the first branch was seated
    finish: int = -1
    final_answer: object = None
    # failure-domain state (docs/robustness.md)
    retries: int = 0              # attributable faults charged so far
    not_before: int = 0           # backoff: earliest re-admission clock
    quarantined: bool = False     # terminal: retry budget exhausted
    quarantine_reason: Optional[str] = None
    had_fault: bool = False       # saw any fault (drives `recovered`)

    @property
    def done(self) -> bool:
        """True once the scheduler stamped a finish clock (terminal)."""
        return self.finish >= 0


@dataclasses.dataclass
class Timeline:
    steps: List[int] = dataclasses.field(default_factory=list)
    live_branches: List[int] = dataclasses.field(default_factory=list)
    live_tokens: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, branches: int, tokens: int) -> None:
        """Append one sample of the live-branch/live-token occupancy."""
        self.steps.append(step)
        self.live_branches.append(branches)
        self.live_tokens.append(tokens)


class Scheduler:
    """Algorithm 1, parameterized by policy."""

    def __init__(self, engine: Engine, prm: PRM, cfg: SchedulerConfig,
                 answer_fn: Callable):
        self.engine = engine
        self.prm = prm
        self.cfg = cfg.resolve()
        self.answer_fn = answer_fn
        self.pruner = TwoPhasePruner(PruningConfig(
            alpha=self.cfg.alpha, beta=self.cfg.beta,
            enabled=self.cfg.policy == "sart"))
        self.admission = make_policy(self.cfg.admission_policy)
        self.request_queue: deque = deque()
        self.branch_queue: deque = deque()   # requests with pending spawns
        self.prefilling: List[Request] = []  # admitted, chunks still pending
        self.suspended: deque = deque()      # preempted branches to resume
        self.requests: Dict[int, Request] = {}
        self.clock = 0
        self.timeline = Timeline()
        self._next_request_id = 0
        # failure-domain accounting (docs/robustness.md): quarantine /
        # retry / restart / recovered counters surface in metrics()
        self.fault_counters = {"step_faults": 0, "retries": 0,
                               "quarantined": 0, "requeued": 0,
                               "engine_restarts": 0, "recovered": 0,
                               "last_restart_clock": -1}
        self._fault_streak = 0    # consecutive non-attributable faults

    # ---------------------------------------------------------------- intake
    def submit(self, prompt: List[int], payload=None, arrival: int = 0,
               deadline: Optional[int] = None, priority: int = 0) -> Request:
        """Queue a request. ``deadline`` is an absolute clock tick the SLO
        wants ``finish`` by (drives ``edf`` ordering and the SLO-attainment
        metrics); ``priority`` is the tier for ``priority`` ordering."""
        req = Request(self._next_request_id, list(prompt), arrival, payload,
                      deadline=deadline, priority=priority)
        self._next_request_id += 1
        self.requests[req.request_id] = req
        self.request_queue.append(req)
        return req

    # ------------------------------------------------------------------ main
    def run(self, max_steps: int = 1_000_000) -> Dict:
        """Drive everything submitted so far to completion."""
        while self.clock < max_steps and not self._all_done():
            self._fill_batch()
            if self.engine.num_active == 0 and not self.prefilling:
                self.clock += 1            # idle: waiting for arrivals
                continue
            self._decode_window()
            self._window_bookkeeping()
        self._drain_truncated()
        return self.metrics()

    def _all_done(self) -> bool:
        """Quarantined requests are terminal too — the retry budget is
        exhausted, so waiting on them would spin forever."""
        return all(r.done or r.quarantined for r in self.requests.values())

    def _drain_truncated(self) -> None:
        """A run stopped at ``max_steps`` can leave admitted prompts with
        chunks still pending; abort their prefill states through the
        engine's normal release path so ``PageAllocator.check_invariants``
        holds after *every* run, and requeue the requests (they surface as
        unfinished in metrics, never dropped)."""
        if not self.prefilling:
            return
        for req in reversed(self.prefilling):
            if req.prefill_state is not None:
                self.engine.abort_prefill(req.prefill_state)
                req.prefill_state = None
            self.request_queue.appendleft(req)
            self.fault_counters["requeued"] += 1
        self.prefilling.clear()

    def probe_cached_tokens(self, req: Request) -> int:
        """Non-mutating prefix-cache probe for LPM ordering: how many of
        ``req``'s prompt tokens a warm admission would serve from cache
        right now. 0 for engines without a cache (LPM degrades to FIFO).
        The probe takes no page references and pollutes no hit counters —
        only actual admission does."""
        probe = getattr(self.engine, "match_cached_tokens", None)
        return probe(req.prompt) if probe is not None else 0

    def _arrived(self) -> Optional[Request]:
        """Select the next request to admit from the *whole* arrived set
        (the seed peeked only the queue head, so an arrived request parked
        behind a future-arrival head was never admitted). The configured
        admission policy orders the set; the starvation bound caps how
        often a request may be passed over (under ``fifo`` the choice is
        always the oldest arrived request — legacy order, bit-exact)."""
        arrived = [r for r in self.request_queue
                   if r.arrival <= self.clock
                   and r.not_before <= self.clock]
        if not arrived:
            return None
        chosen = select_next(self.admission, arrived, self,
                             self.cfg.admission_starvation_bound)
        self.request_queue.remove(chosen)
        return chosen

    # --------------------------------------------------------- batch filling
    def _fill_batch(self):
        """Algorithm 1 lines 3-11: branches first, then prefill requests.
        With ``preempt``, suspended branches resume with top priority."""
        while self.engine.free_slots:
            if self.suspended:
                h = self.suspended[0]
                if h.done or not self.engine.resume_branch(h):
                    self.suspended.popleft()
                    continue
                self.suspended.popleft()
            elif self.branch_queue:
                req = self.branch_queue[0]
                if req.done or req.pending <= 0:
                    self.branch_queue.popleft()
                    continue
                self._spawn_one(req)
                if req.pending <= 0:
                    self.branch_queue.popleft()
            else:
                # keep as many prefills in flight as the engine can pack
                # into one mixed step (admission_capacity = max chunk
                # lanes; 1 without a token budget) — admitting beyond that
                # would reserve prompts' pages long before any chunk runs,
                # starving live decode branches into eviction
                if not self._admit_one():
                    break
        # admission consumes no slot (chunks ride the decode step), so a
        # saturated batch doesn't block it — keep the lanes fed
        if not self.engine.free_slots:
            while self._admit_one():
                pass
        if self.cfg.preempt and not self.engine.free_slots:
            self._maybe_preempt()

    def _maybe_preempt(self):
        """Make progress for waiting work when every slot is taken.

        Admission consumes no slot (prefill chunks ride the decode step)
        and is handled by ``_fill_batch`` even when the batch is full, so
        only a waiting *branch* spawn justifies suspending the weakest
        running branch — the victim resumes as soon as a slot frees."""
        if not self.branch_queue:
            return
        victims = [h for h in self.engine.slots
                   if h is not None
                   and len(self.requests[h.request_id].live) > 1]
        if not victims:
            return
        # never-scored candidates default last_reward=0.0 and would tie
        # below every scored branch — score them first so a strong branch
        # that simply hasn't hit a scoring window isn't the victim
        for h in victims:
            if not h.scored:
                h.last_reward = self.prm.score(
                    self.requests[h.request_id], [h])[0]
                h.scored = True
        victim = min(victims, key=lambda h: h.last_reward)
        self.engine.suspend_branch(victim)
        self.suspended.append(victim)
        req = self.branch_queue[0]
        if not req.done and req.pending > 0:
            self._spawn_one(req)

    def _admit_one(self) -> bool:
        """Admit one arrived request if the engine's chunk lanes have room
        (``admission_capacity``: the max lanes one mixed step can carry —
        1 for legacy single-lane FIFO engines). Returns True if a request
        was admitted, False when at capacity, out of arrivals, or out of
        pages (the request is requeued). Any other admission exception is
        *attributable* to the request being admitted: it is routed to the
        quarantine/retry path instead of crashing ``run()`` — the seed
        popped the request from the arrived set and dropped it."""
        capacity = getattr(self.engine, "admission_capacity", 1)
        if len(self.prefilling) >= capacity:
            return False
        req = self._arrived()
        if req is None:
            return False
        try:
            self._admit(req)
        except OutOfPagesError:
            self.request_queue.appendleft(req)
            return False
        except Exception as exc:  # attributable: quarantine, don't crash
            self._quarantine_or_requeue(req, exc)
        return True

    def _quarantine_or_requeue(self, req: Request, exc: Exception) -> None:
        """Charge an attributable fault to ``req``: requeue it with
        exponential backoff while the retry budget lasts, then quarantine
        it terminally — it stays in metrics (finish=None, quarantined)
        rather than being dropped or retried forever."""
        if req in self.prefilling:
            self.prefilling.remove(req)
        if req.prefill_state is not None:
            self.engine.abort_prefill(req.prefill_state)
            req.prefill_state = None
        req.retries += 1
        req.had_fault = True
        if req.retries > self.cfg.retry_budget:
            req.quarantined = True
            req.quarantine_reason = repr(exc)
            self.fault_counters["quarantined"] += 1
        else:
            self.fault_counters["retries"] += 1
            req.not_before = (self.clock + self.cfg.retry_backoff
                              * (1 << (req.retries - 1)))
            self.request_queue.append(req)

    def _admit(self, req: Request):
        """Algorithm 1 PREFILL, now asynchronous and uniform across model
        families (attention, ssm, hybrid — ssm/hybrid chunks ride the
        masked-dt mixed step): admission allocates the prompt's pages and
        enqueues its chunks; they piggyback on decode steps instead of
        stalling the batch. With the engine's prefix cache enabled,
        ``begin_prefill`` serves the longest cached page-aligned prompt
        prefix from shared pages, so the state arrives with ``next_pos``
        already past the cached tokens and fewer chunks to drain. Only
        engines explicitly configured with ``chunked_prefill=False``
        return an already-done state and keep the seed's one-tick
        synchronous accounting."""
        req.prefill_state = self.engine.begin_prefill(req.prompt)
        if req.prefill_state.done:
            req.first_service = self.clock    # seed-exact sync accounting
            self.clock += 1               # legacy synchronous prefill tick
            self._harvest_prefill(req)
        else:
            self.prefilling.append(req)

    def _harvest_prefill(self, req: Request):
        """Prefill finished: collect its outputs, queue N branch spawns.
        Async requests get first_service stamped here — once their chunks
        have actually been served — so queueing delay keeps its meaning."""
        if req.first_service < 0:
            req.first_service = self.clock
        # prompt tokens the admission actually served from the prefix
        # cache — recorded once per request (unlike the cache's lookup
        # counters, which also see rolled-back OutOfPages retries)
        req.cached_tokens = getattr(req.prefill_state, "cached_tokens", 0)
        blocks, logits, ssm_state = self.engine.finish_prefill(
            req.prefill_state)
        req.prefill_state = None
        req.prefix_blocks = blocks
        req.last_logits = logits
        req.ssm_state = ssm_state
        if req.meta is None:
            req.meta = self.pruner.new_meta(self.cfg.n, self.cfg.m)
            req.pending = (self._rebase_initial_width()
                           if self.cfg.policy == "rebase" else self.cfg.n)
        # else: re-admission after an engine restart or snapshot restore —
        # pruner meta and completed branches survive; ``pending`` already
        # carries the branch budget the teardown preserved (in-flight
        # decode work resumes as resampling)
        self.branch_queue.append(req)

    def _poll_prefills(self) -> bool:
        """Harvest finished prefills and keep the engine's chunk lanes fed.

        With token-budget lane scheduling (``admission_capacity > 1``) this
        is the scheduler half of the lane packer: every decode tick it
        refills the in-flight prefill set from the admission queue up to
        the lane capacity, oldest-first — the engine-side
        ``pack_chunk_lanes`` then chooses which of them ride the next
        mixed step under the token budget (with its starvation bound).
        Legacy single-lane engines (capacity 1) keep the seed's admission
        points (window start + harvest refill) untouched."""
        harvested = False
        for req in [r for r in self.prefilling if r.prefill_state.done]:
            self.prefilling.remove(req)
            self._harvest_prefill(req)
            harvested = True
        if getattr(self.engine, "admission_capacity", 1) > 1:
            while self._admit_one():
                pass
        return harvested

    def _rebase_initial_width(self) -> int:
        return max(self.cfg.n // 2, 1)

    def _spawn_one(self, req: Request):
        h = self.engine.spawn_branch(
            req.request_id, req.prefix_blocks, req.last_logits,
            req.ssm_state, len(req.prompt), prompt_tokens=req.prompt)
        if h is None:
            return
        if req.first_branch < 0:
            req.first_branch = self.clock   # time-to-first-branch anchor
        req.live[h.branch_id] = h
        req.pending -= 1

    # -------------------------------------------------------------- decoding
    def _decode_window(self):
        """Up to T decode steps; completions release slots eagerly. Each
        step also advances one chunk of any pending prefill (mixed step);
        chunk-only steps keep ticking while the decode batch is empty."""
        for _ in range(self.cfg.window):
            if self.engine.num_active == 0 and not self.prefilling:
                break
            try:
                self.engine.decode_step()
            except OutOfPagesError:
                if not self._evict_longest():
                    # nothing evictable freed pages: route the stall to
                    # the engine-fault domain (bounded restarts) instead
                    # of retrying OutOfPages forever without progress
                    self._on_engine_fault(EvictionStallError(
                        "OutOfPages with no evictable progress: "
                        "force-completing every live branch freed 0 pages"))
                continue
            except Exception as exc:  # non-attributable: engine fault domain
                self._on_engine_fault(exc)
                continue
            self._fault_streak = 0
            # a faulty-but-alive engine can report slow steps (deadline
            # pressure): charge the extra ticks the step actually cost
            self.clock += 1 + getattr(self.engine, "last_step_penalty", 0)
            if self._poll_prefills():
                # seed parity: branches spawned the moment prefill finished;
                # refill mid-window instead of waiting out the window
                self._fill_batch()
            self._check_completions()
            self.timeline.record(self.clock, self.engine.num_active,
                                 self.engine.live_tokens())

    def _evict_longest(self) -> bool:
        """Memory pressure: force-complete live branches, longest first,
        until allocator pages are actually freed. Returns False when no
        victim frees anything (pages all prefix-cache-shared, or no live
        branches) — the pre-fix code force-completed one victim blindly
        and span the rest of the window retrying ``OutOfPagesError``."""
        live = sorted((h for h in self.engine.slots if h is not None),
                      key=lambda h: h.blocks.length, reverse=True)
        for victim in live:
            req = self.requests[victim.request_id]
            before = self.engine.allocator.free_pages
            self._complete_branch(req, victim, truncated=True)
            self._maybe_finalize(req)
            if self.engine.allocator.free_pages > before:
                return True
        return False

    def _on_engine_fault(self, exc: Exception) -> None:
        """Non-attributable engine failure during decode: burn the tick,
        and after ``step_fault_tolerance`` consecutive faults restart the
        engine instead of crashing ``run()`` (bounded by
        ``max_engine_restarts``)."""
        self.fault_counters["step_faults"] += 1
        self._fault_streak += 1
        self.clock += 1               # the faulted step still cost a tick
        if self._fault_streak >= self.cfg.step_fault_tolerance:
            self._restart_engine(exc)

    def _restart_engine(self, cause: Optional[Exception] = None) -> None:
        """Engine-restart path: tear down all engine-resident state
        through the normal release paths (aborted prefills, freed
        branches, released prefixes — so allocator invariants hold and
        generated pages park warm on the prefix cache), requeue every
        unfinished request, and restart the engine if it supports it.
        Request-level progress (completed branches, rewards, pruner meta)
        survives; lost in-flight decode work resumes as resampling."""
        if (self.fault_counters["engine_restarts"]
                >= self.cfg.max_engine_restarts):
            raise SchedulerFaultError(
                f"engine fault persists after "
                f"{self.cfg.max_engine_restarts} restarts") from cause
        self.fault_counters["engine_restarts"] += 1
        self.fault_counters["last_restart_clock"] = self.clock
        self._fault_streak = 0
        survivors = []
        for req in self.requests.values():
            if req.done or req.quarantined:
                continue
            if req.prefill_state is not None:
                self.engine.abort_prefill(req.prefill_state)
                req.prefill_state = None
            if req.live:
                # in-flight branches are lost with the engine; preserve
                # the branch budget so they resample after re-admission
                req.pending += len(req.live)
                for h in list(req.live.values()):
                    self.engine.free_branch(h)
                req.live.clear()
            if req.prefix_blocks is not None:
                self.engine.release_prefix(req.prefix_blocks)
                req.prefix_blocks = None
            req.last_logits = None
            req.ssm_state = None
            req.had_fault = True
            if req not in self.request_queue:
                survivors.append(req)
        self.prefilling.clear()
        self.branch_queue.clear()
        self.suspended.clear()
        # survivors re-admit ahead of never-admitted arrivals, in id order
        for req in sorted(survivors, key=lambda r: r.request_id,
                          reverse=True):
            self.request_queue.appendleft(req)
        self.fault_counters["requeued"] += len(survivors)
        restart = getattr(self.engine, "restart", None)
        if restart is not None:
            restart()

    def _check_completions(self):
        for h in list(self.engine.slots):
            if h is None or h.done:
                continue  # freed earlier this pass (sibling's early stop)
            req = self.requests[h.request_id]
            eos = h.tokens[-1] == self.engine.cfg.eos_id
            full = len(h.tokens) >= self.cfg.max_tokens
            if eos or full:
                self._complete_branch(req, h, truncated=full and not eos)
                self._maybe_finalize(req)

    def _complete_branch(self, req: Request, h: BranchHandle,
                         truncated: bool = False):
        """Record a branch completion. ``truncated`` (force-eviction or
        max-token cap) rides the completion tuple and is excluded from the
        pruner's phase-2 α′ threshold — a cut-off branch's reward is not
        evidence a finished answer exists at that quality."""
        reward = self.prm.score(req, [h])[0]
        self.pruner.on_completion(req.meta, reward, truncated=truncated)
        req.completed.append((list(h.tokens), reward, truncated))
        del req.live[h.branch_id]
        self.engine.free_branch(h)

    # ----------------------------------------------------------- bookkeeping
    def _window_bookkeeping(self):
        """Pruning / early-stop checks at window granularity (lines 23-41)."""
        for req in list(self.requests.values()):
            if req.done or req.meta is None:
                continue
            if self.cfg.policy == "rebase":
                self._rebase_step(req)
            elif req.live and self.pruner.cfg.enabled:
                # suspended branches (slot == -1) hold no engine row; they
                # are scored/pruned once resumed
                handles = [h for h in req.live.values() if h.slot >= 0]
                if not handles:
                    continue
                rewards = self.prm.score(req, handles)
                by_id = {h.branch_id: r for h, r in zip(handles, rewards)}
                for h, r in zip(handles, rewards):
                    h.last_reward = r
                    h.scored = True
                for bid in self.pruner.select_prunes(req.meta, by_id):
                    h = req.live.pop(bid)
                    self.engine.free_branch(h)
            self._maybe_finalize(req)

    def _maybe_finalize(self, req: Request):
        if req.done or req.meta is None:
            return
        live_or_pending = len(req.live) + req.pending
        if req.meta.num_completed >= req.meta.m or live_or_pending == 0:
            self._finalize(req)

    def _finalize(self, req: Request):
        """Early stop: terminate remaining branches, pick the final answer."""
        for h in list(req.live.values()):
            self.engine.free_branch(h)
        req.live.clear()
        req.pending = 0
        if req.prefix_blocks is not None:
            self.engine.release_prefix(req.prefix_blocks)
            req.prefix_blocks = None
        if self.cfg.policy == "sc":
            req.final_answer = majority_vote(req.completed, self.answer_fn)
        else:
            req.final_answer = best_of_n(req.completed, self.answer_fn)
        req.finish = self.clock
        if req.had_fault:
            self.fault_counters["recovered"] += 1

    # ---------------------------------------------------------------- rebase
    def _rebase_step(self, req: Request):
        """Reward-guided tree search: cull weak leaves, fork strong ones."""
        if not req.live:
            return
        handles = list(req.live.values())
        rewards = np.asarray(self.prm.score(req, handles))
        for h, r in zip(handles, rewards):
            h.last_reward = float(r)
            h.scored = True
        # cull leaves far below the best (soft budget reallocation)
        if len(handles) > 1:
            weights = np.exp((rewards - rewards.max()) / self.cfg.rebase_temp)
            weights /= weights.sum()
            cut = weights < 0.5 / len(handles)
            for h, c in zip(handles, cut):
                if c and len(req.live) > 1:
                    req.meta.num_pruned += 1
                    del req.live[h.branch_id]
                    self.engine.free_branch(h)
        # expand best leaves while under budget and slots are free
        total = (len(req.live) + req.meta.num_completed
                 + req.pending)
        ranked = sorted(req.live.values(), key=lambda h: -h.last_reward)
        for h in ranked:
            if total >= self.cfg.n or not self.engine.free_slots:
                break
            child = self.engine.fork_branch(h)
            if child is None:
                break
            req.live[child.branch_id] = child
            total += 1

    # ----------------------------------------------------- checkpoint/restore
    def snapshot(self) -> Dict:
        """JSON-serializable checkpoint of *request-level* progress:
        completed branch tokens+rewards+truncated flags, pruner meta, the
        clock and fault counters, and each request's queue/terminal
        standing. Engine-resident state — KV pages, prefill chunk
        progress, in-flight branch tokens — is deliberately NOT
        checkpointed: after ``restore`` survivors re-admit from the
        queue, the prefix cache resurrects warm prompt (and generated)
        prefixes, and lost in-flight decode resumes as resampling.
        ``payload`` objects and the ``Timeline`` are also excluded
        (re-attach payloads after restore if graders need them)."""
        reqs = []
        for req in self.requests.values():
            reqs.append({
                "request_id": req.request_id,
                "prompt": list(req.prompt),
                "arrival": req.arrival,
                "deadline": req.deadline,
                "priority": req.priority,
                "passed_over": req.passed_over,
                "retries": req.retries,
                "not_before": req.not_before,
                "quarantined": req.quarantined,
                "quarantine_reason": req.quarantine_reason,
                "had_fault": req.had_fault,
                "first_service": req.first_service,
                "first_branch": req.first_branch,
                "finish": req.finish,
                "final_answer": req.final_answer,
                "cached_tokens": req.cached_tokens,
                "completed": [[list(t), float(r), bool(tr)]
                              for t, r, tr in req.completed],
                # branch budget still owed: live branches collapse to
                # pending spawns on restore (resampling)
                "outstanding": len(req.live) + req.pending,
                "meta": (dataclasses.asdict(req.meta)
                         if req.meta is not None else None),
            })
        return {"version": 1, "clock": self.clock,
                "next_request_id": self._next_request_id,
                "fault_counters": dict(self.fault_counters),
                "requests": reqs}

    @classmethod
    def restore(cls, snap: Dict, engine: Engine, prm: PRM,
                cfg: SchedulerConfig, answer_fn: Callable) -> "Scheduler":
        """Rebuild a scheduler from ``snapshot()`` output against a fresh
        engine. Finished and quarantined requests keep their terminal
        records; every other request is requeued for re-admission with
        its completed branches, pruner meta and remaining branch budget
        intact (``_harvest_prefill`` skips re-initializing meta)."""
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')!r}")
        sch = cls(engine, prm, cfg, answer_fn)
        sch.clock = snap["clock"]
        sch._next_request_id = snap["next_request_id"]
        sch.fault_counters.update(snap.get("fault_counters", {}))
        for rec in snap["requests"]:
            req = Request(rec["request_id"], list(rec["prompt"]),
                          rec["arrival"], None, deadline=rec["deadline"],
                          priority=rec["priority"])
            req.passed_over = rec["passed_over"]
            req.retries = rec["retries"]
            req.not_before = rec["not_before"]
            req.quarantined = rec["quarantined"]
            req.quarantine_reason = rec["quarantine_reason"]
            req.had_fault = rec["had_fault"]
            req.first_service = rec["first_service"]
            req.first_branch = rec["first_branch"]
            req.finish = rec["finish"]
            req.final_answer = rec["final_answer"]
            req.cached_tokens = rec["cached_tokens"]
            req.completed = [(list(t), float(r), bool(tr))
                             for t, r, tr in rec["completed"]]
            req.pending = rec["outstanding"]
            if rec["meta"] is not None:
                req.meta = RequestMeta(**rec["meta"])
            sch.requests[req.request_id] = req
            if not (req.done or req.quarantined):
                sch.request_queue.append(req)
        return sch

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> Dict:
        """Per-request records + aggregates. Requests still live when the
        run stops (``max_steps`` overload) are emitted with
        ``finish=None`` and null latencies instead of being dropped —
        omitting them survivorship-biases every percentile optimistic
        exactly when the system is saturated. ``percentile_latency``
        skips the null fields explicitly."""
        recs = []
        for req in self.requests.values():
            done = req.done
            recs.append({
                "request_id": req.request_id,
                "arrival": req.arrival,
                "first_service": (req.first_service
                                  if req.first_service >= 0 else None),
                "finish": req.finish if done else None,
                "e2e": req.finish - req.arrival if done else None,
                "queue": (req.first_service - req.arrival
                          if req.first_service >= 0 else None),
                "ttfb": (req.first_branch - req.arrival
                         if req.first_branch >= 0 else None),
                "inference": (req.finish - req.first_service
                              if done and req.first_service >= 0 else None),
                "num_completed": req.meta.num_completed if req.meta else 0,
                "num_pruned": req.meta.num_pruned if req.meta else 0,
                "num_truncated": req.meta.num_truncated if req.meta else 0,
                "prompt_tokens": len(req.prompt),
                "cached_tokens": req.cached_tokens,
                "deadline": req.deadline,
                # None without a deadline; an unfinished deadline is a miss
                "deadline_met": (None if req.deadline is None
                                 else done and req.finish <= req.deadline),
                "answer": req.final_answer,
                "response_lengths": [len(t) for t, *_ in req.completed],
                "retries": req.retries,
                "quarantined": req.quarantined,
            })
        slo = [r for r in recs if r["deadline"] is not None]
        met = sum(1 for r in slo if r["deadline_met"])
        out = {"requests": recs, "timeline": self.timeline,
               "clock": self.clock,
               "decode_steps": self.engine.decode_steps_executed,
               "completed_requests": sum(1 for r in recs
                                         if r["finish"] is not None),
               "unfinished_requests": sum(1 for r in recs
                                          if r["finish"] is None),
               "admission_policy": self.admission.name,
               "slo": {
                   "with_deadline": len(slo),
                   "deadline_met": met,
                   "deadline_missed": len(slo) - met,
                   "attainment": met / len(slo) if slo else None,
               }}
        # radix prefix-cache counters (hit rate, evictions, ...) when the
        # engine serves admission through one — cached-prefix admission is
        # part of the scheduling story (warm hits skip chunk steps), so
        # the metrics dict carries it next to the latency percentiles
        stats = getattr(self.engine, "prefix_cache_stats", None)
        pc = stats() if callable(stats) else None
        if pc is not None:
            out["prefix_cache"] = pc
        # failure-domain counters (always present; all-zero on clean runs)
        # plus the injector's own tallies when a FaultInjector drives the
        # run — chaos benchmarks key on these (docs/robustness.md)
        out["faults"] = dict(self.fault_counters)
        out["faults"]["quarantined_requests"] = sum(
            1 for r in recs if r["quarantined"])
        inj = getattr(self.engine, "fault_stats", None)
        if callable(inj):
            out["faults"]["injected"] = inj()
        return out


def percentile_latency(metrics: Dict, q: float, key: str = "e2e") -> float:
    """Percentile over finished measurements only: unfinished requests
    carry ``None`` for every latency field (``metrics()`` emits them so
    overload runs are visible, not silently optimistic) and are skipped
    explicitly here. Check ``metrics["unfinished_requests"]`` before
    trusting a percentile from a saturated run."""
    vals = [r[key] for r in metrics["requests"] if r[key] is not None]
    if not vals:
        return float("nan")
    return float(np.percentile(vals, q))
