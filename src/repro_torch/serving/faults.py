"""Deterministic fault injection for the serving stack (chaos harness).

Production serving fails in ways the happy-path tests never exercise: the
KV pool briefly over-commits, a device step raises, logits come back NaN,
a step stalls long enough to threaten deadlines, or the whole engine
process dies mid-run. ``FaultInjector`` wraps any object implementing the
engine interface (``repro_torch.serving.Engine`` live, ``SimEngine`` traced)
behind the *same* duck-typed surface the ``Scheduler`` already drives, and
injects those failures at points planned by a seeded ``FaultPlan`` — so
every chaos run is replayable token-for-token from ``(plan, workload
seed)`` and every fixed bug gets a deterministic regression test.

A copy of ``repro.serving.faults``. The injector touches no tensor: its
draws come from ``np.random.default_rng(plan.seed)`` in the same order, so
one plan gives the same fault sequence in both packages. It raises the
port's own ``OutOfPagesError``, the class the port's scheduler catches
for eviction. On the card a ``CorruptedLogitsFault`` follows a step whose
graph replay ran; the next step replays the same graph.

Fault taxonomy (see docs/robustness.md for how the scheduler reacts):

  * ``OutOfPagesError`` storm — ``decode_step`` raises the allocator's
    own exception *before* touching engine state, modeling transient KV
    over-commit. The scheduler's eviction path handles it.
  * ``InjectedStepFault`` — ``decode_step`` raises before delegating (the
    step never ran): a generic non-attributable engine failure.
  * ``CorruptedLogitsFault`` — the inner step *runs to completion* and
    then the wrapper raises: models NaN/garbage logits detected after
    state was already mutated. The scheduler must tolerate a step whose
    side effects landed but whose output is unusable.
  * slow step — no exception; the wrapper sets ``last_step_penalty`` so
    the scheduler charges extra clock ticks (deadline pressure).
  * ``EngineCrashFault`` — hard crash at planned step indices: the
    injector goes dead and every subsequent ``decode_step`` fails until
    ``restart()`` — the scheduler's engine-restart path must kick in.
  * ``PoisonedRequestFault`` — ``begin_prefill`` rejects any prompt
    containing ``poison_token``, *every* time: a request-attributable
    fault that must end in quarantine, never an infinite retry loop.
  * transient admission fault — ``begin_prefill`` fails at
    ``admit_fail_rate``: attributable but transient, so bounded retry
    with backoff must eventually admit the request.

Determinism contract: one uniform draw per fault category per
``decode_step`` call, in a fixed order, regardless of which rates are
enabled — so turning one category on never shifts another category's
draw sequence, and a chaos failure replays exactly from its seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..kv import OutOfPagesError


class InjectedFault(RuntimeError):
    """Base class for every failure raised by the injector."""


class InjectedStepFault(InjectedFault):
    """Non-attributable engine failure: the step never ran."""


class CorruptedLogitsFault(InjectedFault):
    """The step ran (state mutated) but produced unusable output."""


class EngineCrashFault(InjectedFault):
    """Hard crash: the engine is down until ``restart()``."""


class PoisonedRequestFault(InjectedFault):
    """Request-attributable admission failure (deterministic)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of what to inject and how often.

    Rates are per-``decode_step`` probabilities; ``crash_at`` lists
    injector step indices (the injector's own call counter, not the
    scheduler clock) that hard-crash the engine. An all-default plan
    injects nothing — the wrapper is then observationally identical to
    the bare engine (pinned by test)."""
    seed: int = 0
    oop_rate: float = 0.0         # OutOfPagesError storms
    step_rate: float = 0.0        # step-level exceptions (step never ran)
    nan_rate: float = 0.0         # corrupted logits (step ran, then raise)
    slow_rate: float = 0.0        # slow steps (extra clock ticks)
    slow_penalty: int = 8         # ticks a slow step costs beyond the 1
    crash_at: Tuple[int, ...] = ()  # decode_step indices that hard-crash
    admit_fail_rate: float = 0.0  # transient begin_prefill failures
    poison_token: Optional[int] = None  # prompts containing it never admit

    @property
    def enabled(self) -> bool:
        """False iff the plan can never inject anything."""
        return bool(self.oop_rate or self.step_rate or self.nan_rate
                    or self.slow_rate or self.crash_at
                    or self.admit_fail_rate
                    or self.poison_token is not None)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a CLI string: comma-separated ``key=value``
        pairs, with ``crash_at`` taking ``+``-separated step indices —
        e.g. ``"seed=3,step_rate=0.1,crash_at=50+120,poison_token=5"``."""
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in fields:
                raise ValueError(f"unknown FaultPlan field {key!r} "
                                 f"(have: {sorted(fields)})")
            if key == "crash_at":
                kwargs[key] = tuple(int(v) for v in val.split("+") if v)
            elif key in ("seed", "slow_penalty", "poison_token"):
                kwargs[key] = int(val)
            else:
                kwargs[key] = float(val)
        return cls(**kwargs)


class FaultInjector:
    """Engine wrapper injecting the faults a ``FaultPlan`` describes.

    Every attribute not overridden here (slots, allocator, cfg,
    spawn/fork/free/suspend/resume, prefix-cache probes, ...) delegates
    to the wrapped engine, so the ``Scheduler`` drives the wrapper
    through the identical duck-typed interface. Only ``decode_step`` and
    ``begin_prefill`` are intercepted."""

    def __init__(self, engine, plan: FaultPlan):
        self.inner = engine
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._crash_set = frozenset(plan.crash_at)
        self.steps_seen = 0           # injector call counter (crash_at base)
        self.dead = False             # crashed and not yet restarted
        self.last_step_penalty = 0    # extra ticks the last step cost
        self.counts = {"oop": 0, "step": 0, "nan": 0, "slow": 0,
                       "crash": 0, "admit": 0, "poisoned": 0, "restarts": 0}

    def __getattr__(self, name):
        # only reached for names not set on the wrapper itself
        return getattr(self.inner, name)

    # ------------------------------------------------------------ intercepts
    def decode_step(self):
        """Delegate one decode step, injecting per the plan. Draw order is
        fixed (oop, step, nan, slow) and unconditional so the stream stays
        aligned whichever categories are enabled."""
        self.last_step_penalty = 0
        if self.dead:
            raise EngineCrashFault(
                "engine is down (crashed; restart() required)")
        idx = self.steps_seen
        self.steps_seen += 1
        u_oop, u_step, u_nan, u_slow = self._rng.random(4)
        if idx in self._crash_set:
            self.dead = True
            self.counts["crash"] += 1
            raise EngineCrashFault(f"injected hard crash at step {idx}")
        if u_oop < self.plan.oop_rate:
            self.counts["oop"] += 1
            raise OutOfPagesError(f"injected OutOfPages storm at step {idx}")
        if u_step < self.plan.step_rate:
            self.counts["step"] += 1
            raise InjectedStepFault(f"injected step fault at step {idx}")
        out = self.inner.decode_step()
        if u_nan < self.plan.nan_rate:
            # the inner step already ran: state mutated, output unusable
            self.counts["nan"] += 1
            raise CorruptedLogitsFault(
                f"injected corrupted logits at step {idx}")
        if u_slow < self.plan.slow_rate:
            self.counts["slow"] += 1
            self.last_step_penalty = self.plan.slow_penalty
        return out

    def begin_prefill(self, prompt):
        """Delegate admission, rejecting poisoned prompts (always) and a
        seeded fraction of the rest (transient)."""
        if (self.plan.poison_token is not None
                and self.plan.poison_token in prompt):
            self.counts["poisoned"] += 1
            raise PoisonedRequestFault(
                f"prompt contains poison token {self.plan.poison_token}")
        if (self.plan.admit_fail_rate
                and self._rng.random() < self.plan.admit_fail_rate):
            self.counts["admit"] += 1
            raise InjectedStepFault("injected transient admission fault")
        return self.inner.begin_prefill(prompt)

    # ------------------------------------------------------------- lifecycle
    def restart(self) -> None:
        """Bring a crashed engine back up (scheduler restart path). The
        wrapped engine object survives — in this model a crash kills the
        serving pipeline, not the KV pool, so warm prefix-cache pages
        remain valid for resurrection on re-admission."""
        self.dead = False
        self.counts["restarts"] += 1
        inner_restart = getattr(self.inner, "restart", None)
        if inner_restart is not None:
            inner_restart()

    def fault_stats(self) -> dict:
        """Injection counters for ``Scheduler.metrics()['faults']``."""
        return dict(self.counts, steps_seen=self.steps_seen)
