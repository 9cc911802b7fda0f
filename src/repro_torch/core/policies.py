"""Pluggable cache- and SLO-aware admission policies for the scheduler.

The scheduler's admission loop used to be FIFO-with-a-starvation-bound
baked into ``Scheduler._arrived`` — worse, it peeked only the queue
*head*, so an already-arrived request parked behind a future-arrival head
was never admitted at all. This module replaces that with a policy object
that **orders the whole arrived set** at each admission opportunity:

  * ``fifo``      — submission order (bit-exact with the pre-policy
                    scheduler on in-order arrival workloads, and the
                    default).
  * ``lpm``       — longest-prefix-match, SGLang-style: probe the radix
                    prefix cache (``PrefixCache.match_tokens``, a
                    non-mutating lookup) for each queued prompt and admit
                    the hottest matches first, so warm pages are increfed
                    (and thereby pinned) before cold admissions evict
                    them.
  * ``edf``       — earliest-deadline-first over the optional absolute
                    ``Request.deadline`` clock; deadline-less requests
                    sort last.
  * ``priority``  — higher ``Request.priority`` tier first.

Policies **compose**: ``"priority+lpm"`` (or the equivalent
``"priority-then-lpm"``) orders by tier first and breaks ties by cache
hotness. Every ordering ends with the FIFO key, so selection is always
deterministic.

Starvation bound: any non-FIFO ordering can pass over an unlucky request
indefinitely (a cold prompt under ``lpm``, a deadline-less request under
``edf``). ``select_next`` therefore counts, per request, how many times a
*younger* request was admitted ahead of it; once that reaches the bound
(``SchedulerConfig.admission_starvation_bound``) the request is starved
and is admitted next — oldest starved request first — regardless of the
policy's preference. Under ``fifo`` the chosen request is always the
oldest arrived one, so the counters never move and behavior is exactly
the legacy order. The same skip-counting guarantee the chunk-lane packer
gives in-flight prefills (``pack_chunk_lanes``), applied one layer up.
"""
from __future__ import annotations

import math
from typing import (Any, List, Sequence, Tuple, Union, TYPE_CHECKING)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, types only
    from .scheduler import Request, Scheduler

ADMISSION_POLICIES = ("fifo", "lpm", "edf", "priority")

# spec separators, all equivalent: "priority+lpm" == "priority-then-lpm"
_SEPARATORS = ("-then-", "+", ",")


class AdmissionPolicy:
    """Orders the arrived-request set; lower ``key`` admits first."""

    name = "fifo"

    def key(self, req: "Request", sched: "Scheduler") -> Tuple[Any, ...]:
        """Sort key for ``req`` (lower = admitted earlier). ``sched`` is
        the driving ``Scheduler`` — policies read clock/cache through it
        so ``Engine`` and ``SimEngine`` go through one code path."""
        return ()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class FifoPolicy(AdmissionPolicy):
    """Submission order (the request_id tiebreak carries the ordering)."""
    name = "fifo"


class LpmPolicy(AdmissionPolicy):
    """Longest-prefix-match: most cached prompt tokens first. Engines
    without a prefix cache probe as 0 everywhere — pure FIFO."""
    name = "lpm"

    def key(self, req: "Request", sched: "Scheduler") -> Tuple[Any, ...]:
        """Negated cached-token count: hotter prompts sort earlier."""
        return (-sched.probe_cached_tokens(req),)


class EdfPolicy(AdmissionPolicy):
    """Earliest absolute deadline first; deadline-less requests last."""
    name = "edf"

    def key(self, req: "Request", sched: "Scheduler") -> Tuple[Any, ...]:
        """Absolute deadline clock; ``inf`` parks deadline-less last."""
        return (req.deadline if req.deadline is not None else math.inf,)


class PriorityPolicy(AdmissionPolicy):
    """Higher priority tier first (default tier 0)."""
    name = "priority"

    def key(self, req: "Request", sched: "Scheduler") -> Tuple[Any, ...]:
        """Negated tier: higher-priority requests sort earlier."""
        return (-req.priority,)


class ComposedPolicy(AdmissionPolicy):
    """Lexicographic composition: earlier parts dominate, later parts
    break their ties (e.g. priority-then-lpm)."""

    def __init__(self, parts: Sequence[AdmissionPolicy]) -> None:
        self.parts = tuple(parts)
        self.name = "+".join(p.name for p in self.parts)

    def key(self, req: "Request", sched: "Scheduler") -> Tuple[Any, ...]:
        """Concatenation of the parts' keys, in composition order."""
        out: Tuple[Any, ...] = ()
        for p in self.parts:
            out += p.key(req, sched)
        return out


_REGISTRY = {
    "fifo": FifoPolicy,
    "lpm": LpmPolicy,
    "edf": EdfPolicy,
    "priority": PriorityPolicy,
}


def make_policy(spec: Union[str, AdmissionPolicy]) -> AdmissionPolicy:
    """Build a policy from a config string (``"fifo"``, ``"lpm"``,
    ``"edf"``, ``"priority"``, or compositions like ``"priority+lpm"`` /
    ``"priority-then-lpm"``). Policy instances pass through unchanged."""
    if isinstance(spec, AdmissionPolicy):
        return spec
    s = str(spec).strip().lower()
    for sep in _SEPARATORS:
        s = s.replace(sep, " ")
    names = s.split()
    if not names:
        raise ValueError(f"empty admission policy spec {spec!r}")
    try:
        parts = [_REGISTRY[n]() for n in names]
    except KeyError as e:
        raise ValueError(
            f"unknown admission policy {e.args[0]!r} in {spec!r}; "
            f"known: {', '.join(sorted(_REGISTRY))}") from None
    return parts[0] if len(parts) == 1 else ComposedPolicy(parts)


def select_next(policy: AdmissionPolicy, arrived: List["Request"],
                sched: "Scheduler", starvation_bound: int) -> "Request":
    """Pick the next request to admit from the arrived set.

    Starved requests (passed over ``starvation_bound`` times by younger
    ones) preempt the policy ordering, oldest first, so no request is
    deferred unboundedly. Otherwise the policy's key orders the set, with
    submission order as the final tiebreak. Bookkeeping: every request
    older than the chosen one records one pass-over.
    """
    starved = [r for r in arrived if r.passed_over >= starvation_bound]
    if starved:
        chosen = min(starved, key=lambda r: r.request_id)
    else:
        chosen = min(arrived,
                     key=lambda r: policy.key(r, sched) + (r.request_id,))
    for r in arrived:
        if r is not chosen and r.request_id < chosen.request_id:
            r.passed_over += 1
    chosen.passed_over = 0
    return chosen
