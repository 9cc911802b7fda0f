"""Two-phase dynamic pruning (paper §3 Solution 2, Figure 4).

Phase 1 — *exploration*: prune only branches whose PRM reward falls below a
low static threshold α, and never prune more than β branches total, so the
search stays wide while nothing has finished.

Phase 2 — *exploitation*: entered the moment the request's first branch
completes. The threshold is raised to α′ = reward of that first completed
branch, and the prune cap is lifted to N−1 — any live branch scoring below
what a finished answer already achieved is released immediately.

The pruner is pure bookkeeping over ``RequestMeta`` — no engine coupling —
so its invariants are property-tested in isolation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass
class RequestMeta:
    """Per-request scheduler metadata (Algorithm 1 line 16)."""
    n: int                            # branches sampled
    m: int                            # completions that trigger early stop
    phase: str = "explore"            # explore | exploit
    threshold: float = 0.0            # current pruning threshold
    max_num_pruned: int = 0           # β in phase 1, N-1 in phase 2
    num_completed: int = 0
    num_pruned: int = 0
    num_truncated: int = 0            # force-evicted / max-token cut-offs

    @property
    def terminal(self) -> bool:
        """All accounting done: early stop hit or nothing left running."""
        return (self.num_completed >= self.m
                or self.num_completed + self.num_pruned >= self.n)


@dataclasses.dataclass(frozen=True)
class PruningConfig:
    alpha: float = 0.5                # phase-1 threshold
    beta: int = 0                     # phase-1 prune cap (0 -> N//2 default)
    enabled: bool = True


class TwoPhasePruner:
    def __init__(self, cfg: PruningConfig):
        self.cfg = cfg

    def new_meta(self, n: int, m: int) -> RequestMeta:
        """Fresh per-request pruning state in the explore phase, with the
        phase-1 prune cap resolved (beta<=0 -> N//2, capped at n-1 so at
        least one branch always survives to completion)."""
        beta = self.cfg.beta if self.cfg.beta > 0 else max(n // 2, 1)
        return RequestMeta(n=n, m=m, phase="explore",
                           threshold=self.cfg.alpha,
                           max_num_pruned=min(beta, n - 1))

    def on_completion(self, meta: RequestMeta, reward: float,
                      truncated: bool = False) -> None:
        """Algorithm 1 lines 24-27: first completion flips to exploitation.

        ``truncated`` completions (force-evicted under memory pressure, or
        cut at the max-token cap) still count toward the early-stop M, but
        they must NOT flip the phase or set the α′ threshold: a cut-off
        branch's reward is not evidence that a *finished* answer at that
        quality exists, and letting it seed α′ would prune live branches
        against a phantom baseline."""
        meta.num_completed += 1
        if truncated:
            meta.num_truncated += 1
            return
        if meta.phase == "explore":
            meta.phase = "exploit"
            meta.threshold = reward       # α′
            meta.max_num_pruned = meta.n - 1

    def select_prunes(self, meta: RequestMeta,
                      rewards: Dict[int, float]) -> List[int]:
        """Algorithm 1 lines 32-37: pick branch ids to prune this window.

        ``rewards``: {branch_id: reward} for the request's *live* branches.
        Respects the phase cap; prunes lowest-reward first so the cap binds
        on the worst branches.
        """
        if not self.cfg.enabled:
            return []
        budget = meta.max_num_pruned - meta.num_pruned
        if budget <= 0:
            return []
        victims = sorted(
            (bid for bid, r in rewards.items() if r < meta.threshold),
            key=lambda bid: rewards[bid])
        victims = victims[:budget]
        meta.num_pruned += len(victims)
        return victims
