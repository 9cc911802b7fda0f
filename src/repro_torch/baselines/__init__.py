"""Baseline serving policies (paper §5.1).

All baselines share the continuous-batching engine and live as policies
of ``repro_torch.core.Scheduler`` so the comparison is apples-to-apples
(the paper does the same: each baseline is integrated with continuous
batching and releases branches as they complete):

  * ``vanilla``       — no branch sampling (N = 1).
  * ``sc``            — Self-Consistency [Wang et al., ICLR'23]: N parallel
                        branches, wait for all N, majority vote.
  * ``rebase``        — reward-guided tree search [Wu et al., 2024]:
                        <= N live leaves, cull weak / fork strong every T
                        steps (see Scheduler._rebase_step).
  * ``sart_noprune``  — SART ablation: early stopping only (Fig. 6).

Use: ``SchedulerConfig(policy=<name>, ...)``. A copy of
``repro.baselines``, re-exporting the port's scheduler.
"""
from ..core.scheduler import POLICIES, Scheduler, SchedulerConfig

__all__ = ["POLICIES", "Scheduler", "SchedulerConfig"]
