# SART's primary contribution: redundant sampling with early stopping
# (early_stop), two-phase dynamic pruning (pruning), PRM scoring (prm),
# branch-granularity continuous batching (scheduler, Algorithm 1), and
# final-answer ensembling (ensemble).
from .early_stop import (empirical_mth_completion, expected_speedup,
                         order_statistic_cdf, order_statistic_expectation)
from .ensemble import best_of_n, majority_vote, weighted_vote
from .policies import (ADMISSION_POLICIES, AdmissionPolicy, ComposedPolicy,
                       EdfPolicy, FifoPolicy, LpmPolicy, PriorityPolicy,
                       make_policy, select_next)
from .prm import (PRM, OraclePRM, RewardHeadPRM, init_prm_head,
                  prm_head_loss, reward_from_hidden)
from .pruning import PruningConfig, RequestMeta, TwoPhasePruner
from .scheduler import (POLICIES, EvictionStallError, Request, Scheduler,
                        SchedulerConfig, SchedulerFaultError,
                        percentile_latency)

__all__ = [
    "order_statistic_cdf", "order_statistic_expectation",
    "empirical_mth_completion", "expected_speedup",
    "best_of_n", "majority_vote", "weighted_vote",
    "PRM", "OraclePRM", "RewardHeadPRM", "init_prm_head", "prm_head_loss",
    "reward_from_hidden",
    "PruningConfig", "RequestMeta", "TwoPhasePruner",
    "POLICIES", "EvictionStallError", "Request", "Scheduler",
    "SchedulerConfig", "SchedulerFaultError", "percentile_latency",
    "ADMISSION_POLICIES", "AdmissionPolicy", "ComposedPolicy",
    "EdfPolicy", "FifoPolicy", "LpmPolicy", "PriorityPolicy",
    "make_policy", "select_next",
]
