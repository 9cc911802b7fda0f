"""Process Reward Models.

Counterpart of ``repro.core.prm``. The PRM is pluggable behind one
protocol — ``score(request, handles) -> rewards in [0,1]`` — with two
implementations:

  * ``RewardHeadPRM`` — a small MLP head over the serving model's own last
    hidden state (returned by every decode step for free).
  * ``OraclePRM`` — task-aware reward for controlled experiments: fraction
    of correct reasoning steps in the branch so far, plus seeded noise.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

# --------------------------------------------------------------- reward head


def init_prm_head(gen: torch.Generator, d_model: int, hidden_dim: int = 64,
                  device=None) -> dict:
    """Two-layer MLP reward head in fp32 (draws from ``gen``)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)
    return {
        "w1": randn(d_model, hidden_dim) * (d_model ** -0.5),
        "b1": torch.zeros((hidden_dim,), device=device),
        "w2": randn(hidden_dim) * (hidden_dim ** -0.5),
        "b2": torch.zeros((), device=device),
    }


def reward_logit(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Pre-sigmoid reward head output for ``hidden [..., D] -> [...]``;
    dispatches on the params' keys (MLP vs legacy linear head). The
    hidden state is promoted to the head's fp32, as JAX promotes it."""
    if "w1" in params:
        x = hidden.to(params["w1"].dtype)
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]
    x = hidden.to(params["w"].dtype)
    return x @ params["w"] + params["b"]   # legacy linear head


def reward_from_hidden(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., D] -> rewards [...] in (0, 1)."""
    return torch.sigmoid(reward_logit(params, hidden))



def prm_head_loss(params: dict, hidden: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on per-step goodness labels, in the stable
    form max(logit, 0) - logit * y + log1p(exp(-|logit|))."""
    logit = reward_logit(params, hidden)
    return torch.mean(torch.clamp(logit, min=0) - logit * labels
                      + torch.log1p(torch.exp(-logit.abs())))

# ------------------------------------------------------------------ protocols


class PRM:
    """Scores live branches of a request. Higher = more right-thinking."""

    def score(self, request, handles: Sequence) -> List[float]:
        """Reward in [0, 1] per handle, aligned with ``handles`` order."""
        raise NotImplementedError


class RewardHeadPRM(PRM):
    """Reads the engine's cached last-hidden rows for the handles' slots."""

    def __init__(self, engine):
        self.engine = engine

    def score(self, request, handles) -> List[float]:
        """Index the engine's per-slot reward vector by handle slot (one
        host sync per pruning round, not per handle)."""
        rewards = self.engine.score_slots()  # [max_slots]
        return [float(rewards[h.slot]) for h in handles]


class OraclePRM(PRM):
    """Deterministic task-aware reward with optional noise.

    ``grader(request, tokens) -> float in [0,1]`` judges the partial branch;
    the synthetic-task grader lives in ``repro_torch.data.tasks``.
    """

    def __init__(self, grader: Callable, noise: float = 0.0, seed: int = 0):
        self.grader = grader
        self.noise = noise
        self._rng = np.random.default_rng(seed)

    def score(self, request, handles) -> List[float]:
        """Grade each handle's partial token stream, clipping the noised
        reward back into [0, 1]."""
        out = []
        for h in handles:
            r = float(self.grader(request, h.tokens))
            if self.noise:
                r = float(np.clip(r + self._rng.normal(0, self.noise), 0, 1))
            out.append(r)
        return out
