"""AdamW with a cosine/warmup schedule over the port's params tree.

Counterpart of ``repro.training.optimizer``, same arithmetic in the same
order: the gradients are clipped by their global fp32 norm, mu and nu
are fp32 whatever the params' dtype, the update is computed in fp32 and
cast back to each param's own dtype, and weight decay applies to every
leaf with ``ndim >= 2``. The layer params are stacked ``[L, ...]`` as in
the reference (``models/model.py:_stack_into``), so per-layer norm scales
(``[L, D]``) and QKV biases are decayed too and only ``final_norm``
(``[D]``) is not: the reference's rule, kept as it is for parity.

Unlike the reference's pure function, ``adamw_update`` writes the params
and the optimizer state IN PLACE (under ``torch.no_grad()``) and returns
the same trees: at full width a second copy of the params and of mu and
nu would not fit beside them. The step count and the learning rate stay
on the params' device, so an update reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The leaves of a nested dict in sorted key order (JAX's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), fp32 on its device:
    linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> dict:
    """Zero fp32 mu and nu shaped like ``params``, and step 0 (an int32
    tensor on the params' device)."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    device = next(tree_leaves(params)).device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, dict, torch.Tensor]:
    """One AdamW step, in place. Returns (params, state, grad_norm): the
    same trees, and the norm of the gradients before clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state["step"] += 1
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        g32 = g.float() * scale
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32.square_().mul_(1 - b2))
        del g32
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:   # decay matrices only (norms/bias exempt)
            delta.add_(p.float() * cfg.weight_decay)
        # (p.float() is p itself for an fp32 leaf: nothing here writes it
        # before the copy)
        p.copy_(p.float() - delta.mul_(lr))
    return params, state, gnorm
