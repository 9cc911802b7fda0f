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
on the params' device, so an update reads nothing back to the host. The
norm, clip scale, step and schedule are torch ops
(``update_scalars``); each leaf's update is one
``kernels/adamw/ops.py:adamw_leaf``, the fused kernel ``csrc/adamw.cu``
on the card (the counterpart of XLA's fusion of the reference's update)
and the plain loop body on the CPU.

Sharded (a DTensor params tree, the train step of ``launch/steps.py``):
mu and nu are DTensors with their param's placements (``opt_pspecs``:
each rank holds its own shard, never the whole). ``adamw_update`` first
brings each gradient to its param's placements, one collective a leaf
(a reduce-scatter where it comes back as a partial sum over the batch
axes). The global norm is then taken from the local shards: each leaf's
local sum of squares, counted on one rank of each replica group, and a
scalar all-reduce over each mesh dim, a plain 0-d tensor that the
kernels read. ``adamw_leaf`` runs on the four local tensors: on the card
one fused launch a leaf, as unsharded. The decay rule reads ``ndim``,
which a local shard shares with its global tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor import zeros as dtensor_zeros

from ..kernels.adamw.ops import adamw_leaf


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
    tensor on the params' device). A DTensor leaf gets DTensor moments
    with its placements, made shard by shard."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, DTensor):
            return dtensor_zeros(tree.shape, dtype=torch.float32,
                                 device_mesh=tree.device_mesh,
                                 placements=tree.placements)
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    device = _local(next(tree_leaves(params))).device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32. For DTensor
    leaves (sharded or replicated, never a partial sum) a plain 0-d
    tensor, the same on every rank: the local sums, a scalar all-reduce
    over each mesh dim, then the root."""
    leaves = list(tree_leaves(tree))
    total = sum(_sum_squares(g) for g in leaves)
    mesh = next((g.device_mesh for g in leaves if isinstance(g, DTensor)),
                None)
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def _sum_squares(g) -> torch.Tensor:
    """The fp32 sum of ``g``'s squares; of a DTensor, its local shard's,
    and 0 on a rank that is not the first of a mesh dim over which ``g``
    is replicated (so the all-reduce counts each element once)."""
    if not isinstance(g, DTensor):
        return torch.sum(torch.square(g.float()))
    if any(p.is_partial() for p in g.placements):
        raise ValueError("global_norm takes sharded or replicated "
                         f"gradients, not {g.placements}")
    s = torch.sum(torch.square(g.to_local().float()))
    coord = g.device_mesh.get_coordinate()
    if any(p.is_replicate() and c for p, c in zip(g.placements, coord)):
        return torch.zeros_like(s)
    return s


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def replicated(t):
    """A DTensor's whole value as a plain tensor (a 0-d result, the same
    on every rank); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


@torch.no_grad()
def update_scalars(cfg: AdamWConfig, grads, state
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The step's scalars, as torch ops on the grads' device: advances
    ``state["step"]`` by one in place and returns (grad_norm, (scale, lr,
    bc1, bc2)), the norm before clipping and the 0-d fp32 clip scale,
    learning rate and bias corrections that every leaf's update reads."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state["step"] += 1
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    bc1 = 1 - torch.pow(cfg.beta1, step)
    bc2 = 1 - torch.pow(cfg.beta2, step)
    return gnorm, (scale, lr, bc1, bc2)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, dict, torch.Tensor]:
    """One AdamW step, in place. Returns (params, state, grad_norm): the
    same trees, and the norm of the gradients before clipping. Each leaf
    is one ``kernels.adamw.ops.adamw_leaf``: on the card one launch of
    the fused kernel, on the CPU the plain loop body."""
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, DTensor) else g
             for p, g in zip(tree_leaves(params), tree_leaves(grads))]
    gnorm, scalars = update_scalars(cfg, dict(enumerate(grads)), state)
    for p, g, m, v in zip(tree_leaves(params), grads,
                          tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        if isinstance(p, DTensor):
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        adamw_leaf(p, g, m, v, *scalars, beta1=cfg.beta1, beta2=cfg.beta2,
                   eps=cfg.eps, weight_decay=cfg.weight_decay)
    return params, state, gnorm
