"""Mixture-of-Experts FFN with capacity-based dispatch, as plain torch ops.

Counterpart of ``repro.models.moe``: tokens are routed top-k, sorted by
expert id (stable), scattered into a dense ``[E, C, D]`` buffer (capacity
C from the static row count, overflow dropped), run through the expert
MLPs as batched matmuls against ``[E, D, F]`` weights, and combined back
with the router gates. The reference computes the expert products with
``jnp.einsum`` outside any Pallas kernel; here they are ``torch.bmm``.

Every shape depends on the row count alone and no value is read on the
host, so the body captures into the engine's step graphs: the drop is a
scatter into a ``[E, C + 1, D]`` buffer whose last row takes every
dropped token and is sliced off (the reference's ``mode="drop"``), and
the combine adds each token's k contributions in ascending expert id,
the order the reference's scatter-add meets them, without atomics, so a
replay gives the same bits as the eager step.

The capacity is sized from every row of the call: in the engine's step
that includes empty slots and chunk pad rows, as in the reference, so a
valid row's assignment can depend on the other rows of its step.

The reference's shard-local dispatch (``moe_dp_chunks() > 1``) belongs
to the distribution slice, which the port does not have yet; this is the
global dispatch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .config import ModelConfig
from .layers import _act, dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    """Router ``[D, E]`` and expert weights ``w_up``/``w_gate`` ``[E, D,
    F]``, ``w_down`` ``[E, F, D]`` in ``dtype``, each drawn in fp32 and
    cast on its own (one expert tensor of temporaries at a time)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, e), 0, dtype, device),
        "w_up": dense_init(gen, (e, d, f), 1, dtype, device),
        "w_down": dense_init(gen, (e, f, d), 1, dtype, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (e, d, f), 1, dtype, device)
    return p


def router_probs(cfg: ModelConfig, p: dict, x_flat: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat [T, D] -> (gates [T, k] fp32, expert_ids [T, k], the
    Switch load-balance aux loss, an fp32 scalar). The router logits are
    computed in the model dtype, then softmaxed in fp32."""
    logits = (x_flat @ p["router"]).float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = cfg.num_experts
    density = _one_hot(expert_ids[:, 0], e).mean(0)
    aux = (density * probs.mean(0)).sum() * e * cfg.router_aux_coef
    return gates, expert_ids, aux


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``ids`` over ``n`` classes, by comparison
    (``F.one_hot`` checks its range with a host read)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).float()


def _capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` rows, rounded up to 8 (at least 8)."""
    c = int(t * cfg.num_experts_per_tok * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _dispatch(cfg: ModelConfig, x_flat: torch.Tensor, gates: torch.Tensor,
              expert_ids: torch.Tensor, cap: int):
    """Sort-based capacity dispatch of [T, D] tokens into [E, cap, D].

    Returns (buf, indices): ``indices`` is (sorted_expert, pos_in_expert,
    keep, token_order, gate_order, order) over the T*k assignments in
    expert order; ``order`` maps them back to token order."""
    t, d = x_flat.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    flat_expert = expert_ids.reshape(t * k)
    idx = torch.arange(t * k, device=x_flat.device)
    flat_token = idx // k
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    # rank within each expert's group of the sorted stream
    is_start = torch.ones_like(sorted_expert, dtype=torch.bool)
    is_start[1:] = sorted_expert[1:] != sorted_expert[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos_in_expert = idx - group_start
    keep = pos_in_expert < cap
    token_order = flat_token[order]
    # a dropped assignment lands on row ``cap``, which is sliced off
    buf = x_flat.new_zeros((e, cap + 1, d))
    buf[sorted_expert, torch.where(keep, pos_in_expert, cap)] = \
        x_flat[token_order]
    indices = (sorted_expert, pos_in_expert, keep, token_order,
               gates.reshape(t * k)[order], order)
    return buf[:, :cap], indices


def _combine(out_buf: torch.Tensor, indices, t: int,
             dtype) -> torch.Tensor:
    """Route [E, cap, D] expert outputs back to [T, D] token order in
    ``dtype``: each assignment's output times its gate, cast to
    ``dtype``, and each token's k contributions added in ascending
    expert id (the stream is sorted by expert, stably), as the
    reference's scatter-add into zeros does, with no atomics."""
    sorted_expert, pos_in_expert, keep, _, gate_order, order = indices
    d = out_buf.shape[-1]
    k = order.shape[0] // t
    gathered = out_buf[sorted_expert, torch.where(keep, pos_in_expert, 0)]
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = (gathered * gate_order[:, None]).to(dtype)     # [T*k, D]
    # the assignment at stream position i is (token order[i] // k, slot
    # order[i] % k); rank the k slots of each token by expert id
    stream_pos = torch.empty_like(order)
    stream_pos[order] = torch.arange(order.shape[0], device=order.device)
    by_expert = torch.sort(stream_pos.view(t, k), dim=-1).values
    parts = contrib[by_expert.reshape(-1)].view(t, k, d)
    y = torch.zeros((t, d), dtype=dtype, device=out_buf.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


def _expert_ffn(cfg: ModelConfig, p: dict, buf: torch.Tensor
                ) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D] through each expert's MLP."""
    up = torch.bmm(buf, p["w_up"])
    if cfg.mlp_gated:
        h = _act(cfg.mlp_activation, torch.bmm(buf, p["w_gate"])) * up
    else:
        h = _act(cfg.mlp_activation, up)
    return torch.bmm(h, p["w_down"])


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux loss): the global dispatch over
    all B * S rows (the capacity counts every one of them)."""
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    gates, expert_ids, aux = router_probs(cfg, p, x_flat)
    buf, indices = _dispatch(cfg, x_flat, gates, expert_ids,
                             _capacity(cfg, t))
    y = _combine(_expert_ffn(cfg, p, buf), indices, t, x.dtype)
    return y.reshape(b, s, d), aux


def apply_moe_dense_eval(cfg: ModelConfig, p: dict,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain version: every expert on every token, combined with the
    gates (O(E x the FFN); small-shape tests of the dispatch only)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    gates, expert_ids, _ = router_probs(cfg, p, x_flat)
    up = torch.einsum("td,edf->tef", x_flat, p["w_up"])
    if cfg.mlp_gated:
        h = _act(cfg.mlp_activation,
                 torch.einsum("td,edf->tef", x_flat, p["w_gate"])) * up
    else:
        h = _act(cfg.mlp_activation, up)
    all_out = torch.einsum("tef,efd->ted", h, p["w_down"])   # [T, E, D]
    mask = _one_hot(expert_ids, cfg.num_experts)
    weights = torch.einsum("tk,tke->te", gates, mask)          # [T, E]
    y = torch.einsum("te,ted->td", weights, all_out.to(weights.dtype))
    return y.reshape(b, s, d).to(x.dtype)
