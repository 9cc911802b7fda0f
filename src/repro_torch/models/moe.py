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

Two dispatch strategies, as the reference's:

  * global: one sort over all T rows, buffer ``[E, C, D]``.
  * shard-local (``moe_dp_chunks() = G > 1`` and G divides T): the rows
    regroup to ``[G, T/G, D]`` (G = the data shards), each group is
    dispatched and combined on its own with capacity ``_capacity(cfg,
    T/G)`` (a loop over ``_dispatch``/``_combine``), and the expert
    products run on ``[G, E, C, D]``.

Sharded (a DTensor ``x``, the steps of ``launch/steps.py``): the routing,
the scatter and the combine have no DTensor sharding strategy, so they
run on each rank's local rows under ``local_map`` (the global dispatch
over all rows, replicated; the shard-local one over the rank's own
groups), and the buffers are pinned to ``"ecd"``/``"gecd"`` (experts on
``"model"``) for the expert products.

In the engine's step graphs captured with the tracer on, the global
dispatch's device marks (``spans.device_mark``) time the routing, the
dispatch and the combine as ``moe_route`` and the expert products as
``moe_experts``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import spans
from ..distributed.local import as_dtensor, batch_placements, partial_where
from ..distributed.logical import constrain, moe_dp_chunks
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
    probs, gates, expert_ids = _route(cfg, p["router"], x_flat)
    return gates, expert_ids, _aux_loss(cfg, probs, expert_ids)


def _route(cfg: ModelConfig, router: torch.Tensor, x_flat: torch.Tensor):
    """(probs [T, E] fp32, gates [T, k], expert_ids [T, k])."""
    logits = (x_flat @ router).float()                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, expert_ids


def _aux_loss(cfg: ModelConfig, probs, expert_ids):
    """The Switch load-balance loss over every row, fp32 scalar."""
    e = cfg.num_experts
    density = _one_hot(expert_ids[:, 0], e).mean(0)
    return (density * probs.mean(0)).sum() * e * cfg.router_aux_coef


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
    """buf [E, C, D] (or [G, E, C, D]) -> the same shape through each
    expert's MLP."""
    mm = torch.bmm if buf.dim() == 3 else torch.matmul
    up = mm(buf, p["w_up"])
    if cfg.mlp_gated:
        h = _act(cfg.mlp_activation, mm(buf, p["w_gate"])) * up
    else:
        h = _act(cfg.mlp_activation, up)
    return mm(h, p["w_down"])


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux loss): the global dispatch over
    all B * S rows (the capacity counts every one of them), or the
    shard-local one when ``moe_dp_chunks()`` asks for it."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(cfg, p, x)
    b, s, d = x.shape
    t = b * s
    spans.device_mark("moe_route")
    x_flat = x.reshape(t, d)
    gates, expert_ids, aux = router_probs(cfg, p, x_flat)
    g = moe_dp_chunks()
    if g > 1 and t % g == 0:
        buf, indices = _dispatch_groups(
            cfg, x_flat.reshape(g, t // g, d), gates.reshape(g, t // g, -1),
            expert_ids.reshape(g, t // g, -1))
        y = _combine_groups(_expert_ffn(cfg, p, buf), indices, t // g,
                            x.dtype)
        return y.reshape(b, s, d), aux
    buf, indices = _dispatch(cfg, x_flat, gates, expert_ids,
                             _capacity(cfg, t))
    spans.device_mark("moe_experts")
    out = _expert_ffn(cfg, p, buf)
    spans.device_mark("moe_route")
    y = _combine(out, indices, t, x.dtype)
    return y.reshape(b, s, d), aux


def _dispatch_groups(cfg: ModelConfig, xg, gg, ig):
    """The shard-local dispatch: each of the G groups of ``xg`` [G, T/G,
    D] into its own ``[E, C, D]`` with capacity ``_capacity(cfg, T/G)``.
    Returns (buf [G, E, C, D], the groups' indices stacked)."""
    cap = _capacity(cfg, xg.shape[1])
    parts = [_dispatch(cfg, xg[i], gg[i], ig[i], cap)
             for i in range(xg.shape[0])]
    buf = torch.stack([b for b, _ in parts])
    indices = tuple(torch.stack(t) for t in zip(*(ind for _, ind in parts)))
    return buf, indices


def _combine_groups(out_buf, indices, tl: int, dtype):
    """[G, E, C, D] expert outputs back to [G, T/G, D], group by group
    (``tl`` = T/G rows a group)."""
    return torch.stack([_combine(out_buf[i], tuple(t[i] for t in indices),
                                 tl, dtype)
                        for i in range(out_buf.shape[0])])


def _apply_moe_sharded(cfg: ModelConfig, p: dict, x: DTensor):
    """``apply_moe`` on DTensors: routing, scatter and combine on each
    rank's local rows under ``local_map``, the expert products on buffers
    with the experts on ``"model"``."""
    mesh = x.device_mesh
    b, s, d = x.shape
    t, k = b * s, cfg.num_experts_per_tok
    rep = (Replicate(),) * mesh.ndim
    x_flat = x.reshape(t, d)
    bp = batch_placements(x_flat)
    x_flat = x_flat.redistribute(mesh, bp)
    bdims = tuple(i for i, pl in enumerate(bp) if pl == Shard(0))
    router = as_dtensor(p["router"], mesh, rep)
    probs, gates, expert_ids = local_map(
        lambda xl, rl: _route(cfg, rl, xl), out_placements=(bp, bp, bp),
        in_placements=(bp, rep), in_grad_placements=(
            bp, partial_where(rep, bdims)), device_mesh=mesh)(x_flat, router)
    aux = _aux_loss(cfg, probs, expert_ids)
    g = moe_dp_chunks()
    if g > 1 and t % g == 0:
        tl = t // g
        xg = constrain(x_flat.reshape(g, tl, d), "gtd")
        gp = batch_placements(xg)
        xg = xg.redistribute(mesh, gp)
        gg = gates.reshape(g, tl, k).redistribute(mesh, gp)
        ig = expert_ids.reshape(g, tl, k).redistribute(mesh, gp)
        buf, *indices = local_map(
            lambda xl, gl, il: _flat(_dispatch_groups(cfg, xl, gl, il)),
            out_placements=(gp,) * 7, in_placements=(gp, gp, gp),
            device_mesh=mesh)(xg, gg, ig)
        out = constrain(_expert_ffn_local(cfg, p, constrain(buf, "gecd")),
                        "gecd").redistribute(mesh, gp)
        y = local_map(
            lambda ol, *il: _combine_groups(ol, tuple(il), tl, x.dtype),
            out_placements=list(gp), in_placements=(gp,) * 7,
            device_mesh=mesh)(out, *indices)
        return constrain(y, "gtd").reshape(b, s, d), aux
    x_r, g_r, i_r = (a.redistribute(mesh, rep)
                     for a in (x_flat, gates, expert_ids))
    cap = _capacity(cfg, t)
    buf, *indices = local_map(
        lambda xl, gl, il: _flat(_dispatch(cfg, xl, gl, il, cap)),
        out_placements=(rep,) * 7, in_placements=(rep, rep, rep),
        device_mesh=mesh)(x_r, g_r, i_r)
    out = constrain(_expert_ffn(cfg, p, constrain(buf, "ecd")), "ecd")
    y = local_map(lambda ol, *il: _combine(ol, tuple(il), t, x.dtype),
                  out_placements=list(rep), in_placements=(rep,) * 7,
                  device_mesh=mesh)(out.redistribute(mesh, rep), *indices)
    return y.reshape(b, s, d), aux


def _flat(buf_indices):
    buf, indices = buf_indices
    return (buf,) + tuple(indices)


def _expert_ffn_local(cfg: ModelConfig, p: dict, buf: DTensor) -> DTensor:
    """The expert products of the shard-local ``[G, E, C, D]`` buffers on
    each rank's groups and experts, the weights gathered over their FSDP
    axis (their gradient a partial sum over the groups' axes)."""
    mesh = buf.device_mesh
    bpl = tuple(buf.placements)
    gdims = tuple(i for i, pl in enumerate(bpl) if pl == Shard(0))
    wp = tuple(Shard(0) if pl == Shard(1) else Replicate() for pl in bpl)
    names = [n for n in ("w_up", "w_gate", "w_down") if n in p]
    ws = [as_dtensor(p[n], mesh, wp) for n in names]
    return local_map(
        lambda bl, *wl: _expert_ffn(cfg, dict(zip(names, wl)), bl),
        out_placements=list(bpl), in_placements=(bpl,) + (wp,) * len(ws),
        in_grad_placements=(bpl,) + (partial_where(wp, gdims),) * len(ws),
        device_mesh=mesh)(buf, *ws)


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
