"""GQA attention: training (full/sliding-window causal), prefill and decode.

Counterpart of ``repro.models.attention``, same layouts: q ``[B, S, H,
hd]``, k and v ``[B, S, KV, hd]``, the dense decode cache ``[B, S_max, KV,
hd]`` (a ring buffer with a sliding window). The serving engine's paged
attention lives in ``repro_torch.kernels``; this module serves
``Model.forward``, ``Model.prefill`` (the engine's exact-length path) and
``Model.decode_step``.

Dispatch of the full-sequence paths (``attention_train``,
``attention_prefill``), decided by the config and the call alone, never by
the device or a failure: plain causal attention (no ``sliding_window``, no
``attn_logit_softcap``, no ``segment_ids``) goes through
``ops.flash_attention`` at every length (kernel K5 on the card, its plain
version on the CPU). The other cases, which K5 does not compute, use
``_attend`` up to ``CHUNKED_THRESHOLD`` tokens (and always with
``segment_ids``) and ``_attend_chunked`` above it, as the reference.
``attention_decode`` is plain torch ops, as the reference keeps it in jnp.
One difference from the reference: the reference's ``_attend`` casts the
probabilities to v's dtype before the P·V product; K5 keeps them in fp32.
The two agree in fp32 (ROADMAP section 3).

Sharded (DTensor inputs, the steps of ``launch/steps.py``): q, k and v
are pinned to ``"bshd"`` after the projection, and the attention itself
runs on each rank's local heads under ``local_map`` (K5 and its backward
on the card): batch on the data axes, query heads on ``"model"``, k/v
heads there too where they divide it. Otherwise k/v stay replicated over
``"model"`` and each rank slices the contiguous KV heads its query heads
read (the local GQA group must be whole). In decode, a cache whose
sequence is sharded over ``"model"`` (``cache_pspecs`` when the kv heads
do not divide it) holds a slab of keys per rank: only the owner of ``pos
% Smax`` writes, and the ranks' (m, l, acc) partials merge across the
slab axes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.local import (as_dtensor, batch_placements, model_dim,
                                 partial_where, shard_count, shard_dims,
                                 shard_index, split_last)
from ..distributed.logical import constrain
from ..kernels.flash_prefill.ops import flash_attention
from .config import ModelConfig
from .layers import apply_mrope, apply_rope, dense_init, positions_for

NEG_INF = -1e30

# Full-sequence attention materialises [Sq, Sk] scores; beyond this length
# the train/prefill paths of the cases K5 does not take switch to the
# chunked formulation, which keeps the transient at [q_chunk, Sk] per head.
CHUNKED_THRESHOLD = 2048
Q_CHUNK = 512


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device=None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (d, h * hd), 0, dtype, device),
        "wk": dense_init(gen, (d, kv * hd), 0, dtype, device),
        "wv": dense_init(gen, (d, kv * hd), 0, dtype, device),
        "wo": dense_init(gen, (h * hd, d), 0, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x [B, S, D] -> q [B, S, H, hd], k and v [B, S, KV, hd]."""
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_last(q, (cfg.num_heads, hd))
    k = split_last(k, (cfg.num_kv_heads, hd))
    v = split_last(v, (cfg.num_kv_heads, hd))
    return constrain(q, "bshd"), constrain(k, "bshd"), constrain(v, "bshd")


def _rotate(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            positions: torch.Tensor):
    """RoPE with [B, S] positions, M-RoPE with [B, S, 3]; sinusoidal
    and no positions leave q and k as they are."""
    if cfg.pos_embedding == "rope":
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    elif cfg.pos_embedding == "mrope":
        q = apply_mrope(cfg, q, positions)
        k = apply_mrope(cfg, k, positions)
    return q, k


def _attend(cfg: ModelConfig, q, k, v, mask):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]; mask: [B,1,Sq,Sk] bool
    (True = keep) or already [B,1,1,Sq,Sk]. Returns [B,Sq,H*hd]."""
    hd = q.shape[-1]
    groups = cfg.gqa_groups
    b, sq, h, _ = q.shape
    q = q.reshape(b, sq, cfg.num_kv_heads, groups, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores / (hd ** 0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores.masked_fill(~(mask[:, :, None] if mask.dim() == 4
                                  else mask), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h * hd)


def _attend_chunked(cfg: ModelConfig, q, k, v):
    """Causal (and sliding-window) attention in query chunks of
    ``Q_CHUNK``, O(chunk * Sk) transient scores. q: [B,S,H,hd]; k,v:
    [B,S,KV,hd], head-repeated up front as the reference does. Returns
    [B,S,H*hd]."""
    b, s, h, hd = q.shape
    groups = cfg.gqa_groups
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    chunk = min(Q_CHUNK, s)
    kpos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for c0 in range(0, s, chunk):
        qi = q[:, c0:c0 + chunk]
        qpos = c0 + torch.arange(qi.shape[1], device=q.device)[:, None]
        m = kpos <= qpos
        if cfg.sliding_window:
            m &= kpos > qpos - cfg.sliding_window
        scores = torch.einsum("bqhd,bshd->bhqs", qi, k).float()
        scores = scores * (1.0 / hd ** 0.5)
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            scores = torch.tanh(scores / c) * c
        scores = scores.masked_fill(~m[None, None], NEG_INF)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqs,bshd->bqhd", w, v))
    return torch.cat(outs, 1).reshape(b, s, h * hd)


def causal_mask(cfg: ModelConfig, sq: int, sk: int, q_offset=0,
                device=None):
    """[1,1,Sq,Sk] causal (+sliding window) mask."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if cfg.sliding_window:
        m &= kpos > qpos - cfg.sliding_window
    return m[None, None]


def _flash_ok(cfg: ModelConfig) -> bool:
    """Plain causal attention: the case K5 computes."""
    return not cfg.sliding_window and not cfg.attn_logit_softcap


def _attend_full(cfg: ModelConfig, q, k, v):
    """Causal attention over the whole sequence without segment ids,
    [B,S,H*hd]: K5 where it applies, else the reference's formulation."""
    if isinstance(q, DTensor):
        return _attend_full_sharded(cfg, q, k, v)
    b, s, h, hd = q.shape
    if _flash_ok(cfg):
        return flash_attention(q, k, v, causal=True).reshape(b, s, h * hd)
    if s > CHUNKED_THRESHOLD:
        return _attend_chunked(cfg, q, k, v)
    return _attend(cfg, q, k, v, causal_mask(cfg, s, s, device=q.device))


def attention_train(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None):
    """Full-sequence causal attention. Returns [B,S,D]."""
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rotate(cfg, q, k, positions)
    if segment_ids is None:
        return _attend_full(cfg, q, k, v) @ p["wo"]
    s = x.shape[1]
    seg = segment_ids[:, :, None] == segment_ids[:, None, :]
    mask = causal_mask(cfg, s, s, device=x.device) & seg[:, None]
    return _attend(cfg, q, k, v, mask) @ p["wo"]


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor):
    """Causal attention that also returns the (k, v) to seed a cache."""
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rotate(cfg, q, k, positions)
    return _attend_full(cfg, q, k, v) @ p["wo"], (k, v)


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     positions: torch.Tensor):
    """One decode step against a dense KV cache, updated IN PLACE.

    x: [B,1,D]; cache_k/v: [B,Smax,KV,hd]; positions: [B] absolute
    position of the new token. With a sliding window and a cache sized to
    it the write index wraps (``pos % Smax``, a ring buffer) and the slots
    holding the last ``min(pos+1, Smax)`` tokens are attended; RoPE is
    applied at write time with the absolute position. Returns (out
    [B,1,D], cache_k, cache_v) — the same cache tensors."""
    q, k, v = _project_qkv(cfg, p, x)          # q,k,v: [B,1,.,hd]
    q, k = _rotate(cfg, q, k, positions_for(cfg, positions[:, None]))
    if isinstance(cache_k, DTensor):
        out = _decode_sharded(cfg, q, k, v, cache_k, cache_v, positions)
    else:
        out = _decode_attend(cfg, q, k, v, cache_k, cache_v, positions)
    return out @ p["wo"], cache_k, cache_v


def _window(cfg: ModelConfig, smax: int) -> int:
    if cfg.sliding_window and cfg.sliding_window < 0x7FFFFFFF:
        return min(cfg.sliding_window, smax)
    return smax


def _decode_attend(cfg: ModelConfig, q, k, v, cache_k, cache_v, positions):
    """Write the new k/v at ``pos % Smax`` and attend over the valid
    slots. Returns [B,1,H*hd]."""
    b = q.shape[0]
    smax = cache_k.shape[1]
    write_idx = (positions % smax).long()
    bidx = torch.arange(b, device=q.device)
    cache_k[bidx, write_idx] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, write_idx] = v[:, 0].to(cache_v.dtype)
    ctx = positions[:, None] + 1                # tokens now in context
    slot = torch.arange(smax, device=q.device)[None, :]
    mask = slot < torch.clamp(ctx, max=_window(cfg, smax))  # valid slots
    return _attend(cfg, q, cache_k, cache_v, mask[:, None, None, :])


# ---------------------------------------------------------------------------
# sharded: the attention on each rank's local heads (or key slab)
# ---------------------------------------------------------------------------


def _local_cfg(cfg: ModelConfig, heads: int, kv_heads: int) -> ModelConfig:
    return cfg.replace(num_heads=heads, num_kv_heads=kv_heads,
                       head_dim=cfg.resolved_head_dim)


def _head_layout(cfg: ModelConfig, q: DTensor):
    """Placements of a head-local call: q's batch sharding, query heads
    on ``"model"`` where they divide it, k/v heads too where theirs do.
    Returns (q placements, k/v placements, k/v gradient placements,
    split): ``split`` when k/v stay replicated over ``"model"`` while the
    query heads are sharded, so each rank reads a slice of them and their
    gradient is a partial sum there."""
    mesh = q.device_mesh
    md = model_dim(mesh)
    qp = list(batch_placements(q))
    kp = list(qp)
    split = False
    if md >= 0 and qp[md] == Replicate() \
            and cfg.num_heads % mesh.size(md) == 0:
        qp[md] = Shard(2)
        if cfg.num_kv_heads % mesh.size(md) == 0:
            kp[md] = Shard(2)
        else:
            split = True
    kgrad = partial_where(kp, (md,)) if split else tuple(kp)
    return tuple(qp), tuple(kp), kgrad, split


def _slice_kv(cfg: ModelConfig, hl: int, rank: int, k, v):
    """The contiguous KV heads that query heads ``[rank*hl, (rank+1)*hl)``
    read, for k/v replicated over the query heads' axis."""
    groups = cfg.gqa_groups
    if hl % groups and groups % hl:
        raise ValueError(
            f"attention: {hl} local query heads do not make whole GQA "
            f"groups of {groups} (num_heads {cfg.num_heads}, num_kv_heads "
            f"{cfg.num_kv_heads}); choose a 'model' axis that keeps them")
    lo, n = rank * hl // groups, max(hl // groups, 1)
    return k[:, :, lo:lo + n].contiguous(), v[:, :, lo:lo + n].contiguous()


def _attend_full_sharded(cfg: ModelConfig, q: DTensor, k, v):
    """``_attend_full`` on each rank's local heads (K5 on the card)."""
    mesh = q.device_mesh
    qp, kp, kgrad, split = _head_layout(cfg, q)
    q = q.redistribute(mesh, qp)
    k, v = as_dtensor(k, mesh, kp), as_dtensor(v, mesh, kp)
    md = model_dim(mesh)
    rank = mesh.get_local_rank(md) if split else 0

    def body(ql, kl, vl):
        if split:
            kl, vl = _slice_kv(cfg, ql.shape[2], rank, kl, vl)
        return _attend_full(_local_cfg(cfg, ql.shape[2], kl.shape[2]),
                            ql, kl, vl)

    return local_map(body, out_placements=list(qp), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kgrad, kgrad),
                     device_mesh=mesh)(q, k, v)


def _decode_sharded(cfg: ModelConfig, q, k, v, cache_k: DTensor, cache_v,
                    positions):
    """``_decode_attend`` on each rank's local cache: its kv heads (query
    heads alongside), or its slab of the sequence."""
    mesh = cache_k.device_mesh
    cp = tuple(cache_k.placements)              # [B, Smax, KV, hd]
    bdims, sdims, hdims = (shard_dims(cp, d) for d in (0, 1, 2))
    qp = tuple(Shard(0) if i in bdims else Shard(2) if i in hdims
               else Replicate() for i in range(mesh.ndim))
    pp = tuple(Shard(0) if i in bdims else Replicate()
               for i in range(mesh.ndim))
    q, k, v = (as_dtensor(t, mesh, qp) for t in (q, k, v))
    positions = as_dtensor(positions, mesh, pp)
    shards = shard_count(mesh, sdims)
    index = shard_index(mesh, sdims)

    def body(ql, kl, vl, ck, cv, pos):
        lcfg = _local_cfg(cfg, ql.shape[2], ck.shape[2])
        if not sdims:
            return _decode_attend(lcfg, ql, kl, vl, ck, cv, pos)
        return _decode_slab(lcfg, ql, kl, vl, ck, cv, pos, index, shards,
                            [(mesh, i) for i in sdims])

    return local_map(body, out_placements=list(qp),
                     in_placements=(qp, qp, qp, cp, cp, pp),
                     device_mesh=mesh)(q, k, v, cache_k, cache_v, positions)


def _decode_slab(cfg: ModelConfig, q, k, v, cache_k, cache_v, positions,
                 index: int, shards: int, groups):
    """One rank's slab ``[index*Sl, (index+1)*Sl)`` of a sequence-sharded
    cache: the owner of ``pos % Smax`` writes, the slab's softmax partials
    (m, l, acc) merge across ``groups`` (mesh dims), as K3's key splits
    merge. Returns [B,1,H*hd]."""
    b, _, h, hd = q.shape
    sl = cache_k.shape[1]
    smax, off = sl * shards, index * sl
    local = (positions % smax).long() - off
    owner = ((local >= 0) & (local < sl))[:, None, None]
    idx = local.clamp(0, sl - 1)
    bidx = torch.arange(b, device=q.device)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache[bidx, idx] = torch.where(owner, new[:, 0].to(cache.dtype),
                                       cache[bidx, idx])
    ctx = positions[:, None] + 1
    slot = off + torch.arange(sl, device=q.device)[None, :]
    mask = slot < torch.clamp(ctx, max=_window(cfg, smax))      # [B, Sl]
    kv, groups_ = cfg.num_kv_heads, cfg.gqa_groups
    qg = q.reshape(b, 1, kv, groups_, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k).float()
    scores = scores / (hd ** 0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    m = scores.amax(-1, keepdim=True)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    w = torch.exp(scores - m)
    denom = w.sum(-1, keepdim=True)                 # [B, KV, G, 1, 1]
    acc = torch.einsum("bkgqs,bskd->bkgqd", w, cache_v.float())
    for g in groups:
        denom = funcol.all_reduce(denom, "sum", g)
        acc = funcol.all_reduce(acc, "sum", g)
    out = (acc / denom).permute(0, 3, 1, 2, 4)      # [B, 1, KV, G, hd]
    return out.to(v.dtype).reshape(b, 1, h * hd)
