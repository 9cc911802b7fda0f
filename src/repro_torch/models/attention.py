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
"""
from __future__ import annotations

from typing import Optional

import torch

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
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


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
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)          # q,k,v: [B,1,.,hd]
    q, k = _rotate(cfg, q, k, positions_for(cfg, positions[:, None]))
    smax = cache_k.shape[1]
    write_idx = (positions % smax).long()
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, write_idx] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, write_idx] = v[:, 0].to(cache_v.dtype)
    ctx = positions[:, None] + 1                # tokens now in context
    slot = torch.arange(smax, device=x.device)[None, :]
    if cfg.sliding_window and cfg.sliding_window < 0x7FFFFFFF:
        window = min(cfg.sliding_window, smax)
    else:
        window = smax
    mask = slot < torch.clamp(ctx, max=window)  # valid slots
    out = _attend(cfg, q, cache_k, cache_v, mask[:, None, None, :])
    return out @ p["wo"], cache_k, cache_v
