"""GQA attention projections for the paged serving step.

Counterpart of ``repro.models.attention``: ``init_attention``,
``_project_qkv`` and ``_rotate``. The dense-cache paths (``_attend``,
``attention_train/prefill/decode``) are not ported yet; the serving
engine attends through the paged kernels in ``repro_torch.kernels``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import apply_rope, dense_init


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
    if cfg.pos_embedding == "rope":
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    elif cfg.pos_embedding == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    return q, k
