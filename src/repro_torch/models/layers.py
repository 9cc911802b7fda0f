"""Core layers of the dense families, as plain functions on tensors.

Counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors in the reference's layout: weights are ``[in, out]`` so
activations compute ``x @ W``, and norm scales are fp32. Norms and RoPE
compute in fp32 and cast back to the input dtype, as the reference does.
``apply_mrope`` and ``sinusoidal_embedding`` are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig

# ---------------------------------------------------------------------------
# initializers (explicit generator; the numbers differ from jax.random's)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights, drawn in fp32 and cast to ``dtype``."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal(0, 0.02) embedding table."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: int, device=None) -> dict:
    """fp32 scale (and bias for layernorm), as ``layers.init_norm``."""
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, computed in fp32."""
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "rmsnorm":
        var = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    else:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]
    return y.to(dt)


# ---------------------------------------------------------------------------
# MLP (dense FFN): SwiGLU / GeGLU / gelu / squared-ReLU
# ---------------------------------------------------------------------------


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_up": dense_init(gen, (d, f), 0, dtype, device),
        "w_down": dense_init(gen, (f, d), 0, dtype, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (d, f), 0, dtype, device)
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((f,), dtype=dtype, device=device)
        p["b_down"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_bias:
        up = up + p["b_up"]
    if cfg.mlp_gated:
        h = _act(cfg.mlp_activation, x @ p["w_gate"]) * up
    else:
        h = _act(cfg.mlp_activation, up)
    y = h @ p["w_down"]
    if cfg.mlp_bias:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# positions: RoPE
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, rot_dim: int,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (cfg.rope_theta ** exponent)  # [rot_dim//2]


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int. Partial rotary supported."""
    hd = x.shape[-1]
    rot_dim = int(hd * cfg.rope_pct) // 2 * 2
    inv = rope_freqs(cfg, rot_dim, x.device)
    ang = positions.float()[..., None] * inv                # [B,S,rot/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device=None) -> dict:
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                 device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0,
                                  dtype, device)
    return p


def embed_tokens(cfg: ModelConfig, p: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = p["embedding"][tokens]
    if cfg.embedding_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["lm_head"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
