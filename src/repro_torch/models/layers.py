"""Core layers of the dense families, as plain functions on tensors.

Counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors in the reference's layout: weights are ``[in, out]`` so
activations compute ``x @ W``, and norm scales are fp32. Norms and RoPE
compute in fp32 and cast back to the input dtype, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.local import (as_dtensor, partial_where, shard_count,
                                 shard_dims, shard_index)
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
# positions: RoPE, M-RoPE (qwen2-vl), sinusoidal (musicgen)
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


def apply_mrope(cfg: ModelConfig, x: torch.Tensor,
                positions3: torch.Tensor) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: [B, S, H, hd]; positions3: [B, S,
    3] (temporal, height, width) position ids. The hd/2 frequency slots
    are split into three sections (``cfg.mrope_sections`` scaled to this
    head_dim), each rotated by its own position stream; with three equal
    streams it is 1-D RoPE."""
    hd = x.shape[-1]
    half = hd // 2
    sec = cfg.mrope_sections
    total = sum(sec)
    sizes = [s * half // total for s in sec]
    sizes[-1] = half - sizes[0] - sizes[1]
    inv = rope_freqs(cfg, hd, x.device)                     # [half]
    pos = positions3.float()                                # [B, S, 3]
    parts, start = [], 0
    for i, sz in enumerate(sizes):
        parts.append(pos[..., i:i + 1] * inv[start:start + sz])
        start += sz
    ang = torch.cat(parts, dim=-1)                          # [B, S, half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[...] int positions -> [..., dim] fp32 sinusoidal embeddings
    (sines, then cosines)."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def positions_for(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """A [B, S] position tensor in the form the config's rotary needs:
    three equal streams [B, S, 3] for M-RoPE, else unchanged."""
    if cfg.pos_embedding == "mrope" and positions.dim() == 2:
        return positions[..., None].expand(*positions.shape, 3)
    return positions


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
    emb = p["embedding"]
    x = _embed_sharded(emb, tokens) if isinstance(emb, DTensor) \
        else emb[tokens]
    if cfg.embedding_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _embed_sharded(emb: DTensor, tokens) -> DTensor:
    """The lookup of a vocab-parallel table on each rank's local rows
    (DTensor's index and its backward's ``index_put`` are not used: the
    latter has no strategy for the gradient's placements in every torch
    release). Where the vocab is split over n > 1 ranks, each looks up the
    tokens in its rows, zeros the others, and the output is a partial sum
    there; the table's gradient is a partial sum over the tokens' batch
    axes."""
    mesh = emb.device_mesh
    vdims = shard_dims(emb.placements, 0)
    n = shard_count(mesh, vdims)
    index = shard_index(mesh, vdims)
    ep = tuple(Shard(0) if i in vdims else Replicate()
               for i in range(mesh.ndim))
    tp = tuple(Shard(0) if isinstance(tokens, DTensor) and i not in vdims
               and tokens.placements[i] == Shard(0) else Replicate()
               for i in range(mesh.ndim))
    bdims = shard_dims(tp, 0)
    op = tuple(Partial() if i in vdims and n > 1 else p
               for i, p in enumerate(tp))

    def body(el, tl):
        if n == 1:
            return el[tl]
        rows = el.shape[0]
        rel = tl - index * rows
        inside = (rel >= 0) & (rel < rows)
        return torch.where(inside[..., None], el[rel.clamp(0, rows - 1)],
                           0)

    return local_map(body, out_placements=list(op), in_placements=(ep, tp),
                     in_grad_placements=(partial_where(ep, bdims), tp),
                     device_mesh=mesh)(as_dtensor(emb, mesh, ep),
                                       as_dtensor(tokens, mesh, tp))


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["lm_head"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
