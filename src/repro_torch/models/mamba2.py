"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) mixer.

Counterpart of ``repro.models.mamba2``. Chunked SSD formulation: within-
chunk attention-like quadratic term + inter-chunk linear recurrence over
chunk states. Used by the pure-SSM config (mamba2-130m) and the hybrid
config (hymba-1.5b, parallel attention+SSM heads). Decode is a constant-
size state update.

``mamba2_forward`` runs the chunked scan through the dispatcher
``kernels.ssd_scan.ops.ssd_with_state``: the hand-written CUDA kernel K4
on CUDA tensors, the plain ``ssd_chunked`` (defined beside K4 in
``kernels/ssd_scan/ref.py`` and re-exported here) on CPU tensors. The
one-token ``ssd_decode_step`` stays in plain torch ops, as the reference
keeps it in jnp. The causal conv is the reference's sum of shifted
products, not ``F.conv1d`` (which cuDNN would run in TF32 on the card).

Sharded (DTensor inputs, the steps of ``launch/steps.py``): the
projections are DTensor matmuls; the mixer between them (conv, the scan,
the gated norm: ``_mixer_forward``, ``_mixer_decode``) runs on each
rank's local rows under ``local_map``, replicated over ``"model"`` (K4
and ``SsdScanFn`` on the card). Its SSD head counts (24, 50) rarely
divide the model axis, and DTensor cannot split or fold a sharded dim
across heads in the forward or in the backward. The states it returns
go to the cache's layout (``cache_pspecs``: conv channels and the SSD
head_dim on ``"model"``) when stored.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.local import as_dtensor, batch_placements, partial_where
from ..kernels.ssd_scan.ops import ssd_with_state
from ..kernels.ssd_scan.ref import _segsum, ssd_chunked  # noqa: F401
from .config import ModelConfig
from .layers import apply_norm, dense_init, init_norm


def ssd_decode_step(state, x, dt, a, b, c, valid=None):
    """Single-token SSD recurrence.

    state: [B, H, P, N]; x: [B, H, P]; dt: [B, H]; a: [H];
    b, c: [B, H, N]; valid: [B] bool or None — rows marked False get dt
    forced to 0, so their state update is an exact identity (inert rows in
    the serving mixed step). Returns (y [B,H,P], new_state).
    """
    if valid is not None:
        dt = torch.where(valid[:, None], dt, 0.0)
    da = torch.exp(dt * a)                                   # [B,H]
    # dt is fp32, so the update is formed in fp32 (jnp's promotion)
    upd = dt[:, :, None, None] * x.float()[..., None] * b.float()[:, :, None]
    new_state = state * da[:, :, None, None].to(state.dtype) \
        + upd.to(state.dtype)
    y = torch.einsum("bhpn,bhn->bhp", new_state, c.to(state.dtype))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# full Mamba2 mixer block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device=None) -> dict:
    """Random mixer weights from ``gen`` (the reference's initializers;
    the numbers differ from jax.random's). ``a_log`` and ``dt_bias`` are
    fp32 whatever ``dtype``, as the reference makes them."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((h,), generator=gen, **f32)
    return {
        "in_proj": dense_init(gen, (d, proj_out), 0, dtype, device),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, _conv_dim(cfg)), 0,
                             dtype, device),
        "conv_b": torch.zeros((_conv_dim(cfg),), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones((h,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(
            u * 2.3 - 4.6))),
        "norm": init_norm(cfg, di, device),
        "out_proj": dense_init(gen, (di, d), 0, dtype, device),
    }


def _split_proj(cfg: ModelConfig, proj):
    di, h = cfg.d_inner, cfg.ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di:di + _conv_dim(cfg)]
    dt = proj[..., di + _conv_dim(cfg):]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _split_xbc(cfg: ModelConfig, xbc):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :di]
    b = xbc[..., di:di + g * n]
    c = xbc[..., di + g * n:]
    return x, b, c


def _dt(p, dt_raw) -> torch.Tensor:
    """softplus(dt_raw + dt_bias) in fp32. Computed in fp64 and rounded
    once: PyTorch's CPU kernels take a tensor's SIMD body and its scalar
    tail through different exp/log1p, which differ by an ulp in fp32, and
    which positions fall in the tail depends on how many rows the step
    carries. In fp64 the two differ by at most an fp64 ulp, which rounds to
    the same fp32 unless it straddles an fp32 rounding boundary, so a lane's
    dt does not depend on how many lanes share its step."""
    return F.softplus((dt_raw.float() + p["dt_bias"]).double()).float()


def _valid_lens(valid_len, batch: int, device) -> torch.Tensor:
    """A scalar or [B] valid length as a [B] int64 tensor."""
    vl = torch.as_tensor(valid_len, device=device).long()
    return vl.expand(batch) if vl.dim() == 0 else vl


def _causal_conv(p, xbc, conv_state=None, valid_len=None):
    """Depthwise causal conv. xbc: [B, S, C]. conv_state: [B, W-1, C] tail.

    ``valid_len`` (scalar or [B], <= S) marks only the first ``valid_len``
    positions as real input: the returned state is the W-1 tail of the
    *valid* stream (prev state ++ xbc[:valid_len]), gathered per row, so
    right-padded rows never leak into the next segment's receptive field.
    Conv outputs at padded positions are unspecified (callers discard
    them)."""
    w = p["conv_w"].shape[0]
    bs, s, ch = xbc.shape
    if conv_state is None:
        pad = xbc.new_zeros((bs, w - 1, ch))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], 1)                           # [B, S+W-1, C]
    out = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(w))
    out = out + p["conv_b"]
    if w == 1:
        new_state = pad
    elif valid_len is None:
        new_state = xp[:, -(w - 1):]
    else:
        # tail of the valid stream: xp[b, vl : vl + W-1] (vl == S gives the
        # unmasked slice above)
        vl = _valid_lens(valid_len, bs, xbc.device)
        idx = vl[:, None] + torch.arange(w - 1, device=xbc.device)
        new_state = torch.gather(xp, 1, idx[..., None].expand(-1, -1, ch))
    return F.silu(out), new_state


def _head_broadcast(cfg: ModelConfig, bc):
    """[B, S, G*N] -> [B, S, H, N] broadcasting groups to heads."""
    bs, s, _ = bc.shape
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return bc.reshape(bs, s, g, n).repeat_interleave(h // g, dim=2)


def mamba2_forward(cfg: ModelConfig, p, x_in, initial=None, valid_len=None):
    """x_in: [B, S, D] -> (y [B,S,D], (conv_state, ssd_state)).

    ``valid_len`` (scalar or [B]) treats only the first ``valid_len``
    positions as real tokens: padded tail positions get dt masked to zero
    (identity SSD transition) and are excluded from the conv state, so the
    returned states equal those of a scan over the unpadded sequence.
    Outputs at padded positions are unspecified. The scan runs through
    ``ssd_with_state`` (K4 on the card; in training its forward and
    backward, ``SsdScanFn``)."""
    proj = x_in @ p["in_proj"]
    if isinstance(proj, DTensor):
        y, states = _on_local_rows(_mixer_forward, cfg, p, proj,
                                   initial or (), batch_placements(x_in),
                                   valid_len=valid_len)
    else:
        y, states = _mixer_forward(cfg, p, proj, *(initial or ()),
                                   valid_len=valid_len)
    return y @ p["out_proj"], states


def _mixer_forward(cfg: ModelConfig, p, proj, conv_state_in=None,
                   ssd_state_in=None, valid_len=None):
    """The mixer between its projections: conv, the scan, the gated
    norm. proj [B, S, in_proj's width] -> (y [B, S, d_inner],
    (conv_state, ssd_state))."""
    bs, s, _ = proj.shape
    h, pp = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(p, xbc, conv_state_in, valid_len)
    xs, b, c = _split_xbc(cfg, xbc)
    xs = xs.reshape(bs, s, h, pp)
    bh = _head_broadcast(cfg, b)
    ch = _head_broadcast(cfg, c)
    dt = _dt(p, dt_raw)
    a = -torch.exp(p["a_log"])
    valid = None
    if valid_len is not None:
        vl = _valid_lens(valid_len, bs, proj.device)
        valid = torch.arange(s, device=proj.device)[None, :] < vl[:, None]
    y, ssd_state = ssd_with_state(xs, dt, a, bh, ch, cfg.ssm_chunk,
                                  ssd_state_in, valid=valid)
    y = y + xs * p["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(bs, s, cfg.d_inner)
    y = apply_norm(cfg, p["norm"], y * F.silu(z))
    return y, (conv_state, ssd_state)


def _on_local_rows(fn, cfg: ModelConfig, p, proj: DTensor, states, bp,
                   **kw):
    """``fn(cfg, p, proj, *states, **kw)`` (the mixer between its
    projections) on each rank's local rows under ``local_map``: the
    batch on its data axes (``bp``, the mixer input's batch placements),
    every other dim whole (the mixer's own
    weights gathered; their gradients partial sums over the batch axes).
    Its splits and head reshapes then meet no sharded dim, and the scan
    runs on local tensors (K4 on the card). Returns fn's outputs as
    DTensors with the batch sharding."""
    mesh = proj.device_mesh
    proj = proj.redistribute(mesh, bp)
    bdims = tuple(i for i, pl in enumerate(bp) if pl == Shard(0))
    rep = (Replicate(),) * mesh.ndim
    names = sorted(k for k in p if k not in ("in_proj", "out_proj", "norm"))
    norm = sorted(p["norm"])
    weights = [as_dtensor(p[k], mesh, rep) for k in names] + \
        [as_dtensor(p["norm"][k], mesh, rep) for k in norm]
    states = [as_dtensor(t, mesh, bp) for t in states]
    n_w = len(weights)

    def body(pl, *rest):
        lp = dict(zip(names, rest[:len(names)]))
        lp["norm"] = dict(zip(norm, rest[len(names):n_w]))
        return fn(cfg, lp, pl, *rest[n_w:], **kw)

    n_out = 3
    return local_map(
        body, out_placements=(bp,) * n_out,
        in_placements=(bp,) + (rep,) * n_w + (bp,) * len(states),
        in_grad_placements=(bp,) + (partial_where(rep, bdims),) * n_w
        + (bp,) * len(states), device_mesh=mesh)(proj, *weights, *states)


def mamba2_decode(cfg: ModelConfig, p, x_in, conv_state, ssd_state,
                  valid=None):
    """One-token decode. x_in: [B, 1, D]; conv_state: [B, W-1, C];
    ssd_state: [B, H, P, N]; valid: [B] bool or None — rows marked False
    keep BOTH states bit-identical (inert rows in the serving mixed step).
    Returns (y [B,1,D], conv_state, ssd_state), new tensors."""
    proj = x_in @ p["in_proj"]                              # [B,1,·]
    if isinstance(proj, DTensor):
        y, (conv_state, ssd_state) = _on_local_rows(
            _mixer_decode, cfg, p, proj, (conv_state, ssd_state),
            batch_placements(x_in), valid=valid)
    else:
        y, (conv_state, ssd_state) = _mixer_decode(
            cfg, p, proj, conv_state, ssd_state, valid=valid)
    return y @ p["out_proj"], conv_state, ssd_state


def _mixer_decode(cfg: ModelConfig, p, proj, conv_state, ssd_state,
                  valid=None):
    """The one-token mixer between its projections. Returns (y [B, 1,
    d_inner], (conv_state, ssd_state))."""
    bs = proj.shape[0]
    h, pp = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_state_in = conv_state
    xbc, conv_state = _causal_conv(p, xbc, conv_state)
    if valid is not None:
        conv_state = torch.where(valid[:, None, None], conv_state,
                                 conv_state_in.to(conv_state.dtype))
    xs, b, c = _split_xbc(cfg, xbc)
    xs1 = xs[:, 0].reshape(bs, h, pp)
    bh = _head_broadcast(cfg, b)[:, 0]                      # [B,H,N]
    ch = _head_broadcast(cfg, c)[:, 0]
    dt = _dt(p, dt_raw[:, 0])
    a = -torch.exp(p["a_log"])
    y, ssd_state = ssd_decode_step(ssd_state, xs1, dt, a, bh, ch, valid=valid)
    y = y + xs1 * p["d_skip"][None, :, None].to(y.dtype)
    y = y.reshape(bs, 1, cfg.d_inner)
    y = apply_norm(cfg, p["norm"], y * F.silu(z))
    return y, (conv_state, ssd_state)


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (conv [B, W-1, C], ssd [B, H, P, N]) decode state."""
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, _conv_dim(cfg)),
                       dtype=dtype, device=device)
    ssd = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state), dtype=dtype, device=device)
    return conv, ssd
