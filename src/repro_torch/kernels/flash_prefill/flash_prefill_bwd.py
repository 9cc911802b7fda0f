"""Wrapper of the hand-written CUDA backward of the dense flash prefill
(kernel K5), and the autograd binding that trains through K5.

The JAX package has no Pallas backward: its training path takes XLA's
autodiff of the plain attention (``repro/models/attention.py:_attend``).
The port's training forward is K5, so its gradient is a kernel of its own,
``csrc/flash_prefill_bwd.cu``: a pass for D = rowsum(dO * O), then dK/dV
(one CTA per key tile and KV head, the GQA group's heads summed inside
it, no atomics: the gradients are the same bits from run to run) and dQ
(one CTA per query tile and head); bf16 on wgmma fed by TMA, fp32 on the
CUDA cores. One call of ``flash_prefill_bwd`` is one launch of the three,
counted in ``launches``. ``flash_prefill_bwd_grid`` describes the three
launches' grids as data (``introspect``); the launcher refuses any other.

``FlashPrefillFn`` saves q, k, v, the output and the forward's log-sum-
exp (``flash_prefill.flash_prefill_lse``) and runs the backward kernel;
``ops.flash_attention`` takes it on the card when grad is enabled and an
input requires grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build
from .. import introspect as ix
from . import flash_prefill as fwd

launches = 0

_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + \
    [ctypes.c_int] * 6 + [ctypes.c_float] + ix.GRID_ARGTYPES + \
    [ctypes.c_void_p]
#: bf16's LSE and D rows: S padded to a multiple of this (kPad)
PAD = 64
#: threads of a D-pass block and its passes over rows (bwd_dot_kernel,
#: Dot::kPasses), an fp32 CTA's tile rows (F32::kTile)
DOT_THREADS = 256
DOT_PASSES = 2
F32_TILE = 32


def bf16_tiles(head_dim: int) -> Tuple[int, int]:
    """(keys of a bf16 dK/dV CTA, rows of a bf16 dQ CTA): KvCfg::kKeys and
    QCfg::kRows of ``flash_prefill_bwd.cu``, 64 each at head_dim 256 (one
    warpgroup's 64 rows or keys), else 128 (two)."""
    return (64, 64) if head_dim > 128 else (128, 128)


def padded_len(seqlen: int) -> int:
    return ix.cdiv(seqlen, PAD) * PAD


@functools.lru_cache(maxsize=256)
def flash_prefill_bwd_grid(b: int, s: int, h: int, hd: int, hkv: int,
                           dtype: torch.dtype = torch.float32
                           ) -> ix.Launches:
    """The three launches of ``flash_prefill_bwd`` as data, in launch
    order: the D pass (``bwd_dot``: 16-byte loads, min(hd x itemsize / 16,
    32) threads a row, 2 passes of a 256-thread block, over every
    (head, position) of each batch row, bf16's positions padded to
    ``PAD``), then dK/dV
    and dQ. bf16: dK/dV (Hkv, B, ceil(S / keys)) and dQ (H, B, ceil(S /
    rows)) with ``bf16_tiles``, the key or query tile on z so that the
    longest causal CTAs launch first; fp32: (ceil(S / 32), Hkv, B) and
    (ceil(S / 32), H, B). No access model yet: STEP007 does not cover the
    training kernels."""
    bf16 = dtype == torch.bfloat16
    route = "bf16" if bf16 else "fp32"
    vecs = hd * (2 if bf16 else 4) // 16
    per = DOT_THREADS // min(vecs, 32) * DOT_PASSES
    rows = b * (padded_len(s) if bf16 else s) * h
    dot = (ix.cdiv(rows, per), 1, 1)
    if bf16:
        keys, qrows = bf16_tiles(hd)
        grids = (dot, (hkv, b, ix.cdiv(s, keys)), (h, b, ix.cdiv(s, qrows)))
    else:
        t = ix.cdiv(s, F32_TILE)
        grids = (dot, (t, hkv, b), (t, h, b))
    names = ("bwd_dot", "dkdv", "dq")
    return ix.Launches(ix.LaunchGrid(f"flash_prefill_bwd.{name}", route,
                                     grid, ())
                       for name, grid in zip(names, grids))


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, causal: bool = True,
                      true_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_prefill(q, k, v, causal, true_len)`` for
    the output's gradient ``dout``: q, out and dout [B, S, H, hd], k and v
    [B, S, Hkv, hd] in one dtype (fp32 or bf16), ``lse`` the forward's
    [B, H, S] fp32 log-sum-exp. The forward's refusals hold (CPU tensors,
    head_dim, GQA group, alignment, true_len)."""
    global launches
    n = fwd.check_inputs("flash_prefill_bwd", q, k, v, true_len)
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_prefill_bwd: out and dout must be shaped "
                         "and typed as q")
    batch, seqlen, q_heads, head_dim = q.shape
    if lse.shape != (batch, q_heads, seqlen) or lse.dtype != torch.float32:
        raise ValueError("flash_prefill_bwd: lse must be fp32 [B, H, S]")
    build.check_operands("flash_prefill_bwd", q, out, dout, lse)
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_prefill_bwd: operands must be 16-byte "
                         "aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if batch == 0:
        return dq, dk, dv
    # D (and for bf16 the LSE in log2 units), [2, B, H, S padded]
    scratch = torch.empty(2 * batch * q_heads * padded_len(seqlen),
                          dtype=torch.float32, device=q.device)
    grids = ix.grid_args(flash_prefill_bwd_grid(
        batch, seqlen, q_heads, head_dim, k.shape[2], q.dtype))
    fn = build.function("flash_prefill_bwd", "flash_prefill_bwd_launch",
                        _ARGTYPES)
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            batch, seqlen, q_heads, k.shape[2], n, int(causal),
            1.0 / head_dim ** 0.5, *grids, build.stream(q))
    build.raise_on_error("flash_prefill_bwd", rc)
    launches += 1
    return dq, dk, dv


class FlashPrefillFn(torch.autograd.Function):
    """K5 with a gradient: the forward kernel writing its log-sum-exp,
    the backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, true_len: Optional[int]):
        out, lse = fwd.flash_prefill_lse(q, k, v, causal, true_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.true_len = causal, true_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, out, lse, dout.contiguous(),
                                       ctx.causal, ctx.true_len)
        return dq, dk, dv, None, None
