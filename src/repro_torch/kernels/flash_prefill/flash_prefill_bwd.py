"""Wrapper of the hand-written CUDA backward of the dense flash prefill
(kernel K5), and the autograd binding that trains through K5.

The JAX package has no Pallas backward: its training path takes XLA's
autodiff of the plain attention (``repro/models/attention.py:_attend``).
The port's training forward is K5, so its gradient is a kernel of its own,
``csrc/flash_prefill_bwd.cu``: a pass for D = rowsum(dO * O), then dK/dV
(one CTA per key tile and KV head, the GQA group's heads summed inside
it, no atomics: the gradients are the same bits from run to run) and dQ;
bf16 on ``mma.sync`` tensor-core tiles, fp32 on the CUDA cores. One call
of ``flash_prefill_bwd`` is one launch of the three, counted in
``launches``.

``FlashPrefillFn`` saves q, k, v, the output and the forward's log-sum-
exp (``flash_prefill.flash_prefill_lse``) and runs the backward kernel;
``ops.flash_attention`` takes it on the card when grad is enabled and an
input requires grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import build
from . import flash_prefill as fwd

launches = 0

_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + \
    [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


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
    delta = torch.empty_like(lse)
    fn = build.function("flash_prefill_bwd", "flash_prefill_bwd_launch",
                        _ARGTYPES)
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            batch, seqlen, q_heads, k.shape[2], n, int(causal),
            1.0 / head_dim ** 0.5, build.stream(q))
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
