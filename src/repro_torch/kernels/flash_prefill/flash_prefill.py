"""Wrapper of the hand-written CUDA dense flash prefill (kernel K5).

The kernel is ``csrc/flash_prefill.cu``; it replaces the TPU kernel
``repro/kernels/flash_prefill/flash_prefill.py:flash_prefill``. It is
forward-only, as the TPU kernel is (no gradient is defined there), so an
input that requires grad raises. ``launches`` counts the launches this
wrapper made.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
MAX_ROWS = 64           # query positions x GQA group one CTA holds


def block_rows(group: int) -> int:
    """Query positions per CTA: as many as keep positions x group within
    64."""
    return MAX_ROWS // group


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  true_len: Optional[int] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, S, Hkv, hd] with Hkv | H and at most 64
    query heads per KV head; one dtype, fp32 or bf16; head_dim 32, 64 or
    128. ``true_len`` is a host int in (0, S] or None (= S). Returns
    [B, S, H, hd]."""
    global launches
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_prefill: K5 is forward-only; an input "
                           "requires grad")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    batch, seqlen, q_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill: q, k and v must share a dtype")
    if head_dim not in build.HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {head_dim} not in "
                         f"{build.HEAD_DIMS}")
    if kv_heads < 1 or q_heads % kv_heads or \
            q_heads // kv_heads > MAX_ROWS:
        raise ValueError(f"flash_prefill: {q_heads} query heads over "
                         f"{kv_heads} KV heads")
    build.check_operands("flash_prefill", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill: operands must be 16-byte aligned")
    n = seqlen if true_len is None else int(true_len)
    if not 0 < n <= seqlen:
        raise ValueError(f"flash_prefill: true_len {n} not in (0, "
                         f"{seqlen}]")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), batch, seqlen, q_heads, kv_heads,
            n, block_rows(q_heads // kv_heads), int(causal),
            1.0 / head_dim ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on_error("flash_prefill", rc)
    launches += 1
    return out
