"""Wrapper of the hand-written CUDA paged flash-decode (kernel K1).

The kernel is ``csrc/paged_decode.cu``; it replaces the TPU kernel
``repro/kernels/paged_attention/paged_attention.py:paged_attention_decode``.
``launches`` counts the launches this wrapper made.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
    [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
MAX_GROUP = 32          # query heads per KV head one CTA holds


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q [B, H, hd]; k/v pages [kv, P, ps, hd] (fp32 or bf16, like q);
    block_tables [B, W] and lengths [B] int32. Returns [B, H, hd]."""
    global launches
    build.check_operands("paged_decode", q, k_pages, v_pages, block_tables,
                         lengths)
    build.check_paged_operands("paged_decode", q, k_pages, v_pages,
                               MAX_GROUP)
    batch, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode: block tables and lengths are int32")
    if block_tables.shape[0] != batch or tuple(lengths.shape) != (batch,):
        raise ValueError("paged_decode: block tables / lengths batch")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), batch, q_heads, kv_heads, num_pages, page_size,
            block_tables.shape[1], 1.0 / head_dim ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on_error("paged_decode", rc)
    launches += 1
    return out
