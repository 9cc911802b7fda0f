"""Wrapper of the hand-written CUDA paged flash-prefill (kernel K2).

The kernel is ``csrc/paged_prefill.cu``; it replaces the TPU kernel
``repro/kernels/flash_prefill/paged_prefill.py:paged_flash_prefill_fwd``.
``launches`` counts the launches this wrapper made.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
    [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
MAX_ROWS = 32           # chunk rows x GQA group one CTA holds


def block_rows(group: int) -> int:
    """Chunk rows per CTA: as many as keep rows x group within 32."""
    return max(1, MAX_ROWS // group)


def paged_flash_prefill_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            pos0: int, valid_len: int) -> torch.Tensor:
    """q [T, H, hd]; k/v pages [kv, P, ps, hd] (fp32 or bf16, like q);
    block_table [W] int32; pos0 and valid_len host ints. Returns
    [T, H, hd]."""
    global launches
    build.check_operands("paged_prefill", q, k_pages, v_pages, block_table)
    build.check_paged_operands("paged_prefill", q, k_pages, v_pages,
                               MAX_ROWS)
    t, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    if block_table.dtype != torch.int32 or block_table.dim() != 1:
        raise TypeError("paged_prefill: the block table is int32 [W]")
    pos0, valid_len = int(pos0), int(valid_len)
    if pos0 < 0:
        raise ValueError(f"paged_prefill: pos0 {pos0} < 0")
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = build.load("paged_prefill")
    fn = lib.paged_prefill_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), out.data_ptr(), t,
            q_heads, kv_heads, num_pages, page_size, block_table.shape[0],
            pos0, valid_len, block_rows(q_heads // kv_heads),
            1.0 / head_dim ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on_error("paged_prefill", rc)
    launches += 1
    return out
