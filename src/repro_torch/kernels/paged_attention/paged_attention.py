"""Wrapper of the hand-written CUDA paged flash-decode (kernel K1).

The kernel is ``csrc/paged_decode.cu``; it replaces the TPU kernel
``repro/kernels/paged_attention/paged_attention.py:paged_attention_decode``.
bf16 runs the split-key tensor-core decode core
(``csrc/paged_decode_mma.cuh``), cut over the CTAs of a cluster by
``ref.decode_splits`` from the shapes alone; fp32 the CUDA-core loop. One
launch and one allocation (the output) per call, no host sync. The launch
is described as data by ``paged_attention_grid`` (``introspect``), whose
grid the launcher checks before it launches.
``launches`` counts the launches this wrapper made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .. import introspect as ix
from .ref import decode_splits

launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
    [ctypes.c_int] * 8 + [ctypes.c_float] + ix.GRID_ARGTYPES + \
    [ctypes.c_void_p]
MAX_GROUP = 32          # query heads per KV head one CTA holds


@functools.lru_cache(maxsize=256)
def paged_attention_grid(batch: int, q_heads: int, head_dim: int,
                         kv_heads: int, num_pages: int, page_size: int,
                         pages_per_seq: int,
                         dtype: torch.dtype = torch.float32) -> ix.Launches:
    """The launch of ``paged_attention_decode`` as data (the reference's
    ``paged_attention_grid``, plus the dtype that picks the kernel).
    Scalars: block_tables [B, W] and lengths [B] int32. bf16: the decode
    core over ``decode_splits``' key splits, grid (n_split, kv x 16-head
    slices, B); fp32: one CTA per (row, KV head) walking the row's table
    (``paged_decode_kernel``, ``stream_pages``), grid (B, kv, 1)."""
    if dtype == torch.bfloat16:
        split_keys, n_split = decode_splits(page_size, pages_per_seq, dtype)
        return ix.Launches((ix.decode_core_grid(
            "paged_attention", batch, q_heads, head_dim, kv_heads,
            num_pages, page_size, pages_per_seq, split_keys, n_split),))
    group = q_heads // kv_heads
    cap = pages_per_seq * page_size

    def walk(cta, tables, lengths):
        b, h, _ = cta
        return ix.stream_pages(h, b, tables[b],
                               ix.clamp(int(lengths[b]), 0, cap),
                               pages_per_seq, page_size, num_pages, head_dim)

    def rows(cta, *s):
        return ix.rows_box(cta[0], 1, cta[1] * group, group, head_dim)

    pool = (kv_heads, num_pages, page_size, head_dim)
    return ix.Launches((ix.LaunchGrid("paged_attention", "fp32",
                                      (batch, kv_heads, 1), (
        ix.OperandAccess("q", (batch, q_heads, head_dim), rows),
        ix.OperandAccess("k_pages", pool, lambda c, *s: walk(c, *s)[1]),
        ix.OperandAccess("v_pages", pool, lambda c, *s: walk(c, *s)[1]),
        ix.OperandAccess("block_tables", (batch, pages_per_seq),
                         lambda c, *s: walk(c, *s)[0]),
        ix.OperandAccess("lengths", (batch,),
                         lambda c, *s: [((c[0], c[0] + 1),)]),
        ix.OperandAccess("out", (batch, q_heads, head_dim), rows)), 2,
        (("split_keys", cap), ("n_split", 1))),))


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
    ptrs = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("paged_decode: q and the pages must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    width = block_tables.shape[1]
    split_keys, n_split = decode_splits(page_size, width, q.dtype)
    grids = paged_attention_grid(batch, q_heads, head_dim, kv_heads,
                                 num_pages, page_size, width, q.dtype)
    fn = build.function("paged_decode", "paged_decode_launch", _ARGTYPES)
    rc = fn(build.dtype_code(q), head_dim, *ptrs, block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), batch, q_heads, kv_heads,
            num_pages, page_size, width, split_keys, n_split,
            1.0 / head_dim ** 0.5, *ix.grid_args(grids), build.stream(q))
    build.raise_on_error("paged_decode", rc)
    launches += 1
    return out
