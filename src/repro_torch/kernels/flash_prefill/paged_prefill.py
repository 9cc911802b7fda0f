"""Wrapper of the hand-written CUDA paged flash-prefill (kernel K2).

The kernel is ``csrc/paged_prefill.cu``; it replaces the TPU kernel
``repro/kernels/flash_prefill/paged_prefill.py:paged_flash_prefill_fwd``.
One launch takes every chunk lane of a mixed step
(``paged_flash_prefill_lanes_fwd``), reading each lane's first position and
valid length from device arrays; ``paged_flash_prefill_fwd`` is the one-lane
case with host ints (the JAX signature). ``launches`` counts the launches
both made.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + \
    [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
MAX_GROUP = 32          # query heads per KV head the launcher takes


def _launch(q, k_pages, v_pages, tables, positions, chunk_lens, *,
            n_lanes: int, bucket: int, table_stride: int, pos0: int = 0,
            valid_len: int = 0) -> torch.Tensor:
    global launches
    rows, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    if rows == 0:
        return out
    fn = build.function("paged_prefill", "paged_prefill_launch", _ARGTYPES)
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), tables.data_ptr(),
            positions.data_ptr() if positions is not None else None,
            chunk_lens.data_ptr() if chunk_lens is not None else None,
            out.data_ptr(), n_lanes, bucket, q_heads, kv_heads, num_pages,
            page_size, tables.shape[-1], table_stride, pos0, valid_len,
            1.0 / head_dim ** 0.5, build.stream(q))
    build.raise_on_error("paged_prefill", rc)
    launches += 1
    return out


def _check_common(q, k_pages, v_pages, tables) -> None:
    build.check_paged_operands("paged_prefill", q, k_pages, v_pages,
                               MAX_GROUP)
    if tables.dtype != torch.int32:
        raise TypeError("paged_prefill: block tables are int32")


def paged_flash_prefill_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            pos0: int, valid_len: int) -> torch.Tensor:
    """One lane: q [T, H, hd]; k/v pages [kv, P, ps, hd] (fp32 or bf16,
    like q); block_table [W] int32; pos0 and valid_len host ints. Returns
    [T, H, hd]."""
    build.check_operands("paged_prefill", q, k_pages, v_pages, block_table)
    _check_common(q, k_pages, v_pages, block_table)
    if block_table.dim() != 1:
        raise TypeError("paged_prefill: the block table is int32 [W]")
    pos0, valid_len = int(pos0), int(valid_len)
    if pos0 < 0:
        raise ValueError(f"paged_prefill: pos0 {pos0} < 0")
    return _launch(q, k_pages, v_pages, block_table, None, None, n_lanes=1,
                   bucket=q.shape[0], table_stride=0, pos0=pos0,
                   valid_len=valid_len)


def paged_flash_prefill_lanes_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  positions: torch.Tensor,
                                  chunk_lens: torch.Tensor,
                                  lane_buckets: Sequence[int]
                                  ) -> torch.Tensor:
    """Every lane of a step in one launch: q [R, H, hd] holds the lanes'
    rows in order (R = sum of ``lane_buckets``, one bucket for all lanes,
    as the engine packs them); block_tables [R, W] and positions [R] are
    the same rows' (int32, on the card); chunk_lens [n_lanes] int32 on the
    card. Lane i's pos0 is its first row's position, its table its first
    row's table. ``lane_buckets`` (a shape) is the only host input.
    Returns [R, H, hd]."""
    build.check_operands("paged_prefill", q, k_pages, v_pages, block_tables,
                         positions, chunk_lens)
    _check_common(q, k_pages, v_pages, block_tables)
    n_lanes, rows = len(lane_buckets), q.shape[0]
    bucket = lane_buckets[0] if n_lanes else 0
    if any(bk != bucket for bk in lane_buckets) or rows != n_lanes * bucket:
        raise ValueError(f"paged_prefill: {rows} rows do not make lanes of "
                         f"one bucket {tuple(lane_buckets)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != rows or \
            positions.shape != (rows,) or chunk_lens.shape != (n_lanes,) or \
            positions.dtype != torch.int32 or chunk_lens.dtype != torch.int32:
        raise ValueError("paged_prefill: block tables [R, W], positions [R] "
                         "and chunk_lens [n_lanes] int32 expected")
    return _launch(q, k_pages, v_pages, block_tables, positions, chunk_lens,
                   n_lanes=n_lanes, bucket=bucket,
                   table_stride=bucket * block_tables.shape[1])
