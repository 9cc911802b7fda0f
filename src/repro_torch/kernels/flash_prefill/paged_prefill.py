"""Wrapper of the hand-written CUDA paged flash-prefill (kernel K2).

The kernel is ``csrc/paged_prefill.cu``; it replaces the TPU kernel
``repro/kernels/flash_prefill/paged_prefill.py:paged_flash_prefill_fwd``.
One launch takes every chunk lane of a mixed step
(``paged_flash_prefill_lanes_fwd``), reading each lane's first position and
valid length from device arrays; ``paged_flash_prefill_fwd`` is the one-lane
case with host ints (the JAX signature). ``paged_prefill_grid`` describes
the launch as data (``introspect``); the launcher checks its grid.
``launches`` counts the launches both made.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import build
from .. import introspect as ix

launches = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + \
    [ctypes.c_int] * 10 + [ctypes.c_float] + ix.GRID_ARGTYPES + \
    [ctypes.c_void_p]
MAX_GROUP = 32          # query heads per KV head the launcher takes


def block_q(q_heads: int, kv_heads: int, dtype: torch.dtype) -> int:
    """Chunk rows of one CTA: bf16, four m-tiles of floor(16 / group) rows
    (at most 16 heads a slice; ``paged_prefill.cu:mma_grid``); fp32,
    floor(32 / group) (``kMaxRows / group``)."""
    group = q_heads // kv_heads
    if dtype == torch.bfloat16:
        return ix.WARPS * (ix.TILE_ROWS // min(group, ix.TILE_ROWS))
    return ix.MAX_ROWS // group


@functools.lru_cache(maxsize=256)
def paged_prefill_grid(t: int, q_heads: int, head_dim: int, kv_heads: int,
                       num_pages: int, page_size: int, pages_per_seq: int,
                       dtype: torch.dtype = torch.float32,
                       n_lanes: int = 1) -> ix.Launches:
    """The launch of ``paged_flash_prefill_lanes_fwd`` (and of the
    one-lane ``paged_flash_prefill_fwd``) as data: the reference's
    ``paged_prefill_grid`` at a bucket of ``t`` rows, plus the dtype that
    picks the kernel and the lanes of one launch. Grid (ceil(t /
    block_q), kv x 16-head slices (fp32: kv), lanes). Scalars: the step's
    tables [n_lanes * t, W] (lane i's is row i * t), positions [n_lanes *
    t] (lane i's pos0 is entry i * t) and chunk_lens [n_lanes]. A q-block
    reads pages up to its causal horizon (its last valid row's position
    + 1, capped at the table's keys); a block past the lane's valid rows
    writes zeros and (bf16) reads nothing more."""
    group = q_heads // kv_heads
    bf16 = dtype == torch.bfloat16
    bq = block_q(q_heads, kv_heads, dtype)
    slices = ix.cdiv(group, ix.TILE_ROWS) if bf16 else 1
    cap = pages_per_seq * page_size
    rows_all = n_lanes * t
    hd = head_dim

    def geometry(cta, tables, positions, chunk_lens):
        x, y, li = cta
        if bf16:
            h, head0 = y // slices, (y % slices) * ix.TILE_ROWS
            heads = min(min(group, ix.TILE_ROWS), group - head0)
        else:
            h, head0, heads = y, 0, group
        q_start = x * bq
        nq = min(bq, t - q_start)
        row0 = li * t
        pos0 = max(int(positions[row0]), 0)
        valid = min(max(int(chunk_lens[li]), 0), t)
        if bf16:
            live = q_start < valid
            horizon = (min(pos0 + min(q_start + bq, valid), cap)
                       if live else 0)
        else:
            last = min(q_start + nq, valid)
            live = True
            horizon = min(pos0 + last, cap) if last > q_start else 0
        return (h, h * group + head0, heads, q_start, nq, row0, valid,
                live, horizon, tables[row0])

    def q_ranges(cta, *s):
        h, qh0, heads, q_start, nq, row0, valid, live, _, _ = \
            geometry(cta, *s)
        n = min(q_start + bq, valid) - q_start if bf16 else nq
        return ix.rows_box(row0 + q_start, n, qh0, heads, hd) if live \
            else []

    def kv_ranges(cta, *s):
        h, *_, horizon, table = geometry(cta, *s)
        return ix.key_pages(h, table, 0, horizon, page_size, num_pages, hd)

    def table_ranges(cta, *s):
        *_, row0, _, _, horizon, _ = geometry(cta, *s)
        return ix.entries(row0, 0, ix.cdiv(horizon, page_size))

    def out_ranges(cta, *s):
        _, qh0, heads, q_start, nq, row0, *_ = geometry(cta, *s)
        return ix.rows_box(row0 + q_start, nq, qh0, heads, hd)

    pool = (kv_heads, num_pages, page_size, hd)
    lg = ix.LaunchGrid(
        "paged_flash_prefill", "bf16" if bf16 else "fp32",
        (ix.cdiv(t, bq), kv_heads * slices, n_lanes), (
            ix.OperandAccess("q", (rows_all, q_heads, hd), q_ranges),
            ix.OperandAccess("k_pages", pool, kv_ranges),
            ix.OperandAccess("v_pages", pool, kv_ranges),
            ix.OperandAccess("tables", (rows_all, pages_per_seq),
                             table_ranges),
            ix.OperandAccess("positions", (rows_all,),
                             lambda c, *s: [((c[2] * t, c[2] * t + 1),)]),
            ix.OperandAccess("chunk_lens", (n_lanes,),
                             lambda c, *s: [((c[2], c[2] + 1),)]),
            ix.OperandAccess("out", (rows_all, q_heads, hd), out_ranges)),
        3, (("bucket", t), ("n_lanes", n_lanes)))
    return ix.Launches((lg,))


def _launch(q, k_pages, v_pages, tables, positions, chunk_lens, *,
            n_lanes: int, bucket: int, table_stride: int, pos0: int = 0,
            valid_len: int = 0) -> torch.Tensor:
    global launches
    rows, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    if rows == 0:
        return out
    width = tables.shape[-1]
    grids = paged_prefill_grid(bucket, q_heads, head_dim, kv_heads,
                               num_pages, page_size, width, q.dtype, n_lanes)
    fn = build.function("paged_prefill", "paged_prefill_launch", _ARGTYPES)
    rc = fn(build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), tables.data_ptr(),
            positions.data_ptr() if positions is not None else None,
            chunk_lens.data_ptr() if chunk_lens is not None else None,
            out.data_ptr(), n_lanes, bucket, q_heads, kv_heads, num_pages,
            page_size, width, table_stride, pos0, valid_len,
            1.0 / head_dim ** 0.5, *ix.grid_args(grids), build.stream(q))
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
