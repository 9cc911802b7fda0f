"""Wrapper of the hand-written CUDA tree-decode pair (kernel K3).

The kernels are ``csrc/paged_tree_decode.cu``; they replace the TPU
kernels of ``repro/kernels/paged_attention/tree_decode.py:
paged_tree_attention_fwd`` — ``tree_shared_kernel`` its shared pass
(``_tree_shared_kernel``), ``tree_branch_kernel`` its branch pass
(``_tree_branch_kernel``) with the merge of the partial sets folded
into the epilogue; in bf16 the branch pass is K1's split-key tensor-core
decode core (``csrc/paged_decode_mma.cuh``) over the suffix tables, cut
by ``ref.decode_splits`` from the shapes alone. In bf16 the shared pass
is split over the table, from its shape alone (``shared_splits``; splits
past a group's span hold no key): its fp32 partials are one tensor
[n_split, B, H, hd + 2], each row ``acc`` then ``m`` then ``l``
(``unpack_partials`` gives the three as views), returned with the split
width; the branch pass takes both and merges the splits in order before
the row's suffix. In fp32 the shared pass runs the whole span as one
split (n_split = 1). The
wrappers' host time is paid on every decode step of the tree path, so
they make one allocation each and few tensor calls.
``paged_tree_shared_grid`` and ``paged_tree_branch_grid`` describe the two
launches as data (``introspect``); each launcher checks its grid.
``shared_launches`` and ``branch_launches`` count the launches of each
pass this module made.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build
from .. import introspect as ix
from .ref import decode_splits

shared_launches = 0
branch_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SHARED_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 9 + [ctypes.c_float] + \
    ix.GRID_ARGTYPES + [_P]
_BRANCH_ARGTYPES = [_I, _I] + [_P] * 9 + [_I] * 11 + [ctypes.c_float] + \
    ix.GRID_ARGTYPES + [_P]
MAX_GROUP = 32          # query heads per KV head one CTA holds
MIN_SPLIT_KEYS = 32     # the bf16 shared pass's smallest split, in keys
MAX_SPLITS = 16         # and its most splits of one table


@functools.lru_cache(maxsize=256)
def shared_splits(page_size: int, width: int,
                  dtype: torch.dtype) -> Tuple[int, int]:
    """``(split_keys, n_split)`` of the shared pass over tables of
    ``width`` pages of ``page_size`` tokens, from these shapes only (never
    from a step's spans, so a captured step's grid holds for every step).
    bf16: splits of whole pages, at least 32 keys, doubled until at most
    16 cover the table: the serve's 32-page tables of 16-token pages are
    16 splits of 32 keys, and a group's 256-token span fills the first 8
    (its 2 groups x 8 KV heads x 8 = 128 CTAs with keys); a split past a
    group's span writes its neutral (NEG_INF, 0, 0) partials. fp32: one
    split (the CUDA-core loop)."""
    cap = page_size * width
    if dtype != torch.bfloat16:
        return max(cap, 1), 1
    pages = max(1, -(-MIN_SPLIT_KEYS // page_size))
    while -(-width // pages) > MAX_SPLITS:
        pages *= 2
    return pages * page_size, max(1, -(-width // pages))


@functools.lru_cache(maxsize=256)
def paged_tree_shared_grid(batch: int, q_heads: int, head_dim: int,
                           kv_heads: int, num_pages: int, page_size: int,
                           num_groups: int, pages_per_seq: int,
                           dtype: torch.dtype = torch.float32,
                           n_split: Optional[int] = None,
                           split_keys: Optional[int] = None
                           ) -> ix.Launches:
    """The shared pass's launch as data (the reference's
    ``paged_tree_shared_grid`` plus the dtype, and the split layout,
    ``shared_splits`` of the table's shape unless given). Scalars:
    row_group [B], shared_bt [G, W], shared_lens [G] and lengths [B]
    int32; the output is the packed partials [n_split, B, H, hd + 2].
    bf16: grid (n_split, kv, G): CTA (z, h, g) walks span keys [z *
    split_keys, ...) (the last split every key from its start) below its
    members' farthest end, for every member of group g (each CTA scans
    row_group and lengths for them), 64 // group members at a time, and
    writes every member's split z. An unused group (span 0) reads no
    page. fp32: grid (kv, G, ceil(B / (32 // group))): CTA (h, g, j)
    takes group g's members ranked j * (32 // group) .., the whole span
    as one split (``tree_shared_kernel``)."""
    group = q_heads // kv_heads
    bf16 = dtype == torch.bfloat16
    if n_split is None or split_keys is None:
        split_keys, n_split = shared_splits(page_size, pages_per_seq, dtype)
    cap = pages_per_seq * page_size
    per_cta = (ix.SPLIT_ROWS if bf16 else ix.MAX_ROWS) // group
    hd = head_dim

    def geometry(cta, rg, sbt, sl, lengths):
        if bf16:
            z, h, g = cta
            slices = range(0, batch, per_cta)   # walked one after another
        else:
            h, g, j = cta
            z, slices = 0, [j * per_cta]
        span = ix.clamp(int(sl[g]), 0, cap)
        lo = z * split_keys if bf16 else 0
        hi = (span if not bf16 or z == n_split - 1
              else min(lo + split_keys, span))
        members = [b for b in range(batch) if int(rg[b]) == g]
        walks = []
        for first in slices:
            mine = members[first:first + per_cta]
            if not mine:
                break
            end = max(min(ix.clamp(int(lengths[b]), 0, cap), span)
                      for b in mine)
            walks.append((mine, min(hi, end)))
        return z, h, g, lo, hi, walks, sbt[g]

    def q_ranges(cta, *s):
        _, h, _, lo, _, walks, _ = geometry(cta, *s)
        return [box for mine, kv_hi in walks if lo < kv_hi or not bf16
                for b in mine
                for box in ix.rows_box(b, 1, h * group, group, hd)]

    def kv_ranges(cta, *s):
        _, h, _, lo, _, walks, table = geometry(cta, *s)
        return [box for _, kv_hi in walks
                for box in ix.key_pages(h, table, lo, kv_hi, page_size,
                                        num_pages, hd)]

    def table_ranges(cta, *s):
        _, _, g, lo, hi, walks, _ = geometry(cta, *s)
        if bf16:   # the first tile's entries, then each walk's
            out = ix.entries(g, lo // page_size,
                             ix.cdiv(min(hi, lo + ix.TILE_KEYS), page_size))
            return out + [e for _, kv_hi in walks
                          for e in ix.entries(g, lo // page_size,
                                              ix.cdiv(kv_hi, page_size))]
        return [e for _, kv_hi in walks
                for e in ix.entries(g, 0, ix.cdiv(kv_hi, page_size))]

    def part_ranges(cta, *s):
        z, h, _, _, _, walks, _ = geometry(cta, *s)
        return [((z, z + 1), (b, b + 1), (h * group, (h + 1) * group),
                 (0, hd + 2)) for mine, _ in walks for b in mine]

    def member_scan(cta, *s):
        return [((0, batch),)]

    pool = (kv_heads, num_pages, page_size, hd)
    grid = ((n_split, kv_heads, num_groups) if bf16 else
            (kv_heads, num_groups, ix.cdiv(batch, per_cta)))
    return ix.Launches((ix.LaunchGrid(
        "paged_tree_shared", "bf16" if bf16 else "fp32", grid, (
            ix.OperandAccess("q", (batch, q_heads, hd), q_ranges),
            ix.OperandAccess("k_pages", pool, kv_ranges),
            ix.OperandAccess("v_pages", pool, kv_ranges),
            ix.OperandAccess("row_group", (batch,), member_scan),
            ix.OperandAccess("shared_bt", (num_groups, pages_per_seq),
                             table_ranges),
            ix.OperandAccess("shared_lens", (num_groups,),
                             lambda c, *s: [((c[2 if bf16 else 1],
                                              c[2 if bf16 else 1] + 1),)]),
            ix.OperandAccess("lengths", (batch,), member_scan),
            ix.OperandAccess("partials", (n_split, batch, q_heads, hd + 2),
                             part_ranges)), 4,
        (("split_keys", split_keys), ("n_split", n_split))),))


@functools.lru_cache(maxsize=256)
def paged_tree_branch_grid(batch: int, q_heads: int, head_dim: int,
                           kv_heads: int, num_pages: int, page_size: int,
                           pages_per_seq: int,
                           dtype: torch.dtype = torch.float32,
                           num_groups: int = 1,
                           shared_n: Optional[int] = None,
                           shared_keys: Optional[int] = None
                           ) -> ix.Launches:
    """The branch pass's launch as data (the reference's
    ``paged_tree_branch_grid`` plus the dtype, the map's group count and
    the shared pass's split layout, ``shared_splits`` of the table's shape
    unless given). Scalars: row_group [B], shared_lens [G], branch_bt [B,
    W] and lengths [B] int32; the shared partials [shared_n, B, H, hd + 2]
    are an input. bf16: the decode core over the suffix tables (grid
    (n_split, kv x 16-head slices, B), ``decode_splits`` of the table's
    shape); fp32: one CTA per (row, KV head) (``tree_branch_kernel``),
    grid (B, kv, 1)."""
    if shared_n is None or shared_keys is None:
        shared_keys, shared_n = shared_splits(page_size, pages_per_seq,
                                              dtype)
    if dtype == torch.bfloat16:
        own_keys, own_n = decode_splits(page_size, pages_per_seq, dtype)
        return ix.Launches((ix.decode_core_grid(
            "paged_tree_branch", batch, q_heads, head_dim, kv_heads,
            num_pages, page_size, pages_per_seq, own_keys, own_n,
            branch=True, num_groups=num_groups, shared_keys=shared_keys,
            shared_n=shared_n),))
    group = q_heads // kv_heads
    cap = pages_per_seq * page_size
    hd = head_dim

    def geometry(cta, rg, sl, bbt, lengths):
        b, h, _ = cta
        ln = ix.clamp(int(lengths[b]), 0, cap)
        g = int(rg[b])
        grouped = 0 <= g < num_groups
        span = ix.clamp(int(sl[g]), 0, cap) if grouped else 0
        used = (min(shared_n, ix.cdiv(min(ln, span), shared_keys))
                if grouped else 0)
        walk = ix.stream_pages(h, b, bbt[b], max(ln - span, 0),
                               pages_per_seq, page_size, num_pages, hd)
        return b, h, g if grouped else -1, used, walk

    def rows(cta, *s):
        return ix.rows_box(cta[0], 1, cta[1] * group, group, hd)

    def part_ranges(cta, *s):
        b, h, _, used, _ = geometry(cta, *s)
        return ([((0, used), (b, b + 1), (h * group, (h + 1) * group),
                  (0, hd + 2))] if used else [])

    def group_ranges(cta, *s):
        g = geometry(cta, *s)[2]
        return [((g, g + 1),)] if g >= 0 else []

    def row_b(cta, *s):
        return [((cta[0], cta[0] + 1),)]

    pool = (kv_heads, num_pages, page_size, hd)
    return ix.Launches((ix.LaunchGrid(
        "paged_tree_branch", "fp32", (batch, kv_heads, 1), (
            ix.OperandAccess("q", (batch, q_heads, hd), rows),
            ix.OperandAccess("k_pages", pool,
                             lambda c, *s: geometry(c, *s)[4][1]),
            ix.OperandAccess("v_pages", pool,
                             lambda c, *s: geometry(c, *s)[4][1]),
            ix.OperandAccess("row_group", (batch,), row_b),
            ix.OperandAccess("shared_lens", (num_groups,), group_ranges),
            ix.OperandAccess("branch_bt", (batch, pages_per_seq),
                             lambda c, *s: geometry(c, *s)[4][0]),
            ix.OperandAccess("lengths", (batch,), row_b),
            ix.OperandAccess("partials", (shared_n, batch, q_heads, hd + 2),
                             part_ranges),
            ix.OperandAccess("out", (batch, q_heads, hd), rows)), 4,
        (("split_keys", cap), ("n_split", 1), ("shared_keys", shared_keys),
         ("shared_n", shared_n))),))


def unpack_partials(partials: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views ``(m [n_split, B, H], l [n_split, B, H], acc [n_split, B, H,
    hd])`` of the shared pass's packed partials [n_split, B, H, hd + 2]."""
    hd = partials.shape[-1] - 2
    return partials[..., hd], partials[..., hd + 1], partials[..., :hd]


def _check(kernel: str, q, k_pages, v_pages, row_group, lengths,
           *tables, partials=None) -> None:
    build.check_paged_operands(kernel, q, k_pages, v_pages, MAX_GROUP)
    build.check_operands(kernel, q, k_pages, v_pages, row_group, lengths,
                         *tables, *(() if partials is None else (partials,)))
    batch = q.shape[0]
    for t in (row_group, lengths, *tables):
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: the map and lengths are int32")
    if tuple(row_group.shape) != (batch,) or \
            tuple(lengths.shape) != (batch,):
        raise ValueError(f"{kernel}: row_group / lengths batch")


def _launch(name: str, argtypes, *args) -> None:
    fn = build.function("paged_tree_decode", name, argtypes)
    build.raise_on_error(name, fn(*args))


def paged_tree_shared_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, row_group: torch.Tensor,
                          shared_bt: torch.Tensor, shared_lens: torch.Tensor,
                          lengths: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The shared pass: raw fp32 partials of each row in a group over its
    group's shared span (keys < min(length, span)), packed as [n_split, B,
    H, hd + 2] (``acc``, ``m``, ``l``; see ``unpack_partials``), and the
    split width ``split_keys``: split ``z`` covers span keys [z *
    split_keys, (z + 1) * split_keys), the last one every key from its
    start (``shared_splits`` of the table's shape; n_split = 1 in fp32).
    Every split of a grouped row is written, (NEG_INF, 0, 0) where it
    holds no visible key; rows in no group are left unwritten. Both go to
    ``paged_tree_branch_fwd`` as they are."""
    split_keys, n_split = shared_splits(k_pages.shape[2], shared_bt.shape[1],
                                        q.dtype)
    return paged_tree_shared_split_fwd(q, k_pages, v_pages, row_group,
                                       shared_bt, shared_lens, lengths,
                                       split_keys, n_split)


def paged_tree_shared_split_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                row_group: torch.Tensor,
                                shared_bt: torch.Tensor,
                                shared_lens: torch.Tensor,
                                lengths: torch.Tensor, split_keys: int,
                                n_split: int) -> Tuple[torch.Tensor, int]:
    """``paged_tree_shared_fwd`` at an explicit layout of ``n_split``
    splits of ``split_keys`` keys (bf16; fp32 takes one split), to time
    one layout against another."""
    global shared_launches
    _check("tree_shared", q, k_pages, v_pages, row_group, lengths,
           shared_bt, shared_lens)
    batch, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    num_groups, width = shared_bt.shape
    if tuple(shared_lens.shape) != (num_groups,):
        raise ValueError("tree_shared: shared_lens does not fit shared_bt")
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 or \
            v_pages.data_ptr() % 16:
        raise ValueError("tree_shared: q and the pages must be 16-byte "
                         "aligned")
    partials = q.new_empty((n_split, batch, q_heads, head_dim + 2),
                           dtype=torch.float32)
    if batch == 0 or num_groups == 0:
        return partials, split_keys
    grids = paged_tree_shared_grid(batch, q_heads, head_dim, kv_heads,
                                   num_pages, page_size, num_groups, width,
                                   q.dtype, n_split, split_keys)
    _launch("tree_shared_launch", _SHARED_ARGTYPES,
            build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), row_group.data_ptr(), shared_bt.data_ptr(),
            shared_lens.data_ptr(), lengths.data_ptr(), partials.data_ptr(),
            batch, q_heads, kv_heads, num_pages, page_size, width,
            num_groups, split_keys, n_split, 1.0 / head_dim ** 0.5,
            *ix.grid_args(grids), build.stream(q))
    shared_launches += 1
    return partials, split_keys


def paged_tree_branch_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, row_group: torch.Tensor,
                          shared_lens: torch.Tensor, branch_bt: torch.Tensor,
                          lengths: torch.Tensor, partials: torch.Tensor,
                          split_keys: int) -> torch.Tensor:
    """The branch pass: each row's suffix ``branch_bt[b]`` over
    ``max(lengths[b] - span, 0)`` tokens, merged with the shared pass's
    split partials where the row is in a group (``paged_tree_shared_fwd``'s
    two results: the packed partials and their split width
    ``split_keys``; merged in split order). Returns [B, H, hd] in q's
    dtype."""
    global branch_launches
    batch, q_heads, head_dim = q.shape
    n_split = partials.shape[0] if partials.dim() == 4 else 0
    if partials.dtype != torch.float32 or \
            not 1 <= n_split <= (MAX_SPLITS if q.dtype == torch.bfloat16
                                 else 1) or \
            tuple(partials.shape[1:]) != (batch, q_heads, head_dim + 2):
        raise ValueError("tree_branch: shared split partials are fp32 "
                         "[n_split, B, H, hd + 2], n_split from 1 to 16 in "
                         "bf16 and 1 in fp32")
    if split_keys < 1:
        raise ValueError("tree_branch: split_keys must be positive")
    _check("tree_branch", q, k_pages, v_pages, row_group, lengths,
           shared_lens, branch_bt, partials=partials)
    kv_heads, num_pages, page_size, _ = k_pages.shape
    if branch_bt.shape[0] != batch:
        raise ValueError("tree_branch: branch_bt batch")
    ptrs = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("tree_branch: q and the pages must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    width = branch_bt.shape[1]
    own_keys, own_n = decode_splits(page_size, width, q.dtype)
    grids = paged_tree_branch_grid(batch, q_heads, head_dim, kv_heads,
                                   num_pages, page_size, width, q.dtype,
                                   shared_lens.shape[0], n_split, split_keys)
    _launch("tree_branch_launch", _BRANCH_ARGTYPES,
            build.dtype_code(q), head_dim, *ptrs,
            row_group.data_ptr(), shared_lens.data_ptr(),
            branch_bt.data_ptr(), lengths.data_ptr(), partials.data_ptr(),
            out.data_ptr(), batch, q_heads, kv_heads, num_pages, page_size,
            width, shared_lens.shape[0], split_keys, n_split, own_keys,
            own_n, 1.0 / head_dim ** 0.5, *ix.grid_args(grids),
            build.stream(q))
    branch_launches += 1
    return out


def paged_tree_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, row_group: torch.Tensor,
                             shared_bt: torch.Tensor,
                             shared_lens: torch.Tensor,
                             branch_bt: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """Tree-decode over the branch x page map: the shared pass, then the
    branch pass on the same stream. Same contract as
    ``paged_attention_decode`` over the full tables the map decomposes;
    both passes take their layouts from the shapes alone."""
    if shared_bt.shape[1] != branch_bt.shape[1]:
        raise ValueError("paged_tree: shared_bt and branch_bt widths differ")
    shared = paged_tree_shared_fwd(q, k_pages, v_pages, row_group,
                                   shared_bt, shared_lens, lengths)
    return paged_tree_branch_fwd(q, k_pages, v_pages, row_group, shared_lens,
                                 branch_bt, lengths, *shared)
