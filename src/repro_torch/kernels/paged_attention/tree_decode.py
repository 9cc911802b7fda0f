"""Wrapper of the hand-written CUDA tree-decode pair (kernel K3).

The kernels are ``csrc/paged_tree_decode.cu``; they replace the TPU
kernels of ``repro/kernels/paged_attention/tree_decode.py:
paged_tree_attention_fwd`` — ``tree_shared_kernel`` its shared pass
(``_tree_shared_kernel``), ``tree_branch_kernel`` its branch pass
(``_tree_branch_kernel``) with the merge of the partial sets folded
into the epilogue; in bf16 the branch pass is K1's split-key tensor-core
decode core (``csrc/paged_decode_mma.cuh``) over the suffix tables, cut
by ``ref.decode_splits`` from the shapes alone. In bf16 the shared pass
is split over the span
(``shared_splits``): its fp32 partials are one tensor [n_split, B, H, hd
+ 2], each row ``acc`` then ``m`` then ``l`` (``unpack_partials`` gives
the three as views), returned with the split width; the branch pass
takes both and merges the splits in order before the row's suffix. In
fp32 the shared pass runs the whole span as one split (n_split = 1). The
wrappers' host time is paid on every decode step of the tree path, so
they make one allocation each and few tensor calls.
``shared_launches`` and ``branch_launches`` count the launches of each
pass this module made.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import build
from .ref import decode_splits

shared_launches = 0
branch_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SHARED_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P]
_BRANCH_ARGTYPES = [_I, _I] + [_P] * 9 + [_I] * 11 + [ctypes.c_float, _P]
MAX_GROUP = 32          # query heads per KV head one CTA holds
MIN_SPLIT_KEYS = 32     # the bf16 shared pass's smallest split, in keys
MAX_SPLITS = 16         # and its most splits of one span


@functools.lru_cache(maxsize=256)
def shared_splits(page_size: int, width: int, dtype: torch.dtype,
                  span: int) -> Tuple[int, int]:
    """``(split_keys, n_split)`` of the shared pass over tables of
    ``width`` pages of ``page_size`` tokens whose groups' spans are at
    most ``span`` tokens (a host int the caller knows, as the engine does
    from its host map). bf16: splits of whole pages, at least 32 keys,
    doubled until at most 16 cover the span (never more than the table):
    the tree serve's 256-token span of 16-token pages is 8 splits of 32
    keys, so its 2 groups x 8 KV heads give 128 CTAs, all with keys.
    fp32: one split (the CUDA-core loop). The last split also takes every
    key past its start, so a span longer than ``span`` is still attended
    whole."""
    cap = page_size * width
    if dtype != torch.bfloat16:
        return max(cap, 1), 1
    cover = -(-min(max(int(span), 0), cap) // page_size)    # pages to cover
    pages = max(1, -(-MIN_SPLIT_KEYS // page_size))
    while -(-cover // pages) > MAX_SPLITS:
        pages *= 2
    return pages * page_size, max(1, -(-cover // pages))


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
                          lengths: torch.Tensor, span: int
                          ) -> Tuple[torch.Tensor, int]:
    """The shared pass: raw fp32 partials of each row in a group over its
    group's shared span (keys < min(length, span)), packed as [n_split, B,
    H, hd + 2] (``acc``, ``m``, ``l``; see ``unpack_partials``), and the
    split width ``split_keys``: split ``z`` covers span keys [z *
    split_keys, (z + 1) * split_keys), the last one every key from its
    start (``shared_splits`` with the host ``span``, the longest group
    span; n_split = 1 in fp32). Every split of a grouped row is written,
    (NEG_INF, 0, 0) where it holds no visible key; rows in no group are
    left unwritten. Both go to ``paged_tree_branch_fwd`` as they are."""
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
    split_keys, n_split = shared_splits(page_size, width, q.dtype, span)
    partials = q.new_empty((n_split, batch, q_heads, head_dim + 2),
                           dtype=torch.float32)
    if batch == 0 or num_groups == 0:
        return partials, split_keys
    _launch("tree_shared_launch", _SHARED_ARGTYPES,
            build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), row_group.data_ptr(), shared_bt.data_ptr(),
            shared_lens.data_ptr(), lengths.data_ptr(), partials.data_ptr(),
            batch, q_heads, kv_heads, num_pages, page_size, width,
            num_groups, split_keys, n_split, 1.0 / head_dim ** 0.5,
            build.stream(q))
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
    _launch("tree_branch_launch", _BRANCH_ARGTYPES,
            build.dtype_code(q), head_dim, *ptrs,
            row_group.data_ptr(), shared_lens.data_ptr(),
            branch_bt.data_ptr(), lengths.data_ptr(), partials.data_ptr(),
            out.data_ptr(), batch, q_heads, kv_heads, num_pages, page_size,
            width, shared_lens.shape[0], split_keys, n_split, own_keys,
            own_n, 1.0 / head_dim ** 0.5, build.stream(q))
    branch_launches += 1
    return out


def paged_tree_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, row_group: torch.Tensor,
                             shared_bt: torch.Tensor,
                             shared_lens: torch.Tensor,
                             branch_bt: torch.Tensor, lengths: torch.Tensor,
                             span: int) -> torch.Tensor:
    """Tree-decode over the branch x page map: the shared pass, then the
    branch pass on the same stream. Same contract as
    ``paged_attention_decode`` over the full tables the map decomposes;
    ``span`` (a host int, the longest group span) only sets how the
    shared pass splits."""
    if shared_bt.shape[1] != branch_bt.shape[1]:
        raise ValueError("paged_tree: shared_bt and branch_bt widths differ")
    shared = paged_tree_shared_fwd(q, k_pages, v_pages, row_group,
                                   shared_bt, shared_lens, lengths, span)
    return paged_tree_branch_fwd(q, k_pages, v_pages, row_group, shared_lens,
                                 branch_bt, lengths, *shared)
