"""Wrapper of the hand-written CUDA tree-decode pair (kernel K3).

The kernels are ``csrc/paged_tree_decode.cu``; they replace the TPU
kernels of ``repro/kernels/paged_attention/tree_decode.py:
paged_tree_attention_fwd`` — ``tree_shared_kernel`` its shared pass
(``_tree_shared_kernel``), ``tree_branch_kernel`` its branch pass
(``_tree_branch_kernel``) with the merge of the two partial sets folded
into the epilogue. ``shared_launches`` and ``branch_launches`` count the
launches of each pass this module made.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import build

shared_launches = 0
branch_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SHARED_ARGTYPES = [_I, _I] + [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]
_BRANCH_ARGTYPES = [_I, _I] + [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P]
MAX_GROUP = 32          # query heads per KV head one CTA holds


def _check(kernel: str, q, k_pages, v_pages, row_group, lengths,
           *tables) -> None:
    build.check_operands(kernel, q, k_pages, v_pages, row_group, lengths,
                         *tables)
    build.check_paged_operands(kernel, q, k_pages, v_pages, MAX_GROUP)
    batch = q.shape[0]
    for t in (row_group, lengths, *tables):
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: the map and lengths are int32")
    if tuple(row_group.shape) != (batch,) or \
            tuple(lengths.shape) != (batch,):
        raise ValueError(f"{kernel}: row_group / lengths batch")


def _launch(name: str, argtypes, *args) -> None:
    fn = getattr(build.load("paged_tree_decode"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    build.raise_on_error(name, fn(*args))


def paged_tree_shared_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, row_group: torch.Tensor,
                          shared_bt: torch.Tensor, shared_lens: torch.Tensor,
                          lengths: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The shared pass: raw fp32 partials ``(m [B, H], l [B, H], acc
    [B, H, hd])`` of each row in a group over its group's shared span
    (keys < min(length, span)). Rows in no group are left unwritten."""
    global shared_launches
    _check("tree_shared", q, k_pages, v_pages, row_group, lengths,
           shared_bt, shared_lens)
    batch, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    num_groups, width = shared_bt.shape
    if tuple(shared_lens.shape) != (num_groups,):
        raise ValueError("tree_shared: shared_lens does not fit shared_bt")
    m = torch.empty((batch, q_heads), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((batch, q_heads, head_dim), dtype=torch.float32,
                      device=q.device)
    if batch == 0 or num_groups == 0:
        return m, l, acc
    _launch("tree_shared_launch", _SHARED_ARGTYPES,
            build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), row_group.data_ptr(), shared_bt.data_ptr(),
            shared_lens.data_ptr(), lengths.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), batch, q_heads, kv_heads,
            num_pages, page_size, width, num_groups, 1.0 / head_dim ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    shared_launches += 1
    return m, l, acc


def paged_tree_branch_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, row_group: torch.Tensor,
                          shared_lens: torch.Tensor, branch_bt: torch.Tensor,
                          lengths: torch.Tensor, m_shared: torch.Tensor,
                          l_shared: torch.Tensor, acc_shared: torch.Tensor
                          ) -> torch.Tensor:
    """The branch pass: each row's suffix ``branch_bt[b]`` over
    ``max(lengths[b] - span, 0)`` tokens, merged with the shared pass's
    partials where the row is in a group. Returns [B, H, hd] in q's
    dtype."""
    global branch_launches
    _check("tree_branch", q, k_pages, v_pages, row_group, lengths,
           shared_lens, branch_bt)
    build.check_operands("tree_branch", q, m_shared, l_shared, acc_shared)
    batch, q_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    if branch_bt.shape[0] != batch:
        raise ValueError("tree_branch: branch_bt batch")
    if (m_shared.dtype, l_shared.dtype, acc_shared.dtype) != \
            (torch.float32,) * 3 or tuple(acc_shared.shape) != \
            tuple(q.shape) or tuple(m_shared.shape) != (batch, q_heads) \
            or l_shared.shape != m_shared.shape:
        raise ValueError("tree_branch: shared partials are fp32 [B, H] "
                         "and [B, H, hd]")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    _launch("tree_branch_launch", _BRANCH_ARGTYPES,
            build.dtype_code(q), head_dim, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), row_group.data_ptr(), shared_lens.data_ptr(),
            branch_bt.data_ptr(), lengths.data_ptr(), m_shared.data_ptr(),
            l_shared.data_ptr(), acc_shared.data_ptr(), out.data_ptr(),
            batch, q_heads, kv_heads, num_pages, page_size,
            branch_bt.shape[1], shared_lens.shape[0], 1.0 / head_dim ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    branch_launches += 1
    return out


def paged_tree_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, row_group: torch.Tensor,
                             shared_bt: torch.Tensor,
                             shared_lens: torch.Tensor,
                             branch_bt: torch.Tensor, lengths: torch.Tensor
                             ) -> torch.Tensor:
    """Tree-decode over the branch x page map: the shared pass, then the
    branch pass on the same stream. Same contract as
    ``paged_attention_decode`` over the full tables the map decomposes."""
    if shared_bt.shape[1] != branch_bt.shape[1]:
        raise ValueError("paged_tree: shared_bt and branch_bt widths differ")
    m, l, acc = paged_tree_shared_fwd(q, k_pages, v_pages, row_group,
                                      shared_bt, shared_lens, lengths)
    return paged_tree_branch_fwd(q, k_pages, v_pages, row_group, shared_lens,
                                 branch_bt, lengths, m, l, acc)
