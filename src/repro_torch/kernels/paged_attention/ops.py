"""Public paged flash-decode (kernel K1) and tree-decode (kernel K3): the
CUDA kernels for CUDA tensors, the plain PyTorch versions for CPU
tensors."""
from __future__ import annotations

from typing import Sequence

import torch

from .paged_attention import paged_attention_decode
from .ref import paged_attention_decode_ref, paged_tree_attention_ref
from .tree_decode import paged_tree_attention_fwd


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode attention, [B, H, hd] (see ``ref.py`` for the
    contract). Dispatches on the device of ``q``."""
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_pages, v_pages, block_tables,
                                          lengths)
    return paged_attention_decode(q, k_pages, v_pages, block_tables, lengths)


def paged_tree_attention(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, row_group: torch.Tensor,
                         shared_bt: torch.Tensor, shared_lens: torch.Tensor,
                         branch_bt: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Tree/cascade decode attention over a branch x page map (built by
    ``repro_torch.kv.tree_decode_map``): each fork group's shared pages
    are streamed once for all its rows. Same output as
    ``paged_attention`` over the per-row full tables the map decomposes;
    no host int of a step's map reaches the card's launches. Dispatches on
    the device of ``q``."""
    if q.device.type == "cpu":
        return paged_tree_attention_ref(q, k_pages, v_pages, row_group,
                                        shared_bt, shared_lens, branch_bt,
                                        lengths)
    return paged_tree_attention_fwd(q, k_pages, v_pages, row_group,
                                    shared_bt, shared_lens, branch_bt,
                                    lengths)


def tree_decode_bytes_read(shared_pages: int, branch_pages: Sequence[int],
                           page_size: int, kv_heads: int, head_dim: int, *,
                           path: str, itemsize: int = 4) -> int:
    """Analytic K+V HBM bytes one decode step reads for a fork group of
    sibling branches with ``shared_pages`` common ancestor pages and
    per-branch post-fork suffixes ``branch_pages`` (copied from
    ``repro.kernels.paged_attention.ops``).

    ``path="branch"`` is the per-branch flash-decode loop: every sibling
    re-streams the shared ancestor pages. ``path="tree"`` streams them
    once (shared pass) plus each suffix once (branch pass).
    """
    if path == "branch":
        pages = sum(shared_pages + bp for bp in branch_pages)
    elif path == "tree":
        pages = shared_pages + sum(branch_pages)
    else:
        raise ValueError(f"unknown tree-decode path {path!r}")
    return 2 * pages * page_size * kv_heads * head_dim * itemsize
