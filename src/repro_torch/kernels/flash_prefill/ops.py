"""Public dense flash prefill (kernel K5) and paged flash-prefill (kernel
K2): the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
tensors."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .flash_prefill import flash_prefill
from .paged_prefill import (paged_flash_prefill_fwd,
                            paged_flash_prefill_lanes_fwd)
from .ref import (flash_prefill_ref, paged_flash_prefill_lanes_ref,
                  paged_flash_prefill_ref)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    true_len: Optional[int] = None) -> torch.Tensor:
    """Dense flash prefill attention, [B, S, H, hd] (see ``ref.py`` for
    the contract): q [B, S, H, hd], k and v [B, S, Hkv, hd] with Hkv | H,
    never pre-repeated. ``true_len`` is a host int or None. Dispatches on
    the device of ``q``."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, causal, true_len)
    return flash_prefill(q, k, v, causal, true_len)


def paged_flash_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        pos0: int, valid_len: int) -> torch.Tensor:
    """Fused mixed-step chunk attention, [T, H, hd] (see ``ref.py`` for
    the contract). ``pos0`` and ``valid_len`` are host ints. Dispatches on
    the device of ``q``."""
    if q.device.type == "cpu":
        return paged_flash_prefill_ref(q, k_pages, v_pages, block_table,
                                       pos0, valid_len)
    return paged_flash_prefill_fwd(q, k_pages, v_pages, block_table, pos0,
                                   valid_len)


def paged_flash_prefill_lanes(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              positions: torch.Tensor,
                              chunk_lens: torch.Tensor,
                              lane_buckets: Sequence[int]) -> torch.Tensor:
    """Every chunk lane of a mixed step at once, [R, H, hd]: lane i holds
    ``lane_buckets[i]`` consecutive rows of q, and its pos0, block table
    and valid length are its first row's entry of ``positions`` and
    ``block_tables`` and ``chunk_lens[i]`` (device arrays: no host int
    that changes between steps). Each lane is ``paged_flash_prefill`` of
    its rows. Dispatches on the device of ``q``; on the card one launch."""
    if q.device.type == "cpu":
        return paged_flash_prefill_lanes_ref(q, k_pages, v_pages,
                                             block_tables, positions,
                                             chunk_lens, lane_buckets)
    return paged_flash_prefill_lanes_fwd(q, k_pages, v_pages, block_tables,
                                         positions, chunk_lens, lane_buckets)


def mixed_step_bytes_read(chunk: int, pos0: int, page_size: int,
                          kv_heads: int, head_dim: int, *, path: str,
                          block_q: int = 128, itemsize: int = 4) -> int:
    """Analytic K+V HBM bytes the chunk-row attention of one mixed step
    reads (copied from ``repro.kernels.flash_prefill.ops``).

    ``path="decode"`` is the per-token flash-decode loop: every chunk row
    streams its whole visible context. ``path="fused"`` is the paged
    flash-prefill kernel: each q block streams the context once, and pages
    past a block's causal horizon are never fetched.
    """
    if path == "decode":
        pages = sum(math.ceil((pos0 + i + 1) / page_size)
                    for i in range(chunk))
    elif path == "fused":
        bq = min(block_q, chunk)
        pages = sum(
            math.ceil((pos0 + min((qi + 1) * bq, chunk)) / page_size)
            for qi in range(math.ceil(chunk / bq)))
    else:
        raise ValueError(f"unknown mixed-step path {path!r}")
    return 2 * pages * page_size * kv_heads * head_dim * itemsize
