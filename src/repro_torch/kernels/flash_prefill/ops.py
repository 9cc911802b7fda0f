"""Public paged flash-prefill (kernel K2): the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors."""
from __future__ import annotations

import math

import torch

from .paged_prefill import paged_flash_prefill_fwd
from .ref import paged_flash_prefill_ref


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
