"""Public paged flash-decode (kernel K1): the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors."""
from __future__ import annotations

import torch

from .paged_attention import paged_attention_decode
from .ref import paged_attention_decode_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode attention, [B, H, hd] (see ``ref.py`` for the
    contract). Dispatches on the device of ``q``."""
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_pages, v_pages, block_tables,
                                          lengths)
    return paged_attention_decode(q, k_pages, v_pages, block_tables, lengths)
