"""Plain PyTorch version of the paged flash-prefill (kernel K2).

Counterpart of ``repro.kernels.flash_prefill.ref.paged_flash_prefill_ref``.
It is what the CPU runs and the yardstick the CUDA kernel is held to on
the card.
"""
from __future__ import annotations

import torch

from ..paged_attention.ref import NEG_INF, gather_pages


def paged_flash_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            pos0: int, valid_len: int) -> torch.Tensor:
    """q [T, H, hd] chunk rows of one request against pages [kv, P, ps,
    hd] through its block table [W]. Row i sits at absolute position
    pos0 + i and sees keys at positions <= pos0 + i; rows >= valid_len are
    bucket padding and return exact zeros. Returns [T, H, hd] in q's
    dtype. O(T * W * ps) memory, correctness only."""
    t, q_heads, head_dim = q.shape
    kv_heads = k_pages.shape[0]
    group = q_heads // kv_heads
    k = gather_pages(k_pages, block_table).float()     # [kv, S, hd]
    v = gather_pages(v_pages, block_table).float()
    s_max = k.shape[1]
    rows = torch.arange(t, device=q.device)
    mask = (torch.arange(s_max, device=q.device)[None, :]
            <= pos0 + rows[:, None])                    # [T, S]
    qg = q.reshape(t, kv_heads, group, head_dim).float()
    scores = torch.einsum("tkgd,ksd->tkgs", qg, k) / (head_dim ** 0.5)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # keys past the last valid row's horizon never count: zero their
    # values so a stale page's bytes cannot reach the sum
    horizon = pos0 + max(min(valid_len, t), 0)
    v = v.masked_fill((torch.arange(s_max, device=q.device) >= horizon)
                      [None, :, None], 0.0)
    out = torch.einsum("tkgs,ksd->tkgd", w, v)
    out = out.masked_fill((rows >= valid_len)[:, None, None, None], 0.0)
    return out.reshape(t, q_heads, head_dim).to(q.dtype)
