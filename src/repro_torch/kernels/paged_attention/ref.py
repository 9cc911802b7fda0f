"""Plain PyTorch version of the paged flash-decode (kernel K1).

Counterpart of ``repro.kernels.paged_attention.ref``. It is what the CPU
runs and the yardstick the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pages [kv, P, ps, hd], table [..., W] -> [..., kv, W*ps, hd], with
    table entries clamped into the pool (a sentinel never indexes past
    it; the positions it covers are masked by the caller)."""
    kv, num_pages, ps, hd = pages.shape
    t = table.long().clamp(0, num_pages - 1)
    g = pages[:, t]                                  # [kv, ..., W, ps, hd]
    g = g.movedim(0, -4)                             # [..., kv, W, ps, hd]
    return g.reshape(*t.shape[:-1], kv, t.shape[-1] * ps, hd)


def paged_attention_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [B, H, hd] against pages [kv, P, ps, hd] through block_tables
    [B, W]; row b attends its first ``lengths[b]`` positions. Returns
    [B, H, hd] in q's dtype; a row of length 0 gives exact zeros, as the
    kernel's max(l, 1e-30) epilogue does. Gathers every row's pages into
    a contiguous context: O(B * W * ps) memory, correctness only."""
    batch, q_heads, head_dim = q.shape
    kv_heads = k_pages.shape[0]
    group = q_heads // kv_heads
    k = gather_pages(k_pages, block_tables).float()   # [B, kv, S, hd]
    v = gather_pages(v_pages, block_tables).float()
    s_max = k.shape[2]
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < lengths.long()[:, None])                 # [B, S]
    # masked keys get weight 0 and masked values are zeroed, so a stale
    # page's bytes never reach the sum
    v = v.masked_fill(~mask[:, None, :, None], 0.0)
    qg = q.reshape(batch, kv_heads, group, head_dim).float()
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) / (head_dim ** 0.5)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, v)
    out = out.masked_fill((lengths <= 0)[:, None, None, None], 0.0)
    return out.reshape(batch, q_heads, head_dim).to(q.dtype)
