"""Plain PyTorch versions of the dense flash prefill (kernel K5) and the
paged flash-prefill (kernel K2).

Counterparts of ``repro.kernels.flash_prefill.ref.flash_prefill_ref`` (with
the ``true_len`` of the Pallas ``flash_prefill``) and
``paged_flash_prefill_ref``. They are what the CPU runs and the yardsticks
the CUDA kernels are held to on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..paged_attention.ref import NEG_INF, gather_pages


# Past this many positions the plain version attends in query blocks of
# Q_BLOCK rows, so its transient scores are [Q_BLOCK, S] per head, never
# [S, S] (the reference's ``models/attention.py`` CHUNKED_THRESHOLD and
# Q_CHUNK, where ``_attend_chunked`` takes over).
CHUNKED_THRESHOLD = 2048
Q_BLOCK = 512


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      true_len: Optional[int] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, S, Hkv, hd] with Hkv | H (GQA: each KV
    head serves H / Hkv query heads). Full softmax attention in fp32,
    causal on positions or not; with ``true_len`` (a host int, 0 <
    true_len <= S) keys at or past it are never attended and rows at or
    past it are exact zeros. Returns [B, S, H, hd] in q's dtype.
    Up to ``CHUNKED_THRESHOLD`` positions the scores are one [S, S] fp32
    tensor per head; past it, query blocks of ``Q_BLOCK`` rows (the same
    function with fp32 scores and P, [Q_BLOCK, S] per head at a time).
    Correctness only."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    n = s if true_len is None else int(true_len)
    qg = q.reshape(b, s, hkv, h // hkv, hd).float()
    kf, vf = k.float(), v.float()
    block = s if s <= CHUNKED_THRESHOLD else Q_BLOCK
    pos = torch.arange(s, device=q.device)
    out = torch.empty((b, s, hkv, h // hkv, hd), dtype=torch.float32,
                      device=q.device)
    for r0 in range(0, s, block):
        rows = pos[r0:r0 + block]
        # a causal block sees no key past its last row
        sk = min(int(rows[-1]) + 1, s) if causal else s
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, r0:r0 + block],
                              kf[:, :sk]) / (hd ** 0.5)
        mask = (pos[:sk] < n)[None, :].expand(len(rows), sk)   # [Sq, Sk]
        if causal:
            mask = mask & (pos[None, :sk] <= rows[:, None])
        scores = scores.masked_fill(~mask, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out[:, r0:r0 + block] = torch.einsum("bkgqs,bskd->bqkgd", w,
                                             vf[:, :sk])
    out = out.masked_fill((pos >= n)[None, :, None, None, None], 0.0)
    return out.reshape(b, s, h, hd).to(q.dtype)


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
