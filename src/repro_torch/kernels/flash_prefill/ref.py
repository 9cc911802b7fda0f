"""Plain PyTorch versions of the dense flash prefill (kernel K5, with its
log-sum-exp and its gradient) and the paged flash-prefill (kernel K2).

Counterparts of ``repro.kernels.flash_prefill.ref.flash_prefill_ref`` (with
the ``true_len`` of the Pallas ``flash_prefill``) and
``paged_flash_prefill_ref``. They are what the CPU runs and the yardsticks
the CUDA kernels are held to on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

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
        # a causal block sees no key past its last row (from host ints:
        # a train step's body reads no tensor value on the host)
        sk = min(r0 + block, s) if causal else s
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


def _blocks(s: int):
    """The query blocks of the plain versions: one up to
    ``CHUNKED_THRESHOLD`` positions, blocks of ``Q_BLOCK`` past it."""
    block = s if s <= CHUNKED_THRESHOLD else Q_BLOCK
    return [(r0, min(r0 + block, s)) for r0 in range(0, s, block)]


def _visible(rows, pos_k, n: int, causal: bool):
    """[rows, keys] bool: key < n, row < n and (causal) key <= row."""
    mask = (pos_k < n)[None, :] & (rows < n)[:, None]
    if causal:
        mask = mask & (pos_k[None, :] <= rows[:, None])
    return mask


def flash_prefill_lse_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          true_len: Optional[int] = None) -> torch.Tensor:
    """The log-sum-exp K5's forward writes for its backward: fp32 [B, H,
    S], the natural log of sum_j exp(q_i.k_j / sqrt(hd)) over row i's
    visible keys, 0 for rows at or past ``true_len``."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    n = s if true_len is None else int(true_len)
    qg = q.reshape(b, s, hkv, h // hkv, hd).float()
    kf = k.float()
    pos = torch.arange(s, device=q.device)
    lse = torch.zeros((b, hkv, h // hkv, s), dtype=torch.float32,
                      device=q.device)
    for r0, r1 in _blocks(s):
        sk = r1 if causal else s
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, r0:r1],
                              kf[:, :sk]) / (hd ** 0.5)
        mask = _visible(pos[r0:r1], pos[:sk], n, causal)
        out = torch.logsumexp(scores.masked_fill(~mask, NEG_INF), dim=-1)
        lse[..., r0:r1] = out.masked_fill(pos[r0:r1] >= n, 0.0)
    return lse.reshape(b, h, s)


def flash_prefill_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          dout: torch.Tensor, causal: bool = True,
                          true_len: Optional[int] = None):
    """The gradient of ``flash_prefill_ref`` written out, in fp32: with
    P = exp(q.k / sqrt(hd) - lse) on visible (row, key) pairs and 0
    elsewhere, D = rowsum(dout * out) and dS = P (dout.v - D),
    dv = P^T dout, dk = dS^T q / sqrt(hd), dq = dS k / sqrt(hd); GQA
    heads summed into their KV head. ``lse`` is [B, H, S] (the kernel's,
    or ``flash_prefill_lse_ref``'s). Returns (dq, dk, dv) in the inputs'
    dtypes. Correctness only (query blocks past ``CHUNKED_THRESHOLD``, as
    ``flash_prefill_ref``)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    n = s if true_len is None else int(true_len)
    scale = 1.0 / hd ** 0.5

    def grouped(t):
        return t.reshape(b, s, hkv, g, hd).float()
    qg, og, dog = grouped(q), grouped(out), grouped(dout)
    kf, vf = k.float(), v.float()
    lse_g = lse.float().reshape(b, hkv, g, s)
    delta = torch.einsum("bskgd,bskgd->bkgs", dog, og)
    pos = torch.arange(s, device=q.device)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0, r1 in _blocks(s):
        sk = r1 if causal else s
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, r0:r1],
                              kf[:, :sk]) * scale
        mask = _visible(pos[r0:r1], pos[:sk], n, causal)
        p = torch.where(mask, torch.exp(scores - lse_g[..., r0:r1, None]),
                        0.0)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog[:, r0:r1], vf[:, :sk])
        ds = p * (dp - delta[..., r0:r1, None])
        dv[:, :sk] += torch.einsum("bkgqs,bqkgd->bskd", p, dog[:, r0:r1])
        dk[:, :sk] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                   qg[:, r0:r1]) * scale
        dq[:, r0:r1] = torch.einsum("bkgqs,bskd->bqkgd", ds,
                                    kf[:, :sk]) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_flash_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            pos0, valid_len) -> torch.Tensor:
    """q [T, H, hd] chunk rows of one request against pages [kv, P, ps,
    hd] through its block table [W]. Row i sits at absolute position
    pos0 + i and sees keys at positions <= pos0 + i; rows >= valid_len are
    bucket padding and return exact zeros. ``pos0`` and ``valid_len`` are
    host ints or 0-d integer tensors on q's device (then nothing here
    reads a value on the host). Returns [T, H, hd] in q's dtype.
    O(T * W * ps) memory, correctness only."""
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
    horizon = pos0 + (valid_len.clamp(0, t)
                      if isinstance(valid_len, torch.Tensor)
                      else max(min(valid_len, t), 0))
    v = v.masked_fill((torch.arange(s_max, device=q.device) >= horizon)
                      [None, :, None], 0.0)
    out = torch.einsum("tkgs,ksd->tkgd", w, v)
    out = out.masked_fill((rows >= valid_len)[:, None, None, None], 0.0)
    return out.reshape(t, q_heads, head_dim).to(q.dtype)


def paged_flash_prefill_lanes_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  positions: torch.Tensor,
                                  chunk_lens: torch.Tensor,
                                  lane_buckets: Sequence[int]
                                  ) -> torch.Tensor:
    """Every chunk lane of a step: q [R, H, hd] holds the lanes' rows in
    order (lane i has ``lane_buckets[i]`` rows), block_tables [R, W] and
    positions [R] the same rows'; chunk_lens [n_lanes]. Lane i is
    ``paged_flash_prefill_ref`` of its rows through its first row's table,
    from its first row's position, with ``chunk_lens[i]`` valid rows
    (read on the device: no host read of a value). Returns [R, H, hd] in
    q's dtype."""
    parts, off = [], 0
    for i, bk in enumerate(lane_buckets):
        parts.append(paged_flash_prefill_ref(
            q[off:off + bk], k_pages, v_pages, block_tables[off],
            positions[off].long(), chunk_lens[i].long()))
        off += bk
    return torch.cat(parts, 0) if parts else q.new_zeros(q.shape)
