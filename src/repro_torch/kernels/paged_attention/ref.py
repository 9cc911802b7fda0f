"""Plain PyTorch versions of the paged flash-decode (kernel K1) and the
tree-decode pair (kernel K3).

Counterpart of ``repro.kernels.paged_attention.ref``. They are what the
CPU runs and the yardsticks the CUDA kernels are held to on the card.
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


def paged_tree_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, row_group: torch.Tensor,
                             shared_bt: torch.Tensor,
                             shared_lens: torch.Tensor,
                             branch_bt: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the tree-decode pair: rebuilds each row's full
    block table from the map — its group's shared pages, then its
    post-fork suffix — and defers to ``paged_attention_decode_ref``. The
    map splits tables on whole pages only, so the rebuilt table is the
    per-branch one and the result is bit-identical to the per-branch plain
    version (``repro.kernels.paged_attention.ref.paged_tree_attention_ref``
    does the same). A ``row_group`` entry outside [0, G) means the row is
    in no group."""
    full_bt = tree_full_tables(row_group, shared_bt, shared_lens, branch_bt,
                               k_pages.shape[2])
    return paged_attention_decode_ref(q, k_pages, v_pages, full_bt, lengths)


def tree_full_tables(row_group: torch.Tensor, shared_bt: torch.Tensor,
                     shared_lens: torch.Tensor, branch_bt: torch.Tensor,
                     page_size: int) -> torch.Tensor:
    """Each row's full block table [B, W] rebuilt from the tree map: its
    group's shared pages, then its suffix, sentinel-padded as
    ``branch_bt`` is."""
    num_groups, width = shared_bt.shape
    rg = row_group.long()
    grouped = (rg >= 0) & (rg < num_groups)
    grp = rg.clamp(0, num_groups - 1)
    sh_pages = torch.where(grouped, shared_lens.long()[grp] // page_size, 0)
    idx = torch.arange(width, device=branch_bt.device)[None, :]
    suffix_idx = (idx - sh_pages[:, None]).clamp(0, width - 1)
    return torch.where(idx < sh_pages[:, None], shared_bt[grp],
                       torch.gather(branch_bt, 1, suffix_idx))


def _partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              end: torch.Tensor):
    """Raw fp32 online-softmax partials of q [B, H, hd] over gathered
    k/v [B, kv, S, hd], row b seeing keys < end[b]: (m, l, acc) as
    [B, H], [B, H], [B, H, hd]; a row with no key gets (NEG_INF, 0, 0)."""
    batch, q_heads, head_dim = q.shape
    kv_heads = k.shape[1]
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            < end[:, None])[:, None, None, :]         # [B, 1, 1, S]
    qg = q.reshape(batch, kv_heads, -1, head_dim).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k) / (head_dim ** 0.5)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.masked_fill(
        ~mask.transpose(-1, -2), 0.0))
    return (m.reshape(batch, q_heads), p.sum(-1).reshape(batch, q_heads),
            acc.reshape(batch, q_heads, head_dim))


def tree_shared_partials_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, row_group: torch.Tensor,
                             shared_bt: torch.Tensor,
                             shared_lens: torch.Tensor,
                             lengths: torch.Tensor):
    """Plain version of K3's shared pass: each grouped row's raw partials
    over its group's shared pages, keys < min(length, span). Rows in no
    group get (NEG_INF, 0, 0), which the kernel leaves unwritten."""
    num_groups = shared_bt.shape[0]
    rg = row_group.long()
    grouped = (rg >= 0) & (rg < num_groups)
    grp = rg.clamp(0, num_groups - 1)
    table = shared_bt[grp]
    span = torch.where(grouped, shared_lens.long()[grp], 0)
    end = torch.minimum(lengths.long(), span)
    return _partials(q, gather_pages(k_pages, table).float(),
                     gather_pages(v_pages, table).float(), end)


def tree_branch_merge_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, row_group: torch.Tensor,
                          shared_lens: torch.Tensor, branch_bt: torch.Tensor,
                          lengths: torch.Tensor, m_shared: torch.Tensor,
                          l_shared: torch.Tensor,
                          acc_shared: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's branch pass: each row's suffix partials over
    ``max(length - span, 0)`` keys of ``branch_bt``, merged with the
    shared partials where the row is in a group (the others' shared
    partials are never read), then divided. [B, H, hd] in q's dtype."""
    num_groups = shared_lens.shape[0]
    rg = row_group.long()
    grouped = (rg >= 0) & (rg < num_groups)
    grp = rg.clamp(0, num_groups - 1)
    span = torch.where(grouped, shared_lens.long()[grp], 0)
    end = (lengths.long() - span).clamp_min(0)
    m_b, l_b, acc_b = _partials(q, gather_pages(k_pages, branch_bt).float(),
                                gather_pages(v_pages, branch_bt).float(), end)
    g2 = grouped[:, None]
    m_s = torch.where(g2, m_shared, NEG_INF)
    l_s = torch.where(g2, l_shared, 0.0)
    acc_s = torch.where(g2[..., None], acc_shared, 0.0)
    m = torch.maximum(m_s, m_b)
    a_s, a_b = torch.exp(m_s - m), torch.exp(m_b - m)
    l = l_s * a_s + l_b * a_b
    acc = acc_s * a_s[..., None] + acc_b * a_b[..., None]
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
