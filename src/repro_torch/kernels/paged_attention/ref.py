"""Plain PyTorch versions of the paged flash-decode (kernel K1) and the
tree-decode pair (kernel K3).

Counterpart of ``repro.kernels.paged_attention.ref``. They are what the
CPU runs and the yardsticks the CUDA kernels are held to on the card.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

#: the bf16 decode core's layout (csrc/paged_decode_mma.cuh): keys per
#: warp tile, warps per CTA, the most CTAs (key splits) of one row, and the
#: fewest keys a split takes before a table is cut over CTAs
DECODE_TILE_KEYS = 32
DECODE_WARPS = 4
DECODE_MAX_SPLITS = 8
DECODE_MIN_SPLIT_KEYS = 1024


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
              end: torch.Tensor, start: int = 0):
    """Raw fp32 online-softmax partials of q [B, H, hd] over gathered
    k/v [B, kv, S, hd], row b seeing keys start <= key < end[b]: (m, l,
    acc) as [B, H], [B, H], [B, H, hd]; a row with no key gets
    (NEG_INF, 0, 0)."""
    key = torch.arange(k.shape[2], device=q.device)[None, :]
    return _masked_partials(q, k, v, (key >= start) & (key < end[:, None]))


def _masked_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keys: torch.Tensor):
    """``_partials`` over the keys that ``keys`` [B, S] (bool) marks."""
    batch, q_heads, head_dim = q.shape
    kv_heads = k.shape[1]
    mask = keys[:, None, None, :]
    qg = q.reshape(batch, kv_heads, -1, head_dim).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k) / (head_dim ** 0.5)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.masked_fill(
        ~mask.transpose(-1, -2), 0.0))
    return (m.reshape(batch, q_heads), p.sum(-1).reshape(batch, q_heads),
            acc.reshape(batch, q_heads, head_dim))


def _shared_span(q, k_pages, v_pages, row_group, shared_bt, shared_lens,
                 lengths):
    """Each row's group's gathered shared K/V [B, kv, S, hd] (fp32) and
    its visible end min(length, span); 0 for a row in no group."""
    num_groups = shared_bt.shape[0]
    rg = row_group.long()
    grouped = (rg >= 0) & (rg < num_groups)
    grp = rg.clamp(0, num_groups - 1)
    table = shared_bt[grp]
    span = torch.where(grouped, shared_lens.long()[grp], 0)
    end = torch.minimum(lengths.long(), span)
    return (gather_pages(k_pages, table).float(),
            gather_pages(v_pages, table).float(), end)


def tree_shared_partials_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, row_group: torch.Tensor,
                             shared_bt: torch.Tensor,
                             shared_lens: torch.Tensor,
                             lengths: torch.Tensor):
    """Plain version of K3's shared pass: each grouped row's raw partials
    over its group's shared pages, keys < min(length, span). Rows in no
    group get (NEG_INF, 0, 0), which the kernel leaves unwritten."""
    k, v, end = _shared_span(q, k_pages, v_pages, row_group, shared_bt,
                             shared_lens, lengths)
    return _partials(q, k, v, end)


def tree_shared_split_partials_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   row_group: torch.Tensor,
                                   shared_bt: torch.Tensor,
                                   shared_lens: torch.Tensor,
                                   lengths: torch.Tensor, split_keys: int,
                                   n_split: int):
    """Plain version of the bf16 shared pass's split partials: split z
    holds each grouped row's raw partials over span keys [z * split_keys,
    (z + 1) * split_keys), the last split every key from its start, keys
    < min(length, span) only; (m, l, acc) as [n_split, B, H], [n_split,
    B, H], [n_split, B, H, hd]."""
    k, v, end = _shared_span(q, k_pages, v_pages, row_group, shared_bt,
                             shared_lens, lengths)
    parts = [_partials(q, k, v, end if z == n_split - 1 else
                       torch.clamp(end, max=(z + 1) * split_keys),
                       z * split_keys) for z in range(n_split)]
    return tuple(torch.stack(x) for x in zip(*parts))


def tree_merge_splits_ref(m: torch.Tensor, l: torch.Tensor,
                          acc: torch.Tensor):
    """Folds split partials (m, l [n_split, B, H], acc [n_split, B, H,
    hd]) into one set of raw partials [B, H], [B, H], [B, H, hd], the
    ``tree_shared_partials_ref`` form: m the largest split max, l and acc
    each split's rescaled to it and summed over splits. Splits without a
    key (NEG_INF, 0, 0) add nothing."""
    m_all = m.amax(0)
    w = torch.exp(m - m_all)
    return m_all, (l * w).sum(0), (acc * w[..., None]).sum(0)


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


# ------------------------------------------------- the bf16 decode core


@functools.lru_cache(maxsize=256)
def decode_splits(page_size: int, width: int,
                  dtype: torch.dtype) -> Tuple[int, int]:
    """``(split_keys, n_split)``: how the bf16 decode core (K1 and K3's
    branch pass, ``csrc/paged_decode_mma.cuh``) cuts tables of ``width``
    pages of ``page_size`` tokens over the CTAs of a cluster, from these
    shapes only (never from a step's lengths). A table of up to 1,024 keys
    is one split (its keys rounded up to 128, one 32-key tile per warp);
    a longer one is cut into splits of 1,024 keys (8 tiles per warp),
    doubled until at most 8 cover it. The serve's 32 pages of 16 tokens
    are one split of 512 keys: at its 16 rows a split over CTAs costs more
    than it saves (``scripts/decode_core_sweep.py``). fp32 (the CUDA-core
    loop) takes the whole table as one split."""
    cap = page_size * width
    if dtype != torch.bfloat16:
        return max(cap, 1), 1
    if cap <= DECODE_MIN_SPLIT_KEYS:
        step = DECODE_TILE_KEYS * DECODE_WARPS
        return max(step, -(-cap // step) * step), 1
    keys = DECODE_MIN_SPLIT_KEYS
    while -(-cap // keys) > DECODE_MAX_SPLITS:
        keys *= 2
    return keys, -(-cap // keys)


def decode_split_keys(end: torch.Tensor, split_keys: int, n_split: int,
                      s_max: int) -> torch.Tensor:
    """Which keys each (CTA, warp) of the decode core walks: bool [n_split,
    DECODE_WARPS, B, s_max]. CTA z holds keys [z * split_keys, (z + 1) *
    split_keys) of a row, cut into 32-key tiles; warp w walks tiles w, w +
    4, ... of them; only keys < end[b] count."""
    key = torch.arange(s_max, device=end.device)
    tile = (key % split_keys) // DECODE_TILE_KEYS
    z = torch.arange(n_split, device=end.device)[:, None, None, None]
    w = torch.arange(DECODE_WARPS, device=end.device)[None, :, None, None]
    return ((key // split_keys == z) & (tile % DECODE_WARPS == w)
            & (key < end[:, None]))


def decode_split_partials_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, tables: torch.Tensor,
                              end: torch.Tensor, split_keys: int,
                              n_split: int):
    """Plain version of the decode core's per-warp partials: q [B, H, hd]
    over the first ``end[b]`` keys of ``tables`` [B, W], raw fp32 (m, l,
    acc) of each (CTA z, warp w) as [n_split, WARPS, B, H] twice and
    [n_split, WARPS, B, H, hd]; (NEG_INF, 0, 0) where a warp holds no
    key."""
    k = gather_pages(k_pages, tables).float()
    v = gather_pages(v_pages, tables).float()
    owned = decode_split_keys(end.long(), split_keys, n_split, k.shape[2])
    parts = [_masked_partials(q, k, v, owned[z, w]) for z in range(n_split)
             for w in range(DECODE_WARPS)]
    return tuple(torch.stack(x).unflatten(0, (n_split, DECODE_WARPS))
                 for x in zip(*parts))


def decode_merge_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     shared: Optional[tuple] = None) -> torch.Tensor:
    """The decode core's merge, fp32 [B, H, hd]: each CTA's warps
    (per-warp partials [n_split, WARPS, ...] as
    ``decode_split_partials_ref`` gives them) folded into the CTA's
    partials, then one list — the shared splits ``shared = (m, l, acc)``
    [n, B, H(, hd)] first where given (K3's branch pass), then the CTAs
    in split order — folded by ``tree_merge_splits_ref`` (one max, then
    every partial rescaled to it and summed) and divided by max(l,
    1e-30). A list without a key gives zeros."""
    ctas = [tree_merge_splits_ref(m[z], l[z], acc[z])
            for z in range(m.shape[0])]
    parts = ([tuple(x[i] for x in shared) for i in range(shared[0].shape[0])]
             if shared is not None else []) + ctas
    _, l_all, acc_all = tree_merge_splits_ref(
        *(torch.stack(x) for x in zip(*parts)))
    return acc_all / l_all.clamp_min(1e-30)[..., None]


def paged_attention_decode_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     lengths: torch.Tensor, split_keys: int,
                                     n_split: int) -> torch.Tensor:
    """K1 as the bf16 decode core computes it: per-warp partials of each
    key split, merged in the fixed order. The same function as
    ``paged_attention_decode_ref``; [B, H, hd] in q's dtype."""
    cap = block_tables.shape[1] * k_pages.shape[2]
    end = lengths.long().clamp(0, cap)
    out = decode_merge_ref(*decode_split_partials_ref(
        q, k_pages, v_pages, block_tables, end, split_keys, n_split))
    return out.to(q.dtype)


def tree_branch_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, row_group: torch.Tensor,
                          shared_lens: torch.Tensor, branch_bt: torch.Tensor,
                          lengths: torch.Tensor, m_shared: torch.Tensor,
                          l_shared: torch.Tensor, acc_shared: torch.Tensor,
                          split_keys: int, n_split: int) -> torch.Tensor:
    """K3's branch pass as the bf16 decode core computes it: the suffix
    (``max(length - span, 0)`` keys of ``branch_bt``) in key splits and
    warps, merged behind the shared pass's split partials (m, l [n, B, H],
    acc [n, B, H, hd], read only for rows in a group) in the fixed order.
    The same function as ``tree_branch_merge_ref`` over the folded
    splits; [B, H, hd] in q's dtype."""
    num_groups = shared_lens.shape[0]
    cap = branch_bt.shape[1] * k_pages.shape[2]
    rg = row_group.long()
    grouped = (rg >= 0) & (rg < num_groups)
    grp = rg.clamp(0, num_groups - 1)
    span = torch.where(grouped, shared_lens.long()[grp].clamp(0, cap), 0)
    end = (lengths.long().clamp(0, cap) - span).clamp_min(0)
    g2 = grouped[:, None]
    shared = (torch.where(g2, m_shared, NEG_INF),
              torch.where(g2, l_shared, 0.0),
              torch.where(g2[..., None], acc_shared, 0.0))
    out = decode_merge_ref(*decode_split_partials_ref(
        q, k_pages, v_pages, branch_bt, end, split_keys, n_split), shared)
    return out.to(q.dtype)
