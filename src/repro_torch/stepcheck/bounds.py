"""STEP007: the launch-bounds proof of the port's CUDA launchers.

Counterpart of ``tools/stepcheck/bounds.py``. Each wrapper describes its
launches as ``LaunchGrid``s (``repro_torch.kernels.introspect``), and each
launcher refuses a grid that is not the one it would launch, so the grids
proved here are the grids the card runs. This module evaluates every
operand's access function at every CTA of the grid, with concrete numpy
tables and lengths, and checks each box it returns:

    0 <= lo <= hi <= array_shape[d]   in every dim d

over a lattice of the reference's cases (``engine_lattice``): ragged
lengths, page-straddling resumed chunks, sentinel-laden and all-sentinel
tables, kv heads 1, 2 and 4 under 4 query heads; on both routes (bf16
tensor cores, fp32 CUDA cores), at head_dim 32 and 128, K2 over several
lanes in one launch, and K1 and both K3 passes at tables long enough to
split over several CTAs (``SPLIT_GEOMETRY``). An unclamped sentinel chase fails here at
the CTA that would read past the pool (the self-test seeds one).
``verify_launch_grid`` is a reusable harness: tests hand it broken grids.
``coverage_masks`` gives, per operand, the elements some CTA may address
(the coverage test poisons the rest).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.introspect import Box, LaunchGrid
from .findings import Finding

#: the routes of every kernel, and the head widths the lattice runs at
ROUTES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 128)


@dataclasses.dataclass(frozen=True)
class ScalarCase:
    """One set of a launch's integer operands to sweep its grid under."""

    name: str
    args: Tuple[object, ...] = ()


def verify_launch_grid(lg: LaunchGrid,
                       cases: Sequence[ScalarCase] = (ScalarCase("-"),),
                       max_findings_per_operand: int = 3) -> List[Finding]:
    """Evaluate every operand access of ``lg`` at every CTA x case; one
    STEP007 finding per violating (operand, CTA, case), capped at
    ``max_findings_per_operand`` each (one out-of-bounds access is
    already a failed proof)."""
    findings: List[Finding] = []
    for op in lg.operands:
        reported = 0
        for case in cases:
            for cta in lg.ctas():
                if reported >= max_findings_per_operand:
                    break
                try:
                    boxes = list(op.ranges(cta, *case.args))
                except Exception as exc:   # evaluation itself is a failure
                    findings.append(Finding(
                        path=lg.kernel, line=0, rule="STEP007",
                        symbol=op.name,
                        message=(f"access of `{op.name}` raised at CTA "
                                 f"{cta} (case {case.name}, {lg.route}): "
                                 f"{exc!r}")))
                    reported += 1
                    continue
                for box in boxes:
                    problem = _containment_violation(box, op.array_shape)
                    if problem is not None:
                        findings.append(Finding(
                            path=lg.kernel, line=0, rule="STEP007",
                            symbol=op.name,
                            message=(f"`{op.name}` access out of bounds at "
                                     f"CTA {cta} (case {case.name}, "
                                     f"{lg.route}): {problem}")))
                        reported += 1
                        break
    return findings


def _containment_violation(box: Box, array: Tuple[int, ...]
                           ) -> Optional[str]:
    if len(box) != len(array):
        return f"rank mismatch: box {box}, array {array}"
    for d, ((lo, hi), size) in enumerate(zip(box, array)):
        if not 0 <= lo <= hi <= size:
            return (f"dim {d}: elements [{lo}, {hi}) of an axis of "
                    f"size {size}")
    return None


def coverage_masks(lg: LaunchGrid, args: Sequence[object]
                   ) -> Dict[str, np.ndarray]:
    """Per operand, a bool mask of its array: the elements that some CTA
    of ``lg`` may address under the integer operands ``args``."""
    masks: Dict[str, np.ndarray] = {}
    for op in lg.operands:
        mask = masks.setdefault(op.name, np.zeros(op.array_shape, bool))
        for cta in lg.ctas():
            for box in op.ranges(cta, *args):
                mask[tuple(slice(lo, hi) for lo, hi in box)] = True
    return masks


# --------------------------------------------------------------- lattice
def _bt(pages: Sequence[int], width: int, sentinel: int) -> np.ndarray:
    row = np.full((width,), sentinel, np.int32)
    row[:len(pages)] = np.asarray(pages, np.int32)
    return row


def prefill_lanes(num_pages: int, page_size: int, pages_per_seq: int
                  ) -> Dict[str, Tuple[np.ndarray, int, int]]:
    """The reference's five K2 lanes (``paged_prefill_cases``) as (table,
    pos0, valid_len) at a bucket of up to 8 rows: a cold full chunk, a
    page-straddling resumed chunk, a one-token ragged tail, a chunk near
    the table's capacity, and an all-sentinel table."""
    live = _bt(range(pages_per_seq), pages_per_seq, num_pages)
    return {
        "cold-full": (live, 0, 8),
        "straddle": (_bt([3, 1, 4], pages_per_seq, num_pages),
                     page_size + 1, min(8, page_size)),
        "ragged-1": (_bt([7], pages_per_seq, num_pages), 0, 1),
        "deep": (live, (pages_per_seq - 2) * page_size, 8),
        "all-sentinel": (_bt([], pages_per_seq, num_pages), 0, 1),
    }


def lanes_args(lanes: Sequence[Tuple[np.ndarray, int, int]], t: int):
    """K2's integer operands for lanes (table, pos0, valid_len) of a
    bucket of ``t`` rows, as the engine lays them out: every row its
    lane's table and its own position, then each lane's valid length."""
    tables = np.concatenate([np.repeat(tb[None], t, 0) for tb, _, _ in lanes])
    positions = np.concatenate([p0 + np.arange(t, dtype=np.int32)
                                for _, p0, _ in lanes]).astype(np.int32)
    lens = np.asarray([min(vl, t) for _, _, vl in lanes], np.int32)
    return tables.astype(np.int32), positions, lens


def paged_prefill_cases(num_pages: int, page_size: int, pages_per_seq: int,
                        t: int) -> List[ScalarCase]:
    """One lane per case: the reference's five."""
    return [ScalarCase(name, lanes_args([lane], t)) for name, lane in
            prefill_lanes(num_pages, page_size, pages_per_seq).items()]


def paged_prefill_lanes_case(num_pages: int, page_size: int,
                             pages_per_seq: int, t: int) -> ScalarCase:
    """All five lanes in one launch (the engine's multi-lane step)."""
    return ScalarCase("lanes", lanes_args(
        list(prefill_lanes(num_pages, page_size, pages_per_seq).values()),
        t))


def paged_attention_cases(num_pages: int, page_size: int,
                          pages_per_seq: int,
                          batch: int) -> List[ScalarCase]:
    """(block_tables, lengths): a full row, a short sentinel-padded one
    and an empty slot (length 0, all sentinels)."""
    tables = np.stack([
        _bt(range(pages_per_seq), pages_per_seq, num_pages),
        _bt([5, 2], pages_per_seq, num_pages),
        _bt([], pages_per_seq, num_pages),
    ][:batch])
    lengths = np.asarray(
        [pages_per_seq * page_size, page_size + 3, 0][:batch], np.int32)
    return [ScalarCase("ragged", (tables, lengths))]


def tree_shared_cases(num_pages: int, page_size: int, pages_per_seq: int,
                      num_groups: int) -> List[ScalarCase]:
    """(row_group, shared_bt, shared_lens, lengths) for the shared pass:
    groups of ragged shared depths (3 pages, 1 page, unused), rows seeing
    all, part and none of their group's span; then every table
    all-sentinel with zero spans (no fork group this step: every CTA
    parks on entry 0 and clamps the sentinel)."""
    g = num_groups
    live = np.stack([
        _bt(range(3), pages_per_seq, num_pages),
        _bt([9], pages_per_seq, num_pages),
        _bt([], pages_per_seq, num_pages),
    ][:g])
    spans = np.asarray([3 * page_size, page_size, 0][:g], np.int32)
    rg = np.asarray([0, 1, 0], np.int32)
    lengths = np.asarray([3 * page_size + 2, page_size + 1, 2 * page_size],
                         np.int32)
    empty = np.stack([_bt([], pages_per_seq, num_pages)] * g)
    return [
        ScalarCase("ragged-depths", (rg, live, spans, lengths)),
        ScalarCase("all-sentinel", (np.asarray([0, g, g], np.int32), empty,
                                    np.zeros((g,), np.int32),
                                    np.asarray([1, 1, 0], np.int32))),
    ]


def tree_branch_cases(num_pages: int, page_size: int, pages_per_seq: int,
                      num_groups: int) -> List[ScalarCase]:
    """(row_group, shared_lens, branch_bt, lengths) for the branch pass:
    the reference's ragged suffixes — a full table (a row in no group),
    a short suffix past a 2-page shared span, and a row the shared pass
    covers whole (suffix 0, all-sentinel table)."""
    span = 2 * page_size
    tables = np.stack([
        _bt(range(pages_per_seq), pages_per_seq, num_pages),
        _bt([11, 6], pages_per_seq, num_pages),
        _bt([], pages_per_seq, num_pages),
    ])
    rg = np.asarray([num_groups, 0, 0], np.int32)
    spans = np.asarray([span, page_size, 0][:num_groups], np.int32)
    lengths = np.asarray([pages_per_seq * page_size, span + page_size + 2,
                          span], np.int32)
    return [ScalarCase("ragged", (rg, spans, tables, lengths))]


#: (num_pages, page_size, pages_per_seq) of the split geometry: tables of
#: 72 pages of 16 tokens (1,152 keys) over a pool of 80 pages. There the
#: bf16 decode core (K1, K3's branch pass) cuts a table into 2 key splits
#: of 1,024 (``decode_splits``) and the bf16 shared pass into 9 of 128
#: (``shared_splits``); the lattice's first geometry (6 pages of 4) is one
#: split of each, so only this one reaches the CTAs with z > 0.
SPLIT_GEOMETRY = (80, 16, 72)


def paged_attention_split_cases(num_pages: int, page_size: int,
                                pages_per_seq: int) -> List[ScalarCase]:
    """K1 over several key splits (batch 4): a full table, a row ending
    inside the last split in front of sentinel entries, a row ending in
    split 0 (the later CTAs read their first tile's entries and stop at
    the ``n_used`` cutoff), and an empty all-sentinel slot."""
    w = pages_per_seq
    long_row = w - 3
    tables = np.stack([
        _bt(range(w), w, num_pages),
        _bt([(7 * i + 3) % num_pages for i in range(long_row)], w,
            num_pages),
        _bt([5, 2, 9, 11, 40, 41, 66], w, num_pages),
        _bt([], w, num_pages),
    ])
    lengths = np.asarray([w * page_size, long_row * page_size - 5,
                          6 * page_size + 4, 0], np.int32)
    return [ScalarCase("split-ragged", (tables, lengths))]


def tree_shared_split_cases(num_pages: int, page_size: int,
                            pages_per_seq: int, num_groups: int
                            ) -> List[ScalarCase]:
    """The shared pass over several key splits (batch 4): group 0's span
    ends inside the last split (which reads from its start to the span),
    group 1's inside split 0, group 2 is unused; rows see all of group
    0's span, part of group 1's (ending in split 0), part of group 0's
    (ending in split 2), and a row in no group. Then every table
    all-sentinel with zero spans, every split parked on entry 0."""
    g, w = num_groups, pages_per_seq
    live = np.stack([
        _bt(range(w - 2), w, num_pages),
        _bt([71, 75, 78], w, num_pages),
        _bt([], w, num_pages),
    ][:g])
    spans = np.asarray([(w - 2) * page_size, 3 * page_size, 0][:g],
                       np.int32)
    rg = np.asarray([0, 1, 0, g], np.int32)
    lengths = np.asarray([(w - 2) * page_size + 10, 3 * page_size - 8,
                          300, 5], np.int32)
    empty = np.stack([_bt([], w, num_pages)] * g)
    return [
        ScalarCase("split-depths", (rg, live, spans, lengths)),
        ScalarCase("split-all-sentinel", (
            np.asarray([0, g, g, 0], np.int32), empty,
            np.zeros((g,), np.int32), np.asarray([1, 1, 0, 0], np.int32))),
    ]


def tree_branch_split_cases(num_pages: int, page_size: int,
                            pages_per_seq: int, num_groups: int
                            ) -> List[ScalarCase]:
    """The branch pass over several key splits of its own and of the
    shared pass's (batch 4): a row in no group over a full table (both
    own splits), a suffix ending in own split 0 behind a 5-split shared
    span, a suffix reaching own split 1 behind a 1-split span, and a row
    the shared span covers whole (suffix 0, all-sentinel table)."""
    w, ps = pages_per_seq, page_size
    span0, span1 = 40 * ps, 3 * ps
    tables = np.stack([
        _bt(range(w), w, num_pages),
        _bt([(3 * i + 1) % num_pages for i in range(13)], w, num_pages),
        _bt([(5 * i + 2) % num_pages for i in range(w - 5)], w, num_pages),
        _bt([], w, num_pages),
    ])
    rg = np.asarray([num_groups, 0, 1, 0], np.int32)
    spans = np.asarray([span0, span1, 0][:num_groups], np.int32)
    lengths = np.asarray([w * ps, span0 + 200, span1 + (w - 5) * ps - 12,
                          span0], np.int32)
    return [ScalarCase("split-ragged", (rg, spans, tables, lengths))]


def flash_prefill_cases(s: int) -> List[ScalarCase]:
    """(true_len, causal): the reference's one case ``-`` (causal over
    the whole length), then a true_len short of S and non-causal."""
    return [ScalarCase("-", (s, 1)), ScalarCase("true-len", (s - 3, 1)),
            ScalarCase("non-causal", (s, 0))]


def engine_lattice(head_dims: Sequence[int] = HEAD_DIMS,
                   routes: Sequence[torch.dtype] = ROUTES
                   ) -> List[Tuple[LaunchGrid, List[ScalarCase]]]:
    """The (LaunchGrid, cases) pairs ``python -m repro_torch.stepcheck``
    proves in bounds: every launch of the six TPU kernels' wrappers over
    kv heads 1, 2 and 4 under 4 query heads, both routes and both head
    widths; K1, K3s and K3b also at ``SPLIT_GEOMETRY``, where the bf16
    routes split a table over several CTAs; K2 at a bucket of 8 per lane
    case and with all five lanes in one launch; K5 at S 12 (a partial q
    block) and 16; K4 at the
    reference's (2, 16, 2, 8, 4, 8) with an initial state and chunk
    states, and at P 24 (a partial 16-column slice)."""
    from ..kernels.flash_prefill.flash_prefill import flash_prefill_grid
    from ..kernels.flash_prefill.paged_prefill import paged_prefill_grid
    from ..kernels.paged_attention.paged_attention import \
        paged_attention_grid
    from ..kernels.paged_attention.tree_decode import (
        paged_tree_branch_grid, paged_tree_shared_grid)
    from ..kernels.ssd_scan.ssd_scan import ssd_scan_grid

    out: List[Tuple[LaunchGrid, List[ScalarCase]]] = []
    num_pages, page_size, pps, t, groups = 16, 4, 6, 8, 3
    for dtype in routes:
        for hd in head_dims:
            for kv in (1, 2, 4):          # MQA / GQA / MHA over 4 q heads
                (lg,) = paged_prefill_grid(t, 4, hd, kv, num_pages,
                                           page_size, pps, dtype)
                out.append((lg, paged_prefill_cases(num_pages, page_size,
                                                    pps, t)))
                (lg,) = paged_prefill_grid(t, 4, hd, kv, num_pages,
                                           page_size, pps, dtype, 5)
                out.append((lg, [paged_prefill_lanes_case(
                    num_pages, page_size, pps, t)]))
                (lg,) = paged_attention_grid(3, 4, hd, kv, num_pages,
                                             page_size, pps, dtype)
                out.append((lg, paged_attention_cases(num_pages, page_size,
                                                      pps, 3)))
                (lg,) = paged_tree_shared_grid(3, 4, hd, kv, num_pages,
                                               page_size, groups, pps, dtype)
                out.append((lg, tree_shared_cases(num_pages, page_size, pps,
                                                  groups)))
                (lg,) = paged_tree_branch_grid(3, 4, hd, kv, num_pages,
                                               page_size, pps, dtype, groups)
                out.append((lg, tree_branch_cases(num_pages, page_size, pps,
                                                  groups)))
                for s in (12, 16):
                    (lg,) = flash_prefill_grid(2, s, 4, hd, kv, dtype)
                    out.append((lg, flash_prefill_cases(s)))
                # the split geometry: K1, K3s and K3b past CTA z = 0
                (lg,) = paged_attention_grid(4, 4, hd, kv, *SPLIT_GEOMETRY,
                                             dtype)
                out.append((lg, paged_attention_split_cases(
                    *SPLIT_GEOMETRY)))
                sp, sps, spps = SPLIT_GEOMETRY
                (lg,) = paged_tree_shared_grid(4, 4, hd, kv, sp, sps, groups,
                                               spps, dtype)
                out.append((lg, tree_shared_split_cases(
                    *SPLIT_GEOMETRY, groups)))
                (lg,) = paged_tree_branch_grid(4, 4, hd, kv, sp, sps, spps,
                                               dtype, groups)
                out.append((lg, tree_branch_split_cases(
                    *SPLIT_GEOMETRY, groups)))
        (lg,) = ssd_scan_grid(2, 16, 2, 8, 4, 8, dtype, True, True)
        out.append((lg, [ScalarCase("-")]))
        (lg,) = ssd_scan_grid(2, 12, 2, 24, 4, 8, dtype, True, True)
        out.append((lg, [ScalarCase("partial-slice")]))
    return out


def kv_regime(lg: LaunchGrid) -> Optional[int]:
    """The KV-head count of an attention launch (None for K4)."""
    for op in lg.operands:
        if op.name == "k_pages":
            return op.array_shape[0]
        if op.name == "k":
            return op.array_shape[2]
    return None


def run_bounds_lattice() -> List[Finding]:
    """STEP007 over the full engine lattice."""
    findings: List[Finding] = []
    for lg, cases in engine_lattice():
        findings.extend(verify_launch_grid(lg, cases))
    return findings
