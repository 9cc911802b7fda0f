"""Launch geometry of the port's CUDA kernels, as data.

Counterpart of ``repro.kernels.introspect``. The reference describes each
Pallas launch as a ``KernelGrid`` of ``BlockMapping``s and builds its
``BlockSpec``s from that description, so the geometry its checker proves is
the geometry it launches. Here the launch is C++: each launcher in
``csrc/`` computes its own grid. So each wrapper has a grid function
beside it (``paged_attention_grid``, ``paged_prefill_grid``,
``paged_tree_shared_grid``, ``paged_tree_branch_grid``, ``ssd_scan_grid``,
``flash_prefill_grid``; for the training kernels ``flash_prefill_bwd_grid``
and ``ssd_scan_bwd_grid``, whose launches carry no operand access yet)
that returns the ``LaunchGrid`` of every launch it
makes, from the shapes alone, and the wrapper passes those grids to its
launcher (``Launches.dims``: n_launches x 3 ints). The launcher compares
them with the grids it would launch, before it launches anything, and
refuses a mismatch (``csrc/launch_check.cuh``): one source of truth for the
grids. ``python -m repro_torch.stepcheck`` (STEP007) then evaluates every
operand's access at every CTA of every launch over a lattice of
sentinel-laden tables and proves each one in bounds.

A ``LaunchGrid`` holds the kernel's name, its route (``"bf16"``: the
tensor-core kernel; ``"fp32"``: the CUDA-core one), the CUDA grid ``(x, y,
z)`` and, per operand, an ``OperandAccess``: the operand's array shape and
a function from ``(cta, *scalars)`` — the CTA's ``(blockIdx.x, .y, .z)``
and the launch's integer operands as numpy (block tables, lengths, the
tree map, ...) — to the boxes of elements that CTA may address, each box a
half-open ``[lo, hi)`` range per dim. The ranges are those after the
kernel's own clamps: a table entry clamped into ``[0, num_pages - 1]``
(``clamp_page``, ``paged_decode_mma.cuh``; ``stream_pages``,
``paged_common.cuh``), lengths clamped to ``pages_per_seq * page_size``
(``clamp_to``), key loops stopped at a row's horizon, the padded tails of
the last q or key tile. A paged K/V access is one box per page it reads.

Unlike Pallas, nothing builds the launch *from* the access functions:
they model the address arithmetic of the ``.cu`` code. Two checks tie
them to it: a CPU test that poisons every element no CTA's range covers
and finds the plain version's output unchanged
(``tests/test_torch_introspect.py``), and ``chip_smoke.py``'s phase 16,
which runs every STEP007 case on the card between NaN guard regions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from typing import Callable, Iterable, Iterator, List, Sequence, Tuple

Range = Tuple[int, int]
Box = Tuple[Range, ...]
Access = Callable[..., Iterable[Box]]

# The C++ constants the launchers' grids and the kernels' addresses use.
#: threads of a paged-attention CTA (kThreads, csrc/paged_common.cuh:37)
THREADS = 128
#: query rows a CUDA-core paged CTA owns (kMaxRows, paged_common.cuh:39):
#: K2's fp32 chunk rows per CTA are MAX_ROWS // group
#: (paged_prefill.cu:395), K3's fp32 shared pass's member rows per CTA
#: ``per_cta = kMaxRows / group`` (paged_tree_decode.cu:457)
MAX_ROWS = 32
#: warps of a bf16 paged CTA (kWarps, paged_decode_mma.cuh:306 and
#: paged_prefill.cu:66)
WARPS = THREADS // 32
#: query heads one decode-core CTA holds (decode::kRows,
#: paged_decode_mma.cuh:307)
ROWS = 16
#: rows of one m16n8k16 m-tile of K2's bf16 kernel (kTileRows,
#: paged_prefill.cu:67); its block_q is WARPS * (16 // min(group, 16))
#: chunk rows (paged_prefill.cu:278)
TILE_ROWS = 16
#: keys of one shared-memory tile of the mma kernels (tile::kKeys,
#: paged_decode_mma.cuh:80)
TILE_KEYS = 32
#: member rows of one CTA of K3's bf16 shared pass (split::kRows,
#: paged_tree_decode.cu:157): per_cta = SPLIT_ROWS // group (:189)
SPLIT_ROWS = 64
#: columns of P one K4 CTA owns (kSlice, ssd_scan.cu:72)
SLICE = 16
#: keys of one K/V tile of K5 (kKeys, flash_prefill_sm90.cu:68 and
#: flash_prefill.cu:49)
K5_KEYS = 64


@dataclasses.dataclass(frozen=True)
class OperandAccess:
    """One operand of a launch: its array shape and ``ranges(cta,
    *scalars)``, the boxes of elements the CTA may address (one half-open
    ``(lo, hi)`` per dim each). The counterpart of ``BlockMapping``."""

    name: str
    array_shape: Tuple[int, ...]
    ranges: Access


@dataclasses.dataclass(frozen=True)
class LaunchGrid:
    """One launch as data: kernel name, route (``"bf16"`` or ``"fp32"``),
    the CUDA grid ``(x, y, z)``, and every operand's access, inputs and
    outputs. ``num_scalars`` integer operands (as numpy) follow the CTA
    index in every access function. The counterpart of ``KernelGrid``."""

    kernel: str
    route: str
    grid: Tuple[int, int, int]
    operands: Tuple[OperandAccess, ...]
    num_scalars: int = 0
    #: the host ints of the launch besides the shapes (a split layout, a
    #: lane bucket, a chunk), as (name, value) pairs
    host: Tuple[Tuple[str, int], ...] = ()

    def ctas(self) -> Iterator[Tuple[int, int, int]]:
        """Every CTA index ``(x, y, z)`` of the grid."""
        return itertools.product(*(range(g) for g in self.grid))

    @property
    def num_ctas(self) -> int:
        x, y, z = self.grid
        return x * y * z


class Launches(tuple):
    """The ``LaunchGrid``s of one wrapper call, in launch order; ``dims``
    is what the wrapper passes its launcher (n x 3 ints), made once per
    cached grid."""

    @functools.cached_property
    def dims(self) -> ctypes.Array:
        flat = [int(d) for lg in self for d in lg.grid]
        return (ctypes.c_int * len(flat))(*flat)


#: the ctypes argument types of a launcher's grid pair (pointer, count)
GRID_ARGTYPES = [ctypes.c_void_p, ctypes.c_int]


def grid_args(launches: Launches) -> Tuple[ctypes.Array, int]:
    """The launcher's ``(grids, n_grids)`` arguments. ``grids`` is the
    ctypes array itself (a ``c_void_p`` argument takes it), not its
    address: the call then holds the array alive, whoever holds the
    ``Launches``."""
    return launches.dims, len(launches)


# ------------------------------------------------------------ helpers


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def clamp(x: int, lo: int, hi: int) -> int:
    return lo if x < lo else hi if x > hi else x


def clamp_page(page: int, num_pages: int) -> int:
    """A table entry clamped into the pool, as ``tile::clamp_page`` and
    ``stream_pages`` clamp it (a sentinel reads page num_pages - 1)."""
    return clamp(int(page), 0, num_pages - 1)


def entries(row: int, lo: int, hi: int) -> List[Box]:
    """The box of a table [rows, W]'s entries lo .. hi - 1 of ``row``."""
    return [((row, row + 1), (lo, hi))] if hi > lo else []


def key_pages(head: int, table: Sequence[int], lo: int, hi: int,
              page_size: int, num_pages: int, head_dim: int) -> List[Box]:
    """The boxes of a K/V pool [kv, P, ps, hd] that keys lo .. hi - 1 of
    one KV head read through one table row: one box per page, the entry
    clamped into the pool, the slots of the page the keys cover."""
    out: List[Box] = []
    if hi <= lo:
        return out
    for i in range(lo // page_size, cdiv(hi, page_size)):
        page = clamp_page(table[i], num_pages)
        a = max(lo, i * page_size) - i * page_size
        b = min(hi, (i + 1) * page_size) - i * page_size
        out.append(((head, head + 1), (page, page + 1), (a, b),
                    (0, head_dim)))
    return out


def stream_pages(head: int, table_row: int, table: Sequence[int],
                 ctx_end: int, width: int, page_size: int, num_pages: int,
                 head_dim: int) -> Tuple[List[Box], List[Box]]:
    """(table boxes, K/V boxes) of ``stream_pages`` (paged_common.cuh):
    the first min(ceil(ctx_end / ps), W) entries of the row, each page's
    keys below ctx_end."""
    n_pages = min(cdiv(max(ctx_end, 0), page_size), width)
    hi = min(max(ctx_end, 0), n_pages * page_size)
    return (entries(table_row, 0, n_pages),
            key_pages(head, table, 0, hi, page_size, num_pages, head_dim))


def rows_box(first: int, n: int, head0: int, heads: int,
             head_dim: int) -> List[Box]:
    """Rows first .. first + n - 1, heads head0 .. of a [R, H, hd] tensor."""
    if n <= 0 or heads <= 0:
        return []
    return [((first, first + n), (head0, head0 + heads), (0, head_dim))]


# ------------------------------------------- the bf16 decode core's model


def decode_core_grid(kernel: str, batch: int, q_heads: int, head_dim: int,
                     kv_heads: int, num_pages: int, page_size: int,
                     pages_per_seq: int, split_keys: int, n_split: int, *,
                     branch: bool = False, num_groups: int = 0,
                     shared_keys: int = 0, shared_n: int = 0) -> LaunchGrid:
    """The bf16 split-key decode core (``decode_mma_kernel``,
    ``csrc/paged_decode_mma.cuh``) as data: K1 (``branch=False``; scalars
    block tables [B, W] and lengths [B]) or K3's branch pass
    (``branch=True``; scalars row_group [B], shared_lens [G], branch
    tables [B, W] and lengths [B], and the shared pass's partials
    [shared_n, B, H, hd + 2] as an input). Grid (n_split, kv x 16-head
    slices, B) (``decode::grid_of``)."""
    group = q_heads // kv_heads
    slices = cdiv(group, ROWS)
    cap = pages_per_seq * page_size
    hd = head_dim

    def geometry(cta, *s):
        z, y, b = cta
        if branch:
            rg, sl, tables, lengths = s
        else:
            tables, lengths = s
        h, head0 = y // slices, (y % slices) * ROWS
        rows = min(ROWS, group - head0)
        first = h * group + head0
        ln = clamp(int(lengths[b]), 0, cap)
        end, used, g = ln, 0, -1
        if branch:
            g = int(rg[b])
            grouped = 0 <= g < num_groups
            span = clamp(int(sl[g]), 0, cap) if grouped else 0
            end = max(ln - span, 0)
            used = (min(shared_n, cdiv(min(ln, span), shared_keys))
                    if grouped else 0)
        n_used = max(1, min(n_split, cdiv(end, split_keys)))
        lo = z * split_keys
        hi = min(lo + split_keys, end)
        return (b, tables, first, rows, lo, hi, n_used, used, g, h)

    def reads_rows(cta, *s):
        z = cta[0]
        b, _, first, rows, _, _, n_used, _, _, _ = geometry(cta, *s)
        return (z == 0 or z < n_used), b, first, rows

    def q_ranges(cta, *s):
        live, b, first, rows = reads_rows(cta, *s)
        return rows_box(b, 1, first, rows, hd) if live else []

    def table_ranges(cta, *s):
        b, _, _, _, lo, hi, n_used, _, _, _ = geometry(cta, *s)
        # each lane's first-tile entry, read before the length
        e0 = min(lo // page_size, pages_per_seq - 1)
        e1 = min((lo + WARPS * TILE_KEYS - 1) // page_size,
                 pages_per_seq - 1)
        out = entries(b, e0, e1 + 1)
        if cta[0] < n_used:
            out += entries(b, lo // page_size, cdiv(hi, page_size))
        return out

    def kv_ranges(cta, *s):
        b, tables, first, rows, lo, hi, n_used, _, _, h = geometry(cta, *s)
        if cta[0] >= n_used:
            return []
        return key_pages(h, tables[b], lo, hi, page_size, num_pages, hd)

    def out_ranges(cta, *s):
        b, _, first, rows, *_ = geometry(cta, *s)
        return rows_box(b, 1, first, rows, hd) if cta[0] == 0 else []

    def row_b(cta, *s):
        return [((cta[2], cta[2] + 1),)]

    pool = (kv_heads, num_pages, page_size, hd)
    ops = [OperandAccess("q", (batch, q_heads, hd), q_ranges),
           OperandAccess("k_pages", pool, kv_ranges),
           OperandAccess("v_pages", pool, kv_ranges)]
    if branch:
        def group_ranges(cta, *s):
            g = geometry(cta, *s)[8]
            return [((g, g + 1),)] if 0 <= g < num_groups else []

        def part_ranges(cta, *s):
            b, _, first, rows, _, _, _, used, _, _ = geometry(cta, *s)
            if cta[0] != 0:
                return []
            return [((0, max(used, 1)), (b, b + 1), (first, first + rows),
                     (0, hd + 2))]
        ops += [OperandAccess("row_group", (batch,), row_b),
                OperandAccess("shared_lens", (num_groups,), group_ranges),
                OperandAccess("branch_bt", (batch, pages_per_seq),
                              table_ranges),
                OperandAccess("lengths", (batch,), row_b),
                OperandAccess("partials", (shared_n, batch, q_heads, hd + 2),
                              part_ranges)]
    else:
        ops += [OperandAccess("block_tables", (batch, pages_per_seq),
                              table_ranges),
                OperandAccess("lengths", (batch,), row_b)]
    ops.append(OperandAccess("out", (batch, q_heads, hd), out_ranges))
    host = (("split_keys", split_keys), ("n_split", n_split))
    if branch:
        host += (("shared_keys", shared_keys), ("shared_n", shared_n))
    return LaunchGrid(kernel, "bf16",
                      (n_split, kv_heads * slices, batch), tuple(ops),
                      4 if branch else 2, host)
