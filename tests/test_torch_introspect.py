"""The port's launch geometry as data (``repro_torch.kernels.introspect``)
and STEP007 over it (``repro_torch.stepcheck.bounds``), on the CPU.

Held against the reference's STEP007 (``tools/stepcheck/bounds.py``,
``tests/test_stepcheck.py``): the port's lattice covers every (kernel,
KV-head regime, case) of the reference's ``engine_lattice()``, plus both
routes, two head widths and K2 over several lanes; the shipped grids
prove in bounds; the reference's seeded violations (an unclamped K1 page,
an unclamped K2 sentinel chase, an overrun of the last tile) are caught
on the same cases, and findings are capped per operand. The coverage
test poisons every element of the inputs that no CTA's range covers (NaN
for floats, an out-of-pool entry for ints) and finds the plain version's
output finite and bit-equal to the clean run's: the ranges are not
narrower than what the function needs. Each wrapper passes its grid
function's grids to its launcher: checked here with the launcher
replaced, against the argument list of the ``extern "C"`` signature in
``csrc/``. The launchers' refusal of a wrong grid runs on the card
(``chip_smoke.py`` phase 16).
"""
import ctypes
import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import introspect as ix
from repro_torch.kernels.flash_prefill import flash_prefill, paged_prefill
from repro_torch.kernels.paged_attention import paged_attention, tree_decode
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.stepcheck import bounds, calls
from repro_torch.stepcheck.bounds import verify_launch_grid

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:          # tools/ lives at the repo root
    sys.path.insert(0, str(REPO))

CSRC = REPO / "src" / "repro_torch" / "csrc"
NUM_PAGES, PAGE_SIZE, PPS = 16, 4, 6


def _unclamp(lg, names, ranges):
    """Replace the access of the named operands: seed a violation."""
    return dataclasses.replace(lg, operands=tuple(
        dataclasses.replace(op, ranges=ranges) if op.name in names else op
        for op in lg.operands))


# ------------------------------------------------- the lattice's coverage


def _reference_triples():
    from tools.stepcheck.bounds import engine_lattice
    out = set()
    for kg, cases in engine_lattice():
        if kg.kernel == "ssd_scan":
            kv = None
        elif kg.kernel == "flash_prefill":
            kv = kg.in_mappings[1].array_shape[2]
        else:
            kv = next(m for m in kg.in_mappings
                      if m.name == "k_pages").array_shape[0]
        out |= {(kg.kernel, kv, c.name) for c in cases}
    return out


def test_lattice_covers_the_reference_lattice():
    """Every (kernel, KV-head regime, case name) of the reference's STEP007
    lattice is in the port's, on both routes and at head_dim 32 and 128;
    K2 also runs with all five lanes in one launch."""
    pairs = bounds.engine_lattice()
    want = _reference_triples()
    for route in ("bf16", "fp32"):
        for hd in (32, 128):
            have = {(lg.kernel, bounds.kv_regime(lg), c.name)
                    for lg, cases in pairs for c in cases
                    if lg.route == route and (
                        lg.kernel == "ssd_scan" or
                        lg.operands[0].array_shape[-1] == hd)}
            assert want <= have, (route, hd, sorted(want - have))
    lanes = [lg for lg, cases in pairs if lg.kernel == "paged_flash_prefill"
             and lg.grid[2] > 1]
    assert {lg.route for lg in lanes} == {"bf16", "fp32"}
    assert sorted({lg.kernel for lg, _ in pairs}) == [
        "flash_prefill", "paged_attention", "paged_flash_prefill",
        "paged_tree_branch", "paged_tree_shared", "ssd_scan"]


def test_shipped_grids_prove_in_bounds():
    assert bounds.run_bounds_lattice() == []


def test_lattice_grids_are_pinned():
    """The grids the lattice sweeps, pinned to the launchers' formulas
    (``csrc/``) so a refactor cannot silently collapse a grid axis."""
    bf, f32 = torch.bfloat16, torch.float32
    g = lambda launches: launches[0].grid          # noqa: E731
    # K1: bf16 (n_split, kv x 16-head slices, B); fp32 (B, kv, 1)
    assert g(paged_attention.paged_attention_grid(
        3, 4, 32, 2, 16, 4, 6, bf)) == (1, 2, 3)
    assert g(paged_attention.paged_attention_grid(
        3, 40, 128, 8, 4097, 16, 128, bf)) == (2, 8, 3)   # 2,048 keys
    assert g(paged_attention.paged_attention_grid(
        3, 64, 32, 2, 16, 4, 6, bf)) == (1, 4, 3)         # group 32
    assert g(paged_attention.paged_attention_grid(
        3, 4, 32, 2, 16, 4, 6, f32)) == (3, 2, 1)
    # K2: bf16 block_q 4 * (16 // group), slices; fp32 block_q 32 // group
    assert g(paged_prefill.paged_prefill_grid(
        8, 4, 32, 2, 16, 4, 6, bf, 5)) == (1, 2, 5)
    assert g(paged_prefill.paged_prefill_grid(
        64, 40, 128, 8, 16, 4, 6, bf)) == (6, 8, 1)       # block_q 12
    assert g(paged_prefill.paged_prefill_grid(
        64, 40, 128, 8, 16, 4, 6, f32)) == (11, 8, 1)     # block_q 6
    # K3: the shared pass's splits from the table's shape
    assert g(tree_decode.paged_tree_shared_grid(
        16, 40, 128, 8, 4097, 16, 16, 32, bf)) == (16, 8, 16)
    assert g(tree_decode.paged_tree_shared_grid(
        16, 40, 128, 8, 4097, 16, 16, 32, f32)) == (8, 16, 3)
    assert g(tree_decode.paged_tree_branch_grid(
        3, 4, 32, 2, 16, 4, 6, f32)) == (3, 2, 1)
    # K4: (ceil(P / 16), H, B); K5: (ceil(S / block_q), Hkv, B)
    assert g(ssd_scan.ssd_scan_grid(2, 16, 2, 24, 4, 8)) == (2, 2, 2)
    assert g(flash_prefill.flash_prefill_grid(
        2, 1000, 40, 128, 8, bf)) == (40, 8, 2)           # 128 rows: 25
    assert g(flash_prefill.flash_prefill_grid(
        2, 12, 4, 32, 2, f32)) == (1, 2, 2)
    # the split geometry: K1 and K3b 2 splits of 1,024 keys, K3s 9 of 128
    sp = bounds.SPLIT_GEOMETRY
    assert g(paged_attention.paged_attention_grid(
        4, 4, 32, 2, *sp, bf)) == (2, 2, 4)
    assert g(tree_decode.paged_tree_shared_grid(
        4, 4, 32, 2, sp[0], sp[1], 3, sp[2], bf)) == (9, 2, 3)
    (lg,) = tree_decode.paged_tree_branch_grid(4, 4, 32, 2, *sp, bf, 3)
    assert lg.grid == (2, 2, 4) and dict(lg.host) == {
        "split_keys": 1024, "n_split": 2, "shared_keys": 128, "shared_n": 9}
    launches = paged_prefill.paged_prefill_grid(8, 4, 32, 2, 16, 4, 6, bf, 5)
    assert list(launches.dims) == [1, 2, 5]
    for lg, cases in bounds.engine_lattice():
        assert lg.num_ctas > 0 and cases


@pytest.mark.parametrize("kernel", ["paged_attention", "paged_tree_shared",
                                    "paged_tree_branch"])
def test_split_lattice_reaches_later_ctas(kernel):
    """At ``SPLIT_GEOMETRY`` the bf16 lattice evaluates CTAs with z > 0:
    some read keys (the shared pass's last split among them, from its
    start to the span), and for the decode core some read only their
    first tile's table entries and stop at the ``n_used`` cutoff."""
    pairs = [(lg, cases) for lg, cases in bounds.engine_lattice(
        head_dims=(32,), routes=(torch.bfloat16,))
        if lg.kernel == kernel and lg.grid[0] > 1]
    assert len(pairs) == 3                      # kv heads 1, 2, 4
    reading, cut_off, last = 0, 0, 0
    for lg, cases in pairs:
        ops = {op.name: op for op in lg.operands}
        table = ops["shared_bt" if kernel == "paged_tree_shared" else
                    "block_tables" if kernel == "paged_attention" else
                    "branch_bt"]
        for case in cases:
            for cta in lg.ctas():
                if cta[0] == 0:
                    continue
                kv = list(ops["k_pages"].ranges(cta, *case.args))
                reading += bool(kv)
                last += bool(kv) and cta[0] == lg.grid[0] - 1
                cut_off += (not kv and
                            bool(list(table.ranges(cta, *case.args))))
    assert reading and last
    if kernel != "paged_tree_shared":
        assert cut_off


# ------------------------------------------------ seeded violations


@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_unclamped_decode_kv_access_is_caught(route):
    """Without the sentinel clamp, K1's ragged case (an empty slot's
    all-sentinel table) reads page ``num_pages``: STEP007 findings on the
    K/V operands, and the shipped access stays silent."""
    dtype = torch.bfloat16 if route == "bf16" else torch.float32
    (lg,) = paged_attention.paged_attention_grid(3, 4, 32, 2, NUM_PAGES,
                                                 PAGE_SIZE, 5, dtype)
    cases = bounds.paged_attention_cases(NUM_PAGES, PAGE_SIZE, 5, 3)
    assert verify_launch_grid(lg, cases) == []

    def unclamped(cta, bt, ln):
        b, h = (cta[0], cta[1]) if route == "fp32" else (cta[2], cta[1])
        return [((h, h + 1), (int(bt[b, i]), int(bt[b, i]) + 1),
                 (0, PAGE_SIZE), (0, 32)) for i in range(5)]
    caught = verify_launch_grid(
        _unclamp(lg, ("k_pages", "v_pages"), unclamped), cases)
    assert {f.rule for f in caught} == {"STEP007"}
    assert {f.symbol for f in caught} == {"k_pages", "v_pages"}
    assert all(f.path == "paged_attention" for f in caught)


@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_unclamped_prefill_sentinel_chase_is_caught(route):
    """K2 chases each lane's table up to the q-block's horizon; without
    the clamp the all-sentinel lane addresses page ``num_pages``."""
    dtype = torch.bfloat16 if route == "bf16" else torch.float32
    t = 8
    (lg,) = paged_prefill.paged_prefill_grid(t, 4, 32, 2, NUM_PAGES,
                                             PAGE_SIZE, PPS, dtype)
    cases = bounds.paged_prefill_cases(NUM_PAGES, PAGE_SIZE, PPS, t)
    assert verify_launch_grid(lg, cases) == []

    def unclamped(cta, tables, positions, lens):
        row = cta[2] * t
        horizon = int(positions[row]) + int(lens[cta[2]])
        return [((0, 1), (int(tables[row, i]), int(tables[row, i]) + 1),
                 (0, PAGE_SIZE), (0, 32))
                for i in range(-(-horizon // PAGE_SIZE))]
    broken = _unclamp(lg, ("k_pages", "v_pages"), unclamped)
    caught = verify_launch_grid(broken, cases)
    assert {f.symbol for f in caught if f.rule == "STEP007"} == \
        {"k_pages", "v_pages"}
    sentinel = [c for c in cases if c.name == "all-sentinel"]
    caught = verify_launch_grid(broken, sentinel)
    assert any(f.rule == "STEP007" and "all-sentinel" in f.message
               for f in caught)


def test_last_tile_overrun_is_caught():
    """A CTA whose tile overhangs the array (no integer operand at all):
    the plain half of the containment proof."""
    lg = ix.LaunchGrid("toy", "fp32", (3, 1, 1), (ix.OperandAccess(
        "x", (10,), lambda cta: [((4 * cta[0], 4 * cta[0] + 4),)]),))
    caught = verify_launch_grid(lg)
    assert len(caught) == 1 and "CTA (2, 0, 0)" in caught[0].message


def test_findings_capped_per_operand():
    lg = ix.LaunchGrid("toy", "fp32", (100, 1, 1), (ix.OperandAccess(
        "x", (1,), lambda cta: [((cta[0] + 1, cta[0] + 2),)]),))
    assert len(verify_launch_grid(lg, max_findings_per_operand=3)) == 3


# ------------------------------------- coverage: poison what no CTA reads


def _poisoned(x, masks):
    out = {}
    for name, t in x.items():
        keep = torch.from_numpy(masks[name])
        if t.is_floating_point():
            out[name] = t.float().masked_fill(~keep, float("nan"))
        else:
            out[name] = t.masked_fill(~keep, 2 ** 30)
    return out


def _coverage_mismatches(lg, case):
    x = calls.make_inputs(lg, case, "cpu", torch.Generator().manual_seed(0))
    clean = calls.run_plain(lg, case, {k: v.float() if v.is_floating_point()
                                       else v for k, v in x.items()})
    dirty = calls.run_plain(lg, case, _poisoned(
        x, bounds.coverage_masks(lg, case.args)))
    rows = calls.compared_rows(lg, x)
    bad = []
    for name in clean:
        a, b = clean[name], dirty[name]
        if rows is not None and rows[0] == name:
            a, b = a[:, rows[1]], b[:, rows[1]]
        if not (torch.isfinite(b).all() and torch.equal(a, b)):
            bad.append(name)
    return bad


KERNELS = ["paged_attention", "paged_flash_prefill", "paged_tree_shared",
           "paged_tree_branch", "flash_prefill", "ssd_scan"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_access_ranges_cover_what_the_plain_version_needs(kernel):
    """Every lattice case of the kernel, both routes, head_dim 32: NaN in
    every float element and an out-of-pool entry in every int element
    that no CTA's range covers leave the plain version's outputs finite
    and bit-equal (K3's shared pass: the rows in a group, the others it
    leaves unwritten)."""
    n = 0
    for lg, cases in bounds.engine_lattice(head_dims=(32,)):
        if lg.kernel != kernel:
            continue
        for case in cases:
            assert _coverage_mismatches(lg, case) == [], \
                (lg.route, bounds.kv_regime(lg), case.name)
            n += 1
    assert n >= 2


def test_coverage_catches_a_narrowed_access():
    """The negative control: K1's K/V access without the full row's last
    two pages (page 4 of the pool is then in no CTA's range; page 5 is
    the short row's) poisons keys the row attends, and the plain output
    changes."""
    (lg,) = paged_attention.paged_attention_grid(3, 4, 32, 2, NUM_PAGES,
                                                 PAGE_SIZE, PPS,
                                                 torch.float32)
    kv = next(op for op in lg.operands if op.name == "k_pages")

    def narrowed(cta, *s):
        boxes = list(kv.ranges(cta, *s))
        return boxes[:-2] if cta[0] == 0 else boxes
    case = bounds.paged_attention_cases(NUM_PAGES, PAGE_SIZE, PPS, 3)[0]
    assert _coverage_mismatches(
        _unclamp(lg, ("k_pages", "v_pages"), narrowed), case) == ["out"]


# ----------------------------- the wrappers hand their grids to launchers


def _c_params(source: str, name: str):
    text = (CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S)
    return [p.strip() for p in m.group(1).split(",")]


class _Launcher:
    """Stands in for a launcher: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def launchers(monkeypatch):
    got = {}

    def function(source, fn_name, argtypes):
        rec = got.setdefault(fn_name, _Launcher())
        rec.source, rec.argtypes = source, list(argtypes)
        return rec
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "check_operands", lambda *a: None)
    monkeypatch.setattr(build, "stream", lambda t: 0)
    monkeypatch.setattr(flash_prefill, "_num_sms", lambda dev: 132)
    return got


def _grids(rec):
    """The (grids, n_grids) pair a launcher got: the two arguments before
    the stream."""
    arr, n = rec.calls[-1][-3], rec.calls[-1][-2]
    assert isinstance(arr, ctypes.Array)   # held alive by the call
    ptr = ctypes.addressof(arr)
    return [tuple((ctypes.c_int * 3).from_address(ptr + 12 * i))
            for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_pass_their_grids(launchers, dtype):
    """Each serve-path wrapper passes its grid function's grids, as the
    two arguments before the stream, to a launcher whose ctypes argument
    list matches the ``extern "C"`` signature (ending ``const int*
    grids, int n_grids, void* stream``)."""
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(*s, generator=g).to(dtype)   # noqa: E731
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)      # noqa: E731
    q, kp, vp = f(3, 4, 32), f(2, 16, 4, 32), f(2, 16, 4, 32)
    paged_attention.paged_attention_decode(q, kp, vp, i32(3, 6), i32(3))
    paged_prefill.paged_flash_prefill_lanes_fwd(
        f(16, 4, 32), kp, vp, i32(16, 6), i32(16), i32(2), (8, 8))
    part, keys = tree_decode.paged_tree_shared_fwd(
        q, kp, vp, i32(3), i32(3, 6), i32(3), i32(3))
    tree_decode.paged_tree_branch_fwd(q, kp, vp, i32(3), i32(3), i32(3, 6),
                                      i32(3), part, keys)
    flash_prefill.flash_prefill(f(2, 12, 4, 32), f(2, 12, 2, 32),
                                f(2, 12, 2, 32))
    ssd_scan.ssd_scan(f(2, 16, 2, 24), torch.rand(2, 16, 2),
                      -torch.rand(2), f(2, 16, 2, 4), f(2, 16, 2, 4),
                      chunk=8)
    want = {
        "paged_decode_launch": paged_attention.paged_attention_grid(
            3, 4, 32, 2, 16, 4, 6, dtype),
        "paged_prefill_launch": paged_prefill.paged_prefill_grid(
            8, 4, 32, 2, 16, 4, 6, dtype, 2),
        "tree_shared_launch": tree_decode.paged_tree_shared_grid(
            3, 4, 32, 2, 16, 4, 3, 6, dtype),
        "tree_branch_launch": tree_decode.paged_tree_branch_grid(
            3, 4, 32, 2, 16, 4, 6, dtype, 3),
        ("flash_prefill_sm90_launch" if dtype == torch.bfloat16
         else "flash_prefill_launch"): flash_prefill.flash_prefill_grid(
            2, 12, 4, 32, 2, dtype),
        "ssd_scan_launch": ssd_scan.ssd_scan_grid(2, 16, 2, 24, 4, 8,
                                                  dtype),
    }
    assert set(launchers) == set(want)
    for name, launches in want.items():
        rec = launchers[name]
        assert _grids(rec) == [lg.grid for lg in launches], name
        params = _c_params(rec.source, name)
        assert len(params) == len(rec.argtypes) == len(rec.calls[-1]), name
        assert params[-3:] == ["const int* grids", "int n_grids",
                               "void* stream"], name
        assert rec.argtypes[-3:] == ix.GRID_ARGTYPES + [ctypes.c_void_p]


def test_grid_rules_follow_the_split_layouts():
    """K1's and K3's grids read the split layouts the wrappers launch
    with: ``decode_splits`` and ``shared_splits`` of the table's shape."""
    from repro_torch.kernels.paged_attention.ref import decode_splits
    for width in (6, 32, 128, 512):
        keys, n = decode_splits(16, width, torch.bfloat16)
        (lg,) = paged_attention.paged_attention_grid(
            2, 40, 128, 8, 4097, 16, width, torch.bfloat16)
        assert lg.grid[0] == n and dict(lg.host)["split_keys"] == keys
        keys, n = tree_decode.shared_splits(16, width, torch.bfloat16)
        (lg,) = tree_decode.paged_tree_shared_grid(
            2, 40, 128, 8, 4097, 16, 2, width, torch.bfloat16)
        assert lg.grid[0] == n and dict(lg.host)["split_keys"] == keys
    assert np.prod(ssd_scan.ssd_scan_grid(1, 4, 3, 128, 16, 4)[0].grid) == 24
