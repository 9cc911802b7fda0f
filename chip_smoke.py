#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py              # every phase; needs one card
    python3 chip_smoke.py --skip-serve # build + kernel checks only, no "ok"
    python3 chip_smoke.py --profile DIR  # build + profiled serves, no "ok"
    python3 chip_smoke.py --tree-pairs 3 # build + phase 6 tree/paged pairs

Phases, in order; any failure raises and the script exits non-zero:

  1. device  — the card's name and power limit (nvidia-smi) and torch's name;
  2. build   — nvcc builds the CUDA kernels from ``src/repro_torch/csrc``
               (the time of each source, ptxas's registers and spills,
               and the tensor-core instructions in the SASS);
  3. kernels — K1 (paged flash-decode; bf16 on the split-key mma.sync
               decode core), K2 (paged flash-prefill), both
               passes of K3 (tree decode; the shared pass's split partials
               folded by the plain merge; the branch pass on the decode
               core), K4 (the SSD chunked scan, y
               and final state, with and without an initial state) and K5
               (the dense flash prefill: wgmma in bf16, CUDA cores in
               fp32) against their plain PyTorch versions on the card,
               bf16 and fp32, at the serving shapes
               of r1-distill-14b and mamba2-130m, one qwen2-0.5b and one
               hymba-1.5b shape, head_dim 32 (the launcher's fallback
               trunks) for K1-K3 and K5, and the edge cases (K1's ragged
               lengths 0-512, and 0-2,048 over 128-page tables cut into two
               key splits, and a 24-head GQA group; K3's topologies, the
               same ragged lengths in one group, suffixes across two key
               splits, a span that is not a
               whole number of splits and a 13-member group; K1 and K3
               outputs bit-equal with and without the NaN in stale and
               unowned pages; K4's non-divisible S, masked dt and
               all-invalid rows; K5's non-divisible S, non-causal, GQA
               groups 1 and 8, true_len, a key loop wrapping the TMA ring);
               then each timed with CUDA events (L2 flushed
               before every launch; ``ms`` holds the wrapper's host time
               where it outlasts the flush, ``queued_ms`` queues the
               launches ahead and is the device's alone; ``host_us`` is
               the wrapper's host time per call) beside its plain
               version, a bound from
               bytes and operations, and one library call as a yardstick
               where one exists (none for K4); K5 at S = 272 and 4096; K1
               and K3's branch pass also at a long context (16 rows of 512
               tokens; suffixes of 240-256 tokens), and K1 at 2 rows of
               2,048 tokens, where each row spans two key splits (a
               cluster of 2 CTAs);
  4. parity  — the engine on the card (kernels) against the engine on the
               CPU (plain versions) on small fp32 models, greedy, with
               chunked admission, forked branches, CoW and a suspend/resume
               round trip: dense, then with the prefix cache and tree
               decode on (a warm request sharing the cold one's header);
               ssm and hybrid (K4 in the chunk lanes), the hybrid again
               with the cache and tree on, its warm request seeded from a
               page-aligned SSM boundary snapshot; dense, ssm and hybrid
               with ``chunked_prefill=False`` (K5 in every exact
               admission); ``Model.prefill`` + ``decode_step`` (dense and
               sliding-window); the launcher's dense and hybrid fallback
               trunks (head_dim 32) serving on the card;
  5. serve   — r1-distill-14b at full width and depth (48 layers, bf16,
               random weights from a seed) behind the SART scheduler through
               ``repro_torch.launch.serve.run_serving``: 4 requests, n=8.
               Kernel launch counters are zeroed just before and read just
               after, and every request must complete with no fault;
  6. tree    — the same model and weights, phase 5's engine freed, with
               ``prefix_cache=True, decode_kernel="tree"``: 4 requests whose
               prompts share a 256-token few-shot header. The cache must
               hit, K3 must carry every decode row and K1 must not launch;
  7. exact   — the same model and weights, phase 6's traffic with
               ``chunked_prefill=False`` (cache off, per-branch decode):
               every admission is one exact-length pass, K5 48 times; K5
               must launch 192 times, K2 never, K1 on every step; then
               ``Model.prefill`` of a 4,096-token prompt (48 K5 launches)
               and 8 ``decode_step``s over its dense cache, and exact
               against chunked first-token logits of one prompt (printed);
  8. ssm     — mamba2-130m at full width and depth (24 layers, d_model
               768, 24 SSD heads, state 128, bf16, random weights from a
               seed) through ``run_serving``: 4 requests, n=8. K4 must
               launch once per layer per mixed step, K1-K3 never; every
               request completes with no fault and no leaked page.

Then one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without a card, or without the repo's
``src/`` beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
DEVICE = "cuda"

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
TOL = {"bf16": 2e-2, "fp32": 1e-5}      # atol = rtol, per working dtype


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- inputs


def _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd, dtype):
    return (torch.randn((kv_heads, pool_pages, ps, hd), generator=gen,
                        device=dev).to(dtype),
            torch.randn((kv_heads, pool_pages, ps, hd), generator=gen,
                        device=dev).to(dtype))


def _poison_tail(k_pages, v_pages, page: int, start: int) -> None:
    """NaN into a page's slots past a sequence's end: a kernel that
    multiplies them by a zero weight instead of skipping them fails."""
    k_pages[:, page, start:] = float("nan")
    v_pages[:, page, start:] = float("nan")


def k1_inputs(torch, gen, dev, *, lengths, q_heads, kv_heads, hd, ps, width,
              pool_pages, dtype):
    batch = len(lengths)
    q = torch.randn((batch, q_heads, hd), generator=gen, device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    perm = torch.randperm(pool_pages, generator=gen, device=dev).tolist()
    # sentinel tails point past the pool: a kernel must never follow them
    bt = torch.full((batch, width), pool_pages, dtype=torch.int32)
    off = 0
    for b, n_tok in enumerate(lengths):
        n = -(-n_tok // ps)
        bt[b, :n] = torch.tensor(perm[off:off + n], dtype=torch.int32)
        off += n
        if n_tok % ps:
            _poison_tail(k_pages, v_pages, perm[off - 1], n_tok % ps)
    # every page no row owns is NaN (the clamped sentinel's target too)
    unowned = torch.tensor(perm[off:], dtype=torch.long, device=dev)
    k_pages[:, unowned] = float("nan")
    v_pages[:, unowned] = float("nan")
    return (q, k_pages, v_pages, bt.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def k2_inputs(torch, gen, dev, *, t, pos0, valid_len, q_heads, kv_heads, hd,
              ps, width, pool_pages, dtype):
    q = torch.randn((t, q_heads, hd), generator=gen, device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    end = pos0 + valid_len
    n = -(-end // ps)
    perm = torch.randperm(pool_pages, generator=gen, device=dev).tolist()
    bt = torch.full((width,), pool_pages, dtype=torch.int32)
    bt[:n] = torch.tensor(perm[:n], dtype=torch.int32)
    if end % ps:
        _poison_tail(k_pages, v_pages, perm[n - 1], end % ps)
    return q, k_pages, v_pages, bt.to(dev), pos0, valid_len


# ---------------------------------------------------------------- timing


def k3_inputs(torch, gen, dev, *, groups, singles, q_heads, kv_heads, hd,
              ps, width, pool_pages, dtype):
    """A fork topology and its tree map, as ``tree_decode_map`` lays it
    out (group axis padded to the batch). ``groups``: (shared pages, [row
    lengths in tokens]) per fork group; ``singles``: lengths of rows in no
    group. Every page no row owns is NaN, and so is every slot past a
    row's end in a page only that row reads."""
    perm = iter(torch.randperm(pool_pages, generator=gen,
                               device=dev).tolist())

    def take(n):
        return [next(perm) for _ in range(n)]

    rows = []                      # (group or None, shared, suffix, length)
    for gi, (n_shared, lens) in enumerate(groups):
        shared = take(n_shared)
        for n in lens:
            rows.append((gi, shared, take(-(-max(n - n_shared * ps, 0)
                                            // ps)), n))
    rows += [(None, [], take(-(-n // ps)), n) for n in singles]
    batch = len(rows)
    q = torch.randn((batch, q_heads, hd), generator=gen, device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    rg = torch.full((batch,), batch, dtype=torch.int32)
    sbt = torch.full((batch, width), pool_pages, dtype=torch.int32)
    sl = torch.zeros((batch,), dtype=torch.int32)
    bbt = torch.full((batch, width), pool_pages, dtype=torch.int32)
    used = set()
    for b, (gi, shared, suffix, n) in enumerate(rows):
        if gi is not None:
            rg[b] = gi
            sbt[gi, :len(shared)] = torch.tensor(shared, dtype=torch.int32)
            sl[gi] = len(shared) * ps
        bbt[b, :len(suffix)] = torch.tensor(suffix, dtype=torch.int32)
        used.update(shared + suffix)
        if suffix and n % ps:
            _poison_tail(k_pages, v_pages, suffix[-1], n % ps)
    unowned = torch.ones((pool_pages,), dtype=torch.bool)
    unowned[sorted(used)] = False
    k_pages[:, unowned.to(dev)] = float("nan")
    v_pages[:, unowned.to(dev)] = float("nan")
    lengths = torch.tensor([r[3] for r in rows], dtype=torch.int32)
    return (q, k_pages, v_pages, rg.to(dev), sbt.to(dev), sl.to(dev),
            bbt.to(dev), lengths.to(dev))


def time_ms(torch, fn, n: int = 50, warmup: int = 5,
            head_start: bool = False) -> float:
    """Mean device time of ``fn`` over ``n`` launches (CUDA events around
    each launch), with a 64 MiB write before each to push the inputs out
    of the 50 MB L2, as a layer of the serving step finds them. Where the
    host takes longer to issue ``fn``'s launches than the card takes for
    the write, the card idles inside the measurement: the time then
    holds the wrapper's host time, which a host-bound step also pays.
    ``head_start`` adds a ~0.3 ms spin of the card after the write, so
    the launches are queued before the card reaches the start event and
    the time is the device's alone (reported as ``queued_ms``)."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        flush.zero_()
        if head_start:
            torch.cuda._sleep(500_000)   # cycles; touches no memory
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / n


def host_us(torch, fn, n: int = 200) -> float:
    """Mean host time of one call of ``fn`` in microseconds: ``n`` calls
    issued back to back (the card's queue absorbs them), no sync inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def kernel_ms(torch, fn) -> dict:
    """A kernel wrapper's ``ms`` (host time included where the host is
    slower than the flush), ``queued_ms`` (launches queued ahead: the
    device's time alone), both from ``time_ms``, and ``host_us``, the
    wrapper's host time per call."""
    return {"ms": time_ms(torch, fn),
            "queued_ms": time_ms(torch, fn, head_start=True),
            "host_us": host_us(torch, fn)}


def bound(bytes_moved: float, ops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi


def _demangle(symbol: str) -> str:
    """A kernel's C++ name from its mangled symbol (c++filt where the
    machine has it), shortened to the name and its template arguments."""
    try:
        symbol = subprocess.run(["c++filt", symbol], capture_output=True,
                                text=True, timeout=10).stdout.strip() \
            or symbol
    except OSError:
        pass
    return symbol.split("(")[0]


def phase_build():
    from repro_torch.kernels import build
    secs = build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in {secs:.1f} s -> "
          f"{build.build_dir()}")
    for name, t in sorted(build.build_seconds.items()):
        print(f"[build] {name}: nvcc done after {t:.1f} s")
    for name, log in sorted(build.build_log.items()):
        fn = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = _demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {fn}: {line.strip()}")
    # the tensor-core instructions in the built code: warpgroup MMAs
    # (HGMMA, wgmma) in K5's bf16 kernel, warp MMAs (HMMA, mma.sync) in
    # the bf16 decode core (K1; K3's branch pass) and K3's shared pass
    dump = Path(build._nvcc()).with_name("cuobjdump")
    if not dump.exists():
        print("[build] no cuobjdump beside nvcc: SASS not counted")
        return
    for name, op in (("flash_prefill_sm90", "HGMMA"),
                     ("paged_decode", "HMMA"),
                     ("paged_tree_decode", "HMMA")):
        sass = subprocess.run(
            [str(dump), "-sass", str(build.build_dir() / f"lib{name}.so")],
            capture_output=True, text=True, timeout=120).stdout
        n = sum(op in line for line in sass.splitlines())
        print(f"[build] {name}: {n} {op} instructions in its SASS")
        check(n > 0, f"{name} has no {op} instruction")


def _compare(torch, name, out, ref, dtype_name):
    tol = TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), atol=tol, rtol=tol)
    print(f"[kernels] {name}: max_abs_err {err:.3e} (atol=rtol={tol}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return err


# ragged decode lengths over 32-page tables of 16 tokens: empty, full
# (512), one key, and ends on and around page, tile and split edges
RAGGED = [0, 512, 1, 15, 16, 17, 33, 100, 255, 256, 257, 300, 400, 450, 500,
          511]
# and over 128-page tables, around the 1,024-key split edge
RAGGED_2K = [0, 2048, 1, 1023, 1024, 1025, 2047, 1500]


def k1_splits(torch, page_size: int, width: int) -> str:
    """The bf16 decode core's key splits of such tables, for a shape
    string."""
    from repro_torch.kernels.paged_attention.ref import decode_splits
    keys, n = decode_splits(page_size, width, torch.bfloat16)
    if n == 1:
        return f"one key split of {keys} (one CTA per row and KV head)"
    return f"{n} key splits of {keys} (a cluster of {n} CTAs per row)"


def phase_kernels(torch):
    """Hold K1/K2 against their plain versions; returns per-kernel
    results for the JSON line (timings at the serving shapes)."""
    from repro_torch.kernels.flash_prefill.ops import mixed_step_bytes_read
    from repro_torch.kernels.flash_prefill.paged_prefill import \
        paged_flash_prefill_fwd
    from repro_torch.kernels.flash_prefill.ref import paged_flash_prefill_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_decode
    from repro_torch.kernels.paged_attention.ref import (
        gather_pages, paged_attention_decode_ref)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    r1 = dict(q_heads=40, kv_heads=8, hd=128, ps=16, width=32,
              pool_pages=4097)
    qw = dict(q_heads=14, kv_heads=2, hd=64, ps=16, width=32,
              pool_pages=4097)
    # the serve launcher's untrained fallback trunks: 4/2 heads of 32
    t32 = dict(q_heads=4, kv_heads=2, hd=32, ps=16, width=32,
               pool_pages=4097)
    # 24 query heads per KV head: two 16-head slices of the bf16 kernel
    g24 = dict(q_heads=48, kv_heads=2, hd=64, ps=16, width=32,
               pool_pages=4097)
    errs = {"paged_decode": [], "paged_prefill": []}

    # 128-page tables (2,048 keys): two key splits, a cluster of 2 CTAs
    r1_2k = dict(r1, width=128)
    for shape_name, shape, lengths in (("r1", r1, RAGGED),
                                       ("qwen2", qw, RAGGED),
                                       ("hd32", t32, RAGGED),
                                       ("group24", g24, RAGGED[:6]),
                                       ("r1 2 splits", r1_2k, RAGGED_2K),
                                       ("hd32 2 splits", dict(t32, width=128),
                                        RAGGED_2K)):
        for dn, dt in dtypes.items():
            args = k1_inputs(torch, gen, dev, lengths=lengths, dtype=dt,
                             **shape)
            out = paged_attention_decode(*args)
            ref = paged_attention_decode_ref(*args)
            # NaN in stale slots and unowned pages changes no bit
            q, kp, vp, bt, ln = args
            clean = paged_attention_decode(q, kp.nan_to_num(),
                                           vp.nan_to_num(), bt, ln)
            torch.cuda.synchronize()
            check(bool((out[0] == 0).all()), "K1 length-0 row is not zero")
            check(torch.equal(out, clean), "K1 output moved with the NaN "
                  "in stale or unowned pages")
            errs["paged_decode"].append(_compare(
                torch, f"K1 {shape_name} {dn} B={len(lengths)}", out, ref,
                dn))
    k2_cases = [(r1, t, pos0, valid) for t in (32, 64) for pos0 in (0, 37, 448)
                for valid in (t - 5, 1)] + [(qw, 64, 37, 60),
                                            (t32, 64, 37, 60),
                                            (t32, 32, 0, 17)]
    for shape, t, pos0, valid in k2_cases:
        for dn, dt in dtypes.items():
            args = k2_inputs(torch, gen, dev, t=t, pos0=pos0, valid_len=valid,
                             dtype=dt, **shape)
            out = paged_flash_prefill_fwd(*args)
            ref = paged_flash_prefill_ref(*args)
            torch.cuda.synchronize()
            check(bool((out[valid:] == 0).all()), "K2 pad rows are not zero")
            errs["paged_prefill"].append(_compare(
                torch, f"K2 hd={shape['hd']} T={t} pos0={pos0} "
                f"valid={valid} {dn}", out, ref, dn))

    # timing at the serve phase's shapes (bf16): 16 decode rows whose
    # contexts run from the prompt (11-17 tokens) to prompt + 96; one
    # chunk lane of bucket 32 holding a 17-token prompt from position 0
    rng_len = torch.Generator().manual_seed(1)
    lengths = torch.randint(17, 17 + 96, (16,), generator=rng_len).tolist()
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=lengths,
                                  dtype=torch.bfloat16, **r1)
    kc = gather_pages(kp, bt).nan_to_num()       # pre-gathered [B, kv, S, hd]
    vc = gather_pages(vp, bt).nan_to_num()
    mask = (torch.arange(kc.shape[2], device=dev)[None, :]
            < ln[:, None].long())[:, None, None, :]
    H, kv, hd, ps = r1["q_heads"], r1["kv_heads"], r1["hd"], r1["ps"]

    def k1_bytes_ops(lengths):
        tok = sum(lengths)
        followed = sum(-(-n // ps) for n in lengths)   # table entries read
        return (2 * len(lengths) * H * hd * 2 + tok * kv * hd * 2 * 2
                + followed * 4 + len(lengths) * 4, 4 * tok * H * hd)

    sdpa = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
    bytes_, ops = k1_bytes_ops(lengths)
    k1 = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "plain_ms": time_ms(torch, lambda: paged_attention_decode_ref(
            q, kp, vp, bt, ln)),
        "library_ms": sdpa["ms"],
        "bytes": bytes_, "ops": ops,
        "shape": f"B=16 H=40 kv=8 hd=128 ps=16 W=32 bf16, lengths "
                 f"{min(lengths)}..{max(lengths)} (sum {sum(lengths)}), "
                 f"{k1_splits(torch, ps, r1['width'])}",
    }
    print(f"[kernels] K1 at the serve shape: ms {k1['ms']:.4f} (SDPA "
          f"{sdpa['ms']:.4f}), queued_ms {k1['queued_ms']:.4f} (SDPA "
          f"{sdpa['queued_ms']:.4f}), host_us {k1['host_us']:.1f} (SDPA "
          f"{sdpa['host_us']:.1f})")
    # the long-context row: 16 rows at the table's full 512 tokens, where
    # every row spans all the key splits (whether the split over CTAs pays)
    long_lens = [r1["width"] * ps] * 16
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=long_lens,
                                  dtype=torch.bfloat16, **r1)
    kc = gather_pages(kp, bt).nan_to_num()
    vc = gather_pages(vp, bt).nan_to_num()
    bytes_, ops = k1_bytes_ops(long_lens)
    k1["long"] = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True)),
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": "B=16 at 512 tokens (the full table), H=40 kv=8 hd=128 "
                 f"ps=16 W=32 bf16, {k1_splits(torch, ps, r1['width'])}",
    }
    print("[kernels] K1 long-context row: " + json.dumps(k1["long"]))
    # 2 rows at 2,048 tokens over 128-page tables: 2 key splits, the
    # case the cluster split is for (few rows, long tables)
    long_lens = [2048] * 2
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=long_lens,
                                  dtype=torch.bfloat16, **r1_2k)
    kc = gather_pages(kp, bt).nan_to_num()
    vc = gather_pages(vp, bt).nan_to_num()
    bytes_, ops = k1_bytes_ops(long_lens)
    k1["long_few_rows"] = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True)),
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": "B=2 at 2,048 tokens (the full table), H=40 kv=8 hd=128 "
                 f"ps=16 W=128 bf16, {k1_splits(torch, ps, 128)}",
    }
    print("[kernels] K1 long-context row, 2 rows: "
          + json.dumps(k1["long_few_rows"]))
    t, pos0, valid = 32, 0, 17
    q, kp, vp, bt, _, _ = k2_inputs(torch, gen, dev, t=t, pos0=pos0,
                                    valid_len=valid, dtype=torch.bfloat16,
                                    **r1)
    kc = gather_pages(kp, bt).nan_to_num()[None]       # [1, kv, S, hd]
    vc = gather_pages(vp, bt).nan_to_num()[None]
    s_max = kc.shape[2]
    mask2 = (torch.arange(s_max, device=dev)[None, :]
             <= pos0 + torch.arange(t, device=dev)[:, None])[None, None]
    qt = q.transpose(0, 1)[None]                       # [1, H, T, hd]
    seen = sum(pos0 + i + 1 for i in range(valid))
    k2 = {
        **kernel_ms(torch, lambda: paged_flash_prefill_fwd(
            q, kp, vp, bt, pos0, valid)),
        "plain_ms": time_ms(torch, lambda: paged_flash_prefill_ref(
            q, kp, vp, bt, pos0, valid)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask2, enable_gqa=True)),
        # q of the valid rows in (pad rows are zeros whatever q holds),
        # every output row out, the K/V of the visible tokens once (the
        # reference's byte model at token granularity), the table entries
        # the causal horizon reaches
        "bytes": (valid + t) * H * hd * 2
        + mixed_step_bytes_read(valid, pos0, 1, kv, hd, path="fused",
                                block_q=t, itemsize=2)
        + -(-(pos0 + valid) // ps) * 4,
        "ops": 4 * seen * H * hd,
        "shape": f"T={t} pos0={pos0} valid_len={valid} H=40 kv=8 hd=128 "
                 "ps=16 W=32 bf16",
    }
    return errs, {"paged_decode": k1, "paged_prefill": k2}


def phase_tree_kernels(torch):
    """Hold both passes of K3 against their plain versions (the branch
    pass's output is K3's output, held against the full plain version
    that defers to K1's); returns per-pass results for the JSON line,
    timed at the tree serve's shape."""
    from repro_torch.kernels.paged_attention.ops import tree_decode_bytes_read
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_decode
    from repro_torch.kernels.paged_attention.ref import (
        gather_pages, paged_tree_attention_ref, tree_branch_merge_ref,
        tree_full_tables, tree_merge_splits_ref, tree_shared_partials_ref)
    from repro_torch.kernels.paged_attention.tree_decode import (
        paged_tree_branch_fwd, paged_tree_shared_fwd, unpack_partials)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(2)
    rng = torch.Generator().manual_seed(3)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    r1 = dict(q_heads=40, kv_heads=8, hd=128, ps=16, width=32,
              pool_pages=4097)
    qw = dict(r1, q_heads=14, kv_heads=2, hd=64)
    t32 = dict(r1, q_heads=4, kv_heads=2, hd=32)
    errs = {"paged_tree_shared": [], "paged_tree_branch": []}

    def serve_topology():
        # 16 rows in 2 groups of 8, a 16-page span, suffixes of 1-6 pages
        lens = (256 + torch.randint(1, 97, (16,), generator=rng)).tolist()
        return [(16, lens[:8]), (16, lens[8:])], []

    cases = [("r1 serve", r1, *serve_topology()),
             ("qwen2 serve", qw, *serve_topology()),
             # a row ending inside its span, a 1-member group, length-0
             # rows in a group and alone, ungrouped singletons
             ("r1 edges", r1, [(4, [4 * 16 + 5, 2 * 16 + 3, 0, 4 * 16]),
                               (2, [2 * 16 + 9])], [37, 0, 1]),
             ("qwen2 edges", qw, [(3, [3 * 16 + 1, 16 + 7]), (1, [20])],
              [0, 300]),
             ("hd32 serve", t32, *serve_topology()),
             ("hd32 edges", t32, [(2, [2 * 16 + 3, 0, 5 * 16]), (1, [16])],
              [9, 0]),
             # a span of 5 pages, not a whole number of 32-key splits
             ("r1 span 80", r1, [(5, [5 * 16 + 3, 3 * 16 + 2, 5 * 16 + 40])],
              [11]),
             # 13 members: more than one CTA's 12 (64 // 5), a second slice
             ("r1 13 members", r1, [(3, [3 * 16 + 1 + i for i in range(13)])],
              [5]),
             # K1's ragged lengths (0 to 512) in one group over a 2-page
             # span: suffixes up to 480 keys, across the branch pass's key
             # splits
             ("r1 ragged", r1, [(2, RAGGED)], []),
             ("qwen2 ragged", qw, [(2, RAGGED)], []),
             ("hd32 ragged", t32, [(2, RAGGED)], []),
             # 128-page tables: suffixes across the branch pass's two key
             # splits (a cluster of 2 CTAs), an ungrouped row at 2,048
             ("r1 2 splits", dict(r1, width=128),
              [(2, [32 + 2016, 32 + 1000, 32 + 1024, 10])], [2048, 0]),
             ("hd32 2 splits", dict(t32, width=128),
              [(2, [32 + 1500, 32 + 992, 3])], [1025])]
    for name, shape, groups, singles in cases:
        for dn, dt in dtypes.items():
            args = k3_inputs(torch, gen, dev, groups=groups, singles=singles,
                             dtype=dt, **shape)
            q, kp, vp, rg, sbt, sl, bbt, ln = args
            m_r, l_r, acc_r = tree_shared_partials_ref(q, kp, vp, rg, sbt, sl,
                                                       ln)
            ref = paged_tree_attention_ref(*args)
            grouped = rg < rg.shape[0]
            # splits over a span of the whole table, over the longest
            # group span (as the engine passes it), and over a span
            # understated to one page (the last split takes the rest)
            longest = int(sl.max())
            table = shape["ps"] * sbt.shape[1]
            for span in (table, longest, shape["ps"]):
                part, keys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl,
                                                   ln, span)
                out = paged_tree_branch_fwd(q, kp, vp, rg, sl, bbt, ln, part,
                                            keys)
                m, l, acc = unpack_partials(part)
                # NaN in unowned pages and stale slots changes no bit
                kc, vc = kp.nan_to_num(), vp.nan_to_num()
                clean = paged_tree_branch_fwd(q, kc, vc, rg, sl, bbt, ln, *(
                    paged_tree_shared_fwd(q, kc, vc, rg, sbt, sl, ln, span)))
                torch.cuda.synchronize()
                check(bool((out[ln == 0] == 0).all()),
                      "K3 length-0 row is not zero")
                check(torch.equal(out, clean), "K3 output moved with the "
                      "NaN in stale or unowned pages")
                # the kernel's split partials of the grouped rows, folded
                m_k, l_k, acc_k = tree_merge_splits_ref(
                    m[:, grouped], l[:, grouped], acc[:, grouped])
                tag = f"{name} {dn} B={q.shape[0]} span={span} " \
                    f"n_split={m.shape[0]}"
                errs["paged_tree_shared"].append(_compare(
                    torch, f"K3 shared {tag}",
                    torch.cat([m_k[..., None], l_k[..., None], acc_k], -1),
                    torch.cat([m_r[grouped, :, None], l_r[grouped, :, None],
                               acc_r[grouped]], -1), dn))
                errs["paged_tree_branch"].append(_compare(
                    torch, f"K3 branch (output) {tag}", out, ref, dn))

    # timing at the tree serve's shape (bf16)
    groups, _ = serve_topology()
    args = k3_inputs(torch, gen, dev, groups=groups, singles=[],
                     dtype=torch.bfloat16, **r1)
    q, kp, vp, rg, sbt, sl, bbt, ln = args
    H, kv, hd, ps = r1["q_heads"], r1["kv_heads"], r1["hd"], r1["ps"]
    B = q.shape[0]
    lens = ln.tolist()
    span = 256
    suffix = [n - span for n in lens]
    # the K3 calls as the engine makes them: the longest span as a host int
    part, split_keys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln,
                                             span)
    n_split = part.shape[0]
    full = tree_full_tables(rg, sbt, sl, bbt, ps)
    k1_ms = kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, full,
                                                            ln))
    k3_ms = kernel_ms(torch, lambda: paged_tree_branch_fwd(
        q, kp, vp, rg, sl, bbt, ln, *paged_tree_shared_fwd(
            q, kp, vp, rg, sbt, sl, ln, span)))
    # the reference's byte model at token granularity, per fork group
    kv_bytes = {path: sum(tree_decode_bytes_read(
        span, suffix[g * 8:(g + 1) * 8], 1, kv, hd, path=path, itemsize=2)
        for g in range(2)) for path in ("branch", "tree")}
    print(f"[kernels] tree serve shape (B=16, 2 groups of 8, span 256, "
          f"suffixes {min(suffix)}..{max(suffix)} tokens, bf16): K1 over "
          f"the rebuilt full tables {k1_ms['ms']:.4f} ms (queued "
          f"{k1_ms['queued_ms']:.4f} ms); K3 both passes "
          f"{k3_ms['ms']:.4f} ms (queued {k3_ms['queued_ms']:.4f} ms); "
          f"K/V bytes per-branch {kv_bytes['branch']} "
          f"({kv_bytes['branch'] / HBM_BYTES_PER_S * 1e6:.2f} us), tree "
          f"{kv_bytes['tree']} "
          f"({kv_bytes['tree'] / HBM_BYTES_PER_S * 1e6:.2f} us)")
    # library yardsticks over K/V gathered beforehand: the members of each
    # group against their shared span; each row against its suffix
    ks = gather_pages(kp, sbt[:2, :span // ps]).nan_to_num()  # [2, kv, S, hd]
    vs = gather_pages(vp, sbt[:2, :span // ps]).nan_to_num()
    qs = q.reshape(2, 8, H, hd).transpose(1, 2)              # [2, H, 8, hd]
    kb = gather_pages(kp, bbt).nan_to_num()                   # [B, kv, S, hd]
    vb = gather_pages(vp, bbt).nan_to_num()
    mask = (torch.arange(kb.shape[2], device=dev)[None, :]
            < torch.tensor(suffix, device=dev)[:, None])[:, None, None, :]
    common = 4 * B + B * 4 + 2 * 4     # lengths, row_group, shared_lens
    one_set = B * H * (hd + 2) * 4     # one set of fp32 (m, l, acc)
    sdpa = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, enable_gqa=True))
    shared = {
        **kernel_ms(torch, lambda: paged_tree_shared_fwd(
            q, kp, vp, rg, sbt, sl, ln, span)),
        "plain_ms": time_ms(torch, lambda: tree_shared_partials_ref(
            q, kp, vp, rg, sbt, sl, ln)),
        "library_ms": sdpa["ms"],
        # what the function needs: the two spans' K/V once, q in, one set
        # of fp32 (m, l, acc) out, the span's table entries of each group
        # (the other splits' partials are traffic of this design, in
        # "shape", not in the bound)
        "bytes": tree_decode_bytes_read(2 * span, [], 1, kv, hd,
                                        path="tree", itemsize=2)
        + B * H * hd * 2 + one_set + 2 * (span // ps) * 4 + common,
        "ops": 4 * B * span * H * hd,
        "shape": "B=16 in 2 groups of 8, shared span 256 tokens (16 pages),"
                 f" H=40 kv=8 hd=128 ps=16 W=32 bf16, n_split={n_split} "
                 f"of {split_keys} keys (the engine's host span; the splits "
                 f"write {n_split * one_set} bytes of fp32 partials)",
    }
    print(f"[kernels] K3 shared pass at the tree serve shape: ms "
          f"{shared['ms']:.4f} (SDPA {sdpa['ms']:.4f}), queued_ms "
          f"{shared['queued_ms']:.4f} (SDPA {sdpa['queued_ms']:.4f}), "
          f"host_us {shared['host_us']:.1f} (SDPA {sdpa['host_us']:.1f})")
    def branch_bytes_ops(suffix):
        # the suffixes' K/V once, q and one set of shared partials in, the
        # output out, the suffix table entries followed
        followed = sum(-(-n // ps) for n in suffix)
        return (tree_decode_bytes_read(0, suffix, 1, kv, hd, path="tree",
                                       itemsize=2)
                + B * H * hd * 2 + one_set + B * H * hd * 2
                + followed * 4 + common, 4 * sum(suffix) * H * hd)

    sdpa_b = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True))
    bytes_, ops = branch_bytes_ops(suffix)
    branch = {
        **kernel_ms(torch, lambda: paged_tree_branch_fwd(
            q, kp, vp, rg, sl, bbt, ln, part, split_keys)),
        "plain_ms": time_ms(torch, lambda: tree_branch_merge_ref(
            q, kp, vp, rg, sl, bbt, ln,
            *tree_merge_splits_ref(*unpack_partials(part)))),
        "library_ms": sdpa_b["ms"],
        "bytes": bytes_, "ops": ops,
        "shape": f"B=16, suffixes {min(suffix)}..{max(suffix)} tokens (sum "
                 f"{sum(suffix)}), H=40 kv=8 hd=128 ps=16 W=32 bf16, "
                 f"merging {n_split} shared splits; "
                 f"{k1_splits(torch, ps, r1['width'])}",
    }
    print(f"[kernels] K3 branch pass at the tree serve shape: ms "
          f"{branch['ms']:.4f} (SDPA {sdpa_b['ms']:.4f}), queued_ms "
          f"{branch['queued_ms']:.4f} (SDPA {sdpa_b['queued_ms']:.4f}), "
          f"host_us {branch['host_us']:.1f} (SDPA {sdpa_b['host_us']:.1f})")
    # the long-context row: the same 256-token span, suffixes of 240-256
    # tokens (each row spans two of the branch pass's key splits)
    long_groups = [(16, (span + torch.randint(240, 257, (8,),
                                               generator=rng)).tolist())
                   for _ in range(2)]
    q, kp, vp, rg, sbt, sl, bbt, ln = k3_inputs(
        torch, gen, dev, groups=long_groups, singles=[],
        dtype=torch.bfloat16, **r1)
    suffix = [n - span for n in ln.tolist()]
    part, split_keys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln,
                                             span)
    kb = gather_pages(kp, bbt).nan_to_num()
    vb = gather_pages(vp, bbt).nan_to_num()
    mask = (torch.arange(kb.shape[2], device=dev)[None, :]
            < torch.tensor(suffix, device=dev)[:, None])[:, None, None, :]
    bytes_, ops = branch_bytes_ops(suffix)
    branch["long"] = {
        **kernel_ms(torch, lambda: paged_tree_branch_fwd(
            q, kp, vp, rg, sl, bbt, ln, part, split_keys)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True)),
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": f"B=16 in 2 groups of 8 over a 256-token span, suffixes "
                 f"{min(suffix)}..{max(suffix)} tokens, H=40 kv=8 hd=128 "
                 f"ps=16 W=32 bf16, {k1_splits(torch, ps, r1['width'])}",
    }
    print("[kernels] K3 branch long-context row: "
          + json.dumps(branch["long"]))
    return errs, {"paged_tree_shared": shared, "paged_tree_branch": branch}


def ssd_inputs(torch, gen, dev, *, b, s, h, p, n, dtype, state=False):
    """Seeded SSD scan operands: x, b, c ~ N(0, 1) in ``dtype``, dt in
    [0.01, 0.2) and a in (-2, -0.5] fp32 (the reference kernel tests'
    ranges), and an initial state ~ N(0, 1) or None."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
    init = randn(b, h, p, n) if state else None
    return randn(b, s, h, p), dt, a, randn(b, s, h, n), randn(b, s, h, n), \
        init


def ssd_flops(seqlen: int, heads: int, head_dim: int, state_dim: int,
              chunk: int) -> int:
    """Operations (2 per multiply-add) the chunked scan needs for one row
    of ``seqlen`` positions: per chunk of q rows the causal half of C·Bᵀ
    and of gate·X, then C·S_prev and the state update, q·N·P each."""
    total = 0
    for c0 in range(0, seqlen, chunk):
        q = min(chunk, seqlen - c0)
        tri = q * (q + 1) // 2
        total += tri * (state_dim + head_dim) + 2 * q * state_dim * head_dim
    return 2 * heads * total


SSD_TOL = {"bf16": 2e-2, "fp32": 1e-4}   # atol = rtol (K4, see below)


def phase_ssd_kernels(torch):
    """Hold K4 (the SSD chunked scan, state in and out) against its plain
    version ``ssd_chunked`` on the same inputs, y and final state. The
    plain version runs in fp32 on the (bf16-rounded) inputs, the
    arithmetic K4 does: fp32 to 1e-4 because each output sums up to
    Q·N = 16,384 products in another order; bf16 to 2e-2, the rounding of
    K4's bf16 outputs. The plain version run in bf16 (rounding gate and
    chunk states as the reference does) is printed beside, ungated.
    Returns the results for the JSON line, timed at phase 8's lane
    shape."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(4)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    errs = []

    def compare(name, out, ref, dn, exact=False):
        tol = SSD_TOL[dn]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        ok = bool(torch.isfinite(out.float()).all()) and (
            bool((out == ref).all()) if exact else torch.allclose(
                out.float(), ref.float(), atol=tol, rtol=tol))
        print(f"[kernels] {name}: max_abs_err {err:.3e} "
              f"({'bit-exact' if exact else f'atol=rtol={tol}'}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} disagrees with its plain version")
        errs.append(err)

    def plain32(x, dt, a, b, c, chunk, init, valid=None):
        return ssd_chunked(x.float(), dt, a, b.float(), c.float(), chunk,
                           init.float() if init is not None else None, valid)

    # (name, batch, S, H, P, N, chunk): phase 8's lanes (mamba2-130m, S in
    # a 32- or 64-row bucket under chunk 128), a hymba-1.5b-width lane
    # (50 heads of 64, N=16), the reference kernel tests' shapes
    cases = [("mamba2 1 lane", 1, 64, 24, 64, 128, 128),
             ("mamba2 4 lanes", 4, 64, 24, 64, 128, 128),
             ("mamba2 bucket 32", 1, 32, 24, 64, 128, 128),
             ("hymba widths", 2, 64, 50, 64, 16, 128),
             ("ref 2x32x3 p16 n8 q8", 2, 32, 3, 16, 8, 8),
             ("ref 1x64x2 p32 n16 q16", 1, 64, 2, 32, 16, 16),
             ("ref 2x40x4 p8 n4 q16", 2, 40, 4, 8, 4, 16),
             ("ref 1x16x1 p64 n32 q4", 1, 16, 1, 64, 32, 4),
             ("non-divisible S=13 q8", 1, 13, 2, 8, 4, 8)]
    for name, b, s, h, p, n, q in cases:
        for dn, dt_ in dtypes.items():
            for state in (False, True):
                x, dt, a, bb, cc, init = ssd_inputs(
                    torch, gen, dev, b=b, s=s, h=h, p=p, n=n, dtype=dt_,
                    state=state)
                y, fin = ssd_scan(x, dt, a, bb, cc, chunk=q,
                                  initial_state=init)
                y_r, fin_r = plain32(x, dt, a, bb, cc, q, init)
                torch.cuda.synchronize()
                tag = f"K4 {name} {dn}{' +state' if state else ''}"
                compare(f"{tag} y", y, y_r, dn)
                compare(f"{tag} final state", fin, fin_r, dn)
                if dn == "bf16" and name == "mamba2 1 lane" and state:
                    y_b, fin_b = ssd_chunked(x, dt, a, bb, cc, q, init)
                    e_y = float((y.float() - y_b.float()).abs().max())
                    e_s = float((fin.float() - fin_b.float()).abs().max())
                    print(f"[kernels] {tag}: against the plain version in "
                          f"bf16: max_abs_err y {e_y:.3e}, state {e_s:.3e} "
                          "(not gated)")
    # masked dt: each row's valid prefix gives the unpadded scan's
    # outputs and final state; an all-invalid row returns its state
    # bit-identical (dt = 0 is an exact identity)
    for dn, dt_ in dtypes.items():
        for vl in (1, 7, 11, 16):
            x, dt, a, bb, cc, init = ssd_inputs(
                torch, gen, dev, b=2, s=16, h=2, p=8, n=4, dtype=dt_,
                state=True)
            valid = torch.arange(16, device=dev)[None, :] < vl
            y, fin = ssd_scan(x, dt * valid[..., None], a, bb, cc, chunk=8,
                              initial_state=init)
            y_u, fin_u = plain32(x[:, :vl], dt[:, :vl], a, bb[:, :vl],
                                 cc[:, :vl], 8, init)
            compare(f"K4 valid_len={vl} {dn} y", y[:, :vl], y_u, dn)
            compare(f"K4 valid_len={vl} {dn} final state", fin, fin_u, dn)
        x, dt, a, bb, cc, init = ssd_inputs(
            torch, gen, dev, b=2, s=24, h=24, p=64, n=128, dtype=dt_,
            state=True)
        _, fin = ssd_scan(x, torch.zeros_like(dt), a, bb, cc, chunk=128,
                          initial_state=init)
        compare(f"K4 all-invalid rows {dn} final state", fin, init, dn,
                exact=True)

    # lanes are independent and the kernel deterministic: 4 lanes in one
    # launch give each lane's result alone, bit for bit
    x, dt, a, bb, cc, init = ssd_inputs(
        torch, gen, dev, b=4, s=64, h=24, p=64, n=128, dtype=torch.bfloat16,
        state=True)
    y, fin = ssd_scan(x, dt, a, bb, cc, chunk=128, initial_state=init)
    y1, fin1 = ssd_scan(x[2:3], dt[2:3], a, bb[2:3], cc[2:3], chunk=128,
                        initial_state=init[2:3])
    compare("K4 lane 3 of 4 vs alone bf16 y", y[2:3], y1, "bf16", exact=True)
    compare("K4 lane 3 of 4 vs alone bf16 final state", fin[2:3], fin1,
            "bf16", exact=True)

    # timing at phase 8's lane shape: one lane of a 32-row bucket (an
    # 11-17-token prompt), mamba2-130m's widths, a zero start, bf16
    b, s, h, p, n, q = 1, 32, 24, 64, 128, 128
    x, dt, a, bb, cc, _ = ssd_inputs(torch, gen, dev, b=b, s=s, h=h, p=p,
                                     n=n, dtype=torch.bfloat16)
    valid = torch.arange(s, device=dev)[None, :] < 17
    dtm = dt * valid[..., None]
    state_bytes = b * h * p * n * 2
    timing = {
        **kernel_ms(torch, lambda: ssd_scan(x, dtm, a, bb, cc, chunk=q)),
        "plain_ms": time_ms(torch, lambda: ssd_chunked(x, dt, a, bb, cc, q,
                                                       valid=valid)),
        "library_ms": None,
        # x, b, c, dt, a in; y and the final state out (the zero start is
        # not read)
        "bytes": x.numel() * 2 * 2 + bb.numel() * 2 * 2 + dt.numel() * 4
        + a.numel() * 4 + state_bytes,
        # the scan over the valid rows only (masked rows are identity
        # transitions whose products are all zero)
        "ops": b * ssd_flops(17, h, p, n, q),
        "shape": f"B=1 S={s} (17 valid) H={h} P={p} N={n} chunk {q} bf16",
    }
    return {"ssd_scan": errs}, {"ssd_scan": timing}


def flash_flops(seqlen: int, heads: int, head_dim: int, causal: bool,
                true_len=None) -> int:
    """Operations K5 needs: 4 hd per (query row, visible key) pair and
    head (Q·Kᵀ and P·V, 2 per multiply-add), over the rows before
    ``true_len``: S(S+1)/2 pairs causal, S·S not."""
    n = seqlen if true_len is None else true_len
    pairs = n * (n + 1) // 2 if causal else n * n
    return 4 * head_dim * heads * pairs


def phase_flash_kernels(torch):
    """Hold K5 (the dense flash prefill) against its plain version on the
    same inputs, bf16 (the wgmma kernel) and fp32 (the CUDA-core kernel):
    r1-distill-14b's exact-prefill shape at S = 272 and 4096, a qwen2-0.5b
    shape (14/2 heads of 64), head_dim 32, GQA groups 1 and 8,
    non-divisible S, non-causal, and ``true_len`` (rows past it bit-exact
    zeros; K and V past it NaN, which must not change one bit of the
    output), once at S = 1000 so the key loop wraps the TMA ring. Then
    time it at S = 272 and 4096 beside its plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls).
    Returns (errors, timings, the S = 4096 timing)."""
    from repro_torch.kernels.flash_prefill.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(5)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    errs = []

    def inputs(b, s, h, kv, hd, dtype):
        return [torch.randn((b, s, n, hd), generator=gen, device=dev).to(dtype)
                for n in (h, kv, kv)]

    # (name, B, S, H, Hkv, hd, causal, true_len)
    cases = [("r1 S=272", 1, 272, 40, 8, 128, True, None),
             ("r1 S=4096", 1, 4096, 40, 8, 128, True, None),
             ("qwen2 S=272", 1, 272, 14, 2, 64, True, None),
             ("hd32 S=100", 2, 100, 4, 2, 32, True, None),
             ("group1 S=37", 2, 37, 4, 4, 64, True, None),
             ("group8 S=130", 1, 130, 64, 8, 128, True, None),
             ("r1 non-causal S=272", 1, 272, 40, 8, 128, False, None),
             ("hd32 non-causal S=37", 2, 37, 4, 2, 32, False, None),
             ("r1 true_len=200 S=272", 1, 272, 40, 8, 128, True, 200),
             ("non-causal true_len=13 S=48", 2, 48, 6, 3, 64, False, 13),
             # 16 key tiles through the TMA ring, the last one partial
             ("r1 true_len=997 S=1000", 1, 1000, 40, 8, 128, True, 997)]
    for name, b, s, h, kv, hd, causal, tl in cases:
        for dn, dt in dtypes.items():
            q, k, v = inputs(b, s, h, kv, hd, dt)
            out = flash_prefill(q, k, v, causal, tl)
            ref = flash_prefill_ref(q, k, v, causal, tl)
            torch.cuda.synchronize()
            errs.append(_compare(torch, f"K5 {name} {dn}", out, ref, dn))
            if tl is not None:
                check(bool((out[:, tl:] == 0).all()),
                      "K5 rows past true_len are not exact zeros")
                kp, vp = k.clone(), v.clone()
                kp[:, tl:] = float("nan")
                vp[:, tl:] = float("nan")
                check(torch.equal(flash_prefill(q, kp, vp, causal, tl), out),
                      "K5 read K/V past true_len")
            del q, k, v, out, ref

    timing = {}
    for s in (272, 4096):
        h, kv, hd = 40, 8, 128
        q, k, v = inputs(1, s, h, kv, hd, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, hd]
        timing[s] = {
            **kernel_ms(torch, lambda: flash_prefill(q, k, v)),
            "plain_ms": time_ms(torch, lambda: flash_prefill_ref(q, k, v),
                                n=10 if s > 1024 else 50),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
            # q, k, v in once, o out once
            "bytes": 2 * (2 * h + 2 * kv) * s * hd,
            "ops": flash_flops(s, h, hd, True),
            "shape": f"B=1 S={s} H=40 kv=8 hd=128 causal bf16",
        }
        del q, k, v, qt, kt, vt
    return {"flash_prefill": errs}, {"flash_prefill": timing[272]}, \
        timing[4096]


def _parity_scenario(torch, eng, vocab: int):
    """A cold request (a 16-token header + its own 21 tokens, a partial
    last page) forks 3 branches that decode 6 steps (CoW of the shared
    page); a mid-generation fork joins them and the second branch is
    suspended for 2 steps, then resumed; then a warm request sharing the
    header rides the decode steps as a chunk lane and forks 2 more
    branches; 6 more steps. SSM states travel with every prefill. Returns
    (tokens of every branch, both prefill logits, live rows' hidden, the
    warm request's cached tokens, the branches' final (conv, ssd) rows or
    [])."""
    header = [int(x) for x in (np.arange(16) * 7 + 3) % vocab]
    cold = header + [int(x) for x in (np.arange(21) * 5 + 1) % vocab]
    warm = header + [int(x) for x in (np.arange(9) * 11 + 2) % vocab]
    blocks, lg_cold, ssm_cold = eng.prefill(cold)
    hs = [eng.spawn_branch(0, blocks, lg_cold, ssm_cold, len(cold),
                           prompt_tokens=cold) for _ in range(3)]
    for _ in range(6):
        eng.decode_step()
    hs.append(eng.fork_branch(hs[0]))
    eng.suspend_branch(hs[1])
    for _ in range(2):
        eng.decode_step()
    check(eng.resume_branch(hs[1]), "a suspended branch found no slot")
    st = eng.begin_prefill(warm)
    while not st.done:
        eng.decode_step()
    b2, lg_warm, ssm_warm = eng.finish_prefill(st)
    hs += [eng.spawn_branch(1, b2, lg_warm, ssm_warm, len(warm),
                            prompt_tokens=warm) for _ in range(2)]
    for _ in range(6):
        eng.decode_step()
    slots = [h.slot for h in hs]
    states = ([eng.state[k][:, slots].float().cpu() for k in ("conv", "ssd")]
              if eng.model.cfg.uses_ssm else [])
    out = ([h.tokens for h in hs],
           torch.stack([lg_cold.float().cpu(), lg_warm.float().cpu()]),
           eng._last_hidden[slots].float().cpu(), st.cached_tokens, states)
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    eng.release_prefix(b2)
    check(eng.allocator.used_pages == 0, "parity engine leaked pages")
    eng.allocator.check_invariants()
    return out


def _tiny_family(arch: str):
    """The tests' ssm/hybrid widths (``tests/conftest.py`` FAMILY_CONFIGS):
    2 layers, d_model 64, 4 SSD heads of 32, state 16, chunk 8; the
    hybrid's 4/2 attention heads are 64 wide (the tests' 16 is below the
    64 or 128 that K1-K3 take)."""
    from repro_torch.models import ModelConfig
    attn = dict(d_ff=0) if arch == "ssm" else dict(d_ff=128, head_dim=64)
    return ModelConfig(name=f"tiny-{arch}", arch_type=arch, num_layers=2,
                       d_model=64, vocab_size=97, num_heads=4,
                       num_kv_heads=2, ssm_state=16, ssm_head_dim=32,
                       ssm_chunk=8, **attn)


def phase_parity(torch):
    """The engine with the kernels on the card against the engine with the
    plain versions on the CPU: same fp32 weights, greedy decoding. Dense
    (r1-distill-14b's smoke widths): per-branch decode (K1) with the cache
    off, then the prefix cache and tree decode (K3) on. ssm and hybrid
    (the tests' widths): the chunk lanes' scan is K4; the hybrid runs again
    with the cache (the warm request seeded from a page-aligned boundary
    snapshot) and the tree on, K1-K4 in one engine."""
    from repro_torch.configs import smoke
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import tree_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import Model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cache_tree = {"prefix_cache": True, "decode_kernel": "tree"}
    exact = {"chunked_prefill": False}
    for cfg, extras in ((smoke("r1-distill-14b"), ({}, cache_tree, exact)),
                        (_tiny_family("ssm"), ({}, exact)),
                        (_tiny_family("hybrid"), ({}, cache_tree, exact))):
        cpu_model = Model(cfg, device="cpu")
        params = cpu_model.init_params(torch.Generator().manual_seed(0))
        gpu_model = Model(cfg, device=DEVICE)
        gpu_params = {k: _to(v, DEVICE) for k, v in params.items()}
        gpu_model.load_params(gpu_params)
        for extra in extras:
            ecfg = EngineConfig(page_size=4, num_pages=64, max_slots=6,
                                max_pages_per_branch=24, prefill_chunk=16,
                                sampling=SamplingParams(temperature=0.0),
                                **extra)
            runs = []
            for model, p in ((cpu_model, params), (gpu_model, gpu_params)):
                eng = Engine(model, p, ecfg)
                tree_decode.branch_launches = 0
                ssd_scan.launches = 0
                flash_prefill.launches = 0
                runs.append(_parity_scenario(torch, eng, cfg.vocab_size))
                stats = eng.prefix_cache_stats()
            (t_cpu, l_cpu, h_cpu, c_cpu, s_cpu), \
                (t_gpu, l_gpu, h_gpu, c_gpu, s_gpu) = runs
            err = max([float((l_cpu - l_gpu).abs().max()),
                       float((h_cpu - h_gpu).abs().max())]
                      + [float((a - b).abs().max())
                         for a, b in zip(s_cpu, s_gpu)])
            ok = t_cpu == t_gpu and err <= 1e-4 and c_cpu == c_gpu
            name = cfg.arch_type + ": " + (", ".join(
                f"{k}={v}" for k, v in extra.items()) or "defaults")
            print(f"[parity] {name}: greedy tokens equal: {t_cpu == t_gpu}; "
                  f"max abs err of prefill logits / hidden"
                  f"{' / (conv, ssd) state' if s_cpu else ''} {err:.3e} "
                  f"(atol 1e-4); warm request cached tokens {c_gpu}; K4 "
                  f"launches {ssd_scan.launches}; K5 launches "
                  f"{flash_prefill.launches}; {'ok' if ok else 'FAIL'}")
            check(ok, f"engine on the card disagrees with the CPU engine "
                      f"({name})")
            if cfg.uses_ssm:
                check(ssd_scan.launches > 0,
                      f"the {name} parity run never launched K4")
            if extra is cache_tree:
                check(c_gpu > 0 and stats["hit_tokens"] > 0,
                      "the warm request missed the prefix cache")
                check(tree_decode.branch_launches > 0,
                      "the tree parity run never launched K3")
            if extra is exact:
                # two exact admissions, one K5 launch per attention layer
                check(flash_prefill.launches == 2 * cfg.num_layers
                      if cfg.uses_attention else flash_prefill.launches == 0,
                      f"the exact parity run launched K5 "
                      f"{flash_prefill.launches} times")
    _model_parity(torch)
    _fallback_trunks(torch)


def _model_parity(torch):
    """``Model.prefill`` + ``decode_step`` over the dense cache on the card
    against the CPU, fp32, greedy: r1-distill-14b's smoke widths (K5 in
    every layer of the prefill) and the same with an 8-token sliding
    window (a ring cache, the ported ``_attend``), a 20-token prompt and
    8 steps."""
    from repro_torch.configs import smoke
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models import Model
    base = smoke("r1-distill-14b")
    prompt = [int(x) for x in (np.arange(20) * 7 + 3) % base.vocab_size]
    for name, cfg in (("dense", base),
                      ("swa", base.replace(sliding_window=8))):
        runs = []
        for dev in ("cpu", DEVICE):
            model = Model(cfg, device=dev)
            params = model.init_params(torch.Generator().manual_seed(0)) \
                if dev == "cpu" else _to(runs[0][2], dev)
            model.load_params(params)
            flash_prefill.launches = 0
            lg, cache = model.prefill(
                params, tokens=torch.tensor([prompt], device=dev),
                max_len=len(prompt) + 8)
            first, toks, pos = lg.float().cpu(), [], len(prompt)
            cur = int(torch.argmax(lg[0]))
            for _ in range(8):
                toks.append(cur)
                lg, cache, _ = model.decode_step(
                    params, torch.tensor([cur], device=dev), cache,
                    torch.tensor([pos], device=dev))
                cur, pos = int(torch.argmax(lg[0])), pos + 1
            runs.append((toks, first, params, flash_prefill.launches))
        (t_cpu, l_cpu, _, _), (t_gpu, l_gpu, _, k5) = runs
        err = float((l_cpu - l_gpu).abs().max())
        want_k5 = 0 if cfg.sliding_window else cfg.num_layers
        ok = t_cpu == t_gpu and err <= 1e-4 and k5 == want_k5
        print(f"[parity] Model {name}: greedy tokens equal: "
              f"{t_cpu == t_gpu}; max abs err of prefill logits {err:.3e} "
              f"(atol 1e-4); K5 launches {k5}; {'ok' if ok else 'FAIL'}")
        check(ok, f"Model.prefill/decode_step on the card disagree with "
                  f"the CPU ({name})")


def _fallback_trunks(torch):
    """The serve launcher's untrained dense and hybrid fallback trunks
    (32-wide attention heads, K1/K2 at head_dim 32) serve on the card."""
    from repro_torch.launch.serve import load_reasoner, run_serving
    for arch in ("dense", "hybrid"):
        model, params, prm = load_reasoner(None, device=DEVICE, arch=arch)
        out, engine = run_serving(
            model, params, prm, policy="sart", n=4, num_requests=3,
            rate_gap=4, prm_kind="oracle", window=8, max_tokens=32,
            max_slots=8, seed=0, temperature=0.9)
        ok = (out["completed_requests"] == 3
              and out["faults"]["step_faults"] == 0
              and engine.allocator.used_pages == 0)
        print(f"[parity] serve fallback --arch {arch} (head_dim "
              f"{model.cfg.resolved_head_dim}) on the card: "
              f"{out['completed_requests']}/3 requests, "
              f"{engine.decode_steps_executed} steps; "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"the {arch} fallback trunk failed to serve on the card")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import Model
    cfg = get_config("r1-distill-14b")
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params bf16, "
          f"random weights in {time.perf_counter() - t0:.1f} s")

    paged_attention.launches = 0
    paged_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, engine = run_serving(
        model, params, None, policy="sart", n=8, num_requests=4, rate_gap=8,
        prm_kind="oracle", window=8, max_tokens=96, max_slots=16, seed=0,
        temperature=0.9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches}

    steps = sorted(engine.step_seconds)
    p50 = steps[len(steps) // 2] if steps else float("nan")
    faults = out["faults"]
    line = {
        "completed_requests": out["completed_requests"],
        "unfinished_requests": out["unfinished_requests"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(p50 * 1e3, 3),
        "step_ms_mean": round(sum(steps) / max(len(steps), 1) * 1e3, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "k1_launches": launches["paged_decode"],
        "k2_launches": launches["paged_prefill"],
        "e2e_p50_steps": out["p50"], "ttfb50_steps": out["ttfb50"],
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
    }
    print("[serve] " + json.dumps(line))
    check(out["completed_requests"] == 4 and out["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the serve run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    return model, params, launches


def few_shot_header(n_tokens: int, seed: int):
    """Seeded solved problems rendered as traces (EOS dropped), joined
    and cut to ``n_tokens``: the shared few-shot header of phase 6."""
    from repro_torch.data import tasks
    from repro_torch.data import tokenizer as tk
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_tokens:
        out += [t for t in tasks.render_trace(tasks.gen_problem(rng), rng)
                if t != tk.EOS]
    return out[:n_tokens]


def _serve_shared_header(torch, model, params, decode_kernel: str):
    """One serve of phase 6's traffic with the prefix cache on: 4
    requests every 8 steps, each prompt a 256-token few-shot header (16
    whole pages) and then the request's own problem. The run_serving
    config otherwise (4096 x 16 pages, 16 slots, 32 pages per branch,
    chunk 64; SART n=8, window 8, max 96 tokens, OraclePRM noise 0.05),
    built here so the launcher gains no feature the reference lacks.
    Launch counters are zeroed just before the run and read just after.
    Returns (summary line, launches)."""
    from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
    from repro_torch.core.scheduler import percentile_latency
    from repro_torch.data import tasks
    from repro_torch.data import tokenizer as tk
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    gc.collect()                 # the previous engine and its KV pools
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    seed = 0
    prompts, probs = _shared_header_prompts(seed)
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, params, EngineConfig(
        page_size=16, num_pages=4096, max_slots=16, max_pages_per_branch=32,
        eos_id=tk.EOS, sampling=SamplingParams(temperature=0.9, top_p=0.95),
        seed=seed, prefix_cache=True, decode_kernel=decode_kernel))
    prm = OraclePRM(tasks.oracle_grader, noise=0.05, seed=seed + 1)
    sch = Scheduler(engine, prm, SchedulerConfig(policy="sart", n=8,
                                                 window=8, max_tokens=96),
                    answer_fn=tasks.extract_answer)
    for i, (prompt, prob) in enumerate(zip(prompts, probs)):
        sch.submit(prompt, payload=prob, arrival=i * 8)

    paged_attention.launches = 0
    paged_prefill.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    t0 = time.perf_counter()
    metrics = sch.run(max_steps=2_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches}

    steps = sorted(engine.step_seconds)
    faults = metrics["faults"]
    stats = engine.prefix_cache_stats()
    line = {
        "decode_kernel": decode_kernel,
        "completed_requests": metrics["completed_requests"],
        "unfinished_requests": metrics["unfinished_requests"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "step_ms_mean": round(sum(steps) / len(steps) * 1e3, 3),
        "mem_held_before_gb": round(held, 2),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "launches": launches,
        "prefix_cache": stats,
        "cached_tokens": [r["cached_tokens"] for r in metrics["requests"]],
        "e2e_p50_steps": percentile_latency(metrics, 50),
        "ttfb50_steps": percentile_latency(metrics, 50, "ttfb"),
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
    }
    print("[serve-tree] " + json.dumps(line))
    check(metrics["completed_requests"] == 4
          and metrics["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(stats["hit_tokens"] > 0 and stats["hit_rate"] > 0,
          "the shared header never hit the prefix cache")
    return line, launches


def phase_tree_serve(torch, model, params):
    """Phase 6: the shared-header traffic with tree decode (the path,
    whose launches are counted), then the same traffic with per-branch
    decode for the step-time comparison inside this one call."""
    line, launches = _serve_shared_header(torch, model, params, "tree")
    check(launches["paged_decode"] == 0, "K1 launched in the tree run")
    check(launches["paged_tree_branch"]
          == model.cfg.num_layers * line["decode_steps"],
          "K3's branch pass did not carry every decode step")
    check(launches["paged_tree_shared"] > 0
          and launches["paged_prefill"] > 0,
          f"a kernel of the tree path never launched: {launches}")
    paged, _ = _serve_shared_header(torch, model, params, "paged")
    print(f"[serve-tree] step p50 tree {line['step_ms_p50']} ms vs paged "
          f"{paged['step_ms_p50']} ms on the same traffic "
          f"({line['step_ms_p50'] / paged['step_ms_p50'] - 1:+.1%})")
    return launches, paged["step_ms_p50"]


def _shared_header_prompts(seed: int = 0):
    """Phase 6's 4 prompts: the 256-token few-shot header, then each
    request's own problem (267-273 tokens in all), with the problems."""
    from repro_torch.data import tasks
    header = few_shot_header(256, seed=seed + 3)
    rng = np.random.default_rng(seed + 2)
    probs = [tasks.gen_problem(rng) for _ in range(4)]
    return [header + p.prompt_tokens() for p in probs], probs


def phase_exact_serve(torch, model, params, paged_p50: float):
    """Phase 7: phase 6's traffic (4 requests every 8 steps, 256-token
    shared header + problem) on the same weights with
    ``chunked_prefill=False``: the cache off, per-branch decode, phase 5's
    config otherwise. Every admission is one synchronous exact-length pass
    (K5 in each of the 48 layers), every decode row K1, no chunk lane (K2
    0). Then ``Model.prefill`` of one seeded 4,096-token prompt (K5 48
    times) and 8 ``decode_step``s over its dense cache, and the first
    token's logits of one prompt by exact against chunked admission
    (printed, not gated in bf16). Returns the K5 launches of the serve."""
    from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
    from repro_torch.core.scheduler import percentile_latency
    from repro_torch.data import tasks
    from repro_torch.data import tokenizer as tk
    from repro_torch.kernels.flash_prefill import flash_prefill, paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    gc.collect()                 # phase 6's engines and their KV pools
    torch.cuda.empty_cache()
    L = model.cfg.num_layers
    seed = 0
    prompts, probs = _shared_header_prompts(seed)
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, params, EngineConfig(
        page_size=16, num_pages=4096, max_slots=16, max_pages_per_branch=32,
        eos_id=tk.EOS, sampling=SamplingParams(temperature=0.9, top_p=0.95),
        seed=seed, chunked_prefill=False))
    prefill_s = []
    begin = engine.begin_prefill

    def timed_begin(prompt):     # the synchronous admission, device-synced
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = begin(prompt)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return st
    engine.begin_prefill = timed_begin
    prm = OraclePRM(tasks.oracle_grader, noise=0.05, seed=seed + 1)
    sch = Scheduler(engine, prm, SchedulerConfig(policy="sart", n=8,
                                                 window=8, max_tokens=96),
                    answer_fn=tasks.extract_answer)
    for i, (prompt, prob) in enumerate(zip(prompts, probs)):
        sch.submit(prompt, payload=prob, arrival=i * 8)

    paged_attention.launches = 0
    paged_prefill.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    flash_prefill.launches = 0
    t0 = time.perf_counter()
    metrics = sch.run(max_steps=2_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches,
                "flash_prefill": flash_prefill.launches}
    steps = sorted(engine.step_seconds)
    faults = metrics["faults"]
    line = {
        "completed_requests": metrics["completed_requests"],
        "unfinished_requests": metrics["unfinished_requests"],
        "prompt_tokens": [len(p) for p in prompts],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "exact_prefills": engine.exact_prefills,
        "clock": metrics["clock"],
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "step_ms_mean": round(sum(steps) / len(steps) * 1e3, 3),
        "paged_step_ms_p50_phase6": paged_p50,
        "prefill_ms": [round(t * 1e3, 3) for t in prefill_s],
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "launches": launches,
        "e2e_p50_steps": percentile_latency(metrics, 50),
        "ttfb50_steps": percentile_latency(metrics, 50, "ttfb"),
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
    }
    check(metrics["completed_requests"] == 4
          and metrics["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(launches["flash_prefill"] == L * 4 and launches["paged_prefill"]
          == 0 and launches["paged_decode"] > 0
          and engine.mixed_steps_executed == 0,
          f"the exact path's kernels: {launches}")
    del engine, sch
    gc.collect()
    torch.cuda.empty_cache()

    # exact against chunked admission of the first prompt: first-token
    # logits (bf16, different kernels and sums: printed, not gated)
    small = dict(page_size=16, num_pages=64, max_slots=2,
                 max_pages_per_branch=32,
                 sampling=SamplingParams(temperature=0.0))
    logits = []
    for chunked in (False, True):
        eng = Engine(model, params, EngineConfig(chunked_prefill=chunked,
                                                 **small))
        blocks, lg, _ = eng.prefill(prompts[0])
        logits.append(lg.float())
        eng.release_prefix(blocks)
        del eng
    line["exact_vs_chunked_logits_max_abs"] = float(
        (logits[0] - logits[1]).abs().max())
    line["exact_vs_chunked_argmax_equal"] = bool(
        int(logits[0].argmax()) == int(logits[1].argmax()))

    # Model.prefill of a 4,096-token prompt, then 8 decode steps
    gen = torch.Generator().manual_seed(seed + 5)
    toks = torch.randint(2, model.cfg.vocab_size, (1, 4096), generator=gen)
    toks = toks.to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    flash_prefill.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, tokens=toks, max_len=4104)
    torch.cuda.synchronize()
    prefill_4096 = time.perf_counter() - t0
    k5_4096 = flash_prefill.launches
    finite = bool(torch.isfinite(lg.float()).all())
    cur, dec = lg.argmax(-1), []
    for pos in range(4096, 4104):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, _ = model.decode_step(
            params, cur, cache, torch.tensor([pos], device=DEVICE))
        cur = lg.argmax(-1)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(lg.float()).all())
    line["model_prefill_4096"] = {
        "prefill_ms": round(prefill_4096 * 1e3, 3),
        "decode_step_ms_p50": round(sorted(dec)[len(dec) // 2] * 1e3, 3),
        "k5_launches": k5_4096,
        "cache_gb": round(sum(t.numel() * t.element_size()
                              for t in cache.values()) / 1e9, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
    print("[serve-exact] " + json.dumps(line))
    print(f"[serve-exact] step p50 exact {line['step_ms_p50']} ms vs phase "
          f"6 paged {paged_p50} ms "
          f"({line['step_ms_p50'] / paged_p50 - 1:+.1%})")
    check(k5_4096 == L, f"Model.prefill launched K5 {k5_4096} times")
    check(finite, "non-finite logits from Model.prefill/decode_step")
    del cache, lg
    return launches["flash_prefill"]


def phase_ssm_serve(torch):
    """Phase 8: mamba2-130m at full width and depth (24 layers, d_model
    768, 24 SSD heads of 64, state 128, chunk 128, vocab 50280), bf16,
    random weights from a seed, behind the SART scheduler through
    ``run_serving`` (4 requests, n=8). Every chunk lane's scan is K4, one
    launch per layer per mixed step; no attention kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import Model
    gc.collect()                 # phase 6's model, engines and pools
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-130m")
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve-ssm] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, "
          f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
          f"{cfg.param_count() / 1e9:.3f} B params bf16, random weights in "
          f"{time.perf_counter() - t0:.1f} s")

    paged_attention.launches = 0
    paged_prefill.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, engine = run_serving(
        model, params, None, policy="sart", n=8, num_requests=4, rate_gap=8,
        prm_kind="oracle", window=8, max_tokens=96, max_slots=16, seed=0,
        temperature=0.9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches,
                "ssd_scan": ssd_scan.launches}

    steps = sorted(engine.step_seconds)
    faults = out["faults"]
    line = {
        "completed_requests": out["completed_requests"],
        "unfinished_requests": out["unfinished_requests"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "step_ms_mean": round(sum(steps) / len(steps) * 1e3, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "launches": launches,
        "e2e_p50_steps": out["p50"], "ttfb50_steps": out["ttfb50"],
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
    }
    print("[serve-ssm] " + json.dumps(line))
    check(out["completed_requests"] == 4 and out["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(launches["ssd_scan"] > 0 and launches["ssd_scan"]
          == cfg.num_layers * engine.mixed_steps_executed,
          f"K4 did not carry every mixed step's layers: {launches}")
    check(all(launches[k] == 0 for k in launches if k != "ssd_scan"),
          f"an attention kernel launched in the ssm serve: {launches}")
    return launches


def phase_tree_pairs(torch, pairs: int) -> None:
    """Phase 6's traffic on r1-distill-14b (bf16, random weights from a
    seed) served with tree and with per-branch decode in alternating
    order (tree, paged, paged, tree, ...) after one discarded warm-up run
    of each, so that a drift of the host's speed during the call falls on
    both alike. Prints each run's step p50 and tokens/s and the tree/paged
    step p50 ratio of each pair."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config("r1-distill-14b"), dtype=torch.bfloat16,
                  device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    for kind in ("paged", "tree"):
        _serve_shared_header(torch, model, params, kind)
    runs = {"tree": [], "paged": []}
    for i in range(pairs):
        for kind in (("tree", "paged") if i % 2 == 0 else ("paged", "tree")):
            line, _ = _serve_shared_header(torch, model, params, kind)
            runs[kind].append((line["step_ms_p50"], line["tokens_per_s"]))
    ratios = [t[0] / p[0] for t, p in zip(runs["tree"], runs["paged"])]
    print("[tree-pairs] " + json.dumps({
        "step_ms_p50": {k: [r[0] for r in v] for k, v in runs.items()},
        "tokens_per_s": {k: [r[1] for r in v] for k, v in runs.items()},
        "tree_over_paged": [round(r, 4) for r in ratios]}))


def _step_stats(engine, wall: float) -> dict:
    steps = sorted(engine.step_seconds)
    return {"decode_steps": engine.decode_steps_executed, "wall_s": wall,
            "step_ms_p50": steps[len(steps) // 2] * 1e3,
            "step_ms_mean": sum(steps) * 1e3 / len(steps)}


def phase_profile(torch, out_dir: Path) -> None:
    """The serve phases' traffic (4 requests, n=8, 96 tokens) on
    r1-distill-14b (phase 5) and on mamba2-130m (phase 8), each served
    twice: once plain, for step times, then under torch.profiler tracing
    device activity only (no host ops, so the trace adds little to the
    host side), for device time by kernel and the device's busy share of
    that run's own wall time. The tables go to
    ``out_dir/profile_serve.txt`` and ``out_dir/profile_serve_ssm.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import Model
    kw = dict(policy="sart", n=8, num_requests=4, rate_gap=8,
              prm_kind="oracle", window=8, max_tokens=96, max_slots=16,
              seed=0, temperature=0.9)
    out_dir.mkdir(parents=True, exist_ok=True)
    for arch, fname in (("r1-distill-14b", "profile_serve.txt"),
                        ("mamba2-130m", "profile_serve_ssm.txt")):
        gc.collect()
        torch.cuda.empty_cache()
        model = Model(get_config(arch), dtype=torch.bfloat16, device=DEVICE)
        params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
        t0 = time.perf_counter()
        _, engine = run_serving(model, params, None, **kw)
        torch.cuda.synchronize()
        plain = _step_stats(engine, time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, engine = run_serving(model, params, None, **kw)
            torch.cuda.synchronize()
            traced = _step_stats(engine, time.perf_counter() - t0)
        events = prof.key_averages()
        # one stream, so kernels never overlap and their sum is busy time
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.is_user_annotation)
        traced["device_busy_s"] = device_us / 1e6
        traced["device_busy_share"] = device_us / 1e6 / traced["wall_s"]
        table = events.table(sort_by="self_device_time_total", row_limit=30,
                             max_name_column_width=90)
        (out_dir / fname).write_text(table)
        print(table)
        print("[profile] " + json.dumps({"model": arch, "untraced": plain,
                                         "traced": traced}))
        del model, params, engine, prof, events


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel checks (prints no result)")
    ap.add_argument("--profile", metavar="DIR",
                    help="profile the serve phases' traffic (r1-distill-14b"
                         " and mamba2-130m) instead of the checks, writing "
                         "the tables under DIR (prints no result)")
    ap.add_argument("--tree-pairs", type=int, metavar="N",
                    help="serve phase 6's traffic in N alternating "
                         "tree/paged pairs instead of the checks (prints "
                         "no result)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the repo's src/repro_torch is not beside {__file__}")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device(torch)
    phase_build()
    if args.profile:
        phase_profile(torch, Path(args.profile))
        return 0
    if args.tree_pairs:
        phase_tree_pairs(torch, args.tree_pairs)
        return 0
    errs, timing = phase_kernels(torch)
    tree_errs, tree_timing = phase_tree_kernels(torch)
    errs.update(tree_errs)
    timing.update(tree_timing)
    ssd_errs, ssd_timing = phase_ssd_kernels(torch)
    errs.update(ssd_errs)
    timing.update(ssd_timing)
    flash_errs, flash_timing, flash_4096 = phase_flash_kernels(torch)
    errs.update(flash_errs)
    timing.update(flash_timing)
    print("[kernels] K5 at S=4096: " + json.dumps(flash_4096))
    if args.skip_serve:
        print(json.dumps(timing))
        return 0
    phase_parity(torch)
    model, params, launches = phase_serve(torch)
    # K1 and K2 count phase 5's run, the K3 passes phase 6's, K5 phase 7's
    tree_run, paged_p50 = phase_tree_serve(torch, model, params)
    for name in ("paged_tree_shared", "paged_tree_branch"):
        launches[name] = tree_run[name]
    launches["flash_prefill"] = phase_exact_serve(torch, model, params,
                                                  paged_p50)
    del model, params
    launches["ssd_scan"] = phase_ssm_serve(torch)["ssd_scan"]

    sdpa = ("scaled_dot_product_attention over pre-gathered contiguous "
            "K/V (a yardstick; the port never calls it)")
    attn_tol = "atol=rtol=2e-2 bf16, 1e-5 fp32"
    meta = {
        "paged_decode": ("src/repro_torch/csrc/paged_decode_mma.cuh",
                         "src/repro/kernels/paged_attention/"
                         "paged_attention.py:144", attn_tol, sdpa),
        "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/flash_prefill/"
                          "paged_prefill.py:176", attn_tol, sdpa),
        "paged_tree_shared": ("src/repro_torch/csrc/paged_tree_decode.cu",
                              "src/repro/kernels/paged_attention/"
                              "tree_decode.py:170", attn_tol, sdpa),
        "paged_tree_branch": ("src/repro_torch/csrc/paged_decode_mma.cuh",
                              "src/repro/kernels/paged_attention/"
                              "tree_decode.py:229", attn_tol, sdpa),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/ssd_scan.py:117",
                     "atol=rtol=2e-2 bf16, 1e-4 fp32 (against the plain "
                     "version in fp32); all-invalid rows bit-exact",
                     "none: no single PyTorch call computes the SSD scan"),
        "flash_prefill": ("src/repro_torch/csrc/flash_prefill_sm90.cu",
                          "src/repro/kernels/flash_prefill/"
                          "flash_prefill.py:144", attn_tol + " (bf16: the "
                          "wgmma kernel, timed; fp32: the CUDA-core kernel "
                          "of flash_prefill.cu); rows past true_len "
                          "bit-exact zeros",
                          "scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True) on the same q, k, v (a "
                          "yardstick; the port never calls it)"),
    }
    kernels = []
    for name, (source, replaces, tol, library) in meta.items():
        tm = timing[name]
        b_ms, b_by = bound(tm["bytes"], tm["ops"], "bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name]), "tolerance": tol,
            "ms": tm["ms"], "queued_ms": tm["queued_ms"],
            "host_us": tm["host_us"],
            "plain_ms": tm["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tm["library_ms"],
            "library": library, "timed_shape": tm["shape"], "card": smi,
            **{key: tm[k] for k, key in (("long", "long_context"),
                                         ("long_few_rows",
                                          "long_context_few_rows"))
               if k in tm},
        })
    for k in kernels:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")
                  ) and (k["library_ms"] is None
                         or math.isfinite(k["library_ms"])),
              f"non-finite timing for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
