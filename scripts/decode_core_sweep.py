#!/usr/bin/env python3
"""Time the port's bf16 split-key decode core (K1, ``csrc/paged_decode_mma.cuh``)
on one CUDA card under several key-split layouts and source variants.

    python3 scripts/decode_core_sweep.py [--reps 3]

Each variant is a copy of ``src/repro_torch/csrc`` with one textual change
(``VARIANTS``), built with the port's nvcc flags into
``build/decode_core_sweep/<variant>/`` (all at once) and loaded with
ctypes; every layout passes its own ``(split_keys, n_split)`` to the
launcher, so the wrapper's rule (``ref.decode_splits``) is bypassed. Each
(variant, layout) is first held against the plain K1 (atol = rtol = 2e-2),
then timed with ``chip_smoke.time_ms(head_start=True)`` (the device's time
alone, L2 flushed) at shapes of r1-distill-14b (40/8 heads, hd 128, pages of 16 tokens):
over 32-page tables the serve phase's 16 decode rows (17-112 tokens),
the tree serve's rebuilt full tables (257-352) and 16 rows at the full
512; over 128-page tables 16 rows and 2 rows at the full 2,048; and K3's
branch pass (``tree_branch_launch``) at the tree serve's shape, behind
the shared pass's split partials. Combinations run in turns, ``--reps`` rounds, so that a
drift of the card falls on all alike; SDPA over pre-gathered K/V and a
one-element ``zero_`` (the launch floor of this timer) run beside them.
Prints one JSON line per round and a summary of medians.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# variant name -> (file, old text, new text, [old text, new text, ...]);
# "base" is the tree as it is.
# Variants marked in KNOCKOUTS compute nothing right: they are timed, not
# checked, to split the time into its parts.
VARIANTS = {
    "base": None,
    "empty": ("paged_decode_mma.cuh",
              "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;"
              "\n  const int z = blockIdx.x, b = blockIdx.z;",
              "  if (a.batch > 0) return;\n"
              "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;"
              "\n  const int z = blockIdx.x, b = blockIdx.z;"),
    "no_shared_merge": ("paged_decode_mma.cuh",
                        "    used = grouped ? min(a.shared_n,",
                        "    used = false ? min(a.shared_n,"),
    "three_stage": ("paged_decode_mma.cuh",
                    "return split_keys > kWarps * tile::kKeys ? "
                    "max_stages<HD>() : 1;",
                    "return split_keys > 2 * kWarps * tile::kKeys ? "
                    "max_stages<HD>()\n"
                    "         : split_keys > kWarps * tile::kKeys ? 2 : 1;",
                    "return Layout<HD>::bytes(2) <= kMaxSmem ? 2 : 1;",
                    "return Layout<HD>::bytes(3) <= kMaxSmem ? 3 : 1;"),
    "gather_unroll2": ("paged_decode_mma.cuh",
                       "#pragma unroll (kGatherUnroll)\n"
                       "        for (int it = 0; it < kChunks;",
                       "#pragma unroll 2\n        for (int it = 0; it < kChunks;"),
    "carveout": ("paged_decode_mma.cuh",
                 "    smem_raised<HD, kBranch> = true;",
                 "    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferred"
                 "SharedMemoryCarveout, 100);\n"
                 "    smem_raised<HD, kBranch> = true;"),
    "one_stage": ("paged_decode_mma.cuh",
                  "return split_keys > kWarps * tile::kKeys ? "
                  "max_stages<HD>() : 1;",
                  "return 1;"),
    "min3": ("paged_decode_mma.cuh",
             "__global__ void __launch_bounds__(kThreads)\n"
             "    decode_mma_kernel(const Args a) {",
             "__global__ void __launch_bounds__(kThreads, 3)\n"
             "    decode_mma_kernel(const Args a) {"),
}
KNOCKOUTS = {"empty", "no_shared_merge"}
LAYOUTS = [(128, 4), (256, 2), (512, 1)]         # 32-page tables
LONG_LAYOUTS = [(512, 4), (1024, 2), (2048, 1)]  # 128-page tables
ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
    [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
BRANCH_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + \
    [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]


def build_variants(build) -> dict:
    out_root = ROOT / "build" / "decode_core_sweep"
    procs = {}
    for name, change in VARIANTS.items():
        src = out_root / name / "csrc"
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(build.CSRC, src)
        if change is not None:
            path = src / change[0]
            text = path.read_text()
            for old, new in zip(change[1::2], change[2::2]):
                if old not in text:
                    raise SystemExit(f"variant {name}: pattern not found")
                text = text.replace(old, new)
            path.write_text(text)
        for source in ("paged_decode", "paged_tree_decode"):
            lib = out_root / name / f"lib{source}.so"
            procs[(name, source)] = (lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(src / f"{source}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs, branch_libs = {}, {}
    for (name, source), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} {source}:\n{log}")
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and \
                    "decode_mma_kernelILi128" in fn:
                print(f"[sweep] {name}: {fn}: {line.strip()}")
        if source == "paged_decode":
            fn_ = ctypes.CDLL(str(lib)).paged_decode_launch
            fn_.argtypes, fn_.restype = ARGTYPES, ctypes.c_int
            libs[name] = fn_
        else:
            fn_ = ctypes.CDLL(str(lib)).tree_branch_launch
            fn_.argtypes, fn_.restype = BRANCH_ARGTYPES, ctypes.c_int
            branch_libs[name] = fn_
    return libs, branch_libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_core_sweep: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention.ref import (
        gather_pages, paged_attention_decode_ref)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[sweep] card: {smi}")
    libs, branch_libs = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    rng = torch.Generator().manual_seed(1)
    r1 = dict(q_heads=40, kv_heads=8, hd=128, ps=16, pool_pages=4097)
    # shape -> (lengths, table width in pages)
    shapes = {
        "serve": (torch.randint(17, 17 + 96, (16,),
                                generator=rng).tolist(), 32),
        "tree_full": ((256 + torch.randint(1, 97, (16,),
                                           generator=rng)).tolist(), 32),
        "long": ([512] * 16, 32),
        "2048 x16": ([2048] * 16, 128),
        "2048 x2": ([2048] * 2, 128),
    }
    inputs = {k: cs.k1_inputs(torch, gen, dev, lengths=v, width=w,
                              dtype=torch.bfloat16, **r1)
              for k, (v, w) in shapes.items()}
    F = torch.nn.functional
    calls = {}
    for shape, (q, kp, vp, bt, ln) in inputs.items():
        out = torch.empty_like(q)
        ref = paged_attention_decode_ref(q, kp, vp, bt, ln)
        cap = bt.shape[1] * 16
        layouts = LAYOUTS if cap == 512 else LONG_LAYOUTS
        for var, fn in libs.items():
            for keys, n in layouts:
                def call(fn=fn, q=q, kp=kp, vp=vp, bt=bt, ln=ln, out=out,
                         keys=keys, n=n):
                    return fn(1, 128, q.data_ptr(), kp.data_ptr(),
                              vp.data_ptr(), bt.data_ptr(), ln.data_ptr(),
                              out.data_ptr(), q.shape[0], 40, 8,
                              kp.shape[1], 16, bt.shape[1], keys, n,
                              1.0 / 128 ** 0.5, build.stream(q))
                rc = call()
                torch.cuda.synchronize()
                name = f"{var} {keys}x{n}"
                if rc:
                    print(f"[sweep] {shape} | {name}: launch refused, "
                          f"cudaError {rc}")
                    continue
                if var not in KNOCKOUTS:
                    cs.check(torch.allclose(out.float(), ref.float(),
                                            atol=2e-2, rtol=2e-2),
                             f"{name} {shape} disagrees")
                calls[(shape, name)] = call
        kc = gather_pages(kp, bt).nan_to_num()
        vc = gather_pages(vp, bt).nan_to_num()
        mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                < ln[:, None].long())[:, None, None, :]
        calls[(shape, "sdpa")] = (
            lambda q=q, kc=kc, vc=vc, mask=mask:
            F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                           attn_mask=mask, enable_gqa=True))
    # K3's branch pass at the tree serve's shape (2 groups of 8 over a
    # 256-token span, suffixes 1-96 and 240-256 tokens), behind the
    # production shared pass's 16 split partials (8 of them with keys)
    from repro_torch.kernels.paged_attention.ref import (
        tree_branch_merge_ref, tree_merge_splits_ref)
    from repro_torch.kernels.paged_attention.tree_decode import (
        paged_tree_shared_fwd, unpack_partials)
    r1w = dict(r1, width=32)
    for shape, lo_, hi_ in (("tree serve", 1, 97), ("tree long", 240, 257)):
        groups = [(16, (256 + torch.randint(lo_, hi_, (8,),
                                            generator=rng)).tolist())
                  for _ in range(2)]
        q, kp, vp, rg, sbt, sl, bbt, ln = cs.k3_inputs(
            torch, gen, dev, groups=groups, singles=[],
            dtype=torch.bfloat16, **r1w)
        part, skeys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln)
        out = torch.empty_like(q)
        ref = tree_branch_merge_ref(q, kp, vp, rg, sl, bbt, ln,
                                    *tree_merge_splits_ref(
                                        *unpack_partials(part)))
        for var, fn in branch_libs.items():
            for keys, n in ((128, 4), (512, 1)):
                def call(fn=fn, q=q, kp=kp, vp=vp, rg=rg, sl=sl, bbt=bbt,
                         ln=ln, part=part, out=out, keys=keys, n=n,
                         skeys=skeys):
                    return fn(1, 128, q.data_ptr(), kp.data_ptr(),
                              vp.data_ptr(), rg.data_ptr(), sl.data_ptr(),
                              bbt.data_ptr(), ln.data_ptr(), part.data_ptr(),
                              out.data_ptr(), q.shape[0], 40, 8,
                              kp.shape[1], 16, 32, sl.shape[0], skeys,
                              part.shape[0], keys, n, 1.0 / 128 ** 0.5,
                              build.stream(q))
                rc = call()
                torch.cuda.synchronize()
                name = f"{var} {keys}x{n}"
                if rc:
                    print(f"[sweep] {shape} | {name}: launch refused, "
                          f"cudaError {rc}")
                    continue
                if var not in KNOCKOUTS:
                    cs.check(torch.allclose(out.float(), ref.float(),
                                            atol=2e-2, rtol=2e-2),
                             f"{name} {shape} disagrees")
                calls[(shape, name)] = call
    one = torch.zeros(1, device=dev)
    calls[("floor", "zero_ of one element")] = one.zero_
    print("[sweep] every (variant, layout) launched agrees with the plain "
          "K1 (knock-outs not checked)")
    times = {k: [] for k in calls}
    for rep in range(args.reps):
        keys = list(calls)
        if rep % 2:
            keys.reverse()
        for k in keys:
            times[k].append(cs.time_ms(torch, calls[k], head_start=True))
        print("[sweep] round " + json.dumps(
            {f"{s} | {v}": t[-1] for (s, v), t in times.items()}))
    summary = {f"{s} | {v}": statistics.median(t)
               for (s, v), t in times.items()}
    print("[sweep] median queued_ms " + json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
