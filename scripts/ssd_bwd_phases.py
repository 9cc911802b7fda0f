#!/usr/bin/env python3
"""Time the phases of K4's bf16 backward (``csrc/ssd_scan_bwd.cu``) on one
CUDA card by knocking parts of its chunk-gradient kernel out.

    python3 scripts/ssd_bwd_phases.py [--reps 2]

Each variant is a copy of ``ssd_scan_bwd.cu`` with one textual change
(``VARIANTS``), built with the port's nvcc flags into
``build/ssd_bwd_phases/`` (all at once) and swapped in for the wrapper's
library, so every variant runs through ``ssd_scan_bwd`` with its grid
check. A cut (``loads``, ``qq``, ``phase2``) returns after that phase:
copies and their shared-memory stores stay, products whose results are
never stored are dropped by the compiler, so each cut times what comes
before it. A knock-out (``nostore``, ``nodot``, ``nostates``) keeps the
work but skips one piece behind a condition the compiler cannot fold.
The variants' outputs are wrong by design: nothing is checked here
(phase 3 of ``chip_smoke.py`` holds the tree's kernel to its plain
version). Timed at mamba2-130m's training shape (B=2, S=2048, 24 heads,
P 64, N 128, chunk 128, bf16) with ``chip_smoke.launch_split_ms`` (each
launch's device ms, queued, L2 flushed), variants in turns, ``--reps``
rounds. Prints each variant's chunk_grad and chain ms per round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# variant name -> (old text, new text); "base" is the tree as it is
_RET = "  if (g.vec >= 0) return;\n"
_LANDED = "  ptx::cp_async_wait<0>();   // X and dY\n  __syncthreads();\n"
VARIANTS = {
    "loads": (_LANDED, _LANDED + _RET),
    "qq": ("  // ---- dX [Q, P] in 16 x 16 tiles",
           _RET + "  // ---- dX [Q, P] in 16 x 16 tiles"),
    "phase2": ("  for (int i = tid; i < qcap; i += kGradThreads) {\n"
               "    float o = 0.f, r = 0.f;",
               _RET + "  for (int i = tid; i < qcap; i += kGradThreads) {\n"
               "    float o = 0.f, r = 0.f;"),
    "nostore": ("            if (i < qn && n < N)\n"
                "              *reinterpret_cast",
                "            if (g.vec < 0 && i < qn && n < N)\n"
                "              *reinterpret_cast"),
    "nodot": ("        rs[e / 2] += v * __bfloat162float(dotm[i * KS + n]);",
              ""),
    "nostates": ("  for (int e0 = 4 * tid; e0 < pp * NP;",
                 "  for (int e0 = 4 * tid; g.vec < 0 && e0 < pp * NP;"),
}


def sources() -> dict:
    """Every variant's source text; raises if a marker is not found once."""
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    out = {"base": src}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"ssd_bwd_phases: marker of {name!r} not "
                             f"found once in ssd_scan_bwd.cu")
        out[name] = src.replace(old, new)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    srcs = sources()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_phases: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd as k4b
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_states
    out_dir = ROOT / "build" / "ssd_bwd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = out_dir / f"ssd_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out_dir / f"libssd_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    libs = {n: ctypes.CDLL(str(out_dir / f"libssd_{n}.so")) for n in srcs}
    cs.phase_device(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(9)
    b, s, h, p, n, q = 2, cs.TRAIN_SEQLEN, 24, 64, 128, 128
    x, dt, a, bb, cc, _ = cs.ssd_inputs(torch, gen, dev, b=b, s=s, h=h, p=p,
                                        n=n, dtype=torch.bfloat16)
    dy = torch.randn((b, s, h, p), generator=gen,
                     device=dev).to(torch.bfloat16)
    states = ssd_scan_states(x, dt, a, bb, cc, chunk=q)[2]
    res = {name: [] for name in srcs}
    for _ in range(args.reps):
        for name, lib in libs.items():
            build._libs["ssd_scan_bwd"] = lib
            build._fns.clear()
            res[name].append(cs.launch_split_ms(
                torch, lambda: k4b.ssd_scan_bwd(x, dt, a, bb, cc, states, dy,
                                                chunk=q),
                cs.K4_BWD_LAUNCHES))
    for name, rounds in res.items():
        print(f"[ssd_bwd_phases] {name}: " + json.dumps({
            "chunk_grad_ms": [r["chunk_grad"] for r in rounds],
            "chain_ms": [r["chain"] for r in rounds]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
