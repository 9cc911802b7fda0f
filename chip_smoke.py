#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py              # every phase; needs one card
    python3 chip_smoke.py --skip-serve # build + kernel checks only, no "ok"
    python3 chip_smoke.py --profile DIR  # build + a profiled serve, no "ok"

Phases, in order; any failure raises and the script exits non-zero:

  1. device  — the card's name and power limit (nvidia-smi) and torch's name;
  2. build   — nvcc builds the CUDA kernels from ``src/repro_torch/csrc``;
  3. kernels — K1 (paged flash-decode) and K2 (paged flash-prefill) against
               their plain PyTorch versions on the card, bf16 and fp32, at
               the serving shapes of r1-distill-14b and one qwen2-0.5b shape;
               then each timed with CUDA events (L2 flushed before every
               launch) beside its plain version, a bound from bytes and
               operations, and one library call as a yardstick;
  4. parity  — the engine on the card (kernels) against the engine on the
               CPU (plain versions) on a small fp32 model, greedy, with
               chunked admission, forked branches and CoW;
  5. serve   — r1-distill-14b at full width and depth (48 layers, bf16,
               random weights from a seed) behind the SART scheduler through
               ``repro_torch.launch.serve.run_serving``: 4 requests, n=8.
               Kernel launch counters are zeroed just before and read just
               after, and every request must complete with no fault.

Then one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without a card, or without the repo's
``src/`` beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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


def time_ms(torch, fn, n: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``n`` launches (CUDA events around
    each launch), with a 64 MiB write before each to push the inputs out
    of the 50 MB L2, as a layer of the serving step finds them."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / n


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


def phase_build():
    from repro_torch.kernels import build
    secs = build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in {secs:.1f} s -> "
          f"{build.build_dir()}")
    for name, log in sorted(build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


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
    errs = {"paged_decode": [], "paged_prefill": []}

    ragged = [0, 512, 1, 15, 16, 17, 33, 100, 255, 256, 257, 300, 400, 450,
              500, 511]
    for shape_name, shape, lengths in (("r1", r1, ragged),
                                       ("qwen2", qw, ragged)):
        for dn, dt in dtypes.items():
            args = k1_inputs(torch, gen, dev, lengths=lengths, dtype=dt,
                             **shape)
            out = paged_attention_decode(*args)
            ref = paged_attention_decode_ref(*args)
            torch.cuda.synchronize()
            check(bool((out[0] == 0).all()), "K1 length-0 row is not zero")
            errs["paged_decode"].append(_compare(
                torch, f"K1 {shape_name} {dn} B={len(lengths)}", out, ref,
                dn))
    k2_cases = [(r1, t, pos0, valid) for t in (32, 64) for pos0 in (0, 37, 448)
                for valid in (t - 5, 1)] + [(qw, 64, 37, 60)]
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
    tok = sum(lengths)
    followed = sum(-(-n // ps) for n in lengths)   # table entries read
    k1 = {
        "ms": time_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                            ln)),
        "plain_ms": time_ms(torch, lambda: paged_attention_decode_ref(
            q, kp, vp, bt, ln)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)),
        "bytes": 2 * q.numel() * 2 + tok * kv * hd * 2 * 2 + followed * 4
        + ln.numel() * 4,
        "ops": 4 * tok * H * hd,
        "shape": f"B=16 H=40 kv=8 hd=128 ps=16 W=32 bf16, lengths "
                 f"{min(lengths)}..{max(lengths)} (sum {tok})",
    }
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
        "ms": time_ms(torch, lambda: paged_flash_prefill_fwd(
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


def phase_parity(torch):
    """The engine with the kernels on the card against the engine with the
    plain versions on the CPU: same fp32 weights, greedy decoding."""
    from repro_torch.configs import smoke
    from repro_torch.models import Model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = smoke("r1-distill-14b")
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init_params(torch.Generator().manual_seed(0))
    gpu_model = Model(cfg, device=DEVICE)
    gpu_params = {k: _to(v, DEVICE) for k, v in params.items()}
    gpu_model.load_params(gpu_params)
    ecfg = EngineConfig(page_size=4, num_pages=64, max_slots=4,
                        max_pages_per_branch=24, prefill_chunk=16,
                        sampling=SamplingParams(temperature=0.0))
    runs = []
    for model, p in ((cpu_model, params), (gpu_model, gpu_params)):
        eng = Engine(model, p, ecfg)
        prompt = [int(x) for x in (torch.arange(37) * 7 % cfg.vocab_size)]
        blocks, logits, _ = eng.prefill(prompt)
        hs = [eng.spawn_branch(0, blocks, logits, None, len(prompt))
              for _ in range(3)]
        for _ in range(12):
            eng.decode_step()
        runs.append(([h.tokens for h in hs], logits.float().cpu(),
                     eng._last_hidden[:3].float().cpu()))
        for h in hs:
            eng.free_branch(h)
        eng.release_prefix(blocks)
        check(eng.allocator.used_pages == 0, "parity engine leaked pages")
    (t_cpu, l_cpu, h_cpu), (t_gpu, l_gpu, h_gpu) = runs
    err = max(float((l_cpu - l_gpu).abs().max()),
              float((h_cpu - h_gpu).abs().max()))
    ok = t_cpu == t_gpu and err <= 1e-4
    print(f"[parity] greedy tokens equal: {t_cpu == t_gpu}; max abs err of "
          f"prefill logits / hidden {err:.3e} (atol 1e-4) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "engine on the card disagrees with the CPU engine")


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
    return launches


def _step_stats(engine, wall: float) -> dict:
    steps = sorted(engine.step_seconds)
    return {"decode_steps": engine.decode_steps_executed, "wall_s": wall,
            "step_ms_p50": steps[len(steps) // 2] * 1e3,
            "step_ms_mean": sum(steps) * 1e3 / len(steps)}


def phase_profile(torch, out_dir: Path) -> None:
    """The serve phase's traffic (4 requests, n=8, 96 tokens) served twice:
    once plain, for step times, then under torch.profiler tracing device
    activity only (no host ops, so the trace adds little to the host
    side), for device time by kernel and the device's busy share of that
    run's own wall time. The table goes to ``out_dir/profile_serve.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import Model
    model = Model(get_config("r1-distill-14b"), dtype=torch.bfloat16,
                  device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    kw = dict(policy="sart", n=8, num_requests=4, rate_gap=8,
              prm_kind="oracle", window=8, max_tokens=96, max_slots=16,
              seed=0, temperature=0.9)
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
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_serve.txt").write_text(table)
    print(table)
    print("[profile] " + json.dumps({"untraced": plain, "traced": traced}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel checks (prints no result)")
    ap.add_argument("--profile", metavar="DIR",
                    help="profile the serve phase's traffic instead of the "
                         "checks, writing the table under DIR (prints no "
                         "result)")
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
    errs, timing = phase_kernels(torch)
    if args.skip_serve:
        print(json.dumps(timing))
        return 0
    phase_parity(torch)
    launches = phase_serve(torch)

    meta = {
        "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                         "src/repro/kernels/paged_attention/"
                         "paged_attention.py:144"),
        "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/flash_prefill/"
                          "paged_prefill.py:176"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        tm = timing[name]
        b_ms, b_by = bound(tm["bytes"], tm["ops"], "bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name]),
            "tolerance": "atol=rtol=2e-2 bf16, 1e-5 fp32",
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tm["library_ms"],
            "library": "scaled_dot_product_attention over pre-gathered "
                       "contiguous K/V (a yardstick; the port never calls "
                       "it)",
            "timed_shape": tm["shape"], "card": smi,
        })
    for k in kernels:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")),
              f"non-finite timing for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
