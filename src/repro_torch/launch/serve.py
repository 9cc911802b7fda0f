"""Serving launcher: SART (or a baseline policy) on the live engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt checkpoints/reasoner \
        --policy sart --n 8 --requests 16 --rate-gap 8

Counterpart of ``repro.launch.serve``: runs the trained tiny reasoner (or,
with no checkpoint, an untrained model: scheduling behaviour only) behind
the Algorithm-1 scheduler and prints accuracy and latency percentiles.
``--arch ssm|hybrid`` serves the untrained fallback trunk of that family
(masked-dt chunked admission of the Mamba2 mixer, kernel K4 on the card).
The model build (``load_reasoner``) is separate from the run
(``run_serving``: engine, scheduler, request loop), so a caller with its
own model — ``chip_smoke.py`` serves r1-distill-14b and mamba2-130m —
drives the same run. Runs on the CUDA card unless ``--device cpu``; the
fallback trunks keep the reference's widths (32-wide attention heads,
which K1-K3 take), so every ``--arch`` runs on the card as on the CPU.
Fault plans are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import OraclePRM, RewardHeadPRM, Scheduler, SchedulerConfig
from ..core.scheduler import percentile_latency
from ..data import tasks
from ..data import tokenizer as tk
from ..device import resolve_device
from ..models import Model, ModelConfig, params_from_numpy
from ..serving import Engine, EngineConfig, SamplingParams


# untrained-fallback trunks per family (scheduling behaviour only): lets the
# CLI drive the ssm/hybrid serving paths — masked-dt chunked admission — end
# to end without a checkpoint (the reference's, ``launch/serve.py``)
_FALLBACK_FAMILIES = {
    "dense": dict(arch_type="dense", d_ff=512),
    "ssm": dict(arch_type="ssm", d_ff=0, ssm_state=16, ssm_head_dim=32,
                ssm_chunk=16),
    "hybrid": dict(arch_type="hybrid", d_ff=512, ssm_state=16,
                   ssm_head_dim=32, ssm_chunk=16),
}


def _load_npz(path: str, device, dtype=torch.float32) -> dict:
    with np.load(path) as data:
        return params_from_numpy(dict(data), device=device, dtype=dtype)


def load_reasoner(ckpt_dir: Optional[str], device=None, arch: str = "dense"
                  ) -> Tuple[Model, dict, Optional[dict]]:
    """Returns (model, params, prm_head_params_or_None): the trained tiny
    reasoner from ``ckpt_dir`` (``config.json``, ``lm.npz``, optional
    ``prm.npz``), else the untrained fallback trunk of ``arch``
    (checkpoints are dense-only)."""
    dev = resolve_device(device)
    has_ckpt = ckpt_dir and os.path.exists(
        os.path.join(ckpt_dir, "config.json"))
    if arch != "dense" and has_ckpt:
        print(f"warning: checkpoint {ckpt_dir} is dense-only; "
              f"--arch {arch} serves the untrained fallback trunk instead",
              file=sys.stderr)
    if arch == "dense" and has_ckpt:
        with open(os.path.join(ckpt_dir, "config.json")) as f:
            c = json.load(f)
        cfg = ModelConfig(
            name="tiny-reasoner", arch_type="dense",
            num_layers=c["num_layers"], d_model=c["d_model"],
            vocab_size=c["vocab_size"], num_heads=c["num_heads"],
            num_kv_heads=c["num_kv_heads"], d_ff=c["d_ff"], max_seq_len=512)
        model = Model(cfg, device=dev)
        params = _load_npz(os.path.join(ckpt_dir, "lm.npz"), dev)
        model.load_params(params)
        prm_path = os.path.join(ckpt_dir, "prm.npz")
        prm = _load_npz(prm_path, dev) if os.path.exists(prm_path) else None
        return model, params, prm
    cfg = ModelConfig(name=f"untrained-{arch}", num_layers=2, d_model=128,
                      vocab_size=tk.VOCAB_SIZE, num_heads=4, num_kv_heads=2,
                      max_seq_len=512, **_FALLBACK_FAMILIES[arch])
    model = Model(cfg, device=dev)
    params = model.init_params(torch.Generator(dev).manual_seed(0))
    return model, params, None


def run_serving(model: Model, params: dict, prm_head: Optional[dict], *,
                policy: str, n: int, num_requests: int, rate_gap: int,
                prm_kind: str, window: int, max_tokens: int, max_slots: int,
                seed: int, temperature: float,
                mixed_step_kernel: str = "fused",
                step_token_budget: int = 0, prefix_cache: bool = False,
                admission_policy: str = "fifo",
                deadline: Optional[int] = None) -> Tuple[dict, Engine]:
    """Serve ``num_requests`` synthetic problems arriving every
    ``rate_gap`` decode steps under ``policy``. Returns the summary dict
    of the reference's ``serve`` and the engine (for its counters)."""
    engine = Engine(model, params, EngineConfig(
        page_size=16, num_pages=4096, max_slots=max_slots,
        max_pages_per_branch=32, eos_id=tk.EOS,
        sampling=SamplingParams(temperature=temperature, top_p=0.95),
        seed=seed, mixed_step_kernel=mixed_step_kernel,
        step_token_budget=step_token_budget, prefix_cache=prefix_cache),
        prm_params=prm_head)
    if prm_kind == "head" and prm_head is not None:
        prm = RewardHeadPRM(engine)
    else:
        prm = OraclePRM(tasks.oracle_grader, noise=0.05, seed=seed + 1)
    sch = Scheduler(engine, prm,
                    SchedulerConfig(policy=policy, n=n, window=window,
                                    max_tokens=max_tokens,
                                    admission_policy=admission_policy),
                    answer_fn=tasks.extract_answer)
    rng = np.random.default_rng(seed + 2)
    problems = []
    for i in range(num_requests):
        prob = tasks.gen_problem(rng)
        problems.append(prob)
        arrival = i * rate_gap
        sch.submit(prob.prompt_tokens(), payload=prob, arrival=arrival,
                   deadline=(arrival + deadline
                             if deadline is not None else None))
    metrics = sch.run(max_steps=2_000_000)
    correct = sum(
        1 for r, prob in zip(metrics["requests"], problems)
        if tasks.is_correct(prob, r["answer"]))
    out = {
        "policy": policy, "n": n,
        "accuracy": correct / max(num_requests, 1),
        "p50": percentile_latency(metrics, 50),
        "p90": percentile_latency(metrics, 90),
        "p97": percentile_latency(metrics, 97),
        "p99": percentile_latency(metrics, 99),
        "queue_p50": percentile_latency(metrics, 50, "queue"),
        "decode_steps": metrics["decode_steps"],
        "clock": metrics["clock"],
        "ttfb50": percentile_latency(metrics, 50, "ttfb"),
        "prefill_compile_count": engine.prefill_compile_count,
        "mixed_step_kernel": mixed_step_kernel,
        "step_token_budget": step_token_budget,
        "chunk_lane_capacity": engine.admission_capacity,
        "chunk_lanes_per_mixed_step": (
            engine.prefill_chunk_steps / engine.mixed_steps_executed
            if engine.mixed_steps_executed else 0.0),
        "prefix_cache": engine.prefix_cache_stats(),
        "admission_policy": metrics["admission_policy"],
        "slo": metrics["slo"],
        "completed_requests": metrics["completed_requests"],
        "unfinished_requests": metrics["unfinished_requests"],
        "faults": metrics["faults"],
    }
    return out, engine


def serve(policy: str, n: int, num_requests: int, rate_gap: int,
          ckpt: Optional[str], prm_kind: str, window: int, max_tokens: int,
          max_slots: int, seed: int, temperature: float,
          mixed_step_kernel: str = "fused", step_token_budget: int = 0,
          prefix_cache: bool = False, admission_policy: str = "fifo",
          deadline: Optional[int] = None, device=None,
          arch: str = "dense") -> dict:
    """``load_reasoner`` then ``run_serving``; returns the summary dict."""
    model, params, prm_head = load_reasoner(ckpt, device, arch)
    out, _ = run_serving(
        model, params, prm_head, policy=policy, n=n,
        num_requests=num_requests, rate_gap=rate_gap, prm_kind=prm_kind,
        window=window, max_tokens=max_tokens, max_slots=max_slots, seed=seed,
        temperature=temperature, mixed_step_kernel=mixed_step_kernel,
        step_token_budget=step_token_budget, prefix_cache=prefix_cache,
        admission_policy=admission_policy, deadline=deadline)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="sart",
                    choices=["vanilla", "sc", "sart", "sart_noprune",
                             "rebase"])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate-gap", type=int, default=8,
                    help="decode steps between arrivals")
    ap.add_argument("--ckpt", default="checkpoints/reasoner")
    ap.add_argument("--arch", default="dense",
                    choices=sorted(_FALLBACK_FAMILIES),
                    help="model family of the untrained fallback trunk; "
                         "ssm/hybrid exercise masked-dt chunked admission "
                         "(checkpoints are dense-only)")
    ap.add_argument("--mixed-step-kernel", default="fused",
                    choices=["fused", "decode"],
                    help="chunk-row attention path of the mixed step: one "
                         "fused paged flash-prefill pass vs the per-token "
                         "flash-decode fallback")
    ap.add_argument("--step-token-budget", type=int, default=0,
                    help="max chunk-row tokens per mixed step, drawn from "
                         "multiple in-flight prefills; 0 = one FIFO chunk "
                         "per step")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix page-hash prompt prefix cache: admission "
                         "reuses cached page-aligned prefixes (shared "
                         "headers) instead of recomputing them")
    ap.add_argument("--admission-policy", default="fifo",
                    help="admission ordering over the arrived set: fifo, "
                         "lpm, edf, priority, or compositions like "
                         "priority+lpm")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request SLO: finish within this many decode "
                         "steps of arrival")
    ap.add_argument("--prm", default="oracle", choices=["oracle", "head"])
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args()
    out = serve(args.policy, args.n, args.requests, args.rate_gap,
                args.ckpt, args.prm, args.window, args.max_tokens,
                args.slots, args.seed, args.temperature,
                args.mixed_step_kernel, args.step_token_budget,
                args.prefix_cache, args.admission_policy, args.deadline,
                args.device, args.arch)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
