"""Quickstart on the PyTorch port: the SART serving loop in ~40 lines.

The port's counterpart of ``examples/quickstart.py``: builds a tiny
reasoner (untrained — this demo shows the *scheduling* machinery),
submits a few synthetic reasoning requests, and serves them with
redundant sampling (N=8, early stop at M=4) + two-phase pruning, on the
CUDA card (``--device cpu`` runs the plain PyTorch path).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
from repro_torch.core.scheduler import percentile_latency
from repro_torch.data import tasks
from repro_torch.data import tokenizer as tk
from repro_torch.device import resolve_device
from repro_torch.models import Model, ModelConfig
from repro_torch.serving import Engine, EngineConfig, SamplingParams


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-tokens", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a model (any of the 10 assigned archs works via
    #    repro_torch.configs.smoke)
    cfg = ModelConfig(name="demo", arch_type="dense", num_layers=2,
                      d_model=128, vocab_size=tk.VOCAB_SIZE, num_heads=4,
                      num_kv_heads=2, d_ff=512)
    model = Model(cfg, device=dev)
    params = model.init_params(torch.Generator(dev).manual_seed(0))

    # 2. the serving engine: paged KV cache with ref-counted prefix sharing
    engine = Engine(model, params, EngineConfig(
        page_size=8, num_pages=512, max_slots=16, max_pages_per_branch=16,
        eos_id=tk.EOS, sampling=SamplingParams(temperature=1.0,
                                               top_p=0.95)))

    # 3. SART: Algorithm 1 with N=8 branches, early stop at M=4, PRM pruning
    prm = OraclePRM(tasks.oracle_grader, noise=0.05)
    scheduler = Scheduler(
        engine, prm,
        SchedulerConfig(policy="sart", n=8, m=4, window=8,
                        max_tokens=args.max_tokens),
        answer_fn=tasks.extract_answer)

    # 4. submit reasoning requests (synthetic verifiable arithmetic chains)
    rng = np.random.default_rng(0)
    problems = [tasks.gen_problem(rng) for _ in range(args.requests)]
    for i, prob in enumerate(problems):
        print(f"request {i}: {tk.decode(prob.prompt_tokens())}  "
              f"(answer: {prob.answer})")
        scheduler.submit(prob.prompt_tokens(), payload=prob, arrival=i * 4)

    # 5. serve
    metrics = scheduler.run()
    for r, prob in zip(metrics["requests"], problems):
        ok = tasks.is_correct(prob, r["answer"])
        print(f"request {r['request_id']}: answer={r['answer']} "
              f"({'correct' if ok else 'wrong — untrained model'}) "
              f"e2e={r['e2e']} steps, queued={r['queue']}, "
              f"completed={r['num_completed']}, pruned={r['num_pruned']}")
    print(f"P97 latency: {percentile_latency(metrics, 97):.0f} decode steps")
    assert engine.allocator.used_pages == 0, "page leak!"
    print("all KV pages released — no leaks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
