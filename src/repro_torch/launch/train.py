"""Training launcher.

Counterpart of ``repro.launch.train``, with the same two modes and flags
plus ``--device`` (the CUDA card unless ``--device cpu``):
  * train the tiny reasoner LM (+ PRM head) on the synthetic CoT task,
    the model the live serving experiments use:
      PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
          --steps 400 --out checkpoints/reasoner
  * smoke an assigned architecture (its reduced variant, one train step):
      PYTHONPATH=src python -m repro_torch.launch.train \\
          --arch qwen3-moe-235b-a22b --smoke --device cpu

On the card the attention of every config without a window or soft-cap
trains through kernel K5's forward and backward (a windowed one, as
hymba-1.5b's, takes the reference's plain formulation: the reference has
no kernel with a window), and the ssm and hybrid families' scan through
kernel K4's forward and hand-written backward (``SsdScanFn``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from ..configs import smoke
from ..data import DataConfig, padded_batches, prm_batches
from ..data import tokenizer as tk
from ..device import resolve_device
from ..models import Model, ModelConfig
from ..training import (AdamWConfig, init_opt_state, make_train_step,
                        save_checkpoint, train_lm, train_prm_head)
from ..training.train_loop import to_batch


def train_reasoner(steps: int, prm_steps: int, out_dir: str, d_model: int,
                   num_layers: int, seed: int, device=None):
    """Train the tiny reasoner and its PRM head; writes ``lm.npz``,
    ``prm.npz`` and ``config.json`` (with both histories) to
    ``out_dir``. Returns (params, head)."""
    dev = resolve_device(device)
    cfg = ModelConfig(
        name="tiny-reasoner", arch_type="dense", num_layers=num_layers,
        d_model=d_model, vocab_size=tk.VOCAB_SIZE,
        num_heads=max(d_model // 32, 2), num_kv_heads=max(d_model // 64, 1),
        d_ff=d_model * 4, max_seq_len=512)
    model = Model(cfg, device=dev)
    data_cfg = DataConfig(batch_size=32, seq_len=160, seed=seed)

    print(f"[train] {cfg.name}: L={cfg.num_layers} d={cfg.d_model} "
          f"({cfg.param_count()/1e6:.2f}M params), {steps} steps on "
          f"{dev}")
    params, hist = train_lm(
        model, padded_batches(data_cfg), steps,
        AdamWConfig(lr=1e-3, warmup_steps=50, total_steps=steps),
        seed=seed, logger=lambda r: print(f"  step {r['step']:4d} "
                                          f"loss {r['loss']:.4f}"))

    print(f"[train] PRM head: {prm_steps} steps")
    head, phist = train_prm_head(
        model, params, prm_batches(data_cfg), prm_steps, seed=seed,
        logger=lambda r: print(f"  step {r['step']:4d} "
                               f"prm_loss {r['prm_loss']:.4f}"))

    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(os.path.join(out_dir, "lm.npz"), params)
    save_checkpoint(os.path.join(out_dir, "prm.npz"), head)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"d_model": cfg.d_model, "num_layers": cfg.num_layers,
                   "num_heads": cfg.num_heads,
                   "num_kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
                   "vocab_size": cfg.vocab_size,
                   "history": hist, "prm_history": phist}, f)
    print(f"[train] saved to {out_dir}")
    return params, head


def smoke_arch(arch: str, seed: int = 0, device=None):
    """One train step of the reduced family variant."""
    dev = resolve_device(device)
    cfg = smoke(arch)
    model = Model(cfg, device=dev)
    params = model.init_params(torch.Generator(dev).manual_seed(seed))
    b, s = 2, 64
    rng = np.random.default_rng(seed)
    arrays = {"labels": rng.integers(0, cfg.vocab_size, (b, s)),
              "mask": np.ones((b, s), np.float32)}
    if cfg.multimodal:
        arrays["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        arrays["tokens"] = rng.integers(0, cfg.vocab_size, (b, s))
    step = make_train_step(model, AdamWConfig(total_steps=10))
    opt = init_opt_state(params)
    params, opt, metrics = step(params, opt, to_batch(arrays, dev))
    loss = float(metrics["loss"])
    assert math.isfinite(loss), f"{arch}: non-finite loss"
    print(f"[smoke] {arch}: train step ok, loss={loss:.4f}")


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned arch to smoke")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--prm-steps", type=int, default=200)
    ap.add_argument("--out", default="checkpoints/reasoner")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.arch:
        smoke_arch(args.arch, args.seed, args.device)
    else:
        train_reasoner(args.steps, args.prm_steps, args.out, args.d_model,
                       args.layers, args.seed, args.device)


if __name__ == "__main__":
    main()
