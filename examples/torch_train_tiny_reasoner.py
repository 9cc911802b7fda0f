"""End-to-end driver on the PyTorch port: train a ~1M-param reasoner on
the synthetic CoT task, fit the PRM reward head on its hidden states,
save a checkpoint, and evaluate greedy accuracy.

The port's counterpart of ``examples/train_tiny_reasoner.py``, through
``repro_torch.launch.train.train_reasoner``, on the CUDA card
(``--device cpu`` runs the plain PyTorch path). The checkpoint
(``lm.npz``, ``prm.npz``, ``config.json``) has the reference's format:
``torch_serve_reasoning.py`` and the JAX package's loader both read it.

    PYTHONPATH=src python examples/torch_train_tiny_reasoner.py \\
        [--steps 400] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.data import tasks
from repro_torch.data import tokenizer as tk
from repro_torch.device import resolve_device
from repro_torch.launch.train import train_reasoner
from repro_torch.models import Model, ModelConfig


@torch.no_grad()
def greedy_eval(model, params, n=30, seed=123, max_new=96):
    dev = model.device
    rng = np.random.default_rng(seed)
    correct = 0
    for _ in range(n):
        prob = tasks.gen_problem(rng, 3, 6)
        toks = prob.prompt_tokens()
        lg, cache = model.prefill(
            params, tokens=torch.tensor([toks], dtype=torch.int32,
                                        device=dev), max_len=256)
        cur = int(torch.argmax(lg[0]))
        out, pos = [], len(toks)
        while len(out) < max_new and cur != tk.EOS:
            out.append(cur)
            lg2, cache, _ = model.decode_step(
                params, torch.tensor([cur], dtype=torch.int32, device=dev),
                cache, torch.tensor([pos], dtype=torch.int32, device=dev))
            cur = int(torch.argmax(lg2[0]))
            pos += 1
        if tasks.extract_answer(out) == prob.answer:
            correct += 1
    return correct / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--prm-steps", type=int, default=200)
    ap.add_argument("--eval-problems", type=int, default=30)
    ap.add_argument("--out", default="checkpoints/reasoner")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params, head = train_reasoner(args.steps, args.prm_steps, args.out,
                                  d_model=128, num_layers=2, seed=0,
                                  device=dev)
    cfg = ModelConfig(name="tiny-reasoner", arch_type="dense", num_layers=2,
                      d_model=128, vocab_size=tk.VOCAB_SIZE, num_heads=4,
                      num_kv_heads=2, d_ff=512, max_seq_len=512)
    model = Model(cfg, device=dev)
    acc = greedy_eval(model, params, n=args.eval_problems)
    print(f"[eval] greedy accuracy on held-out problems: {acc:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
