"""Serve the trained reasoner with SART on the PyTorch port and watch the
two mechanisms work.

The port's counterpart of ``examples/serve_reasoning.py``, through
``repro_torch.launch.serve.serve``, on the CUDA card (``--device cpu``
runs the plain PyTorch path). Run ``torch_train_tiny_reasoner.py`` first
(or point ``--ckpt`` elsewhere; without a checkpoint the untrained
fallback trunk serves).

    PYTHONPATH=src python examples/torch_serve_reasoning.py \\
        --policy sart --n 8 [--device cpu]
"""
import argparse
import json

from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="sart")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--ckpt", default="checkpoints/reasoner")
    ap.add_argument("--prm", default="head", choices=["oracle", "head"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = serve(policy=args.policy, n=args.n, num_requests=args.requests,
                rate_gap=8, ckpt=args.ckpt, prm_kind=args.prm, window=8,
                max_tokens=args.max_tokens, max_slots=16, seed=0,
                temperature=0.9, device=resolve_device(args.device))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
