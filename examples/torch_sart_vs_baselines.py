"""Live engine comparison on the PyTorch port (paper Fig. 5, small
scale): Vanilla vs Self-Consistency vs Rebase vs SART on the trained tiny
reasoner.

The port's counterpart of ``examples/sart_vs_baselines.py``, through
``repro_torch.launch.serve.serve``, on the CUDA card (``--device cpu``
runs the plain PyTorch path). Reads the checkpoint that
``torch_train_tiny_reasoner.py`` writes.

    PYTHONPATH=src python examples/torch_sart_vs_baselines.py [--device cpu]
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--ckpt", default="checkpoints/reasoner")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"{'policy':14s} {'N':>2s} {'acc':>5s} {'P50':>6s} {'P97':>6s} "
          f"{'queueP50':>8s} steps")
    for policy, n in [("vanilla", 1), ("sc", args.n), ("rebase", args.n),
                      ("sart", args.n)]:
        out = serve(policy=policy, n=n, num_requests=args.requests,
                    rate_gap=6, ckpt=args.ckpt, prm_kind="oracle", window=8,
                    max_tokens=args.max_tokens, max_slots=16, seed=0,
                    temperature=0.9, device=dev)
        print(f"{policy:14s} {n:2d} {out['accuracy']:5.2f} "
              f"{out['p50']:6.0f} {out['p97']:6.0f} "
              f"{out['queue_p50']:8.0f} {out['decode_steps']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
