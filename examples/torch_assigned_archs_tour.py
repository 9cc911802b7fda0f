"""Tour of the 10 assigned architectures on the PyTorch port.

The port's counterpart of ``examples/assigned_archs_tour.py``: for each
arch, print the exact full config and parameter counts, then run one
prefill and a short greedy decode on the REDUCED smoke variant, on the
CUDA card (``--device cpu`` runs the plain PyTorch path). The FULL
configs are traced by ``repro_torch.launch.dryrun``.

    PYTHONPATH=src python examples/torch_assigned_archs_tour.py \\
        [--arch <id>] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, get_config, smoke
from repro_torch.device import resolve_device
from repro_torch.models import Model


def tour(arch: str, dev: torch.device, new_tokens: int = 8):
    full = get_config(arch)
    cfg = smoke(arch)
    print(f"== {arch} [{full.arch_type}]  ({full.source})")
    print(f"   full: L={full.num_layers} d={full.d_model} "
          f"H={full.num_heads}/kv{full.num_kv_heads} ff={full.d_ff} "
          f"V={full.vocab_size} params={full.param_count()/1e9:.2f}B "
          f"active={full.active_param_count()/1e9:.2f}B")
    model = Model(cfg, device=dev)
    params = model.init_params(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    b, s = 1, 12
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device=dev)
    if cfg.multimodal:
        embeds = torch.as_tensor(rng.normal(size=(b, s, cfg.d_model)),
                                 dtype=torch.float32, device=dev)
        _, cache = model.prefill(params, embeds=embeds, max_len=48)
        print("   frontend stub: prefill over precomputed "
              f"{'patch' if cfg.arch_type == 'vlm' else 'frame'} embeddings")
    else:
        _, cache = model.prefill(params, tokens=toks, max_len=48)
    cur, pos, out = int(toks[0, -1]), s, []
    for _ in range(new_tokens):
        logits, cache, _ = model.decode_step(
            params, torch.tensor([cur], dtype=torch.int32, device=dev), cache,
            torch.tensor([pos], dtype=torch.int32, device=dev))
        cur = int(torch.argmax(logits[0]))
        out.append(cur)
        pos += 1
    state_kind = []
    if cfg.uses_attention:
        state_kind.append(f"KV cache[{cache['k'].shape[2]}]")
    if cfg.uses_ssm:
        state_kind.append(f"SSD state[{cfg.ssm_heads}x{cfg.ssm_head_dim}"
                          f"x{cfg.ssm_state}]")
    print(f"   smoke decode ok: tokens={out}  state: {', '.join(state_kind)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=[None] + ASSIGNED)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for arch in ([args.arch] if args.arch else ASSIGNED):
        tour(arch, dev, args.new_tokens)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
