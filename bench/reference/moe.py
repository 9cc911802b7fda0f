"""Plain PyTorch reference of a Qwen3-MoE decoder.

The dense reference's attention (no q/k/v bias; the per-head q/k RMSNorm
of the published Qwen3 is left out, as the program leaves it out) with
a mixture of experts in place of the MLP: the router's softmax in fp32,
the top ``num_experts_per_tok`` experts with their gates normalised to
sum 1 (``norm_topk_prob``), the program's capacity rule, each expert a
SwiGLU, and the gated sum of the experts' outputs.

The capacity rule (as ``models/moe.py`` of the program documents it):
a call over T rows gives each expert ``max(8, 8 * ceil(int(T * k *
capacity_factor / E) / 8))`` places; the T * k assignments, taken in
row order and within a row in top-k order, fill each expert's places
first come first served, and an assignment past them is dropped. A
call's rows here are every row of every sequence, in order. With the
configuration's capacity factor of E / k no assignment can be dropped.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from bench.reference import dense


def capacity(config: dict, rows: int) -> int:
    k, e = config["num_experts_per_tok"], config["num_experts"]
    c = int(rows * k * config["moe_capacity_factor"] / e)
    return max(8, -(-c // 8) * 8)


def moe(config: dict, lp: dict, layer: int, x: torch.Tensor,
        precision: str) -> torch.Tensor:
    """The MoE block over rows x [T, D]."""
    w = lp["moe"]
    k, e = config["num_experts_per_tok"], config["num_experts"]
    t = x.shape[0]
    xa = dense.act(x, precision)
    probs = torch.softmax(xa @ dense.weight(w["router"][layer], precision),
                          dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    if config["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    cap = capacity(config, t)
    flat = ids.reshape(-1)                # assignment t * k + j
    gflat = gates.reshape(-1)
    y = torch.zeros_like(x)
    for ex in range(e):
        pos = (flat == ex).nonzero().squeeze(1)[:cap]
        if pos.numel() == 0:
            continue
        rows = pos // k
        xe = xa[rows]
        up = xe @ dense.weight(w["w_up"][layer, ex], precision)
        gate = xe @ dense.weight(w["w_gate"][layer, ex], precision)
        out = dense.act(F.silu(gate) * up, precision) @ dense.weight(
            w["w_down"][layer, ex], precision)
        y.index_add_(0, rows, out * gflat[pos][:, None])
    return y


def logits(config: dict, params: dict, seqs: List[List[int]],
           last: List[int], precision: str = "fp32") -> List[torch.Tensor]:
    return dense.logits(config, params, seqs, last, precision, ffn=moe)
