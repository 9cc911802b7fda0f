"""Plain PyTorch reference of a Qwen2-style decoder (DeepSeek-R1-Distill-Qwen).

fp32 throughout, with TF32 off, layer by layer over every sequence at
once (so one layer's weights are held in fp32 at a time, beside the
served weights). RMSNorm; q/k/v projections with their biases where the
configuration has them; rotate-half RoPE at ``rope_theta``; causal GQA
attention; SwiGLU MLP; final norm and LM head. Positions run from 0 in
each sequence. Weights are the benchmark's tree (``[L, ...]`` stacked,
matrices ``[in, out]``), read, never changed.

``precision="fp8"`` is the control: every matrix product's inputs (the
activations per row, the weights per output column) and q, k, v rounded
to float8 e4m3 with a scale, the products and everything else in fp32 --
the step below the served bfloat16.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

F8_MAX = 448.0


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3, with one scale per slice along ``dim``
    (its largest magnitude maps to the format's largest value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A served weight ``[..., in, out]`` as the reference computes with."""
    w = w.float()
    return q8(w, -2) if precision == "fp8" else w


def act(x: torch.Tensor, precision: str) -> torch.Tensor:
    return q8(x, -1) if precision == "fp8" else x


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] rotated by positions 0..S-1 (rotate-half)."""
    s, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal GQA. q [S, H, hd], k and v [S, KV, hd] -> [S, H * hd]."""
    s, h, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for j in range(kvh):
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)            # [g, S, hd]
        sc = qj @ k[:, j].T / hd ** 0.5                           # [g, S, S]
        sc = sc.masked_fill(~keep, float("-inf"))
        out[:, j * g:(j + 1) * g] = (torch.softmax(sc, -1) @ v[:, j]
                                     ).transpose(0, 1)
    return out.reshape(s, h * hd)


def mlp(config: dict, w: Dict[str, torch.Tensor], layer: int,
        x: torch.Tensor, precision: str) -> torch.Tensor:
    """SwiGLU over rows x [T, D]."""
    up = act(x, precision) @ weight(w["w_up"][layer], precision)
    gate = act(x, precision) @ weight(w["w_gate"][layer], precision)
    return act(F.silu(gate) * up, precision) @ weight(w["w_down"][layer],
                                                      precision)


def logits(config: dict, params: dict, seqs: List[List[int]],
           last: List[int], precision: str = "fp32",
           ffn: Optional[Callable] = None) -> List[torch.Tensor]:
    """For each token sequence, the fp32 logits of its last ``last[i]``
    positions, ``[last[i], vocab]``. ``ffn(config, layer_params, layer,
    rows, precision)`` is the feed-forward block over every row of every
    sequence at once (this file's ``mlp`` by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ffn = ffn or (lambda c, lp, i, x, p: mlp(c, lp["mlp"], i, x, p))
    eps = config["rms_norm_eps"]
    heads, kvh = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim", config["hidden_size"] // heads)
    bias = config.get("qkv_bias", config.get("attention_bias", False))
    lp = params["layers"]
    emb = params["embed"]["embedding"]
    dev = emb.device
    sizes = [len(s) for s in seqs]
    tokens = torch.tensor([t for s in seqs for t in s], dtype=torch.long,
                          device=dev)
    x = emb[tokens].float()                                     # [T, D]
    with torch.no_grad():
        for i in range(config["num_hidden_layers"]):
            a = lp["attn"]
            wq, wk, wv, wo = (weight(a[n][i], precision)
                              for n in ("wq", "wk", "wv", "wo"))
            h = act(rmsnorm(x, lp["norm1"]["scale"][i], eps), precision)
            q, k, v = h @ wq, h @ wk, h @ wv
            if bias:
                q = q + a["bq"][i].float()
                k = k + a["bk"][i].float()
                v = v + a["bv"][i].float()
            att = []
            for qs, ks, vs in zip(q.split(sizes), k.split(sizes),
                                  v.split(sizes)):
                qs = act(rope(qs.view(-1, heads, hd), config["rope_theta"]),
                         precision)
                ks = act(rope(ks.view(-1, kvh, hd), config["rope_theta"]),
                         precision)
                att.append(attention(qs, ks,
                                     act(vs.view(-1, kvh, hd), precision)))
            x = x + act(torch.cat(att), precision) @ wo
            del wq, wk, wv, wo, q, k, v, att
            h = rmsnorm(x, lp["norm2"]["scale"][i], eps)
            x = x + ffn(config, lp, i, h, precision)
        head = params["embed"].get("lm_head")
        head = (weight(head, precision) if head is not None
                else weight(params["embed"]["embedding"].T, precision))
        out = []
        for xs, n in zip(x.split(sizes), last):
            h = rmsnorm(xs[-n:], params["final_norm"]["scale"], eps)
            out.append(act(h, precision) @ head)
        return out
