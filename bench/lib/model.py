"""A configuration file as the port's ``ModelConfig``, and its weights made
from the seed on the device.

The weights are the benchmark's own: drawn by one ``torch.Generator`` on
the device, one call per stacked leaf, in the type they are served in,
and laid out as the port's ``Model.load_params`` takes them (per-layer
tensors stacked on a leading ``[L, ...]`` axis, matrices ``[in, out]``,
norm scales fp32). The port and the reference are handed the same
tensors.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file (the published
    ``config.json`` keys, plus the file's own ``qkv_bias`` and
    ``moe_capacity_factor``)."""
    from repro_torch.models import ModelConfig
    moe = bool(config.get("num_experts"))
    heads = config["num_attention_heads"]
    extra = {}
    if moe:
        extra = dict(num_experts=config["num_experts"],
                     num_experts_per_tok=config["num_experts_per_tok"],
                     moe_capacity_factor=config["moe_capacity_factor"],
                     norm_topk_prob=config["norm_topk_prob"],
                     router_aux_coef=config["router_aux_loss_coef"])
    return ModelConfig(
        name=config["name"], arch_type="moe" if moe else "dense",
        source=config["source"], num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], vocab_size=config["vocab_size"],
        num_heads=heads, num_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim", config["hidden_size"] // heads),
        qkv_bias=config.get("qkv_bias", config.get("attention_bias", False)),
        d_ff=config["moe_intermediate_size"] if moe
        else config["intermediate_size"],
        mlp_activation=config["hidden_act"], mlp_gated=True,
        rope_theta=config["rope_theta"], norm_type="rmsnorm",
        norm_eps=config["rms_norm_eps"],
        tie_embeddings=config["tie_word_embeddings"],
        max_seq_len=config["max_position_embeddings"], **extra)


def make_params(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random weights from ``seed``: matrices N(0, 1/fan_in), the
    embedding N(0, 0.02), biases N(0, 0.1), norm scales 1 + N(0, 0.1)
    (fp32), each stacked leaf in one draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def draw(shape, std, mean=0.0, dt=dtype):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(mean, std, generator=gen)

    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    H, KV, hd, F = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_ff)

    def scale():
        return {"scale": draw((L, D), 0.1, 1.0, torch.float32)}

    attn = {"wq": draw((L, D, H * hd), D ** -0.5),
            "wk": draw((L, D, KV * hd), D ** -0.5),
            "wv": draw((L, D, KV * hd), D ** -0.5),
            "wo": draw((L, H * hd, D), (H * hd) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=draw((L, H * hd), 0.1), bk=draw((L, KV * hd), 0.1),
                    bv=draw((L, KV * hd), 0.1))
    layers = {"norm1": scale(), "attn": attn, "norm2": scale()}
    if cfg.uses_moe:
        E = cfg.num_experts
        layers["moe"] = {"router": draw((L, D, E), D ** -0.5),
                         "w_up": draw((L, E, D, F), D ** -0.5),
                         "w_down": draw((L, E, F, D), F ** -0.5),
                         "w_gate": draw((L, E, D, F), D ** -0.5)}
    else:
        layers["mlp"] = {"w_up": draw((L, D, F), D ** -0.5),
                         "w_down": draw((L, F, D), F ** -0.5),
                         "w_gate": draw((L, D, F), D ** -0.5)}
    embed = {"embedding": draw((V, D), 0.02)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = draw((D, V), D ** -0.5)
    return {"embed": embed, "layers": layers,
            "final_norm": {"scale": draw((D,), 0.1, 1.0, torch.float32)}}

