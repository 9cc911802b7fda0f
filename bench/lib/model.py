"""What the model families of ``bench/families/`` share: the served types,
the seeded draw, and the decoder that ``dense`` and ``moe`` both build on
(GQA attention with RoPE and RMSNorm in every layer, the embedding, a
final norm and the LM head), with each layer's FFN left to the family.

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


def drawer(seed: int, device, dtype=torch.bfloat16):
    """``draw(shape, std, mean=0.0, dt=dtype)``: each call one normal draw
    of a new tensor from one generator on ``device`` seeded with
    ``seed``, so the weights follow from the seed and the calls' order."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def draw(shape, std, mean=0.0, dt=dtype):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(mean, std, generator=gen)
    return draw


def decoder_config(config: dict, **family):
    """The port's ``ModelConfig`` for a decoder's configuration file (the
    published ``config.json`` keys, plus the file's own ``qkv_bias``);
    ``family`` gives ``arch_type``, ``d_ff`` and the family's other
    fields, and overrides the defaults here (a gated MLP of
    ``hidden_act``)."""
    from repro_torch.models import ModelConfig
    heads = config["num_attention_heads"]
    fields = dict(
        name=config["name"], source=config["source"],
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], vocab_size=config["vocab_size"],
        num_heads=heads, num_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim", config["hidden_size"] // heads),
        qkv_bias=config.get("qkv_bias", config.get("attention_bias", False)),
        mlp_activation=config["hidden_act"], mlp_gated=True,
        rope_theta=config["rope_theta"], norm_type="rmsnorm",
        norm_eps=config["rms_norm_eps"],
        tie_embeddings=config["tie_word_embeddings"],
        max_seq_len=config["max_position_embeddings"])
    fields.update(family)
    return ModelConfig(**fields)


def decoder_params(cfg, seed: int, device, dtype, ffn) -> dict:
    """Random weights from ``seed``: matrices N(0, 1/fan_in), the
    embedding N(0, 0.02), biases N(0, 0.1), norm scales 1 + N(0, 0.1)
    (fp32), each stacked leaf in one draw. ``ffn(cfg, draw)`` draws the
    layers' FFN after their attention and norms and returns (its key
    in the layer tree, its leaves)."""
    draw = drawer(seed, device, dtype)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

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
    key, leaves = ffn(cfg, draw)
    layers[key] = leaves
    embed = {"embedding": draw((V, D), 0.02)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = draw((D, V), D ** -0.5)
    return {"embed": embed, "layers": layers,
            "final_norm": {"scale": draw((D,), 0.1, 1.0, torch.float32)}}


def _dims(config: dict):
    heads = config["num_attention_heads"]
    hd = config.get("head_dim", config["hidden_size"] // heads)
    return (config["hidden_size"], heads, config["num_key_value_heads"], hd,
            config["num_hidden_layers"], config["vocab_size"])


def decoder_matmul_params(config: dict, ffn: int) -> int:
    """Matrix-product parameters one token passes through a decoder whose
    layers' FFN passes ``ffn``: each layer's q, k, v and o projections
    and FFN, and the LM head (the embedding table's transpose where
    tied)."""
    d, h, kv, hd, layers, vocab = _dims(config)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    return layers * (attn + ffn) + d * vocab


def decoder_context_flops(config: dict) -> int:
    """Attention FLOPs of one token per token of its context, all layers:
    its q.k products and weighted sum of values, 2 FLOPs a multiply-add
    each."""
    d, h, kv, hd, layers, vocab = _dims(config)
    return 4 * h * hd * layers
