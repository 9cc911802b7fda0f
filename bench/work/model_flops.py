"""Model FLOPs of the tokens a step runs, from the configuration file.

Per token: 2 x the matrix-product parameters it passes (for a mixture of
experts the router and only the ``num_experts_per_tok`` experts it is
routed to), plus attention's 4 x context x heads x head_dim per layer
(its q.k products and its weighted sum of values, 2 FLOPs a
multiply-add each).

Worked count, r1-distill-14b (D 5120, 40/8 heads of 128, F 13824, 48
layers, vocab 152,064): attention projections 5120*5120 + 2*5120*1024 +
5120*5120 = 62,914,560; SwiGLU 3*5120*13824 = 212,336,640; a layer
275,251,200; 48 layers 13,212,057,600; the LM head 5120*152064 =
778,567,680; in all 13,990,625,280 parameters, 27.98 GFLOP a token, plus
4*40*128*48 = 983,040 FLOP per token of context.

qwen3-moe-235b-a22b at 8 layers (D 4096, 64/4 heads of 128, 128
experts, top 8 of width 1536, vocab 151,936): attention 4096*8192 +
2*4096*512 + 8192*4096 = 71,303,168; router 4096*128 = 524,288; 8
experts 8*3*4096*1536 = 150,994,944; a layer 222,822,400; 8 layers
1,782,579,200; the LM head 4096*151936 = 622,329,856; in all
2,404,909,056 parameters, 4.81 GFLOP a token, plus 4*64*128*8 = 262,144
FLOP per token of context.
"""
from __future__ import annotations


def _dims(config: dict):
    heads = config["num_attention_heads"]
    hd = config.get("head_dim", config["hidden_size"] // heads)
    return (config["hidden_size"], heads, config["num_key_value_heads"], hd,
            config["num_hidden_layers"], config["vocab_size"])


def matmul_params(config: dict) -> int:
    """Matrix-product parameters one token passes through."""
    d, h, kv, hd, layers, vocab = _dims(config)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if config.get("num_experts"):
        ffn = (d * config["num_experts"] + config["num_experts_per_tok"]
               * 3 * d * config["moe_intermediate_size"])
    else:
        ffn = 3 * d * config["intermediate_size"]
    # the LM head (the embedding table's transpose where tied)
    return layers * (attn + ffn) + d * vocab


def attention_flops_per_context_token(config: dict) -> int:
    """Attention FLOPs of one token per token of its context, all layers."""
    d, h, kv, hd, layers, vocab = _dims(config)
    return 4 * h * hd * layers


def step_flops(config: dict, tokens: int, context: int) -> int:
    """FLOPs of ``tokens`` tokens that attend ``context`` keys in all."""
    return (2 * matmul_params(config) * tokens
            + attention_flops_per_context_token(config) * context)
