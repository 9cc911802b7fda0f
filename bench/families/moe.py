"""Mixture-of-experts decoders of the Qwen3-MoE kind: the dense family's
attention, RoPE and RMSNorm, and in every layer a softmax router over
``num_experts`` SwiGLU experts of ``moe_intermediate_size``, each token
sent to its top ``num_experts_per_tok`` through the port's capacity
dispatch (the file's ``moe_capacity_factor``).

Worked count, qwen3-moe-235b-a22b at 8 layers (D 4096, 64/4 heads of
128, 128 experts, top 8 of width 1536, vocab 151,936): attention
4096*8192 + 2*4096*512 + 8192*4096 = 71,303,168; router 4096*128 =
524,288; 8 experts 8*3*4096*1536 = 150,994,944; a layer 222,822,400; 8
layers 1,782,579,200; the LM head 4096*151936 = 622,329,856; in all
2,404,909,056 parameters, 4.81 GFLOP a token, plus 4*64*128*8 = 262,144
FLOP per token of context.
"""
from __future__ import annotations

from bench.lib import model

DEVICE_MARKS = ("attention", "head", "moe_route")


def model_config(config: dict):
    return model.decoder_config(
        config, arch_type="moe", d_ff=config["moe_intermediate_size"],
        num_experts=config["num_experts"],
        num_experts_per_tok=config["num_experts_per_tok"],
        moe_capacity_factor=config["moe_capacity_factor"],
        norm_topk_prob=config["norm_topk_prob"],
        router_aux_coef=config["router_aux_loss_coef"])


def _experts(cfg, draw):
    L, D, F, E = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    return "moe", {"router": draw((L, D, E), D ** -0.5),
                   "w_up": draw((L, E, D, F), D ** -0.5),
                   "w_down": draw((L, E, F, D), F ** -0.5),
                   "w_gate": draw((L, E, D, F), D ** -0.5)}


def make_params(cfg, seed: int, device, dtype) -> dict:
    return model.decoder_params(cfg, seed, device, dtype, _experts)


def matmul_params(config: dict) -> int:
    """The router and the ``num_experts_per_tok`` experts a token is
    routed to (not every expert the capacity dispatch runs)."""
    d = config["hidden_size"]
    return model.decoder_matmul_params(
        config, d * config["num_experts"] + config["num_experts_per_tok"]
        * 3 * d * config["moe_intermediate_size"])


def context_flops(config: dict) -> int:
    return model.decoder_context_flops(config)


def attention_layers(config: dict) -> int:
    return config["num_hidden_layers"]


def state_bytes(config: dict) -> int:
    return 0
