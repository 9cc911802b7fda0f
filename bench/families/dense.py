"""Dense decoders of the Qwen2 kind (DeepSeek-R1-Distill-Qwen): GQA
attention with q/k/v biases where the configuration has them, RoPE and
RMSNorm in every layer, and a SwiGLU MLP of ``intermediate_size``.

Worked count, r1-distill-14b (D 5120, 40/8 heads of 128, F 13824, 48
layers, vocab 152,064): attention projections 5120*5120 + 2*5120*1024 +
5120*5120 = 62,914,560; SwiGLU 3*5120*13824 = 212,336,640; a layer
275,251,200; 48 layers 13,212,057,600; the LM head 5120*152064 =
778,567,680; in all 13,990,625,280 parameters, 27.98 GFLOP a token, plus
4*40*128*48 = 983,040 FLOP per token of context.
"""
from __future__ import annotations

from bench.lib import model

DEVICE_MARKS = ("attention", "head")


def model_config(config: dict):
    return model.decoder_config(config, arch_type="dense",
                                d_ff=config["intermediate_size"])


def _mlp(cfg, draw):
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    return "mlp", {"w_up": draw((L, D, F), D ** -0.5),
                   "w_down": draw((L, F, D), F ** -0.5),
                   "w_gate": draw((L, D, F), D ** -0.5)}


def make_params(cfg, seed: int, device, dtype) -> dict:
    return model.decoder_params(cfg, seed, device, dtype, _mlp)


def matmul_params(config: dict) -> int:
    return model.decoder_matmul_params(
        config, 3 * config["hidden_size"] * config["intermediate_size"])


def context_flops(config: dict) -> int:
    return model.decoder_context_flops(config)


def attention_layers(config: dict) -> int:
    return config["num_hidden_layers"]


def state_bytes(config: dict) -> int:
    return 0
