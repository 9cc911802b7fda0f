"""The work functions against the hand counts in their docstrings."""
from __future__ import annotations

import json

import torch

from bench.lib import spec
from bench.lib.model import make_params, model_config
from bench.work import kv_bytes, model_flops, step_bytes


def _cfg(name):
    with open(spec.ROOT / "bench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_model_flops_by_hand():
    r1, moe = _cfg("r1-distill-14b"), _cfg("qwen3-moe-235b-a22b")
    assert model_flops.matmul_params(r1) == 13_990_625_280
    assert model_flops.attention_flops_per_context_token(r1) == 983_040
    assert model_flops.matmul_params(moe) == 2_404_909_056
    assert model_flops.attention_flops_per_context_token(moe) == 262_144
    assert model_flops.step_flops(r1, 3, 100) == \
        2 * 13_990_625_280 * 3 + 983_040 * 100


def test_kv_bytes_by_hand():
    r1 = _cfg("r1-distill-14b")
    assert kv_bytes.kv_token_bytes(r1) * 48 == 196_608
    # two siblings share a 16-token page; 5 tokens each of their own
    tables = [([7, 8], 21), ([7, 9], 21)]
    assert kv_bytes.unique_tokens(tables, 16) == 26
    assert kv_bytes.decode_bytes(r1, tables, 16) == \
        26 * 196_608 + 1_966_080
    # a page a row has not reached counts only what rows attend
    assert kv_bytes.unique_tokens([([3, 4, 5], 17)], 16) == 17


def test_step_bytes_by_hand():
    r1 = _cfg("r1-distill-14b")
    small = dict(r1, num_hidden_layers=1, hidden_size=64,
                 num_attention_heads=4, num_key_value_heads=2,
                 intermediate_size=96, vocab_size=50)
    params = make_params(model_config(small), 0, "cpu", torch.bfloat16)
    # a layer: q,k,v,o 64*64 + 2*64*32 + 64*64, biases 64 + 32 + 32,
    # SwiGLU 3*64*96, in bf16; two fp32 norm scales of 64; the final
    # norm 64 fp32; the LM head 64*50 bf16
    layer = (64 * 64 + 2 * 64 * 32 + 64 * 64 + 128 + 3 * 64 * 96) * 2 \
        + 2 * 64 * 4
    assert step_bytes.weight_bytes(params) == layer + 64 * 4 + 64 * 50 * 2
    assert step_bytes.step_bytes(small, params, 10) == \
        step_bytes.weight_bytes(params) + 10 * 2 * 2 * 16 * 2
