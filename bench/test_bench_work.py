"""The work functions and the families' counts against the hand counts in
their docstrings, and the families' weights against digests taken before
the weights' code moved into ``bench/families/``."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from bench.conftest import TINY, TINY_MOE
from bench.families import dense, moe
from bench.lib import spec
from bench.work import kv_bytes, model_flops, step_bytes


def _cfg(name):
    with open(spec.ROOT / "bench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _digest(tree) -> str:
    """sha256 over every leaf's path, type, shape and bytes, by path."""
    h = hashlib.sha256()

    def walk(prefix, t):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(prefix + k + "/", v)
            else:
                h.update(f"{prefix}{k} {v.dtype} {tuple(v.shape)}".encode())
                h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    walk("", tree)
    return h.hexdigest()


@pytest.mark.parametrize("family,config,dtype,want", [
    (dense, TINY, torch.float32,
     "82c23238b991bb3d039e517d69aef486f9b73fd3d2be9f1f845e0b4aaf17559f"),
    (dense, TINY, torch.bfloat16,
     "552f800fdc1ddc2991cf60807fb4af34e41992a232422536272b630b0304a84e"),
    (moe, TINY_MOE, torch.float32,
     "83714cbf0cc246295d180fe0295864a3b38b1859091bb65d0c62bf0c3ef1cbc2"),
    (moe, TINY_MOE, torch.bfloat16,
     "300146e0ca251c1e30e7d31e96582e436a5c7a51aace89b497b99977677e2d0e")],
    ids=["dense-fp32", "dense-bf16", "moe-fp32", "moe-bf16"])
def test_family_weights_match_their_digest(family, config, dtype, want):
    # the same draws, in the same order, from the same generator as
    # before the families: weights from a seed are the same bit for bit
    params = family.make_params(family.model_config(config), 2**31 + 5,
                                "cpu", dtype)
    assert _digest(params) == want


def test_model_flops_by_hand():
    r1, q3 = _cfg("r1-distill-14b"), _cfg("qwen3-moe-235b-a22b")
    assert dense.matmul_params(r1) == 13_990_625_280
    assert dense.context_flops(r1) == 983_040
    assert moe.matmul_params(q3) == 2_404_909_056
    assert moe.context_flops(q3) == 262_144
    assert model_flops.step_flops(dense, r1, 3, 100) == \
        2 * 13_990_625_280 * 3 + 983_040 * 100
    # every layer of both holds K/V, and neither keeps a recurrent state
    assert (dense.attention_layers(r1), moe.attention_layers(q3)) == (48, 8)
    assert dense.state_bytes(r1) == moe.state_bytes(q3) == 0


def test_kv_bytes_by_hand():
    r1 = _cfg("r1-distill-14b")
    assert kv_bytes.kv_token_bytes(r1) * 48 == 196_608
    # two siblings share a 16-token page; 5 tokens each of their own
    tables = [([7, 8], 21), ([7, 9], 21)]
    assert kv_bytes.unique_tokens(tables, 16) == 26
    assert kv_bytes.decode_bytes(dense, r1, tables, 16) == \
        26 * 196_608 + 1_966_080
    # a page a row has not reached counts only what rows attend
    assert kv_bytes.unique_tokens([([3, 4, 5], 17)], 16) == 17


def test_step_bytes_by_hand():
    r1 = _cfg("r1-distill-14b")
    small = dict(r1, num_hidden_layers=1, hidden_size=64,
                 num_attention_heads=4, num_key_value_heads=2,
                 intermediate_size=96, vocab_size=50)
    params = dense.make_params(dense.model_config(small), 0, "cpu",
                               torch.bfloat16)
    # a layer: q,k,v,o 64*64 + 2*64*32 + 64*64, biases 64 + 32 + 32,
    # SwiGLU 3*64*96, in bf16; two fp32 norm scales of 64; the final
    # norm 64 fp32; the LM head 64*50 bf16
    layer = (64 * 64 + 2 * 64 * 32 + 64 * 64 + 128 + 3 * 64 * 96) * 2 \
        + 2 * 64 * 4
    assert step_bytes.weight_bytes(params) == layer + 64 * 4 + 64 * 50 * 2
    assert step_bytes.step_bytes(dense, small, params, 10, 3) == \
        step_bytes.weight_bytes(params) + 10 * 2 * 2 * 16 * 2
