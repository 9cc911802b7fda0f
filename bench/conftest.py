"""A cell small enough for the CPU, for the benchmark's own tests: the
harness runs it end to end on the program's plain paths (fp32)."""
from __future__ import annotations

import copy

import pytest

from bench.lib import spec

TINY = {
    "name": "tiny", "source": "test", "family": "dense",
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "intermediate_size": 96, "num_hidden_layers": 2,
    "vocab_size": 97, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "max_position_embeddings": 4096,
    "hidden_act": "silu", "eos_token_id": 1, "serve_dtype": "float32",
    "qkv_bias": True,
}

TINY_MOE = dict(TINY, family="moe", qkv_bias=False, num_experts=8,
                num_experts_per_tok=2, moe_intermediate_size=32,
                moe_capacity_factor=4.0, norm_topk_prob=True,
                router_aux_loss_coef=0.001)

TINY_WORKLOAD = {
    "config": "tiny", "traffic": "tiny",
    "arrivals": {"kind": "open_poisson", "rate_per_s": 4.0},
    "prompts": {"median": 12, "sigma": 0.5, "min": 4, "max": 40},
    "warmup_s": 1.0,
    "sart": {"policy": "sart", "n": 4, "m": 2, "alpha": 0.5, "beta": 2,
             "window": 4, "max_tokens": 12},
    "sampling": {"temperature": 0.9, "top_p": 0.95}, "prm_noise": 0.05,
    "engine": {"page_size": 4, "num_pages": 512, "max_slots": 16,
               "max_pages_per_branch": 16, "prefill_chunk": 8,
               "mixed_step_kernel": "fused", "step_token_budget": 0,
               "decode_kernel": "paged", "prefix_cache": False},
    "check": {"requests": 3, "limits": {"logit_gap_max": 1e-3}},
    "trace": {"seconds": 0.5},
}

E2E = ("answer_p90_s", "ttft_p90_s", "itl_p95_ms", "tokens_per_s", "setup_s")


def tiny_cell(config=None, **workload) -> spec.Cell:
    wl = copy.deepcopy(TINY_WORKLOAD)
    wl.update(workload)
    metrics = [{"name": n, "unit": "s"} for n in E2E]
    return spec.Cell("tiny.tiny", {"chips": 1}, dict(config or TINY), wl,
                     metrics, [], spec.ROOT)


@pytest.fixture
def one_thread():
    """One CPU thread for a served run: the test workers share the
    machine, and a tiny model gains nothing from more."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
