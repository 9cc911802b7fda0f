"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    vocab_size=151936,
    num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536,                      # per-expert FFN width (fine-grained)
    mlp_activation="silu", mlp_gated=True,
    num_experts=128, num_experts_per_tok=8,
    moe_capacity_factor=1.25,
    norm_topk_prob=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
    max_seq_len=32768,
)
