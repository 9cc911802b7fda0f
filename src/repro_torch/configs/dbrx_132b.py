"""dbrx-132b — 16 experts top-4, fine-grained MoE [hf:databricks/dbrx-base]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    vocab_size=100352,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752,
    mlp_activation="silu", mlp_gated=True,
    num_experts=16, num_experts_per_tok=4,
    moe_capacity_factor=1.25,
    rope_theta=5e5,
    norm_type="layernorm",
    max_seq_len=32768,
)
