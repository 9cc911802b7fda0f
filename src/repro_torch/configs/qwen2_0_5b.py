"""qwen2-0.5b — GQA with QKV bias [arXiv:2407.10671]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    vocab_size=151936,
    num_heads=14, num_kv_heads=2, head_dim=64,
    qkv_bias=True,
    d_ff=4864,
    mlp_activation="silu", mlp_gated=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
    tie_embeddings=True,
    max_seq_len=32768,
)
