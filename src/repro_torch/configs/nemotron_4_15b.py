"""nemotron-4-15b — GQA, squared-ReLU MLP, 256k vocab [arXiv:2402.16819]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    source="arXiv:2402.16819",
    num_layers=32,
    d_model=6144,
    vocab_size=256000,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576,
    mlp_activation="relu2", mlp_gated=False,
    rope_pct=0.5,
    norm_type="layernorm",
    max_seq_len=32768,
)
