"""stablelm-1.6b — full MHA, partial rotary [hf:stabilityai/stablelm-2-1_6b]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    vocab_size=100352,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632,
    mlp_activation="silu", mlp_gated=True,
    rope_pct=0.25,
    norm_type="layernorm",
    max_seq_len=32768,
)
