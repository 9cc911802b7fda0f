"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

Audio decoder backbone only: the EnCodec conv codec frontend is stubbed per
the assignment; input_specs() provides frame embeddings. Sinusoidal
positions, LayerNorm, non-gated GELU MLP, full MHA (kv=24), vocab = 2048
EnCodec codebook entries.
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    vocab_size=2048,
    num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144,
    mlp_activation="gelu", mlp_gated=False,
    pos_embedding="sinusoidal",
    norm_type="layernorm",
    max_seq_len=32768,
)
