"""gemma-7b — GeGLU, head_dim=256, embeddings scaled by sqrt(d) [arXiv:2403.08295]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    vocab_size=256000,
    num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576,
    mlp_activation="gelu", mlp_gated=True,   # GeGLU
    norm_type="rmsnorm",
    embedding_scale=True,
    tie_embeddings=True,
    max_seq_len=32768,
)
