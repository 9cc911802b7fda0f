"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

Pure Mamba2 stack: no attention, no MLP (d_ff=0); d_inner = 2*d_model = 1536,
head_dim 64 -> 24 SSD heads, state N=128, depthwise conv width 4.
Decode state is O(1) in sequence length -> runs long_500k natively.
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    num_heads=24, num_kv_heads=24,     # unused (attention-free)
    d_ff=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    norm_type="rmsnorm",
    pos_embedding="none",
    tie_embeddings=True,
    max_seq_len=1 << 20,
)
