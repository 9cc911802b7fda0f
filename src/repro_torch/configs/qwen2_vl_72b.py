"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191].

VLM decoder backbone only: the ViT vision frontend is stubbed per the
assignment; input_specs() provides patch embeddings. M-RoPE splits rotary
frequencies into (temporal, height, width) sections (16/24/24).
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    vocab_size=152064,
    num_heads=64, num_kv_heads=8, head_dim=128,
    qkv_bias=True,
    d_ff=29568,
    mlp_activation="silu", mlp_gated=True,
    pos_embedding="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    norm_type="rmsnorm",
    max_seq_len=32768,
)
