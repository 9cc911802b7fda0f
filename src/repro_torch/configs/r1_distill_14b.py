"""r1-distill-qwen-14b-like — the paper's own serving model family
[arXiv:2501.12948, DeepSeek-R1-Distill-Qwen-14B]. Not part of the assigned
pool; used by the paper-faithful serving experiments."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="r1-distill-14b",
    arch_type="dense",
    source="arXiv:2501.12948",
    num_layers=48,
    d_model=5120,
    vocab_size=152064,
    num_heads=40, num_kv_heads=8, head_dim=128,
    qkv_bias=True,
    d_ff=13824,
    mlp_activation="silu", mlp_gated=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
    max_seq_len=32768,
)
