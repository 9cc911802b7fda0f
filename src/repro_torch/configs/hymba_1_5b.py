"""hymba-1.5b — parallel attention+mamba heads per block [arXiv:2411.13676].

Hybrid-head block: attention and SSD paths read the same normed input in
parallel; outputs are averaged (the paper's learnable fusion simplified to
mean — noted in DESIGN.md). Sliding-window attention (most Hymba layers are
SWA) + constant-size SSM state -> long_500k runs with O(window) attention
state. Meta tokens are not implemented (DESIGN.md §Arch-applicability).
"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    vocab_size=32001,
    num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504,
    mlp_activation="silu", mlp_gated=True,
    sliding_window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    norm_type="rmsnorm",
    max_seq_len=1 << 20,
)
