"""Model configuration covering all six assigned architecture families.

A single ``ModelConfig`` describes dense GQA transformers, MoE transformers,
pure SSM (Mamba2/SSD) stacks, hybrid (parallel attention+SSM) blocks, and the
VLM/audio decoder backbones (whose modality frontends are stubbed per the
assignment; the config only describes the decoder that consumes embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
ACTIVATIONS = ("silu", "gelu", "relu2")
POS_EMBEDDINGS = ("rope", "mrope", "sinusoidal", "none")
NORM_TYPES = ("rmsnorm", "layernorm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str = "unnamed"
    arch_type: str = "dense"          # one of ARCH_TYPES
    source: str = ""                  # citation for the architecture

    # --- trunk dimensions ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    vocab_size: int = 512

    # --- attention ----------------------------------------------------------
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    pos_embedding: str = "rope"
    rope_theta: float = 10000.0
    rope_pct: float = 1.0             # partial rotary (stablelm-2: 0.25)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl M-RoPE
    sliding_window: int = 0           # 0 -> full causal attention
    attn_logit_softcap: float = 0.0   # 0 -> disabled

    # --- MLP ----------------------------------------------------------------
    d_ff: int = 0                     # 0 -> no MLP (pure mamba2 stack)
    mlp_activation: str = "silu"
    mlp_gated: bool = True            # SwiGLU / GeGLU when True
    mlp_bias: bool = False

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0              # 0 -> dense FFN
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    norm_topk_prob: bool = True

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0                # N, the SSD state dimension
    ssm_expand: int = 2               # d_inner = ssm_expand * d_model
    ssm_head_dim: int = 64            # P
    ssm_groups: int = 1               # G (B/C groups)
    ssm_conv_width: int = 4
    ssm_chunk: int = 64               # SSD chunk length

    # --- norms / embeddings ------------------------------------------------
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    embedding_scale: bool = False     # gemma: scale embeds by sqrt(d_model)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- serving / context --------------------------------------------------
    max_seq_len: int = 32768

    def __post_init__(self):
        assert self.arch_type in ARCH_TYPES, self.arch_type
        assert self.mlp_activation in ACTIVATIONS, self.mlp_activation
        assert self.pos_embedding in POS_EMBEDDINGS, self.pos_embedding
        assert self.norm_type in NORM_TYPES, self.norm_type
        if self.uses_attention:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                self.num_heads, self.num_kv_heads)
        if self.num_experts:
            assert 0 < self.num_experts_per_tok <= self.num_experts
        if self.arch_type in ("ssm", "hybrid"):
            assert self.ssm_state > 0

    # --- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def gqa_groups(self) -> int:
        """Query heads per KV head — the GQA group size the attention
        kernels tile along the sublane dimension."""
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def uses_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def multimodal(self) -> bool:
        """VLM/audio backbones consume precomputed frontend embeddings."""
        return self.arch_type in ("vlm", "audio")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline maths)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        per_layer = 0
        if self.uses_attention:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            per_layer += q + kv + o
            if self.qkv_bias:
                per_layer += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.uses_ssm:
            di, g, ns, hh = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * g * ns + hh)
            conv = (di + 2 * g * ns) * self.ssm_conv_width
            per_layer += in_proj + conv + hh * 3 + di + di * d  # A,D,dt_bias,norm,out
        if self.d_ff:
            mults = 3 if self.mlp_gated else 2
            ff = mults * d * self.d_ff
            if self.uses_moe:
                per_layer += self.num_experts * ff + d * self.num_experts
            else:
                per_layer += ff
        per_layer += 2 * d  # norms
        return n + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.uses_moe:
            return self.param_count()
        full = self.param_count()
        mults = 3 if self.mlp_gated else 2
        ff = mults * self.d_model * self.d_ff
        inactive = (self.num_experts - self.num_experts_per_tok) * ff
        return full - self.num_layers * inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests.

    2 layers, d_model<=512, <=4 experts, small vocab/context — preserves the
    family-defining structure (GQA ratio, gating, SSM dims, MoE top-k).
    """
    d = min(cfg.d_model, 256)
    heads = max(2, min(cfg.num_heads, 4))
    kv_ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    kv = max(1, heads // min(kv_ratio, heads))
    experts = min(cfg.num_experts, 4)
    topk = min(cfg.num_experts_per_tok, 2) if experts else 0
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=experts,
        num_experts_per_tok=topk,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        max_seq_len=256,
    )
