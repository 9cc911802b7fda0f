"""Assigned-architecture registry: ``get_config(arch_id)`` / ``--arch``.

Ten architectures from the public pool (six families) + the paper's own
model family. Each module documents its source; ``smoke(arch_id)`` returns
the reduced CPU-testable variant of the same family.
"""
from ..models import ModelConfig, smoke_variant
from . import (dbrx_132b, gemma_7b, hymba_1_5b, mamba2_130m,
               musicgen_medium, nemotron_4_15b, qwen2_0_5b, qwen2_vl_72b,
               qwen3_moe_235b, r1_distill_14b, stablelm_1_6b)

REGISTRY = {
    "mamba2-130m": mamba2_130m.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "stablelm-1.6b": stablelm_1_6b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "r1-distill-14b": r1_distill_14b.CONFIG,
}

ASSIGNED = [k for k in REGISTRY if k != "r1-distill-14b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def smoke(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))
