"""The engine targets stepcheck traces: tiny configs, fake weights.

Counterpart of ``tools/stepcheck/harness.py``, with the same targets:
dense, ssm and hybrid, each with the prefix cache off and on, and
dense+tree and hybrid+tree; models in bf16 (so that every silent fp32
upcast of the step is visible to STEP005), 2 layers, d_model 64, vocab 97,
4 query and 2 KV heads; the same ``ENGINE_KW``. The model, its params and
the engine's state are built under one ``FakeTensorMode``
(``build_engine``), so no weight is materialised and the step body runs
on the CPU as shapes and dtypes only (``tracing.trace_variant``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import Model, ModelConfig
from ..serving import Engine, EngineConfig, StepVariant
from ..serving.simulator import SimEngine, SimEngineConfig, SimWorkload

#: the three assigned architecture families, smoke-sized
FAMILY_CONFIGS: Dict[str, dict] = {
    "dense": dict(d_ff=128),
    "ssm": dict(ssm_state=16, ssm_head_dim=32, ssm_chunk=8, d_ff=0),
    "hybrid": dict(ssm_state=16, ssm_head_dim=32, ssm_chunk=8, d_ff=128),
}

#: engine geometry shared by every target: two buckets (4, 8) x two lane
#: configs (1, 2) under a 16-token budget -> 1 + 2 x 2 = 5 variants each
ENGINE_KW = dict(page_size=4, num_pages=64, max_slots=4,
                 max_pages_per_branch=12, prefill_chunk=8,
                 step_token_budget=16)


@dataclasses.dataclass
class EngineTarget:
    """One engine under analysis, its variants and the fake mode its
    tensors live in."""

    name: str                      # "engine[hybrid]" / "engine[hybrid+cache]"
    family: str
    cache: bool
    engine: Engine
    variants: List[StepVariant]
    mode: FakeTensorMode


def model_config(family: str) -> ModelConfig:
    return ModelConfig(name=f"stepcheck-{family}", arch_type=family,
                       num_layers=2, d_model=64, vocab_size=97,
                       num_heads=4, num_kv_heads=2,
                       **FAMILY_CONFIGS[family])


def build_engine(family: str, cache: bool = False, tree: bool = False
                 ) -> Tuple[Engine, FakeTensorMode]:
    """An engine over fake bf16 weights (no weight exists) and the mode
    its tensors belong to."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        model = Model(model_config(family), dtype=torch.bfloat16,
                      device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        cfg = EngineConfig(prefix_cache=cache,
                           decode_kernel="tree" if tree else "paged",
                           **ENGINE_KW)
        engine = Engine(model, params, cfg)
    return engine, mode


def build_targets(include_cache: bool = True) -> List[EngineTarget]:
    """Every target, cache-off first (the body rules run on cache-off
    targets; the cache-on twins pin signature invariance), then one
    tree-decode target per attention family."""
    out: List[EngineTarget] = []
    for cache in ([False, True] if include_cache else [False]):
        for family in FAMILY_CONFIGS:
            eng, mode = build_engine(family, cache)
            suffix = "+cache" if cache else ""
            out.append(EngineTarget(
                name=f"engine[{family}{suffix}]", family=family,
                cache=cache, engine=eng, variants=eng.step_variants(),
                mode=mode))
    for family in ("dense", "hybrid"):   # "ssm" has no attention
        eng, mode = build_engine(family, tree=True)
        out.append(EngineTarget(
            name=f"engine[{family}+tree]", family=family, cache=False,
            engine=eng, variants=eng.step_variants(), mode=mode))
    return out


def sim_variant_names() -> List[str]:
    """Variant names of a SimEngine matched to ``ENGINE_KW``'s budget and
    chunk: STEP001 holds them to a subset of the engine's."""
    cfg = SimEngineConfig(page_size=4, num_pages=64, max_slots=4,
                          prefill_chunk=8, step_token_budget=16)
    sim = SimEngine(cfg, SimWorkload())
    return [v.name for v in sim.step_variants()]
