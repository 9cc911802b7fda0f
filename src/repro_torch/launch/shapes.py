"""Assigned input shapes and input stand-ins per (arch, shape).

Counterpart of ``repro.launch.shapes``. Decode shapes run ``serve_step``
(one new token against a ``seq_len`` cache); ``train_4k`` runs
``train_step``; ``prefill_32k`` runs ``prefill_step``.

``long_500k`` needs sub-quadratic attention state: ssm and hybrid run
natively; attention archs without a window are adapted to sliding-window
attention (window 8192, a ring-buffer KV cache), as the reference does.
VLM and audio backbones take precomputed frontend embeddings (``embeds``)
for train and prefill, token ids for decode.

The stand-ins are meta tensors of the global shapes: nothing is
allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models import Model, ModelConfig

LONG_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def adapt_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Shape-specific config adaptation (long-context window carve-out)."""
    cfg = cfg.replace(max_seq_len=max(cfg.max_seq_len, shape.seq_len))
    if shape.name == "long_500k" and cfg.uses_attention \
            and not cfg.sliding_window:
        cfg = cfg.replace(sliding_window=LONG_WINDOW)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16
                ) -> Dict[str, object]:
    """Meta-tensor stand-ins for every model input (``None`` where the
    config takes the other of tokens and embeds)."""
    b, s = shape.global_batch, shape.seq_len
    i64 = torch.int64
    if shape.kind == "train":
        specs = {"labels": _meta((b, s), i64),
                 "mask": _meta((b, s), torch.float32)}
        if cfg.multimodal:
            specs["embeds"] = _meta((b, s, cfg.d_model), dtype)
            specs["tokens"] = None
        else:
            specs["tokens"] = _meta((b, s), i64)
            specs["embeds"] = None
        return specs
    if shape.kind == "prefill":
        if cfg.multimodal:
            return {"embeds": _meta((b, s, cfg.d_model), dtype),
                    "tokens": None}
        return {"tokens": _meta((b, s), i64), "embeds": None}
    # decode: one token against a seq_len-deep cache
    model = Model(cfg, dtype=dtype, device="meta")
    return {"tokens": _meta((b,), i64), "positions": _meta((b,), i64),
            "cache": model.init_cache(b, s)}
