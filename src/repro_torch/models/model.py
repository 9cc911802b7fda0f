"""Decoder-only model of the dense, ssm and hybrid families, as a PyTorch
module.

Counterpart of ``repro.models.model``. The weights keep the JAX pytree's
key paths and layout: per-layer tensors are stacked along a leading
``[L, ...]`` axis, matrices are ``[in, out]``, norm scales and the
Mamba2 mixer's ``a_log``/``dt_bias`` are fp32. ``Model`` holds them as
non-trainable parameters under those paths (``weights.embed.lm_head``,
``weights.layers.attn.wq``, ``weights.layers.mamba.in_proj``, ...); the
functional layer code and the engine take the nested dict itself. The
serving engine loops over layers in Python where the reference scans.
``forward``, ``prefill`` and ``decode_step`` over the dense cache are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .attention import init_attention
from .config import ModelConfig
from .layers import init_embedding, init_mlp, init_norm
from .mamba2 import init_mamba2

Params = Dict[str, Any]


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    p: Params = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if cfg.uses_attention:
        p["attn"] = init_attention(gen, cfg, dtype, device)
    if cfg.uses_ssm:
        p["mamba"] = init_mamba2(gen, cfg, dtype, device)
    if cfg.d_ff:
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        p["mlp"] = init_mlp(gen, cfg, dtype, device)
    return p


def _stack_into(dst: Params, layer: Params, i: int, num_layers: int) -> None:
    """Write one layer's tree into the stacked ``[L, ...]`` tree, making
    each stacked tensor on first use (one layer of temporaries at a
    time, so a 48-layer model never holds an fp32 copy of itself)."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _stack_into(dst.setdefault(k, {}), v, i, num_layers)
            continue
        if k not in dst:
            dst[k] = torch.empty((num_layers,) + tuple(v.shape),
                                 dtype=v.dtype, device=v.device)
        dst[k][i] = v


def _module_tree(tree: Params) -> nn.Module:
    sub, leaves = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub[k] = _module_tree(v)
        else:
            leaves[k] = nn.Parameter(v, requires_grad=False)
    if leaves and not sub:
        return nn.ParameterDict(leaves)
    mod = nn.ModuleDict(sub)
    for k, v in leaves.items():
        mod.register_parameter(k, v)
    return mod


class Model(nn.Module):
    """Decoder: ``cfg``, compute ``dtype`` and ``device`` (the card
    unless the caller names another), weights bound by ``init_params``
    or ``load_params``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.weights: Optional[nn.Module] = None

    def init_params(self, gen: torch.Generator) -> Params:
        """Random weights from ``gen`` (a generator on ``self.device``),
        the layout of ``Model.init_params``. MoE layers are not ported
        yet and raise."""
        cfg = self.cfg
        if cfg.uses_moe:
            raise NotImplementedError("moe layers are not ported yet")
        embed = init_embedding(gen, cfg, self.dtype, self.device)
        layers: Params = {}
        for i in range(cfg.num_layers):
            _stack_into(layers, _init_layer(gen, cfg, self.dtype,
                                            self.device), i, cfg.num_layers)
        params = {"embed": embed, "layers": layers,
                  "final_norm": init_norm(cfg, cfg.d_model, self.device)}
        self.load_params(params)
        return params

    def load_params(self, params: Params) -> None:
        """Bind a params tree (same tensors, no copy) as this module's
        non-trainable parameters under the JAX key paths."""
        self.weights = _module_tree(params)


#: leaves the reference keeps in fp32 whatever the model dtype
#: (``mamba2.init_mamba2``); norm scales and biases are the others
_FP32_LEAVES = ("a_log", "dt_bias")


def _is_fp32_key(key: str) -> bool:
    parts = key.split("/")
    return parts[-1] in _FP32_LEAVES or any(
        part.startswith("norm") or part == "final_norm"
        for part in parts[:-1])


def params_from_numpy(flat: Mapping[str, np.ndarray], *,
                      device: Optional[torch.device] = None,
                      dtype=torch.float32) -> Params:
    """Slash-keyed numpy arrays (the ``lm.npz`` format of
    ``training/checkpoint.py``) -> the port's nested params, same keys.
    Norm scales and biases stay fp32, as ``layers.init_norm`` makes them,
    and so do the mixer's ``a_log`` and ``dt_bias``, as
    ``mamba2.init_mamba2`` makes them; every other leaf takes ``dtype``."""
    dev = resolve_device(device)
    root: Params = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        dt = torch.float32 if _is_fp32_key(key) else dtype
        t = torch.from_numpy(np.asarray(arr, np.float32).copy())
        node[parts[-1]] = t.to(device=dev, dtype=dt)
    return root
