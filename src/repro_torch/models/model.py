"""Decoder-only model of every family (dense, moe, ssm, hybrid, vlm,
audio), as a PyTorch module.

Counterpart of ``repro.models.model``. The weights keep the JAX pytree's
key paths and layout: per-layer tensors are stacked along a leading
``[L, ...]`` axis, matrices are ``[in, out]``, norm scales and the
Mamba2 mixer's ``a_log``/``dt_bias`` are fp32. ``Model`` holds them as
non-trainable parameters under those paths (``weights.embed.lm_head``,
``weights.layers.attn.wq``, ``weights.layers.moe.w_up``, ...); the
functional layer code and the engine take the nested dict itself.

Entry points, as the reference's: ``forward`` (full-sequence logits),
``prefill`` (the prompt, seeding the dense decode cache) and
``decode_step`` (one token against it). A Python loop over the stacked
layers takes the place of ``jax.lax.scan``. The cache (``init_cache``:
``k``/``v`` ``[L, B, S_max, KV, hd]``, a ring buffer of the window with
a sliding window; ``conv``/``ssd`` for ssm/hybrid) is written IN PLACE by
``prefill`` and ``decode_step``, which return the same dict: at full
width a second copy would cost as much memory as the cache itself. The
full-sequence attention of ``forward`` and ``prefill`` is kernel K5 on the
card where it applies (``attention.py``; in training its forward and
backward), the ssm mixer's scan kernel K4 (in training through
``SsdScanFn``: its forward writing the chunk states, and its backward).
``forward`` with trainable layer params recomputes each layer in the
backward pass (``torch.utils.checkpoint``), so a train step launches K4's
(and K5's) forward twice per layer and its backward once.
MoE layers run the capacity dispatch of ``moe.py`` and ``forward`` sums
their aux losses; vlm configs rotate by M-RoPE over ``[B, S, 3]``
positions (``[B, S]`` ones are broadcast to three equal streams); audio
configs add sinusoidal position embeddings to the inputs. vlm and audio
take ``embeds`` (the stubbed frontend's output) in place of token ids.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import (attention_decode, attention_prefill, attention_train,
                        init_attention)
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, embed_tokens, init_embedding,
                     init_mlp, init_norm, positions_for, sinusoidal_embedding,
                     unembed)
from .mamba2 import (init_mamba2, init_mamba2_state, mamba2_decode,
                     mamba2_forward)
from .moe import apply_moe, init_moe

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    p: Params = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if cfg.uses_attention:
        p["attn"] = init_attention(gen, cfg, dtype, device)
    if cfg.uses_ssm:
        p["mamba"] = init_mamba2(gen, cfg, dtype, device)
    if cfg.d_ff:
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        if cfg.uses_moe:
            p["moe"] = init_moe(gen, cfg, dtype, device)
        else:
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


def _leaves(tree: Params):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def layer_slices(layers: Params, num_layers: int) -> List[Params]:
    """Per-layer views of the stacked ``[L, ...]`` params (no copies)."""
    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [pick(layers, i) for i in range(num_layers)]


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
        the layout of ``Model.init_params``."""
        cfg = self.cfg
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

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """Zero decode cache for ``max_len`` tokens of context on this
        model's device. With a sliding window the attention cache is a
        ring buffer of ``min(max_len, window)`` slots. At full width the
        default ``cfg.max_seq_len`` is large (32,768 tokens of the 14B are
        6.4 GB), so callers on the card pass ``max_len``."""
        cfg = self.cfg
        cache: Cache = {}
        if cfg.uses_attention:
            klen = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                    else max_len)
            shape = (cfg.num_layers, batch, klen, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            for key in ("k", "v"):
                cache[key] = torch.zeros(shape, dtype=self.dtype,
                                         device=self.device)
        if cfg.uses_ssm:
            conv, ssd = init_mamba2_state(cfg, batch, self.dtype, self.device)
            cache["conv"] = conv.new_zeros((cfg.num_layers,) + conv.shape)
            cache["ssd"] = ssd.new_zeros((cfg.num_layers,) + ssd.shape)
        return cache

    def _embed_inputs(self, params: Params, tokens, embeds) -> torch.Tensor:
        """Token embeddings (or ``embeds``), plus sinusoidal embeddings of
        positions 0..S-1 for audio configs."""
        if embeds is not None:
            x = embeds.to(self.dtype)
        else:
            x = embed_tokens(self.cfg, params["embed"], tokens)
        if self.cfg.pos_embedding == "sinusoidal":
            pos = torch.arange(x.shape[1], device=x.device)
            x = x + sinusoidal_embedding(pos, self.cfg.d_model)[None].to(
                x.dtype)
        return x

    def _positions(self, positions, b: int, s: int, device):
        """The given positions, or 0..S-1 for every row, in the form the
        config's rotary takes (``positions_for``)."""
        if positions is None:
            positions = torch.arange(s, device=device)[None].expand(b, s)
        return positions_for(self.cfg, positions)

    def _run_layers(self, params: Params, step, x, cache: Optional[Cache]):
        """x through every layer: ``step(layer params, layer cache, x)``
        with the layer's views of the stacked cache; each step returns (x,
        its MoE aux loss or None). Returns (x, the aux losses' fp32 sum)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in enumerate(layer_slices(params["layers"],
                                            self.cfg.num_layers)):
            layer_cache = ({k: v[i] for k, v in cache.items()}
                           if cache is not None else None)
            x, aux_l = step(lp, layer_cache, x)
            if aux_l is not None:
                aux = aux + aux_l
        return x, aux

    def forward(self, params: Params, tokens=None, embeds=None,
                positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits [B,S,V], aux_loss): the
        sum over layers of the MoE load-balance losses, 0 without MoE.
        With grad enabled and a trainable layer param, each layer runs
        under ``torch.utils.checkpoint`` and is recomputed in the backward
        pass."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens, embeds)
        b, s, _ = x.shape
        positions = self._positions(positions, b, s, x.device)

        def layer(lp, _, x):
            return self._layer_train(lp, x, positions)

        def layer_recomputed(lp, _, x):
            # the reference's jax.checkpoint(nothing_saveable): a layer's
            # activations live only while its gradient is taken
            return checkpoint(layer, lp, None, x, use_reentrant=False)
        train = torch.is_grad_enabled() and any(
            t.requires_grad for t in _leaves(params["layers"]))
        x, aux = self._run_layers(params, layer_recomputed if train
                                  else layer, x, None)
        x = apply_norm(cfg, params["final_norm"], x)
        return unembed(cfg, params["embed"], x), aux

    def _layer_train(self, p: Params, x, positions):
        cfg = self.cfg
        h = apply_norm(cfg, p["norm1"], x)
        mix = None
        if cfg.uses_attention:
            mix = attention_train(cfg, p["attn"], h, positions)
        if cfg.uses_ssm:
            y, _ = mamba2_forward(cfg, p["mamba"], h)
            mix = y if mix is None else mix + y
        return self._finish_layer(p, x, mix)

    def _finish_layer(self, p: Params, x, mix):
        """Residual of the mixer (hybrids average their two heads, as
        Hymba), then the MLP or MoE block over every row of x. Returns (x,
        the MoE aux loss or None)."""
        cfg = self.cfg
        if cfg.arch_type == "hybrid":
            mix = mix * 0.5
        x = x + mix
        aux = None
        if cfg.d_ff:
            h = apply_norm(cfg, p["norm2"], x)
            if cfg.uses_moe:
                y, aux = apply_moe(cfg, p["moe"], h)
            else:
                y = apply_mlp(cfg, p["mlp"], h)
            x = x + y
        return x, aux

    def prefill(self, params: Params, tokens=None, embeds=None,
                positions=None, cache: Optional[Cache] = None,
                max_len: Optional[int] = None):
        """Process the prompt and seed the cache (``init_cache(B, max_len
        or cfg.max_seq_len)`` unless one is passed; written in place).
        Returns (logits of the last position [B,V], cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens, embeds)
        b, s, _ = x.shape
        positions = self._positions(positions, b, s, x.device)
        if cache is None:
            cache = self.init_cache(b, max_len or cfg.max_seq_len)
        x, _ = self._run_layers(
            params, lambda lp, lc, x: self._layer_prefill(lp, lc, x,
                                                          positions, s),
            x, cache)
        x = apply_norm(cfg, params["final_norm"], x[:, -1:])
        return unembed(cfg, params["embed"], x)[:, 0], cache

    def _layer_prefill(self, p: Params, layer_cache: Cache, x, positions,
                       s: int):
        cfg = self.cfg
        h = apply_norm(cfg, p["norm1"], x)
        mix = None
        if cfg.uses_attention:
            mix, (k, v) = attention_prefill(cfg, p["attn"], h, positions)
            for key, new in (("k", k), ("v", v)):
                dst = layer_cache[key]
                klen = dst.shape[1]
                if s <= klen:
                    dst[:, :s] = new
                else:  # a ring smaller than the prompt: the tail at p % klen
                    dst.copy_(torch.roll(new[:, -klen:], s % klen, dims=1))
        if cfg.uses_ssm:
            y, (conv, ssd) = mamba2_forward(cfg, p["mamba"], h)
            mix = y if mix is None else mix + y
            layer_cache["conv"].copy_(conv)
            layer_cache["ssd"].copy_(ssd)
        return self._finish_layer(p, x, mix)

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Cache, positions: torch.Tensor):
        """tokens [B] int, positions [B] absolute positions; the cache is
        updated in place. Returns (logits [B,V], cache, hidden [B,D]) —
        ``hidden`` feeds the PRM reward head."""
        cfg = self.cfg
        x = embed_tokens(cfg, params["embed"], tokens[:, None])
        if cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_embedding(positions, cfg.d_model)[:, None].to(
                x.dtype)
        x, _ = self._run_layers(
            params, lambda lp, lc, x: self._layer_decode(lp, lc, x,
                                                         positions),
            x, cache)
        hidden = apply_norm(cfg, params["final_norm"], x)[:, 0]
        return unembed(cfg, params["embed"], hidden), cache, hidden

    def _layer_decode(self, p: Params, layer_cache: Cache, x, positions):
        cfg = self.cfg
        h = apply_norm(cfg, p["norm1"], x)
        mix = None
        if cfg.uses_attention:
            mix, _, _ = attention_decode(cfg, p["attn"], h, layer_cache["k"],
                                         layer_cache["v"], positions)
        if cfg.uses_ssm:
            y, conv, ssd = mamba2_decode(cfg, p["mamba"], h,
                                         layer_cache["conv"],
                                         layer_cache["ssd"])
            layer_cache["conv"].copy_(conv)
            layer_cache["ssd"].copy_(ssd)
            mix = y if mix is None else mix + y
        return self._finish_layer(p, x, mix)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B,S,V], labels [B,S] -> mean token NLL in fp32 (mask:
    [B,S] 0/1; the masked mean divides by max(sum(mask), 1))."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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
