"""Token sampling: temperature / top-k / top-p over a batch of rows.

Counterpart of ``repro.serving.sampling``. Greedy (temperature 0) is the
argmax with first-index ties, as ``jnp.argmax``; otherwise rows are drawn
from an explicit ``torch.Generator``, whose stream differs from
``jax.random``'s, so only greedy runs match the reference token for token.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.sampling.sample_top_p import sample_top_p

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 -> disabled
    top_p: float = 1.0      # 1.0 -> disabled


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits to NEG_INF (no-op for k<=0 or
    k >= vocab)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: mask logits outside the smallest set whose
    probability mass reaches p (top-1 always kept; no-op for p >= 1)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens while cumulative prob (exclusive) < p; always keep top-1
    keep_sorted = torch.cat(
        [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p],
        dim=-1)
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, NEG_INF)


def sample(gen: torch.Generator, logits: torch.Tensor,
           params: SamplingParams) -> torch.Tensor:
    """logits [..., V] -> int32 token ids [...]. Greedy when temperature
    is 0; else one draw per row from ``gen`` (on the logits' device):
    argmax(p / E) with E ~ Exp(1), the draw ``torch.multinomial(p, 1)``
    makes from the same generator state, without its checks of ``p``,
    which read values on the host (a captured step may not).

    Logits on the card with ``temperature > 0`` and no top-k go to the
    top-p kernel (``kernels/sampling``): the same kept set and the same
    race, with its noise from Philox keyed by one int64 a row drawn from
    ``gen``, and no sort."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if logits.is_cuda and params.temperature > 0 and params.top_k == 0:
        keys = torch.empty(logits.numel() // logits.shape[-1],
                           dtype=torch.int64, device=logits.device)
        keys.random_(generator=gen)
        return sample_top_p(logits, params.temperature, params.top_p,
                            keys)[0]
    logits = logits.float() / params.temperature
    logits = apply_top_k(logits, params.top_k)
    logits = apply_top_p(logits, params.top_p)
    probs = torch.softmax(logits, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=gen)
    return torch.argmax(probs / noise, dim=-1).to(torch.int32)
