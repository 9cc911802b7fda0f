"""Public AdamW leaf update: the fused CUDA kernel for CUDA tensors, the
plain PyTorch version (``ref.adamw_leaf_ref``) for CPU tensors."""
from __future__ import annotations

import torch

from .adamw import adamw_step
from .ref import adamw_leaf_ref


def adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
               bc1: torch.Tensor, bc2: torch.Tensor, *, beta1: float,
               beta2: float, eps: float, weight_decay: float) -> None:
    """AdamW's update of one leaf in place (the contract of
    ``ref.adamw_leaf_ref``). Dispatches on the device of ``p``; on the
    card the gradient is made contiguous first (autograd may hand back a
    strided one), the leaf and its moments must already be."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if p.device.type == "cpu":
        return adamw_leaf_ref(p, g, m, v, scale, lr, bc1, bc2, **kw)
    return adamw_step(p, g.contiguous(), m, v, scale, lr, bc1, bc2, **kw)
