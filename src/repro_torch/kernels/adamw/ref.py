"""Plain PyTorch version of AdamW's update of one leaf: the loop body of
``training/optimizer.py:adamw_update`` (the reference's
``repro/training/optimizer.py:adamw_update``), op for op. On the CPU the
dispatcher runs it; on the card only the comparisons with the fused
kernel (``adamw.py``) do."""
from __future__ import annotations

import torch


@torch.no_grad()
def adamw_leaf_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
                   bc1: torch.Tensor, bc2: torch.Tensor, *, beta1: float,
                   beta2: float, eps: float, weight_decay: float) -> None:
    """One leaf, in place: p (any float dtype) and its fp32 moments m and
    v from the gradient g, with the 0-d fp32 clip scale, learning rate and
    bias corrections; decay only where ``p.dim() >= 2``."""
    g32 = g.float() * scale
    m.mul_(beta1).add_(g32 * (1 - beta1))
    v.mul_(beta2).add_(g32.square_().mul_(1 - beta2))
    del g32
    delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
    if p.dim() >= 2:   # decay matrices only (norms/bias exempt)
        delta.add_(p.float() * weight_decay)
    # (p.float() is p itself for an fp32 leaf: nothing here writes it
    # before the copy)
    p.copy_(p.float() - delta.mul_(lr))
