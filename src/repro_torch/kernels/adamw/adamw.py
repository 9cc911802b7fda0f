"""Wrapper of the hand-written CUDA AdamW leaf update,
``csrc/adamw.cu``.

Not a TPU kernel: the JAX package's update
(``repro/training/optimizer.py:adamw_update``) runs inside its jitted
train step, where XLA fuses it. Here one launch updates one leaf in one
pass, reading p, g, mu and nu and writing p, mu and nu in place, with the
clip scale, learning rate and bias corrections read from fp32 device
scalars (a CUDA graph of the train step reads nothing on the host). Its
arithmetic is the plain version's (``ref.adamw_leaf_ref``), rounded op
for op: the results are bit-equal on the card. ``launches`` counts the
launches this wrapper made.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int64] + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]


def adamw_bytes(p: torch.Tensor, g: torch.Tensor) -> int:
    """The bytes one update of a leaf must move: p read and written, g
    read, mu and nu (fp32) read and written."""
    return p.numel() * (2 * p.element_size() + g.element_size() + 16)


def adamw_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
               bc1: torch.Tensor, bc2: torch.Tensor, *, beta1: float,
               beta2: float, eps: float, weight_decay: float) -> None:
    """AdamW's update of one leaf, in place, by the fused kernel: p (fp32
    or bf16) and g (fp32 or bf16) of one shape, m and v fp32 of that
    shape, all contiguous on one CUDA device; scale, lr, bc1 and bc2 0-d
    fp32 tensors there. Decays where ``p.dim() >= 2``. Raises on anything
    else (CPU tensors included); never falls back to the plain version."""
    global launches
    codes = {torch.float32: 0, torch.bfloat16: 1}
    scalars = (scale, lr, bc1, bc2)
    if p.dtype not in codes or g.dtype not in codes:
        raise TypeError(f"adamw: p and g must be fp32 or bf16, got "
                        f"{p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"adamw: mu and nu must be fp32, got {m.dtype} and "
                        f"{v.dtype}")
    if any(s.dtype != torch.float32 or s.dim() != 0 for s in scalars):
        raise TypeError("adamw: scale, lr, bc1 and bc2 must be 0-d fp32 "
                        "tensors")
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"adamw: shapes differ: p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, mu {tuple(m.shape)}, nu "
                         f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw: p, g, mu and nu must be contiguous")
    build.check_operands("adamw", p, g, m, v, *scalars)
    n = p.numel()
    if n == 0:
        return
    vec = int(all(t.data_ptr() % 16 == 0 for t in (p, g, m, v)))
    fn = build.function("adamw", "adamw_launch", _ARGTYPES)
    rc = fn(codes[p.dtype], codes[g.dtype], p.data_ptr(), g.data_ptr(),
            m.data_ptr(), v.data_ptr(), n, scale.data_ptr(), lr.data_ptr(),
            bc1.data_ptr(), bc2.data_ptr(), beta1, 1 - beta1, beta2,
            1 - beta2, eps, weight_decay, int(p.dim() >= 2), vec,
            build.stream(p))
    build.raise_on_error("adamw", rc)
    launches += 1
