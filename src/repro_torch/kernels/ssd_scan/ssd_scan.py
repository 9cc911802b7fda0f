"""Wrapper of the hand-written CUDA SSD chunked scan (kernel K4).

The kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``repro/kernels/ssd_scan/ssd_scan.py:ssd_scan`` and carries a state in and
out as ``repro/models/mamba2.py:ssd_chunked`` does. ``launches`` counts the
launches this wrapper made.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]
MAX_DIM = 128              # chunk, head_dim and state_dim one CTA holds
MAX_SMEM = 232448          # shared memory a block may take on the H100


def smem_bytes(chunk: int, head_dim: int, state_dim: int) -> int:
    """The CTA's shared memory (``Layout`` in ``ssd_scan.cu``, which
    refuses the same widths): B with a padded row, C, X, the padded
    [P, N] state, a [32, Q] gate tile and three [Q] vectors, all fp32.
    Checked here so that a CPU test can see the limit."""
    floats = (chunk * (state_dim + 1) + chunk * state_dim + chunk * head_dim
              + head_dim * (state_dim + 1) + 32 * chunk + 3 * chunk)
    return 4 * floats


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P] and b, c [B, S, H, N] (fp32 or bf16, one dtype);
    dt [B, S, H] (>= 0, already zero at masked positions) and a [H] fp32;
    ``initial_state`` [B, H, P, N] in x's dtype or None (zeros). S need
    not be a multiple of ``chunk``. Returns (y [B, S, H, P], the final
    state [B, H, P, N] in x's dtype)."""
    global launches
    ops = [x, dt, a, b, c] + ([initial_state] if initial_state is not None
                              else [])
    build.check_operands("ssd_scan", *ops)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if b.shape != (bs, s, h, n) or c.shape != b.shape or \
            dt.shape != (bs, s, h) or a.shape != (h,):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} disagree")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssd_scan: x, b and c must share a dtype")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and a are fp32")
    if initial_state is not None and (
            initial_state.shape != (bs, h, p, n)
            or initial_state.dtype != x.dtype):
        raise ValueError("ssd_scan: the initial state is [B, H, P, N] in "
                         "x's dtype")
    if not 1 <= chunk <= MAX_DIM or p > MAX_DIM or n > MAX_DIM or \
            smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk}, head_dim {p}, state "
                         f"{n} exceed what one CTA holds")
    y = torch.empty_like(x)
    fin = torch.empty((bs, h, p, n), dtype=x.dtype, device=x.device)
    if bs == 0 or h == 0:
        return y, fin
    fn = build.function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    rc = fn(build.dtype_code(x), x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            y.data_ptr(), fin.data_ptr(), bs, s, h, p, n, chunk,
            build.stream(x))
    build.raise_on_error("ssd_scan", rc)
    launches += 1
    return y, fin
