"""Wrapper of the hand-written CUDA SSD chunked scan (kernel K4).

The kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``repro/kernels/ssd_scan/ssd_scan.py:ssd_scan`` and carries a state in and
out as ``repro/models/mamba2.py:ssd_chunked`` does. One launch covers
every (16-column slice of P, head, row); bf16 runs on tensor cores, fp32
on the CUDA cores. ``launches`` counts the launches this wrapper made.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]
MAX_DIM = 128              # chunk, head_dim and state_dim the kernel takes
MAX_SMEM = 232448          # shared memory a block may take on the H100
SLICE = 16                 # columns of head_dim one CTA owns


def ctas_per_head(head_dim: int) -> int:
    """CTAs of one (row, head): its 16-column slices of P (the grid is
    (slice, head, row))."""
    return -(-head_dim // SLICE)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(chunk: int, head_dim: int, state_dim: int,
               seqlen: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """One CTA's shared memory (``MmaLayout`` / ``F32Layout`` in
    ``ssd_scan.cu``, which refuses the same shapes). It is sized by the
    rows a chunk holds (min(chunk, seqlen)) and one 16-column slice of X,
    never by ``head_dim``. bf16: per stage (two where the sequence spans
    several chunks) B and C rows of N padded to 16, 32, 64 or 128 plus 8
    bf16, the X slice [rows][24] bf16 and dt fp32, then the state's hi and
    lo [16][N + 8] bf16 and two [rows] fp32 vectors, rows padded to 16.
    fp32: B [rows][N + 1], C [rows][N], the X slice [rows][16], the state
    slice [16][N + 1], a [32][rows] gate tile and three [rows] vectors.
    Checked here so that a CPU test can see the limit."""
    del head_dim   # the slice is 16 columns whatever P is
    rows = min(chunk, seqlen if seqlen is not None else chunk)
    n = state_dim
    if dtype == torch.float32:
        floats = (rows * (n + 1) + rows * n + rows * SLICE
                  + SLICE * (n + 1) + 32 * rows + 3 * rows)
        return 4 * floats
    q = _round16(rows)
    npad = next(w for w in (16, 32, 64, 128) if w >= n) if n <= 128 \
        else _round16(n)
    stride = npad + 8
    stages = 2 if seqlen is not None and seqlen > chunk else 1
    stage = 2 * q * stride * 2 + q * (SLICE + 8) * 2 + q * 4
    return stages * stage + 2 * SLICE * stride * 2 + 2 * q * 4


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
            smem_bytes(chunk, p, n, s, x.dtype) > MAX_SMEM:
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
