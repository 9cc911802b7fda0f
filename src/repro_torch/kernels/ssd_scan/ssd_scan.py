"""Wrapper of the hand-written CUDA SSD chunked scan (kernel K4).

The kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``repro/kernels/ssd_scan/ssd_scan.py:ssd_scan`` and carries a state in and
out as ``repro/models/mamba2.py:ssd_chunked`` does. One launch covers
every (16-column slice of P, head, row); bf16 runs on tensor cores, fp32
on the CUDA cores. ``ssd_scan_states`` also writes the fp32 state before
each chunk, what the backward kernel reads (``ssd_scan_bwd.py``, whose
``SsdScanFn`` binds the two for autograd). ``ssd_scan`` is forward-only,
as the TPU kernel is: an input that requires grad raises (the output would
carry no gradient back); ``ops.ssd_with_state`` takes ``SsdScanFn`` there
instead. ``ssd_scan_grid`` describes the launch as data (``introspect``);
the launcher checks its grid. ``launches`` counts the launches this
wrapper made.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build
from .. import introspect as ix

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
    ix.GRID_ARGTYPES + [ctypes.c_void_p]
MAX_DIM = 128              # chunk, head_dim and state_dim the kernel takes
MAX_SMEM = 232448          # shared memory a block may take on the H100
SLICE = 16                 # columns of head_dim one CTA owns


def ctas_per_head(head_dim: int) -> int:
    """CTAs of one (row, head): its 16-column slices of P (the grid is
    (slice, head, row))."""
    return -(-head_dim // SLICE)


@functools.lru_cache(maxsize=256)
def ssd_scan_grid(bs: int, s: int, h: int, p: int, n: int, chunk: int,
                  dtype: torch.dtype = torch.float32,
                  initial_state: bool = False,
                  chunk_states: bool = False) -> ix.Launches:
    """The launch of ``ssd_scan`` as data (the reference's
    ``ssd_scan_grid``, plus the dtype that picks the kernel and whether an
    initial state and the chunk states are operands). Grid (ceil(P / 16),
    H, B) on both routes: CTA (j, hh, b) owns columns 16 j .. of P of
    head hh of row b and walks every position (S need not be a multiple
    of ``chunk``); it reads that head's dt, a, B and C rows whole. No
    scalar operands."""
    nc = n_chunks(s, chunk)

    def cols(cta):
        return cta[0] * SLICE, min((cta[0] + 1) * SLICE, p)

    def seq(cta, *_):        # [B, S, H, P]: x and y
        lo, hi = cols(cta)
        return [((cta[2], cta[2] + 1), (0, s), (cta[1], cta[1] + 1),
                 (lo, hi))]

    def seq_n(cta, *_):      # [B, S, H, N]: B and C
        return [((cta[2], cta[2] + 1), (0, s), (cta[1], cta[1] + 1),
                 (0, n))]

    def state(cta, *_):      # [B, H, P, N]
        lo, hi = cols(cta)
        return [((cta[2], cta[2] + 1), (cta[1], cta[1] + 1), (lo, hi),
                 (0, n))]

    ops = [ix.OperandAccess("x", (bs, s, h, p), seq),
           ix.OperandAccess("dt", (bs, s, h),
                            lambda c, *_: [((c[2], c[2] + 1), (0, s),
                                            (c[1], c[1] + 1))]),
           ix.OperandAccess("a", (h,), lambda c, *_: [((c[1], c[1] + 1),)]),
           ix.OperandAccess("b", (bs, s, h, n), seq_n),
           ix.OperandAccess("c", (bs, s, h, n), seq_n)]
    if initial_state:
        ops.append(ix.OperandAccess("initial_state", (bs, h, p, n), state))
    ops += [ix.OperandAccess("y", (bs, s, h, p), seq),
            ix.OperandAccess("final_state", (bs, h, p, n), state)]
    if chunk_states:
        def states(cta, *_):
            lo, hi = cols(cta)
            return [((cta[2], cta[2] + 1), (0, nc), (cta[1], cta[1] + 1),
                     (lo, hi), (0, n))]
        ops.append(ix.OperandAccess("chunk_states", (bs, nc, h, p, n),
                                    states))
    return ix.Launches((ix.LaunchGrid(
        "ssd_scan", "bf16" if dtype == torch.bfloat16 else "fp32",
        (ctas_per_head(p), h, bs), tuple(ops), 0, (("chunk", chunk),)),))


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


def n_chunks(seqlen: int, chunk: int) -> int:
    """Chunks of a row of ``seqlen`` positions (the last may be partial)."""
    return -(-seqlen // chunk)


def check_shapes(kernel: str, x, dt, a, b, c, initial_state, chunk: int):
    """The shapes and dtypes the forward and backward kernels take, or
    raise: x [B, S, H, P] and b, c [B, S, H, N] in one dtype; dt [B, S, H]
    and a [H] fp32; ``initial_state`` [B, H, P, N] in x's dtype or None;
    chunk, P and N at most 128. (Devices: ``build.check_operands``.)"""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if b.shape != (bs, s, h, n) or c.shape != b.shape or \
            dt.shape != (bs, s, h) or a.shape != (h,):
        raise ValueError(f"{kernel}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} disagree")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"{kernel}: x, b and c must share a dtype")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"{kernel}: dt and a are fp32")
    if initial_state is not None and (
            initial_state.shape != (bs, h, p, n)
            or initial_state.dtype != x.dtype):
        raise ValueError(f"{kernel}: the initial state is [B, H, P, N] in "
                         "x's dtype")
    if not 1 <= chunk <= MAX_DIM or p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"{kernel}: chunk {chunk}, head_dim {p}, state "
                         f"{n} exceed {MAX_DIM}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P] and b, c [B, S, H, N] (fp32 or bf16, one dtype);
    dt [B, S, H] (>= 0, already zero at masked positions) and a [H] fp32;
    ``initial_state`` [B, H, P, N] in x's dtype or None (zeros). S need
    not be a multiple of ``chunk``. Returns (y [B, S, H, P], the final
    state [B, H, P, N] in x's dtype). Raises on an input that requires
    grad, before any other check."""
    if any(t is not None and t.requires_grad
           for t in (x, dt, a, b, c, initial_state)):
        raise RuntimeError("ssd_scan: the raw K4 call is forward-only; an "
                           "input requires grad (ops.ssd_with_state trains "
                           "through SsdScanFn)")
    return _forward(x, dt, a, b, c, chunk, initial_state, False)[:2]


def ssd_scan_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_scan`` that also returns the fp32 state before each chunk,
    [B, ceil(S / chunk), H, P, N] (the backward's input); y and the final
    state are the same bits as ``ssd_scan``'s. The forward of
    ``SsdScanFn``: its inputs may require grad (nothing here records a
    graph)."""
    return _forward(x, dt, a, b, c, chunk, initial_state, True)


def _forward(x, dt, a, b, c, chunk, initial_state, with_states):
    global launches
    check_shapes("ssd_scan", x, dt, a, b, c, initial_state, chunk)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if smem_bytes(chunk, p, n, s, x.dtype) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk}, head_dim {p}, state "
                         f"{n} exceed what one CTA holds")
    build.check_operands("ssd_scan", x, dt, a, b, c, *(
        [initial_state] if initial_state is not None else []))
    y = torch.empty_like(x)
    fin = torch.empty((bs, h, p, n), dtype=x.dtype, device=x.device)
    states = torch.empty((bs, n_chunks(s, chunk), h, p, n),
                         dtype=torch.float32, device=x.device) \
        if with_states else None
    if bs == 0 or h == 0:
        return y, fin, states
    grids = ssd_scan_grid(bs, s, h, p, n, chunk, x.dtype,
                          initial_state is not None, with_states)
    fn = build.function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    rc = fn(build.dtype_code(x), x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            y.data_ptr(), fin.data_ptr(),
            states.data_ptr() if states is not None else None, bs, s, h, p,
            n, chunk, *ix.grid_args(grids), build.stream(x))
    build.raise_on_error("ssd_scan", rc)
    launches += 1
    return y, fin, states
