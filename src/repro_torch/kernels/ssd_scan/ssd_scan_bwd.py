"""Wrapper of the hand-written CUDA backward of the SSD chunked scan
(kernel K4), and the autograd binding that trains the ssm and hybrid
families through K4.

The JAX package has no Pallas backward: its training path takes XLA's
autodiff of the chunked scan (``repro/models/mamba2.py:ssd_chunked``).
The port's training forward is K4, so its gradient is a kernel of its own,
``csrc/ssd_scan_bwd.cu``: the gradient reaching each chunk's end state
(bf16: one reverse walk over the chunks per 32 columns of P; fp32: the
state gradient each chunk adds, then a reverse pass), then every other
gradient of each chunk in parallel, and da summed over (row, chunk) in a
fixed order (no atomics: the gradients are the same bits from run to
run); bf16 on ``mma.sync`` tensor-core tiles, fp32 on the CUDA cores. One
call of ``ssd_scan_bwd`` is one launch of the three (bf16) or four
(fp32), counted in ``launches``. ``ssd_scan_bwd_grid`` describes their
grids as data (``introspect``); the launcher refuses any other.

``SsdScanFn`` runs K4's forward writing the state before each chunk
(``ssd_scan.ssd_scan_states``), saves it with the inputs and runs the
backward kernel; ``ops.ssd_with_state`` takes it on the card when grad is
enabled and an input requires grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build
from .. import introspect as ix
from . import ssd_scan as fwd

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 15 + \
    [ctypes.c_int] * 6 + ix.GRID_ARGTYPES + [ctypes.c_void_p]
#: columns of P one bf16 chain CTA owns (kSlice), threads of every CTA
#: (kThreads), in ``csrc/ssd_scan_bwd.cu``
SLICE = 32
THREADS = 256


@functools.lru_cache(maxsize=256)
def ssd_scan_bwd_grid(b: int, s: int, h: int, p: int, n: int, chunk: int,
                      dtype: torch.dtype = torch.float32) -> ix.Launches:
    """The launches of ``ssd_scan_bwd`` as data, in launch order. bf16:
    the chain (ceil(P / 32), H, B), chunk_grad (ceil(S / chunk), H, B),
    da_reduce (ceil(H / 256), 1, 1); fp32: dstate (ceil(S / chunk), H, B),
    state_pass (ceil(P N / 256), H, B), chunk_grad and da_reduce. No access
    model yet: STEP007 does not cover the training kernels."""
    bf16 = dtype == torch.bfloat16
    chunks = (fwd.n_chunks(s, chunk), h, b)
    da = (ix.cdiv(h, THREADS), 1, 1)
    if bf16:
        named = (("dstate_chain", (ix.cdiv(p, SLICE), h, b)),
                 ("chunk_grad", chunks), ("da_reduce", da))
    else:
        named = (("dstate", chunks),
                 ("state_pass", (ix.cdiv(p * n, THREADS), h, b)),
                 ("chunk_grad", chunks), ("da_reduce", da))
    return ix.Launches(ix.LaunchGrid(f"ssd_scan_bwd.{name}",
                                     "bf16" if bf16 else "fp32", grid, ())
                       for name, grid in named)


def bwd_smem_bytes(chunk: int, head_dim: int, state_dim: int, seqlen: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one CTA of the chunk-gradient kernel
    (``BwdLayout`` and ``f32_grad_smem`` in ``ssd_scan_bwd.cu``, which
    refuses the same shapes), q = min(chunk, seqlen). bf16: X and dY
    [q16][P16 + 8], B and C [q16][N' + 8], S_prev and dS_end [P16][N' + 8],
    G and W [q16][q16 + 8] in bf16 (q16 and P16 padded to 16, N' to 16,
    32, 64 or 128), eight fp32 vectors [q16], two partial arrays
    [q16][max(q16, N') / 16] fp32 and sixteen floats (one a warp). fp32:
    three [q][q + 1]
    matrices, eight vectors [q] and eight floats. One CTA owns all of P
    and N, so P = N = 128 at a chunk of 128 does not fit in bf16."""
    q = min(chunk, seqlen)
    if dtype == torch.float32:
        return (3 * q * (q + 1) + 8 * q + 8) * 4
    q16, p16 = fwd._round16(q), fwd._round16(head_dim)
    npad = next(w for w in (16, 32, 64, 128) if w >= state_dim)
    tiles = 2 * q16 * (p16 + 8) + 2 * q16 * (npad + 8) + \
        2 * p16 * (npad + 8) + 2 * q16 * (q16 + 8)
    return tiles * 2 + 8 * q16 * 4 + 2 * q16 * (max(q16, npad) // 16) * 4 \
        + 16 * 4


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk_states: torch.Tensor,
                 dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None, *,
                 chunk: int, init_grad: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan(x, dt, a, b, c, chunk=chunk,
    initial_state=...)`` for the output's gradient ``dy`` [B, S, H, P] (x's
    dtype) and the final state's ``dfinal`` [B, H, P, N] (any float dtype,
    or None for zeros), from the fp32 states before each chunk
    ``chunk_states`` [B, ceil(S / chunk), H, P, N] that
    ``ssd_scan_states`` wrote. Returns (dx, ddt, da, db, dc, dinit): dx,
    db and dc in x's dtype, ddt [B, S, H] and da [H] fp32, dinit [B, H, P,
    N] fp32 when ``init_grad`` else None. The forward's refusals hold (CPU
    tensors, dtypes, widths over 128), and so does what one CTA cannot
    hold (``bwd_smem_bytes``)."""
    global launches
    fwd.check_shapes("ssd_scan_bwd", x, dt, a, b, c, None, chunk)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = fwd.n_chunks(s, chunk)
    if chunk_states.shape != (bs, nc, h, p, n) or \
            chunk_states.dtype != torch.float32:
        raise ValueError(f"ssd_scan_bwd: the chunk states are fp32 "
                         f"[B, {nc}, H, P, N], got "
                         f"{tuple(chunk_states.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("ssd_scan_bwd: dy must be shaped and typed as x")
    if dfinal is not None and dfinal.shape != (bs, h, p, n):
        raise ValueError("ssd_scan_bwd: dfinal is [B, H, P, N]")
    if bwd_smem_bytes(chunk, p, n, s, x.dtype) > fwd.MAX_SMEM:
        raise ValueError(f"ssd_scan_bwd: chunk {chunk}, head_dim {p}, state "
                         f"{n} exceed what one CTA holds")
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
    build.check_operands("ssd_scan_bwd", x, dt, a, b, c, chunk_states, dy,
                         *([dfinal] if dfinal is not None else []))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, db, dc = (torch.empty_like(t) for t in (x, b, c))
    ddt = torch.empty((bs, s, h), **f32)
    dinit = torch.empty((bs, h, p, n), **f32) if init_grad else None
    if bs == 0 or s == 0:
        if dinit is not None:
            dinit.copy_(dfinal) if dfinal is not None else dinit.zero_()
        return dx, ddt, torch.zeros((h,), **f32), db, dc, dinit
    da = torch.empty((h,), **f32)
    # one workspace: dS_end like the states, then cs_last and the da
    # partials [B, H, chunks] (the launcher carves it)
    ws = torch.empty(bs * nc * h * (p * n + 2), **f32)
    grids = ix.grid_args(ssd_scan_bwd_grid(bs, s, h, p, n, chunk, x.dtype))
    fn = build.function("ssd_scan_bwd", "ssd_scan_bwd_launch", _ARGTYPES)
    rc = fn(build.dtype_code(x), x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), chunk_states.data_ptr(),
            dy.data_ptr(),
            dfinal.data_ptr() if dfinal is not None else None,
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dinit.data_ptr() if dinit is not None else None,
            ws.data_ptr(), bs, s, h, p, n, chunk, *grids, build.stream(x))
    build.raise_on_error("ssd_scan_bwd", rc)
    launches += 1
    return dx, ddt, da, db, dc, dinit


class SsdScanFn(torch.autograd.Function):
    """K4 with a gradient: the forward kernel writing the state before
    each chunk, the backward kernel in ``backward``. Returns (y,
    final_state) as ``ssd_scan``; a final state whose gradient is None
    (training never uses it) counts as zeros, and the initial state gets a
    gradient only when it requires one."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, chunk: int):
        y, fin, states = fwd.ssd_scan_states(x, dt, a, b, c, chunk=chunk,
                                             initial_state=initial_state)
        ctx.save_for_backward(x, dt, a, b, c, states)
        ctx.chunk = chunk
        ctx.init_grad = initial_state is not None and \
            ctx.needs_input_grad[5]
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        x, dt, a, b, c, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, da, db, dc, dinit = ssd_scan_bwd(
            x, dt, a, b, c, states, dy, dfin, chunk=ctx.chunk,
            init_grad=ctx.init_grad)
        return (dx, ddt, da, db, dc,
                dinit.to(x.dtype) if dinit is not None else None, None)
