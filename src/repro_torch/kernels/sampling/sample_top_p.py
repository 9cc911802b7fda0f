"""Wrapper of the hand-written CUDA top-p sampler, ``csrc/sample_top_p.cu``.

Not a TPU kernel: the JAX package samples with jnp ops inside its jitted
step. One launch samples every row of a step's logits (bf16 or fp32) with
temperature and top-p, one cluster of CTAs a row, and writes one int32
token a row and the row's threshold key; its arithmetic is the plain version's
(``ref.sample_top_p_ref``), so both are bit-equal to it on the same keys.
Each row's int64 key seeds the kernel's Philox; ``serving.sampling.sample``
draws the keys from the engine's generator with one small op, so a
captured step draws fresh keys at every replay. ``sample_top_p_grid``
describes the launch as data (``introspect``); the launcher checks its
grid. ``launches`` counts the launches this wrapper made.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import build
from .. import introspect as ix
from .ref import MAX_VOCAB

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
    [ctypes.c_float, ctypes.c_double] + ix.GRID_ARGTYPES + [ctypes.c_void_p]


def cluster_ctas(n_rows: int) -> int:
    """CTAs of the cluster that shares one row (``cluster_ctas`` in the
    .cu, which says why): 8 for at most 32 rows, else 2."""
    return 8 if n_rows <= 32 else 2


@functools.lru_cache(maxsize=256)
def sample_top_p_grid(n_rows: int, vocab: int,
                      dtype: torch.dtype = torch.bfloat16) -> ix.Launches:
    """The launch of ``sample_top_p`` as data: grid (rows x C, 1, 1) in
    clusters of C = ``cluster_ctas(rows)`` CTAs, cluster r on row r: each
    CTA reads key r and a slice of row r of the logits [rows, V] (modelled
    as the row, which bounds it), the first CTA writes token r and
    threshold r. The dtype picks the instantiation; no scalar operands."""
    c = cluster_ctas(n_rows)

    def key(cta, *_):
        r = cta[0] // c
        return [((r, r + 1),)]

    def out(cta, *_):
        r = cta[0] // c
        return [((r, r + 1),)] if cta[0] % c == 0 else []

    def logits_row(cta, *_):
        r = cta[0] // c
        return [((r, r + 1), (0, vocab))]

    ops = (ix.OperandAccess("logits", (n_rows, vocab), logits_row),
           ix.OperandAccess("keys", (n_rows,), key),
           ix.OperandAccess("tokens", (n_rows,), out),
           ix.OperandAccess("thresholds", (n_rows,), out))
    return ix.Launches((ix.LaunchGrid(
        "sample_top_p", "bf16" if dtype == torch.bfloat16 else "fp32",
        (n_rows * c, 1, 1), ops, 0, (("cluster", c),)),))


def sample_top_p(logits: torch.Tensor, temperature: float, top_p: float,
                 keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature and top-p sampling of ``logits`` [..., V] (fp32 or
    bf16, on one CUDA device with ``keys``, one int64 a row) by the
    kernel. Returns (tokens [...] int32, threshold keys [...] int32).
    Raises on anything else (CPU tensors included); never falls back to
    the plain version."""
    global launches
    vocab = logits.shape[-1]
    lead = logits.shape[:-1]
    n = keys.numel()
    if not temperature > 0.0:
        raise ValueError(f"sample_top_p: temperature must be > 0, got "
                         f"{temperature}")
    if not 0 < vocab < MAX_VOCAB:
        raise ValueError(f"sample_top_p: vocab {vocab} not in [1, "
                         f"{MAX_VOCAB})")
    if keys.dtype != torch.int64 or keys.dim() != 1 or \
            n * vocab != logits.numel():
        raise ValueError(f"sample_top_p: keys must be int64 [rows], one a "
                         f"row of logits {tuple(logits.shape)}, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    code = build.dtype_code(logits)
    x = logits.contiguous()
    build.check_operands("sample_top_p", x, keys)
    tokens = torch.empty(lead, dtype=torch.int32, device=x.device)
    thresholds = torch.empty(lead, dtype=torch.int32, device=x.device)
    if n == 0:
        return tokens, thresholds
    fn = build.function("sample_top_p", "sample_top_p_launch", _ARGTYPES)
    grids = sample_top_p_grid(n, vocab, x.dtype)
    rc = fn(code, x.data_ptr(), keys.data_ptr(), tokens.data_ptr(),
            thresholds.data_ptr(), n, vocab, temperature, top_p,
            *ix.grid_args(grids), build.stream(x))
    build.raise_on_error("sample_top_p", rc)
    launches += 1
    return tokens, thresholds
