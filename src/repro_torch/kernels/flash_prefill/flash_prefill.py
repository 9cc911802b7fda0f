"""Wrapper of the hand-written CUDA dense flash prefill (kernel K5).

Two kernels replace the TPU kernel
``repro/kernels/flash_prefill/flash_prefill.py:flash_prefill``, chosen by
dtype: bf16 runs on the tensor cores (``csrc/flash_prefill_sm90.cu``:
wgmma fed by TMA, one or two consumer warpgroups of 64 rows per CTA,
one at head_dim 256), fp32 on the CUDA cores (``csrc/flash_prefill.cu``,
64 rows per CTA), since bf16 tensor-core products cannot meet fp32's tolerance.
``flash_prefill`` is the forward alone, as the TPU kernel is, so an input
that requires grad raises there. Training reaches the same kernels through
``flash_prefill_bwd.FlashPrefillFn``, which calls ``flash_prefill_lse``:
the forward that also writes each row's log-sum-exp (fp32 [B, H, S],
natural log of the scaled scores, 0 for rows at or past ``true_len``) for
the backward kernel; without it the kernels write no LSE and their output
is the same bits. ``flash_prefill_grid`` describes the launch as data
(``introspect``); both launchers check its grid. ``launches`` counts the
launches of either kernel made by either entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import build
from .. import introspect as ix

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
    [ctypes.c_int] * 7 + [ctypes.c_float] + ix.GRID_ARGTYPES + \
    [ctypes.c_void_p]
_SM90_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
    [ctypes.c_int] * 8 + [ctypes.c_float] + ix.GRID_ARGTYPES + \
    [ctypes.c_void_p]
#: SMs of an H100 SXM, the count ``flash_prefill_grid`` assumes without a
#: card
H100_SMS = 132
MAX_GROUP = 64          # query heads per KV head (one position's rows)
MAX_ROWS = 128          # query rows (positions x GQA group) one CTA holds
WG_ROWS = 64            # rows of one consumer warpgroup (and of fp32 CTAs)
MAX_WG2_HEAD_DIM = 128  # the widest head two consumer warpgroups take


def block_rows(group: int, rows: int = WG_ROWS) -> int:
    """Query positions per CTA of ``rows`` rows (64 or 128): as many as
    keep positions x group within it."""
    return rows // group


def cta_rows(seqlen: int, group: int, kv_heads: int, batch: int,
             dtype: torch.dtype, num_sms: int, head_dim: int) -> int:
    """Rows per CTA, a fixed rule: 128 (two consumer warpgroups sharing
    each K/V tile) for bf16 where the grid still has a CTA for each of
    the card's ``num_sms`` SMs, else 64; fp32's CUDA-core kernel always
    takes 64, and so does bf16 at head_dim 256 (a warpgroup's O
    accumulator is then 128 registers a thread, too many for two).
    r1-distill-14b (group 5, 8 KV heads) on an H100 SXM (132 SMs): 88
    CTAs of 128 rows at S = 272, so 184 of 64; 1,312 of 128 at
    S = 4096."""
    if dtype != torch.bfloat16 or head_dim > MAX_WG2_HEAD_DIM:
        return WG_ROWS
    tiles = -(-seqlen // block_rows(group, MAX_ROWS))
    return MAX_ROWS if tiles * kv_heads * batch >= num_sms else WG_ROWS


@functools.lru_cache(maxsize=256)
def flash_prefill_grid(b: int, s: int, h: int, hd: int, hkv: int,
                       dtype: torch.dtype = torch.float32,
                       num_sms: int = H100_SMS,
                       with_lse: bool = False) -> ix.Launches:
    """The launch of ``flash_prefill`` as data (the reference's
    ``flash_prefill_grid``, plus the dtype that picks the kernel, the
    card's SM count that picks bf16's rows per CTA, ``cta_rows``, and
    whether the LSE is an output). Grid (ceil(S / block_q), Hkv, B): CTA
    (i, kh, b) holds positions i * block_q .. of KV head kh's query heads.
    Scalars: ``true_len`` and ``causal`` (host ints). Its keys end at the
    block's causal horizon (its last row below true_len, + 1) or at
    true_len; bf16's TMA loads whole 64-key tiles, zero-filled past
    true_len, fp32 stops at the horizon."""
    group = h // hkv
    bf16 = dtype == torch.bfloat16
    bq = block_rows(group, cta_rows(s, group, hkv, b, dtype, num_sms, hd))

    def block(cta):
        i, kh, bi = cta
        q0 = i * bq
        return bi, kh, q0, min(bq, s - q0)

    def rows(cta, *_):
        bi, kh, q0, nq = block(cta)
        return [((bi, bi + 1), (q0, q0 + nq), (kh * group, (kh + 1) * group),
                 (0, hd))]

    def keys(cta, true_len, causal):
        bi, kh, q0, nq = block(cta)
        last = min(q0 + nq, int(true_len))
        end = 0 if last <= q0 else (last if causal else int(true_len))
        if bf16:
            end = min(ix.cdiv(end, ix.K5_KEYS) * ix.K5_KEYS, int(true_len))
        return ([((bi, bi + 1), (0, end), (kh, kh + 1), (0, hd))]
                if end > 0 else [])

    ops = [ix.OperandAccess("q", (b, s, h, hd), rows),
           ix.OperandAccess("k", (b, s, hkv, hd), keys),
           ix.OperandAccess("v", (b, s, hkv, hd), keys),
           ix.OperandAccess("out", (b, s, h, hd), rows)]
    if with_lse:
        def lse(cta, *_):
            bi, kh, q0, nq = block(cta)
            return [((bi, bi + 1), (kh * group, (kh + 1) * group),
                     (q0, q0 + nq))]
        ops.append(ix.OperandAccess("lse", (b, h, s), lse))
    return ix.Launches((ix.LaunchGrid(
        "flash_prefill", "bf16" if bf16 else "fp32",
        (ix.cdiv(s, bq), hkv, b), tuple(ops), 2),))


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  true_len: Optional[int] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, S, Hkv, hd] with Hkv | H and at most 64
    query heads per KV head; one dtype, fp32 or bf16 (which picks the
    kernel); a head_dim of ``build.HEAD_DIMS`` (32, 64, 128 or 256).
    ``true_len`` is a host int in (0, S] or None (= S). Returns [B, S, H,
    hd]. Forward-only: raises if an input requires grad."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_prefill: K5 is forward-only; an input "
                           "requires grad")
    return _forward(q, k, v, causal, true_len, False)[0]


def flash_prefill_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, true_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_prefill``'s contract, returning (out, lse [B, H, S] fp32):
    the forward of ``FlashPrefillFn``, which saves both for the backward.
    Its inputs may require grad (nothing here records a graph)."""
    return _forward(q, k, v, causal, true_len, True)


def check_inputs(kernel: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, true_len: Optional[int]) -> int:
    """Raises on what K5's kernels (forward and backward) do not take;
    returns true_len as an int."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    seqlen, q_heads, head_dim = q.shape[1:]
    kv_heads = k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{kernel}: q, k and v must share a dtype")
    if head_dim not in build.HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {head_dim} not in "
                         f"{build.HEAD_DIMS}")
    if kv_heads < 1 or q_heads % kv_heads or \
            q_heads // kv_heads > MAX_GROUP:
        raise ValueError(f"{kernel}: {q_heads} query heads over "
                         f"{kv_heads} KV heads")
    build.check_operands(kernel, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{kernel}: operands must be 16-byte aligned")
    n = seqlen if true_len is None else int(true_len)
    if not 0 < n <= seqlen:
        raise ValueError(f"{kernel}: true_len {n} not in (0, {seqlen}]")
    return n


def _forward(q, k, v, causal, true_len, with_lse):
    global launches
    n = check_inputs("flash_prefill", q, k, v, true_len)
    batch, seqlen, q_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((batch, q_heads, seqlen), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if batch == 0:
        return out, lse
    group = q_heads // kv_heads
    stream = build.stream(q)
    lse_ptr = lse.data_ptr() if lse is not None else None
    num_sms = _num_sms(q.device)
    grids = ix.grid_args(flash_prefill_grid(batch, seqlen, q_heads,
                                            head_dim, kv_heads, q.dtype,
                                            num_sms, with_lse))
    if q.dtype == torch.bfloat16:
        rows = cta_rows(seqlen, group, kv_heads, batch, q.dtype, num_sms,
                        head_dim)
        fn = build.function("flash_prefill_sm90",
                            "flash_prefill_sm90_launch", _SM90_ARGTYPES)
        rc = fn(head_dim, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse_ptr, batch, seqlen, q_heads, kv_heads,
                n, rows, block_rows(group, rows), int(causal),
                1.0 / head_dim ** 0.5, *grids, stream)
    else:
        fn = build.function("flash_prefill", "flash_prefill_launch",
                            _ARGTYPES)
        rc = fn(head_dim, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse_ptr, batch, seqlen, q_heads, kv_heads,
                n, block_rows(group), int(causal), 1.0 / head_dim ** 0.5,
                *grids, stream)
    build.raise_on_error("flash_prefill", rc)
    launches += 1
    return out, lse
