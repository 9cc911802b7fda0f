"""Wrapper of the hand-written CUDA dense flash prefill (kernel K5).

Two kernels replace the TPU kernel
``repro/kernels/flash_prefill/flash_prefill.py:flash_prefill``, chosen by
dtype: bf16 runs on the tensor cores (``csrc/flash_prefill_sm90.cu``:
wgmma fed by TMA, one or two consumer warpgroups of 64 rows per CTA,
one at head_dim 256), fp32 on the CUDA cores (``csrc/flash_prefill.cu``,
64 rows per CTA), since bf16 tensor-core products cannot meet fp32's tolerance. Both are
forward-only, as the TPU kernel is (no gradient is defined there), so an
input that requires grad raises. ``launches`` counts the launches this
wrapper made, of either kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build

launches = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_SM90_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
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


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  true_len: Optional[int] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, S, Hkv, hd] with Hkv | H and at most 64
    query heads per KV head; one dtype, fp32 or bf16 (which picks the
    kernel); a head_dim of ``build.HEAD_DIMS`` (32, 64, 128 or 256). ``true_len`` is a host int in (0, S]
    or None (= S). Returns [B, S, H, hd]."""
    global launches
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_prefill: K5 is forward-only; an input "
                           "requires grad")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    batch, seqlen, q_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill: q, k and v must share a dtype")
    if head_dim not in build.HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {head_dim} not in "
                         f"{build.HEAD_DIMS}")
    if kv_heads < 1 or q_heads % kv_heads or \
            q_heads // kv_heads > MAX_GROUP:
        raise ValueError(f"flash_prefill: {q_heads} query heads over "
                         f"{kv_heads} KV heads")
    build.check_operands("flash_prefill", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill: operands must be 16-byte aligned")
    n = seqlen if true_len is None else int(true_len)
    if not 0 < n <= seqlen:
        raise ValueError(f"flash_prefill: true_len {n} not in (0, "
                         f"{seqlen}]")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    group = q_heads // kv_heads
    stream = build.stream(q)
    if q.dtype == torch.bfloat16:
        rows = cta_rows(seqlen, group, kv_heads, batch, q.dtype,
                        _num_sms(q.device), head_dim)
        fn = build.function("flash_prefill_sm90",
                            "flash_prefill_sm90_launch", _SM90_ARGTYPES)
        rc = fn(head_dim, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), batch, seqlen, q_heads, kv_heads, n, rows,
                block_rows(group, rows), int(causal), 1.0 / head_dim ** 0.5,
                stream)
    else:
        fn = build.function("flash_prefill", "flash_prefill_launch",
                            _ARGTYPES)
        rc = fn(head_dim, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), batch, seqlen, q_heads, kv_heads, n,
                block_rows(group), int(causal), 1.0 / head_dim ** 0.5,
                stream)
    build.raise_on_error("flash_prefill", rc)
    launches += 1
    return out
