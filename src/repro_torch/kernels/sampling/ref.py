"""Plain PyTorch version of the top-p sampler (``csrc/sample_top_p.cu``).

The same arithmetic as the kernel, op for op, so that thresholds and
tokens are bit-equal on the same inputs and keys:

* ``y = float(x) / T + 0.0`` in fp32 (the ``+ 0.0`` folds -0 into +0);
* a token's mass ``e = exp_det(y - max(y))``, an exp built from fp32
  multiplies and adds alone (no library ``exp``, whose last bit differs
  between the CPU and the card), and its fixed-point form
  ``trunc(e * 2**43)`` in int64: sums of it are exact, so they do not
  depend on the order in which they are added;
* the kept set ``{y >= t*}``, ``t*`` the largest ``y`` whose mass at or
  above it reaches ``ceil(p * Z)`` (``Z`` the row's mass): the set that
  ``serving.sampling.apply_top_p`` keeps (top-1 always, ties at the
  threshold all kept), found without a sort by a radix select *on mass*
  over an order-preserving uint32 key of ``y`` (12, 12 and 8 bits);
* the draw, the exponential race ``argmax e_i / E_i`` over the kept set
  (first index on a tie), ``E_i = -log(u_i)`` from Philox4x32-10 keyed by
  the row's int64 key, counter ``(i >> 2, row, 0, 0)``, word ``i & 3``,
  and a log built from fp32 multiplies and adds as the exp is.

On the CPU ``serving.sampling.sample`` keeps its own path; this version
is what the kernel is held against, and the definition it implements.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _f32(v: float) -> float:
    """The fp32 value nearest ``v``, as a Python float (exact in fp32, so
    a tensor op casts it without rounding)."""
    return float(np.float32(v))


#: a token's mass in fixed point: trunc(e * 2**MASS_SHIFT), e in [0, 1]
MASS_SHIFT = 43
#: rows of fewer tokens than this sum their masses below 2**63
MAX_VOCAB = 1 << 20
#: the radix select's digits of the uint32 key, top first: (shift, bits)
LEVELS = ((20, 12), (8, 12), (0, 8))
#: ``exp_det`` gives 0 below this (e**-80 is far below 2**-43)
EXP_MIN = -80.0
LOG2E = _f32(1.4426950408889634)
LN2_HI = _f32(0.693145751953125)          # 16 significant bits
LN2_LO = _f32(math.log(2.0) - 0.693145751953125)
#: e**r on |r| <= ln2 / 2: Horner from 1/7! down to 1/2!, then 1, 1
EXP_COEF = tuple(_f32(1.0 / math.factorial(n)) for n in range(7, 1, -1))
SQRT2 = _f32(math.sqrt(2.0))
#: log(m) = 2 s (1 + z/3 + z^2/5 + z^3/7 + z^4/9), s = (m-1)/(m+1), z = s^2
LOG_COEF = tuple(_f32(1.0 / n) for n in (9, 7, 5, 3))

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF


def exp_det(d: torch.Tensor) -> torch.Tensor:
    """e**d for fp32 d <= 0, within a few ulp, from fp32 multiplies and
    adds (each its own rounded op) and an exact power of two; 0 below
    ``EXP_MIN`` and for NaN; exactly 1 at 0."""
    live = d >= EXP_MIN
    d = torch.where(live, d, torch.zeros_like(d))
    k = torch.floor(d * LOG2E + 0.5)
    r = (d - k * LN2_HI) - k * LN2_LO
    p = torch.full_like(r, EXP_COEF[0])
    for c in EXP_COEF[1:]:
        p = p * r + c
    p = p * r + 1.0
    p = p * r + 1.0
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(live, p * scale, torch.zeros_like(p))


def race_noise(bits: torch.Tensor) -> torch.Tensor:
    """Exp(1) noise ``-log(u)`` from uint32 words (held in int64): u =
    (2 (bits >> 9) + 1) / 2**24, odd multiples of 2**-24 in (0, 1), so
    the noise is never 0; the log from fp32 multiplies and adds."""
    n = ((bits >> 9) * 2 + 1).to(torch.float32)       # exact: < 2**24
    b = n.view(torch.int32)
    ex = (b >> 23) - 127
    m = ((b & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    big = m > SQRT2
    m = torch.where(big, m * 0.5, m)
    ex = ex + big.to(torch.int32)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    q = torch.full_like(z, LOG_COEF[0])
    for c in LOG_COEF[1:]:
        q = q * z + c
    q = q * z + 1.0
    log_m = (s * 2.0) * q
    f = (24 - ex).to(torch.float32)
    return (f * LN2_HI + f * LN2_LO) - log_m


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a 32-bit constant and 32-bit
    words b in int64, through 16-bit halves (no product passes 2**48)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    p0, p1 = b_lo * a_lo, b_lo * a_hi
    p2, p3 = b_hi * a_lo, b_hi * a_hi
    mid = (p0 >> 16) + (p1 & 0xFFFF) + (p2 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)
    hi = p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(ctr: Tuple[torch.Tensor, ...], key: Tuple[torch.Tensor, ...]
               ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11) of counter words ``ctr`` (4)
    under key words ``key`` (2), each an int64 tensor of 32-bit values;
    they broadcast. Returns the 4 output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(PHILOX_ROUNDS):
        if i:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def row_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """The race's noise E [rows, vocab] fp32 for rows keyed by ``keys``
    [rows] int64: token i of row r is word i & 3 of Philox4x32-10 at
    counter (i >> 2, r, 0, 0) under key (low, high 32 bits of keys[r])."""
    dev = keys.device
    rows = keys.shape[0]
    k0 = (keys & _MASK32)[:, None]
    k1 = ((keys >> 32) & _MASK32)[:, None]
    blocks = -(-vocab // 4)
    c0 = torch.arange(blocks, dtype=torch.int64, device=dev)[None, :]
    c1 = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((c0, c1, zero, zero), (k0, k1))
    bits = torch.stack(torch.broadcast_tensors(*words), -1)
    return race_noise(bits.reshape(rows, 4 * blocks)[:, :vocab])


def order_key(y: torch.Tensor) -> torch.Tensor:
    """The uint32 key (in int64) whose order is fp32 ``y``'s: negative
    floats' bits inverted, the others' sign bit set."""
    b = y.view(torch.int32).to(torch.int64) & _MASK32
    return torch.where(b >= 0x80000000, b ^ _MASK32, b | 0x80000000)


def scaled_logits(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """[rows, V] fp32 ``float(x) / T + 0.0`` (true division by the fp32
    temperature: a 0-d tensor on the logits' device, where a Python float
    on the card would multiply by its reciprocal)."""
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return logits.reshape(-1, logits.shape[-1]).float() / t + 0.0


def masses(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e, m): each token's mass exp_det(y - max) fp32 and its fixed
    point trunc(e * 2**43) int64, for [rows, V] fp32 ``y``."""
    e = exp_det(y - y.amax(-1, keepdim=True))
    return e, (e * float(1 << MASS_SHIFT)).to(torch.int64)


def mass_target(z: torch.Tensor, top_p: float) -> torch.Tensor:
    """ceil(p Z) in fp64, clamped to [1, Z]: the mass the kept set must
    reach (0 where Z is 0)."""
    t = (z.to(torch.float64) * top_p).ceil().to(torch.int64)
    return torch.minimum(t.clamp(min=1), z)


def top_p_threshold_ref(key: torch.Tensor, m: torch.Tensor,
                        top_p: float) -> torch.Tensor:
    """The threshold key per row [rows] int64: the largest key whose mass
    at or above it reaches ``mass_target``, by the radix select on mass
    (``LEVELS``); 0 (keep all) for p >= 1 and for a row of no mass."""
    rows = key.shape[0]
    dev = key.device
    thr = torch.zeros(rows, dtype=torch.int64, device=dev)
    if top_p >= 1.0:
        return thr
    z = m.sum(-1)
    target = mass_target(z, top_p)[:, None]
    above = torch.zeros(rows, dtype=torch.int64, device=dev)
    match = torch.ones_like(key, dtype=torch.bool)
    for shift, bits in LEVELS:
        nb = 1 << bits
        digit = (key >> shift) & (nb - 1)
        hist = torch.zeros((rows, nb), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, digit, torch.where(match, m,
                                                torch.zeros_like(m)))
        cs = above[:, None] + hist.flip(-1).cumsum(-1).flip(-1)
        b = ((cs >= target).sum(-1) - 1).clamp(min=0)[:, None]
        above = (cs.gather(1, b) - hist.gather(1, b))[:, 0]
        thr = thr | (b[:, 0] << shift)
        match = match & (digit == b)
    return torch.where(z > 0, thr, torch.zeros_like(thr))


@torch.no_grad()
def sample_top_p_ref(logits: torch.Tensor, temperature: float,
                     top_p: float, keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature and top-p sampling of ``logits`` [..., V] (fp32 or
    bf16; T > 0) with one int64 key a row (``keys`` [rows]). Returns
    (tokens [...] int32, threshold keys [...] int32: the uint32 key's
    bits)."""
    lead, vocab = logits.shape[:-1], logits.shape[-1]
    y = scaled_logits(logits, temperature)
    e, m = masses(y)
    key = order_key(y)
    thr = top_p_threshold_ref(key, m, top_p)
    keep = key >= thr[:, None]
    race = torch.where(keep, e / row_noise(keys.reshape(-1), vocab),
                       torch.full_like(e, -1.0))
    tokens = race.argmax(-1).to(torch.int32)
    thr32 = torch.where(thr >= 0x80000000, thr - (1 << 32), thr)
    return tokens.reshape(lead), thr32.to(torch.int32).reshape(lead)
