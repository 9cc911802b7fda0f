"""Plain PyTorch versions of the SSD scan (kernel K4).

Counterpart of ``repro.kernels.ssd_scan.ref`` plus the chunked scan of
``repro.models.mamba2``:
  * ``ssd_scan_ref`` — the naive per-token recurrence (ground truth);
  * ``ssd_chunked``  — the chunked scan with state in, state out and a
    validity mask, K4's plain version (``models.mamba2`` re-exports it
    under the reference's name).
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_scan_ref(x, dt, a, b, c, valid=None):
    """Token-by-token SSM recurrence.

    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t ;  y_t = C_t · h_t
    x: [B,S,H,P]; dt: [B,S,H]; a: [H]; b,c: [B,S,H,N] -> y [B,S,H,P].
    ``valid`` ([B,S] bool or None) zeroes dt at invalid positions, making
    their state transition an exact identity. Computed in fp32.
    """
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                       # [B,H]
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * bf[:, t, :, None, :])                        # [B,H,P,N]
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    return torch.stack(ys, 1).to(x.dtype)


def _segsum(x):
    """x: [..., Q] log-decays -> [..., Q, Q] lower-triangular segment sums.

    out[i, j] = sum_{k=j+1..i} x[k]  (i >= j), -inf above the diagonal.
    """
    q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def _pad_seq(t, pad: int):
    """Zero rows appended along the sequence axis (axis 1)."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def ssd_chunked(x, dt, a, b, c, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None):
    """Chunked SSD scan (``repro.models.mamba2.ssd_chunked``).

    x:  [B, S, H, P]   head inputs
    dt: [B, S, H]      discretization steps (post-softplus, >0)
    a:  [H]            negative state decay rates
    b:  [B, S, H, N]   input projections (already head-broadcast)
    c:  [B, S, H, N]   output projections (already head-broadcast)
    initial_state: [B, H, P, N] (taken in x's dtype) or None
    valid: [B, S] bool or None — positions marked False get dt forced to
        0: an exact identity state transition that adds nothing to any
        other position's output.

    Returns (y [B, S, H, P], final_state [B, H, P, N]). Outputs at invalid
    positions are unspecified (callers discard them). Rounds where the
    reference rounds: the gate and the chunk states in x's dtype.
    """
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
    pad = (-s) % q
    if pad:
        x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    nc = x.shape[1] // q

    xc = x.reshape(bs, nc, q, h, p)
    dtc = dt.reshape(bs, nc, q, h)
    bc = b.reshape(bs, nc, q, h, n)
    cc = c.reshape(bs, nc, q, h, n)

    da = dtc * a                       # [B,nc,Q,H] log-decay per step (a < 0)
    da_cs = torch.cumsum(da, 2)

    # ---- intra-chunk (quadratic, attention-like) ---------------------------
    lmat = torch.exp(_segsum(da.movedim(2, 3)))            # [B,nc,H,Q,Q]
    cb = torch.einsum("bzihn,bzjhn->bzhij", cc, bc)         # [B,nc,H,Q,Q]
    gate = cb * lmat * dtc.movedim(2, 3)[..., None, :]
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", gate.to(x.dtype), xc)

    # ---- chunk states -------------------------------------------------------
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # [B,nc,Q,H]
    wx = (dtc * decay_to_end).to(x.dtype)[..., None] * xc   # [B,nc,Q,H,P]
    states = torch.einsum("bzqhn,bzqhp->bzhpn", bc, wx)

    # ---- inter-chunk recurrence (a loop over chunks) ------------------------
    chunk_decay = torch.exp(da_cs[:, :, -1, :])             # [B,nc,H]
    if initial_state is None:
        carry = torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
    else:
        carry = initial_state.to(x.dtype)
    before = []
    for z in range(nc):
        before.append(carry)           # state BEFORE chunk z
        carry = carry * chunk_decay[:, z, :, None, None].to(carry.dtype) \
            + states[:, z]
    prev = torch.stack(before, 1)                           # [B,nc,H,P,N]

    # ---- inter-chunk output contribution ------------------------------------
    in_decay = torch.exp(da_cs).to(x.dtype)                 # [B,nc,Q,H]
    y_off = torch.einsum("bzqhn,bzhpn->bzqhp", cc, prev) * in_decay[..., None]

    y = (y_diag + y_off).reshape(bs, nc * q, h, p)
    return y[:, :s], carry
