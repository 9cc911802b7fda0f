"""Plain PyTorch versions of the SSD scan (kernel K4).

Counterpart of ``repro.kernels.ssd_scan.ref`` plus the chunked scan of
``repro.models.mamba2``:
  * ``ssd_scan_ref`` — the naive per-token recurrence (ground truth);
  * ``ssd_chunked``  — the chunked scan with state in, state out and a
    validity mask, K4's plain version (``models.mamba2`` re-exports it
    under the reference's name);
  * ``ssd_chunk_states_ref`` — the fp32 state before each chunk, what
    K4's forward writes for its backward;
  * ``ssd_chunked_bwd_ref`` — the gradient of the chunked scan written
    out in fp32 from those states, the backward kernel's plain version.
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
    return _scan(x, dt, a, b, c, chunk, initial_state, valid)[:2]


def ssd_chunk_states_ref(x, dt, a, b, c, chunk: int,
                         initial_state: Optional[torch.Tensor] = None):
    """The state before each chunk, [B, ceil(S / chunk), H, P, N] fp32,
    of the chunked scan run in fp32 (dt already zero at masked
    positions): what K4's forward writes for its backward."""
    return _scan(x.float(), dt.float(), a.float(), b.float(), c.float(),
                 chunk, None if initial_state is None
                 else initial_state.float())[2]


def _scan(x, dt, a, b, c, chunk, initial_state=None, valid=None):
    """``ssd_chunked``'s body: (y, final state, the states before each
    chunk [B, nc, H, P, N])."""
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
    return y[:, :s], carry, prev


def ssd_chunked_bwd_ref(x, dt, a, b, c, chunk_states, dy, dfinal=None, *,
                        chunk: int):
    """The gradient of the chunked scan (``ssd_chunked`` in fp32) written
    out in fp32, in the backward kernel's order: per chunk, with cs the
    cumulative sum of dt·a, L = exp(cs_i - cs_j) (j <= i), G = C Bᵀ ∘ L
    ∘ dt, W = dY Xᵀ ∘ L ∘ dt and w = dt exp(cs_last - cs):
      (a) U = Σ_i exp(cs_i) dy_i C_iᵀ;
      (b) dS_end from the last chunk back: dS_end = dS_fin at the last,
          then dS_prev = exp(cs_last) dS_end + U; d(initial) is what
          reaches chunk 0;
      (c) dX = Gᵀ dY + w ∘ (B dS_endᵀ), dC = W B + exp(cs) ∘ (dY S_prev),
          dB = Wᵀ C + w ∘ (X dS_end), and on cs the row sums minus the
          column sums of E = W ∘ C Bᵀ, plus exp(cs) dy·(S_prev C) - w r
          (r = x dS_end B), plus at the chunk's last row Σ w r and
          exp(cs_last) <dS_end, S_prev>; its reverse cumulative sum is
          d(dt·a), giving d dt and da.
    x, dy [B, S, H, P]; dt [B, S, H] (already zero at masked positions);
    a [H]; b, c [B, S, H, N]; ``chunk_states`` [B, nc, H, P, N] (the
    state before each chunk, ``ssd_chunk_states_ref``'s or K4's);
    ``dfinal`` [B, H, P, N] or None (zeros). Returns (dx, ddt, da, db, dc,
    dinit): dx, db and dc in x's dtype, the others fp32. Used by the tests
    and ``chip_smoke.py``; nothing on the card's path calls it."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    xf, dtf, bf, cf, dyf = (t.float() for t in (x, dt, b, c, dy))
    pad = (-s) % q
    if pad:
        xf, dtf, bf, cf, dyf = (_pad_seq(t, pad)
                                for t in (xf, dtf, bf, cf, dyf))
    nc = xf.shape[1] // q

    def heads_first(t):           # [B, nc*Q, H, ...] -> [B, nc, H, Q, ...]
        return t.reshape(bs, nc, q, h, -1).movedim(3, 2)
    xc, bc, cc, dyc = (heads_first(t) for t in (xf, bf, cf, dyf))
    dtc = dtf.reshape(bs, nc, q, h).movedim(3, 2)           # [B,nc,H,Q]
    cs = torch.cumsum(dtc * a.float()[:, None], -1)
    cs_last = cs[..., -1]                                   # [B,nc,H]
    ecs = torch.exp(cs)
    sp = chunk_states.float()

    # (a), (b)
    u = torch.einsum("bzhi,bzhip,bzhin->bzhpn", ecs, dyc, cc)
    carry = torch.zeros((bs, h, p, n), dtype=torch.float32,
                        device=x.device) if dfinal is None else dfinal.float()
    ends = [None] * nc
    for z in range(nc - 1, -1, -1):
        ends[z] = carry
        carry = torch.exp(cs_last[:, z])[..., None, None] * carry + u[:, z]
    dse = torch.stack(ends, 1)                              # [B,nc,H,P,N]

    # (c)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    diff = cs[..., :, None] - cs[..., None, :]
    lmat = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                       0.0)
    cb = torch.einsum("bzhin,bzhjn->bzhij", cc, bc)
    m = torch.einsum("bzhip,bzhjp->bzhij", dyc, xc)
    gate = cb * lmat * dtc[..., None, :]
    wmat = m * lmat * dtc[..., None, :]
    w = dtc * torch.exp(cs_last[..., None] - cs)
    xds = torch.einsum("bzhjp,bzhpn->bzhjn", xc, dse)
    dc_off = ecs[..., None] * torch.einsum("bzhip,bzhpn->bzhin", dyc, sp)
    dx = torch.einsum("bzhij,bzhip->bzhjp", gate, dyc) + \
        w[..., None] * torch.einsum("bzhjn,bzhpn->bzhjp", bc, dse)
    dc = torch.einsum("bzhij,bzhjn->bzhin", wmat, bc) + dc_off
    db = torch.einsum("bzhij,bzhin->bzhjn", wmat, cc) + w[..., None] * xds
    col_f = (m * cb * lmat).sum(-2)                         # [B,nc,H,Q]
    r = (xds * bc).sum(-1)
    dcs = (wmat * cb).sum(-1) - dtc * col_f + (dc_off * cc).sum(-1) - w * r
    dcs[..., -1] += (w * r).sum(-1) + torch.exp(cs_last) * (dse * sp).sum(
        (-2, -1))
    dda = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
    ddt = col_f + torch.exp(cs_last[..., None] - cs) * r + \
        a.float()[:, None] * dda
    da = (dtc * dda).sum((0, 1, 3))

    def seq_first(t):             # [B, nc, H, Q, ...] -> [B, S, H, ...]
        return t.movedim(2, 3).reshape((bs, nc * q, h) + t.shape[4:])[:, :s]
    return (seq_first(dx).to(x.dtype), seq_first(ddt[..., None])[..., 0],
            da, seq_first(db).to(x.dtype), seq_first(dc).to(x.dtype), carry)
