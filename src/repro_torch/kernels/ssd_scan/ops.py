"""Public SSD chunked scan (kernel K4, with its backward): the CUDA kernel
for CUDA tensors, the plain PyTorch version (``ref.ssd_chunked``) for CPU
tensors."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import ssd_chunked
from .ssd_scan import ssd_scan
from .ssd_scan_bwd import SsdScanFn


def ssd_with_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int,
                   initial_state: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan with state in and out, ``(y [B,S,H,P],
    final_state [B,H,P,N])`` (the contract of ``ref.ssd_chunked``). S
    need not be a multiple of ``chunk``. ``valid`` ([B, S] bool) zeroes dt
    at masked positions before the launch, as the TPU wrapper does.
    Dispatches on the device of ``x``; what ``mamba2_forward`` calls.
    Differentiable on both: on the card, with grad enabled and an input
    that requires grad, K4 runs through ``SsdScanFn`` (the forward writing
    its chunk states, the backward kernel for the gradient; the mask's
    ``where`` stays outside, in autograd), else the forward-only kernel;
    on the CPU the plain version is differentiated by autograd."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, b, c, chunk, initial_state, valid)
    return _launch(x, dt, a, b, c, chunk, initial_state, valid)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SSD scan from a zero state, y [B, S, H, P] only
    (``repro.kernels.ssd_scan.ops.ssd``). Dispatches on the device of
    ``x``."""
    return ssd_with_state(x, dt, a, b, c, chunk, valid=valid)[0]


def _launch(x, dt, a, b, c, chunk, initial_state, valid):
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
    args = (x.contiguous(), dt.float().contiguous(), a.float().contiguous(),
            b.contiguous(), c.contiguous(),
            initial_state.to(x.dtype).contiguous()
            if initial_state is not None else None)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return SsdScanFn.apply(*args, chunk)
    return ssd_scan(*args[:5], chunk=chunk, initial_state=args[5])

