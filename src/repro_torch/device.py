"""Where the port runs: the CUDA card unless the caller names the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never carries on silently on the CPU (tests pass ``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev
