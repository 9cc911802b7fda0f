"""stepcheck for the port: the step graphs' and the launchers' verifier.

Counterpart of ``tools/stepcheck``, run on the CPU with no device work:

  * **STEP001 / STEP002** — the graph manifest: every step variant of
    ``Engine.step_variants()`` (family x bucket x lane-config, cache on
    and off) is one CUDA graph on the card; the count must equal 1 +
    buckets x lane-configs, and each variant's signature (host array,
    lane states, static outputs) ratchets against ``manifest.json``.
  * **STEP003 - STEP006** — rules over ``Engine._step_body`` run on fake
    tensors under a ``TorchDispatchMode`` recorder (``tracing.py``):
    capture safety, host reads, silent fp32 upcasts, dead surface.
  * **STEP007** — the launch-bounds proof: every CUDA launcher's grid
    (``repro_torch.kernels.introspect``; each launcher refuses a grid that
    is not its own) is swept CTA by CTA over a lattice of sentinel-laden
    shapes, proving every operand access in bounds.

CLI (findings render as ``target · STEP0xx · message``; a committed
baseline with a justification per entry; exit 1 only on findings not in
the baseline):

    python -m repro_torch.stepcheck                # full run
    python -m repro_torch.stepcheck --json
    python -m repro_torch.stepcheck --write-manifest
    python -m repro_torch.stepcheck --self-test    # seeded violations
    python -m repro_torch.stepcheck --list-rules
"""
from __future__ import annotations

from .rules import RULES

__all__ = ["RULES"]
