"""A STEP007 lattice case as real tensors: its inputs, the plain
version's outputs, the kernel's outputs.

``tests/test_torch_introspect.py`` uses it on the CPU (the coverage test:
every element no CTA's range covers is poisoned, and the plain version
must not change), ``chip_smoke.py``'s phase 16 on the card (every case
run by its kernel between NaN guard regions and held to the plain
version). The operands follow the ``LaunchGrid``'s names; the integer
ones are the case's scalars, in the grid's scalar order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.introspect import LaunchGrid
from .bounds import ScalarCase

#: per kernel: the integer operands, in scalar order (K5's are host ints)
INTS = {"paged_attention": ("block_tables", "lengths"),
        "paged_flash_prefill": ("tables", "positions", "chunk_lens"),
        "paged_tree_shared": ("row_group", "shared_bt", "shared_lens",
                              "lengths"),
        "paged_tree_branch": ("row_group", "shared_lens", "branch_bt",
                              "lengths"),
        "flash_prefill": (),
        "ssd_scan": ()}
#: per kernel: the outputs (what the wrapper allocates)
OUTPUTS = {"paged_attention": ("out",), "paged_flash_prefill": ("out",),
           "paged_tree_shared": ("partials",),
           "paged_tree_branch": ("out",), "flash_prefill": ("out", "lse"),
           "ssd_scan": ("y", "final_state", "chunk_states")}
#: fp32 whatever the route: K4's dt and a, K3's packed partials
FP32 = ("dt", "a", "partials")


def make_inputs(lg: LaunchGrid, case: ScalarCase, device,
                gen: torch.Generator,
                alloc: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Every input operand of ``lg`` on ``device``: the float ones drawn
    from ``gen`` (CPU) in the route's dtype (K4's dt >= 0 and a < 0, K3's
    partials with l > 0), the integer ones the case's scalars as int32.
    ``alloc(shape, dtype)`` makes each tensor's storage (default
    ``torch.empty``; phase 16 passes views between guard regions)."""
    alloc = alloc or (lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                       device=device))
    ints = dict(zip(INTS[lg.kernel], case.args))
    route = torch.bfloat16 if lg.route == "bf16" else torch.float32
    out: Dict[str, torch.Tensor] = {}
    for op in lg.operands:
        if op.name in OUTPUTS[lg.kernel]:
            continue
        if op.name in ints:
            src = torch.as_tensor(ints[op.name], dtype=torch.int32)
        else:
            src = torch.randn(op.array_shape, generator=gen)
            if op.name == "dt":
                src = src.abs() * 0.5
            elif op.name == "a":
                src = -src.abs() - 0.5
            elif op.name == "partials":
                src[..., -1] = src[..., -1].abs() + 0.5      # l > 0
            src = src.to(torch.float32 if op.name in FP32 else route)
        t = alloc(tuple(op.array_shape), src.dtype)
        t.copy_(src.to(t.device))
        out[op.name] = t
    return out


def _host(lg: LaunchGrid, case: ScalarCase) -> Dict[str, int]:
    host = dict(lg.host)
    if lg.kernel == "flash_prefill":
        host["true_len"], host["causal"] = (int(x) for x in case.args)
    return host


def run_plain(lg: LaunchGrid, case: ScalarCase,
              x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version's outputs on inputs ``x``."""
    from ..kernels.flash_prefill.ref import (flash_prefill_ref,
                                             paged_flash_prefill_lanes_ref)
    from ..kernels.paged_attention.ref import (
        paged_attention_decode_ref, tree_branch_merge_ref,
        tree_merge_splits_ref, tree_shared_split_partials_ref)
    from ..kernels.ssd_scan.ref import ssd_chunk_states_ref, ssd_chunked
    h = _host(lg, case)
    k = lg.kernel
    if k == "paged_attention":
        return {"out": paged_attention_decode_ref(
            x["q"], x["k_pages"], x["v_pages"], x["block_tables"],
            x["lengths"])}
    if k == "paged_flash_prefill":
        return {"out": paged_flash_prefill_lanes_ref(
            x["q"], x["k_pages"], x["v_pages"], x["tables"], x["positions"],
            x["chunk_lens"], (h["bucket"],) * h["n_lanes"])}
    if k == "paged_tree_shared":
        m, l, acc = tree_shared_split_partials_ref(
            x["q"], x["k_pages"], x["v_pages"], x["row_group"],
            x["shared_bt"], x["shared_lens"], x["lengths"], h["split_keys"],
            h["n_split"])
        return {"partials": torch.cat([acc, m[..., None], l[..., None]], -1)}
    if k == "paged_tree_branch":
        shared = tree_merge_splits_ref(*used_partials(lg, x))
        return {"out": tree_branch_merge_ref(
            x["q"], x["k_pages"], x["v_pages"], x["row_group"],
            x["shared_lens"], x["branch_bt"], x["lengths"], *shared)}
    if k == "flash_prefill":
        return {"out": flash_prefill_ref(x["q"], x["k"], x["v"],
                                         bool(h["causal"]), h["true_len"])}
    if k == "ssd_scan":
        args = (x["x"], x["dt"], x["a"], x["b"], x["c"], h["chunk"])
        y, fin = ssd_chunked(*args, x.get("initial_state"))
        out = {"y": y, "final_state": fin}
        if any(op.name == "chunk_states" for op in lg.operands):
            out["chunk_states"] = ssd_chunk_states_ref(
                *args, x.get("initial_state"))
        return out
    raise KeyError(k)


def used_partials(lg: LaunchGrid, x: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The branch pass's shared partials (m, l, acc) as it merges them:
    row b's first ``used`` splits, the rest neutral (NEG_INF, 0, 0), as
    the shared pass writes a split past a row's view of its span; ``used``
    = ceil(min(length, span) / shared_keys) for a row in a group, 0 for
    the others (``paged_decode_mma.cuh``, ``paged_tree_decode.cu``)."""
    from ..kernels.paged_attention.ref import NEG_INF
    from ..kernels.paged_attention.tree_decode import unpack_partials
    m, l, acc = unpack_partials(x["partials"])
    n, groups = m.shape[0], x["shared_lens"].shape[0]
    _, width = x["branch_bt"].shape
    cap = width * x["k_pages"].shape[2]
    rg = x["row_group"].long()
    grouped = (rg >= 0) & (rg < groups)
    span = torch.where(grouped,
                       x["shared_lens"].long()[rg.clamp(0, groups - 1)]
                       .clamp(0, cap), 0)
    seen = torch.minimum(x["lengths"].long().clamp(0, cap), span)
    keys = dict(lg.host)["shared_keys"]
    used = torch.where(grouped, ((seen + keys - 1) // keys).clamp(max=n), 0)
    keep = (torch.arange(n, device=m.device)[:, None]
            < used[None, :])[..., None]                  # [n, B, 1]
    return (torch.where(keep, m, NEG_INF), torch.where(keep, l, 0.0),
            torch.where(keep[..., None], acc, 0.0))


def run_kernel(lg: LaunchGrid, case: ScalarCase,
               x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The CUDA kernel's outputs on inputs ``x`` (on the card), through
    its wrapper: the launch ``lg`` describes, grid checked."""
    from ..kernels.flash_prefill.flash_prefill import flash_prefill
    from ..kernels.flash_prefill.paged_prefill import \
        paged_flash_prefill_lanes_fwd
    from ..kernels.paged_attention.paged_attention import \
        paged_attention_decode
    from ..kernels.paged_attention.tree_decode import (
        paged_tree_branch_fwd, paged_tree_shared_split_fwd)
    from ..kernels.ssd_scan.ssd_scan import ssd_scan_states
    h = _host(lg, case)
    k = lg.kernel
    if k == "paged_attention":
        return {"out": paged_attention_decode(
            x["q"], x["k_pages"], x["v_pages"], x["block_tables"],
            x["lengths"])}
    if k == "paged_flash_prefill":
        return {"out": paged_flash_prefill_lanes_fwd(
            x["q"], x["k_pages"], x["v_pages"], x["tables"], x["positions"],
            x["chunk_lens"], (h["bucket"],) * h["n_lanes"])}
    if k == "paged_tree_shared":
        return {"partials": paged_tree_shared_split_fwd(
            x["q"], x["k_pages"], x["v_pages"], x["row_group"],
            x["shared_bt"], x["shared_lens"], x["lengths"], h["split_keys"],
            h["n_split"])[0]}
    if k == "paged_tree_branch":
        return {"out": paged_tree_branch_fwd(
            x["q"], x["k_pages"], x["v_pages"], x["row_group"],
            x["shared_lens"], x["branch_bt"], x["lengths"], x["partials"],
            h["shared_keys"])}
    if k == "flash_prefill":
        return {"out": flash_prefill(x["q"], x["k"], x["v"],
                                     bool(h["causal"]), h["true_len"])}
    if k == "ssd_scan":
        y, fin, states = ssd_scan_states(
            x["x"], x["dt"], x["a"], x["b"], x["c"], chunk=h["chunk"],
            initial_state=x.get("initial_state"))
        return {"y": y, "final_state": fin, "chunk_states": states}
    raise KeyError(k)


def compared_rows(lg: LaunchGrid, x: Dict[str, torch.Tensor]
                  ) -> Optional[Tuple[str, torch.Tensor]]:
    """(output, bool rows) of the rows an output defines where the
    kernel leaves others unwritten: K3's shared pass writes only the rows
    in a group (dim 1 of its partials)."""
    if lg.kernel != "paged_tree_shared":
        return None
    rg = x["row_group"].long()
    return "partials", (rg >= 0) & (rg < x["shared_lens"].shape[0])
