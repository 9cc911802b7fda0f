"""Decides ``correct``: the window's served tokens against the reference.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the window answered, the one with
the longest sequence always in it, is run through the plain reference
once: each branch of theirs that decoded, over its prompt and its
served tokens (so the branches sit in slots all over the batch). At
every position a branch was served from, the program's own logits gave
a greedy token: the argmax that the proxy
took of the step's logits row (and of the prefill's last logits for the
first). The number compared is the widest gap, over all those
positions, by which the reference's logit of the program's greedy
token lies below the reference's best. The traffic samples (temperature
0.9), and a sampled token's logit says nothing of the program's
arithmetic; the greedy token of the same logits does.

The control puts the reference itself, in float8, in the program's
place: at the same positions, the gap of the token that the float8
reference puts first. In a control run (``--control 1``) the control's
numbers, not the program's, are held to the cell's limits, so the run
reports ``correct`` false through the same comparison.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from bench.lib.driver import RING_STEPS


def sample(records, seed: int, count: int) -> list:
    """[(record, spawn)] for every branch that decoded of ``count``
    answered requests: the one with the longest branch and ``count - 1``
    more drawn from the seed."""
    cands = []
    for rec in records:
        if math.isnan(rec.answer) or rec.argmax0 is None:
            continue
        branches = [sp for sp in rec.branches
                    if len(sp.handle.tokens) > 1
                    and sp.step + len(sp.handle.tokens) - 1 <= RING_STEPS]
        if branches:
            longest = max(len(sp.handle.tokens) for sp in branches)
            cands.append((rec.prompt_len + longest, rec, branches))
    if not cands:
        return []
    top = max(range(len(cands)), key=lambda i: cands[i][0])
    rest = [i for i in range(len(cands)) if i != top]
    rng = np.random.default_rng([int(seed), 0xc4ec])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)),
                      replace=False) if rest else []
    chosen = [cands[top]] + [cands[rest[i]] for i in sorted(pick)]
    return [(rec, sp) for _, rec, branches in chosen for sp in branches]


def program_greedy(ring: torch.Tensor, rec, sp) -> torch.Tensor:
    """The program's greedy token at each position of the branch: the
    prefill's for its first token, the decode steps' for the rest."""
    n = len(sp.handle.tokens)
    steps = torch.arange(sp.step, sp.step + n - 1, device=ring.device)
    rest = ring[steps, sp.handle.slot]
    return torch.cat([rec.argmax0.reshape(1).to(ring.device), rest])


def compare(ref_module, config: dict, params: dict, ring, picked,
            control: bool = False) -> dict:
    """The widest gap (and how it spreads) of the program's greedy tokens;
    with ``control`` also that of the float8 reference's own."""
    seqs, last, prog = [], [], []
    for rec, sp in picked:
        toks = sp.handle.tokens
        seqs.append(list(rec.req.prompt) + list(toks[:-1]))
        last.append(len(toks))
        prog.append(program_greedy(ring, rec, sp))
    ref = ref_module.logits(config, params, seqs, last, "fp32")
    out = _summary("program", ref, [p.to(r.device)
                                    for r, p in zip(ref, prog)])
    out["positions"] = sum(last)
    if control:
        low = ref_module.logits(config, params, seqs, last, "fp8")
        out.update(_summary("control_fp8", ref,
                            [c.argmax(-1) for c in low]))
    return out


def _summary(tag: str, ref: List[torch.Tensor], tokens: list) -> dict:
    """How far below the reference's best its logit of ``tokens`` lies:
    the widest gap (``gap_max``), the mean over all positions
    (``gap_mean``), and the share of positions where the token is the
    reference's own first (``agree``)."""
    gaps, agree = [], 0
    for r, t in zip(ref, tokens):
        best = r.max(-1)
        gaps.append(best.values - r.gather(-1, t.long()[:, None])[:, 0])
        agree += int((best.indices == t).sum())
    g = torch.cat(gaps).double().cpu()
    return {f"{tag}_gap_max": float(g.max()),
            f"{tag}_gap_mean": float(g.mean()),
            f"{tag}_gap_p99": float(torch.quantile(g, 0.99)),
            f"{tag}_agree": agree / g.numel()}


# the numbers a cell's workload file can hold to a limit, by the name its
# ``check.limits`` gives them
NUMBERS = {"logit_gap_max": "gap_max", "logit_gap_mean": "gap_mean"}


def verdict(result: Optional[dict], limits: dict,
            side: str = "program") -> dict:
    """Each number compared beside its limit (NaN: nothing was checked),
    of the program's greedy tokens or, with ``side`` ``"control_fp8"``,
    of the control's."""
    return {name: {"value": result[f"{side}_{NUMBERS[name]}"] if result
                   else math.nan, "limit": limit}
            for name, limit in limits.items()}
