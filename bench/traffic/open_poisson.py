"""Open-loop Poisson arrivals at the workload's fixed ``rate_per_s``.

Independent users: request i is due at a fixed time whether or not
earlier ones have finished. The ``n`` gaps of the schedule are the ``n``
stratified quantiles of the exponential, scaled to a mean of exactly
``1 / rate``, in an order drawn from the seed; the prompt lengths
likewise (``prompts.Requests``). So every seed gets the same gaps and
lengths as multisets: bursts of short gaps, long pauses and the longest
prompts all arrive, at places the seed chooses.

With ``"block": k`` in the arrivals, the gaps are stratified over each
block of ``k`` arrivals instead of the whole schedule: every block holds
the ``k`` quantiles in its own order and spans exactly ``k / rate``
seconds. A window then sees the same load on every seed, up to the
blocks it cuts, while bursts and pauses still come within each block.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from bench.traffic.prompts import Requests, in_order, quantiles_exponential


class OpenPoisson:
    def __init__(self, workload: dict, vocab: int, seed: int,
                 horizon_s: float):
        rate = float(workload["arrivals"]["rate_per_s"])
        n = int(math.ceil(rate * horizon_s * 1.25)) + 16
        block = int(workload["arrivals"].get("block", n))
        n = -(-n // block) * block
        rng = np.random.default_rng([int(seed), 0xa771])
        q = quantiles_exponential(block, 1.0)
        scale = sum(q) / block * rate
        gaps = []
        for _ in range(n // block):
            gaps += in_order([g / scale for g in q], rng)
        self.due = np.cumsum(gaps).tolist()
        self.requests = Requests(workload["prompts"], vocab, seed, n)

    def first(self) -> List[Tuple[float, int]]:
        """(due seconds after the schedule's start, request index)."""
        return [(t, i) for i, t in enumerate(self.due)]

    def answered(self, index: int, t: float) -> List[Tuple[float, int]]:
        """Requests an answer at ``t`` sets due: none in an open loop."""
        return []


def make(workload: dict, vocab: int, seed: int, horizon_s: float):
    return OpenPoisson(workload, vocab, seed, horizon_s)
