"""Model FLOPs of the tokens a step runs, from the configuration file and
its family's counts (``bench/families/<family>.py``).

Per token: 2 x the matrix-product parameters it passes
(``matmul_params``; for a mixture of experts the router and only the
experts it is routed to), plus the attention FLOPs per token of its
context (``context_flops``). The families' docstrings work the counts
by hand.
"""
from __future__ import annotations


def step_flops(family, config: dict, tokens: int, context: int) -> int:
    """FLOPs of ``tokens`` tokens that attend ``context`` keys in all."""
    return (2 * family.matmul_params(config) * tokens
            + family.context_flops(config) * context)
