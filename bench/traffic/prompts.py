"""The requests a cell sends: prompt token ids and a task payload each.

Every seed gets the same prompt lengths in its own order: the ``n``
requests' lengths are the ``n`` stratified quantiles of the workload's
clipped lognormal, the whole range up to its clip, in an order drawn
from the seed. So a seed changes where the long and the short prompts
fall and which tokens they hold, not how much work the schedule holds.
The token ids are drawn from the configuration's vocabulary. Each request
carries a seeded ``Problem``, the payload the port's ``OraclePRM``
grades branches against (a frozen copy of the port's
``data/tasks.py:gen_problem``).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Problem:
    terms: Tuple[int, ...]        # digits
    ops: Tuple[str, ...]          # between terms, len = len(terms)-1
    running: Tuple[int, ...]      # running value (mod 10) after each fold
    answer: int                   # == running[-1]


def gen_problem(rng: np.random.Generator, min_terms: int = 3,
                max_terms: int = 8) -> Problem:
    k = int(rng.integers(min_terms, max_terms + 1))
    terms = [int(rng.integers(0, 10)) for _ in range(k)]
    ops = [str(rng.choice(["+", "-", "*"])) for _ in range(k - 1)]
    running = [terms[0] % 10]
    for op, t in zip(ops, terms[1:]):
        v = running[-1]
        if op == "+":
            v = (v + t) % 10
        elif op == "-":
            v = (v - t) % 10
        else:
            v = (v * t) % 10
        running.append(v)
    return Problem(tuple(terms), tuple(ops), tuple(running), running[-1])


def quantiles_lognormal(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> List[int]:
    """The n stratified quantiles (i + 0.5) / n of a lognormal with this
    median and sigma, rounded and clipped to [lo, hi], ascending."""
    nd = NormalDist()
    return [int(min(max(round(median * math.exp(
        sigma * nd.inv_cdf((i + 0.5) / n))), lo), hi)) for i in range(n)]


def quantiles_exponential(n: int, mean: float) -> List[float]:
    """The n stratified quantiles (i + 0.5) / n of an exponential."""
    return [-mean * math.log(1.0 - (i + 0.5) / n) for i in range(n)]


def in_order(values: list, rng: np.random.Generator) -> list:
    """``values`` in an order drawn from ``rng``."""
    return [values[i] for i in rng.permutation(len(values))]


class Requests:
    """``n`` requests of the workload's ``prompts`` parameters for one
    seed, their lengths the ``n`` quantiles in the seed's order:
    ``get(i)`` is (prompt token ids, Problem)."""

    def __init__(self, prompts: dict, vocab: int, seed: int, n: int):
        rng = np.random.default_rng([int(seed), 0x5eed])
        self.lengths = in_order(quantiles_lognormal(
            n, prompts["median"], prompts["sigma"], prompts["min"],
            prompts["max"]), rng)
        header = prompts.get("shared_header", 0)
        self.header = rng.integers(0, vocab, size=header).tolist()
        self._tokens = rng.integers(0, vocab, size=sum(self.lengths))
        self._starts = np.concatenate([[0], np.cumsum(self.lengths)])
        self.problems = [gen_problem(rng) for _ in range(n)]

    def __len__(self) -> int:
        return len(self.lengths)

    def get(self, i: int) -> Tuple[List[int], Problem]:
        body = self._tokens[self._starts[i]:self._starts[i + 1]].tolist()
        return self.header + body, self.problems[i]
