"""Redundant sampling with early stopping — order-statistics analysis.

Paper §3, Lemma 1 (David & Nagaraja, *Order Statistics*): for N iid branch
lengths with CDF F, the M-th smallest length has CDF

    F_{X_(M)}(x; N) = Σ_{i=M}^{N} C(N, i) F(x)^i (1 − F(x))^{N−i}

which is increasing in N for fixed M — i.e. sampling more branches and
stopping at the M-th completion *stochastically shortens* the time to obtain
M responses. These utilities power the Lemma-1 validation benchmark and the
(N, M) planning helper used by the scheduler.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np


def order_statistic_cdf(f: np.ndarray, m: int, n: int) -> np.ndarray:
    """CDF of the m-th smallest of n iid draws, given parent CDF values f."""
    f = np.asarray(f, dtype=np.float64)
    assert 1 <= m <= n, (m, n)
    out = np.zeros_like(f)
    for i in range(m, n + 1):
        out += math.comb(n, i) * f ** i * (1.0 - f) ** (n - i)
    return out


def order_statistic_expectation(lengths: Sequence[float], m: int, n: int,
                                grid: int = 4096) -> float:
    """E[X_(m)] of n draws from the *empirical* distribution of `lengths`.

    E[X] = ∫ (1 − F_(m)(x)) dx over [0, max]; numeric on a grid.
    """
    xs = np.sort(np.asarray(lengths, dtype=np.float64))
    hi = xs[-1]
    grid_x = np.linspace(0.0, hi, grid)
    f_parent = np.searchsorted(xs, grid_x, side="right") / len(xs)
    f_m = order_statistic_cdf(f_parent, m, n)
    return float(np.trapezoid(1.0 - f_m, grid_x))


def empirical_mth_completion(lengths: np.ndarray, m: int, n: int,
                             trials: int, seed: int = 0) -> np.ndarray:
    """Monte-Carlo: sample n lengths per trial, return the m-th smallest."""
    rng = np.random.default_rng(seed)
    draws = rng.choice(np.asarray(lengths), size=(trials, n), replace=True)
    part = np.partition(draws, m - 1, axis=1)
    return part[:, m - 1]


def expected_speedup(lengths: Sequence[float], m: int, n: int) -> float:
    """E[max of m] / E[m-th of n] — the early-stopping win for equal yield.

    Baseline (Self-Consistency with m branches) waits for the slowest of m;
    SART with n>m redundant branches waits only for the m-th fastest of n.
    """
    base = order_statistic_expectation(lengths, m, m)
    ours = order_statistic_expectation(lengths, m, n)
    return base / max(ours, 1e-9)
