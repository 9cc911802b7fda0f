"""Synthetic verifiable reasoning tasks (modular arithmetic chains).

Design goals mirroring the paper's experimental conditions:
  * exact answer checking (stand-in for GPQA/GAOKAO graders);
  * CoT traces whose *length varies independently of correctness* — training
    traces include stochastic "recheck" steps (`R<d>;` re-emitting the
    current running value), and a geometric tail of rechecks reproduces the
    over-thinking dilemma: occasional branches run extremely long;
  * a step-level notion of partial correctness for the oracle PRM: every
    emitted step digit is checkable against the true running values.

Trace grammar (see ``repro_torch.data.tokenizer``):
    ^ d1 op d2 op d3 ... =  ( >v; (Rv;)* )*  A a $
where v is the running value (mod 10) after folding each term and `a` the
final answer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import tokenizer as tk


@dataclasses.dataclass(frozen=True)
class Problem:
    terms: Tuple[int, ...]        # digits
    ops: Tuple[str, ...]          # between terms, len = len(terms)-1
    running: Tuple[int, ...]      # running value (mod 10) after each fold
    answer: int                   # == running[-1]

    def prompt_tokens(self) -> List[int]:
        out = [tk.BOS, tk.digit(self.terms[0])]
        for op, t in zip(self.ops, self.terms[1:]):
            out += [tk.OPS[op], tk.digit(t)]
        out.append(tk.EQUALS)
        return out


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


def render_trace(problem: Problem, rng: np.random.Generator,
                 recheck_p: float = 0.25, error_p: float = 0.0,
                 overthink_p: float = 0.05,
                 overthink_geo: float = 0.15) -> List[int]:
    """Full training trace = prompt + CoT + answer + EOS.

    ``recheck_p``   — per-step probability of one redundant recheck.
    ``overthink_p`` — probability this trace falls into the over-thinking
                      dilemma: a geometric (p=overthink_geo) burst of extra
                      rechecks at a random step, producing the long tail of
                      response lengths the paper observes (§3, Fig. 2).
    ``error_p``     — per-step probability of a corrupted digit (used to
                      build PRM-head training data, not the LM data).
    """
    out = list(problem.prompt_tokens())
    overthink_at = (int(rng.integers(0, len(problem.running)))
                    if rng.random() < overthink_p else -1)

    def emit(head: int, value: int):
        v = value
        if error_p and rng.random() < error_p:
            v = (v + int(rng.integers(1, 10))) % 10
        out.extend([head, tk.digit(v), tk.SEP])
        return v == value

    ok = True
    for i, v in enumerate(problem.running):
        ok &= emit(tk.STEP, v)
        n_recheck = 1 if rng.random() < recheck_p else 0
        if i == overthink_at:
            n_recheck += int(rng.geometric(overthink_geo))
        for _ in range(n_recheck):
            ok &= emit(tk.RECHECK, v)
    final = problem.answer
    if error_p and rng.random() < error_p:
        final = (final + int(rng.integers(1, 10))) % 10
        ok = False
    out.extend([tk.ANSWER, tk.digit(final), tk.EOS])
    return out


# ----------------------------------------------------------- answer checking


def extract_answer(tokens: List[int]) -> Optional[int]:
    """Extract the final answer digit from generated tokens ('A' d)."""
    for i in range(len(tokens) - 1, -1, -1):
        if tokens[i] == tk.ANSWER and i + 1 < len(tokens) \
                and tk.is_digit(tokens[i + 1]):
            return tk.digit_value(tokens[i + 1])
    return None


def grade_steps(problem: Problem, generated: List[int]) -> Tuple[int, int]:
    """(correct_emissions, total_emissions) for a (partial) branch."""
    ptr = 0
    correct = total = 0
    i = 0
    n = len(generated)
    while i < n:
        t = generated[i]
        if t in (tk.STEP, tk.RECHECK, tk.ANSWER) and i + 1 < n \
                and tk.is_digit(generated[i + 1]):
            v = tk.digit_value(generated[i + 1])
            if t == tk.STEP:
                exp = (problem.running[ptr] if ptr < len(problem.running)
                       else None)
                ptr += 1
            elif t == tk.RECHECK:
                exp = (problem.running[ptr - 1]
                       if 0 < ptr <= len(problem.running) else None)
            else:
                exp = problem.answer
            total += 1
            if exp is not None and v == exp:
                correct += 1
            i += 2
        else:
            i += 1
    return correct, total


def oracle_grader(request, generated: List[int]) -> float:
    """PRM protocol grader: fraction of correct emissions so far.

    ``request.payload`` must be the Problem. Neutral 0.5 before any step.
    """
    problem: Problem = request.payload
    correct, total = grade_steps(problem, generated)
    if total == 0:
        return 0.5
    return correct / total


def is_correct(problem: Problem, answer) -> bool:
    return answer is not None and int(answer) == problem.answer
