"""Training data pipeline: trace generation, packing, batching.

Counterpart of ``repro.data.pipeline``, a copy: pure NumPy on the host,
batches that the train step moves to its device.
Sequences are packed back-to-back with segment ids so attention stays within
a trace (the packed path uses the model's ``segment_ids`` support), or padded
per-row for the simple path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from . import tasks
from . import tokenizer as tk


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 32
    seq_len: int = 128
    min_terms: int = 3
    max_terms: int = 8
    recheck_p: float = 0.25
    overthink_p: float = 0.05
    seed: int = 0


def padded_batches(cfg: DataConfig) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yields (tokens, labels, mask) of shape [B, S].

    labels[i] = tokens shifted left by one; mask is 1 on CoT positions only
    (the prompt is conditioning, not a training target).
    """
    rng = np.random.default_rng(cfg.seed)
    while True:
        toks = np.full((cfg.batch_size, cfg.seq_len), tk.PAD, np.int32)
        mask = np.zeros((cfg.batch_size, cfg.seq_len), np.float32)
        for b in range(cfg.batch_size):
            prob = tasks.gen_problem(rng, cfg.min_terms, cfg.max_terms)
            trace = tasks.render_trace(prob, rng, cfg.recheck_p,
                                       overthink_p=cfg.overthink_p)
            trace = trace[:cfg.seq_len]
            toks[b, :len(trace)] = trace
            plen = len(prob.prompt_tokens())
            mask[b, plen - 1:len(trace) - 1] = 1.0   # predict CoT tokens
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = tk.PAD
        yield toks, labels, mask


def prm_batches(cfg: DataConfig, error_p: float = 0.3
                ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Batches for PRM-head training: (tokens, step_labels, step_mask).

    Traces are rendered with per-step corruption probability ``error_p``;
    label 1 at a position iff every emission up to and including it is
    correct (matching how the PRM judges a *partial* branch).
    """
    rng = np.random.default_rng(cfg.seed + 7)
    while True:
        toks = np.full((cfg.batch_size, cfg.seq_len), tk.PAD, np.int32)
        labels = np.zeros((cfg.batch_size, cfg.seq_len), np.float32)
        mask = np.zeros((cfg.batch_size, cfg.seq_len), np.float32)
        for b in range(cfg.batch_size):
            prob = tasks.gen_problem(rng, cfg.min_terms, cfg.max_terms)
            corrupt = rng.random() < 0.5
            trace = tasks.render_trace(
                prob, rng, cfg.recheck_p, error_p=error_p if corrupt else 0.0)
            trace = trace[:cfg.seq_len]
            toks[b, :len(trace)] = trace
            plen = len(prob.prompt_tokens())
            # per-position prefix-correctness labels on emission digits
            correct_so_far = True
            i = plen
            while i < len(trace) - 1:
                t = trace[i]
                if t in (tk.STEP, tk.RECHECK, tk.ANSWER) \
                        and tk.is_digit(trace[i + 1]):
                    c, tot = tasks.grade_steps(prob, trace[plen:i + 2])
                    correct_so_far = (c == tot)
                    labels[b, i + 1] = 1.0 if correct_so_far else 0.0
                    mask[b, i + 1] = 1.0
                    i += 2
                else:
                    i += 1
        yield toks, labels, mask
