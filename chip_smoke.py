#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py              # every phase; needs one card
    python3 chip_smoke.py --skip-serve # build + kernel checks only, no "ok"
    python3 chip_smoke.py --profile DIR  # build + profiled serves (eager
                                         # and graphs), no "ok"
    python3 chip_smoke.py --tree-pairs 3 # build + phase 6 tree/paged pairs

Phases, in order; any failure raises and the script exits non-zero:

  1. device  — the card's name and power limit (nvidia-smi) and torch's name;
  2. build   — nvcc builds the CUDA kernels from ``src/repro_torch/csrc``
               (the time of each source, ptxas's registers and spills,
               and the tensor-core instructions in the SASS per kernel;
               the bf16 kernels of K2 and K4 must hold HMMA and spill
               nothing; one line sums up the registers and spill bytes
               of the sixteen head_dim-256 instantiations of K1, K2, K3,
               K5 and K5's backward (its D pass two), others those of every
               instantiation of K5's and of K4's backward, whose bf16
               kernels must hold HGMMA (K5's, wgmma) or HMMA (K4's) and
               none of which may spill);
  3. kernels — K1 (paged flash-decode; bf16 on the split-key mma.sync
               decode core), K2 (paged flash-prefill), both
               passes of K3 (tree decode; the shared pass's split partials
               folded by the plain merge; the branch pass on the decode
               core), K4 (the SSD chunked scan, y
               and final state, with and without an initial state) and K5
               (the dense flash prefill: wgmma in bf16, CUDA cores in
               fp32) against their plain PyTorch versions on the card,
               bf16 and fp32, at the serving shapes
               of r1-distill-14b and mamba2-130m, one qwen2-0.5b and one
               hymba-1.5b shape, head_dim 32 (the launcher's fallback
               trunks) for K1-K3 and K5, the GQA groups of the families
               of phases 10-11 (qwen3-moe-235b-a22b's 16 and qwen2-vl-72b's
               8 at head_dim 128 for K1, K2, K3 and K5; musicgen-medium's
               1 at head_dim 64 with 24 KV heads for K1, K2 and K5), and
               the edge cases (K1's ragged
               lengths 0-512, and 0-2,048 over 128-page tables cut into two
               key splits, and a 24-head GQA group; K3's topologies, the
               same ragged lengths in one group, suffixes across two key
               splits, a span that is not a
               whole number of splits and a 13-member group; K1 and K3
               outputs bit-equal with and without the NaN in stale and
               unowned pages; K4's non-divisible S, masked dt and
               all-invalid rows; K5's non-divisible S, non-causal, GQA
               groups 1 and 8, true_len, a key loop wrapping the TMA ring);
               then each timed with CUDA events (L2 flushed
               before every launch; ``ms`` holds the wrapper's host time
               where it outlasts the flush, ``queued_ms`` queues the
               launches ahead and is the device's alone; ``host_us`` is
               the wrapper's host time per call) beside its plain
               version, a bound from
               bytes and operations, and one library call as a yardstick
               where one exists (none for K4); K5 at S = 272 and 4096; K1
               and K3's branch pass also at a long context (16 rows of 512
               tokens; suffixes of 240-256 tokens), and K1 at 2 rows of
               2,048 tokens, where each row spans two key splits (a
               cluster of 2 CTAs); K2 (one launch over all lanes of a
               step) also over four lanes of bucket 32 in one launch, each
               lane bit-equal to itself launched alone and with the NaN
               past its horizon taken out, and timed at phase 6's
               cold-header chunk (64 rows at pos0 192) too; K1 and K2
               also timed at qwen3-moe-235b-a22b's serve shape (64 query
               heads over 4 KV heads); K4 also timed
               at one row of 2,048 positions (16 chunks); K3's shared
               pass splits from the table's shape (16 splits of 32 keys
               at the serve's 32-page tables), both passes also timed at
               the 8 splits a host span of 256 tokens gave before;
               K5's backward (``flash_prefill_bwd.cu``; bf16 on
               wgmma, fp32 on the CUDA cores) against its plain
               version from the kernel's own output and LSE, at
               r1-distill-14b (B=2, S=2048), qwen2-0.5b (group 7,
               S=1000), gemma-7b (head_dim 256) and the tiny reasoner
               (head_dim 32), causal and not, with and without
               true_len: the error over the largest magnitude of the
               reference gradient within ``BWD_TOL``, the gradients
               bit-equal over two runs, the forward with its LSE output
               bit-equal to the forward without and its LSE against
               the plain one; timed at phase 14's shapes beside the
               backward of one SDPA call, with each launch's device
               time (D pass, dK/dV, dQ; ``launch_split_ms``); K4's
               backward
               (``ssd_scan_bwd.cu``; bf16 on mma.sync, fp32 on the CUDA
               cores) against its plain version from the forward's own
               chunk states, at mamba2-130m's training shape (B=2,
               S=2048), hymba-1.5b's widths, S a multiple of no chunk,
               masked dt, an initial state and the smoke widths, with a
               final-state gradient: the error over the largest
               magnitude within ``BWD_TOL``, bit-repeatable, the forward
               with its chunk states bit-equal to the forward without;
               timed at mamba2-130m's training shape beside the plain
               version and the bound from its bytes, with each launch's
               device time; the fused AdamW
               update (``adamw.cu``, one launch a leaf; not a TPU
               kernel) against the plain loop body, three updates
               (clipped, unclipped, clipped) on mamba2-130m's full tree
               and on one r1-distill-14b layer's leaves (bf16 and fp32
               leaves, ndim 1 and >= 2): p, mu and nu bit-equal; timed
               over the 14B layer's leaves beside the plain loop body,
               the bound from its bytes and one
               ``torch.optim.AdamW(fused=True)`` step; the top-p
               sampler (``sample_top_p.cu``; not a TPU kernel) at 320 x
               152,064 bf16 logits at two spreads and at one row,
               tokens and thresholds bit-equal to its plain version on
               the same keys, timed beside one read of the logits and
               the sort-based sampling it replaced;
  4. parity  — the engine on the card (kernels) against the engine on the
               CPU (plain versions) on small fp32 models, greedy, with
               chunked admission, forked branches, CoW and a suspend/resume
               round trip: dense, then with the prefix cache and tree
               decode on (a warm request sharing the cold one's header);
               ssm and hybrid (K4 in the chunk lanes), the hybrid again
               with the cache and tree on, its warm request seeded from a
               page-aligned SSM boundary snapshot; dense, ssm and hybrid
               with ``chunked_prefill=False`` (K5 in every exact
               admission); the smoke widths of qwen3-moe-235b-a22b (MoE;
               per-branch, cache and tree, exact; the smallest top-k
               router margin of the CPU run printed), qwen2-vl-72b
               (M-RoPE) and musicgen-medium (sinusoidal positions);
               ``Model.prefill`` + ``decode_step`` (dense and
               sliding-window); the launcher's dense and hybrid fallback
               trunks (head_dim 32) serving on the card; the card's
               engines step through their CUDA graphs; last, a fault
               case: the smoke 14B in fp32 with the prefix cache,
               greedy, 3 requests behind a ``FaultInjector`` whose plan
               storms oop, raises step faults and crashes at step 12
               (``FAULT_PARITY_PLAN``): the card's engine must give the
               CPU engine's trajectory and injected counts; then
               training: 3 steps of ``make_train_step`` on the card
               (K5's and K4's forward and backward, fp32) against the
               CPU from the same weights and batches, the tiny reasoner
               (head_dim 32) and the smoke widths of
               qwen3-moe-235b-a22b, mamba2-130m (ssm) and hymba-1.5b
               (hybrid): losses, grad norms and params after the last
               step within tolerance; on the card the step is a CUDA
               graph (step 1 warms up, step 2 captures and replays,
               step 3 replays), and the launches it ran are each
               kernel's forward 2 x layers x steps, its backward layers
               x steps where the config runs it and AdamW leaves x
               steps (the wrappers' own counters: warm-up and capture);
  5. serve   — r1-distill-14b at full width and depth (48 layers, bf16,
               random weights from a seed) behind the SART scheduler through
               ``repro_torch.launch.serve.run_serving``: 4 requests, n=8.
               Every step is the replay of its variant's CUDA graph (the
               engine's default on the card): replays must equal decode
               steps, graphs captured at most the declared variants.
               Kernel launch counters are zeroed just before and read just
               after; a kernel's launches are what the engine reports, its
               launches recorded at capture times its variant's replays
               (``Engine.step_launches``). Every request must complete
               with no fault; K2 must launch once per layer per mixed
               step, the top-p sampler once per step (phases 6-8 and
               10-13 hold its launches to its wrapper's count too);
  6. tree    — the same model and weights, phase 5's engine freed, with
               ``prefix_cache=True, decode_kernel="tree"``: 4 requests whose
               prompts share a 256-token few-shot header. The cache must
               hit, K3 must carry every decode row, K1 must not launch and
               K2 must launch once per layer per mixed step;
  7. exact   — the same model and weights, phase 6's traffic with
               ``chunked_prefill=False`` (cache off, per-branch decode):
               every admission is one exact-length pass, K5 48 times; K5
               must launch 192 times, K2 never, K1 on every step; then
               ``Model.prefill`` of a 4,096-token prompt (48 K5 launches)
               and 8 ``decode_step``s over its dense cache, and exact
               against chunked first-token logits of one prompt (printed);
  8. ssm     — mamba2-130m at full width and depth (24 layers, d_model
               768, 24 SSD heads, state 128, bf16, random weights from a
               seed) through ``run_serving``: 4 requests, n=8. K4 must
               launch once per layer per mixed step, K1-K3 never; every
               request completes with no fault and no leaked page;
  9. graphs  — eager steps (``Engine.eager()``) against graph steps, greedy,
               at full width and depth on one set of random weights each:
               r1-distill-14b on phase 5's traffic and on phase 6's with
               tree decode, mamba2-130m on phase 8's. The tokens of every
               decode step must be identical; prints the steps' largest
               logit difference, both step p50s and each variant's
               capture time;
 10. moe     — qwen3-moe-235b-a22b at full width (d_model 4096, 64/4
               heads of 128, 128 experts top-8 of d_ff 1536, vocab
               151936), its depth cut from 94 to 8 layers to fit the
               card, bf16, random weights from a seed, on phase 5's
               traffic through ``run_serving`` and the step graphs: K1
               every step, K2 once per layer per mixed step, replays =
               decode steps, 4/4 requests, no fault or leaked page,
               finite hidden states; then the same traffic greedy, eager
               against graphs: tokens identical at every step and the
               logit difference 0.0 on the rows that carry a result.
               Prints the step p50 beside the bound from the bytes a step
               streams (every expert's weights: the capacity buffer runs
               all 128), the peak memory and each variant's capture time;
 11. family  — the same checks on qwen2-vl-72b (M-RoPE; full width, 8 of
               its 80 layers) and musicgen-medium (sinusoidal positions;
               full width and depth), 2 requests, n=4, max 48 tokens,
               the engine feeding text token ids (the vision and codec
               frontends are stubbed in the configs);
 12. gemma   — gemma-7b at full width and depth (28 layers, d_model 3072,
               16/16 heads of 256, GeGLU, a tied vocabulary of 256,000;
               bf16, random weights from a seed): the head_dim-256
               kernels on the serve path, three runs on one set of
               weights. Phase 5's traffic (K1 every step, K2 once per
               layer per mixed step), then greedy eager against graphs;
               phase 6's shared-header traffic with the prefix cache and
               tree decode (K3 carries every decode row, K1 never), then
               greedy eager against graphs; phase 7's exact admission
               (K5 in all 28 layers per admission) and ``Model.prefill``
               of 4,096 tokens. Each run: 4/4 requests, no fault or leaked
               page, finite hidden states, replays = decode steps; tokens
               identical and logit difference 0.0 eager against graphs.
               Prints each run's step p50 beside the bound from the bytes
               a step streams, the peak memory and each variant's capture
               time;
 13. chaos   — runs after phase 7, on its r1-distill-14b model and
               weights, each run on a fresh engine of run_serving's
               config with the prefix cache on, under the seeded
               ``CHAOS_PLAN`` (oop storms, step faults, corrupted logits
               after a step that ran, slow steps, a crash at step 60,
               transient admission faults). Run A: phase 5's traffic
               plus a fifth request holding the poison token ``tk.STEP``
               (K1, K2): the four clean requests finish, the poisoned one
               ends quarantined, every fault category fires, at least one
               restart and one recovery. Run B: phase 5's traffic greedy
               on two fresh engines, bare and behind an empty plan: every
               branch's tokens and the trajectory equal. Run C: phase 6's
               shared-header traffic with tree decode (K3; K1 never)
               under the plan without the poison token (the header's
               traces hold ``tk.STEP``). In A and C: no slot or page held
               at the end, allocator invariants, finite hidden states,
               replays = the inner engine's decode steps (oop, step and
               crash faults raise before a step; a nan fault is a replay
               whose output is thrown away), each captured variant
               captured once. Prints one ``[chaos]`` line a run and the
               phase's seconds. The injected faults are caught by the
               scheduler: anything that escapes ``Scheduler.run`` fails
               the phase.
 14. train   — runs after every model of phases 5-13 is freed.
               Every train step runs through the port's counterpart of
               the reference's jitted step, one CUDA graph per batch
               signature (``training/train_graph.py``): step 1 warms up
               eagerly, step 2 captures and replays, every later step
               replays (checked: one capture, replays = steps - 1; a
               failed capture raises). r1-distill-14b at full width,
               its depth cut from 48 to 8 layers, bf16 params with fp32
               AdamW moments: 8 steps of ``train_lm`` on
               ``padded_batches`` at B=2, S=2048; every loss and grad
               norm finite, the last loss below the first; the launches
               run (``TrainGraph.launches_run``) K5's forward 2 x 8 x 8,
               its backward 8 x 8, AdamW once per leaf a step, the
               wrappers' calls those of two steps (warm-up and
               capture); prints the step p50 over the replayed steps
               (3 on), the capture's seconds apart, tokens/s, the peak
               memory and the step's bound from its operations, and the
               breakdown of one traced replay (the AdamW kernel once a
               leaf); then 3 steps of ``train_prm_head`` on those
               weights through ``make_prm_step``'s graph (K5's backward
               never). Eager against graph from the same seed and
               batches, 3 steps each: r1-distill-14b at full width and
               2 layers, mamba2-130m at full width and depth; losses,
               grad norms and every param bit-equal. ``smoke_arch`` of
               mamba2-130m and hymba-1.5b on the card (one eager step:
               K4's forward and backward and AdamW, launches exact);
               mamba2-130m at full width and depth (24 layers), 8 steps
               at B=2, S=2048, falling loss, K4 forward 384 and backward
               192 launches run; hymba-1.5b at full width and depth (32
               layers, ~1.5 B params), 5 steps at B=1, S=2048, finite
               losses, K4 320 and 160, K5 none (its attention has a
               window); each with its breakdown. gemma-7b at full
               width, 2 of its 28 layers (the head_dim-256 backward), 5
               steps at B=1, S=2048. Last the launcher's
               ``train_reasoner`` with the reference's defaults in a
               temp dir: the LM loss falls by at least 20%, the PRM loss
               is finite, lm.npz and prm.npz load back bit-equal, K5's
               backward wrapper ran at the warm-up and the capture
               only. The 14B's line holds a digest of every param
               leaf's bits after its 8 steps (``_param_digest``).
 15. dist    — the distribution layer, after phase 14: a 1 x 1
               ``("data", "model")`` DeviceMesh on the card, the process
               group NCCL, world size 1, on an in-process ``HashStore``.
               ``launch/steps.py:build_step``'s train step of
               r1-distill-14b (8 layers, B=2, S=2048, phase 14's seed,
               AdamW settings and batches) through its ``TrainGraph``
               on DTensor params: every loss and grad norm and the
               params' digest after step 8 equal to phase 14's, the
               step p50 beside phase 14's (and the ratio), the
               collectives ``CommDebugMode`` counts in the warm-up step,
               the peak memory, launches as phase 14's; the prefill
               step (a 4,096-token prompt, B=1, K5 once a layer) and 8
               serve steps on its cache, logits and cache bit-equal to
               ``Model.prefill``/``decode_step`` on the same weights;
               mamba2-130m at full width and depth, 3 steps, bit-equal
               to its unsharded train graph (K4 and its backward); the
               smoke qwen3-moe-235b-a22b's prefill step with
               ``moe_dp=2`` (the shard-local dispatch) against the same
               dispatch on the CPU, within atol 1e-4. K4, K5, their
               backwards and AdamW run on the DTensors' local shards.
 16. verifiers — the launch-grid check and STEP007 on the card, after
               phase 15 (``[verifiers]`` lines). Each serve-path
               launcher (K1, K2, both K3 passes, K4, K5 and the top-p
               sampler) and the launchers of K5's and K4's backward,
               bf16 and fp32 (18 calls), is called once through its
               wrapper with its grid function's first grid off by one
               in x, and must raise
               (the launcher refuses it before launching; the wrapper
               counts no launch). Then every STEP007 lattice case
               (``repro_torch.stepcheck.bounds.engine_lattice``, both
               routes, head_dim 128) runs on its kernel with every
               input a view between NaN guard regions (ints: an
               out-of-pool value): each output equal to the plain
               version within the phase-3 tolerance, exact zeros where
               the plain row is zero, finite, and every guard unchanged.
               Last the examples at smoke size on the card, in-process:
               ``examples/torch_quickstart.py`` (no page leaked), then
               ``torch_train_tiny_reasoner.py`` into a temp dir and
               ``torch_serve_reasoning.py`` and
               ``torch_sart_vs_baselines.py`` over its checkpoint.
 17. spans   — the tracer's device marks (``repro_torch.spans``), after
               phase 16 (``[spans]`` lines): a toy graph of two marked
               intervals (two matmuls), captured with the marks and
               replayed, each interval's time within 25% of the same
               events recorded eagerly; then the smoke dense and MoE
               models served through the step graphs with the tracer on:
               one device row per replayed step, each kind the body
               marks timed (``moe_route`` and ``moe_experts`` for MoE),
               the kinds' sum under the step's wall time; no row from an
               eager step, and a graph captured with the tracer off holds
               no marks.

The serve phases time each decode step by the tracer's
``engine.decode_step`` span (the tracer is on from the start, with
``marks=False``: their graphs carry no device marks).

Phase 3 also holds the head_dim-256 instantiations of K1, K2, both K3
passes and K5 at gemma-7b's serve shapes (16/16 heads of 256, group 1):
K1's ragged lengths and a row across two key splits, K2's four lanes in
one launch (each bit-equal alone), K3's topologies, K5 at S = 272 and
4096, non-causal, with true_len and through the ring; the NaN
bit-equality checks; each timed beside its bound and one SDPA call.
Phase 4 adds gemma-7b's smoke widths at head_dim 256 (per-branch, cache
and tree, exact; and ``Model``). The JSON line lists the head_dim-256
kernels as rows of their own (``<name>_hd256``), their launches from
phase 12.

Phases 5, 6 (tree and paged), 7 (its decode steps), 8, 10, 11, 12 and
13 serve through the step graphs; a capture or replay that fails raises,
and nothing falls back to the eager step.

Then one JSON line ``{"kernels": [...]}`` (``launches_chaos``: phase
13's runs A and C; K5's backward rows, ``flash_prefill_bwd`` and
``flash_prefill_bwd_hd256``, count phase 14's r1-distill-14b and gemma-7b
runs, K4's backward row ``ssd_scan_bwd`` its mamba2-130m run and
``launches_hymba`` its hymba-1.5b run, the ``adamw`` row the 14B's run
and ``launches_mamba`` mamba2-130m's, the ``sample_top_p`` row phase 3's
320-row x1.5 timing (``timed_shapes``: all three) and phase 5's
launches; phase 14's counts are the launches
its graphs ran; ``launches_sharded``: what phase 15 ran of K5, its
backward, K4, its backward and AdamW), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without a card, or without the repo's
``src/`` beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
DEVICE = "cuda"
T_START = time.perf_counter()

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
TOL = {"bf16": 2e-2, "fp32": 1e-5}      # atol = rtol, per working dtype
# the bf16 tensor-core kernels of K2 and K4 (phase 2: HMMA, no spills)
TENSOR_K2_K4 = {"paged_prefill": "prefill_mma_kernel",
                "ssd_scan": "ssd_mma_kernel"}
# the bf16 kernels of K5's backward (phase 2: HGMMA, wgmma) and K4's
# (HMMA, mma.sync); registers and spills printed per instantiation, none
# may spill
TENSOR_BWD = {"flash_prefill_bwd": ("dkdv_wgmma_kernel", "dq_wgmma_kernel"),
              "ssd_scan_bwd": ("dstate_chain_kernel",
                               "chunk_grad_mma_kernel")}
# name fragments of the port's CUDA kernels (K1-K5), for the profile
PORT_KERNELS = ("decode_mma_kernel", "paged_decode_kernel",
                "prefill_mma_kernel", "prefill_f32_kernel",
                "tree_shared", "tree_branch_kernel",
                "ssd_mma_kernel", "ssd_f32_kernel", "flash_prefill")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- inputs


def _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd, dtype):
    return (torch.randn((kv_heads, pool_pages, ps, hd), generator=gen,
                        device=dev).to(dtype),
            torch.randn((kv_heads, pool_pages, ps, hd), generator=gen,
                        device=dev).to(dtype))


def _poison_tail(k_pages, v_pages, page: int, start: int) -> None:
    """NaN into a page's slots past a sequence's end: a kernel that
    multiplies them by a zero weight instead of skipping them fails."""
    k_pages[:, page, start:] = float("nan")
    v_pages[:, page, start:] = float("nan")


def k1_inputs(torch, gen, dev, *, lengths, q_heads, kv_heads, hd, ps, width,
              pool_pages, dtype):
    batch = len(lengths)
    q = torch.randn((batch, q_heads, hd), generator=gen, device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    perm = torch.randperm(pool_pages, generator=gen, device=dev).tolist()
    # sentinel tails point past the pool: a kernel must never follow them
    bt = torch.full((batch, width), pool_pages, dtype=torch.int32)
    off = 0
    for b, n_tok in enumerate(lengths):
        n = -(-n_tok // ps)
        bt[b, :n] = torch.tensor(perm[off:off + n], dtype=torch.int32)
        off += n
        if n_tok % ps:
            _poison_tail(k_pages, v_pages, perm[off - 1], n_tok % ps)
    # every page no row owns is NaN (the clamped sentinel's target too)
    unowned = torch.tensor(perm[off:], dtype=torch.long, device=dev)
    k_pages[:, unowned] = float("nan")
    v_pages[:, unowned] = float("nan")
    return (q, k_pages, v_pages, bt.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def k2_inputs(torch, gen, dev, *, t, pos0, valid_len, q_heads, kv_heads, hd,
              ps, width, pool_pages, dtype):
    q = torch.randn((t, q_heads, hd), generator=gen, device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    end = pos0 + valid_len
    n = -(-end // ps)
    perm = torch.randperm(pool_pages, generator=gen, device=dev).tolist()
    bt = torch.full((width,), pool_pages, dtype=torch.int32)
    bt[:n] = torch.tensor(perm[:n], dtype=torch.int32)
    if end % ps:
        _poison_tail(k_pages, v_pages, perm[n - 1], end % ps)
    return q, k_pages, v_pages, bt.to(dev), pos0, valid_len


def k2_lanes_inputs(torch, gen, dev, *, bucket, lanes, q_heads, kv_heads, hd,
                    ps, width, pool_pages, dtype):
    """One mixed step's chunk lanes as the engine lays them out: ``lanes``
    is a list of (pos0, valid_len); each lane owns its own pages, its
    ``bucket`` rows share its block table, and its positions run from pos0
    (pad rows repeat the last valid one). Slots past each lane's last valid
    position and every page no lane owns (the clamped sentinel's target
    too) are NaN. Returns (q, k_pages, v_pages, block_tables [R, W],
    positions [R], chunk_lens [n])."""
    n = len(lanes)
    q = torch.randn((n * bucket, q_heads, hd), generator=gen,
                    device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    perm = torch.randperm(pool_pages, generator=gen, device=dev).tolist()
    bt = torch.full((n * bucket, width), pool_pages, dtype=torch.int32)
    pos = torch.zeros((n * bucket,), dtype=torch.int32)
    off = 0
    for i, (pos0, valid) in enumerate(lanes):
        end = pos0 + valid
        npg = -(-end // ps)
        bt[i * bucket:(i + 1) * bucket, :npg] = torch.tensor(
            perm[off:off + npg], dtype=torch.int32)
        off += npg
        pos[i * bucket:(i + 1) * bucket] = torch.clamp(
            pos0 + torch.arange(bucket), max=end - 1)
        if end % ps:
            _poison_tail(k_pages, v_pages, perm[off - 1], end % ps)
    unowned = torch.tensor(perm[off:], dtype=torch.long, device=dev)
    k_pages[:, unowned] = float("nan")
    v_pages[:, unowned] = float("nan")
    lens = torch.tensor([v for _, v in lanes], dtype=torch.int32)
    return q, k_pages, v_pages, bt.to(dev), pos.to(dev), lens.to(dev)


def k2_bytes_ops(t: int, pos0: int, valid: int, *, H, kv, hd, ps):
    """What one K2 lane needs (bf16): q of the valid rows in, every output
    row out, the K/V of the visible tokens once (the reference's byte
    model at token granularity) and the table entries the causal horizon
    reaches; 4 hd operations per (valid row, visible key) pair and head."""
    from repro_torch.kernels.flash_prefill.ops import mixed_step_bytes_read
    seen = sum(pos0 + i + 1 for i in range(valid))
    return ((valid + t) * H * hd * 2
            + mixed_step_bytes_read(valid, pos0, 1, kv, hd, path="fused",
                                    block_q=t, itemsize=2)
            + -(-(pos0 + valid) // ps) * 4, 4 * seen * H * hd)


# ---------------------------------------------------------------- timing


def k3_inputs(torch, gen, dev, *, groups, singles, q_heads, kv_heads, hd,
              ps, width, pool_pages, dtype):
    """A fork topology and its tree map, as ``tree_decode_map`` lays it
    out (group axis padded to the batch). ``groups``: (shared pages, [row
    lengths in tokens]) per fork group; ``singles``: lengths of rows in no
    group. Every page no row owns is NaN, and so is every slot past a
    row's end in a page only that row reads."""
    perm = iter(torch.randperm(pool_pages, generator=gen,
                               device=dev).tolist())

    def take(n):
        return [next(perm) for _ in range(n)]

    rows = []                      # (group or None, shared, suffix, length)
    for gi, (n_shared, lens) in enumerate(groups):
        shared = take(n_shared)
        for n in lens:
            rows.append((gi, shared, take(-(-max(n - n_shared * ps, 0)
                                            // ps)), n))
    rows += [(None, [], take(-(-n // ps)), n) for n in singles]
    batch = len(rows)
    q = torch.randn((batch, q_heads, hd), generator=gen, device=dev).to(dtype)
    k_pages, v_pages = _pages(torch, gen, dev, kv_heads, pool_pages, ps, hd,
                              dtype)
    rg = torch.full((batch,), batch, dtype=torch.int32)
    sbt = torch.full((batch, width), pool_pages, dtype=torch.int32)
    sl = torch.zeros((batch,), dtype=torch.int32)
    bbt = torch.full((batch, width), pool_pages, dtype=torch.int32)
    used = set()
    for b, (gi, shared, suffix, n) in enumerate(rows):
        if gi is not None:
            rg[b] = gi
            sbt[gi, :len(shared)] = torch.tensor(shared, dtype=torch.int32)
            sl[gi] = len(shared) * ps
        bbt[b, :len(suffix)] = torch.tensor(suffix, dtype=torch.int32)
        used.update(shared + suffix)
        if suffix and n % ps:
            _poison_tail(k_pages, v_pages, suffix[-1], n % ps)
    unowned = torch.ones((pool_pages,), dtype=torch.bool)
    unowned[sorted(used)] = False
    k_pages[:, unowned.to(dev)] = float("nan")
    v_pages[:, unowned.to(dev)] = float("nan")
    lengths = torch.tensor([r[3] for r in rows], dtype=torch.int32)
    return (q, k_pages, v_pages, rg.to(dev), sbt.to(dev), sl.to(dev),
            bbt.to(dev), lengths.to(dev))


def time_ms(torch, fn, n: int = 50, warmup: int = 5,
            head_start: bool = False) -> float:
    """Mean device time of ``fn`` over ``n`` launches (CUDA events around
    each launch), with a 64 MiB write before each to push the inputs out
    of the 50 MB L2, as a layer of the serving step finds them. Where the
    host takes longer to issue ``fn``'s launches than the card takes for
    the write, the card idles inside the measurement: the time then
    holds the wrapper's host time, which a host-bound step also pays.
    ``head_start`` adds a ~0.3 ms spin of the card after the write, so
    the launches are queued before the card reaches the start event and
    the time is the device's alone (reported as ``queued_ms``)."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        flush.zero_()
        if head_start:
            torch.cuda._sleep(500_000)   # cycles; touches no memory
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / n


def host_us(torch, fn, n: int = 200) -> float:
    """Mean host time of one call of ``fn`` in microseconds: ``n`` calls
    issued back to back (the card's queue absorbs them), no sync inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def kernel_ms(torch, fn) -> dict:
    """A kernel wrapper's ``ms`` (host time included where the host is
    slower than the flush), ``queued_ms`` (launches queued ahead: the
    device's time alone), both from ``time_ms``, and ``host_us``, the
    wrapper's host time per call."""
    return {"ms": time_ms(torch, fn),
            "queued_ms": time_ms(torch, fn, head_start=True),
            "host_us": host_us(torch, fn)}


def launch_split_ms(torch, fn, kernels: dict, n: int = 20) -> dict:
    """Device ms of each launch of one wrapper call: ``fn`` run ``n``
    times, each behind a 64 MiB L2 flush and a ~0.3 ms spin (the launches
    queued, as ``queued_ms``), under torch.profiler (device activity
    only); each kernel's device time summed by name fragment
    (``kernels``: label -> fragment) and divided by ``n``."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            torch.cuda._sleep(500_000)
            fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label in kernels}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, frag in kernels.items():
            if frag in e.key:
                out[label] += e.self_device_time_total / 1e3 / n
    return out


def bound(bytes_moved: float, ops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi


def _demangle(symbol: str) -> str:
    """A kernel's C++ name from its mangled symbol (c++filt where the
    machine has it), shortened to the name and its template arguments."""
    try:
        symbol = subprocess.run(["c++filt", symbol], capture_output=True,
                                text=True, timeout=10).stdout.strip() \
            or symbol
    except OSError:
        pass
    return symbol.replace("(anonymous namespace)::", "").split("(")[0]


def phase_build():
    from repro_torch.kernels import build
    secs = build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in {secs:.1f} s -> "
          f"{build.build_dir()}")
    for name, t in sorted(build.build_seconds.items()):
        print(f"[build] {name}: nvcc done after {t:.1f} s")
    spills = {}     # the bf16 tensor-core kernels of K2 and K4
    wide = {}       # the head_dim-256 instantiations: registers, spills
    bwd = {name: {} for name in TENSOR_BWD}   # the backwards: the same
    fused = {}      # the AdamW kernel's instantiations: the same
    sampled = {}    # the top-p sampler's instantiations: the same
    for name, log in sorted(build.build_log.items()):
        fn = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = _demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {fn}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
                r = re.search(r"Used (\d+) registers", line)
                rows = [wide.setdefault(f"{name}: {fn}", {})] if re.search(
                    rf"[<, ]{WIDE}[,>]", fn) and (m or r) else []
                if name in bwd and (m or r):
                    rows.append(bwd[name].setdefault(fn, {}))
                if name == "adamw" and (m or r):
                    rows.append(fused.setdefault(fn, {}))
                if name == "sample_top_p" and (m or r):
                    rows.append(sampled.setdefault(fn, {}))
                for row in rows:
                    if m:
                        row["spill_bytes"] = int(m[1]) + int(m[2])
                    if r:
                        row["registers"] = int(r[1])
                if m and any(k in fn for k in TENSOR_K2_K4.values()):
                    spills[fn] = int(m[1]) + int(m[2])
    for fn, n in sorted(spills.items()):
        print(f"[build] {fn}: {n} bytes of spill stores and loads")
    print(f"[build] the head_dim-{WIDE} instantiations (registers, spill "
          f"stores + loads in bytes): " + json.dumps(wide))
    print("[build] flash_prefill_bwd, K5's backward, per instantiation "
          "(registers, spill stores + loads in bytes): "
          + json.dumps(bwd["flash_prefill_bwd"]))
    print("[build] ssd_scan_bwd, K4's backward, per kernel (registers, "
          "spill stores + loads in bytes): "
          + json.dumps(bwd["ssd_scan_bwd"]))
    print("[build] adamw, the fused AdamW update, per instantiation "
          "(registers, spill stores + loads in bytes): " + json.dumps(fused))
    check(all(row.get("spill_bytes", 0) == 0 for row in fused.values()),
          f"the AdamW kernel spills: {fused}")
    # (at 64 registers, what two CTAs of 512 threads an SM leave, the
    # sampler spills a few dozen bytes, outside its token loops' loads)
    print("[build] sample_top_p, the top-p sampler, per instantiation "
          "(registers, spill stores + loads in bytes): "
          + json.dumps(sampled))
    for name, rows in bwd.items():
        check(all(row.get("spill_bytes", 0) == 0 for row in rows.values()),
              f"a kernel of {name} spills: {rows}")
    if len(build.build_log) == len(build.SOURCES):   # all built here
        check(len(wide) == 16, f"expected 16 head_dim-{WIDE} kernels, "
                               f"found {sorted(wide)}")
    check(all(n == 0 for n in spills.values()),
          f"a bf16 kernel of K2 or K4 spills: {spills}")
    # the tensor-core instructions in the built code: warpgroup MMAs
    # (HGMMA, wgmma) in K5's bf16 kernel and its backward's, warp MMAs
    # (HMMA, mma.sync) in the bf16 decode core (K1; K3's branch pass), K3's
    # shared pass and the bf16 kernels of K2 and K4 and of K4's backward
    dump = Path(build._nvcc()).with_name("cuobjdump")
    if not dump.exists():
        print("[build] no cuobjdump beside nvcc: SASS not counted")
        return
    for name, op in (("flash_prefill_sm90", "HGMMA"),
                     ("paged_decode", "HMMA"),
                     ("paged_tree_decode", "HMMA"),
                     ("paged_prefill", "HMMA"),
                     ("ssd_scan", "HMMA"),
                     ("flash_prefill_bwd", "HGMMA"),
                     ("ssd_scan_bwd", "HMMA")):
        sass = subprocess.run(
            [str(dump), "-sass", str(build.build_dir() / f"lib{name}.so")],
            capture_output=True, text=True, timeout=120).stdout
        per_fn, fn = {}, "?"
        for line in sass.splitlines():
            if "Function :" in line:
                fn = _demangle(line.split("Function :")[1].strip())
            elif op in line:
                per_fn[fn] = per_fn.get(fn, 0) + 1
        n = sum(per_fn.values())
        print(f"[build] {name}: {n} {op} instructions in its SASS "
              + json.dumps(per_fn))
        check(n > 0, f"{name} has no {op} instruction")
        if name in TENSOR_K2_K4:
            check(any(TENSOR_K2_K4[name] in f for f in per_fn),
                  f"{name}: no {op} in {TENSOR_K2_K4[name]}")
        for kernel in TENSOR_BWD.get(name, ()):
            check(any(kernel in f for f in per_fn),
                  f"{name}: no {op} in {kernel}")


def _compare(torch, name, out, ref, dtype_name):
    tol = TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), atol=tol, rtol=tol)
    print(f"[kernels] {name}: max_abs_err {err:.3e} (atol=rtol={tol}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return err


# ragged decode lengths over 32-page tables of 16 tokens: empty, full
# (512), one key, and ends on and around page, tile and split edges
RAGGED = [0, 512, 1, 15, 16, 17, 33, 100, 255, 256, 257, 300, 400, 450, 500,
          511]
# and over 128-page tables, around the 1,024-key split edge
RAGGED_2K = [0, 2048, 1, 1023, 1024, 1025, 2047, 1500]


# the families served in phases 10-12, by their configs' attention
# shapes: qwen3-moe-235b-a22b (64 query heads over 4 KV heads of 128: a
# GQA group of 16, one m16 tile), qwen2-vl-72b (64 over 8: group 8),
# musicgen-medium (24 over 24 of 64: group 1, one row padded to 16),
# gemma-7b (16 over 16 of 256: group 1, the head_dim-256 instantiations)
FAMILY_ARCHS = {"qwen3-moe": "qwen3-moe-235b-a22b",
                "qwen2-vl": "qwen2-vl-72b", "musicgen": "musicgen-medium",
                "gemma": "gemma-7b"}
WIDE = 256      # the head_dim whose kernels get rows of their own


def kernel_key(name: str, hd: int) -> str:
    """The JSON line's kernel name of a case: the head_dim-256
    instantiations are rows of their own."""
    return f"{name}_hd{WIDE}" if hd == WIDE else name


def family_shapes(base: dict) -> dict:
    """``base`` (page size, table width, pool) with each family's heads
    and head_dim."""
    from repro_torch.configs import get_config
    out = {}
    for name, arch in FAMILY_ARCHS.items():
        cfg = get_config(arch)
        out[name] = dict(base, q_heads=cfg.num_heads,
                         kv_heads=cfg.num_kv_heads,
                         hd=cfg.resolved_head_dim)
    return out


def k1_splits(torch, page_size: int, width: int) -> str:
    """The bf16 decode core's key splits of such tables, for a shape
    string."""
    from repro_torch.kernels.paged_attention.ref import decode_splits
    keys, n = decode_splits(page_size, width, torch.bfloat16)
    if n == 1:
        return f"one key split of {keys} (one CTA per row and KV head)"
    return f"{n} key splits of {keys} (a cluster of {n} CTAs per row)"


def phase_kernels(torch):
    """Hold K1/K2 against their plain versions; returns per-kernel
    results for the JSON line (timings at the serving shapes)."""
    from repro_torch.kernels.flash_prefill.paged_prefill import (
        paged_flash_prefill_fwd, paged_flash_prefill_lanes_fwd)
    from repro_torch.kernels.flash_prefill.ref import (
        paged_flash_prefill_lanes_ref, paged_flash_prefill_ref)
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_decode
    from repro_torch.kernels.paged_attention.ref import (
        gather_pages, paged_attention_decode_ref)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    r1 = dict(q_heads=40, kv_heads=8, hd=128, ps=16, width=32,
              pool_pages=4097)
    qw = dict(q_heads=14, kv_heads=2, hd=64, ps=16, width=32,
              pool_pages=4097)
    # the serve launcher's untrained fallback trunks: 4/2 heads of 32
    t32 = dict(q_heads=4, kv_heads=2, hd=32, ps=16, width=32,
               pool_pages=4097)
    # 24 query heads per KV head: two 16-head slices of the bf16 kernel
    g24 = dict(q_heads=48, kv_heads=2, hd=64, ps=16, width=32,
               pool_pages=4097)
    errs = {k: [] for k in ("paged_decode", "paged_prefill",
                            kernel_key("paged_decode", WIDE),
                            kernel_key("paged_prefill", WIDE))}
    fam = family_shapes(r1)

    # 128-page tables (2,048 keys): two key splits, a cluster of 2 CTAs
    r1_2k = dict(r1, width=128)
    for shape_name, shape, lengths in (("r1", r1, RAGGED),
                                       ("qwen2", qw, RAGGED),
                                       ("hd32", t32, RAGGED),
                                       ("group24", g24, RAGGED[:6]),
                                       ("qwen3-moe group16",
                                        fam["qwen3-moe"], RAGGED),
                                       ("qwen2-vl group8",
                                        fam["qwen2-vl"], RAGGED),
                                       ("musicgen group1",
                                        fam["musicgen"], RAGGED),
                                       ("gemma hd256 group1",
                                        fam["gemma"], RAGGED),
                                       ("gemma hd256 2 splits",
                                        dict(fam["gemma"], width=128),
                                        RAGGED_2K),
                                       ("r1 2 splits", r1_2k, RAGGED_2K),
                                       ("hd32 2 splits", dict(t32, width=128),
                                        RAGGED_2K)):
        for dn, dt in dtypes.items():
            args = k1_inputs(torch, gen, dev, lengths=lengths, dtype=dt,
                             **shape)
            out = paged_attention_decode(*args)
            ref = paged_attention_decode_ref(*args)
            # NaN in stale slots and unowned pages changes no bit
            q, kp, vp, bt, ln = args
            clean = paged_attention_decode(q, kp.nan_to_num(),
                                           vp.nan_to_num(), bt, ln)
            torch.cuda.synchronize()
            check(bool((out[0] == 0).all()), "K1 length-0 row is not zero")
            check(torch.equal(out, clean), "K1 output moved with the NaN "
                  "in stale or unowned pages")
            errs[kernel_key("paged_decode", shape["hd"])].append(_compare(
                torch, f"K1 {shape_name} {dn} B={len(lengths)}", out, ref,
                dn))
    k2_cases = [(r1, t, pos0, valid) for t in (32, 64) for pos0 in (0, 37, 448)
                for valid in (t - 5, 1)] + [(qw, 64, 37, 60),
                                            (t32, 64, 37, 60),
                                            (t32, 32, 0, 17)] + [
        (fam[name], t, pos0, valid) for name in fam
        for t, pos0, valid in ((32, 0, 17), (64, 37, 60), (64, 448, 1))]
    for shape, t, pos0, valid in k2_cases:
        for dn, dt in dtypes.items():
            args = k2_inputs(torch, gen, dev, t=t, pos0=pos0, valid_len=valid,
                             dtype=dt, **shape)
            out = paged_flash_prefill_fwd(*args)
            ref = paged_flash_prefill_ref(*args)
            torch.cuda.synchronize()
            check(bool((out[valid:] == 0).all()), "K2 pad rows are not zero")
            errs[kernel_key("paged_prefill", shape["hd"])].append(_compare(
                torch, f"K2 H={shape['q_heads']} kv={shape['kv_heads']} "
                f"hd={shape['hd']} T={t} pos0={pos0} valid={valid} {dn}",
                out, ref, dn))
    # one launch over four lanes of bucket 32 (the engine's call): against
    # the plain version lane by lane, each lane bit-equal to that lane
    # launched alone, and bit-equal with the NaN past each lane's horizon
    # taken out of the pools
    lanes = [(0, 17), (37, 32), (256, 1), (496, 9)]
    for (shape_name, shape), (dn, dt) in itertools.product(
            (("r1", r1), ("gemma hd256", fam["gemma"])), dtypes.items()):
        q, kp, vp, bt, pos, lens = k2_lanes_inputs(
            torch, gen, dev, bucket=32, lanes=lanes, dtype=dt, **shape)
        out = paged_flash_prefill_lanes_fwd(q, kp, vp, bt, pos, lens,
                                            (32,) * 4)
        ref = paged_flash_prefill_lanes_ref(q, kp, vp, bt, pos, lens,
                                            (32,) * 4)
        clean = paged_flash_prefill_lanes_fwd(q, kp.nan_to_num(),
                                              vp.nan_to_num(), bt, pos, lens,
                                              (32,) * 4)
        torch.cuda.synchronize()
        errs[kernel_key("paged_prefill", shape["hd"])].append(_compare(
            torch, f"K2 {shape_name} 4 lanes of 32 at pos0 "
            f"{[p for p, _ in lanes]} valid {[v for _, v in lanes]} {dn}",
            out, ref, dn))
        check(torch.equal(out, clean), "K2 output moved with the NaN past "
              "the lanes' horizons")
        for i, (pos0, valid) in enumerate(lanes):
            rows = slice(32 * i, 32 * (i + 1))
            alone = paged_flash_prefill_fwd(q[rows], kp, vp, bt[32 * i],
                                            pos0, valid)
            check(torch.equal(out[rows], alone),
                  f"K2 lane {i} of 4 differs from the lane launched alone")
            check(bool((out[rows][valid:] == 0).all()),
                  f"K2 lane {i}: pad rows are not zero")
        print(f"[kernels] K2 {shape_name} 4 lanes {dn}: each lane "
              "bit-equal alone, bit-equal without the NaN, pad rows zeros: "
              "ok")

    # timing at the serve phase's shapes (bf16): 16 decode rows whose
    # contexts run from the prompt (11-17 tokens) to prompt + 96; one
    # chunk lane of bucket 32 holding a 17-token prompt from position 0
    rng_len = torch.Generator().manual_seed(1)
    lengths = torch.randint(17, 17 + 96, (16,), generator=rng_len).tolist()
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=lengths,
                                  dtype=torch.bfloat16, **r1)
    kc = gather_pages(kp, bt).nan_to_num()       # pre-gathered [B, kv, S, hd]
    vc = gather_pages(vp, bt).nan_to_num()
    mask = (torch.arange(kc.shape[2], device=dev)[None, :]
            < ln[:, None].long())[:, None, None, :]
    H, kv, hd, ps = r1["q_heads"], r1["kv_heads"], r1["hd"], r1["ps"]

    def k1_bytes_ops(lengths, H=H, kv=kv, hd=hd):
        tok = sum(lengths)
        followed = sum(-(-n // ps) for n in lengths)   # table entries read
        return (2 * len(lengths) * H * hd * 2 + tok * kv * hd * 2 * 2
                + followed * 4 + len(lengths) * 4, 4 * tok * H * hd)

    sdpa = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
    bytes_, ops = k1_bytes_ops(lengths)
    k1 = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "plain_ms": time_ms(torch, lambda: paged_attention_decode_ref(
            q, kp, vp, bt, ln)),
        "library_ms": sdpa["ms"],
        "bytes": bytes_, "ops": ops,
        "shape": f"B=16 H=40 kv=8 hd=128 ps=16 W=32 bf16, lengths "
                 f"{min(lengths)}..{max(lengths)} (sum {sum(lengths)}), "
                 f"{k1_splits(torch, ps, r1['width'])}",
    }
    print(f"[kernels] K1 at the serve shape: ms {k1['ms']:.4f} (SDPA "
          f"{sdpa['ms']:.4f}), queued_ms {k1['queued_ms']:.4f} (SDPA "
          f"{sdpa['queued_ms']:.4f}), host_us {k1['host_us']:.1f} (SDPA "
          f"{sdpa['host_us']:.1f})")
    # the long-context row: 16 rows at the table's full 512 tokens, where
    # every row spans all the key splits (whether the split over CTAs pays)
    long_lens = [r1["width"] * ps] * 16
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=long_lens,
                                  dtype=torch.bfloat16, **r1)
    kc = gather_pages(kp, bt).nan_to_num()
    vc = gather_pages(vp, bt).nan_to_num()
    bytes_, ops = k1_bytes_ops(long_lens)
    k1["long"] = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True)),
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": "B=16 at 512 tokens (the full table), H=40 kv=8 hd=128 "
                 f"ps=16 W=32 bf16, {k1_splits(torch, ps, r1['width'])}",
    }
    print("[kernels] K1 long-context row: " + json.dumps(k1["long"]))
    # K1 at qwen3-moe-235b-a22b's serve shape (phase 10): the same 16
    # decode lengths, 64 query heads over 4 KV heads (a group of 16)
    q3 = fam["qwen3-moe"]
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=lengths,
                                  dtype=torch.bfloat16, **q3)
    kc = gather_pages(kp, bt).nan_to_num()
    vc = gather_pages(vp, bt).nan_to_num()
    bytes_, ops = k1_bytes_ops(lengths, H=q3["q_heads"], kv=q3["kv_heads"],
                               hd=q3["hd"])
    k1["moe_serve"] = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "plain_ms": time_ms(torch, lambda: paged_attention_decode_ref(
            q, kp, vp, bt, ln)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)),
        "bytes": bytes_, "ops": ops,
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": f"B=16 H=64 kv=4 hd=128 ps=16 W=32 bf16, lengths "
                 f"{min(lengths)}..{max(lengths)} (sum {sum(lengths)}), "
                 f"{k1_splits(torch, ps, q3['width'])}",
    }
    print("[kernels] K1 at qwen3-moe's serve shape: "
          + json.dumps(k1["moe_serve"]))
    # K1 at gemma-7b's serve shape (phase 12): the same 16 decode lengths,
    # 16 query heads over 16 KV heads of 256 (the head_dim-256 kernel)
    gm = fam["gemma"]
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=lengths,
                                  dtype=torch.bfloat16, **gm)
    kc = gather_pages(kp, bt).nan_to_num()
    vc = gather_pages(vp, bt).nan_to_num()
    bytes_, ops = k1_bytes_ops(lengths, H=gm["q_heads"], kv=gm["kv_heads"],
                               hd=gm["hd"])
    sdpa = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
    k1_wide = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "plain_ms": time_ms(torch, lambda: paged_attention_decode_ref(
            q, kp, vp, bt, ln)),
        "library_ms": sdpa["ms"], "library": sdpa,
        "bytes": bytes_, "ops": ops,
        "shape": f"B=16 H=16 kv=16 hd=256 ps=16 W=32 bf16, lengths "
                 f"{min(lengths)}..{max(lengths)} (sum {sum(lengths)}), "
                 f"{k1_splits(torch, ps, gm['width'])}",
    }
    print(f"[kernels] K1 hd256 at gemma-7b's serve shape: ms "
          f"{k1_wide['ms']:.4f} (SDPA {sdpa['ms']:.4f}), queued_ms "
          f"{k1_wide['queued_ms']:.4f} (SDPA {sdpa['queued_ms']:.4f}), "
          f"host_us {k1_wide['host_us']:.1f} (SDPA {sdpa['host_us']:.1f}), "
          f"bound {bound(bytes_, ops, 'bf16')[0]:.6f}")
    # 2 rows at 2,048 tokens over 128-page tables: 2 key splits, the
    # case the cluster split is for (few rows, long tables)
    long_lens = [2048] * 2
    q, kp, vp, bt, ln = k1_inputs(torch, gen, dev, lengths=long_lens,
                                  dtype=torch.bfloat16, **r1_2k)
    kc = gather_pages(kp, bt).nan_to_num()
    vc = gather_pages(vp, bt).nan_to_num()
    bytes_, ops = k1_bytes_ops(long_lens)
    k1["long_few_rows"] = {
        **kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, bt,
                                                          ln)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True)),
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": "B=2 at 2,048 tokens (the full table), H=40 kv=8 hd=128 "
                 f"ps=16 W=128 bf16, {k1_splits(torch, ps, 128)}",
    }
    print("[kernels] K1 long-context row, 2 rows: "
          + json.dumps(k1["long_few_rows"]))
    # K2 at the serve shape (one lane of bucket 32 holding a 17-token
    # prompt from position 0) and at phase 6's cold-header chunk (64 rows
    # at pos0 192, all valid), each beside SDPA over the K/V gathered
    # beforehand with the same causal mask
    k2_rows = {}
    for name, shape, t, pos0, valid in (
            ("serve", r1, 32, 0, 17), ("header", r1, 64, 192, 64),
            ("moe_serve", fam["qwen3-moe"], 32, 0, 17),
            ("gemma_serve", fam["gemma"], 32, 0, 17)):
        H, kv, hd = shape["q_heads"], shape["kv_heads"], shape["hd"]
        q, kp, vp, bt, _, _ = k2_inputs(torch, gen, dev, t=t, pos0=pos0,
                                        valid_len=valid,
                                        dtype=torch.bfloat16, **shape)
        kc = gather_pages(kp, bt).nan_to_num()[None]     # [1, kv, S, hd]
        vc = gather_pages(vp, bt).nan_to_num()[None]
        s_max = kc.shape[2]
        mask2 = (torch.arange(s_max, device=dev)[None, :]
                 <= pos0 + torch.arange(t, device=dev)[:, None])[None, None]
        qt = q.transpose(0, 1)[None]                     # [1, H, T, hd]
        sdpa = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask2, enable_gqa=True))
        bytes_, ops = k2_bytes_ops(t, pos0, valid, H=H, kv=kv, hd=hd, ps=ps)
        row = {
            **kernel_ms(torch, lambda: paged_flash_prefill_fwd(
                q, kp, vp, bt, pos0, valid)),
            "plain_ms": time_ms(torch, lambda: paged_flash_prefill_ref(
                q, kp, vp, bt, pos0, valid)),
            "library_ms": sdpa["ms"], "library": sdpa,
            "bytes": bytes_, "ops": ops,
            "bound_ms": bound(bytes_, ops, "bf16")[0],
            "shape": f"T={t} pos0={pos0} valid_len={valid} H={H} "
                     f"kv={kv} hd={hd} ps=16 W=32 bf16",
        }
        print(f"[kernels] K2 at {row['shape']}: ms {row['ms']:.4f} (SDPA "
              f"{sdpa['ms']:.4f}), queued_ms {row['queued_ms']:.4f} (SDPA "
              f"{sdpa['queued_ms']:.4f}), host_us {row['host_us']:.1f} "
              f"(SDPA {sdpa['host_us']:.1f}), bound {row['bound_ms']:.6f}")
        k2_rows[name] = row
    k2 = dict(k2_rows["serve"], header_chunk=k2_rows["header"],
              moe_serve=k2_rows["moe_serve"])
    return errs, {"paged_decode": k1, "paged_prefill": k2,
                  kernel_key("paged_decode", WIDE): k1_wide,
                  kernel_key("paged_prefill", WIDE): k2_rows["gemma_serve"]}


def phase_tree_kernels(torch):
    """Hold both passes of K3 against their plain versions (the branch
    pass's output is K3's output, held against the full plain version
    that defers to K1's); returns per-pass results for the JSON line,
    timed at the tree serve's shape."""
    from repro_torch.kernels.paged_attention.ops import tree_decode_bytes_read
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_decode
    from repro_torch.kernels.paged_attention.ref import (
        gather_pages, paged_tree_attention_ref, tree_branch_merge_ref,
        tree_full_tables, tree_merge_splits_ref, tree_shared_partials_ref)
    from repro_torch.kernels.paged_attention.tree_decode import (
        paged_tree_branch_fwd, paged_tree_shared_fwd,
        paged_tree_shared_split_fwd, unpack_partials)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(2)
    rng = torch.Generator().manual_seed(3)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    r1 = dict(q_heads=40, kv_heads=8, hd=128, ps=16, width=32,
              pool_pages=4097)
    qw = dict(r1, q_heads=14, kv_heads=2, hd=64)
    t32 = dict(r1, q_heads=4, kv_heads=2, hd=32)
    fam = family_shapes(r1)
    errs = {kernel_key(k, hd): [] for k in ("paged_tree_shared",
                                            "paged_tree_branch")
            for hd in (128, WIDE)}

    def serve_topology():
        # 16 rows in 2 groups of 8, a 16-page span, suffixes of 1-6 pages
        lens = (256 + torch.randint(1, 97, (16,), generator=rng)).tolist()
        return [(16, lens[:8]), (16, lens[8:])], []

    cases = [("r1 serve", r1, *serve_topology()),
             ("qwen2 serve", qw, *serve_topology()),
             # a row ending inside its span, a 1-member group, length-0
             # rows in a group and alone, ungrouped singletons
             ("r1 edges", r1, [(4, [4 * 16 + 5, 2 * 16 + 3, 0, 4 * 16]),
                               (2, [2 * 16 + 9])], [37, 0, 1]),
             ("qwen2 edges", qw, [(3, [3 * 16 + 1, 16 + 7]), (1, [20])],
              [0, 300]),
             ("hd32 serve", t32, *serve_topology()),
             ("hd32 edges", t32, [(2, [2 * 16 + 3, 0, 5 * 16]), (1, [16])],
              [9, 0]),
             # a span of 5 pages, not a whole number of 32-key splits
             ("r1 span 80", r1, [(5, [5 * 16 + 3, 3 * 16 + 2, 5 * 16 + 40])],
              [11]),
             # 13 members: more than one CTA's 12 (64 // 5), a second slice
             ("r1 13 members", r1, [(3, [3 * 16 + 1 + i for i in range(13)])],
              [5]),
             # K1's ragged lengths (0 to 512) in one group over a 2-page
             # span: suffixes up to 480 keys, across the branch pass's key
             # splits
             ("r1 ragged", r1, [(2, RAGGED)], []),
             ("qwen2 ragged", qw, [(2, RAGGED)], []),
             ("hd32 ragged", t32, [(2, RAGGED)], []),
             # 128-page tables: suffixes across the branch pass's two key
             # splits (a cluster of 2 CTAs), an ungrouped row at 2,048
             ("r1 2 splits", dict(r1, width=128),
              [(2, [32 + 2016, 32 + 1000, 32 + 1024, 10])], [2048, 0]),
             ("hd32 2 splits", dict(t32, width=128),
              [(2, [32 + 1500, 32 + 992, 3])], [1025]),
             # the GQA groups of qwen3-moe-235b-a22b (16) and qwen2-vl-72b
             # (8) at the serve topology, and ragged in one group
             ("qwen3-moe serve", fam["qwen3-moe"], *serve_topology()),
             ("qwen3-moe edges", fam["qwen3-moe"],
              [(4, [4 * 16 + 5, 2 * 16 + 3, 0, 4 * 16]), (2, [2 * 16 + 9])],
              [37, 0, 1]),
             ("qwen3-moe ragged", fam["qwen3-moe"], [(2, RAGGED)], []),
             ("qwen2-vl serve", fam["qwen2-vl"], *serve_topology()),
             ("qwen2-vl ragged", fam["qwen2-vl"], [(2, RAGGED)], []),
             # gemma-7b's 16/16 heads of 256 (group 1; the head_dim-256
             # instantiations): the serve topology, the edges, K1's
             # ragged lengths in one group, suffixes across two key splits
             ("gemma hd256 serve", fam["gemma"], *serve_topology()),
             ("gemma hd256 edges", fam["gemma"],
              [(4, [4 * 16 + 5, 2 * 16 + 3, 0, 4 * 16]), (2, [2 * 16 + 9])],
              [37, 0, 1]),
             ("gemma hd256 ragged", fam["gemma"], [(2, RAGGED)], []),
             ("gemma hd256 2 splits", dict(fam["gemma"], width=128),
              [(2, [32 + 2016, 32 + 1000, 3])], [1025, 0])]
    for name, shape, groups, singles in cases:
        for dn, dt in dtypes.items():
            args = k3_inputs(torch, gen, dev, groups=groups, singles=singles,
                             dtype=dt, **shape)
            q, kp, vp, rg, sbt, sl, bbt, ln = args
            m_r, l_r, acc_r = tree_shared_partials_ref(q, kp, vp, rg, sbt, sl,
                                                       ln)
            ref = paged_tree_attention_ref(*args)
            grouped = rg < rg.shape[0]
            # the splits come from the table's shape alone: splits past
            # a group's span hold no key
            part, keys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln)
            out = paged_tree_branch_fwd(q, kp, vp, rg, sl, bbt, ln, part,
                                        keys)
            m, l, acc = unpack_partials(part)
            # NaN in unowned pages and stale slots changes no bit
            kc, vc = kp.nan_to_num(), vp.nan_to_num()
            clean = paged_tree_branch_fwd(q, kc, vc, rg, sl, bbt, ln, *(
                paged_tree_shared_fwd(q, kc, vc, rg, sbt, sl, ln)))
            torch.cuda.synchronize()
            check(bool((out[ln == 0] == 0).all()),
                  "K3 length-0 row is not zero")
            check(torch.equal(out, clean), "K3 output moved with the "
                  "NaN in stale or unowned pages")
            # the kernel's split partials of the grouped rows, folded
            m_k, l_k, acc_k = tree_merge_splits_ref(
                m[:, grouped], l[:, grouped], acc[:, grouped])
            tag = f"{name} {dn} B={q.shape[0]} n_split={m.shape[0]} of " \
                f"{keys} keys"
            errs[kernel_key("paged_tree_shared", shape["hd"])].append(
                _compare(torch, f"K3 shared {tag}",
                         torch.cat([m_k[..., None], l_k[..., None], acc_k],
                                   -1),
                         torch.cat([m_r[grouped, :, None],
                                    l_r[grouped, :, None], acc_r[grouped]],
                                   -1), dn))
            errs[kernel_key("paged_tree_branch", shape["hd"])].append(
                _compare(torch, f"K3 branch (output) {tag}", out, ref, dn))

    def serve_rows(shape):
        """Both passes at the tree serve's topology on ``shape`` (bf16),
        as the engine calls them (splits from the table's shape), each
        beside its plain version, the bound from what it needs and SDPA
        over K/V gathered beforehand. Returns (shared row, branch row,
        the inputs and the shared pass's result)."""
        groups, _ = serve_topology()
        args = k3_inputs(torch, gen, dev, groups=groups, singles=[],
                         dtype=torch.bfloat16, **shape)
        q, kp, vp, rg, sbt, sl, bbt, ln = args
        H, kv, hd, ps = (shape[k] for k in ("q_heads", "kv_heads", "hd",
                                            "ps"))
        B, span = q.shape[0], 256
        suffix = [n - span for n in ln.tolist()]
        part, split_keys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln)
        n_split = part.shape[0]
        both = kernel_ms(torch, lambda: paged_tree_branch_fwd(
            q, kp, vp, rg, sl, bbt, ln, *paged_tree_shared_fwd(
                q, kp, vp, rg, sbt, sl, ln)))
        heads = f"H={H} kv={kv} hd={hd} ps=16 W=32 bf16"
        # library yardsticks over K/V gathered beforehand: the members of
        # each group against their shared span; each row against its
        # suffix
        ks = gather_pages(kp, sbt[:2, :span // ps]).nan_to_num()
        vs = gather_pages(vp, sbt[:2, :span // ps]).nan_to_num()
        qs = q.reshape(2, 8, H, hd).transpose(1, 2)          # [2, H, 8, hd]
        kb = gather_pages(kp, bbt).nan_to_num()               # [B, kv, S, hd]
        vb = gather_pages(vp, bbt).nan_to_num()
        mask = (torch.arange(kb.shape[2], device=dev)[None, :]
                < torch.tensor(suffix, device=dev)[:, None])[:, None, None, :]
        common = 4 * B + B * 4 + 2 * 4   # lengths, row_group, shared_lens
        one_set = B * H * (hd + 2) * 4   # one set of fp32 (m, l, acc)
        sdpa = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True))
        shared = {
            **kernel_ms(torch, lambda: paged_tree_shared_fwd(
                q, kp, vp, rg, sbt, sl, ln)),
            "plain_ms": time_ms(torch, lambda: tree_shared_partials_ref(
                q, kp, vp, rg, sbt, sl, ln)),
            "library_ms": sdpa["ms"], "library": sdpa,
            # what the function needs: the two spans' K/V once, q in, one
            # set of fp32 (m, l, acc) out, the span's table entries of each
            # group (the other splits' partials are traffic of this design,
            # in "shape", not in the bound)
            "bytes": tree_decode_bytes_read(2 * span, [], 1, kv, hd,
                                            path="tree", itemsize=2)
            + B * H * hd * 2 + one_set + 2 * (span // ps) * 4 + common,
            "ops": 4 * B * span * H * hd,
            "shape": "B=16 in 2 groups of 8, shared span 256 tokens (16 "
                     f"pages), {heads}, n_split={n_split} of {split_keys} "
                     f"keys (from the table's shape; the splits write "
                     f"{n_split * one_set} bytes of fp32 partials)",
            "both_passes_queued_ms": both["queued_ms"],
        }
        print(f"[kernels] K3 shared pass at the tree serve shape, {heads}: "
              f"ms {shared['ms']:.4f} (SDPA {sdpa['ms']:.4f}), queued_ms "
              f"{shared['queued_ms']:.4f} (SDPA {sdpa['queued_ms']:.4f}), "
              f"host_us {shared['host_us']:.1f} (SDPA "
              f"{sdpa['host_us']:.1f})")

        def branch_bytes_ops(suffix):
            # the suffixes' K/V once, q and one set of shared partials in,
            # the output out, the suffix table entries followed
            followed = sum(-(-n // ps) for n in suffix)
            return (tree_decode_bytes_read(0, suffix, 1, kv, hd, path="tree",
                                           itemsize=2)
                    + B * H * hd * 2 + one_set + B * H * hd * 2
                    + followed * 4 + common, 4 * sum(suffix) * H * hd)

        sdpa_b = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True))
        bytes_, ops = branch_bytes_ops(suffix)
        branch = {
            **kernel_ms(torch, lambda: paged_tree_branch_fwd(
                q, kp, vp, rg, sl, bbt, ln, part, split_keys)),
            "plain_ms": time_ms(torch, lambda: tree_branch_merge_ref(
                q, kp, vp, rg, sl, bbt, ln,
                *tree_merge_splits_ref(*unpack_partials(part)))),
            "library_ms": sdpa_b["ms"], "library": sdpa_b,
            "bytes": bytes_, "ops": ops,
            "shape": f"B=16, suffixes {min(suffix)}..{max(suffix)} tokens "
                     f"(sum {sum(suffix)}), {heads}, merging {n_split} "
                     f"shared splits; {k1_splits(torch, ps, shape['width'])}",
        }
        print(f"[kernels] K3 branch pass at the tree serve shape, {heads}: "
              f"ms {branch['ms']:.4f} (SDPA {sdpa_b['ms']:.4f}), queued_ms "
              f"{branch['queued_ms']:.4f} (SDPA {sdpa_b['queued_ms']:.4f}), "
              f"host_us {branch['host_us']:.1f} (SDPA "
              f"{sdpa_b['host_us']:.1f})")
        return shared, branch, dict(args=args, part=part,
                                    split_keys=split_keys, suffix=suffix,
                                    both=both, bytes_ops=branch_bytes_ops)

    # timing at the tree serve's shape (bf16): r1-distill-14b's heads,
    # then gemma-7b's (the head_dim-256 kernels; phase 12)
    shared, branch, r1_in = serve_rows(r1)
    q, kp, vp, rg, sbt, sl, bbt, ln = r1_in["args"]
    H, kv, hd, ps = r1["q_heads"], r1["kv_heads"], r1["hd"], r1["ps"]
    span, suffix = 256, r1_in["suffix"]
    n_split, split_keys = r1_in["part"].shape[0], r1_in["split_keys"]
    full = tree_full_tables(rg, sbt, sl, bbt, ps)
    k1_ms = kernel_ms(torch, lambda: paged_attention_decode(q, kp, vp, full,
                                                            ln))
    # against the layout the longest span as a host int gave before the
    # step was captured (8 splits of 32 keys over a 256-token span)
    span_keys, span_n = 32, span // 32
    k3_span_ms = kernel_ms(torch, lambda: paged_tree_branch_fwd(
        q, kp, vp, rg, sl, bbt, ln, *paged_tree_shared_split_fwd(
            q, kp, vp, rg, sbt, sl, ln, span_keys, span_n)))
    shared_span_ms = kernel_ms(torch, lambda: paged_tree_shared_split_fwd(
        q, kp, vp, rg, sbt, sl, ln, span_keys, span_n))
    print(f"[kernels] K3 both passes at the tree serve shape, queued_ms: "
          f"{r1_in['both']['queued_ms']:.4f} at the shape-only {n_split} "
          f"splits of {split_keys} keys, {k3_span_ms['queued_ms']:.4f} at "
          f"the host span's {span_n} splits of {span_keys} keys; the "
          f"shared pass alone {shared_span_ms['queued_ms']:.4f} at {span_n}")
    # the reference's byte model at token granularity, per fork group
    kv_bytes = {path: sum(tree_decode_bytes_read(
        span, suffix[g * 8:(g + 1) * 8], 1, kv, hd, path=path, itemsize=2)
        for g in range(2)) for path in ("branch", "tree")}
    print(f"[kernels] tree serve shape (B=16, 2 groups of 8, span 256, "
          f"suffixes {min(suffix)}..{max(suffix)} tokens, bf16): K1 over "
          f"the rebuilt full tables {k1_ms['ms']:.4f} ms (queued "
          f"{k1_ms['queued_ms']:.4f} ms); K3 both passes "
          f"{r1_in['both']['ms']:.4f} ms (queued "
          f"{r1_in['both']['queued_ms']:.4f} ms); "
          f"K/V bytes per-branch {kv_bytes['branch']} "
          f"({kv_bytes['branch'] / HBM_BYTES_PER_S * 1e6:.2f} us), tree "
          f"{kv_bytes['tree']} "
          f"({kv_bytes['tree'] / HBM_BYTES_PER_S * 1e6:.2f} us)")
    shared["host_span_layout"] = {
        "n_split": span_n, "split_keys": span_keys,
        "queued_ms": shared_span_ms["queued_ms"],
        "both_passes_queued_ms": k3_span_ms["queued_ms"]}
    # the long-context row: the same 256-token span, suffixes of 240-256
    # tokens (each row spans two of the branch pass's key splits)
    long_groups = [(16, (span + torch.randint(240, 257, (8,),
                                               generator=rng)).tolist())
                   for _ in range(2)]
    q, kp, vp, rg, sbt, sl, bbt, ln = k3_inputs(
        torch, gen, dev, groups=long_groups, singles=[],
        dtype=torch.bfloat16, **r1)
    suffix = [n - span for n in ln.tolist()]
    part, split_keys = paged_tree_shared_fwd(q, kp, vp, rg, sbt, sl, ln)
    kb = gather_pages(kp, bbt).nan_to_num()
    vb = gather_pages(vp, bbt).nan_to_num()
    mask = (torch.arange(kb.shape[2], device=dev)[None, :]
            < torch.tensor(suffix, device=dev)[:, None])[:, None, None, :]
    bytes_, ops = r1_in["bytes_ops"](suffix)
    branch["long"] = {
        **kernel_ms(torch, lambda: paged_tree_branch_fwd(
            q, kp, vp, rg, sl, bbt, ln, part, split_keys)),
        "library": kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True)),
        "bound_ms": bound(bytes_, ops, "bf16")[0],
        "shape": f"B=16 in 2 groups of 8 over a 256-token span, suffixes "
                 f"{min(suffix)}..{max(suffix)} tokens, H=40 kv=8 hd=128 "
                 f"ps=16 W=32 bf16, {k1_splits(torch, ps, r1['width'])}",
    }
    print("[kernels] K3 branch long-context row: "
          + json.dumps(branch["long"]))
    shared_wide, branch_wide, _ = serve_rows(fam["gemma"])
    return errs, {"paged_tree_shared": shared, "paged_tree_branch": branch,
                  kernel_key("paged_tree_shared", WIDE): shared_wide,
                  kernel_key("paged_tree_branch", WIDE): branch_wide}


def ssd_inputs(torch, gen, dev, *, b, s, h, p, n, dtype, state=False):
    """Seeded SSD scan operands: x, b, c ~ N(0, 1) in ``dtype``, dt in
    [0.01, 0.2) and a in (-2, -0.5] fp32 (the reference kernel tests'
    ranges), and an initial state ~ N(0, 1) or None."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
    init = randn(b, h, p, n) if state else None
    return randn(b, s, h, p), dt, a, randn(b, s, h, n), randn(b, s, h, n), \
        init


def ssd_flops(seqlen: int, heads: int, head_dim: int, state_dim: int,
              chunk: int) -> int:
    """Operations (2 per multiply-add) the chunked scan needs for one row
    of ``seqlen`` positions: per chunk of q rows the causal half of C·Bᵀ
    and of gate·X, then C·S_prev and the state update, q·N·P each."""
    total = 0
    for c0 in range(0, seqlen, chunk):
        q = min(chunk, seqlen - c0)
        tri = q * (q + 1) // 2
        total += tri * (state_dim + head_dim) + 2 * q * state_dim * head_dim
    return 2 * heads * total


SSD_TOL = {"bf16": 2e-2, "fp32": 1e-4}   # atol = rtol (K4, see below)


def phase_ssd_kernels(torch):
    """Hold K4 (the SSD chunked scan, state in and out) against its plain
    version ``ssd_chunked`` on the same inputs, y and final state. The
    plain version runs in fp32 on the (bf16-rounded) inputs, the
    arithmetic K4 does: fp32 to 1e-4 because each output sums up to
    Q·N = 16,384 products in another order; bf16 to 2e-2, the rounding of
    K4's bf16 outputs. The plain version run in bf16 (rounding gate and
    chunk states as the reference does) is printed beside, ungated.
    Returns the results for the JSON line, timed at phase 8's lane
    shape."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan.ssd_scan import (ctas_per_head,
                                                       smem_bytes, ssd_scan)
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(4)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    errs = []

    def compare(name, out, ref, dn, exact=False):
        tol = SSD_TOL[dn]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        ok = bool(torch.isfinite(out.float()).all()) and (
            bool((out == ref).all()) if exact else torch.allclose(
                out.float(), ref.float(), atol=tol, rtol=tol))
        print(f"[kernels] {name}: max_abs_err {err:.3e} "
              f"({'bit-exact' if exact else f'atol=rtol={tol}'}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} disagrees with its plain version")
        errs.append(err)

    def plain32(x, dt, a, b, c, chunk, init, valid=None):
        return ssd_chunked(x.float(), dt, a, b.float(), c.float(), chunk,
                           init.float() if init is not None else None, valid)

    # (name, batch, S, H, P, N, chunk): phase 8's lanes (mamba2-130m, S in
    # a 32- or 64-row bucket under chunk 128), a hymba-1.5b-width lane
    # (50 heads of 64, N=16), the reference kernel tests' shapes
    cases = [("mamba2 1 lane", 1, 64, 24, 64, 128, 128),
             ("mamba2 4 lanes", 4, 64, 24, 64, 128, 128),
             ("mamba2 bucket 32", 1, 32, 24, 64, 128, 128),
             ("hymba widths", 2, 64, 50, 64, 16, 128),
             ("ref 2x32x3 p16 n8 q8", 2, 32, 3, 16, 8, 8),
             ("ref 1x64x2 p32 n16 q16", 1, 64, 2, 32, 16, 16),
             ("ref 2x40x4 p8 n4 q16", 2, 40, 4, 8, 4, 16),
             ("ref 1x16x1 p64 n32 q4", 1, 16, 1, 64, 32, 4),
             ("non-divisible S=13 q8", 1, 13, 2, 8, 4, 8)]
    for name, b, s, h, p, n, q in cases:
        for dn, dt_ in dtypes.items():
            for state in (False, True):
                x, dt, a, bb, cc, init = ssd_inputs(
                    torch, gen, dev, b=b, s=s, h=h, p=p, n=n, dtype=dt_,
                    state=state)
                y, fin = ssd_scan(x, dt, a, bb, cc, chunk=q,
                                  initial_state=init)
                y_r, fin_r = plain32(x, dt, a, bb, cc, q, init)
                torch.cuda.synchronize()
                tag = f"K4 {name} {dn}{' +state' if state else ''}"
                compare(f"{tag} y", y, y_r, dn)
                compare(f"{tag} final state", fin, fin_r, dn)
                if dn == "bf16" and name == "mamba2 1 lane" and state:
                    y_b, fin_b = ssd_chunked(x, dt, a, bb, cc, q, init)
                    e_y = float((y.float() - y_b.float()).abs().max())
                    e_s = float((fin.float() - fin_b.float()).abs().max())
                    print(f"[kernels] {tag}: against the plain version in "
                          f"bf16: max_abs_err y {e_y:.3e}, state {e_s:.3e} "
                          "(not gated)")
    # masked dt: each row's valid prefix gives the unpadded scan's
    # outputs and final state; an all-invalid row returns its state
    # bit-identical (dt = 0 is an exact identity)
    for dn, dt_ in dtypes.items():
        for vl in (1, 7, 11, 16):
            x, dt, a, bb, cc, init = ssd_inputs(
                torch, gen, dev, b=2, s=16, h=2, p=8, n=4, dtype=dt_,
                state=True)
            valid = torch.arange(16, device=dev)[None, :] < vl
            y, fin = ssd_scan(x, dt * valid[..., None], a, bb, cc, chunk=8,
                              initial_state=init)
            y_u, fin_u = plain32(x[:, :vl], dt[:, :vl], a, bb[:, :vl],
                                 cc[:, :vl], 8, init)
            compare(f"K4 valid_len={vl} {dn} y", y[:, :vl], y_u, dn)
            compare(f"K4 valid_len={vl} {dn} final state", fin, fin_u, dn)
        x, dt, a, bb, cc, init = ssd_inputs(
            torch, gen, dev, b=2, s=24, h=24, p=64, n=128, dtype=dt_,
            state=True)
        _, fin = ssd_scan(x, torch.zeros_like(dt), a, bb, cc, chunk=128,
                          initial_state=init)
        compare(f"K4 all-invalid rows {dn} final state", fin, init, dn,
                exact=True)

    # lanes are independent and the kernel deterministic: 4 lanes in one
    # launch give each lane's result alone, bit for bit
    x, dt, a, bb, cc, init = ssd_inputs(
        torch, gen, dev, b=4, s=64, h=24, p=64, n=128, dtype=torch.bfloat16,
        state=True)
    y, fin = ssd_scan(x, dt, a, bb, cc, chunk=128, initial_state=init)
    y1, fin1 = ssd_scan(x[2:3], dt[2:3], a, bb[2:3], cc[2:3], chunk=128,
                        initial_state=init[2:3])
    compare("K4 lane 3 of 4 vs alone bf16 y", y[2:3], y1, "bf16", exact=True)
    compare("K4 lane 3 of 4 vs alone bf16 final state", fin[2:3], fin1,
            "bf16", exact=True)

    # timing at phase 8's lane shape (one lane of a 32-row bucket holding
    # an 11-17-token prompt, dt masked past 17) and at one long row (2,048
    # positions, 16 chunks: an exact-length ssm admission), mamba2-130m's
    # widths, a zero start, bf16
    def timed(s, n_valid):
        b, h, p, n, q = 1, 24, 64, 128, 128
        x, dt, a, bb, cc, _ = ssd_inputs(torch, gen, dev, b=b, s=s, h=h, p=p,
                                         n=n, dtype=torch.bfloat16)
        valid = torch.arange(s, device=dev)[None, :] < n_valid
        dtm = dt * valid[..., None]
        ctas = ctas_per_head(p) * h * b
        row = {
            **kernel_ms(torch, lambda: ssd_scan(x, dtm, a, bb, cc, chunk=q)),
            "plain_ms": time_ms(torch, lambda: ssd_chunked(
                x, dt, a, bb, cc, q, valid=valid), n=10 if s > 256 else 50),
            "library_ms": None,
            # x, b, c, dt, a in; y and the final state out (the zero start
            # is not read)
            "bytes": x.numel() * 2 * 2 + bb.numel() * 2 * 2 + dt.numel() * 4
            + a.numel() * 4 + b * h * p * n * 2,
            # the scan over the valid rows only (masked rows are identity
            # transitions whose products are all zero)
            "ops": b * ssd_flops(n_valid, h, p, n, q),
            "ctas": ctas,
            "shape": f"B=1 S={s} ({n_valid} valid) H={h} P={p} N={n} chunk "
                     f"{q} bf16, {ctas} CTAs ({ctas_per_head(p)} per head), "
                     f"{smem_bytes(q, p, n, s)} B of shared memory each",
        }
        row["bound_ms"] = bound(row["bytes"], row["ops"], "bf16")[0]
        print(f"[kernels] K4 at {row['shape']}: ms {row['ms']:.4f}, "
              f"queued_ms {row['queued_ms']:.4f}, host_us "
              f"{row['host_us']:.1f}, bound {row['bound_ms']:.6f}")
        return row
    timing = timed(32, 17)
    timing["long"] = timed(2048, 2048)
    return {"ssd_scan": errs}, {"ssd_scan": timing}


def flash_flops(seqlen: int, heads: int, head_dim: int, causal: bool,
                true_len=None) -> int:
    """Operations K5 needs: 4 hd per (query row, visible key) pair and
    head (Q·Kᵀ and P·V, 2 per multiply-add), over the rows before
    ``true_len``: S(S+1)/2 pairs causal, S·S not."""
    n = seqlen if true_len is None else true_len
    pairs = n * (n + 1) // 2 if causal else n * n
    return 4 * head_dim * heads * pairs


def phase_flash_kernels(torch):
    """Hold K5 (the dense flash prefill) against its plain version on the
    same inputs, bf16 (the wgmma kernel) and fp32 (the CUDA-core kernel):
    r1-distill-14b's exact-prefill shape at S = 272 and 4096, a qwen2-0.5b
    shape (14/2 heads of 64), head_dim 32, GQA groups 1, 8 and 16 (the
    attention shapes of musicgen-medium, qwen2-vl-72b, qwen3-moe),
    non-divisible S, non-causal, and ``true_len`` (rows past it bit-exact
    zeros; K and V past it NaN, which must not change one bit of the
    output), once at S = 1000 so the key loop wraps the TMA ring. Then
    time it at S = 272 and 4096 beside its plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls).
    Returns (errors, timings, the S = 4096 timing)."""
    from repro_torch.kernels.flash_prefill.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(5)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}

    def inputs(b, s, h, kv, hd, dtype):
        return [torch.randn((b, s, n, hd), generator=gen, device=dev).to(dtype)
                for n in (h, kv, kv)]

    # (name, B, S, H, Hkv, hd, causal, true_len)
    cases = [("r1 S=272", 1, 272, 40, 8, 128, True, None),
             ("r1 S=4096", 1, 4096, 40, 8, 128, True, None),
             ("qwen2 S=272", 1, 272, 14, 2, 64, True, None),
             ("hd32 S=100", 2, 100, 4, 2, 32, True, None),
             ("group1 S=37", 2, 37, 4, 4, 64, True, None),
             ("group8 S=130", 1, 130, 64, 8, 128, True, None),
             ("r1 non-causal S=272", 1, 272, 40, 8, 128, False, None),
             ("hd32 non-causal S=37", 2, 37, 4, 2, 32, False, None),
             ("r1 true_len=200 S=272", 1, 272, 40, 8, 128, True, 200),
             ("non-causal true_len=13 S=48", 2, 48, 6, 3, 64, False, 13),
             # 16 key tiles through the TMA ring, the last one partial
             ("r1 true_len=997 S=1000", 1, 1000, 40, 8, 128, True, 997),
             # the families of phases 10-11: qwen3-moe-235b-a22b (group
             # 16), qwen2-vl-72b (group 8), musicgen-medium (group 1)
             ("qwen3-moe group16 S=272", 1, 272, 64, 4, 128, True, None),
             ("qwen3-moe group16 true_len=13 S=40", 1, 40, 64, 4, 128, True,
              13),
             ("qwen2-vl group8 S=272", 1, 272, 64, 8, 128, True, None),
             ("musicgen group1 S=100", 2, 100, 24, 24, 64, True, None),
             # gemma-7b's 16/16 heads of 256 (phase 12; the head_dim-256
             # instantiations): its exact admission and Model.prefill
             # lengths, non-causal, true_len, 16 key tiles through the ring
             ("gemma hd256 S=272", 1, 272, 16, 16, 256, True, None),
             ("gemma hd256 S=4096", 1, 4096, 16, 16, 256, True, None),
             ("gemma hd256 non-causal S=272", 1, 272, 16, 16, 256, False,
              None),
             ("gemma hd256 true_len=200 S=272", 1, 272, 16, 16, 256, True,
              200),
             ("gemma hd256 true_len=997 S=1000", 1, 1000, 16, 16, 256, True,
              997),
             ("hd256 group4 non-causal true_len=13 S=48", 2, 48, 8, 2, 256,
              False, 13)]
    errs = {kernel_key("flash_prefill", hd): [] for hd in (128, WIDE)}
    for name, b, s, h, kv, hd, causal, tl in cases:
        for dn, dt in dtypes.items():
            q, k, v = inputs(b, s, h, kv, hd, dt)
            out = flash_prefill(q, k, v, causal, tl)
            ref = flash_prefill_ref(q, k, v, causal, tl)
            torch.cuda.synchronize()
            errs[kernel_key("flash_prefill", hd)].append(
                _compare(torch, f"K5 {name} {dn}", out, ref, dn))
            if tl is not None:
                check(bool((out[:, tl:] == 0).all()),
                      "K5 rows past true_len are not exact zeros")
                kp, vp = k.clone(), v.clone()
                kp[:, tl:] = float("nan")
                vp[:, tl:] = float("nan")
                check(torch.equal(flash_prefill(q, kp, vp, causal, tl), out),
                      "K5 read K/V past true_len")
            del q, k, v, out, ref

    timing = {}
    for s, h, kv, hd in ((272, 40, 8, 128), (4096, 40, 8, 128),
                         (272, 16, 16, WIDE), (4096, 16, 16, WIDE)):
        q, k, v = inputs(1, s, h, kv, hd, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, hd]
        timing[s, hd] = {
            **kernel_ms(torch, lambda: flash_prefill(q, k, v)),
            "plain_ms": time_ms(torch, lambda: flash_prefill_ref(q, k, v),
                                n=10 if s > 1024 else 50),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
            # q, k, v in once, o out once
            "bytes": 2 * (2 * h + 2 * kv) * s * hd,
            "ops": flash_flops(s, h, hd, True),
            "shape": f"B=1 S={s} H={h} kv={kv} hd={hd} causal bf16",
        }
        del q, k, v, qt, kt, vt
    wide = dict(timing[272, WIDE], S4096=timing[4096, WIDE])
    print("[kernels] K5 hd256 at gemma-7b's shapes: "
          + json.dumps({"S=272": timing[272, WIDE],
                        "S=4096": timing[4096, WIDE]}))
    return errs, {"flash_prefill": timing[272, 128],
                  kernel_key("flash_prefill", WIDE): wide}, \
        timing[4096, 128]


BWD_TOL = {"bf16": 2e-2, "fp32": 1e-4}   # max error / max |reference|
# K5 backward's check shapes (name, B, S, H, Hkv, hd): r1-distill-14b at
# phase 14's batch and length, qwen2-0.5b (group 7, S a multiple of no
# tile), gemma-7b (head_dim 256), the tiny reasoner (head_dim 32)
BWD_SHAPES = (("r1", 2, 2048, 40, 8, 128),
              ("qwen2 group7", 1, 1000, 14, 2, 64),
              ("gemma hd256", 1, 272, 16, 16, 256),
              ("reasoner hd32", 2, 160, 4, 2, 32))
# phase 14's train_reasoner: the launcher's default LM and PRM steps
REASONER_STEPS = (300, 200)
# phase 14's training length, and the backward's timed shapes (B, S, H,
# Hkv, hd) at it: r1-distill-14b at B=2, gemma-7b at B=1
TRAIN_SEQLEN = 2048
BWD_TIMED = ((2, TRAIN_SEQLEN, 40, 8, 128), (1, TRAIN_SEQLEN, 16, 16, 256))


# the launches of one bf16 call of each backward, by kernel-name fragment
# (phase 3's per-launch split)
K5_BWD_LAUNCHES = {"D pass": "bwd_dot_kernel", "dK/dV": "dkdv_",
                   "dQ": "dq_"}
K4_BWD_LAUNCHES = {"chain": "dstate_chain_kernel",
                   "chunk_grad": "chunk_grad_mma_kernel",
                   "da_reduce": "da_reduce_kernel"}


def flash_bwd_bytes(b: int, s: int, h: int, kv: int, hd: int,
                    itemsize: int) -> int:
    """Bytes K5's backward must move: q, k, v, out and dout read once,
    the fp32 LSE read once, dq, dk and dv written once."""
    return b * s * ((4 * h + 4 * kv) * hd * itemsize + 4 * h)


def phase_flash_bwd_kernels(torch):
    """Phase 3's K5 backward: the forward with and without its LSE output
    bit-equal, the LSE against the plain one, and the backward (the
    autograd path's kernel, from the forward's own output and LSE)
    against ``flash_prefill_bwd_ref`` in bf16 and fp32, at r1-distill-14b
    (40/8 heads of 128, B=2, S=2048), qwen2-0.5b (14/2 of 64, group 7,
    S=1000), gemma-7b (16/16 of 256, S=272) and the tiny reasoner (4/2 of
    32, B=2, S=160), each causal and not, with and without ``true_len``.
    Error: the largest difference over the largest magnitude of the
    reference gradient, within ``BWD_TOL``; the gradients bit-equal over
    two runs. Then timed at phase 14's shapes (r1-distill-14b at B=2,
    S=2048; gemma-7b at B=1, S=2048; bf16, causal) beside the plain
    version, the bound from the operations (2.5x the forward's) and the
    backward of one ``scaled_dot_product_attention`` (a yardstick the
    port never calls). Returns (errors, timings)."""
    from repro_torch.kernels.flash_prefill.flash_prefill import (
        flash_prefill, flash_prefill_lse)
    from repro_torch.kernels.flash_prefill.flash_prefill_bwd import \
        flash_prefill_bwd
    from repro_torch.kernels.flash_prefill.ref import (
        flash_prefill_bwd_ref, flash_prefill_lse_ref)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(7)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}

    def inputs(b, s, h, kv, hd, dtype):
        return [torch.randn((b, s, n, hd), generator=gen,
                            device=dev).to(dtype) for n in (h, kv, kv, h)]

    errs = {kernel_key("flash_prefill_bwd", hd): [] for hd in (128, WIDE)}
    rel = {dn: 0.0 for dn in dtypes}
    for name, b, s, h, kv, hd in BWD_SHAPES:
        for causal, tl in ((True, None), (False, None), (True, s - s // 5),
                           (False, s // 3)):
            for dn, dt in dtypes.items():
                q, k, v, do = inputs(b, s, h, kv, hd, dt)
                out0 = flash_prefill(q, k, v, causal, tl)
                out, lse = flash_prefill_lse(q, k, v, causal, tl)
                check(torch.equal(out, out0), f"K5 {name}: the forward "
                      f"with its LSE differs from the forward without it")
                lse_ref = flash_prefill_lse_ref(q, k, v, causal, tl)
                tol = TOL[dn]
                check(torch.allclose(lse, lse_ref, atol=tol, rtol=tol),
                      f"K5 {name}: LSE disagrees with the plain one "
                      f"({float((lse - lse_ref).abs().max()):.3e})")
                got = flash_prefill_bwd(q, k, v, out, lse, do, causal, tl)
                again = flash_prefill_bwd(q, k, v, out, lse, do, causal, tl)
                want = flash_prefill_bwd_ref(q, k, v, out, lse, do, causal,
                                             tl)
                torch.cuda.synchronize()
                case = (f"K5 bwd {name} B={b} S={s} "
                        f"{'causal' if causal else 'non-causal'}"
                        f"{f' true_len={tl}' if tl else ''} {dn}")
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"{case}: gradients differ between two runs")
                worst = 0.0
                for g, w in zip(got, want):
                    diff = (g.float() - w.float()).abs()
                    scale = max(float(w.float().abs().max()), 1e-30)
                    check(bool(torch.isfinite(g.float()).all()),
                          f"{case}: a non-finite gradient")
                    worst = max(worst, float(diff.max()) / scale)
                    errs[kernel_key("flash_prefill_bwd", hd)].append(
                        float(diff.max()))
                rel[dn] = max(rel[dn], worst)
                ok = worst <= BWD_TOL[dn]
                print(f"[kernels] {case}: max err / max |ref| {worst:.3e} "
                      f"(tolerance {BWD_TOL[dn]}); bit-repeatable; forward "
                      f"with LSE bit-equal; {'ok' if ok else 'FAIL'}")
                check(ok, f"{case} disagrees with its plain version")
                if tl is not None:
                    check(all(bool((g[:, tl:] == 0).all()) for g in got),
                          f"{case}: gradients past true_len are not zeros")
                del q, k, v, do, out0, out, lse, got, again, want
    print("[kernels] K5 bwd largest error relative to the reference's "
          "largest magnitude: " + json.dumps(rel))

    timing = {}
    for b, s, h, kv, hd in BWD_TIMED:
        q, k, v, do = inputs(b, s, h, kv, hd, torch.bfloat16)
        out, lse = flash_prefill_lse(q, k, v)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        do_t = do.transpose(1, 2)
        timing[hd] = {
            **kernel_ms(torch, lambda: flash_prefill_bwd(q, k, v, out, lse,
                                                         do)),
            "plain_ms": time_ms(torch, lambda: flash_prefill_bwd_ref(
                q, k, v, out, lse, do), n=3, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do_t, retain_graph=True)),
            "split_ms": launch_split_ms(torch, lambda: flash_prefill_bwd(
                q, k, v, out, lse, do), K5_BWD_LAUNCHES),
            "bytes": flash_bwd_bytes(b, s, h, kv, hd, 2),
            # five products against the forward's two
            "ops": 2.5 * b * flash_flops(s, h, hd, True),
            "shape": f"B={b} S={s} H={h} kv={kv} hd={hd} causal bf16",
        }
        print(f"[kernels] K5 bwd {timing[hd]['shape']}: "
              + json.dumps(timing[hd]))
        del q, k, v, do, out, lse, qt, kt, vt, o_lib, do_t
    return errs, {"flash_prefill_bwd": timing[128],
                  kernel_key("flash_prefill_bwd", WIDE): timing[WIDE]}


# K4 backward's check shapes (name, B, S, H, P, N, chunk, initial state,
# masked dt): mamba2-130m at phase 14's training shape, hymba-1.5b's
# widths (50 heads, N 16), S a multiple of no chunk, masked dt (each row
# valid up to its own length), an initial state, the smoke widths phase 4
# trains (P 32, N 16, chunk 16), and widths no 16-byte copy takes (P 24,
# N 12: staged element by element)
SSD_BWD_SHAPES = (
    ("mamba2 train", 2, TRAIN_SEQLEN, 24, 64, 128, 128, False, False),
    ("hymba widths", 1, TRAIN_SEQLEN, 50, 64, 16, 128, False, False),
    ("non-divisible S", 2, 1000, 24, 64, 128, 128, False, False),
    ("masked dt", 2, 300, 24, 64, 128, 128, False, True),
    ("initial state", 1, 517, 8, 64, 128, 128, True, False),
    ("smoke widths", 4, 64, 16, 32, 16, 16, True, True),
    ("odd widths", 2, 100, 4, 24, 12, 16, True, True))


def ssd_bwd_flops(seqlen: int, heads: int, head_dim: int, state_dim: int,
                  chunk: int) -> int:
    """Operations (2 per multiply-add) K4's backward needs for one row: per
    chunk of q rows the causal halves of C·Bᵀ, dY·Xᵀ, Gᵀ·dY, W·B and Wᵀ·C,
    and four q·P·N products (the chunk's state gradient, B·dS_endᵀ,
    dY·S_prev and X·dS_end)."""
    total = 0
    for c0 in range(0, seqlen, chunk):
        q = min(chunk, seqlen - c0)
        tri = q * (q + 1) // 2
        total += tri * (3 * state_dim + 2 * head_dim) + \
            4 * q * head_dim * state_dim
    return 2 * heads * total


def ssd_bwd_bytes(b: int, s: int, h: int, p: int, n: int, chunk: int,
                  itemsize: int) -> int:
    """Bytes K4's backward must move: x, dy, b and c read and dx, db and
    dc written in the working dtype, dt read and d dt written in fp32, the
    fp32 states before each chunk read once (a [H] a and da aside)."""
    return b * s * h * ((3 * p + 4 * n) * itemsize + 8) + \
        b * -(-s // chunk) * h * p * n * 4


def phase_ssd_bwd_kernels(torch):
    """Phase 3's K4 backward (``ssd_scan_bwd.cu``): at every shape of
    ``SSD_BWD_SHAPES``, bf16 and fp32, the forward with its chunk-state
    output bit-equal to the forward without, its states against
    ``ssd_chunk_states_ref``, and the backward (with a final-state
    gradient, and an initial state's where there is one) against
    ``ssd_chunked_bwd_ref`` from the kernel's own states. Error: the
    largest difference over the largest magnitude of each reference
    gradient, within ``BWD_TOL`` (bf16: G, W, exp(cs)·dY and the states
    rounded to bf16 as tensor-core operands, outputs rounded to bf16;
    fp32: sums in another order); the gradients bit-equal over two runs;
    the kernel's shared memory equal to the wrapper's
    ``bwd_smem_bytes``. Then timed at phase 14's mamba2-130m shape (B=2,
    S=2048, bf16, no final-state gradient, as in training) beside the
    plain version, autograd of the plain forward (printed) and the bound
    from the bytes it must move. Returns (errors, timing)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_states_ref,
                                                  ssd_chunked,
                                                  ssd_chunked_bwd_ref)
    from repro_torch.kernels.ssd_scan.ssd_scan import (ssd_scan,
                                                       ssd_scan_states)
    from repro_torch.kernels.ssd_scan.ssd_scan_bwd import (bwd_smem_bytes,
                                                           ssd_scan_bwd)
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(9)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    smem = build.load("ssd_scan_bwd").ssd_scan_bwd_smem
    smem.restype, smem.argtypes = ctypes.c_size_t, [ctypes.c_int] * 5
    names = ("dx", "ddt", "da", "db", "dc", "dinit")
    errs, rel = [], {dn: 0.0 for dn in dtypes}
    for name, b, s, h, p, n, q, init, masked in SSD_BWD_SHAPES:
        for dn, dtype in dtypes.items():
            x, dt, a, bb, cc, st = ssd_inputs(torch, gen, dev, b=b, s=s, h=h,
                                              p=p, n=n, dtype=dtype,
                                              state=init)
            if masked:
                lens = torch.randint(1, s + 1, (b,), generator=gen,
                                     device=dev)
                dt = dt * (torch.arange(s, device=dev)[None, :]
                           < lens[:, None])[..., None]
            dy = torch.randn((b, s, h, p), generator=gen,
                             device=dev).to(dtype)
            dfin = torch.randn((b, h, p, n), generator=gen, device=dev)
            case = (f"K4 bwd {name} B={b} S={s} H={h} P={p} N={n} chunk "
                    f"{q} {dn}")
            check(smem(s, p, n, q, build.dtype_code(x))
                  == bwd_smem_bytes(q, p, n, s, dtype),
                  f"{case}: the kernel's shared memory differs from "
                  f"bwd_smem_bytes")
            y0, fin0 = ssd_scan(x, dt, a, bb, cc, chunk=q, initial_state=st)
            y, fin, states = ssd_scan_states(x, dt, a, bb, cc, chunk=q,
                                             initial_state=st)
            check(torch.equal(y, y0) and torch.equal(fin, fin0),
                  f"{case}: the forward with chunk states differs from the "
                  f"forward without")
            s_ref = ssd_chunk_states_ref(x, dt, a, bb, cc, q, st)
            s_err = float((states - s_ref).abs().max()) / max(
                float(s_ref.abs().max()), 1e-30)
            got = ssd_scan_bwd(x, dt, a, bb, cc, states, dy, dfin, chunk=q,
                               init_grad=init)
            again = ssd_scan_bwd(x, dt, a, bb, cc, states, dy, dfin,
                                 chunk=q, init_grad=init)
            want = ssd_chunked_bwd_ref(x, dt, a, bb, cc, states, dy, dfin,
                                       chunk=q)
            torch.cuda.synchronize()
            check(all(torch.equal(g, g2) for g, g2 in zip(got, again)
                      if g is not None),
                  f"{case}: gradients differ between two runs")
            worst = {}
            for nm, g, w in zip(names, got, want):
                if g is None:
                    continue
                check(bool(torch.isfinite(g.float()).all()),
                      f"{case}: a non-finite {nm}")
                diff = float((g.float() - w.float()).abs().max())
                worst[nm] = diff / max(float(w.float().abs().max()), 1e-30)
                errs.append(diff)
            top = max(worst.values())
            rel[dn] = max(rel[dn], top, s_err)
            ok = top <= BWD_TOL[dn] and s_err <= BWD_TOL[dn]
            print(f"[kernels] {case}: max err / max |ref| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                  + f"; chunk states {s_err:.2e} (tolerance "
                  f"{BWD_TOL[dn]}); bit-repeatable; forward with states "
                  f"bit-equal; {'ok' if ok else 'FAIL'}")
            check(ok, f"{case} disagrees with its plain version")
            del x, dt, bb, cc, st, dy, y0, y, states, s_ref, got, again, want
    print("[kernels] K4 bwd largest error relative to the reference's "
          "largest magnitude: " + json.dumps(rel))

    b, s, h, p, n, q = 2, TRAIN_SEQLEN, 24, 64, 128, 128
    x, dt, a, bb, cc, _ = ssd_inputs(torch, gen, dev, b=b, s=s, h=h, p=p,
                                     n=n, dtype=torch.bfloat16)
    dy = torch.randn((b, s, h, p), generator=gen,
                     device=dev).to(torch.bfloat16)
    _, _, states = ssd_scan_states(x, dt, a, bb, cc, chunk=q)
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, bb, cc)]
    y_plain = ssd_chunked(*leaves, q)[0]
    timing = {
        **kernel_ms(torch, lambda: ssd_scan_bwd(x, dt, a, bb, cc, states,
                                                dy, chunk=q)),
        "plain_ms": time_ms(torch, lambda: ssd_chunked_bwd_ref(
            x, dt, a, bb, cc, states, dy, chunk=q), n=3, warmup=1),
        "plain_autograd_ms": time_ms(torch, lambda: torch.autograd.grad(
            y_plain, leaves, dy, retain_graph=True), n=3, warmup=1),
        "forward_with_states_ms": time_ms(torch, lambda: ssd_scan_states(
            x, dt, a, bb, cc, chunk=q), head_start=True),
        "library_ms": None,
        "split_ms": launch_split_ms(torch, lambda: ssd_scan_bwd(
            x, dt, a, bb, cc, states, dy, chunk=q), K4_BWD_LAUNCHES),
        "bytes": ssd_bwd_bytes(b, s, h, p, n, q, 2),
        "ops": b * ssd_bwd_flops(s, h, p, n, q),
        "ctas": -(-s // q) * h * b,
        "shape": f"B={b} S={s} H={h} P={p} N={n} chunk {q} bf16, "
                 f"{-(-s // q) * h * b} CTAs, "
                 f"{bwd_smem_bytes(q, p, n, s)} B of shared memory each",
    }
    timing["bound_ms"] = bound(timing["bytes"], timing["ops"], "bf16")[0]
    print("[kernels] K4 bwd timed: " + json.dumps(timing))
    del x, dt, bb, cc, dy, states, leaves, y_plain
    return {"ssd_scan_bwd": errs}, {"ssd_scan_bwd": timing}


ADAMW_OPS = 17          # fp32 operations an element of the fused update


def _ulps(torch, a, b) -> int:
    """The largest distance between ``a`` and ``b`` in units of the last
    place (their bit patterns as integers; same-signed values)."""
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(as_int).long() - b.view(as_int).long()).abs().max())


def _adamw_compare(torch, tag: str, params, state, gen,
                   steps: int = 3) -> tuple:
    """``steps`` AdamW updates of ``params`` (a tree) by the fused kernel
    and by the plain loop body (``ref.adamw_leaf_ref``) from the same
    copies, scalars and gradients, the clip on (gradients of norm >> 1,
    grad_clip 1) and off (grad_clip 1e9) in turn: p, mu and nu compared
    bit for bit after every update. Returns (largest absolute
    difference, largest difference in ulps): (0.0, 0) when bit-equal."""
    from repro_torch.kernels.adamw import adamw
    from repro_torch.kernels.adamw.ref import adamw_leaf_ref
    from repro_torch.training import AdamWConfig
    from repro_torch.training.optimizer import tree_leaves, update_scalars
    fused = [list(tree_leaves(t)) for t in (params, state["mu"],
                                            state["nu"])]
    plain = [[t.clone() for t in leaves] for leaves in fused]
    worst_abs, worst_ulp = 0.0, 0
    for i in range(steps):
        clipped = i % 2 == 0
        cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=1.0 if clipped else 1e9)
        grads = [(torch.randn(p.shape, generator=gen, device=p.device)
                  * (5.0 if clipped else 1e-3)).to(p.dtype)
                 for p in fused[0]]
        gnorm, scalars = update_scalars(cfg, dict(enumerate(grads)),
                                        state)
        hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
        for j, g in enumerate(grads):
            adamw.adamw_step(fused[0][j], g, fused[1][j], fused[2][j],
                             *scalars, **hyper)
            adamw_leaf_ref(plain[0][j], g, plain[1][j], plain[2][j],
                           *scalars, **hyper)
        torch.cuda.synchronize()
        for a, b in zip(itertools.chain(*fused), itertools.chain(*plain)):
            if not torch.equal(a, b):
                worst_abs = max(worst_abs, float((a.float() - b.float())
                                                 .abs().max()))
                worst_ulp = max(worst_ulp, _ulps(torch, a, b))
        print(f"[kernels] AdamW {tag}, update {i + 1} "
              f"({'clipped' if clipped else 'unclipped'}, grad norm "
              f"{float(gnorm):.4e}): fused against plain over "
              f"{len(fused[0])} leaves, largest difference {worst_abs:.3e} "
              f"({worst_ulp} ulp)")
    del plain
    return worst_abs, worst_ulp


def phase_adamw_kernel(torch):
    """Phase 3's AdamW row: the fused update (``csrc/adamw.cu``, one launch
    a leaf) against the plain loop body on the card, three updates each
    (clipped, unclipped, clipped), on mamba2-130m's full tree (24 layers;
    bf16 matrices, fp32 norms, a_log and dt_bias; ndim 1 and >= 2) and on
    one r1-distill-14b layer's leaves: p, mu and nu must be bit-equal.
    Then timed over the 14B layer's leaves (one call updates every leaf)
    beside the plain loop body, the bound from the bytes it must move (22
    a bf16 element, 28 an fp32 one) and one ``torch.optim.AdamW(fused=
    True)`` step over the same bf16 leaves (its moments bf16: a yardstick
    the port never calls). Returns (errors, timing)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import adamw
    from repro_torch.kernels.adamw.ref import adamw_leaf_ref
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, init_opt_state
    from repro_torch.training.optimizer import tree_leaves, update_scalars
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(11)
    errs, ulps, trees = [], [], {}
    for tag, cfg in (("mamba2-130m full tree",
                      get_config("mamba2-130m")),
                     ("r1-distill-14b one layer",
                      get_config("r1-distill-14b").replace(num_layers=1))):
        params = Model(cfg, dtype=torch.bfloat16, device=dev).init_params(
            gen)
        if cfg.num_layers == 1:       # the layer's leaves alone
            params = {"layers": params["layers"]}
        state = init_opt_state(params)
        err, ulp = _adamw_compare(torch, tag, params, state, gen)
        errs.append(err)
        ulps.append(ulp)
        trees[tag] = (params, state)
    check(max(ulps) == 0, f"the fused AdamW differs from the plain update "
                          f"by up to {max(ulps)} ulp")
    del trees["mamba2-130m full tree"]
    params, state = trees.pop("r1-distill-14b one layer")
    leaves = list(tree_leaves(params))
    mu, nu = list(tree_leaves(state["mu"])), list(tree_leaves(state["nu"]))
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in leaves]
    cfg = AdamWConfig(lr=1e-5, warmup_steps=1, total_steps=10)
    _, scalars = update_scalars(cfg, dict(enumerate(grads)), state)
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)

    def fused():
        for p, g, m, v in zip(leaves, grads, mu, nu):
            adamw.adamw_step(p, g, m, v, *scalars, **hyper)

    def plain():
        for p, g, m, v in zip(leaves, grads, mu, nu):
            adamw_leaf_ref(p, g, m, v, *scalars, **hyper)
    lib_params = [p.clone().requires_grad_() for p in leaves]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=1e-5, betas=(cfg.beta1,
                                                        cfg.beta2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay,
                            fused=True)
    n = sum(p.numel() for p in leaves)
    timing = {
        "ms": time_ms(torch, fused),
        "queued_ms": time_ms(torch, fused, head_start=True),
        # per wrapper call, over 20 calls of the layer (240 launches):
        # more would fill the card's launch queue and time the card
        "host_us": host_us(torch, fused, n=20) / len(leaves),
        "plain_ms": time_ms(torch, plain, n=10, warmup=2),
        "library_ms": time_ms(torch, lib.step, n=10, warmup=2),
        "bytes": sum(adamw.adamw_bytes(p, g)
                     for p, g in zip(leaves, grads)),
        "ops": ADAMW_OPS * n, "ops_dtype": "fp32",
        "shape": f"r1-distill-14b one layer: {len(leaves)} leaves, "
                 f"{n / 1e6:.1f} M params (bf16 matrices and biases, fp32 "
                 f"norms), one launch a leaf; ms for all the leaves, "
                 f"host_us per launch",
    }
    timing["bound_ms"] = bound(timing["bytes"], timing["ops"], "fp32")[0]
    print("[kernels] AdamW timed: " + json.dumps(timing))
    del lib, lib_params, grads, params, state, leaves, mu, nu
    return {"adamw": errs}, {"adamw": timing}


SAMPLER_VOCAB = 152064    # r1-distill-14b's vocabulary
SAMPLER_ROWS = 320        # a serve step's rows: 256 slots and a 64-row chunk


def _plain_sample(torch, gen, logits, temperature: float, top_p: float):
    """``serving.sampling.sample``'s path before the kernel, on the card:
    the sort, cumsum and softmaxes of ``apply_top_p``, an exponential draw
    of [rows, V] and an argmax."""
    from repro_torch.serving.sampling import apply_top_p
    probs = torch.softmax(apply_top_p(logits.float() / temperature, top_p),
                          dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=gen)
    return torch.argmax(probs / noise, dim=-1).to(torch.int32)


def phase_sampler_kernel(torch) -> dict:
    """Phase 3's sampler row: the top-p kernel (``csrc/sample_top_p.cu``)
    at a serve step's 320 x 152,064 bf16 logits and at one row (a spawn's
    sample), temperature 0.9 and top-p 0.95 as the benchmark's cells, on
    logits at two spreads (x 1.5, most tokens kept; x 6, a few hundred):
    tokens and thresholds bit-equal to the plain version (run on the card)
    on the same keys, then timed (``ms``, ``queued_ms``, ``host_us`` as
    every kernel) beside the bound (one read of the logits at 3.35 TB/s)
    and ``plain_ms``: the sampling the engine ran before the kernel
    (``_plain_sample``). Returns the timing by shape."""
    from repro_torch.kernels.sampling import sample_top_p as sampler
    from repro_torch.kernels.sampling.ref import sample_top_p_ref
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(13)
    out = {}
    for rows, scale in ((SAMPLER_ROWS, 1.5), (SAMPLER_ROWS, 6.0),
                        (1, 1.5)):
        x = (torch.randn(rows, SAMPLER_VOCAB, generator=gen, device=dev)
             * scale).to(torch.bfloat16)
        keys = torch.randint(-2 ** 62, 2 ** 62, (rows,), generator=gen,
                             device=dev)
        tok, thr = sampler.sample_top_p(x, 0.9, 0.95, keys)
        want_tok, want_thr = sample_top_p_ref(x, 0.9, 0.95, keys)
        torch.cuda.synchronize()
        check(torch.equal(thr, want_thr) and torch.equal(tok, want_tok),
              f"the top-p kernel differs from its plain version at {rows} "
              f"x {SAMPLER_VOCAB}, scale {scale}: "
              f"{int((tok != want_tok).sum())} tokens, "
              f"{int((thr != want_thr).sum())} thresholds")

        def kernel():
            sampler.sample_top_p(x, 0.9, 0.95, keys)

        def plain():
            _plain_sample(torch, gen, x, 0.9, 0.95)
        timing = kernel_ms(torch, kernel)
        timing["plain_ms"] = time_ms(torch, plain, n=10, warmup=2)
        timing["bytes"] = x.numel() * x.element_size() + rows * 16
        timing["bound_ms"] = timing["bytes"] / HBM_BYTES_PER_S * 1e3
        timing["shape"] = (f"{rows} x {SAMPLER_VOCAB} bf16, logits N(0, "
                           f"{scale}^2), T 0.9, p 0.95")
        out[f"rows{rows}_x{scale:g}"] = timing
    print("[kernels] sampler timed: " + json.dumps(out))
    return out

def _parity_scenario(torch, eng, vocab: int):
    """A cold request (a 16-token header + its own 21 tokens, a partial
    last page) forks 3 branches that decode 6 steps (CoW of the shared
    page); a mid-generation fork joins them and the second branch is
    suspended for 2 steps, then resumed; then a warm request sharing the
    header rides the decode steps as a chunk lane and forks 2 more
    branches; 6 more steps. SSM states travel with every prefill. Returns
    (tokens of every branch, both prefill logits, live rows' hidden, the
    warm request's cached tokens, the branches' final (conv, ssd) rows or
    [])."""
    header = [int(x) for x in (np.arange(16) * 7 + 3) % vocab]
    cold = header + [int(x) for x in (np.arange(21) * 5 + 1) % vocab]
    warm = header + [int(x) for x in (np.arange(9) * 11 + 2) % vocab]
    blocks, lg_cold, ssm_cold = eng.prefill(cold)
    hs = [eng.spawn_branch(0, blocks, lg_cold, ssm_cold, len(cold),
                           prompt_tokens=cold) for _ in range(3)]
    for _ in range(6):
        eng.decode_step()
    hs.append(eng.fork_branch(hs[0]))
    eng.suspend_branch(hs[1])
    for _ in range(2):
        eng.decode_step()
    check(eng.resume_branch(hs[1]), "a suspended branch found no slot")
    st = eng.begin_prefill(warm)
    while not st.done:
        eng.decode_step()
    b2, lg_warm, ssm_warm = eng.finish_prefill(st)
    hs += [eng.spawn_branch(1, b2, lg_warm, ssm_warm, len(warm),
                            prompt_tokens=warm) for _ in range(2)]
    for _ in range(6):
        eng.decode_step()
    slots = [h.slot for h in hs]
    states = ([eng.state[k][:, slots].float().cpu() for k in ("conv", "ssd")]
              if eng.model.cfg.uses_ssm else [])
    out = ([h.tokens for h in hs],
           torch.stack([lg_cold.float().cpu(), lg_warm.float().cpu()]),
           eng._last_hidden[slots].float().cpu(), st.cached_tokens, states)
    for h in hs:
        eng.free_branch(h)
    eng.release_prefix(blocks)
    eng.release_prefix(b2)
    check(eng.allocator.used_pages == 0, "parity engine leaked pages")
    eng.allocator.check_invariants()
    return out


def _tiny_family(arch: str):
    """The tests' ssm/hybrid widths (``tests/conftest.py`` FAMILY_CONFIGS):
    2 layers, d_model 64, 4 SSD heads of 32, state 16, chunk 8; the
    hybrid's 4/2 attention heads are 64 wide (the tests' 16 is below the
    32, 64, 128 or 256 that K1-K3 take)."""
    from repro_torch.models import ModelConfig
    attn = dict(d_ff=0) if arch == "ssm" else dict(d_ff=128, head_dim=64)
    return ModelConfig(name=f"tiny-{arch}", arch_type=arch, num_layers=2,
                       d_model=64, vocab_size=97, num_heads=4,
                       num_kv_heads=2, ssm_state=16, ssm_head_dim=32,
                       ssm_chunk=8, **attn)


def _topk_margins(torch):
    """A context that wraps ``moe.router_probs`` to keep the smallest gap
    between the k-th and the (k+1)-th router probability of any row it
    routes (the nearest tie a routing could flip on); yields a dict whose
    ``"min"`` holds it. For eager runs: it reads the gap on the host."""
    from repro_torch.models import moe
    seen = {"min": math.inf}
    orig = moe.router_probs

    def recording(cfg, p, x_flat):
        probs = torch.softmax((x_flat @ p["router"]).float(), dim=-1)
        top = probs.topk(cfg.num_experts_per_tok + 1, dim=-1).values
        k = cfg.num_experts_per_tok
        seen["min"] = min(seen["min"],
                          float((top[:, k - 1] - top[:, k]).min()))
        return orig(cfg, p, x_flat)

    @contextlib.contextmanager
    def ctx():
        moe.router_probs = recording
        try:
            yield seen
        finally:
            moe.router_probs = orig
    return ctx()


def phase_parity(torch):
    """The engine with the kernels on the card against the engine with the
    plain versions on the CPU: same fp32 weights, greedy decoding. Dense
    (r1-distill-14b's smoke widths): per-branch decode (K1) with the cache
    off, then the prefix cache and tree decode (K3) on. ssm and hybrid
    (the tests' widths): the chunk lanes' scan is K4; the hybrid runs again
    with the cache (the warm request seeded from a page-aligned boundary
    snapshot) and the tree on, K1-K4 in one engine. The smoke widths of
    qwen3-moe-235b-a22b (MoE, 4 experts top-2; per-branch, cache and
    tree, exact), qwen2-vl-72b (M-RoPE) and musicgen-medium (sinusoidal
    positions); for MoE the smallest top-k router margin of the CPU run
    is printed (a card/CPU flip of experts below ~1e-5 would be a near
    tie, not a port fault). gemma-7b's smoke widths at its own head_dim
    of 256 (4/4 heads; the head_dim-256 kernels): per-branch, cache and
    tree, exact."""
    from repro_torch.configs import smoke
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import tree_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import Model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cache_tree = {"prefix_cache": True, "decode_kernel": "tree"}
    exact = {"chunked_prefill": False}
    for cfg, extras in ((smoke("r1-distill-14b"), ({}, cache_tree, exact)),
                        (_tiny_family("ssm"), ({}, exact)),
                        (_tiny_family("hybrid"), ({}, cache_tree, exact)),
                        (smoke("qwen3-moe-235b-a22b"),
                         ({}, cache_tree, exact)),
                        (smoke("qwen2-vl-72b"), ({},)),
                        (smoke("musicgen-medium"), ({},)),
                        (smoke("gemma-7b").replace(head_dim=WIDE),
                         ({}, cache_tree, exact))):
        cpu_model = Model(cfg, device="cpu")
        params = cpu_model.init_params(torch.Generator().manual_seed(0))
        gpu_model = Model(cfg, device=DEVICE)
        gpu_params = {k: _to(v, DEVICE) for k, v in params.items()}
        gpu_model.load_params(gpu_params)
        for extra in extras:
            ecfg = EngineConfig(page_size=4, num_pages=64, max_slots=6,
                                max_pages_per_branch=24, prefill_chunk=16,
                                sampling=SamplingParams(temperature=0.0),
                                **extra)
            runs = []
            for model, p in ((cpu_model, params), (gpu_model, gpu_params)):
                eng = Engine(model, p, ecfg)
                tree_decode.branch_launches = 0
                ssd_scan.launches = 0
                flash_prefill.launches = 0
                with (_topk_margins(torch) if model is cpu_model
                      and cfg.uses_moe else contextlib.nullcontext()) as tie:
                    runs.append(_parity_scenario(torch, eng, cfg.vocab_size))
                if tie is not None:
                    margin = tie["min"]
                stats = eng.prefix_cache_stats()
            graphs = _graph_stats(eng)      # the card's engine
            (t_cpu, l_cpu, h_cpu, c_cpu, s_cpu), \
                (t_gpu, l_gpu, h_gpu, c_gpu, s_gpu) = runs
            err = max([float((l_cpu - l_gpu).abs().max()),
                       float((h_cpu - h_gpu).abs().max())]
                      + [float((a - b).abs().max())
                         for a, b in zip(s_cpu, s_gpu)])
            ok = t_cpu == t_gpu and err <= 1e-4 and c_cpu == c_gpu
            name = (cfg.arch_type if cfg.resolved_head_dim != WIDE else
                    f"{cfg.name} head_dim {WIDE}") + ": " + (", ".join(
                f"{k}={v}" for k, v in extra.items()) or "defaults")
            print(f"[parity] {name}: greedy tokens equal: {t_cpu == t_gpu}; "
                  f"max abs err of prefill logits / hidden"
                  f"{' / (conv, ssd) state' if s_cpu else ''} {err:.3e} "
                  f"(atol 1e-4); warm request cached tokens {c_gpu}; K4 "
                  f"launches {ssd_scan.launches}; K5 launches "
                  f"{flash_prefill.launches}; step graphs captured "
                  f"{graphs['captured']} of {graphs['declared']}, replays "
                  f"{graphs['replays']}"
                  + (f"; smallest top-k router margin (CPU run) {margin:.3e}"
                     if cfg.uses_moe else "")
                  + f"; {'ok' if ok else 'FAIL'}")
            check(0 < graphs["captured"] <= graphs["declared"]
                  and graphs["replays"] >= graphs["decode_steps"],
                  f"the card's parity engine did not step through its "
                  f"graphs: {graphs}")
            check(ok, f"engine on the card disagrees with the CPU engine "
                      f"({name})")
            if cfg.uses_ssm:
                check(ssd_scan.launches > 0,
                      f"the {name} parity run never launched K4")
            if extra is cache_tree:
                check(c_gpu > 0 and stats["hit_tokens"] > 0,
                      "the warm request missed the prefix cache")
                check(tree_decode.branch_launches > 0,
                      "the tree parity run never launched K3")
            if extra is exact:
                # two exact admissions, one K5 launch per attention layer
                check(flash_prefill.launches == 2 * cfg.num_layers
                      if cfg.uses_attention else flash_prefill.launches == 0,
                      f"the exact parity run launched K5 "
                      f"{flash_prefill.launches} times")
    _model_parity(torch)
    _fallback_trunks(torch)
    _fault_parity(torch)
    _train_parity(torch)


def _train_counters() -> dict:
    """The launch counters of the kernels a train step runs: K5 and K4,
    forward and backward, and the fused AdamW update."""
    from repro_torch.kernels.adamw import adamw
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    return {"flash_prefill": flash_prefill,
            "flash_prefill_bwd": flash_prefill_bwd, "ssd_scan": ssd_scan,
            "ssd_scan_bwd": ssd_scan_bwd, "adamw": adamw}


def _n_leaves(params) -> int:
    from repro_torch.training.optimizer import tree_leaves
    return len(list(tree_leaves(params)))


def _want_launches(cfg, steps: int, leaves: int) -> dict:
    """What ``steps`` train steps of ``cfg`` launch: each layer's forward
    runs twice (recomputed in the backward pass) and its backward once;
    K5 where the attention takes it (no window, no soft-cap:
    ``attention._flash_ok``), K4 in every SSM mixer; the fused AdamW once
    per leaf of the params tree (``leaves``). Through a ``TrainGraph``
    the wrappers run at the eager warm-up and at the capture only, so
    their counters hold ``_want_launches(cfg, 2, leaves)`` however many
    steps replay; ``TrainGraph.launches_run()`` holds what ran."""
    from repro_torch.models.attention import _flash_ok
    per = cfg.num_layers * steps
    k5 = int(cfg.uses_attention and _flash_ok(cfg))
    k4 = int(cfg.uses_ssm)
    out = {"flash_prefill": 2 * per * k5, "flash_prefill_bwd": per * k5,
           "ssd_scan": 2 * per * k4, "ssd_scan_bwd": per * k4,
           "adamw": leaves * steps}
    return {k: n for k, n in out.items() if n}


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def _check_train_graph(step, steps: int, what: str) -> None:
    """``steps`` calls of one batch signature went through the graph:
    step 1 the eager warm-up, step 2 the capture and its replay, every
    later one a replay."""
    sig, = step.signatures.values()
    check(sig.eager_runs == 1 and sig.captures == 1
          and sig.replays == steps - 1,
          f"{what}: eager runs {sig.eager_runs}, captures {sig.captures}, "
          f"replays {sig.replays}; want 1, 1 and {steps - 1}")


def _train_parity(torch):
    """Phase 4's training case: 3 steps of ``make_train_step`` on the card
    (K5's and K4's forward and backward kernels, fp32) against the CPU
    (the plain versions under autograd) from the same fp32 weights on the
    same batches: the launcher's tiny reasoner (2 layers, 4/2 heads of
    32), qwen3-moe-235b-a22b's smoke widths (MoE aux loss in the
    objective), mamba2-130m's (ssm: K4 alone) and hymba-1.5b's (hybrid:
    K4 beside the window attention's plain formulation). Loss, aux loss
    and grad norm per step within rtol 1e-4 and every param after the
    last step within atol 1e-3 (= the learning rate: Adam moves an entry
    whose gradient is near zero by up to lr on a small relative
    difference of that gradient). On the card the step is a
    ``TrainGraph``: step 1 warms up eagerly, step 2 captures and replays,
    step 3 replays; the launches it ran (``launches_run``) are
    ``_want_launches(cfg, 3)``, the wrappers' counters (warm-up and
    capture) ``_want_launches(cfg, 2)``."""
    from repro_torch.configs import smoke
    from repro_torch.data import DataConfig, padded_batches
    from repro_torch.data import tokenizer as tk
    from repro_torch.models import Model, ModelConfig
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.train_loop import to_batch
    steps = 3
    reasoner = ModelConfig(name="tiny-reasoner", arch_type="dense",
                           num_layers=2, d_model=128,
                           vocab_size=tk.VOCAB_SIZE, num_heads=4,
                           num_kv_heads=2, d_ff=512, max_seq_len=512)
    counters = _train_counters()
    for cfg in (reasoner, smoke("qwen3-moe-235b-a22b"), smoke("mamba2-130m"),
                smoke("hymba-1.5b")):
        cpu_model = Model(cfg, device="cpu")
        params = cpu_model.init_params(torch.Generator().manual_seed(0))
        gpu_model = Model(cfg, device=DEVICE)
        gpu_params = _to(params, DEVICE)
        gpu_model.load_params(gpu_params)
        runs = []
        for model, p in ((cpu_model, params), (gpu_model, gpu_params)):
            for mod in counters.values():
                mod.launches = 0
            step = make_train_step(model, AdamWConfig(
                lr=1e-3, warmup_steps=1, total_steps=10))
            opt = init_opt_state(p)
            data = padded_batches(DataConfig(batch_size=4, seq_len=64,
                                             seed=0))
            metrics = []
            for _ in range(steps):
                toks, labels, mask = next(data)
                p, opt, m = step(p, opt, to_batch(
                    {"tokens": toks, "labels": labels, "mask": mask},
                    model.device))
                metrics.append({k: float(v) for k, v in m.items()})
            with torch.no_grad():
                host = _to(p, "cpu")
            runs.append((metrics, host, step, _nonzero(
                {k: mod.launches for k, mod in counters.items()})))
        (m_cpu, p_cpu, _, _), (m_gpu, p_gpu, step, called) = runs
        _check_train_graph(step, steps, f"train parity {cfg.name}")
        launched = step.launches_run()
        rel = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                  for a, b in zip(m_cpu, m_gpu) for k in a)

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", v
        gpu_leaves = dict(leaves(p_gpu))
        with torch.no_grad():
            diffs = {k: float((v - gpu_leaves[k]).abs().max())
                     for k, v in leaves(p_cpu)}
        worst = max(diffs, key=diffs.get)
        n_leaves = _n_leaves(p_cpu)
        want = _want_launches(cfg, steps, n_leaves)
        ok = rel <= 1e-4 and diffs[worst] <= 1e-3 and launched == want \
            and called == _want_launches(cfg, 2, n_leaves)
        print(f"[parity] train {cfg.name} ({cfg.arch_type}, head_dim "
              f"{cfg.resolved_head_dim}), {steps} steps card vs CPU: losses "
              f"{[round(m['loss'], 6) for m in m_gpu]}, grad norms "
              f"{[round(m['grad_norm'], 6) for m in m_gpu]}; largest "
              f"relative difference of loss / aux / grad norm {rel:.3e} "
              f"(rtol 1e-4); largest param difference {diffs[worst]:.3e} "
              f"({worst}; atol 1e-3), mean over leaves "
              f"{sum(diffs.values()) / len(diffs):.3e}; launches run "
              f"{json.dumps(launched)} (want {json.dumps(want)}; the "
              f"wrappers' calls at warm-up and capture "
              f"{json.dumps(called)}); "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"training on the card disagrees with the CPU "
                  f"({cfg.name})")


FAULT_PARITY_PLAN = "seed=0,step_rate=0.05,oop_rate=0.2,crash_at=12"


def _fault_parity(torch):
    """Phase 4's fault case: r1-distill-14b's smoke widths in fp32 with
    the prefix cache, greedy, a noise-free oracle, 3 problems under SART
    (n=2, m=1, window 8, 24 tokens) behind ``FAULT_PARITY_PLAN`` (an oop
    storm, step faults and a crash at step 12). The injector's draws do
    not depend on the device, so the card's engine (kernels, graphs)
    must give the CPU engine's trajectory and injected counts."""
    from repro_torch.configs import smoke
    from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
    from repro_torch.data import tasks
    from repro_torch.models import Model
    from repro_torch.serving import (Engine, EngineConfig, FaultInjector,
                                     FaultPlan, SamplingParams)
    cfg = smoke("r1-distill-14b")
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init_params(torch.Generator().manual_seed(0))
    gpu_model = Model(cfg, device=DEVICE)
    gpu_params = {k: _to(v, DEVICE) for k, v in params.items()}
    gpu_model.load_params(gpu_params)
    ecfg = EngineConfig(page_size=4, num_pages=64, max_slots=6,
                        max_pages_per_branch=24, prefill_chunk=16,
                        prefix_cache=True,
                        sampling=SamplingParams(temperature=0.0))
    runs = []
    for model, p in ((cpu_model, params), (gpu_model, gpu_params)):
        eng = Engine(model, p, ecfg)
        sch = Scheduler(FaultInjector(eng, FaultPlan.parse(
            FAULT_PARITY_PLAN)), OraclePRM(tasks.oracle_grader, noise=0.0,
                                           seed=2),
            SchedulerConfig(policy="sart", n=2, m=1, window=8,
                            max_tokens=24),
            answer_fn=tasks.extract_answer)
        rng = np.random.default_rng(3)
        for i in range(3):
            prob = tasks.gen_problem(rng)
            sch.submit(prob.prompt_tokens(), payload=prob, arrival=i * 2)
        m = sch.run(max_steps=50_000)
        eng.allocator.check_invariants()
        check(all(h is None for h in eng.slots)
              and eng.allocator.used_pages == 0,
              "the fault parity engine held a slot or a page")
        runs.append((_digest(m), m["faults"]))
    _check_graphs(eng, "the card's fault parity engine")
    _check_captures(eng, "the card's fault parity engine")
    (d_cpu, f_cpu), (d_gpu, f_gpu) = runs
    inj = f_gpu["injected"]
    ok = d_cpu == d_gpu and f_cpu == f_gpu
    print(f"[parity] faults under {FAULT_PARITY_PLAN!r}: trajectory equal "
          f"{d_cpu == d_gpu}, fault counters equal {f_cpu == f_gpu}; "
          f"injected {inj}; restarts {f_gpu['engine_restarts']}; decode "
          f"steps {d_gpu[1]}; {'ok' if ok else 'FAIL'}")
    check(ok, f"the card's engine under faults disagrees with the CPU's: "
              f"{f_cpu} against {f_gpu}")
    check(inj["crash"] == 1 and inj["oop"] > 0
          and f_gpu["engine_restarts"] >= 1,
          f"the fault parity plan did not crash and storm: {f_gpu}")


def _model_parity(torch):
    """``Model.prefill`` + ``decode_step`` over the dense cache on the card
    against the CPU, fp32, greedy: r1-distill-14b's smoke widths (K5 in
    every layer of the prefill), the same with an 8-token sliding window
    (a ring cache, the ported ``_attend``) and gemma-7b's at head_dim 256
    (K5's head_dim-256 kernel), a 20-token prompt and 8 steps."""
    from repro_torch.configs import smoke
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models import Model
    base = smoke("r1-distill-14b")
    prompt = [int(x) for x in (np.arange(20) * 7 + 3) % base.vocab_size]
    for name, cfg in (("dense", base),
                      ("swa", base.replace(sliding_window=8)),
                      (f"gemma head_dim {WIDE}",
                       smoke("gemma-7b").replace(head_dim=WIDE))):
        runs = []
        for dev in ("cpu", DEVICE):
            model = Model(cfg, device=dev)
            params = model.init_params(torch.Generator().manual_seed(0)) \
                if dev == "cpu" else _to(runs[0][2], dev)
            model.load_params(params)
            flash_prefill.launches = 0
            lg, cache = model.prefill(
                params, tokens=torch.tensor([prompt], device=dev),
                max_len=len(prompt) + 8)
            first, toks, pos = lg.float().cpu(), [], len(prompt)
            cur = int(torch.argmax(lg[0]))
            for _ in range(8):
                toks.append(cur)
                lg, cache, _ = model.decode_step(
                    params, torch.tensor([cur], device=dev), cache,
                    torch.tensor([pos], device=dev))
                cur, pos = int(torch.argmax(lg[0])), pos + 1
            runs.append((toks, first, params, flash_prefill.launches))
        (t_cpu, l_cpu, _, _), (t_gpu, l_gpu, _, k5) = runs
        err = float((l_cpu - l_gpu).abs().max())
        want_k5 = 0 if cfg.sliding_window else cfg.num_layers
        ok = t_cpu == t_gpu and err <= 1e-4 and k5 == want_k5
        print(f"[parity] Model {name}: greedy tokens equal: "
              f"{t_cpu == t_gpu}; max abs err of prefill logits {err:.3e} "
              f"(atol 1e-4); K5 launches {k5}; {'ok' if ok else 'FAIL'}")
        check(ok, f"Model.prefill/decode_step on the card disagree with "
                  f"the CPU ({name})")


def _fallback_trunks(torch):
    """The serve launcher's untrained dense and hybrid fallback trunks
    (32-wide attention heads, K1/K2 at head_dim 32) serve on the card."""
    from repro_torch.launch.serve import load_reasoner, run_serving
    for arch in ("dense", "hybrid"):
        model, params, prm = load_reasoner(None, device=DEVICE, arch=arch)
        out, engine = run_serving(
            model, params, prm, policy="sart", n=4, num_requests=3,
            rate_gap=4, prm_kind="oracle", window=8, max_tokens=32,
            max_slots=8, seed=0, temperature=0.9)
        ok = (out["completed_requests"] == 3
              and out["faults"]["step_faults"] == 0
              and engine.allocator.used_pages == 0)
        print(f"[parity] serve fallback --arch {arch} (head_dim "
              f"{model.cfg.resolved_head_dim}) on the card: "
              f"{out['completed_requests']}/3 requests, "
              f"{engine.decode_steps_executed} steps; "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"the {arch} fallback trunk failed to serve on the card")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _graph_stats(engine) -> dict:
    """One engine's step graphs: variants captured against declared,
    replays against decode steps, capture seconds per variant (warm-up on
    the inert inputs included)."""
    return {"captured": engine.graphs_captured,
            "declared": len(engine.step_variants()),
            "replays": engine.graph_replays,
            "decode_steps": engine.decode_steps_executed,
            "capture_s": {name: round(g.capture_seconds, 4)
                          for name, g in engine.step_graphs.items()
                          if g.graph is not None}}


def _check_graphs(engine, what: str) -> None:
    """Every decode step of a serve was one graph replay, and no more
    variants were captured than the engine declares."""
    st = _graph_stats(engine)
    check(st["replays"] == st["decode_steps"] > 0,
          f"{what}: {st['replays']} graph replays for {st['decode_steps']} "
          "decode steps")
    check(0 < st["captured"] <= st["declared"],
          f"{what}: {st['captured']} graphs captured, {st['declared']} "
          "variants declared")


def _path_launches(engine, recorded: dict) -> dict:
    """The launches a serve's steps ran, for each kernel of ``recorded``:
    each variant's launches recorded at capture times its replays, plus
    the eager steps' own (``Engine.step_launches``). ``recorded`` holds
    the wrappers' counters over the run, zeroed just before it: they
    count where a wrapper runs, so under graphs the warm-up's and the
    capture's launches. A kernel the steps ran must show there too."""
    ran = engine.step_launches()
    out = {k: ran.get(k, 0) for k in recorded}
    for k, n in out.items():
        check((n > 0) == (recorded[k] > 0),
              f"{k}: the steps ran it {n} times, its wrapper counted "
              f"{recorded[k]}")
    return out


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.sampling import sample_top_p
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import Model
    cfg = get_config("r1-distill-14b")
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params bf16, "
          f"random weights in {time.perf_counter() - t0:.1f} s")

    paged_attention.launches = 0
    paged_prefill.launches = 0
    sample_top_p.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, engine = run_serving(
        model, params, None, policy="sart", n=8, num_requests=4, rate_gap=8,
        prm_kind="oracle", window=8, max_tokens=96, max_slots=16, seed=0,
        temperature=0.9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recorded = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "sample_top_p": sample_top_p.launches}
    launches = _path_launches(engine, recorded)

    steps = _step_seconds(t0)
    p50 = steps[len(steps) // 2] if steps else float("nan")
    faults = out["faults"]
    line = {
        "completed_requests": out["completed_requests"],
        "unfinished_requests": out["unfinished_requests"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(p50 * 1e3, 3),
        "step_ms_mean": round(sum(steps) / max(len(steps), 1) * 1e3, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "k1_launches": launches["paged_decode"],
        "k2_launches": launches["paged_prefill"],
        "e2e_p50_steps": out["p50"], "ttfb50_steps": out["ttfb50"],
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
        "graphs": _graph_stats(engine),
    }
    print("[serve] " + json.dumps(line))
    _check_graphs(engine, "the serve")
    check(out["completed_requests"] == 4 and out["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the serve run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(launches["paged_prefill"]
          == cfg.num_layers * engine.mixed_steps_executed,
          f"K2 did not launch once per layer per mixed step: {launches}, "
          f"{engine.mixed_steps_executed} mixed steps")
    check(launches["sample_top_p"] == engine.decode_steps_executed,
          f"the top-p sampler did not launch once per step: {launches}, "
          f"{engine.decode_steps_executed} steps")
    return model, params, launches


def few_shot_header(n_tokens: int, seed: int):
    """Seeded solved problems rendered as traces (EOS dropped), joined
    and cut to ``n_tokens``: the shared few-shot header of phase 6."""
    from repro_torch.data import tasks
    from repro_torch.data import tokenizer as tk
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_tokens:
        out += [t for t in tasks.render_trace(tasks.gen_problem(rng), rng)
                if t != tk.EOS]
    return out[:n_tokens]


def _serve_setup(torch, model, params, *, shared_header: bool,
                 decode_kernel: str = "paged", temperature: float = 0.9,
                 engine=None, num_requests: int = 4, n: int = 8,
                 max_tokens: int = 96, prefix_cache: Optional[bool] = None,
                 fault_plan: Optional[str] = None, poisoned: bool = False):
    """The engine and scheduler of a serve phase's traffic: 4 requests
    every 8 steps under SART (n=8, window 8, max 96 tokens, OraclePRM
    noise 0.05; phase 11 takes 2 requests, n=4, max 48) on run_serving's
    engine config (4096 x 16 pages, 16 slots, 32 pages per branch, chunk
    64, top-p 0.95). With
    ``shared_header`` phase 6's prompts (a 256-token few-shot header, 16
    whole pages, then each request's own problem) and the prefix cache
    on; else phase 5's (run_serving's synthetic problems). Built here so
    that the launcher gains no feature the reference lacks. A given
    ``engine`` (idle, with no page held) is served again.
    ``prefix_cache`` overrides the cache's default; ``fault_plan`` (a
    ``FaultPlan.parse`` string, "" the empty plan) puts a
    ``FaultInjector`` between the scheduler and the engine; ``poisoned``
    adds one more request, the next synthetic problem with the poison
    token ``tk.STEP`` (never in a problem's prompt) as its second token.
    Returns the engine itself, never the injector, and the scheduler."""
    from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
    from repro_torch.data import tasks
    from repro_torch.data import tokenizer as tk
    from repro_torch.serving import (Engine, EngineConfig, FaultInjector,
                                     FaultPlan, SamplingParams)
    seed = 0
    if shared_header:
        prompts, probs = _shared_header_prompts(seed)
    else:
        rng = np.random.default_rng(seed + 2)
        probs = [tasks.gen_problem(rng)
                 for _ in range(num_requests + poisoned)]
        prompts = [p.prompt_tokens() for p in probs]
        if poisoned:
            prompts[-1][1] = tk.STEP
    if engine is None:
        engine = Engine(model, params, EngineConfig(
            page_size=16, num_pages=4096, max_slots=16,
            max_pages_per_branch=32, eos_id=tk.EOS,
            sampling=SamplingParams(temperature=temperature, top_p=0.95),
            seed=seed, prefix_cache=(shared_header if prefix_cache is None
                                     else prefix_cache),
            decode_kernel=decode_kernel))
    driven = (engine if fault_plan is None
              else FaultInjector(engine, FaultPlan.parse(fault_plan)))
    prm = OraclePRM(tasks.oracle_grader, noise=0.05, seed=seed + 1)
    sch = Scheduler(driven, prm, SchedulerConfig(policy="sart", n=n,
                                                 window=8,
                                                 max_tokens=max_tokens),
                    answer_fn=tasks.extract_answer)
    for i, (prompt, prob) in enumerate(zip(prompts, probs)):
        sch.submit(prompt, payload=prob, arrival=i * 8)
    return engine, sch


def _serve_shared_header(torch, model, params, decode_kernel: str,
                         tag: str = "serve-tree"):
    """One serve of phase 6's traffic (``_serve_setup`` with the shared
    header) with ``decode_kernel``. Launch counters are zeroed just
    before the run and read just after. Returns (summary line,
    launches)."""
    from repro_torch.core.scheduler import percentile_latency
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.kernels.sampling import sample_top_p
    gc.collect()                 # the previous engine and its KV pools
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine, sch = _serve_setup(torch, model, params, shared_header=True,
                               decode_kernel=decode_kernel)

    paged_attention.launches = 0
    paged_prefill.launches = 0
    sample_top_p.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    t0 = time.perf_counter()
    metrics = sch.run(max_steps=2_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recorded = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "sample_top_p": sample_top_p.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches}
    launches = _path_launches(engine, recorded)

    steps = _step_seconds(t0)
    faults = metrics["faults"]
    stats = engine.prefix_cache_stats()
    line = {
        "decode_kernel": decode_kernel,
        "completed_requests": metrics["completed_requests"],
        "unfinished_requests": metrics["unfinished_requests"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "step_ms_mean": round(sum(steps) / len(steps) * 1e3, 3),
        "mem_held_before_gb": round(held, 2),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "launches": launches,
        "prefix_cache": stats,
        "cached_tokens": [r["cached_tokens"] for r in metrics["requests"]],
        "e2e_p50_steps": percentile_latency(metrics, 50),
        "ttfb50_steps": percentile_latency(metrics, 50, "ttfb"),
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
        "graphs": _graph_stats(engine),
    }
    print(f"[{tag}] " + json.dumps(line))
    _check_graphs(engine, f"the {decode_kernel} serve")
    check(metrics["completed_requests"] == 4
          and metrics["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(stats["hit_tokens"] > 0 and stats["hit_rate"] > 0,
          "the shared header never hit the prefix cache")
    check(launches["paged_prefill"]
          == model.cfg.num_layers * engine.mixed_steps_executed,
          f"K2 did not launch once per layer per mixed step: {launches}, "
          f"{engine.mixed_steps_executed} mixed steps")
    return line, launches


def phase_tree_serve(torch, model, params):
    """Phase 6: the shared-header traffic with tree decode (the path,
    whose launches are counted), then the same traffic with per-branch
    decode for the step-time comparison inside this one call."""
    line, launches = _serve_shared_header(torch, model, params, "tree")
    _check_tree_launches(model, line, launches)
    paged, _ = _serve_shared_header(torch, model, params, "paged")
    print(f"[serve-tree] step p50 tree {line['step_ms_p50']} ms vs paged "
          f"{paged['step_ms_p50']} ms on the same traffic "
          f"({line['step_ms_p50'] / paged['step_ms_p50'] - 1:+.1%})")
    return launches, paged["step_ms_p50"]


def _check_tree_launches(model, line: dict, launches: dict) -> None:
    """The tree path's kernels in a tree serve: K3 carries every decode
    row (its branch pass once per layer per decode step), K1 never; K3's
    shared pass and K2 launch."""
    check(launches["paged_decode"] == 0, "K1 launched in the tree run")
    check(launches["paged_tree_branch"]
          == model.cfg.num_layers * line["decode_steps"],
          "K3's branch pass did not carry every decode step")
    check(launches["paged_tree_shared"] > 0
          and launches["paged_prefill"] > 0,
          f"a kernel of the tree path never launched: {launches}")


def _shared_header_prompts(seed: int = 0):
    """Phase 6's 4 prompts: the 256-token few-shot header, then each
    request's own problem (267-273 tokens in all), with the problems."""
    from repro_torch.data import tasks
    header = few_shot_header(256, seed=seed + 3)
    rng = np.random.default_rng(seed + 2)
    probs = [tasks.gen_problem(rng) for _ in range(4)]
    return [header + p.prompt_tokens() for p in probs], probs


def phase_exact_serve(torch, model, params, paged_p50: float,
                      tag: str = "serve-exact"):
    """Phase 7: phase 6's traffic (4 requests every 8 steps, 256-token
    shared header + problem) on the same weights with
    ``chunked_prefill=False``: the cache off, per-branch decode, phase 5's
    config otherwise. Every admission is one synchronous exact-length pass
    (K5 in each of the 48 layers), every decode row K1, no chunk lane (K2
    0). Then ``Model.prefill`` of one seeded 4,096-token prompt (K5 48
    times) and 8 ``decode_step``s over its dense cache, and the first
    token's logits of one prompt by exact against chunked admission
    (printed, not gated in bf16). Phase 12 runs it on gemma-7b (28
    layers). Returns the serve's line (its launches included)."""
    from repro_torch.core import OraclePRM, Scheduler, SchedulerConfig
    from repro_torch.core.scheduler import percentile_latency
    from repro_torch.data import tasks
    from repro_torch.data import tokenizer as tk
    from repro_torch.kernels.flash_prefill import flash_prefill, paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.kernels.sampling import sample_top_p
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    gc.collect()                 # phase 6's engines and their KV pools
    torch.cuda.empty_cache()
    L = model.cfg.num_layers
    seed = 0
    prompts, probs = _shared_header_prompts(seed)
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, params, EngineConfig(
        page_size=16, num_pages=4096, max_slots=16, max_pages_per_branch=32,
        eos_id=tk.EOS, sampling=SamplingParams(temperature=0.9, top_p=0.95),
        seed=seed, chunked_prefill=False))
    prefill_s = []
    begin = engine.begin_prefill

    def timed_begin(prompt):     # the synchronous admission, device-synced
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = begin(prompt)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return st
    engine.begin_prefill = timed_begin
    prm = OraclePRM(tasks.oracle_grader, noise=0.05, seed=seed + 1)
    sch = Scheduler(engine, prm, SchedulerConfig(policy="sart", n=8,
                                                 window=8, max_tokens=96),
                    answer_fn=tasks.extract_answer)
    for i, (prompt, prob) in enumerate(zip(prompts, probs)):
        sch.submit(prompt, payload=prob, arrival=i * 8)

    paged_attention.launches = 0
    paged_prefill.launches = 0
    sample_top_p.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    flash_prefill.launches = 0
    t0 = time.perf_counter()
    metrics = sch.run(max_steps=2_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # K5 runs eagerly in each admission; the steps' kernels replay
    recorded = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "sample_top_p": sample_top_p.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches}
    launches = dict(_path_launches(engine, recorded),
                    flash_prefill=flash_prefill.launches)
    steps = _step_seconds(t0)
    faults = metrics["faults"]
    line = {
        "completed_requests": metrics["completed_requests"],
        "unfinished_requests": metrics["unfinished_requests"],
        "prompt_tokens": [len(p) for p in prompts],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "exact_prefills": engine.exact_prefills,
        "clock": metrics["clock"],
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "step_ms_mean": round(sum(steps) / len(steps) * 1e3, 3),
        "paged_step_ms_p50_phase6": paged_p50,
        "prefill_ms": [round(t * 1e3, 3) for t in prefill_s],
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "launches": launches,
        "e2e_p50_steps": percentile_latency(metrics, 50),
        "ttfb50_steps": percentile_latency(metrics, 50, "ttfb"),
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
        "graphs": _graph_stats(engine),
    }
    _check_graphs(engine, "the exact serve")
    check(metrics["completed_requests"] == 4
          and metrics["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(launches["flash_prefill"] == L * 4 and launches["paged_prefill"]
          == 0 and launches["paged_decode"] > 0
          and engine.mixed_steps_executed == 0,
          f"the exact path's kernels: {launches}")
    del engine, sch
    gc.collect()
    torch.cuda.empty_cache()

    # exact against chunked admission of the first prompt: first-token
    # logits (bf16, different kernels and sums: printed, not gated)
    small = dict(page_size=16, num_pages=64, max_slots=2,
                 max_pages_per_branch=32,
                 sampling=SamplingParams(temperature=0.0))
    logits = []
    for chunked in (False, True):
        eng = Engine(model, params, EngineConfig(chunked_prefill=chunked,
                                                 **small))
        blocks, lg, _ = eng.prefill(prompts[0])
        logits.append(lg.float())
        eng.release_prefix(blocks)
        del eng
    line["exact_vs_chunked_logits_max_abs"] = float(
        (logits[0] - logits[1]).abs().max())
    line["exact_vs_chunked_argmax_equal"] = bool(
        int(logits[0].argmax()) == int(logits[1].argmax()))

    # Model.prefill of a 4,096-token prompt, then 8 decode steps
    gen = torch.Generator().manual_seed(seed + 5)
    toks = torch.randint(2, model.cfg.vocab_size, (1, 4096), generator=gen)
    toks = toks.to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    flash_prefill.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, tokens=toks, max_len=4104)
    torch.cuda.synchronize()
    prefill_4096 = time.perf_counter() - t0
    k5_4096 = flash_prefill.launches
    finite = bool(torch.isfinite(lg.float()).all())
    cur, dec = lg.argmax(-1), []
    for pos in range(4096, 4104):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, _ = model.decode_step(
            params, cur, cache, torch.tensor([pos], device=DEVICE))
        cur = lg.argmax(-1)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(lg.float()).all())
    line["model_prefill_4096"] = {
        "prefill_ms": round(prefill_4096 * 1e3, 3),
        "decode_step_ms_p50": round(sorted(dec)[len(dec) // 2] * 1e3, 3),
        "k5_launches": k5_4096,
        "cache_gb": round(sum(t.numel() * t.element_size()
                              for t in cache.values()) / 1e9, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
    print(f"[{tag}] " + json.dumps(line))
    print(f"[{tag}] step p50 exact {line['step_ms_p50']} ms vs the paged "
          f"serve of the shared-header traffic {paged_p50} ms "
          f"({line['step_ms_p50'] / paged_p50 - 1:+.1%})")
    check(k5_4096 == L, f"Model.prefill launched K5 {k5_4096} times")
    check(finite, "non-finite logits from Model.prefill/decode_step")
    del cache, lg
    return line


# phase 13's fault plan; run A adds ``poison_token``. The seed is one at
# which every category fires in run A: the draws depend only on the
# order of steps and admissions, which random weights (no branch ends
# before ``max_tokens``) keep the same on every device
CHAOS_PLAN = ("seed=116,step_rate=0.04,oop_rate=0.03,nan_rate=0.03,"
              "slow_rate=0.05,crash_at=60,admit_fail_rate=0.2")
CHAOS_KINDS = ("oop", "step", "nan", "slow", "crash", "admit", "poisoned")


def _check_captures(engine, what: str) -> None:
    """Each captured variant was captured once: a restart or a raised
    step recaptured nothing."""
    caps = {name: g.captures for name, g in engine.step_graphs.items()
            if g.graph is not None}
    check(all(n == 1 for n in caps.values()),
          f"{what}: a variant was captured again: {caps}")


def _chaos_run(torch, model, params, tag: str, *, plan: str,
               shared_header: bool, decode_kernel: str, poisoned: bool):
    """One serve of phase 5's traffic (``poisoned``: plus a fifth request
    holding the poison token) or phase 6's under ``plan``, with the
    prefix cache on, on a fresh engine. Launch counters are zeroed just
    before the run and read just after. Every injected fault is caught
    by the scheduler; anything that escapes ``Scheduler.run`` fails the
    phase. Returns (line, launches)."""
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.kernels.sampling import sample_top_p
    gc.collect()                 # the previous engine and its KV pools
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, sch = _serve_setup(torch, model, params,
                               shared_header=shared_header,
                               decode_kernel=decode_kernel,
                               prefix_cache=True, fault_plan=plan,
                               poisoned=poisoned)
    paged_attention.launches = 0
    paged_prefill.launches = 0
    sample_top_p.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    t0 = time.perf_counter()
    metrics = sch.run(max_steps=2_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recorded = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "sample_top_p": sample_top_p.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches}
    launches = _path_launches(engine, recorded)
    faults = metrics["faults"]
    steps = _step_seconds(t0)
    line = {
        "run": tag, "decode_kernel": decode_kernel,
        "completed_requests": metrics["completed_requests"],
        "quarantined": [r["request_id"] for r in metrics["requests"]
                        if r["quarantined"]],
        "clock": metrics["clock"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "faults": faults,
        "launches": launches,
        "prefix_cache": engine.prefix_cache_stats(),
        "used_pages": engine.allocator.used_pages,
        "graphs": dict(_graph_stats(engine), captures={
            name: g.captures for name, g in engine.step_graphs.items()}),
    }
    print("[chaos] " + json.dumps(line))
    what = f"chaos run {tag}"
    poison_id = len(metrics["requests"]) - 1 if poisoned else None
    for r in metrics["requests"]:
        if r["request_id"] == poison_id:
            reason = sch.requests[poison_id].quarantine_reason or ""
            check(r["quarantined"] and r["finish"] is None
                  and "PoisonedRequestFault" in reason
                  and r["retries"] == sch.cfg.retry_budget + 1,
                  f"{what}: the poisoned request was not quarantined: {r}")
        else:
            check(r["finish"] is not None and not r["quarantined"],
                  f"{what}: request {r['request_id']} did not finish: {r}")
    inj = faults["injected"]
    check(inj["crash"] == 1 and faults["engine_restarts"] >= 1
          and faults["recovered"] >= 1,
          f"{what}: no crash, restart and recovery: {faults}")
    engine.allocator.check_invariants()
    check(all(h is None for h in engine.slots), f"{what}: a slot is held")
    check(engine.allocator.used_pages == 0,
          f"{what}: pages held outside the prefix cache")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          f"{what}: non-finite hidden state")
    # oop, step and crash faults raise before the step runs; a nan fault
    # is a step that ran (one replay) whose output was thrown away
    _check_graphs(engine, what)
    _check_captures(engine, what)
    L = model.cfg.num_layers
    check(launches["paged_prefill"] == L * engine.mixed_steps_executed,
          f"{what}: K2 did not launch once per layer per mixed step: "
          f"{launches}, {engine.mixed_steps_executed} mixed steps")
    if decode_kernel == "tree":
        _check_tree_launches(model, line, launches)
    else:
        check(launches["paged_decode"] == L * engine.decode_steps_executed,
              f"{what}: K1 did not launch on every step: {launches}")
    del engine, sch
    return line, launches


def _chaos_inert(torch, model, params) -> None:
    """Run B: phase 5's traffic, greedy, on two fresh engines with the same
    seed, one bare and one behind ``FaultInjector(engine, FaultPlan())``:
    every branch's tokens and the scheduler's trajectory must be equal."""
    runs = []
    for plan in (None, ""):
        gc.collect()
        torch.cuda.empty_cache()
        engine, sch = _serve_setup(torch, model, params,
                                   shared_header=False, temperature=0.0,
                                   prefix_cache=True, fault_plan=plan)
        branches, free = {}, engine.free_branch

        def recording_free(h, _free=free, _out=branches):
            _out[h.branch_id] = (h.request_id, tuple(h.tokens))
            return _free(h)
        engine.free_branch = recording_free
        metrics = sch.run(max_steps=2_000_000)
        torch.cuda.synchronize()
        _check_graphs(engine, "chaos run B")
        check(metrics["faults"]["step_faults"] == 0
              and engine.allocator.used_pages == 0,
              f"chaos run B: faults or leaked pages: {metrics['faults']}")
        runs.append((branches, _digest(metrics),
                     metrics["faults"].get("injected")))
        del engine, sch
    (b0, d0, _), (b1, d1, inj) = runs
    line = {"run": "B", "branches": len(b0), "decode_steps": d0[1],
            "clock": d0[0], "tokens_equal": b0 == b1,
            "digest_equal": d0 == d1, "injected": inj}
    print("[chaos] " + json.dumps(line))
    check(b0 == b1 and d0 == d1 and len(b0) > 0,
          "chaos run B: the empty plan changed the run")
    check(inj is not None and sum(v for k, v in inj.items()
                                  if k != "steps_seen") == 0,
          f"chaos run B: the empty plan injected: {inj}")


def _digest(m):
    """A scheduler run's trajectory (``tests/test_faults.py:_digest``)."""
    recs = tuple(
        (r["request_id"], r["arrival"], r["first_service"], r["ttfb"],
         r["finish"], r["e2e"], r["num_completed"], r["num_pruned"],
         r["answer"], tuple(r["response_lengths"]))
        for r in m["requests"])
    return m["clock"], m["decode_steps"], recs


def phase_chaos(torch, model, params) -> dict:
    """Phase 13: r1-distill-14b (phases 5-7's model and weights) under a
    seeded fault plan, each run on a fresh engine of run_serving's
    config with the prefix cache on. Run A: phase 5's traffic plus a
    poisoned fifth request under ``CHAOS_PLAN`` with the poison token;
    run B: the empty plan is inert (greedy, bare against injected); run
    C: phase 6's shared-header traffic with tree decode under the same
    plan without the poison token (the few-shot header holds ``tk.STEP``
    in its traces). Returns the launches of runs A and C."""
    from repro_torch.data import tokenizer as tk
    t_phase = time.perf_counter()
    plan_a = f"{CHAOS_PLAN},poison_token={tk.STEP}"
    run_a, launches = _chaos_run(torch, model, params, "A", plan=plan_a,
                                 shared_header=False,
                                 decode_kernel="paged", poisoned=True)
    inj = run_a["faults"]["injected"]
    check(all(inj[k] > 0 for k in CHAOS_KINDS),
          f"chaos run A: a fault category never fired: {inj}")
    _chaos_inert(torch, model, params)
    _, tree = _chaos_run(torch, model, params, "C", plan=CHAOS_PLAN,
                         shared_header=True, decode_kernel="tree",
                         poisoned=False)
    for k, n in tree.items():
        launches[k] = launches.get(k, 0) + n
    print(f"[chaos] plan A {plan_a!r}; plan C {CHAOS_PLAN!r}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_ssm_serve(torch):
    """Phase 8: mamba2-130m at full width and depth (24 layers, d_model
    768, 24 SSD heads of 64, state 128, chunk 128, vocab 50280), bf16,
    random weights from a seed, behind the SART scheduler through
    ``run_serving`` (4 requests, n=8). Every chunk lane's scan is K4, one
    launch per layer per mixed step; no attention kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.kernels.sampling import sample_top_p
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import Model
    gc.collect()                 # phase 6's model, engines and pools
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-130m")
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve-ssm] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, "
          f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
          f"{cfg.param_count() / 1e9:.3f} B params bf16, random weights in "
          f"{time.perf_counter() - t0:.1f} s")

    paged_attention.launches = 0
    paged_prefill.launches = 0
    sample_top_p.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, engine = run_serving(
        model, params, None, policy="sart", n=8, num_requests=4, rate_gap=8,
        prm_kind="oracle", window=8, max_tokens=96, max_slots=16, seed=0,
        temperature=0.9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recorded = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "sample_top_p": sample_top_p.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches,
                "ssd_scan": ssd_scan.launches}
    launches = _path_launches(engine, recorded)

    steps = _step_seconds(t0)
    faults = out["faults"]
    line = {
        "completed_requests": out["completed_requests"],
        "unfinished_requests": out["unfinished_requests"],
        "decode_steps": engine.decode_steps_executed,
        "mixed_steps": engine.mixed_steps_executed,
        "wall_s": round(wall, 3),
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": round(engine.tokens_generated / wall, 2),
        "step_ms_p50": round(steps[len(steps) // 2] * 1e3, 3),
        "step_ms_mean": round(sum(steps) / len(steps) * 1e3, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "launches": launches,
        "e2e_p50_steps": out["p50"], "ttfb50_steps": out["ttfb50"],
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
        "graphs": _graph_stats(engine),
    }
    print("[serve-ssm] " + json.dumps(line))
    _check_graphs(engine, "the ssm serve")
    check(out["completed_requests"] == 4 and out["unfinished_requests"] == 0,
          "not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, "pages leaked after serving")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          "non-finite hidden state")
    check(launches["ssd_scan"] > 0 and launches["ssd_scan"]
          == cfg.num_layers * engine.mixed_steps_executed,
          f"K4 did not carry every mixed step's layers: {launches}")
    check(all(launches[k] == 0 for k in launches
              if k not in ("ssd_scan", "sample_top_p")),
          f"an attention kernel launched in the ssm serve: {launches}")
    return launches


def phase_tree_pairs(torch, pairs: int) -> None:
    """Phase 6's traffic on r1-distill-14b (bf16, random weights from a
    seed) served with tree and with per-branch decode in alternating
    order (tree, paged, paged, tree, ...) after one discarded warm-up run
    of each, so that a drift of the host's speed during the call falls on
    both alike. Prints each run's step p50 and tokens/s and the tree/paged
    step p50 ratio of each pair."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config("r1-distill-14b"), dtype=torch.bfloat16,
                  device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    for kind in ("paged", "tree"):
        _serve_shared_header(torch, model, params, kind)
    runs = {"tree": [], "paged": []}
    for i in range(pairs):
        for kind in (("tree", "paged") if i % 2 == 0 else ("paged", "tree")):
            line, _ = _serve_shared_header(torch, model, params, kind)
            runs[kind].append((line["step_ms_p50"], line["tokens_per_s"]))
    ratios = [t[0] / p[0] for t, p in zip(runs["tree"], runs["paged"])]
    print("[tree-pairs] " + json.dumps({
        "step_ms_p50": {k: [r[0] for r in v] for k, v in runs.items()},
        "tokens_per_s": {k: [r[1] for r in v] for k, v in runs.items()},
        "tree_over_paged": [round(r, 4) for r in ratios]}))


def _serve_recorded(torch, model, params, *, eager: bool,
                    shared_header: bool, decode_kernel: str = "paged",
                    num_requests: int = 4, **traffic):
    """One greedy serve of phase 5's or phase 6's traffic, or phase 11's
    with ``traffic`` (``_serve_setup``), eagerly (``Engine.eager()``) or
    through the step graphs, recording every decode step's tokens and
    every step's logits of the rows that carry a result (a copy of them
    rides each step, both ways). Returns (summary line, tokens per step,
    logits per step)."""
    gc.collect()
    torch.cuda.empty_cache()
    engine, sch = _serve_setup(torch, model, params,
                               shared_header=shared_header,
                               decode_kernel=decode_kernel, temperature=0.0,
                               num_requests=num_requests, **traffic)
    tokens, logits = [], []
    step, decode = engine._step, engine.decode_step
    n_slots = engine.cfg.max_slots

    def recording_step(tokens_, positions, tables, lengths,
                       lane_buckets=(), chunk_lens=(), *args, **kw):
        out = step(tokens_, positions, tables, lengths, lane_buckets,
                   chunk_lens, *args, **kw)
        # the rows that carry a result: occupied slots and each lane's
        # valid rows
        live = [i for i in range(n_slots) if engine._active[i]]
        for i, (bk, cl) in enumerate(zip(lane_buckets, chunk_lens)):
            live += range(n_slots + i * bk, n_slots + i * bk + cl)
        logits.append(out[2][live].clone())
        return out

    def recording_decode():
        out = decode()
        tokens.append(dict(out))
        return out
    engine._step, engine.decode_step = recording_step, recording_decode
    t0 = time.perf_counter()
    with engine.eager() if eager else contextlib.nullcontext():
        metrics = sch.run(max_steps=2_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    faults = metrics["faults"]
    line = dict(_step_stats(engine, wall, t0),
                mode="eager" if eager else "graphs",
                completed_requests=metrics["completed_requests"],
                graphs=_graph_stats(engine),
                used_pages=engine.allocator.used_pages)
    check(metrics["completed_requests"] == num_requests
          and metrics["unfinished_requests"] == 0
          and faults["step_faults"] == faults["engine_restarts"] == 0,
          f"the {line['mode']} serve did not complete cleanly: {faults}")
    check(engine.allocator.used_pages == 0,
          f"the {line['mode']} serve leaked pages")
    if eager:
        check(engine.graph_replays == engine.graphs_captured == 0,
              "the eager serve replayed a graph")
    else:
        _check_graphs(engine, "the graph serve")
    del engine, sch
    return line, tokens, logits


def phase_graphs(torch) -> dict:
    """Phase 9: eager against graph steps at full width and depth, on one
    set of random weights each: r1-distill-14b on phase 5's traffic and
    on phase 6's with tree decode, mamba2-130m on phase 8's; greedy. The
    tokens of every decode step must be identical both ways; the steps'
    logits' largest difference is printed. Returns the lines."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    runs = {}
    for arch, traffic in (("r1-distill-14b", (("serve", False, "paged"),
                                              ("tree", True, "tree"))),
                          ("mamba2-130m", (("ssm", False, "paged"),))):
        gc.collect()
        torch.cuda.empty_cache()
        model = Model(get_config(arch), dtype=torch.bfloat16, device=DEVICE)
        params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
        for name, header, kernel in traffic:
            eager, t_e, l_e = _serve_recorded(torch, model, params,
                                              eager=True,
                                              shared_header=header,
                                              decode_kernel=kernel)
            graph, t_g, l_g = _serve_recorded(torch, model, params,
                                              eager=False,
                                              shared_header=header,
                                              decode_kernel=kernel)
            same = t_e == t_g
            err = (max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(l_e, l_g))
                   if len(l_e) == len(l_g) else float("nan"))
            line = {"model": arch, "traffic": name, "decode_kernel": kernel,
                    "tokens_identical": same, "decode_steps": len(t_g),
                    "logits_max_abs_diff": err,
                    "step_ms_p50": {"eager": eager["step_ms_p50"],
                                    "graphs": graph["step_ms_p50"]},
                    "step_ms_mean": {"eager": eager["step_ms_mean"],
                                     "graphs": graph["step_ms_mean"]},
                    "graphs": graph["graphs"]}
            print("[graphs] " + json.dumps(line))
            print(f"[graphs] {arch} {name}: step p50 eager "
                  f"{eager['step_ms_p50']:.3f} ms, graphs "
                  f"{graph['step_ms_p50']:.3f} ms; tokens identical at "
                  f"every step: {same}; capture s per variant "
                  f"{graph['graphs']['capture_s']}")
            check(same, f"{arch} {name}: graph steps gave other tokens than "
                        "eager steps")
            runs[f"{arch} {name}"] = line
            del l_e, l_g
        del model, params
    return runs


def _step_bytes(model, params) -> int:
    """The bytes a decode step must stream at least: every layer weight
    once (MoE layers run every expert on its capacity buffer, so all
    experts' weights), the final norm and the LM head (the embedding
    table when tied); the step's few embedding rows and K/V pages are
    left out (under 0.1% at these widths)."""
    def size(tree):
        return sum(size(v) if isinstance(v, dict)
                   else v.numel() * v.element_size() for v in tree.values())
    head = params["embed"].get("lm_head", params["embed"]["embedding"])
    return (size(params["layers"]) + size(params["final_norm"])
            + head.numel() * head.element_size())


def _full_width_model(torch, tag: str, arch: str, num_layers: int = 0):
    """``arch`` at full width, its depth cut to ``num_layers`` (0: full
    depth), bf16, random weights from seed 0, after the earlier phases'
    models and pools are freed. Prints its shape and the bound from the
    bytes a decode step streams. Returns (model, params, full config,
    step bytes, bound ms)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    gc.collect()                 # the earlier phases' models and pools
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(num_layers=num_layers) if num_layers else full
    model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
    params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    step_bytes = _step_bytes(model, params)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] {cfg.name} ({cfg.arch_type}): num_layers "
          f"{full.num_layers} -> {cfg.num_layers}, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
          + (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok}"
             f" (capacity factor {cfg.moe_capacity_factor})"
             if cfg.uses_moe else "")
          + f", vocab {cfg.vocab_size}, {cfg.pos_embedding} positions; "
          f"{step_bytes / 1e9:.2f} GB of bf16 weights a step streams, bound "
          f"{bound_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; random "
          f"weights in {time.perf_counter() - t0:.1f} s")
    return model, params, full, step_bytes, bound_ms


def phase_family_serve(torch, tag: str, arch: str, num_layers: int = 0, *,
                       n: int = 8, num_requests: int = 4,
                       max_tokens: int = 96) -> dict:
    """Phases 10-11: ``arch`` at full width, its depth cut to
    ``num_layers`` (0: full depth), bf16, random weights from seed 0, on
    ``_family_serve``'s run and checks; prints the phase's seconds and
    frees the model. Returns the serve's line."""
    t_phase = time.perf_counter()
    model, params, full, step_bytes, bound_ms = _full_width_model(
        torch, tag, arch, num_layers)
    line = _family_serve(torch, tag, model, params, full, step_bytes,
                         bound_ms, n=n, num_requests=num_requests,
                         max_tokens=max_tokens)
    del model, params
    line["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] {line['model']}: phase {line['phase_s']:.1f} s")
    return line


def _eager_vs_graphs(torch, tag: str, model, params, **traffic) -> dict:
    """The same traffic (``_serve_recorded``) greedy, eagerly and through
    the graphs on the same weights: tokens identical at every step and
    the largest logit difference on the rows that carry a result 0.0,
    both checked. Returns the comparison."""
    eager, t_e, l_e = _serve_recorded(torch, model, params, eager=True,
                                      **traffic)
    graph, t_g, l_g = _serve_recorded(torch, model, params, eager=False,
                                      **traffic)
    same = t_e == t_g
    err = (max(float((a.float() - b.float()).abs().max())
               for a, b in zip(l_e, l_g))
           if len(l_e) == len(l_g) else float("nan"))
    out = {"tokens_identical": same, "decode_steps": len(t_g),
           "logits_max_abs_diff": err,
           "step_ms_p50": {"eager": eager["step_ms_p50"],
                           "graphs": graph["step_ms_p50"]}}
    print(f"[{tag}] eager against graphs, greedy: " + json.dumps(out))
    check(same, f"{tag}: graph steps gave other tokens than eager steps")
    check(err == 0.0, f"{tag}: graph and eager logits differ by {err} on "
                      "the rows that carry a result")
    return out


def _family_serve(torch, tag: str, model, params, full, step_bytes: int,
                  bound_ms: float, *, n: int = 8, num_requests: int = 4,
                  max_tokens: int = 96) -> dict:
    """Behind the SART scheduler through ``run_serving`` (requests every 8
    steps, window 8, OraclePRM noise 0.05, temperature 0.9) on the
    launcher's engine config, through the step graphs. Counters are
    zeroed just before the serve and read just after: K1 and K2 must
    launch, K2 once per layer per mixed step; replays must equal decode
    steps, every request complete with no fault or leaked page, hidden
    states be finite. Then ``_eager_vs_graphs`` on the same traffic.
    Prints the step p50 beside the bound from the bytes a step streams,
    the peak memory and the capture seconds per variant. Returns the
    serve's line."""
    from repro_torch.kernels.flash_prefill import flash_prefill, paged_prefill
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     tree_decode)
    from repro_torch.kernels.sampling import sample_top_p
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import run_serving
    cfg = model.cfg
    paged_attention.launches = 0
    paged_prefill.launches = 0
    sample_top_p.launches = 0
    tree_decode.shared_launches = tree_decode.branch_launches = 0
    ssd_scan.launches = 0
    flash_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, engine = run_serving(
        model, params, None, policy="sart", n=n, num_requests=num_requests,
        rate_gap=8, prm_kind="oracle", window=8, max_tokens=max_tokens,
        max_slots=16, seed=0, temperature=0.9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recorded = {"paged_decode": paged_attention.launches,
                "paged_prefill": paged_prefill.launches,
                "sample_top_p": sample_top_p.launches,
                "paged_tree_shared": tree_decode.shared_launches,
                "paged_tree_branch": tree_decode.branch_launches,
                "ssd_scan": ssd_scan.launches,
                "flash_prefill": flash_prefill.launches}
    launches = _path_launches(engine, recorded)
    faults = out["faults"]
    line = {
        "model": cfg.name, "num_layers": [full.num_layers, cfg.num_layers],
        "completed_requests": out["completed_requests"],
        "unfinished_requests": out["unfinished_requests"],
        "generated_tokens": engine.tokens_generated,
        "tokens_per_s": engine.tokens_generated / wall,
        **_step_stats(engine, wall, t0),
        "mixed_steps": engine.mixed_steps_executed,
        "bound_ms": bound_ms, "step_bytes": step_bytes,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "e2e_p50_steps": out["p50"], "ttfb50_steps": out["ttfb50"],
        "faults": {k: faults[k] for k in ("step_faults", "engine_restarts",
                                          "quarantined")},
        "used_pages": engine.allocator.used_pages,
        "graphs": _graph_stats(engine),
    }
    print(f"[{tag}] " + json.dumps(line))
    print(f"[{tag}] {cfg.name}: step p50 {line['step_ms_p50']:.3f} ms "
          f"against the bound {bound_ms:.3f} ms from bytes "
          f"({line['step_ms_p50'] / bound_ms:.2f}x); peak memory "
          f"{line['peak_mem_gb']:.2f} GB; capture s per variant "
          f"{line['graphs']['capture_s']}; K1 {launches['paged_decode']}, "
          f"K2 {launches['paged_prefill']} launches")
    _check_graphs(engine, f"the {tag} serve")
    check(out["completed_requests"] == num_requests
          and out["unfinished_requests"] == 0,
          f"{tag}: not every request completed")
    check(faults["step_faults"] == faults["engine_restarts"]
          == faults["quarantined"] == 0, f"{tag}: faults in the run: {faults}")
    check(engine.allocator.used_pages == 0, f"{tag}: pages leaked")
    check(bool(torch.isfinite(engine._last_hidden.float()).all()),
          f"{tag}: non-finite hidden state")
    check(launches["paged_decode"] > 0 and launches["paged_prefill"]
          == cfg.num_layers * engine.mixed_steps_executed > 0,
          f"{tag}: K1 and K2 did not carry the steps: {launches}, "
          f"{engine.mixed_steps_executed} mixed steps")
    check(all(launches[k] == 0 for k in launches
              if k not in ("paged_decode", "paged_prefill", "sample_top_p")),
          f"{tag}: a kernel off the path launched: {launches}")
    del engine
    line["eager_vs_graphs"] = _eager_vs_graphs(
        torch, tag, model, params, shared_header=False, n=n,
        num_requests=num_requests, max_tokens=max_tokens)
    return line


def phase_gemma_serve(torch) -> dict:
    """Phase 12: gemma-7b at full width and depth (28 layers, d_model
    3072, 16/16 heads of 256, GeGLU, a tied vocabulary of 256,000), bf16,
    random weights from seed 0: the head_dim-256 kernels on the serve
    path. Three runs on one set of weights, each on run_serving's engine
    config through the step graphs, its counters zeroed just before and
    read just after: (1) phase 5's traffic (``_family_serve``: K1 every
    step, K2 once per layer per mixed step; then greedy eager against
    graphs); (2) phase 6's shared-header traffic with
    ``prefix_cache=True, decode_kernel="tree"`` (K3 carries every decode
    row, K1 never; then greedy eager against graphs); (3) phase 7's
    exact admission (K5 in all 28 layers of each admission) and
    ``Model.prefill`` of 4,096 tokens. Each run: every request completes
    with no fault or leaked page, finite hidden states, replays equal
    decode steps. Prints each run's step p50 beside the bound from the
    bytes a step streams, the peak memory and each variant's capture
    time. Returns the launches of each head_dim-256 kernel on its run."""
    t_phase = time.perf_counter()
    tag = "serve-gemma"
    model, params, full, step_bytes, bound_ms = _full_width_model(
        torch, tag, "gemma-7b")
    check(model.cfg.resolved_head_dim == WIDE
          and model.cfg.num_layers == full.num_layers,
          f"{tag}: not gemma-7b at full depth and head_dim {WIDE}")
    serve = _family_serve(torch, tag, model, params, full, step_bytes,
                          bound_ms)
    tree, tree_launches = _serve_shared_header(torch, model, params, "tree",
                                               tag=tag)
    _check_tree_launches(model, tree, tree_launches)
    tree["eager_vs_graphs"] = _eager_vs_graphs(
        torch, tag, model, params, shared_header=True, decode_kernel="tree")
    exact = phase_exact_serve(torch, model, params, tree["step_ms_p50"],
                              tag=tag)
    runs = {
        run: {"step_ms_p50": line["step_ms_p50"],
              "over_bound": line["step_ms_p50"] / bound_ms,
              "peak_mem_gb": line["peak_mem_gb"],
              "capture_s": line["graphs"]["capture_s"],
              "replays": line["graphs"]["replays"],
              "decode_steps": line["graphs"]["decode_steps"]}
        for run, line in (("serve", serve), ("tree", tree),
                          ("exact", exact))}
    summary = {"model": full.name, "num_layers": full.num_layers,
               "head_dim": WIDE, "bound_ms": bound_ms,
               "step_gb": step_bytes / 1e9, "runs": runs,
               "model_prefill_4096": exact["model_prefill_4096"],
               "phase_s": time.perf_counter() - t_phase}
    print(f"[{tag}] " + json.dumps(summary))
    del model, params
    return {kernel_key("paged_decode", WIDE): serve["launches"][
                "paged_decode"],
            kernel_key("paged_prefill", WIDE): serve["launches"][
                "paged_prefill"],
            kernel_key("paged_tree_shared", WIDE): tree_launches[
                "paged_tree_shared"],
            kernel_key("paged_tree_branch", WIDE): tree_launches[
                "paged_tree_branch"],
            kernel_key("flash_prefill", WIDE): exact["launches"][
                "flash_prefill"]}


def _train_model(torch, arch: str, num_layers: int):
    """``arch`` at full width, its depth cut to ``num_layers``, bf16
    params (AdamW's mu and nu fp32), random weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    full = get_config(arch)
    model = Model(full.replace(num_layers=num_layers), dtype=torch.bfloat16,
                  device=DEVICE)
    return full, model, model.init_params(
        torch.Generator(DEVICE).manual_seed(0))


def _train_full_width(torch, tag: str, arch: str, num_layers: int, *,
                      batch: int, seqlen: int, steps: int,
                      breakdown: bool = False, digest: bool = False) -> dict:
    """``arch`` at full width (``_train_model``): ``steps`` steps of
    ``train_lm`` on ``padded_batches`` of ``batch`` x ``seqlen`` through
    one ``make_train_step`` graph, the kernels' counters zeroed just
    before and read just after. Checks finite losses and grad norms; that
    step 1 warmed up, step 2 captured and every later step replayed; the
    launches the steps ran (``launches_run``: K5's and K4's forward 2 x
    layers x steps, backward layers x steps where the config runs the
    kernel, AdamW leaves x steps) and the wrappers' calls (warm-up and
    capture: ``_want_launches(cfg, 2)``). The step p50 is over the
    replay-only steps (3 on); the capture's seconds are printed apart.
    With ``digest``, the line holds ``_param_digest`` of the params after
    the last step (phase 15 holds its sharded steps to it). With
    ``breakdown``, then ``_train_breakdown`` on the same graph.
    Returns the run's line, with the model, params and step under
    "model_obj", "params" and "step_obj"."""
    from repro_torch.data import DataConfig, padded_batches
    from repro_torch.training import AdamWConfig, make_train_step, train_lm
    gc.collect()                 # the earlier phases' models and pools
    torch.cuda.empty_cache()
    full, model, params = _train_model(torch, arch, num_layers)
    cfg = model.cfg

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())

    def matmul(tree):   # params of the layers' matrix products
        return sum(matmul(v) if isinstance(v, dict)
                   else v.numel() * (v.dim() >= 3) for v in tree.values())
    n_params = count(params)
    head = params["embed"].get("lm_head", params["embed"]["embedding"])
    n_layers_mm, n_head = matmul(params["layers"]), head.numel()
    tokens = batch * seqlen
    # attention's causal pairs within the window (all of them without one)
    window = cfg.sliding_window or seqlen
    attn = 4 * cfg.resolved_head_dim * cfg.num_heads * sum(
        min(i + 1, window) for i in range(seqlen)) * batch * \
        cfg.num_layers * cfg.uses_attention
    ssd = [f(seqlen, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
             cfg.ssm_chunk) * batch * cfg.num_layers * cfg.uses_ssm
           for f in (ssd_flops, ssd_bwd_flops)]
    # forward, backward (2x) and the layers' recompute, plus attention:
    # its forward twice and its backward (2.5x the forward), plus the
    # scan: its forward twice and its backward
    step_ops = 6 * (n_layers_mm + n_head) * tokens + \
        2 * n_layers_mm * tokens + 4.5 * attn + 2 * ssd[0] + ssd[1]
    bound_ms = step_ops / PEAK_OPS["bf16"] * 1e3
    mixers = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, window {cfg.sliding_window}"
              if cfg.uses_attention else "no attention")
    if cfg.uses_ssm:
        mixers += (f"; {cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, "
                   f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    print(f"[{tag}] {cfg.name}: num_layers {full.num_layers} -> "
          f"{cfg.num_layers}, d_model {cfg.d_model}, {mixers}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}: {n_params / 1e9:.3f} B params (bf16; "
          f"{n_layers_mm / 1e9:.3f} B in the layers' products, "
          f"{n_head / 1e9:.3f} B in the LM head); B={batch} S={seqlen}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, recs = [], []

    def log(rec):
        stamps.append(time.perf_counter())
        recs.append(rec)
    counters = _train_counters()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    step = make_train_step(model, opt_cfg)
    params, _ = train_lm(
        model, padded_batches(DataConfig(batch_size=batch, seq_len=seqlen)),
        steps, opt_cfg, params=params, log_every=1, logger=log,
        step_fn=step)
    called = _nonzero({k: mod.launches for k, mod in counters.items()})
    launched = step.launches_run()
    step_s = np.diff([t0] + stamps)
    p50 = float(np.median(step_s[2:]))
    sig, = step.signatures.values()
    line = {"model": cfg.name, "num_layers": cfg.num_layers,
            "params_b": n_params / 1e9, "batch": batch, "seqlen": seqlen,
            "losses": [r["loss"] for r in recs],
            "grad_norms": [r["grad_norm"] for r in recs],
            "step_s": [float(x) for x in step_s],
            "step_ms_p50": p50 * 1e3, "p50_over": "replayed steps 3 on",
            "warmup_step_s": float(step_s[0]),
            "capture_s": sig.capture_seconds,
            "tokens_per_s": tokens / p50,
            "step_bound_ms": bound_ms,
            "over_bound": p50 * 1e3 / bound_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "captures": step.captures, "replays": step.replays,
            "launches": launched, "wrapper_calls": called}
    if digest:
        line["digest"] = _param_digest(torch, params)
    print(f"[{tag}] " + json.dumps(line))
    check(all(math.isfinite(x) for x in line["losses"] + line["grad_norms"]),
          f"{tag}: a non-finite loss or grad norm")
    _check_train_graph(step, steps, f"{tag}: {cfg.name}")
    leaves = _n_leaves(params)
    want = _want_launches(cfg, steps, leaves)
    check(launched == want, f"{tag}: {cfg.name} ran {launched}, want "
                            f"{want}")
    want_called = _want_launches(cfg, 2, leaves)
    check(called == want_called,
          f"{tag}: {cfg.name}'s wrappers ran {called} times (warm-up and "
          f"capture), want {want_called}")
    if breakdown:
        line["breakdown"] = _train_breakdown(torch, tag, model, step, batch,
                                             seqlen, leaves)
    return dict(line, model_obj=model, params=params, step_obj=step)


def _train_eager_vs_graph(torch, tag: str, arch: str, num_layers: int, *,
                          batch: int, seqlen: int, steps: int = 3) -> dict:
    """``arch`` at full width with ``num_layers`` layers: ``steps`` steps
    inside ``step.eager()`` (op by op), then ``steps`` through the graph
    (warm-up, capture and replay, replays), each from the same seed's
    weights on the same batches, the fused AdamW in both. Losses, grad
    norms and every param must be bit-equal, and both runs must launch
    ``_want_launches``."""
    from repro_torch.data import DataConfig, padded_batches
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.train_loop import to_batch
    gc.collect()
    torch.cuda.empty_cache()
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    runs = {}
    for mode in ("eager", "graph"):
        _, model, params = _train_model(torch, arch, num_layers)
        opt = init_opt_state(params)
        step = make_train_step(model, opt_cfg)
        data = padded_batches(DataConfig(batch_size=batch, seq_len=seqlen))
        metrics = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with step.eager() if mode == "eager" else contextlib.nullcontext():
            for _ in range(steps):
                toks, labels, mask = next(data)
                _, _, m = step(params, opt, to_batch(
                    {"tokens": toks, "labels": labels, "mask": mask},
                    DEVICE))
                metrics.append({k: float(v) for k, v in m.items()})
        wall = time.perf_counter() - t0
        runs[mode] = (metrics, params, step.launches_run(), wall)
        if mode == "graph":
            _check_train_graph(step, steps, f"{tag}: {model.cfg.name}")
        del opt, step
        gc.collect()
        torch.cuda.empty_cache()
    (m_e, p_e, l_e, w_e), (m_g, p_g, l_g, w_g) = runs["eager"], runs["graph"]
    from repro_torch.training.optimizer import tree_leaves
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(p_e), tree_leaves(p_g)))
    want = _want_launches(model.cfg, steps, _n_leaves(p_e))
    line = {"model": model.cfg.name, "num_layers": num_layers,
            "batch": batch, "seqlen": seqlen, "steps": steps,
            "losses_eager": [m["loss"] for m in m_e],
            "losses_graph": [m["loss"] for m in m_g],
            "grad_norms_eager": [m["grad_norm"] for m in m_e],
            "grad_norms_graph": [m["grad_norm"] for m in m_g],
            "metrics_equal": m_e == m_g, "params_equal": same_params,
            "launches_eager": l_e, "launches_graph": l_g,
            "wall_s_eager": w_e, "wall_s_graph": w_g}
    print(f"[{tag}] eager vs graph " + json.dumps(line))
    check(m_e == m_g and same_params,
          f"{tag}: {model.cfg.name}'s graph steps differ from its eager "
          f"steps")
    check(l_e == want and l_g == want,
          f"{tag}: {model.cfg.name} launched {l_e} eagerly and {l_g} "
          f"through the graph, want {want}")
    del p_e, p_g, runs
    return line


# device kernels of a train step by kind, from name fragments
TRAIN_KINDS = (("K5 backward", ("dkdv_", "dq_wgmma_kernel", "dq_f32_kernel",
                                "bwd_dot_kernel")),
               ("K5 forward", ("flash_prefill",)),
               ("K4 backward", ("dstate_", "state_pass_kernel",
                                "chunk_grad_", "da_reduce_kernel")),
               ("K4 forward", ("ssd_mma_kernel", "ssd_f32_kernel")),
               ("AdamW", ("adamw_kernel",)),
               ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")))


def _train_breakdown(torch, tag: str, model, step, batch: int,
                     seqlen: int, leaves: int) -> dict:
    """Where a replayed train step's time goes: one replay of ``step``'s
    graph timed between syncs, then one under torch.profiler (device
    activity only) with its kernels summed by kind (``TRAIN_KINDS``; the
    rest is elementwise, reduction and copy kernels, the global norm's
    included) and the top kernels. The AdamW ms is the fused kernel's,
    which must run once per leaf. Runs two more steps on the bound
    params and state."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, padded_batches
    from repro_torch.training.train_loop import to_batch
    toks, labels, mask = next(padded_batches(
        DataConfig(batch_size=batch, seq_len=seqlen, seed=1)))
    data = to_batch({"tokens": toks, "labels": labels, "mask": mask},
                    model.device)
    replays = step.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(step.params, step.opt_state, data)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(step.params, step.opt_state, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    check(step.replays == replays + 2, f"{tag}: the breakdown's steps were "
                                       f"not replays")
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    kinds = {name: 0.0 for name, _ in TRAIN_KINDS}
    kinds["other"] = 0.0
    for e in device:
        kind = next((name for name, frags in TRAIN_KINDS
                     if any(f in e.key for f in frags)), "other")
        kinds[kind] += e.self_device_time_total / 1e3
    adamw_launches = sum(e.count for e in device if "adamw_kernel" in e.key)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    out = {"replay_ms": replay_s * 1e3, "adamw_ms": kinds["AdamW"],
           "k5_bwd_ms": kinds["K5 backward"],
           "k4_bwd_ms": kinds["K4 backward"],
           "adamw_launches": adamw_launches, "leaves": leaves,
           "traced_step_ms": wall * 1e3,
           "device_ms": sum(kinds.values()),
           "device_busy_share": sum(kinds.values()) / 1e3 / wall,
           "device_ms_by_kind": kinds,
           "device_ops": sum(e.count for e in device),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]}
    print(f"[{tag}] breakdown " + json.dumps(out))
    check(adamw_launches == leaves, f"{tag}: the traced step ran the "
                                    f"AdamW kernel {adamw_launches} times "
                                    f"for {leaves} leaves")
    return out


def phase_train(torch) -> dict:
    """Phase 14: the training path on the card, after every model of
    phases 5-13 is freed, every train step through a ``TrainGraph`` (step
    1 warms up eagerly, step 2 captures and replays, later steps replay).
    (1) r1-distill-14b at full width (d_model 5120, 40/8 heads of 128,
    d_ff 13824, vocab 152064 untied), its depth cut from 48 to 8 layers,
    bf16 params with fp32 AdamW moments: 8 steps of ``train_lm`` at B=2,
    S=2048, the last loss below the first, with its breakdown (one traced
    replay); then 3 steps of ``train_prm_head`` on those weights through
    ``make_prm_step``'s graph (the LM under no_grad: K5's backward never
    launches). (2) Eager against graph, bit-equal, 3 steps each:
    r1-distill-14b at full width and 2 layers, and mamba2-130m at full
    width and depth. (3) The ssm and hybrid families through K4's
    forward and backward: ``smoke_arch`` of mamba2-130m and hymba-1.5b on
    the card (one eager step: the wrappers' launches exact); mamba2-130m
    at full width and depth (24 layers, 24 SSD heads of 64, state 128), 8
    steps at B=2, S=2048, the last loss below the first; hymba-1.5b at
    full width and depth (32 layers, 25/5 heads of 64 in a 1,024 window
    beside 50 SSD heads of 64, state 16), 5 steps at B=1, S=2048, finite
    losses; each with its breakdown. (4) gemma-7b at full width, 2 of its
    28 layers (16/16 heads of 256: the head_dim-256 backward), 5 steps at
    B=1, S=2048. (5) the launcher's ``train_reasoner`` with the
    reference's defaults (2 layers, d_model 128, head_dim 32, S=160; 300
    LM and 200 PRM steps) in a temp dir: the LM loss falls by at least
    20% (``tests/test_training.py``'s bar), the PRM loss is finite, lm.npz
    and prm.npz load back bit-equal with ``load_checkpoint(like=...)``,
    and K5's backward wrapper ran at the warm-up and the capture only.
    Returns the launches run on (1), (3) and (4)."""
    import tempfile

    from repro_torch.configs import smoke
    from repro_torch.data import DataConfig, prm_batches
    from repro_torch.kernels.flash_prefill import flash_prefill_bwd
    from repro_torch.launch.train import smoke_arch, train_reasoner
    from repro_torch.models import Model
    from repro_torch.training import (load_checkpoint, make_prm_step,
                                      train_prm_head)
    t_phase = time.perf_counter()
    tag = "train"
    r1 = _train_full_width(torch, tag, "r1-distill-14b", 8, batch=2,
                           seqlen=TRAIN_SEQLEN, steps=8, breakdown=True,
                           digest=True)
    check(r1["losses"][-1] < r1["losses"][0],
          f"{tag}: r1-distill-14b's loss did not fall: {r1['losses']}")
    del r1["step_obj"]           # its graph and pool
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prm = make_prm_step(r1["model_obj"], r1["params"])
    _, phist = train_prm_head(r1["model_obj"], r1["params"], prm_batches(
        DataConfig(batch_size=2, seq_len=TRAIN_SEQLEN)), 3, step_fn=prm)
    prm_s = time.perf_counter() - t0
    prm_launched = prm.launches_run()
    print(f"[{tag}] train_prm_head on the 14B's weights, 3 steps in "
          f"{prm_s:.2f} s: losses {[r['prm_loss'] for r in phist]}; "
          f"launches run {json.dumps(prm_launched)}; capture "
          f"{next(iter(prm.signatures.values())).capture_seconds:.3f} s")
    _check_train_graph(prm, 3, f"{tag}: train_prm_head")
    check(prm_launched == {"flash_prefill": 3 * r1["num_layers"]}
          and all(math.isfinite(r["prm_loss"]) for r in phist),
          f"{tag}: train_prm_head ran K5's backward or no forward")
    del r1["model_obj"], r1["params"], prm
    for arch, layers in (("r1-distill-14b", 2), ("mamba2-130m", 24)):
        _train_eager_vs_graph(torch, tag, arch, layers, batch=2,
                              seqlen=TRAIN_SEQLEN)
    counters = _train_counters()
    for arch in ("mamba2-130m", "hymba-1.5b"):
        for mod in counters.values():
            mod.launches = 0
        smoke_arch(arch, device=DEVICE)
        launched = _nonzero({k: mod.launches for k, mod in counters.items()})
        leaves = _n_leaves(Model(smoke(arch), device="cpu").init_params(
            torch.Generator().manual_seed(0)))
        want = _want_launches(smoke(arch), 1, leaves)
        print(f"[{tag}] smoke_arch({arch!r}) on the card (one eager step): "
              f"launches {json.dumps(launched)} (want {json.dumps(want)})")
        check(launched == want, f"{tag}: smoke_arch({arch!r}) launched "
                                f"{launched}, want {want}")
    ssm = _train_full_width(torch, tag, "mamba2-130m", 24, batch=2,
                            seqlen=TRAIN_SEQLEN, steps=8, breakdown=True)
    check(ssm["losses"][-1] < ssm["losses"][0],
          f"{tag}: mamba2-130m's loss did not fall: {ssm['losses']}")
    del ssm["model_obj"], ssm["params"], ssm["step_obj"]
    hybrid = _train_full_width(torch, tag, "hymba-1.5b", 32, batch=1,
                               seqlen=TRAIN_SEQLEN, steps=5, breakdown=True)
    del hybrid["model_obj"], hybrid["params"], hybrid["step_obj"]
    gemma = _train_full_width(torch, tag, "gemma-7b", 2, batch=1,
                              seqlen=TRAIN_SEQLEN, steps=5)
    del gemma["model_obj"], gemma["params"], gemma["step_obj"]
    gc.collect()
    torch.cuda.empty_cache()
    flash_prefill_bwd.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        params, head = train_reasoner(*REASONER_STEPS, out, 128, 2, 0,
                                      device=DEVICE)
        with open(Path(out) / "config.json") as f:
            conf = json.load(f)
        lm_back = load_checkpoint(str(Path(out) / "lm.npz"), like=params)
        prm_back = load_checkpoint(str(Path(out) / "prm.npz"), like=head)
    reasoner_s = time.perf_counter() - t0
    first, last = conf["history"][0]["loss"], conf["history"][-1]["loss"]
    prm_last = conf["prm_history"][-1]["prm_loss"]

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return a.dtype == b.dtype and a.device == b.device and \
            torch.equal(a.detach(), b)
    round_trip = same(params, lm_back) and same(head, prm_back)
    print(f"[{tag}] train_reasoner on the card: LM loss {first:.4f} -> "
          f"{last:.4f} ({(1 - last / first) * 100:.1f}% lower), PRM loss "
          f"{prm_last:.4f}, checkpoints round-trip bit-equal {round_trip}; "
          f"K5 backward wrapper calls {flash_prefill_bwd.launches} (2 "
          f"layers at the warm-up and the capture; the other "
          f"{REASONER_STEPS[0] - 2} steps replay); {reasoner_s:.1f} s")
    check(last < 0.8 * first, f"{tag}: train_reasoner's loss fell less "
                              f"than 20%: {first} -> {last}")
    check(math.isfinite(prm_last), f"{tag}: a non-finite PRM loss")
    check(round_trip, f"{tag}: lm.npz or prm.npz did not load back "
                      f"bit-equal")
    check(flash_prefill_bwd.launches == 2 * 2,
          f"{tag}: train_reasoner's K5 backward wrapper ran "
          f"{flash_prefill_bwd.launches} times, want 4 (warm-up and "
          f"capture of 2 layers)")
    print(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return {"flash_prefill_bwd": r1["launches"]["flash_prefill_bwd"],
            kernel_key("flash_prefill_bwd", WIDE):
                gemma["launches"]["flash_prefill_bwd"],
            "ssd_scan_bwd": ssm["launches"]["ssd_scan_bwd"],
            "ssd_scan_bwd_hymba": hybrid["launches"]["ssd_scan_bwd"],
            "adamw": r1["launches"]["adamw"],
            "adamw_mamba": ssm["launches"]["adamw"],
            "r1": {k: v for k, v in r1.items()
                   if k not in ("model_obj", "params")}}


def _param_digest(torch, params) -> str:
    """A digest of every param leaf's bits (a DTensor leaf's local
    shard), made on the card: per leaf, the int64 sums of its bit
    patterns and of them times (position mod 65521) + 1, in chunks of
    16 M elements (wrapping as int64 does), then sha256 over the leaves'
    shapes, dtypes and sums. Two trees with equal digests are equal to
    the bit but for a collision."""
    import hashlib

    from repro_torch.training.optimizer import tree_leaves
    h = hashlib.sha256()
    chunk = 1 << 24
    for t in tree_leaves(params):
        t = t.to_local() if hasattr(t, "to_local") else t
        bits = t.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[t.element_size()])
        s1 = torch.zeros((), dtype=torch.int64, device=t.device)
        s2 = torch.zeros_like(s1)
        for i in range(0, bits.numel(), chunk):
            c = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=t.device) % 65521 + 1
            s1 += c.sum()
            s2 += (c * w).sum()
        h.update(f"{tuple(t.shape)}:{t.dtype}:{int(s1)}:{int(s2)};".encode())
    return h.hexdigest()


DIST_PREFILL = 4096        # phase 15's prompt (B=1), then 8 decode steps
DIST_DECODE = 8


def _dist_train_r1(torch, tag: str, mesh, r1: dict) -> dict:
    """Phase 15 (1): ``build_step``'s train step of r1-distill-14b at full
    width and 8 of 48 layers on the 1 x 1 mesh, from phase 14's seed, its
    AdamW settings and its 8 batches (B=2, S=2048), through the step's
    ``TrainGraph``: every loss and grad norm, and the digest of every
    param leaf after step 8, equal to phase 14's (``r1``). Launches as
    phase 14's. Returns the run's line, the trained DTensor params under
    "params" and the model under "model"."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data import DataConfig, padded_batches
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.training import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import to_batch
    gc.collect()
    torch.cuda.empty_cache()
    _, model, params = _train_model(torch, "r1-distill-14b", 8)
    cfg, steps = model.cfg, len(r1["losses"])
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    step, _ = build_step(cfg, ShapeSpec("phase15", TRAIN_SEQLEN, 2, "train"),
                         mesh, dtype=model.dtype, opt_cfg=opt_cfg)
    params, = step.shard(params)
    leaves = _n_leaves(params)
    opt = init_opt_state(params)
    data = padded_batches(DataConfig(batch_size=2, seq_len=TRAIN_SEQLEN))
    counters = _train_counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recs, stamps, comm = [], [], {}
    t0 = time.perf_counter()
    for i in range(steps):
        toks, labels, mask = next(data)
        _, _, batch = step.shard(None, None, to_batch(
            {"tokens": toks, "labels": labels, "mask": mask}, DEVICE))
        with CommDebugMode() if i == 0 else contextlib.nullcontext() as cm:
            _, _, m = step(params, opt, batch)
        if i == 0:
            comm = {"total": cm.get_total_counts(),
                    "by_op": {str(k): v for k, v in
                              cm.get_comm_counts().items()}}
        recs.append({k: float(v) for k, v in m.items()})
        stamps.append(time.perf_counter())
    called = _nonzero({k: mod.launches for k, mod in counters.items()})
    graph = step.fn
    launched = graph.launches_run()
    step_s = np.diff([t0] + stamps)
    p50 = float(np.median(step_s[2:]))
    digest = _param_digest(torch, params)
    line = {"model": cfg.name, "num_layers": cfg.num_layers,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "losses": [r["loss"] for r in recs],
            "grad_norms": [r["grad_norm"] for r in recs],
            "losses_equal": [r["loss"] for r in recs] == r1["losses"],
            "grad_norms_equal":
                [r["grad_norm"] for r in recs] == r1["grad_norms"],
            "digest": digest, "digest_equal": digest == r1["digest"],
            "step_ms_p50": p50 * 1e3,
            "unsharded_step_ms_p50": r1["step_ms_p50"],
            "ratio": p50 * 1e3 / r1["step_ms_p50"],
            "p50_over": "replayed steps 3 on",
            "warmup_step_s": float(step_s[0]),
            "capture_s": next(iter(graph.signatures.values())
                              ).capture_seconds,
            "collectives_warmup_step": comm,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "captures": graph.captures, "replays": graph.replays,
            "launches": launched, "wrapper_calls": called}
    print(f"[{tag}] " + json.dumps(line))
    check(line["losses_equal"] and line["grad_norms_equal"],
          f"{tag}: the sharded step's losses or grad norms differ from "
          f"phase 14's: {line['losses']} {line['grad_norms']} against "
          f"{r1['losses']} {r1['grad_norms']}")
    check(line["digest_equal"], f"{tag}: the params after the sharded "
                                f"steps differ from phase 14's (digest)")
    _check_train_graph(graph, steps, f"{tag}: {cfg.name}")
    want = _want_launches(cfg, steps, leaves)
    check(launched == want, f"{tag}: {cfg.name} ran {launched}, want {want}")
    check(called == _want_launches(cfg, 2, leaves),
          f"{tag}: {cfg.name}'s wrappers ran {called} times")
    del opt, step, graph
    gc.collect()
    torch.cuda.empty_cache()
    return dict(line, params=params, model=model)


def _dist_prefill_serve(torch, tag: str, mesh, model, params) -> dict:
    """Phase 15 (3): ``build_step``'s prefill step of the 14B (B=1, a
    4,096-token prompt, K5 once a layer) and ``DIST_DECODE`` calls of its
    serve step on the prefill's cache, against ``Model.prefill`` and
    ``Model.decode_step`` on the same weights (the DTensors' local
    tensors): logits bit-equal at every call, and the caches too."""
    from repro_torch.distributed.sharding import local_tree
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_step
    cfg = model.cfg
    plain = local_tree(params)
    gen = torch.Generator(DEVICE).manual_seed(15)
    toks = torch.randint(0, cfg.vocab_size, (1, DIST_PREFILL + DIST_DECODE),
                         generator=gen, device=DEVICE)
    max_len = DIST_PREFILL + DIST_DECODE
    with torch.no_grad():
        ref_logits, ref_cache = model.prefill(
            plain, tokens=toks[:, :DIST_PREFILL], max_len=max_len)
        pre, _ = build_step(cfg, ShapeSpec("phase15", max_len, 1, "prefill"),
                            mesh, dtype=model.dtype)
        dec, _ = build_step(cfg, ShapeSpec("phase15", max_len, 1, "decode"),
                            mesh, dtype=model.dtype)
        _, batch = pre.shard(None, {"tokens": toks[:, :DIST_PREFILL]})
        flash_prefill.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pre(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        k5 = flash_prefill.launches
        same = [torch.equal(logits.full_tensor(), ref_logits)]
        for i in range(DIST_DECODE):
            tok = toks[:, DIST_PREFILL + i]
            pos = torch.full((1,), DIST_PREFILL + i, dtype=torch.long,
                             device=DEVICE)
            ref, ref_cache, _ = model.decode_step(plain, tok, ref_cache, pos)
            _, _, t_d, p_d = dec.shard(None, None, tok, pos)
            out, cache, _ = dec(params, cache, t_d, p_d)
            same.append(torch.equal(out.full_tensor(), ref))
        cache_same = all(torch.equal(cache[k].full_tensor(), ref_cache[k])
                         for k in ref_cache)
    line = {"prefill_tokens": DIST_PREFILL, "decode_steps": DIST_DECODE,
            "logits_equal": same, "cache_equal": cache_same,
            "prefill_s": prefill_s, "k5_launches": k5,
            "cache_placements": {k: str(tuple(v.placements))
                                 for k, v in cache.items()}}
    print(f"[{tag}] prefill and serve steps " + json.dumps(line))
    check(all(same) and cache_same, f"{tag}: the sharded prefill or serve "
                                    f"logits (or cache) differ: {same}")
    check(k5 == cfg.num_layers, f"{tag}: the prefill step launched K5 {k5} "
                                f"times, want {cfg.num_layers}")
    return {"flash_prefill": k5}


def _dist_train_pair(torch, tag: str, mesh, arch: str, num_layers: int, *,
                     steps: int = 3) -> dict:
    """Phase 15 (2): ``arch`` at full width, ``steps`` steps of the
    unsharded train graph, then of ``build_step``'s train step on the 1 x
    1 mesh, from the same seed and batches (B=2, S=2048): losses, grad
    norms and every param bit-equal; both graphs launch
    ``_want_launches``."""
    from repro_torch.data import DataConfig, padded_batches
    from repro_torch.distributed.sharding import local_tree
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import to_batch
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    runs = {}
    for mode in ("unsharded", "sharded"):
        gc.collect()
        torch.cuda.empty_cache()
        _, model, params = _train_model(torch, arch, num_layers)
        if mode == "unsharded":
            graph = step = make_train_step(model, opt_cfg)
        else:
            step, _ = build_step(model.cfg, ShapeSpec(
                "phase15", TRAIN_SEQLEN, 2, "train"), mesh,
                dtype=model.dtype, opt_cfg=opt_cfg)
            graph = step.fn
            params, = step.shard(params)
        opt = init_opt_state(params)
        data = padded_batches(DataConfig(batch_size=2, seq_len=TRAIN_SEQLEN))
        metrics = []
        for _ in range(steps):
            toks, labels, mask = next(data)
            batch = to_batch({"tokens": toks, "labels": labels,
                              "mask": mask}, DEVICE)
            if mode == "sharded":
                batch = step.shard(None, None, batch)[2]
            _, _, m = step(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        _check_train_graph(graph, steps, f"{tag}: {arch} {mode}")
        runs[mode] = (metrics, local_tree(params), graph.launches_run())
        del opt, step, graph
    (m_u, p_u, l_u), (m_s, p_s, l_s) = runs["unsharded"], runs["sharded"]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p_u),
                                                 tree_leaves(p_s)))
    want = _want_launches(model.cfg, steps, _n_leaves(p_u))
    line = {"model": model.cfg.name, "num_layers": num_layers,
            "losses": [m["loss"] for m in m_s],
            "metrics_equal": m_u == m_s, "params_equal": same,
            "launches_unsharded": l_u, "launches_sharded": l_s}
    print(f"[{tag}] unsharded vs sharded " + json.dumps(line))
    check(m_u == m_s and same, f"{tag}: {arch}'s sharded steps differ from "
                               f"its unsharded steps")
    check(l_u == want and l_s == want,
          f"{tag}: {arch} launched {l_u} / {l_s}, want {want}")
    del runs, p_u, p_s
    return l_s


def _dist_moe_prefill(torch, tag: str, mesh) -> dict:
    """Phase 15 (4): the smoke qwen3-moe-235b-a22b's prefill step with
    ``moe_dp=2`` (the shard-local dispatch: two groups, each with its own
    capacity), fp32, on the card against the same step's dispatch on the
    CPU (``Model.prefill`` under ``activation_rules(None, {"_moe_dp":
    2})``), from the same weights and tokens: logits within atol 1e-4."""
    from repro_torch.configs import smoke
    from repro_torch.distributed.logical import activation_rules
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import Model
    cfg = smoke("qwen3-moe-235b-a22b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        with activation_rules(None, {"_moe_dp": 2}):
            ref, _ = cpu.prefill(params, tokens=toks, max_len=64)
        pre, _ = build_step(cfg, ShapeSpec("phase15", 64, 4, "prefill"),
                            mesh, dtype=torch.float32, moe_dp=2)
        p_d, batch = pre.shard(_to(params, DEVICE),
                               {"tokens": toks.to(DEVICE)})
        logits, _ = pre(p_d, batch)
        err = float((logits.full_tensor().cpu() - ref).abs().max())
    line = {"model": cfg.name, "moe_dp": 2, "batch": 4, "seqlen": 64,
            "max_abs_err": err, "scale": float(ref.abs().max()),
            "atol": 1e-4}
    print(f"[{tag}] shard-local MoE prefill, card vs CPU " + json.dumps(line))
    check(math.isfinite(err) and err <= 1e-4,
          f"{tag}: the shard-local MoE prefill differs from the CPU's by "
          f"{err}")
    return line


def phase_distributed(torch, r1: dict) -> dict:
    """Phase 15: the distribution layer (``launch/steps.py:build_step``
    over a ``DeviceMesh`` of DTensors) on a 1 x 1 ``("data", "model")``
    mesh on the card; the process group is NCCL, world size 1, on an
    in-process ``HashStore`` (no network). (1) r1-distill-14b's sharded
    train step (``_dist_train_r1``), bit-equal to phase 14; (2)
    mamba2-130m at full width and depth, 3 steps, bit-equal to the
    unsharded train graph; (3) the 14B's prefill and serve steps,
    bit-equal to ``Model.prefill``/``decode_step``; (4) the smoke MoE's
    shard-local prefill against the CPU. K4, K5, their backwards and
    AdamW run on the DTensors' local shards. Returns the launches the
    phase ran, by kernel (checked exact in each part)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    t_phase = time.perf_counter()
    tag = "dist"
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), DEVICE)
        line = _dist_train_r1(torch, tag, mesh, r1)
        model, params = line.pop("model"), line.pop("params")
        print(f"[{tag}] sharded train step p50 {line['step_ms_p50']:.2f} ms "
              f"beside phase 14's {r1['step_ms_p50']:.2f} ms: ratio "
              f"{line['ratio']:.4f}; collectives in the warm-up step "
              f"{json.dumps(line['collectives_warmup_step'])}; peak "
              f"{line['peak_mem_gb']:.2f} GB")
        launches = dict(line["launches"])
        _add_counts(launches, _dist_prefill_serve(torch, tag, mesh, model,
                                                  params))
        del model, params
        _add_counts(launches, _dist_train_pair(torch, tag, mesh,
                                               "mamba2-130m", 24))
        _dist_moe_prefill(torch, tag, mesh)
    finally:
        dist.destroy_process_group()
    print(f"[{tag}] launches run {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


GUARD = 1024                 # elements of each guard region (phase 16)
INT_GUARD = 2 ** 30          # an int guard: a page far past any pool


def grid_lookup_us(torch, n: int = 100_000) -> dict:
    """The host time a serve-path wrapper spends on its grids per call:
    its grid function's cached lookup at a serve shape of phase 3 plus
    ``grid_args``, in microseconds (the best of 5 ``timeit`` rounds of
    ``n`` calls). Host only: no card needed."""
    import timeit
    from repro_torch.kernels import introspect as ix
    from repro_torch.kernels.flash_prefill import flash_prefill as k5
    from repro_torch.kernels.flash_prefill import paged_prefill as k2
    from repro_torch.kernels.paged_attention import paged_attention as k1
    from repro_torch.kernels.paged_attention import tree_decode as k3
    from repro_torch.kernels.ssd_scan import ssd_scan as k4
    bf = torch.bfloat16
    lookups = {   # r1-distill-14b's heads and pages; mamba2-130m's scan
        "paged_decode": lambda: k1.paged_attention_grid(
            16, 40, 128, 8, 4097, 16, 32, bf),
        "paged_prefill": lambda: k2.paged_prefill_grid(
            64, 40, 128, 8, 4097, 16, 32, bf, 1),
        "paged_tree_shared": lambda: k3.paged_tree_shared_grid(
            16, 40, 128, 8, 4097, 16, 16, 32, bf),
        "paged_tree_branch": lambda: k3.paged_tree_branch_grid(
            16, 40, 128, 8, 4097, 16, 32, bf, 16, 16, 32),
        "ssd_scan": lambda: k4.ssd_scan_grid(
            1, 2048, 24, 64, 128, 256, bf, False, False),
        "flash_prefill": lambda: k5.flash_prefill_grid(
            1, 4096, 40, 128, 8, bf, 132, False),
    }
    out = {}
    for name, lookup in lookups.items():
        def call(lookup=lookup):
            return ix.grid_args(lookup())
        call()
        out[name] = min(timeit.repeat(call, number=n, repeat=5)) / n * 1e6
    return out


def _verifier_refusals(torch) -> int:
    """Each serve-path launcher (the top-p sampler's too) and the two
    backwards' launchers, both routes, called once through its wrapper
    with its grid function's first grid off by one in x: the launcher
    must refuse it (RuntimeError from
    ``build.raise_on_error``) and the wrapper must count no launch. Returns
    the refusals."""
    import dataclasses
    from repro_torch.kernels import introspect as ix
    from repro_torch.kernels.flash_prefill import flash_prefill as k5
    from repro_torch.kernels.flash_prefill import flash_prefill_bwd as k5b
    from repro_torch.kernels.flash_prefill import paged_prefill as k2
    from repro_torch.kernels.launches import launch_counts
    from repro_torch.kernels.paged_attention import paged_attention as k1
    from repro_torch.kernels.paged_attention import tree_decode as k3
    from repro_torch.kernels.sampling import sample_top_p as sampler
    from repro_torch.kernels.ssd_scan import ssd_scan as k4
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd as k4b
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(16)

    def off_by_one(fn):
        def wrong(*a, **kw):
            good = fn(*a, **kw)
            first = dataclasses.replace(good[0], grid=(
                good[0].grid[0] + 1,) + tuple(good[0].grid[1:]))
            return ix.Launches((first,) + tuple(good[1:]))
        return wrong

    refused = 0
    for dtype in (torch.bfloat16, torch.float32):
        def f(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        def i32(*shape, v=0):
            return torch.full(shape, v, dtype=torch.int32, device=dev)
        q, kp, vp = f(3, 8, 128), f(2, 16, 16, 128), f(2, 16, 16, 128)
        bt, ln = i32(3, 8), i32(3, v=20)
        part, keys = k3.paged_tree_shared_fwd(q, kp, vp, i32(3), bt,
                                              i32(3, v=16), ln)
        calls = [
            (k1, "paged_attention_grid",
             lambda: k1.paged_attention_decode(q, kp, vp, bt, ln)),
            (k2, "paged_prefill_grid",
             lambda: k2.paged_flash_prefill_lanes_fwd(
                 f(16, 8, 128), kp, vp, i32(16, 8), i32(16),
                 i32(2, v=5), (8, 8))),
            (k3, "paged_tree_shared_grid",
             lambda: k3.paged_tree_shared_fwd(q, kp, vp, i32(3), bt,
                                              i32(3, v=16), ln)),
            (k3, "paged_tree_branch_grid",
             lambda: k3.paged_tree_branch_fwd(q, kp, vp, i32(3),
                                              i32(3, v=16), bt, ln, part,
                                              keys)),
            (k4, "ssd_scan_grid",
             lambda: k4.ssd_scan(f(2, 16, 2, 64), torch.rand(
                 2, 16, 2, device=dev), -torch.rand(2, device=dev),
                 f(2, 16, 2, 16), f(2, 16, 2, 16), chunk=8)),
            (k5, "flash_prefill_grid",
             lambda: k5.flash_prefill(f(1, 100, 8, 128), f(1, 100, 2, 128),
                                      f(1, 100, 2, 128))),
        ]
        q5, k5_, v5 = f(1, 100, 8, 128), f(1, 100, 2, 128), f(1, 100, 2, 128)
        o5, lse5 = k5.flash_prefill_lse(q5, k5_, v5)
        x4, dt4, a4 = f(2, 16, 2, 64), torch.rand(2, 16, 2, device=dev), \
            -torch.rand(2, device=dev)
        b4, c4 = f(2, 16, 2, 16), f(2, 16, 2, 16)
        st4 = k4.ssd_scan_states(x4, dt4, a4, b4, c4, chunk=8)[2]
        calls += [
            (k5b, "flash_prefill_bwd_grid",
             lambda: k5b.flash_prefill_bwd(q5, k5_, v5, o5, lse5, o5)),
            (k4b, "ssd_scan_bwd_grid",
             lambda: k4b.ssd_scan_bwd(x4, dt4, a4, b4, c4, st4, x4,
                                      chunk=8)),
            (sampler, "sample_top_p_grid",
             lambda: sampler.sample_top_p(
                 f(3, 1000), 0.9, 0.95,
                 torch.zeros(3, dtype=torch.int64, device=dev))),
        ]
        for mod, name, call in calls:
            call()                      # the true grid launches
            torch.cuda.synchronize()
            real = getattr(mod, name)
            setattr(mod, name, off_by_one(real))
            before = launch_counts()
            try:
                call()
            except RuntimeError as exc:
                check("CUDA launch failed" in str(exc),
                      f"{name} ({dtype}): unexpected error {exc}")
                refused += 1
            else:
                fail(f"{name} ({dtype}): the launcher took a grid off by "
                     "one")
            finally:
                setattr(mod, name, real)
            check(launch_counts() == before,
                  f"{name} ({dtype}): a refused launch was counted")
            torch.cuda.synchronize()
    return refused


def _guarded(torch, dev, buffers):
    """An ``alloc(shape, dtype)`` for ``calls.make_inputs``: each tensor a
    view between two guard regions of GUARD elements (NaN, or INT_GUARD
    for ints) of a larger buffer, kept in ``buffers``."""
    def alloc(shape, dtype):
        n = math.prod(shape)
        buf = torch.empty(n + 2 * GUARD, dtype=dtype, device=dev)
        buf.fill_(float("nan") if dtype.is_floating_point else INT_GUARD)
        buffers.append((buf, n))
        return buf[GUARD:GUARD + n].view(shape)
    return alloc


def _guards_intact(torch, buffers) -> bool:
    for buf, n in buffers:
        for g in (buf[:GUARD], buf[GUARD + n:]):
            ok = (torch.isnan(g).all() if buf.dtype.is_floating_point
                  else (g == INT_GUARD).all())
            if not bool(ok):
                return False
    return True


def _verifier_lattice(torch) -> dict:
    """Every STEP007 lattice case, both routes, head_dim 128, on its
    kernel between NaN guards, held to the plain version. Returns counts
    and the largest error per route."""
    from repro_torch.stepcheck import bounds, calls
    dev = torch.device(DEVICE)
    stats = {"cases": 0, "max_abs_err": {}}
    for lg, cases in bounds.engine_lattice(head_dims=(128,)):
        tol = (1e-4 if lg.kernel == "ssd_scan" and lg.route == "fp32"
               else TOL[lg.route])
        for case in cases:
            buffers: list = []
            x = calls.make_inputs(lg, case, dev,
                                  torch.Generator().manual_seed(16),
                                  _guarded(torch, dev, buffers))
            got = calls.run_kernel(lg, case, x)
            torch.cuda.synchronize()
            want = calls.run_plain(lg, case, {
                k: v.float() if v.is_floating_point() else v
                for k, v in x.items()})
            rows = calls.compared_rows(lg, x)
            what = f"{lg.kernel} {lg.route} kv={bounds.kv_regime(lg)} " \
                   f"{case.name}"
            for name, ref in want.items():
                out = got[name].float()
                if rows is not None and rows[0] == name:
                    out, ref = out[:, rows[1]], ref[:, rows[1]]
                check(bool(torch.isfinite(out).all()),
                      f"{what}: NaN or inf in {name} (a guard was read?)")
                check(torch.allclose(out, ref, atol=tol, rtol=tol),
                      f"{what}: {name} disagrees with the plain version "
                      f"({(out - ref).abs().max().item():.3g})")
                zero = (ref == 0).all(-1)      # rows of the last dim
                check(bool((out[zero] == 0).all()),
                      f"{what}: {name} rows the plain version zeroes are "
                      "not exact zeros")
                err = (out - ref).abs().max().item() if out.numel() else 0.0
                stats["max_abs_err"][lg.route] = max(
                    stats["max_abs_err"].get(lg.route, 0.0), err)
            check(_guards_intact(torch, buffers),
                  f"{what}: a guard region was written")
            stats["cases"] += 1
    return stats


def _verifier_examples(torch) -> dict:
    """The examples at smoke size on the card, in-process: the quickstart,
    then train -> serve (and the four-policy comparison) over one
    checkpoint in a temp dir. Returns each one's seconds."""
    import importlib.util
    import io
    import tempfile
    examples = Path(__file__).resolve().parent / "examples"

    def run(name, *argv):
        spec = importlib.util.spec_from_file_location(
            name, examples / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(list(argv))
        check(rc == 0, f"{name} exited {rc}")
        return out.getvalue(), time.perf_counter() - t0

    secs = {}
    out, secs["quickstart"] = run("torch_quickstart", "--requests", "2",
                                  "--max-tokens", "16")
    check("all KV pages released" in out, "quickstart: pages leaked")
    with tempfile.TemporaryDirectory() as ckpt:
        out, secs["train"] = run("torch_train_tiny_reasoner", "--steps",
                                 "4", "--prm-steps", "2", "--eval-problems",
                                 "2", "--out", ckpt)
        check("[eval] greedy accuracy" in out, "train: no eval line")
        out, secs["serve"] = run("torch_serve_reasoning", "--requests", "2",
                                 "--n", "2", "--max-tokens", "16", "--ckpt",
                                 ckpt)
        served = json.loads(out)
        check(served["completed_requests"] == 2,
              f"serve over the trained checkpoint: {served}")
        out, secs["sart_vs_baselines"] = run(
            "torch_sart_vs_baselines", "--requests", "1", "--n", "2",
            "--max-tokens", "8", "--ckpt", ckpt)
        check([l.split()[0] for l in out.splitlines()[1:]]
              == ["vanilla", "sc", "rebase", "sart"],
              f"sart_vs_baselines: {out}")
    return secs


def phase_verifiers(torch) -> dict:
    """Phase 16: the launchers' grid check, STEP007's lattice between NaN
    guards and the examples, on the card."""
    t0 = time.perf_counter()
    refused = _verifier_refusals(torch)
    check(refused == 18, f"{refused} of 18 launcher calls refused a wrong "
                         f"grid")
    t1 = time.perf_counter()
    lattice = _verifier_lattice(torch)
    t2 = time.perf_counter()
    examples = _verifier_examples(torch)
    t3 = time.perf_counter()
    line = {"refused_off_by_one": refused, "lattice": lattice,
            "examples_s": examples, "grid_lookup_us": grid_lookup_us(torch),
            "seconds": {
                "refusals": t1 - t0, "lattice": t2 - t1,
                "examples": t3 - t2, "phase": t3 - t0}}
    print(f"[verifiers] {json.dumps(line)}")
    return line


def _add_counts(into: dict, counts: dict) -> None:
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n


def _step_seconds(since: float) -> list:
    """The wall seconds of each decode step that started at or after
    ``since`` (``time.perf_counter``), sorted: the durations of the
    tracer's ``engine.decode_step`` spans."""
    from repro_torch import spans
    snap = spans.snapshot()
    # records go in the order they open: a record dropped since ``since``
    # leaves the oldest one kept opening after it
    check(snap["dropped"] == 0 or snap["t0_ns"][0] < since * 1e9,
          f"the tracer's ring dropped {snap['dropped']} records, some of "
          "them steps to be timed")
    keep = (snap["name"] == "engine.decode_step") & (
        snap["t0_ns"] >= since * 1e9) & (snap["t1_ns"] >= 0)
    return sorted(((snap["t1_ns"] - snap["t0_ns"])[keep] / 1e9).tolist())


def _step_stats(engine, wall: float, since: float) -> dict:
    steps = _step_seconds(since)
    return {"decode_steps": engine.decode_steps_executed, "wall_s": wall,
            "step_ms_p50": steps[len(steps) // 2] * 1e3,
            "step_ms_mean": sum(steps) * 1e3 / len(steps)}


def phase_profile(torch, out_dir: Path) -> None:
    """Phase 5's traffic (4 requests, n=8, 96 tokens, temperature 0.9) on
    r1-distill-14b, on mamba2-130m (phase 8), on qwen3-moe-235b-a22b at
    8 of its 94 layers (phase 10) and on gemma-7b (phase 12), each served
    eagerly
    (``Engine.eager()``) and through the step graphs: per mode one plain
    serve, for step times (the graph run captures its variants), then the
    same engine again, its graphs captured, under torch.profiler tracing
    device activity only, with the tracer off (no host ops and no spans,
    so the trace adds little to the host side), for device time by
    kernel, the device's busy share of that run's own wall time and the
    device kernels per decode step. The
    tables go to
    ``out_dir/profile_serve[_ssm|_moe|_gemma]_{eager,graphs}.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    out_dir.mkdir(parents=True, exist_ok=True)
    for arch, stem, layers in (("r1-distill-14b", "profile_serve", 0),
                               ("mamba2-130m", "profile_serve_ssm", 0),
                               ("qwen3-moe-235b-a22b", "profile_serve_moe",
                                8),
                               ("gemma-7b", "profile_serve_gemma", 0)):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
        params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
        for mode in ("eager", "graphs"):
            gc.collect()
            torch.cuda.empty_cache()
            eager = mode == "eager"
            engine, sch = _serve_setup(torch, model, params,
                                       shared_header=False)
            with engine.eager() if eager else contextlib.nullcontext():
                t0 = time.perf_counter()
                sch.run(max_steps=2_000_000)
                torch.cuda.synchronize()
                plain = _step_stats(engine, time.perf_counter() - t0, t0)
                plain["graphs"] = _graph_stats(engine)
                steps0 = engine.decode_steps_executed
                replays0 = engine.graph_replays
                # (no name for the engine returned again: a name left
                # bound would keep this model alive into the next one's)
                sch = _serve_setup(torch, model, params,
                                   shared_header=False, engine=engine)[1]
                spans.disable()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    sch.run(max_steps=2_000_000)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                spans.enable(marks=False)
            traced = {"decode_steps": engine.decode_steps_executed - steps0,
                      "wall_s": wall,
                      "graph_replays": engine.graph_replays - replays0}
            events = prof.key_averages()
            device = [e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation]
            # one stream, so kernels never overlap and their sum is busy
            device_us = sum(e.self_device_time_total for e in device)
            traced["device_busy_s"] = device_us / 1e6
            traced["device_busy_share"] = device_us / 1e6 / wall
            traced["device_ops_per_step"] = (
                sum(e.count for e in device) / traced["decode_steps"])
            traced["device_ms_per_step"] = (
                device_us / 1e3 / traced["decode_steps"])
            # the port's kernels per step by the engine's count (both runs)
            traced["port_launches_per_step"] = (
                sum(engine.step_launches().values())
                / engine.decode_steps_executed)
            table = events.table(sort_by="self_device_time_total",
                                 row_limit=30, max_name_column_width=90)
            (out_dir / f"{stem}_{mode}.txt").write_text(table)
            print(table)
            print("[profile] " + json.dumps({"model": arch, "mode": mode,
                                             "untraced": plain,
                                             "traced": traced}))
            # the port's own kernels, wherever they rank in the table
            ours = {e.key: {"launches": e.count,
                            "self_device_ms": e.self_device_time_total / 1e3,
                            "us_each": e.self_device_time_total / e.count}
                    for e in device if any(k in e.key for k in PORT_KERNELS)}
            print("[profile-kernels] " + json.dumps(
                {"model": arch, "mode": mode, "kernels": ours}))
            del engine, sch, prof, events, device
        del model, params


def _marks_toy(torch) -> dict:
    """Two marked intervals (a matmul each, the second twice the first's
    work) recorded eagerly, then captured into a graph with the same
    marks and replayed: each interval's replayed time against its eager
    time."""
    from repro_torch import spans
    gen = torch.Generator(DEVICE).manual_seed(0)
    a = torch.randn(4096, 4096, device=DEVICE, dtype=torch.bfloat16,
                    generator=gen)
    out = torch.empty_like(a)
    marks = spans.DeviceMarks()

    def body():
        spans.device_mark("dense")
        torch.matmul(a, a, out=out)
        spans.device_mark("attention")
        torch.matmul(out, a, out=out)
        torch.matmul(out, a, out=out)
        spans.device_mark(spans.END)

    eager = []
    for _ in range(5):
        with spans.armed(marks):
            body()
        torch.cuda.synchronize()
        eager.append(marks.elapsed_ms())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), spans.armed(marks):
        body()
    replayed = []
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        replayed.append(marks.elapsed_ms())
    e = np.median(np.stack(eager), 0)[:2]
    r = np.median(np.stack(replayed), 0)[:2]
    check(len(marks.events) == 3, f"{len(marks.events)} marks, 3 expected")
    check(bool(np.all(np.abs(r - e) <= 0.25 * e)),
          f"replayed marks {r.tolist()} ms, eager {e.tolist()} ms")
    check(1.5 < r[1] / r[0] < 2.5, f"intervals {r.tolist()} ms: the second "
          "is two matmuls of the first's size")
    return {"eager_ms": e.tolist(), "replayed_ms": r.tolist()}


def phase_spans(torch) -> dict:
    """Phase 17: the tracer's device marks on the card (see the module's
    docstring). Leaves the tracer on with ``marks=False``."""
    from repro_torch import spans
    from repro_torch.configs import smoke
    from repro_torch.models import Model
    t0 = time.perf_counter()
    line = {"toy": _marks_toy(torch)}
    for tag, arch, kinds in (
            ("dense", "r1-distill-14b", {"dense", "attention", "head"}),
            ("moe", "qwen3-moe-235b-a22b",
             {"dense", "attention", "head", "moe_route", "moe_experts"})):
        cfg = smoke(arch)
        model = Model(cfg, dtype=torch.bfloat16, device=DEVICE)
        params = model.init_params(torch.Generator(DEVICE).manual_seed(0))
        # off at capture: no marks; on: every replayed step gets a row
        spans.enable(marks=False)
        engine, sch = _serve_setup(torch, model, params, shared_header=False,
                                   num_requests=2, max_tokens=24)
        sch.run(max_steps=2_000_000)
        check(all(g.marks is None for g in engine.step_graphs.values()),
              f"{tag}: a graph captured with the tracer off holds marks")
        spans.enable()
        engine, sch = _serve_setup(torch, model, params, shared_header=False,
                                   num_requests=2, max_tokens=24)
        sch.run(max_steps=2_000_000)
        torch.cuda.synchronize()
        steps_graphs = engine.decode_steps_executed
        sch = _serve_setup(torch, model, params, shared_header=False,
                           engine=engine, num_requests=1, max_tokens=8)[1]
        with engine.eager():
            sch.run(max_steps=2_000_000)
        snap = spans.snapshot()
        dev = snap["device"]
        step = snap["name"] == "engine.decode_step"
        wall_ms = dict(zip(snap["seq"][step].tolist(),
                           ((snap["t1_ns"] - snap["t0_ns"])[step]
                            / 1e6).tolist()))
        got = {k for k, col in zip(dev["kinds"], dev["ms"].T)
               if np.all(col > 0)}
        total = dev["ms"].sum(1)
        check(len(dev["seq"]) == steps_graphs == engine.graph_replays,
              f"{tag}: {len(dev['seq'])} device rows, {steps_graphs} "
              f"graph steps, {engine.graph_replays} replays")
        check(got == kinds, f"{tag}: kinds timed every step {sorted(got)}, "
                            f"expected {sorted(kinds)}")
        check(all(0 < t < wall_ms[s] for s, t in zip(dev["seq"].tolist(),
                                                     total.tolist())),
              f"{tag}: a step's marked device time is not under its wall "
              "time")
        line[tag] = {
            "steps": steps_graphs,
            "marks": {n: len(g.marks.events)
                      for n, g in engine.step_graphs.items()
                      if g.marks is not None},
            "device_ms_by_kind": dict(zip(dev["kinds"],
                                          dev["ms"].mean(0).tolist())),
            "step_wall_ms_mean": float(np.mean(list(wall_ms.values())))}
        del engine, sch, model, params
        gc.collect()
        torch.cuda.empty_cache()
    spans.enable(marks=False)
    line["seconds"] = time.perf_counter() - t0
    print(f"[spans] {json.dumps(line)}")
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel checks (prints no result)")
    ap.add_argument("--profile", metavar="DIR",
                    help="profile the serve phases' traffic (r1-distill-14b"
                         ", mamba2-130m, qwen3-moe-235b-a22b at 8 layers, "
                         "gemma-7b) "
                         "instead of the checks, writing "
                         "the tables under DIR (prints no result)")
    ap.add_argument("--tree-pairs", type=int, metavar="N",
                    help="serve phase 6's traffic in N alternating "
                         "tree/paged pairs instead of the checks (prints "
                         "no result)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the repo's src/repro_torch is not beside {__file__}")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import spans
    spans.enable(marks=False)       # the serve phases' step times

    smi = phase_device(torch)
    phase_build()
    if args.profile:
        phase_profile(torch, Path(args.profile))
        return 0
    if args.tree_pairs:
        phase_tree_pairs(torch, args.tree_pairs)
        return 0
    errs, timing = phase_kernels(torch)
    tree_errs, tree_timing = phase_tree_kernels(torch)
    errs.update(tree_errs)
    timing.update(tree_timing)
    ssd_errs, ssd_timing = phase_ssd_kernels(torch)
    errs.update(ssd_errs)
    timing.update(ssd_timing)
    flash_errs, flash_timing, flash_4096 = phase_flash_kernels(torch)
    errs.update(flash_errs)
    timing.update(flash_timing)
    print("[kernels] K5 at S=4096: " + json.dumps(flash_4096))
    bwd_errs, bwd_timing = phase_flash_bwd_kernels(torch)
    errs.update(bwd_errs)
    timing.update(bwd_timing)
    ssd_bwd_errs, ssd_bwd_timing = phase_ssd_bwd_kernels(torch)
    errs.update(ssd_bwd_errs)
    timing.update(ssd_bwd_timing)
    adamw_errs, adamw_timing = phase_adamw_kernel(torch)
    errs.update(adamw_errs)
    timing.update(adamw_timing)
    sampler = phase_sampler_kernel(torch)
    errs["sample_top_p"] = [0.0]          # bit-equal, checked in the phase
    timing["sample_top_p"] = dict(sampler["rows320_x1.5"], ops=0,
                                  library_ms=None, shapes=sampler)
    if args.skip_serve:
        print(json.dumps(timing))
        return 0
    phase_parity(torch)
    model, params, launches = phase_serve(torch)
    # K1 and K2 count phase 5's run, the K3 passes phase 6's, K5 phase 7's
    tree_run, paged_p50 = phase_tree_serve(torch, model, params)
    for name in ("paged_tree_shared", "paged_tree_branch"):
        launches[name] = tree_run[name]
    launches["flash_prefill"] = phase_exact_serve(
        torch, model, params, paged_p50)["launches"]["flash_prefill"]
    # phase 13 on the same weights: the serve path under a fault plan
    chaos = phase_chaos(torch, model, params)
    del model, params
    launches["ssd_scan"] = phase_ssm_serve(torch)["ssd_scan"]
    phase_graphs(torch)
    # phases 10-11: the MoE, vlm and audio families at full width
    moe_line = phase_family_serve(torch, "serve-moe", "qwen3-moe-235b-a22b",
                                  8)
    for arch, layers in (("qwen2-vl-72b", 8), ("musicgen-medium", 0)):
        phase_family_serve(torch, "serve-family", arch, layers, n=4,
                           num_requests=2, max_tokens=48)
    # phase 12: gemma-7b at full width and depth, the head_dim-256 kernels
    launches.update(phase_gemma_serve(torch))
    # phase 14: the training path through graphs, K5's and K4's backward
    # and the fused AdamW
    train = phase_train(torch)
    for name in ("flash_prefill_bwd", kernel_key("flash_prefill_bwd", WIDE),
                 "ssd_scan_bwd", "adamw"):
        launches[name] = train[name]
    # phase 15: the sharded steps on a 1 x 1 DeviceMesh, K4, K5, their
    # backwards and AdamW on the DTensors' local shards
    sharded = phase_distributed(torch, train["r1"])
    # phase 16: the launchers' grid check, STEP007 on the card, examples
    phase_verifiers(torch)
    # phase 17: the tracer's device marks in captured graphs
    phase_spans(torch)

    sdpa = ("scaled_dot_product_attention over pre-gathered contiguous "
            "K/V (a yardstick; the port never calls it)")
    attn_tol = "atol=rtol=2e-2 bf16, 1e-5 fp32"
    meta = {
        "paged_decode": ("src/repro_torch/csrc/paged_decode_mma.cuh",
                         "src/repro/kernels/paged_attention/"
                         "paged_attention.py:144", attn_tol, sdpa),
        "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/flash_prefill/"
                          "paged_prefill.py:176", attn_tol, sdpa),
        "paged_tree_shared": ("src/repro_torch/csrc/paged_tree_decode.cu",
                              "src/repro/kernels/paged_attention/"
                              "tree_decode.py:170", attn_tol, sdpa),
        "paged_tree_branch": ("src/repro_torch/csrc/paged_decode_mma.cuh",
                              "src/repro/kernels/paged_attention/"
                              "tree_decode.py:229", attn_tol, sdpa),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/ssd_scan.py:117",
                     "atol=rtol=2e-2 bf16, 1e-4 fp32 (against the plain "
                     "version in fp32); all-invalid rows bit-exact",
                     "none: no single PyTorch call computes the SSD scan"),
        "flash_prefill": ("src/repro_torch/csrc/flash_prefill_sm90.cu",
                          "src/repro/kernels/flash_prefill/"
                          "flash_prefill.py:144", attn_tol + " (bf16: the "
                          "wgmma kernel, timed; fp32: the CUDA-core kernel "
                          "of flash_prefill.cu); rows past true_len "
                          "bit-exact zeros",
                          "scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True) on the same q, k, v (a "
                          "yardstick; the port never calls it)"),
    }
    meta["flash_prefill_bwd"] = (
        "src/repro_torch/csrc/flash_prefill_bwd.cu",
        "src/repro/models/attention.py:70 (no Pallas backward: XLA's "
        "autodiff of _attend, the gradient of "
        "src/repro/kernels/flash_prefill/flash_prefill.py:144)",
        f"max error / max |plain gradient| <= {BWD_TOL['bf16']} bf16 "
        f"(wgmma; P and dS rounded to bf16), {BWD_TOL['fp32']} fp32 "
        f"(CUDA cores); bit-repeatable; the forward with its LSE "
        f"bit-equal to the forward without",
        "torch.autograd.grad of scaled_dot_product_attention(is_causal="
        "True, enable_gqa=True) on the same q, k, v, dout, forward not "
        "timed (a yardstick; the port never calls it)")
    meta["ssd_scan_bwd"] = (
        "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "src/repro/models/mamba2.py:42 (no Pallas backward: XLA's "
        "autodiff of ssd_chunked, the gradient of "
        "src/repro/kernels/ssd_scan/ssd_scan.py:117)",
        f"max error / max |plain gradient| <= {BWD_TOL['bf16']} bf16 "
        f"(mma.sync; G, W, exp(cs) dY and the states rounded to bf16), "
        f"{BWD_TOL['fp32']} fp32 (CUDA cores); bit-repeatable; the forward "
        f"with its chunk states bit-equal to the forward without",
        "none: no single PyTorch call computes the SSD scan's gradient")
    meta["adamw"] = (
        "src/repro_torch/csrc/adamw.cu",
        "src/repro/training/optimizer.py:46 (no Pallas kernel: XLA fuses "
        "adamw_update inside the jitted train step, "
        "src/repro/training/train_loop.py:54)",
        "bit-equal (0 ulp) to the plain loop body on p, mu and nu",
        "torch.optim.AdamW(fused=True).step() over the same bf16 leaves "
        "and gradients (its moments bf16; decoupled decay, no clip): a "
        "yardstick the port never calls")
    meta["sample_top_p"] = (
        "src/repro_torch/csrc/sample_top_p.cu",
        "none in the JAX package: jnp ops in its jitted step "
        "(src/repro/serving/sampling.py:45); the port's sort-based "
        "sampling (serving/sampling.py, plain_ms)",
        "bit-equal to kernels/sampling/ref.py (tokens and thresholds)",
        "none: no single PyTorch call samples top-p")
    # the head_dim-256 instantiations (gemma-7b, phases 12 and 14): rows
    # of their own, timed at gemma-7b's serve (training) shapes
    meta.update({kernel_key(name, WIDE): meta[name] for name in
                 ("paged_decode", "paged_prefill", "paged_tree_shared",
                  "paged_tree_branch", "flash_prefill",
                  "flash_prefill_bwd")})
    kernels = []
    for name, (source, replaces, tol, library) in meta.items():
        tm = timing[name]
        b_ms, b_by = bound(tm["bytes"], tm["ops"], tm.get("ops_dtype",
                                                          "bf16"))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name]), "tolerance": tol,
            "ms": tm["ms"], "queued_ms": tm["queued_ms"],
            "host_us": tm["host_us"],
            "plain_ms": tm["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tm["library_ms"],
            "library": library, "timed_shape": tm["shape"], "card": smi,
            **{key: tm[k] for k, key in (("long", "long_context"),
                                         ("long_few_rows",
                                          "long_context_few_rows"),
                                         ("header_chunk", "header_chunk"),
                                         ("moe_serve",
                                          "qwen3_moe_serve_shape"),
                                         ("S4096", "S4096"),
                                         ("shapes", "timed_shapes"))
               if k in tm},
        })
        if moe_line["launches"].get(name):
            kernels[-1]["launches_qwen3_moe"] = moe_line["launches"][name]
        if chaos.get(name):
            kernels[-1]["launches_chaos"] = chaos[name]
        if name in sharded:
            kernels[-1]["launches_sharded"] = sharded[name]
        if name == "adamw":
            kernels[-1]["launches_mamba"] = train["adamw_mamba"]
        if name == "ssd_scan_bwd":
            kernels[-1]["launches_hymba"] = train["ssd_scan_bwd_hymba"]
            kernels[-1]["plain_autograd_ms"] = tm["plain_autograd_ms"]
    for k in kernels:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")
                  ) and (k["library_ms"] is None
                         or math.isfinite(k["library_ms"])),
              f"non-finite timing for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(f"[total] {time.perf_counter() - T_START:.1f} s from the start "
          "of the script")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
