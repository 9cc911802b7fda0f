"""Continuous-batching serving engine over the paged KV cache (dense path).

Counterpart of ``repro.serving.engine``: the substrate the SART scheduler
drives. A fixed ``max_slots`` decode batch holds one branch per slot;
prompts are admitted chunk by chunk as extra rows ("lanes") of the same
decode step; page accounting and copy-on-write run on the host in
``repro_torch.kv.PageAllocator``. Each step runs eagerly on the engine's
device: a Python loop over layers in place of ``jax.lax.scan``, the
paged flash-decode (kernel K1) for every decode row and the paged
flash-prefill (kernel K2) once per chunk lane, as the reference's
``mixed_step_kernel="fused"`` default.

Differences from the reference that a reader must know:

  * **Dropped writes land on a spare page.** PyTorch has no
    ``.at[...].set(mode="drop")``, so the K/V pools are
    ``[L, kv, num_pages + 1, ps, hd]``, zero-initialised, and the
    sentinel ``num_pages`` indexes the spare page. The CoW of a sentinel
    pair, the pad rows' K/V and every write through a sentinel block
    table entry go there; no kernel reads it inside a row's length.
  * **In-place updates, reference order.** The step CoWs first, then for
    each layer writes every row's K/V before any row attends, so a
    chunk's own keys are visible to K2, as ``engine.py:1069-1170``.
  * **One host sync per step**, the sampled tokens. The step's index
    arrays are built on the host in numpy and copied to the device once.
  * **Families and options of later slices raise** in ``__init__``:
    ssm/hybrid, MoE, M-RoPE and sinusoidal positions, the prefix cache,
    ``decode_kernel="tree"`` and ``chunked_prefill=False``.
  * **Randomness** comes from one ``torch.Generator`` on the device,
    seeded from ``EngineConfig.seed``; greedy sampling matches the
    reference token for token, stochastic sampling only in distribution.

Public contracts kept from the reference: non-blocking admission
(``begin_prefill`` reserves the prompt's pages up front, failing fast
with ``OutOfPagesError``), harvested ownership (``abort_prefill`` on a
harvested state only detaches it), bounded step shapes (``step_variants``
and ``prefill_compile_count``), inert rows never perturb state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.flash_prefill.ops import paged_flash_prefill
from ..kernels.paged_attention.ops import paged_attention
from ..kv import BranchBlocks, OutOfPagesError, PageAllocator
from ..models.attention import _project_qkv, _rotate
from ..models.layers import apply_mlp, apply_norm, embed_tokens, unembed
from ..models.model import Model
from .sampling import SamplingParams, sample


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    page_size: int = 16
    num_pages: int = 512
    max_slots: int = 16              # decode batch size B
    max_pages_per_branch: int = 64   # static block-table width
    max_branch_tokens: int = 512     # hard length cap per branch
    eos_id: int = 1
    sampling: SamplingParams = SamplingParams(temperature=1.0, top_p=0.95)
    seed: int = 0
    # Chunked prefill: prompts are split into ``prefill_chunk``-token
    # chunks, each padded up to one of ``prefill_buckets`` and run as extra
    # rows of the decode step. () derives buckets as (chunk // 2, chunk).
    # ``False`` (the exact-length path) is not ported yet and raises.
    chunked_prefill: bool = True
    prefill_chunk: int = 64
    prefill_buckets: tuple = ()
    # Chunk-row attention path of the mixed step. "fused" runs each lane's
    # rows as one paged flash-prefill pass (kernel K2) over the request's
    # block table; "decode" re-uses the per-token flash-decode (kernel K1)
    # for every chunk row, kept for equivalence testing.
    mixed_step_kernel: str = "fused"
    # Decode-slot attention path. Only "paged" (kernel K1) is ported;
    # "tree" raises.
    decode_kernel: str = "paged"
    # Token-budget lane scheduling: a mixed step carries up to
    # ``step_token_budget`` chunk-row tokens drawn from several in-flight
    # prefills (one lane per request, all lanes padded to one shared
    # bucket). 0 keeps the single-lane FIFO. Must be >= the largest prefill
    # bucket when set.
    step_token_budget: int = 0
    # Allowed lane counts per mixed step; the packer rounds the number of
    # selected lanes down to the nearest entry. () derives powers of two up
    # to step_token_budget // max_bucket.
    chunk_lane_configs: tuple = ()
    # A pending prefill skipped by the packer more than this many times
    # blocks packing past it (bounded overtaking).
    prefill_starvation_bound: int = 4
    # Radix prefix cache: not ported yet, ``True`` raises.
    prefix_cache: bool = False


@dataclasses.dataclass(eq=False)    # identity equality: the admission
# queue holds several states at once and `in`/`remove` must never confuse
# two requests that happen to share a prompt
class ChunkedPrefillState:
    """A partially-prefilled request: pages fill chunk-by-chunk while the
    decode batch keeps stepping. ``done`` flips once the final chunk has
    been written and the last-position logits are available for
    ``spawn_branch``. ``harvested`` flips in ``finish_prefill`` — from
    then on the pages belong to the caller and ``abort_prefill`` must not
    release them."""
    prompt: List[int]
    blocks: BranchBlocks
    next_pos: int = 0                # prompt tokens written so far
    last_logits: object = None
    done: bool = False
    harvested: bool = False
    passed_over: int = 0             # consecutive packer skips (starvation)

    @property
    def remaining(self) -> int:
        """Prompt tokens still to prefill (0 once the state is done)."""
        return len(self.prompt) - self.next_pos


def pack_chunk_lanes(pending: List[ChunkedPrefillState], *, budget: int,
                     chunk_bucket: Callable[[ChunkedPrefillState], int],
                     lane_configs: Sequence[int], starvation_bound: int):
    """Select which pending prefills contribute a chunk lane to the next
    mixed step (a copy of ``repro.serving.engine.pack_chunk_lanes``).

    Token-budget packing: walk the admission queue oldest-first, adding one
    lane per request while the padded row count — ``shared_bucket x
    n_lanes`` — fits ``budget``. All selected lanes pad to ONE shared
    bucket and the lane count is rounded down to the nearest entry of
    ``lane_configs``. A request whose chunk would overflow the remaining
    budget is skipped, but each skip increments its ``passed_over``
    counter, and once that reaches ``starvation_bound`` the packer refuses
    to pack anything behind it. ``budget <= 0`` is the single-lane FIFO.

    Returns ``(selected, bucket)``.
    """
    if not pending:
        return [], 0
    if budget <= 0:
        st = pending[0]
        st.passed_over = 0
        return [st], chunk_bucket(st)
    max_lanes = max(lane_configs)
    selected: List[ChunkedPrefillState] = []
    shared = 0
    for st in pending:
        if len(selected) == max_lanes:
            break
        b = max(shared, chunk_bucket(st))
        if b * (len(selected) + 1) <= budget:
            selected.append(st)
            shared = b
        elif st.passed_over >= starvation_bound:
            break                     # nothing may overtake a starved lane
        else:
            st.passed_over += 1
    n = max((c for c in lane_configs if c <= len(selected)), default=0)
    for st in selected[n:]:           # rounded off this step: counts as a skip
        st.passed_over += 1
    selected = selected[:n]
    for st in selected:
        st.passed_over = 0
    bucket = max((chunk_bucket(st) for st in selected), default=0)
    return selected, bucket


def derive_lane_configs(configs: Sequence[int], budget: int,
                        max_bucket: int) -> tuple:
    """Resolve the allowed per-step lane counts for a token budget (a copy
    of the reference's): explicit ``configs`` must contain 1; the default
    is powers of two up to ``budget // max_bucket`` plus that maximum."""
    if 0 < budget < max_bucket:
        raise ValueError(
            f"step_token_budget={budget} cannot carry even one full "
            f"prefill bucket of {max_bucket} tokens")
    max_lanes = max(budget // max_bucket, 1) if budget > 0 else 1
    if configs:
        lanes = tuple(sorted(set(int(c) for c in configs)))
        if not lanes or lanes[0] != 1:
            raise ValueError(
                f"chunk_lane_configs {configs} must include 1: the packer "
                "rounds lane counts down to an allowed configuration")
        if lanes[-1] > max_lanes:
            raise ValueError(
                f"chunk_lane_configs {configs} exceed the "
                f"{max_lanes} lane(s) step_token_budget={budget} can "
                f"carry at bucket {max_bucket}")
        return lanes
    lanes, c = {1, max_lanes}, 1
    while c < max_lanes:
        c = min(c * 2, max_lanes)
        lanes.add(c)
    return tuple(sorted(lanes))


@dataclasses.dataclass
class BranchHandle:
    branch_id: int
    request_id: int
    slot: int
    blocks: BranchBlocks
    tokens: List[int]                # generated tokens (after the prompt)
    prompt_len: int
    done: bool = False
    last_reward: float = 0.0
    scored: bool = False              # has the PRM ever scored this branch?


@dataclasses.dataclass(frozen=True)
class StepVariant:
    """One reachable step shape: ``"decode"`` or ``"mixed:b{bucket}x
    l{lanes}"``; ``lane_buckets`` (each lane's padded row count) selects
    it — the shape set a later slice captures as CUDA graphs."""

    name: str
    lane_buckets: Tuple[int, ...]


def _layer_slices(layers: dict, num_layers: int) -> List[dict]:
    """Per-layer views of the stacked ``[L, ...]`` params (no copies)."""
    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [pick(layers, i) for i in range(num_layers)]


class Engine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 prm_params: Optional[dict] = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        mc = model.cfg
        for later, what in ((mc.uses_ssm, f"{mc.arch_type} layers"),
                            (mc.uses_moe, "MoE layers"),
                            (mc.pos_embedding in ("mrope", "sinusoidal"),
                             f"{mc.pos_embedding} positions"),
                            (cfg.prefix_cache, "the prefix cache"),
                            (cfg.decode_kernel == "tree",
                             "decode_kernel='tree'"),
                            (not cfg.chunked_prefill,
                             "exact-length prefill (chunked_prefill=False)")):
            if later:
                raise NotImplementedError(f"{what}: not ported yet")
        assert not mc.sliding_window, \
            "paged engine serves full-attention configs"
        assert cfg.mixed_step_kernel in ("fused", "decode"), \
            cfg.mixed_step_kernel
        assert cfg.decode_kernel == "paged", cfg.decode_kernel
        self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._next_branch_id = 0

        B, L = cfg.max_slots, mc.num_layers
        kv, hd = mc.num_kv_heads, mc.resolved_head_dim
        # one spare page past the pool takes every dropped write
        shape = (L, kv, cfg.num_pages + 1, cfg.page_size, hd)
        self.state: Dict[str, torch.Tensor] = {
            "k_pages": torch.zeros(shape, dtype=model.dtype,
                                   device=self.device),
            "v_pages": torch.zeros(shape, dtype=model.dtype,
                                   device=self.device)}
        self._layers = _layer_slices(params["layers"], L)

        # host-side per-slot bookkeeping
        self.slots: List[Optional[BranchHandle]] = [None] * B
        self._tokens = np.zeros((B,), np.int32)
        self._positions = np.zeros((B,), np.int32)
        self._block_tables = np.full((B, cfg.max_pages_per_branch),
                                     cfg.num_pages, np.int32)  # OOB sentinel
        self._lengths = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._last_hidden = torch.zeros((B, mc.d_model), dtype=model.dtype,
                                        device=self.device)
        self.prm_params = prm_params

        self.decode_steps_executed = 0
        self.prefill_chunk_steps = 0
        self.mixed_steps_executed = 0     # decode steps carrying >= 1 lane
        self.tokens_generated = 0         # decode-row tokens sampled
        self.step_seconds: List[float] = []  # host wall time per decode_step

        buckets = tuple(sorted(set(cfg.prefill_buckets))) or tuple(sorted(
            {max(cfg.prefill_chunk // 2, 1), cfg.prefill_chunk}))
        if buckets[-1] < cfg.prefill_chunk:
            raise ValueError(
                f"largest prefill bucket {buckets[-1]} must cover a full "
                f"prefill_chunk of {cfg.prefill_chunk} tokens — otherwise "
                "chunk rows would alias (see Engine._bucket_for)")
        self._buckets = buckets
        self._buckets_used: set = set()   # (bucket, n_lanes) shapes run
        self._pending_prefills: List[ChunkedPrefillState] = []
        self._lane_configs = derive_lane_configs(
            cfg.chunk_lane_configs, cfg.step_token_budget, buckets[-1])

    # ------------------------------------------------------------------ util
    @property
    def free_slots(self) -> List[int]:
        """Unoccupied decode-slot indices, ascending."""
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def num_active(self) -> int:
        """Occupied decode slots."""
        return int(self._active.sum())

    def live_tokens(self) -> int:
        """Total tokens currently resident in the KV pool."""
        return sum(s.blocks.length for s in self.slots if s is not None)

    # --------------------------------------------------------------- prefill
    def prefill(self, prompt: List[int], exact: Optional[bool] = None):
        """Run prefill for one request to completion (synchronous
        convenience API) through the chunked path. Returns (prefix_blocks,
        last_logits, None). The prefix pages are NOT yet shared — call
        ``spawn_branch`` N times to fork branches off them."""
        if exact:
            raise NotImplementedError("exact-length prefill: not ported yet")
        st = self._new_chunked_state(prompt)
        while not st.done:
            self._advance_chunks([st], piggyback=False)
        return st.blocks, st.last_logits, None

    def _check_prompt_width(self, s: int) -> None:
        assert self.allocator.pages_for(max(s, 1)) <= \
            self.cfg.max_pages_per_branch, "prompt exceeds block-table width"

    def _new_chunked_state(self, prompt: List[int]) -> ChunkedPrefillState:
        """Allocate a prompt's pages (all-or-nothing) and wrap them in a
        chunked state that starts at position 0."""
        self._check_prompt_width(len(prompt))
        blocks = self.allocator.alloc_prefix(len(prompt))
        return ChunkedPrefillState(prompt=list(prompt), blocks=blocks)

    def begin_prefill(self, prompt: List[int]) -> ChunkedPrefillState:
        """Admit a request without stalling decode. The returned state is
        queued and its prompt chunks piggyback on subsequent
        ``decode_step`` calls; poll ``state.done`` and harvest with
        ``finish_prefill``. Raises OutOfPagesError (allocating nothing)
        when the KV pool cannot hold the prompt."""
        st = self._new_chunked_state(prompt)
        self._pending_prefills.append(st)
        return st

    def finish_prefill(self, st: ChunkedPrefillState):
        """Harvest a completed prefill: (prefix_blocks, last_logits, None —
        no SSM state on the dense path). Ownership of the pages passes to
        the caller."""
        assert st.done, "prefill still has pending chunks"
        st.harvested = True
        return st.blocks, st.last_logits, None

    def abort_prefill(self, st: ChunkedPrefillState) -> None:
        """Drop a queued prefill and release its pages. A state already
        harvested no longer owns its pages, so aborting it only detaches
        it from the queue."""
        if st in self._pending_prefills:
            self._pending_prefills.remove(st)
        if not st.harvested:
            self.allocator.release(st.blocks)
        st.done = True

    @property
    def has_pending_prefill(self) -> bool:
        """True while any admitted prompt still has chunks to run."""
        return bool(self._pending_prefills)

    def prefix_cache_stats(self) -> Optional[Dict]:
        """None: the prefix cache is not ported yet (always off)."""
        return None

    def match_cached_tokens(self, prompt: List[int]) -> int:
        """0: no prompt token is served from a cache (cache off)."""
        return 0

    @property
    def prefill_compile_count(self) -> int:
        """Distinct mixed-step chunk shapes run so far — (bucket,
        lane-count) pairs, O(num_buckets x num_lane_configs)."""
        return len(self._buckets_used)

    def step_variants(self) -> List[StepVariant]:
        """Every step shape this engine can dispatch: the pure-decode
        shape plus one mixed shape per (bucket, lane-count) pair."""
        variants = [StepVariant("decode", ())]
        for bucket in self._buckets:
            for n in self._lane_configs:
                variants.append(StepVariant(f"mixed:b{bucket}xl{n}",
                                            (bucket,) * n))
        return variants

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        raise ValueError(
            f"chunk of {n} tokens exceeds the largest prefill bucket "
            f"{self._buckets[-1]}; configure prefill_buckets to cover "
            f"prefill_chunk={self.cfg.prefill_chunk}")

    def _chunk_bucket(self, st: ChunkedPrefillState) -> int:
        return self._bucket_for(min(self.cfg.prefill_chunk, st.remaining))

    def _pack_lanes(self):
        """One packer call per decode step (it mutates the starvation
        counters of skipped states)."""
        return pack_chunk_lanes(
            self._pending_prefills, budget=self.cfg.step_token_budget,
            chunk_bucket=self._chunk_bucket,
            lane_configs=self._lane_configs,
            starvation_bound=self.cfg.prefill_starvation_bound)

    @property
    def admission_capacity(self) -> int:
        """Max prefills worth keeping in flight: the packer can serve at
        most this many chunk lanes per mixed step."""
        return self._lane_configs[-1]

    def _chunk_inputs(self, st: ChunkedPrefillState, bucket: int):
        """One lane's extra step rows for the next chunk of ``st``, padded
        to ``bucket``: (tokens, positions, block tables, lengths,
        chunk_len). Rows past the chunk's true length shadow the last
        valid row so their indices stay in range; the step routes their
        K/V writes to the spare page and K2 gives them exact zeros."""
        cfg = self.cfg
        s = len(st.prompt)
        chunk_len = min(cfg.prefill_chunk, s - st.next_pos)
        idx = np.minimum(st.next_pos + np.arange(bucket), s - 1)
        tokens = np.asarray(st.prompt, np.int32)[idx]
        row = np.full((cfg.max_pages_per_branch,), cfg.num_pages, np.int32)
        row[:len(st.blocks.pages)] = st.blocks.pages
        block_tables = np.broadcast_to(row, (bucket, row.shape[0]))
        # row i covers positions 0..next_pos+i inclusive
        return (tokens, idx.astype(np.int32), block_tables,
                idx.astype(np.int32), chunk_len)

    def _advance_chunks(self, sts: List[ChunkedPrefillState],
                        piggyback: bool, bucket: int = 0,
                        cows: Sequence[tuple] = ()):
        """Run one chunk of each state in ``sts`` through the step as
        concurrent lanes. With ``piggyback`` the caller (``decode_step``)
        supplies the live decode rows plus the step's CoW page copies;
        standalone draining pads with inert rows (sentinel block tables
        send their page writes to the spare page)."""
        cfg = self.cfg
        B = cfg.max_slots
        if not bucket:
            bucket = max(self._chunk_bucket(st) for st in sts)
        lanes = [self._chunk_inputs(st, bucket) for st in sts]
        chunk_lens = [ln[4] for ln in lanes]
        if piggyback:
            d_tokens, d_positions = self._tokens, self._positions
            d_bt, d_lengths = self._block_tables, self._lengths
        else:
            d_tokens = np.zeros((B,), np.int32)
            d_positions = np.zeros((B,), np.int32)
            d_bt = np.full((B, cfg.max_pages_per_branch), cfg.num_pages,
                           np.int32)
            d_lengths = np.zeros((B,), np.int32)
        lane_buckets = (bucket,) * len(sts)
        self._buckets_used.add((bucket, len(sts)))
        next_tokens, hidden, logits = self._step(
            np.concatenate([d_tokens] + [ln[0] for ln in lanes]),
            np.concatenate([d_positions] + [ln[1] for ln in lanes]),
            np.concatenate([d_bt] + [ln[2] for ln in lanes]),
            np.concatenate([d_lengths] + [ln[3] for ln in lanes]),
            lane_buckets, chunk_lens, [st.next_pos for st in sts], cows)
        self.prefill_chunk_steps += len(sts)
        self.mixed_steps_executed += 1
        for i, st in enumerate(sts):
            cl = chunk_lens[i]
            st.next_pos += cl
            if st.next_pos >= len(st.prompt):
                st.done = True
                st.last_logits = logits[B + i * bucket + cl - 1]
                if st in self._pending_prefills:
                    self._pending_prefills.remove(st)
        return next_tokens, hidden

    # --------------------------------------------------------------- branches
    def spawn_branch(self, request_id: int, prefix_blocks: BranchBlocks,
                     last_logits, ssm_state, prompt_len: int,
                     first_fork: bool = False,
                     prompt_tokens: Optional[List[int]] = None
                     ) -> Optional[BranchHandle]:
        """Fork one branch off a prefilled prefix and seat it in a free
        slot, sampling its own first token from the prefill logits.
        Returns None if no slot is free (caller queues the branch).
        ``ssm_state``, ``first_fork`` and ``prompt_tokens`` (the prefix
        cache's key) keep the reference's signature; the dense path
        without a cache does not use them."""
        free = self.free_slots
        if not free:
            return None
        slot = free[0]
        blocks = self.allocator.fork(prefix_blocks)
        first = int(sample(self._gen, last_logits, self.cfg.sampling))
        handle = BranchHandle(
            branch_id=self._next_branch_id, request_id=request_id, slot=slot,
            blocks=blocks, tokens=[first], prompt_len=prompt_len)
        self._next_branch_id += 1
        self.slots[slot] = handle
        self._seat(handle)
        return handle

    def _seat(self, h: BranchHandle):
        """Load a branch's host-side decode state into its slot row."""
        slot = h.slot
        self._tokens[slot] = h.tokens[-1]
        self._positions[slot] = h.blocks.length  # next write position
        self._refresh_block_table(h)
        self._lengths[slot] = h.blocks.length
        self._active[slot] = True

    def _refresh_block_table(self, h: BranchHandle):
        row = np.full((self.cfg.max_pages_per_branch,), self.cfg.num_pages,
                      np.int32)
        assert len(h.blocks.pages) <= self.cfg.max_pages_per_branch, \
            "branch exceeded max_pages_per_branch"
        row[:len(h.blocks.pages)] = h.blocks.pages
        self._block_tables[h.slot] = row

    def fork_branch(self, parent: BranchHandle) -> Optional[BranchHandle]:
        """Mid-generation fork (Rebase tree expansion): the child shares
        all of the parent's pages (CoW on next append)."""
        free = self.free_slots
        if not free:
            return None
        slot = free[0]
        blocks = self.allocator.fork(parent.blocks)
        handle = BranchHandle(
            branch_id=self._next_branch_id, request_id=parent.request_id,
            slot=slot, blocks=blocks, tokens=list(parent.tokens),
            prompt_len=parent.prompt_len)
        self._next_branch_id += 1
        self.slots[slot] = handle
        self._seat(handle)
        return handle

    def suspend_branch(self, h: BranchHandle) -> None:
        """Vacate a branch's slot while KEEPING its pages, so it can be
        reseated later via ``resume_branch``."""
        assert self.slots[h.slot] is h
        slot = h.slot
        self.slots[slot] = None
        self._active[slot] = False
        self._block_tables[slot] = self.cfg.num_pages
        self._lengths[slot] = 0
        h.slot = -1

    def resume_branch(self, h: BranchHandle) -> bool:
        """Reseat a suspended branch. Returns False when no slot is free."""
        free = self.free_slots
        if not free:
            return False
        h.slot = free[0]
        self.slots[h.slot] = h
        self._seat(h)
        return True

    def pages_needed_for_step(self) -> int:
        """Pages the next decode step will allocate (boundary + CoW)."""
        ps = self.cfg.page_size
        need = 0
        for h in self.slots:
            if h is None:
                continue
            b = h.blocks
            if self.allocator.needs_cow(b):
                need += 1
            if b.length % ps == 0 and b.length // ps == len(b.pages):
                need += 1
        return need

    def free_branch(self, h: BranchHandle):
        """Release a branch's slot and eagerly free its pages."""
        self.allocator.release(h.blocks)
        slot = h.slot
        if slot >= 0:                 # suspended branches hold no slot
            self.slots[slot] = None
            self._active[slot] = False
            self._block_tables[slot] = self.cfg.num_pages
            self._lengths[slot] = 0
        h.done = True

    def release_prefix(self, prefix_blocks: BranchBlocks):
        """Drop the scheduler's own reference to a request's prefix."""
        self.allocator.release(prefix_blocks)

    # ----------------------------------------------------------------- decode
    def _cow_arrays(self, cows: Sequence[tuple]):
        """A step's (old, new) CoW page pairs as two int32 arrays, in slot
        order (each decode slot CoWs at most once per step)."""
        src = np.asarray([old for old, _ in cows], np.int32)
        dst = np.asarray([new for _, new in cows], np.int32)
        return src, dst

    def _step(self, tokens: np.ndarray, positions: np.ndarray,
              block_tables: np.ndarray, lengths: np.ndarray,
              lane_buckets: tuple = (), chunk_lens: Sequence[int] = (),
              lane_pos0: Sequence[int] = (), cows: Sequence[tuple] = ()):
        """One batched token step (the reference's ``_step_fn``), generic
        in row count and lane count.

        Rows 0..max_slots-1 are the decode slots; extra rows are the
        step's prefill chunk lanes — ``lane_buckets`` gives each lane's
        padded row count, ``chunk_lens[i]`` its true chunk length and
        ``lane_pos0[i]`` the absolute position of its first row (host
        ints, so the lanes' K2 launches need no device sync). Order, as
        the reference: CoW copies, then per layer norm -> QKV -> RoPE ->
        K/V page writes of every row -> attention (K1 for the decode rows,
        K2 once per lane with the "fused" kernel) -> wo -> MLP; then the
        final norm, unembed and sampling. Returns (next_tokens [rows]
        int32, hidden [rows, D], logits [rows, V]), all on the device.
        """
        mc, cfg, p = self.model.cfg, self.cfg, self.params
        B, nS = tokens.shape[0], cfg.max_slots
        ps, w = cfg.page_size, cfg.max_pages_per_branch
        lane_off = list(np.cumsum((nS,) + tuple(lane_buckets))[:-1])
        # host-side index math: the page and slot each row writes; pad rows
        # of a lane (past its chunk length) write to the spare page
        col = np.minimum(positions // ps, w - 1)
        page_of = block_tables[np.arange(B), col]
        if B > nS:
            write_ok = np.concatenate(
                [np.ones((nS,), bool)]
                + [np.arange(bk) < chunk_lens[i]
                   for i, bk in enumerate(lane_buckets)])
            page_of = np.where(write_ok, page_of, cfg.num_pages)
        cow_src, cow_dst = self._cow_arrays(cows)
        host = np.concatenate([tokens, positions, page_of, positions % ps,
                               lengths + 1, block_tables.reshape(-1),
                               cow_src, cow_dst]).astype(np.int32)
        dev = torch.from_numpy(host).to(self.device)
        tok_d, pos_d, page_d, slot_d, len_d = dev[:5 * B].view(5, B)
        bt_d = dev[5 * B:5 * B + B * w].view(B, w)
        kp_all, vp_all = self.state["k_pages"], self.state["v_pages"]
        if cows:
            # CoW before any write (in place on the pools)
            nc = len(cows)
            src = dev[5 * B + B * w:5 * B + B * w + nc].long()
            dst = dev[5 * B + B * w + nc:].long()
            kp_all[:, :, dst] = kp_all[:, :, src]
            vp_all[:, :, dst] = vp_all[:, :, src]
        page_i, slot_i = page_d.long(), slot_d.long()
        fused_chunk = B > nS and cfg.mixed_step_kernel == "fused"

        x = embed_tokens(mc, p["embed"], tok_d[:, None])      # [B, 1, D]
        for layer, lp in enumerate(self._layers):
            kp, vp = kp_all[layer], vp_all[layer]   # [kv, P + 1, ps, hd]
            h = apply_norm(mc, lp["norm1"], x)
            q, k, v = _project_qkv(mc, lp["attn"], h)
            q, k = _rotate(mc, q, k, pos_d[:, None])
            # every row's K/V lands before any row attends
            kp[:, page_i, slot_i] = k[:, 0].transpose(0, 1)
            vp[:, page_i, slot_i] = v[:, 0].transpose(0, 1)
            q = q[:, 0]                                        # [B, H, hd]
            if fused_chunk:
                parts = [paged_attention(q[:nS], kp, vp, bt_d[:nS],
                                         len_d[:nS])]
                for i, bk in enumerate(lane_buckets):
                    o = lane_off[i]
                    parts.append(paged_flash_prefill(
                        q[o:o + bk], kp, vp, bt_d[o], lane_pos0[i],
                        chunk_lens[i]))
                att = torch.cat(parts, 0)
            else:
                # decode rows, or the mixed_step_kernel="decode" fallback:
                # every row through the per-token flash-decode
                att = paged_attention(q, kp, vp, bt_d, len_d)
            x = x + att.reshape(B, 1, -1) @ lp["attn"]["wo"]
            if mc.d_ff:
                x = x + apply_mlp(mc, lp["mlp"], apply_norm(mc, lp["norm2"],
                                                            x))
        x = apply_norm(mc, p["final_norm"], x)
        hidden = x[:, 0]
        logits = unembed(mc, p["embed"], hidden)
        next_tokens = sample(self._gen, logits, cfg.sampling)
        return next_tokens, hidden, logits

    def decode_step(self) -> Dict[int, int]:
        """One decode step for all active slots, piggybacking up to
        ``step_token_budget`` chunk-row tokens of pending prefills as
        concurrent lanes (mixed step) — one FIFO chunk when the budget is
        unset. Page accounting (boundary alloc + CoW) runs on the host
        *before* the step; the sampled token is then appended to each
        active branch. Returns {slot: new_token}."""
        cfg = self.cfg
        if not self._active.any() and not self._pending_prefills:
            return {}
        t0 = time.perf_counter()
        cap = cfg.max_pages_per_branch * cfg.page_size
        for h in self.slots:
            if h is not None and h.blocks.length + 1 > cap:
                # static block table full: surface as memory pressure so
                # the scheduler's evict-longest path force-completes it
                raise OutOfPagesError(
                    "branch at block-table capacity "
                    f"({cap} tokens)")
        if self.pages_needed_for_step() > self.allocator.free_pages:
            raise OutOfPagesError(
                "decode step needs more pages than are free")
        cows = []
        # the pages_needed_for_step pre-check above reserves this loop's
        # worst case, so append_token cannot raise mid-way
        for h in self.slots:
            if h is None:
                continue
            cow = self.allocator.append_token(h.blocks)  # reprolint: disable=REP002
            if cow is not None:
                cows.append(cow)
            self._refresh_block_table(h)

        # pack only after the page accounting above: an OutOfPagesError
        # abort must not charge skipped prefills' starvation counters
        lanes, bucket = self._pack_lanes()
        if lanes:
            next_tokens, hidden = self._advance_chunks(
                lanes, piggyback=True, bucket=bucket, cows=cows)
        else:
            next_tokens, hidden, _ = self._step(
                self._tokens, self._positions, self._block_tables,
                self._lengths, cows=cows)
        self._last_hidden = hidden[:cfg.max_slots]
        self.decode_steps_executed += 1

        out: Dict[int, int] = {}
        # the one sync per step: sampled tokens drive host-side branch
        # bookkeeping (EOS detection, page accounting) before the next
        # step can be built
        toks = next_tokens.tolist()  # reprolint: disable=REP005
        for slot, h in enumerate(self.slots):
            if h is None:
                continue
            tok = toks[slot]
            h.tokens.append(tok)
            out[slot] = tok
            self._tokens[slot] = tok
            self._positions[slot] += 1
            self._lengths[slot] += 1
        self.tokens_generated += len(out)
        self.step_seconds.append(time.perf_counter() - t0)
        return out

    # --------------------------------------------------------------- scoring
    def score_slots(self) -> np.ndarray:
        """PRM reward per slot from the cached last hidden state."""
        if self.prm_params is None:
            raise RuntimeError("engine has no PRM head")
        from ..core.prm import reward_from_hidden
        r = reward_from_hidden(self.prm_params, self._last_hidden)
        return r.float().cpu().numpy()
