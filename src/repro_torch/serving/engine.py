"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``repro.serving.engine``: the substrate the SART scheduler
drives. A fixed ``max_slots`` decode batch holds one branch per slot;
prompts are admitted chunk by chunk as extra rows ("lanes") of the same
decode step; page accounting and copy-on-write run on the host in
``repro_torch.kv.PageAllocator``. Each step is a host array built in
numpy, copied to the device once, and a step body that reads only
device tensors and shapes; on the card the body of each step variant
(``step_variants()``) is captured once as a CUDA graph and every step is
one replay of it (``serving.step_graph``, the counterpart of the
reference's jitted ``_step_fn``), on the CPU it runs eagerly, as it does
on the card inside ``Engine.eager()``. The body is a Python loop over
layers in place of ``jax.lax.scan``: the paged flash-decode (kernel K1)
for every decode row — or, with
``decode_kernel="tree"``, the tree-decode pair (kernel K3) over the
slots' fork-group map — and the paged flash-prefill (kernel K2) once per
chunk lane, as the reference's ``mixed_step_kernel="fused"`` default.
With ``chunked_prefill=False`` each admitted prompt instead runs one
synchronous exact-length pass, ``Model.prefill`` (the dense flash
prefill, kernel K5, in every attention layer; K4 for the ssm mixer),
whose K/V are then scattered into the prompt's pages.
The ssm and hybrid families carry a per-slot Mamba2 state (conv tail and
SSD state per layer): decode rows step it with ``mamba2_decode`` in plain
torch ops, and all chunk lanes of a step run one batched masked-dt
``mamba2_forward`` whose chunked scan is kernel K4. MoE layers
(``models/moe.py``) run once per layer over every row of the step,
empty slots and chunk pad rows included, so the experts' capacity is
the reference's; vlm configs rotate by M-RoPE over three equal position
streams, audio configs add the sinusoidal embedding of each row's
position. With
``prefix_cache=True`` admission serves the longest cached
page-aligned prefix from the radix cache (``repro_torch.kv.PrefixCache``)
and chunks from the first uncached token.

Differences from the reference that a reader must know:

  * **Dropped writes land on a spare page.** PyTorch has no
    ``.at[...].set(mode="drop")``, so the K/V pools are
    ``[L, kv, num_pages + 1, ps, hd]``, zero-initialised, and the
    sentinel ``num_pages`` indexes the spare page. The CoW of a sentinel
    pair, the pad rows' K/V and every write through a sentinel block
    table entry go there. Nothing reads it: the tables the attention
    kernels read hold ``num_pages - 1`` where the host's hold the
    sentinel, so an empty slot (length 0, one key) attends page
    ``num_pages - 1`` as the reference's clamped gather does. Its hidden
    state is then the reference's, which MoE layers need: every row of
    the step competes for the experts' capacity.
  * **In-place updates, reference order.** The step CoWs first, then for
    each layer writes every row's K/V before any row attends, so a
    chunk's own keys are visible to K2, as ``engine.py:1069-1170``.
  * **One host sync per step**, the sampled tokens. The step's index
    arrays, the tree map's four included, are built on the host in numpy
    into one array of one length per variant (the CoW pairs padded to
    ``max_slots`` with sentinel pairs, as the reference's) and copied to
    the device once, from a pinned buffer into the variant's static one.
  * **Step outputs are static buffers.** A variant's graph (or, eagerly,
    its copy of the body's outputs) rewrites them every step, so what
    the engine keeps past a step — ``last_logits``, ``_last_hidden``,
    the lanes' SSM state — is a copy.
  * **Snapshots are clones.** A torch slice is a view, so every SSM
    state the engine keeps past a step (a lane's running state, the
    ``ssm_snaps`` boundary snapshots, a suspended branch's state) is a
    copy that later in-place updates of the per-slot pools cannot reach.
    A suspended branch's state stays on the device, not on the host.
  * **No per-length program.** The reference jit-compiles one exact
    prefill per prompt length (``_make_prefill``, cached in
    ``_prefill_cache``); the port runs it eagerly, and ``exact_prefills``
    counts the exact passes run in its place. The exact pass allocates
    the prompt's pages before it computes (the reference after), so a
    full pool fails before any work; and it unembeds only the last
    position, the one the engine reads.
  * **Randomness** comes from one ``torch.Generator`` on the device,
    seeded from ``EngineConfig.seed`` and registered with every step
    graph, so each replay draws fresh noise; greedy sampling matches the
    reference token for token, stochastic sampling only in distribution.

Public contracts kept from the reference: non-blocking admission
(``begin_prefill`` reserves the prompt's pages up front, failing fast
with ``OutOfPagesError``), harvested ownership (``abort_prefill`` on a
harvested state only detaches it), bounded step shapes (``step_variants``
and ``prefill_compile_count``), inert rows never perturb state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import spans
from ..kernels.flash_prefill.ops import paged_flash_prefill_lanes
from ..kernels.paged_attention.ops import (paged_attention,
                                           paged_tree_attention)
from ..kv import (BranchBlocks, OutOfPagesError, PageAllocator, PrefixCache,
                  tree_decode_map)
from ..models.attention import _project_qkv, _rotate
from ..models.layers import (apply_norm, embed_tokens, positions_for,
                             sinusoidal_embedding, unembed)
from ..models.mamba2 import init_mamba2_state, mamba2_decode, mamba2_forward
from ..models.model import Model, layer_slices
from .sampling import SamplingParams, sample
from .step_graph import StepGraph


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
    # ``False`` admits each prompt synchronously in one exact-length pass.
    chunked_prefill: bool = True
    prefill_chunk: int = 64
    prefill_buckets: tuple = ()
    # Chunk-row attention path of the mixed step. "fused" runs each lane's
    # rows as one paged flash-prefill pass (kernel K2) over the request's
    # block table; "decode" re-uses the per-token flash-decode (kernel K1)
    # for every chunk row, kept for equivalence testing.
    mixed_step_kernel: str = "fused"
    # Decode-slot attention path. "paged" runs the per-branch flash-decode
    # (kernel K1: every branch streams its whole context, shared ancestor
    # pages once per sibling); "tree" splits the step over the branch x
    # page map of the slots' fork topology (``kv.tree_decode_map``) so
    # each shared ancestor page is streamed once per step for all its
    # branches (kernel K3). Bit-exact with "paged" on the CPU (the plain
    # version rebuilds the same full tables); requires
    # ``mixed_step_kernel="fused"``.
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
    # Radix page-hash prompt prefix cache: admission increfs the longest
    # cached page-aligned prefix of the prompt into its block list and
    # starts chunking at the first uncached token (no prefill compute and
    # no K/V writes for shared tokens). Refcount-0 cached pages park on an
    # LRU list and are evicted only under page pressure. Tokens and logits
    # stay bit-exact with the cache off.
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
    release them. With the prefix cache, ``next_pos`` starts at the
    cached page-aligned boundary (``cached_tokens``). For ssm/hybrid
    configs ``ssm_state`` carries the per-layer running (conv, ssd) state
    of the prompt so far, ``[L, 1, ...]`` each, and with the prefix cache
    ``ssm_snaps`` collects copies of it at page-aligned chunk boundaries
    (what a later request resuming there is seeded from)."""
    prompt: List[int]
    blocks: BranchBlocks
    next_pos: int = 0                # prompt tokens written so far
    last_logits: object = None
    done: bool = False
    harvested: bool = False
    passed_over: int = 0             # consecutive packer skips (starvation)
    cached_tokens: int = 0           # prefix tokens served from the cache
    ssm_state: object = None         # [L,1,...] (conv, ssd) running state
    ssm_snaps: Optional[dict] = None  # {token boundary: (conv, ssd)}

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
    # prefix cache on: the prompt tokens key the branch's generated full
    # pages into the radix cache at page boundaries and on completion
    prompt_tokens: Optional[List[int]] = None
    saved_ssm: object = None          # device copy while suspended
    # ssm/hybrid with the prefix cache: (conv, ssd) copies at page-aligned
    # decode boundaries, attached to the generated pages on insertion
    ssm_snaps: Optional[dict] = None  # {token boundary: (conv, ssd)}


@dataclasses.dataclass(frozen=True)
class StepVariant:
    """One reachable step shape: ``"decode"`` or ``"mixed:b{bucket}x
    l{lanes}"``; ``lane_buckets`` (each lane's padded row count) selects
    it — on the card, one CUDA graph each (``Engine.step_graphs``).
    ``args`` maps each host index array the step takes to its (shape,
    dtype)."""

    name: str
    lane_buckets: Tuple[int, ...]
    args: Dict[str, Tuple[tuple, str]] = dataclasses.field(
        default_factory=dict)


class Engine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 prm_params: Optional[dict] = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        mc = model.cfg
        assert cfg.mixed_step_kernel in ("fused", "decode"), \
            cfg.mixed_step_kernel
        assert cfg.decode_kernel in ("paged", "tree"), cfg.decode_kernel
        if cfg.decode_kernel == "tree" and cfg.mixed_step_kernel == "decode":
            raise ValueError(
                "decode_kernel='tree' requires mixed_step_kernel='fused' — "
                "the 'decode' fallback runs decode slots and chunk rows "
                "through one per-branch call, which the tree dedup map "
                "cannot cover (its row axis is the decode slots only)")
        if cfg.prefix_cache and not cfg.chunked_prefill:
            raise ValueError(
                "prefix_cache requires chunked_prefill=True — the exact-"
                "length path writes every page via the dense scatter and "
                "has no chunk-start offset to resume from")
        if cfg.step_token_budget > 0 and not cfg.chunked_prefill:
            raise ValueError(
                "step_token_budget requires chunked_prefill=True — "
                "synchronous exact-length admission has no chunk lanes to "
                "budget (and a capacity > 1 would let the scheduler drain "
                "its whole arrival queue in one tick)")
        if mc.uses_attention:
            assert not mc.sliding_window, \
                "paged engine serves full-attention configs"
        self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)
        self.prefix_cache = (PrefixCache(self.allocator)
                             if cfg.prefix_cache else None)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._next_branch_id = 0

        B, L = cfg.max_slots, mc.num_layers
        kv, hd = mc.num_kv_heads, mc.resolved_head_dim
        self.state: Dict[str, torch.Tensor] = {}
        if mc.uses_attention:
            # one spare page past the pool takes every dropped write
            shape = (L, kv, cfg.num_pages + 1, cfg.page_size, hd)
            for key in ("k_pages", "v_pages"):
                self.state[key] = torch.zeros(shape, dtype=model.dtype,
                                              device=self.device)
        if mc.uses_ssm:
            # per-slot Mamba2 state of every layer, updated in place
            conv, ssd = init_mamba2_state(mc, B, model.dtype, self.device)
            self.state["conv"] = conv.new_zeros((L,) + conv.shape)
            self.state["ssd"] = ssd.new_zeros((L,) + ssd.shape)
        self._layers = layer_slices(params["layers"], L)

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
        self.exact_prefills = 0           # exact-length passes run
        self.tokens_generated = 0         # decode-row tokens sampled

        buckets = tuple(sorted(set(cfg.prefill_buckets))) or tuple(sorted(
            {max(cfg.prefill_chunk // 2, 1), cfg.prefill_chunk}))
        if buckets[-1] < cfg.prefill_chunk:
            raise ValueError(
                f"largest prefill bucket {buckets[-1]} must cover a full "
                f"prefill_chunk of {cfg.prefill_chunk} tokens — otherwise "
                "chunk rows would alias (see Engine._bucket_for)")
        self._buckets = buckets
        self._buckets_used: set = set()   # (bucket, n_lanes) shapes run
        # one StepGraph per step variant run, by variant name; the card's
        # graphs share one memory pool
        self._tree_on = (cfg.decode_kernel == "tree"
                         and mc.uses_attention)
        self.step_graphs: Dict[str, StepGraph] = {}
        self._host_layouts: Dict[tuple, Tuple[Tuple[str, int, int], ...]] = {}
        self._graph_pool = None
        # the variant the last step ran (its device marks, with the tracer)
        self._last_graph: Optional[StepGraph] = None
        self._eager = False
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
        convenience API). Returns (prefix_blocks, last_logits, ssm_state
        or None). The prefix pages are NOT yet shared — call
        ``spawn_branch`` N times to fork branches off them.

        The chunked path by default (the mixed step's kernels);
        ``exact=True``, or ``chunked_prefill=False``, runs one exact-length
        pass over the whole prompt and scatters its K/V into the prompt's
        pages. Raises OutOfPagesError, computing and
        allocating nothing, when the pool cannot hold the prompt."""
        if not self.cfg.chunked_prefill:
            exact = True     # chunked admission disabled by config
        if not exact:
            st = self._new_chunked_state(prompt)
            while not st.done:
                self._advance_chunks([st], piggyback=False)
            return st.blocks, st.last_logits, st.ssm_state
        mc = self.model.cfg
        s = len(prompt)
        self._check_prompt_width(s)
        blocks = self.allocator.alloc_prefix(s)
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        # the reference's _prefill_all: the port unembeds only the last
        # position, so it is Model.prefill into a cache of the prompt's size
        logits, cache = self.model.prefill(self.params, tokens=tokens,
                                           max_len=s)
        self.exact_prefills += 1
        ssm_state = None
        if mc.uses_attention:
            self._write_prefix_pages(cache, blocks)
        if mc.uses_ssm:
            ssm_state = (cache["conv"], cache["ssd"])  # [L, 1, ...]
        return blocks, logits[0], ssm_state

    def _write_prefix_pages(self, cache, blocks: BranchBlocks) -> None:
        """Scatter the dense prefill K/V into the allocated pages, in
        place (padded up to the page boundary; the pad is never attended
        because block lengths mask it). The spare page is not written."""
        ps = self.cfg.page_size
        k = cache["k"][:, 0]                  # [L, s, kv, hd]
        v = cache["v"][:, 0]
        pad = len(blocks.pages) * ps - k.shape[1]
        if pad > 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        page_ids = torch.tensor(blocks.pages, dtype=torch.long,
                                device=self.device)
        _scatter_pages(self.state["k_pages"], self.state["v_pages"], k, v,
                       page_ids, ps)

    def _check_prompt_width(self, s: int) -> None:
        assert self.allocator.pages_for(max(s, 1)) <= \
            self.cfg.max_pages_per_branch, "prompt exceeds block-table width"

    def _new_chunked_state(self, prompt: List[int]) -> ChunkedPrefillState:
        """Allocate a prompt's pages (all-or-nothing) and, for ssm/hybrid
        configs, the per-layer running (conv, ssd) state its chunks thread
        through the mixed step. With the prefix cache, the longest cached
        page-aligned prefix leads the block list and chunking starts at
        the first uncached token (ssm/hybrid reuse is gated on a cached
        boundary state that seeds the recurrence); ``admit`` rolls its
        references back if the tail allocation fails, so admission stays
        all-or-nothing."""
        mc = self.model.cfg
        # width check BEFORE admit: an oversized prompt must fail without
        # acquiring references it would then leak
        self._check_prompt_width(len(prompt))
        cached, cached_ssm = 0, None
        if self.prefix_cache is None:
            blocks = self.allocator.alloc_prefix(len(prompt))
        else:
            # the two acquisitions sit in exclusive branches, and each is
            # all-or-nothing on its own
            blocks, cached_ssm = self.prefix_cache.admit(  # reprolint: disable=REP002
                prompt, need_state=mc.uses_ssm)
            cached = blocks.num_shared * self.cfg.page_size
        st = ChunkedPrefillState(prompt=list(prompt), blocks=blocks,
                                 next_pos=cached, cached_tokens=cached)
        if self.prefix_cache is not None:
            st.ssm_snaps = {}
        if mc.uses_ssm:
            if cached_ssm is not None:
                # snapshots are never updated in place, so the lane may
                # start from the cached one itself
                st.ssm_state = cached_ssm
                st.ssm_snaps[cached] = cached_ssm
            else:
                conv, ssd = init_mamba2_state(mc, 1, self.model.dtype,
                                              self.device)
                L = mc.num_layers
                st.ssm_state = (conv.new_zeros((L,) + conv.shape),
                                ssd.new_zeros((L,) + ssd.shape))
        return st

    def begin_prefill(self, prompt: List[int]) -> ChunkedPrefillState:
        """Admit a request without stalling decode. The returned state is
        queued and its prompt chunks piggyback on subsequent
        ``decode_step`` calls; poll ``state.done`` and harvest with
        ``finish_prefill``. Raises OutOfPagesError (allocating nothing)
        when the KV pool cannot hold the prompt. With
        ``chunked_prefill=False`` the prompt prefills synchronously (one
        exact-length pass) and the state returns already done."""
        with spans.span("engine.begin_prefill"):
            if not self.cfg.chunked_prefill:
                blocks, logits, ssm = self.prefill(prompt, exact=True)
                return ChunkedPrefillState(
                    prompt=list(prompt), blocks=blocks, next_pos=len(prompt),
                    last_logits=logits, ssm_state=ssm, done=True)
            st = self._new_chunked_state(prompt)
            self._pending_prefills.append(st)
            return st

    def finish_prefill(self, st: ChunkedPrefillState):
        """Harvest a completed prefill: (prefix_blocks, last_logits,
        ssm_state — None on the dense path). Ownership of the pages passes
        to the caller."""
        with spans.span("engine.finish_prefill"):
            assert st.done, "prefill still has pending chunks"
            st.harvested = True
            return st.blocks, st.last_logits, st.ssm_state

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
        """Radix-cache hit/eviction counters, or None with the cache off
        (surfaced by the serve CLI and ``Scheduler.metrics``)."""
        return (self.prefix_cache.stats()
                if self.prefix_cache is not None else None)

    def match_cached_tokens(self, prompt: List[int]) -> int:
        """Non-mutating probe for LPM admission ordering: prompt tokens a
        warm admission would serve from the radix cache right now (0 with
        the cache off), with the SSM-boundary gating of a real admission."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.match_tokens(
            prompt, need_state=self.model.cfg.uses_ssm)

    @property
    def prefill_compile_count(self) -> int:
        """Distinct mixed-step chunk shapes run so far — (bucket,
        lane-count) pairs, O(num_buckets x num_lane_configs)."""
        return len(self._buckets_used)

    def step_variants(self) -> List[StepVariant]:
        """Every step shape this engine can dispatch: the pure-decode
        shape plus one mixed shape per (bucket, lane-count) pair, each
        with the arrays it takes (the lanes' chunk lengths; the tree map's
        four with ``decode_kernel="tree"``; for ssm/hybrid the
        slot-validity mask and the lanes' stacked (conv, ssd) chunk
        state)."""
        cfg, mc = self.cfg, self.model.cfg
        B, w = cfg.max_slots, cfg.max_pages_per_branch
        dtype = str(self.model.dtype).replace("torch.", "")

        def args(n_lanes: int, bucket: int) -> dict:
            rows = B + n_lanes * bucket
            out = {"tokens": ((rows,), "int32"),
                   "positions": ((rows,), "int32"),
                   "block_tables": ((rows, w), "int32"),
                   "lengths": ((rows,), "int32")}
            if cfg.decode_kernel == "tree" and mc.uses_attention:
                out.update(branch_bt=((B, w), "int32"),
                           row_group=((B,), "int32"),
                           shared_bt=((B, w), "int32"),
                           shared_lens=((B,), "int32"))
            out["chunk_lens"] = ((n_lanes,), "int32")
            if mc.uses_ssm:
                out["slot_valid"] = ((B,), "bool")
                if n_lanes:
                    conv, ssd = self.state["conv"], self.state["ssd"]
                    L = mc.num_layers
                    out.update(
                        chunk_conv=((L, n_lanes) + tuple(conv.shape[2:]),
                                    dtype),
                        chunk_ssd=((L, n_lanes) + tuple(ssd.shape[2:]),
                                   dtype))
            return out

        variants = [StepVariant("decode", (), args(0, 0))]
        for bucket in self._buckets:
            for n in self._lane_configs:
                variants.append(StepVariant(f"mixed:b{bucket}xl{n}",
                                            (bucket,) * n, args(n, bucket)))
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
                        cows: Sequence[tuple] = (),
                        tree: Optional[tuple] = None):
        """Run one chunk of each state in ``sts`` through the step as
        concurrent lanes (the variant ``mixed:b{bucket}xl{len(sts)}``).
        With ``piggyback`` the caller (``decode_step``) supplies the live
        decode rows plus the step's CoW page copies and tree map;
        standalone draining pads with inert rows (sentinel block tables
        send their page writes to the spare page; the tree map groups none
        of them; the slot-validity mask freezes every slot's SSM state).

        ssm/hybrid configs thread each lane's running per-layer (conv,
        ssd) state through the step (copied into its lane of the variant's
        static input) and get a copy back advanced by exactly that lane's
        chunk length — pad rows are identity transitions under the
        masked-dt scan. With the prefix
        cache, each lane keeps a copy of its SSM state at page-aligned
        chunk boundaries, and a finished prompt's full pages are inserted
        into the radix with them."""
        cfg, mc = self.cfg, self.model.cfg
        B = cfg.max_slots
        with spans.span("engine.host_array"):
            if not bucket:
                bucket = max(self._chunk_bucket(st) for st in sts)
            lanes = [self._chunk_inputs(st, bucket) for st in sts]
            chunk_lens = [ln[4] for ln in lanes]
            if piggyback:
                d_tokens, d_positions = self._tokens, self._positions
                d_bt, d_lengths = self._block_tables, self._lengths
                slot_valid = self._active
            else:
                d_tokens = np.zeros((B,), np.int32)
                d_positions = np.zeros((B,), np.int32)
                d_bt = np.full((B, cfg.max_pages_per_branch), cfg.num_pages,
                               np.int32)
                d_lengths = np.zeros((B,), np.int32)
                slot_valid = np.zeros((B,), bool)
                tree = self._tree_map([None] * B)
            rows = [np.concatenate([d] + [ln[f] for ln in lanes])
                    for f, d in enumerate((d_tokens, d_positions, d_bt,
                                           d_lengths))]
        lane_states = ([st.ssm_state for st in sts] if mc.uses_ssm
                       else ())
        lane_buckets = (bucket,) * len(sts)
        self._buckets_used.add((bucket, len(sts)))
        next_tokens, hidden, logits, chunk_out = self._step(
            *rows, lane_buckets, chunk_lens, cows, tree, slot_valid,
            lane_states)
        self.prefill_chunk_steps += len(sts)
        self.mixed_steps_executed += 1
        ps = cfg.page_size
        for i, st in enumerate(sts):
            cl = chunk_lens[i]
            st.next_pos += cl
            if chunk_out is not None:
                # this lane's own copy: the step's outputs are static
                # buffers, rewritten by the variant's next step
                st.ssm_state = (chunk_out[0][:, i:i + 1].clone(),
                                chunk_out[1][:, i:i + 1].clone())
                if st.ssm_snaps is not None and st.next_pos % ps == 0:
                    # a chunk boundary on a page boundary: this state can
                    # seed a future request resuming at exactly next_pos
                    st.ssm_snaps[st.next_pos] = st.ssm_state
            if st.next_pos >= len(st.prompt):
                st.done = True
                st.last_logits = logits[B + i * bucket + cl - 1].clone()
                if st in self._pending_prefills:
                    self._pending_prefills.remove(st)
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(st.prompt, st.blocks.pages,
                                             st.ssm_snaps)
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
        ``prompt_tokens`` (the request's prompt) keys the branch's
        generated full pages into the prefix cache at completion and
        page-aligned decode boundaries — without it the branch inserts
        nothing. ``ssm_state`` (ssm/hybrid: the prefill's ``[L, 1, ...]``
        (conv, ssd)) is copied into the slot's rows; ``first_fork`` keeps
        the reference's signature and is unused."""
        with spans.span("engine.spawn_branch", request_id) as sp:
            free = self.free_slots
            if not free:
                return None
            slot = free[0]
            blocks = self.allocator.fork(prefix_blocks)
            first = int(sample(self._gen, last_logits, self.cfg.sampling))
            handle = BranchHandle(
                branch_id=self._next_branch_id, request_id=request_id,
                slot=slot, blocks=blocks, tokens=[first],
                prompt_len=prompt_len,
                prompt_tokens=(list(prompt_tokens)
                               if prompt_tokens is not None else None),
                ssm_snaps={} if self.prefix_cache is not None else None)
            self._next_branch_id += 1
            self.slots[slot] = handle
            if self.model.cfg.uses_ssm and ssm_state is not None:
                conv, ssd = ssm_state
                self.state["conv"][:, slot] = conv[:, 0]
                self.state["ssd"][:, slot] = ssd[:, 0]
            self._seat(handle)
            if sp:
                sp.set(seated=1)
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
        all of the parent's pages (CoW on next append) and copies its SSM
        state."""
        free = self.free_slots
        if not free:
            return None
        slot = free[0]
        blocks = self.allocator.fork(parent.blocks)
        handle = BranchHandle(
            branch_id=self._next_branch_id, request_id=parent.request_id,
            slot=slot, blocks=blocks, tokens=list(parent.tokens),
            prompt_len=parent.prompt_len,
            prompt_tokens=(list(parent.prompt_tokens)
                           if parent.prompt_tokens is not None else None),
            ssm_snaps=(dict(parent.ssm_snaps)
                       if parent.ssm_snaps is not None else None))
        self._next_branch_id += 1
        self.slots[slot] = handle
        if self.model.cfg.uses_ssm:
            for key in ("conv", "ssd"):
                self.state[key][:, slot] = self.state[key][:, parent.slot]
        self._seat(handle)
        return handle

    def suspend_branch(self, h: BranchHandle) -> None:
        """Vacate a branch's slot while KEEPING its pages and SSM state
        (a device copy: the slot's rows go to the next occupant), so it
        can be reseated later via ``resume_branch``."""
        assert self.slots[h.slot] is h
        if self.model.cfg.uses_ssm:
            h.saved_ssm = (self.state["conv"][:, h.slot].clone(),
                           self.state["ssd"][:, h.slot].clone())
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
        if h.saved_ssm is not None:
            conv, ssd = h.saved_ssm
            self.state["conv"][:, h.slot] = conv
            self.state["ssd"][:, h.slot] = ssd
            h.saved_ssm = None
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

    def _insert_generated(self, h: BranchHandle) -> None:
        """Insert a branch's generated full pages into the prefix cache,
        keyed by prompt + generated tokens (``insert`` skips the trailing
        partial page, which keeps private CoW semantics). Released pages
        then park on the LRU instead of freeing, so a resample of the
        same trajectory admits warm. ``ssm_snaps`` attaches (conv, ssd)
        copies to the page-aligned boundaries that have one, keeping the
        seedable-boundary gate for ssm/hybrid. Gated on attention: pure-ssm
        decode allocates no generated pages to insert."""
        if (self.prefix_cache is None or h.prompt_tokens is None
                or not self.model.cfg.uses_attention):
            return
        written = h.blocks.length - h.prompt_len
        if written <= 0:
            return
        key = list(h.prompt_tokens) + h.tokens[:written]
        self.prefix_cache.insert(key, h.blocks.pages, h.ssm_snaps)

    def free_branch(self, h: BranchHandle):
        """Release a branch's slot and eagerly free its pages (inserting
        its generated full pages into the prefix cache first, so they park
        warm on the LRU instead of freeing)."""
        with spans.span("engine.free_branch", h.request_id):
            self._insert_generated(h)
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
        with spans.span("engine.release_prefix"):
            self.allocator.release(prefix_blocks)

    # ----------------------------------------------------------------- decode
    def _cow_arrays(self, cows: Sequence[tuple]):
        """A step's (old, new) CoW page pairs as two int32 [max_slots]
        arrays, in slot order (each decode slot CoWs at most once per
        step), padded with sentinel pairs that copy the spare page onto
        itself (the reference's ``_cow_arrays``)."""
        src = np.full((self.cfg.max_slots,), self.cfg.num_pages, np.int32)
        dst = src.copy()
        src[:len(cows)] = [old for old, _ in cows]
        dst[:len(cows)] = [new for _, new in cows]
        return src, dst

    def _tree_map(self, blocks: List[Optional[BranchBlocks]]
                  ) -> Optional[tuple]:
        """The decode rows' branch x page map for K3 as host arrays
        ``(row_group, shared_bt, shared_lens, branch_bt)`` from the slots'
        blocks (None for an empty slot), or None with the per-branch
        kernel (and without attention)."""
        if not self._tree_on:
            return None
        cfg = self.cfg
        return tree_decode_map(
            blocks, pages_per_branch=cfg.max_pages_per_branch,
            num_pages=cfg.num_pages, page_size=cfg.page_size)

    @contextlib.contextmanager
    def eager(self):
        """Run the steps of the block eagerly, op by op, on the card too
        (the reference's ``jax.disable_jit()``): the comparison for the
        step graphs, which serve every step otherwise. The CPU always
        steps eagerly."""
        prev, self._eager = self._eager, True
        try:
            yield self
        finally:
            self._eager = prev

    @property
    def graphs_captured(self) -> int:
        """Step variants captured as CUDA graphs so far (at most
        ``len(step_variants())``)."""
        return sum(g.graph is not None for g in self.step_graphs.values())

    @property
    def graph_replays(self) -> int:
        """Steps served as the replay of a variant's graph."""
        return sum(g.replays for g in self.step_graphs.values())

    def step_launches(self) -> Dict[str, int]:
        """Kernel launches the steps ran on the device, by kernel: each
        variant's launches recorded at capture times its replays, plus
        the eager steps' own launches."""
        out: Dict[str, int] = {}
        for g in self.step_graphs.values():
            for k, n in g.launches_run().items():
                out[k] = out.get(k, 0) + n
        return out

    def _step_graph(self, lane_buckets: tuple) -> StepGraph:
        """The variant's ``StepGraph``, made at its first step."""
        name = (f"mixed:b{lane_buckets[0]}xl{len(lane_buckets)}"
                if lane_buckets else "decode")
        if name not in self.step_graphs:
            cfg, mc = self.cfg, self.model.cfg
            n = len(lane_buckets)
            lane_state = None
            if mc.uses_ssm and n:
                lane_state = tuple(
                    self.state[k].new_zeros(
                        (mc.num_layers, n) + self.state[k].shape[2:])
                    for k in ("conv", "ssd"))
            inert = self.inert_host_array(lane_buckets)
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self.step_graphs[name] = StepGraph(
                functools.partial(self._step_body, lane_buckets=lane_buckets),
                inert, self.device, lane_state, self._graph_pool,
                self._gen if cfg.sampling.temperature else None)
        return self.step_graphs[name]

    def host_layout(self, lane_buckets: tuple = ()
                    ) -> Tuple[Tuple[str, int, int], ...]:
        """The fields of a variant's host array as (name, start, stop), in
        order; the last one stops at the array's length. The one
        description of the layout: ``_host_array`` packs by it,
        ``_step_body`` slices by it, and stepcheck names the body's reads
        by it."""
        layout = self._host_layouts.get(lane_buckets)
        if layout is None:
            cfg = self.cfg
            nS, w = cfg.max_slots, cfg.max_pages_per_branch
            B = nS + sum(lane_buckets)
            sizes = [("tokens", B), ("positions", B), ("write_page", B),
                     ("write_slot", B), ("lengths", B),
                     ("block_tables", B * w)]
            if self._tree_on:
                sizes += [("row_group", nS), ("shared_lens", nS),
                          ("shared_bt", nS * w), ("branch_bt", nS * w)]
            if self.model.cfg.uses_ssm:
                sizes.append(("slot_valid", nS))
            sizes += [("chunk_lens", len(lane_buckets)), ("cow_src", nS),
                      ("cow_dst", nS)]
            out, pos = [], 0
            for name, size in sizes:
                out.append((name, pos, pos + size))
                pos += size
            layout = self._host_layouts[lane_buckets] = tuple(out)
        return layout

    def inert_host_array(self, lane_buckets: tuple = ()) -> np.ndarray:
        """The variant's host array as its graph's warm-up takes it: every
        write to the spare page, empty tables, no lane."""
        cfg = self.cfg
        nS, n = cfg.max_slots, len(lane_buckets)
        rows = nS + sum(lane_buckets)
        return self._host_array(
            np.zeros((rows,), np.int32), np.zeros((rows,), np.int32),
            np.full((rows, cfg.max_pages_per_branch), cfg.num_pages,
                    np.int32), np.zeros((rows,), np.int32),
            lane_buckets, [0] * n, (), self._tree_map([None] * nS),
            np.zeros((nS,), bool))

    def _host_array(self, tokens: np.ndarray, positions: np.ndarray,
                    block_tables: np.ndarray, lengths: np.ndarray,
                    lane_buckets: tuple, chunk_lens: Sequence[int],
                    cows: Sequence[tuple], tree: Optional[tuple],
                    slot_valid: Optional[np.ndarray]) -> np.ndarray:
        """The step's one host array, int32, of one length per variant:
        every row's token, position, page and slot written, length + 1 and
        block table; the tree map's four (tree decode); the slot-validity
        mask (ssm/hybrid); the lanes' chunk lengths; the CoW pairs, padded
        to ``max_slots``; packed in ``host_layout``'s order, which
        ``_step_body`` slices it apart by on the device."""
        cfg, mc = self.cfg, self.model.cfg
        B, nS = tokens.shape[0], cfg.max_slots
        ps, w = cfg.page_size, cfg.max_pages_per_branch
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
        # the tables the kernels read: a sentinel entry reads page
        # num_pages - 1, as the reference's gather clamps it, never the
        # spare page that the dropped writes (and a graph's warm-up) fill
        last = cfg.num_pages - 1
        fields = {"tokens": tokens, "positions": positions,
                  "write_page": page_of, "write_slot": positions % ps,
                  "lengths": lengths + 1,
                  "block_tables": np.minimum(block_tables, last).reshape(-1)}
        if self._tree_on:
            rg, sbt, sl, bbt = tree
            fields.update(row_group=rg, shared_lens=sl,
                          shared_bt=np.minimum(sbt, last).reshape(-1),
                          branch_bt=np.minimum(bbt, last).reshape(-1))
        if mc.uses_ssm:
            fields["slot_valid"] = slot_valid
        fields["chunk_lens"] = np.asarray(chunk_lens, np.int32).reshape(-1)
        fields["cow_src"], fields["cow_dst"] = self._cow_arrays(cows)
        layout = self.host_layout(tuple(lane_buckets))
        if len(fields) != len(layout):
            raise ValueError(f"host fields {sorted(fields)} do not match the "
                             f"layout {[f for f, _, _ in layout]}")
        out = np.concatenate([fields[f] for f, _, _ in layout]).astype(
            np.int32)
        if out.shape[0] != layout[-1][2]:
            raise ValueError(f"host array of {out.shape[0]} ints, layout "
                             f"{layout[-1][2]}")
        return out

    def _step(self, tokens: np.ndarray, positions: np.ndarray,
              block_tables: np.ndarray, lengths: np.ndarray,
              lane_buckets: tuple = (), chunk_lens: Sequence[int] = (),
              cows: Sequence[tuple] = (),
              tree: Optional[tuple] = None,
              slot_valid: Optional[np.ndarray] = None,
              lane_states: Sequence[tuple] = ()):
        """One batched token step (the reference's ``_step_fn``): the host
        array of the step's index arrays (``_host_array``), then the step
        body over it as the variant's ``StepGraph`` runs it — one graph
        replay on the card. Rows 0..max_slots-1 are the decode slots;
        extra rows are the step's prefill chunk lanes, ``lane_buckets``
        giving each lane's padded row count (a shape, which selects the
        variant) and ``chunk_lens[i]`` its true chunk length. ``tree`` is
        the decode rows' map from ``_tree_map`` (None: per-branch K1);
        ``lane_states`` the lanes' (conv, ssd) ``[L, 1, ...]`` states
        (ssm/hybrid). Returns (next_tokens [rows] int32, hidden [max_slots,
        D], logits [rows, V], the lanes' advanced (conv, ssd) stacked
        along a lane axis or None): static outputs, valid until the next
        step (the variants' graphs share one memory pool)."""
        with spans.span("engine.host_array"):
            host = self._host_array(tokens, positions, block_tables,
                                    lengths, lane_buckets, chunk_lens, cows,
                                    tree, slot_valid)
        graph = self._last_graph = self._step_graph(lane_buckets)
        out = graph.run(host, lane_states, eager=self._eager)
        next_tokens, hidden, logits = out[:3]
        return next_tokens, hidden, logits, (out[3:] if out[3:] else None)

    def _step_body(self, dev: torch.Tensor,
                   lane_state: Optional[Tuple[torch.Tensor, ...]],
                   lane_buckets: tuple = ()):
        """The step body over the device copy of ``_host_array``'s array:
        it reads device tensors and shapes only (no host read of a value,
        no allocation whose size depends on data), so one CUDA graph per
        variant serves every step. ``lane_buckets`` is the variant's lane
        shape; ``lane_state`` the lanes' stacked (conv, ssd) per layer.

        Order, as the reference: CoW copies (every step: sentinel pairs
        copy the spare page onto itself), the embedding (plus the
        sinusoidal one of each row's position, audio), then per layer
        norm -> the mixer -> MLP or MoE (over all rows); then the final
        norm, unembed and sampling. The attention mixer runs QKV -> RoPE
        (M-RoPE over three equal streams, vlm) -> K/V page writes of every row
        -> attention (K1, or K3 over the tree map, for the decode rows; K2
        once over all lanes with the "fused" kernel, reading each lane's
        pos0 and length on the device) -> wo. CoW runs before attention,
        so no shared page of the map is written mid-step.

        The SSM mixer (ssm/hybrid) steps the decode rows with
        ``mamba2_decode``, masked by the slot-validity mask so inert slots
        keep their state bit-identical, and writes the per-slot state in
        place; all lanes (uniform buckets) run as ONE batched masked-dt
        ``mamba2_forward`` (K4 on the card), seeded from ``lane_state``
        with only each lane's first ``chunk_lens[i]`` rows valid. Hybrids
        average the two mixers. Returns (next_tokens [rows] int32, hidden
        [max_slots, D], logits [rows, V]) and, with SSM lanes, their
        advanced conv and ssd states.

        Device marks (``spans.device_mark``; recorded only into a graph
        captured with the tracer on) split it into ``dense`` (CoW, norms,
        QKV, RoPE, page writes, ``wo``, the MLP), ``attention`` (K1 or K3
        and K2's lanes), ``ssm`` (the mixers), the MoE layer's own
        (``models/moe.py``) and ``head`` (final norm, unembed, sampling).
        """
        mc, cfg, p = self.model.cfg, self.cfg, self.params
        nS = cfg.max_slots
        B = nS + sum(lane_buckets)
        ps, w = cfg.page_size, cfg.max_pages_per_branch
        f = {name: dev[a:b] for name, a, b in self.host_layout(lane_buckets)}
        tok_d, pos_d, page_d, slot_d, len_d = (
            f["tokens"], f["positions"], f["write_page"], f["write_slot"],
            f["lengths"])
        bt_d = f["block_tables"].view(B, w)
        if self._tree_on:
            rg_d, sl_d = f["row_group"], f["shared_lens"]
            sbt_d = f["shared_bt"].view(nS, w)
            bbt_d = f["branch_bt"].view(nS, w)
        if mc.uses_ssm:
            valid_d = f["slot_valid"].bool()
        n_lanes = len(lane_buckets)
        lens_d = f["chunk_lens"]
        spans.device_mark("dense")
        if mc.uses_attention:
            kp_all, vp_all = self.state["k_pages"], self.state["v_pages"]
            # CoW before any write (in place on the pools)
            src = f["cow_src"].long()
            dst = f["cow_dst"].long()
            kp_all[:, :, dst] = kp_all[:, :, src]
            vp_all[:, :, dst] = vp_all[:, :, src]
            page_i, slot_i = page_d.long(), slot_d.long()
        fused_chunk = B > nS and cfg.mixed_step_kernel == "fused"
        ssm_lanes = mc.uses_ssm and B > nS
        if ssm_lanes:
            # all lanes run as ONE batched scan: the packer only emits
            # uniform lane tuples, and the lane axis is the batch axis
            assert len(set(lane_buckets)) == 1, lane_buckets
            new_conv, new_ssd = [], []

        x = embed_tokens(mc, p["embed"], tok_d[:, None])      # [B, 1, D]
        if mc.pos_embedding == "sinusoidal":
            x = x + sinusoidal_embedding(pos_d, mc.d_model)[:, None].to(
                x.dtype)
        rot_pos = positions_for(mc, pos_d[:, None])    # [B, 1] or [B, 1, 3]
        for layer, lp in enumerate(self._layers):
            spans.device_mark("dense")
            h = apply_norm(mc, lp["norm1"], x)
            mix = None
            if mc.uses_attention:
                kp, vp = kp_all[layer], vp_all[layer]  # [kv, P + 1, ps, hd]
                q, k, v = _project_qkv(mc, lp["attn"], h)
                q, k = _rotate(mc, q, k, rot_pos)
                # every row's K/V lands before any row attends
                kp[:, page_i, slot_i] = k[:, 0].transpose(0, 1)
                vp[:, page_i, slot_i] = v[:, 0].transpose(0, 1)
                q = q[:, 0]                                    # [B, H, hd]
                spans.device_mark("attention")
                if B > nS and not fused_chunk:
                    # the mixed_step_kernel="decode" fallback: every row
                    # through the per-token flash-decode (the tree map
                    # needs the fused path)
                    att = paged_attention(q, kp, vp, bt_d, len_d)
                else:
                    if self._tree_on:
                        # decode rows over the fork-group map (K3)
                        att = paged_tree_attention(q[:nS], kp, vp, rg_d,
                                                   sbt_d, sl_d, bbt_d,
                                                   len_d[:nS])
                    else:
                        att = paged_attention(q[:nS], kp, vp, bt_d[:nS],
                                              len_d[:nS])
                    if fused_chunk:
                        # every lane in one call: each lane's pos0 and
                        # table are its first row's, its length lens_d's
                        att = torch.cat([att, paged_flash_prefill_lanes(
                            q[nS:], kp, vp, bt_d[nS:], pos_d[nS:], lens_d,
                            lane_buckets)], 0)
                spans.device_mark("dense")
                mix = att.reshape(B, 1, -1) @ lp["attn"]["wo"]
            if mc.uses_ssm:
                spans.device_mark("ssm")
                conv_l, ssd_l = self.state["conv"][layer], \
                    self.state["ssd"][layer]
                y, conv, ssd = mamba2_decode(mc, lp["mamba"], h[:nS], conv_l,
                                             ssd_l, valid=valid_d)
                conv_l.copy_(conv)
                ssd_l.copy_(ssd)
                if ssm_lanes:
                    bk = lane_buckets[0]
                    y_ch, (c_conv, c_ssd) = mamba2_forward(
                        mc, lp["mamba"], h[nS:, 0].reshape(n_lanes, bk, -1),
                        initial=(lane_state[0][layer], lane_state[1][layer]),
                        valid_len=lens_d)
                    new_conv.append(c_conv.to(conv_l.dtype))
                    new_ssd.append(c_ssd.to(ssd_l.dtype))
                    y = torch.cat([y, y_ch.reshape(B - nS, 1, -1)], 0)
                spans.device_mark("dense")
                mix = y if mix is None else mix + y
            # the MLP or MoE block over all B rows: empty slots and pad
            # rows count toward the experts' capacity, as the reference's
            x, _ = self.model._finish_layer(lp, x, mix)
        spans.device_mark("head")
        x = apply_norm(mc, p["final_norm"], x)
        hidden = x[:, 0]
        logits = unembed(mc, p["embed"], hidden)
        next_tokens = sample(self._gen, logits, cfg.sampling)
        spans.device_mark(spans.END)
        out = (next_tokens, hidden[:nS], logits)
        if ssm_lanes:
            out += (torch.stack(new_conv), torch.stack(new_ssd))
        return out

    def decode_step(self) -> Dict[int, int]:
        """One decode step for all active slots, piggybacking up to
        ``step_token_budget`` chunk-row tokens of pending prefills as
        concurrent lanes (mixed step) — one FIFO chunk when the budget is
        unset. Page accounting (boundary alloc + CoW) runs on the host
        *before* the step; the sampled token is then appended to each
        active branch. Returns {slot: new_token}.

        With the tracer on this is the span ``engine.decode_step`` (its
        parts ``engine.pages``, ``.pack``, ``.host_array``, ``.launch``,
        ``.sync`` and ``.commit``), and after it, in the span
        ``host.tracer``, its counters and, where the step replayed a graph
        captured with device marks, its device ms by kind."""
        if not self._active.any() and not self._pending_prefills:
            return {}
        with spans.span("engine.decode_step") as sp:
            out, chunk_tokens = self._decode_step()
        if sp:
            # the tracer's own work, after the step and outside it
            with spans.span("host.tracer"):
                sp.set(rows=len(out), ctx=self.live_tokens(),
                       chunk_tokens=chunk_tokens,
                       pages_used=self.allocator.used_pages)
                marks = self._last_graph.marks
                if marks is not None and not self._eager:
                    sp.device(marks.elapsed_ms())
        return out

    def _decode_step(self) -> Tuple[Dict[int, int], int]:
        """``decode_step``'s work; also returns the chunk tokens the step
        advanced."""
        cfg, mc = self.cfg, self.model.cfg
        with spans.span("engine.pages") as sp:
            cows = self._account_pages()
            if sp:
                sp.set(cows=len(cows))
        with spans.span("engine.pack") as sp:
            # pack only after the page accounting above: an
            # OutOfPagesError abort must not charge skipped prefills'
            # starvation counters
            lanes, bucket = self._pack_lanes()
            # the tree map reflects POST-accounting topology: CoW and
            # boundary allocation above already diverged any page this
            # step writes, so no fork group's shared span covers a
            # written page
            tree = self._tree_map([h.blocks if h is not None else None
                                   for h in self.slots])
            if sp:
                sp.set(lanes=len(lanes))
        chunk_tokens = sum(min(cfg.prefill_chunk, st.remaining)
                           for st in lanes)
        if lanes:
            next_tokens, hidden = self._advance_chunks(
                lanes, piggyback=True, bucket=bucket, cows=cows, tree=tree)
        else:
            next_tokens, hidden, _, _ = self._step(
                self._tokens, self._positions, self._block_tables,
                self._lengths, cows=cows, tree=tree, slot_valid=self._active)
        # a copy: ``hidden`` is the variant's static output
        self._last_hidden = hidden.clone()
        self.decode_steps_executed += 1

        out: Dict[int, int] = {}
        # the one sync per step: sampled tokens drive host-side branch
        # bookkeeping (EOS detection, page accounting) before the next
        # step can be built
        with spans.span("engine.sync"):
            toks = next_tokens.tolist()  # reprolint: disable=REP005
        with spans.span("engine.commit"):
            for slot, h in enumerate(self.slots):
                if h is None:
                    continue
                tok = toks[slot]
                h.tokens.append(tok)
                out[slot] = tok
                self._tokens[slot] = tok
                self._positions[slot] += 1
                self._lengths[slot] += 1
                if (self.prefix_cache is not None
                        and h.prompt_tokens is not None
                        and h.blocks.length % cfg.page_size == 0):
                    # page-aligned decode boundary: long-running branches
                    # publish their generated full pages before
                    # completion. The slot's state now covers exactly
                    # blocks.length tokens, so a copy of it can seed an
                    # ssm/hybrid resume here
                    if mc.uses_ssm and h.ssm_snaps is not None:
                        h.ssm_snaps[h.blocks.length] = (
                            self.state["conv"][:, slot:slot + 1].clone(),
                            self.state["ssd"][:, slot:slot + 1].clone())
                    self._insert_generated(h)
        self.tokens_generated += len(out)
        return out, chunk_tokens

    def _account_pages(self) -> List[tuple]:
        """The step's page accounting on the host: refuses a step the
        block tables or the pool cannot take (``OutOfPagesError``, nothing
        changed), then appends each seated branch's next token, returning
        the CoW page pairs it makes."""
        cfg, mc = self.cfg, self.model.cfg
        cows = []
        if mc.uses_attention:
            cap = cfg.max_pages_per_branch * cfg.page_size
            for h in self.slots:
                if h is not None and h.blocks.length + 1 > cap:
                    # static block table full: surface as memory pressure
                    # so the scheduler's evict-longest path force-completes
                    raise OutOfPagesError(
                        "branch at block-table capacity "
                        f"({cap} tokens)")
            if self.pages_needed_for_step() > self.allocator.free_pages:
                raise OutOfPagesError(
                    "decode step needs more pages than are free")
            # the pages_needed_for_step pre-check above reserves this
            # loop's worst case, so append_token cannot raise mid-way
            for h in self.slots:
                if h is None:
                    continue
                cow = self.allocator.append_token(h.blocks)  # reprolint: disable=REP002
                if cow is not None:
                    cows.append(cow)
                self._refresh_block_table(h)
        else:
            # pure ssm: decode writes no pages; the state is the context
            for h in self.slots:
                if h is not None:
                    h.blocks.length += 1
        return cows

    # --------------------------------------------------------------- scoring
    def score_slots(self) -> np.ndarray:
        """PRM reward per slot from the cached last hidden state."""
        if self.prm_params is None:
            raise RuntimeError("engine has no PRM head")
        from ..core.prm import reward_from_hidden
        r = reward_from_hidden(self.prm_params, self._last_hidden)
        return r.float().cpu().numpy()


# --------------------------------------------------------------------- helpers


def _scatter_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, page_ids: torch.Tensor,
                   page_size: int) -> None:
    """k, v [L, n_pages * ps, kv, hd] -> pages ``page_ids`` of the pools
    [L, kv, P + 1, ps, hd], in place."""
    l, s, kvh, hd = k.shape
    n = s // page_size
    for pages, new in ((k_pages, k), (v_pages, v)):
        pages[:, :, page_ids] = new.reshape(l, n, page_size, kvh, hd).permute(
            0, 3, 1, 2, 4).to(pages.dtype)
