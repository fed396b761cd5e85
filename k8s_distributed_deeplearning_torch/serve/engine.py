"""Continuous-batching serving engine over a paged KV pool.

Port of ``k8s_distributed_deeplearning_tpu/serve/engine.py``
(``ServeEngine``): the same host-side design, with PyTorch calls where the
JAX engine runs its compiled programs.

- The KV cache is ONE pool of fixed-size pages per layer
  (``[num_pages, page_tokens, kv·head_dim]``, K and V). Each slot owns a
  host-side block table row mapping its virtual sequence onto pool pages.
  Page bookkeeping is host-side (:class:`serve.page_pool.PagePool`):
  admission allocates the prompt's pages and RESERVES the request's
  worst-case decode growth, so the mid-decode page-boundary allocation
  cannot fail; back-pressure exists only at admission.
- Admission prefills straight into the pool, from up to three sources:
  the prefix cache (``prefix_cache_mb``; :mod:`serve.prefix_cache`), whose
  longest hit is MAPPED into the slot's table (each trie page ref'd, no
  device copy); intermediate chunks of exactly ``prefill_chunk_tokens``
  real tokens (no LM head) from the hit onwards; and a final chunk
  right-padded to a power-of-two bucket that samples the first token from
  column ``length - 1``. A finished prefill hands the trie a reference to
  each whole prompt block it does not hold yet. Pad writes past the table
  land in the scratch page 0; pad writes inside the last page sit past the
  cursor and are never attended.
- Every iteration runs one decode step for all slots. Free slots ride
  along with all-scratch tables: their writes land in page 0 and are never
  attended. The host register file (tokens, cursors, tables, sampling
  params) is numpy, shipped to the device each step, and the sampled
  tokens come back in the iteration's one host sync.
- Sampling is per slot: greedy rows take the argmax; a sampled request
  draws from its own ``torch.Generator`` seeded with ``Request.seed``, so
  its stream depends only on the request, not on its slot.
- Admission order is the multi-tenant scheduler's
  (:class:`serve.sched.TenantScheduler`: EDF within a tenant, weighted
  round robin, strict priority classes, rate limits and slot quotas).
  ``cancel``, ``drain`` and ``submit(requeue=True)`` control single
  requests and the engine's intake; shutdown and a finished drain check
  that no page is left held.
- Speculative decoding (``draft_model``, ``spec_k``): a second paged
  arena, sized for the draft model, over the SAME page indices and tables
  (every prefill write lands in both). Each iteration the draft proposes
  ``spec_k`` greedy tokens a slot in ``spec_k + 1`` single-token steps,
  one target pass scores the ``[B, spec_k + 1]`` window through the paged
  kernels, and a slot emits the drafts that equal the target's own
  selections plus the target's next one. Rollback is the cursor: rejected
  positions stay past it, never attended. A sampled slot draws the
  window's positions in order with its generator and keeps the state
  after its last emitted token, so its stream is the non-speculative one.
- Quantized serving (``kv_quant="int8"``, ``weight_quant="int8"``): int8
  KV pages with per-token-per-head f32 scales, read by the int8 branch of
  the paged-attention kernels; per-channel int8 matmul weights
  (``serve/quant.py``), dequantized at use.
- KV page shipping (``serve/disagg.py``, ``serve/gateway.py``): a slot's
  written pages move BY VALUE between engines. :meth:`export_request_kv`
  gathers them by index on the device and makes one host copy a pool
  tensor; :meth:`import_request_kv` copies them in and scatters them with
  ``index_copy_`` into fresh pages tagged ``imported``, and decode resumes
  from the shipped cursor with the request's generator state. A
  ``prefill_only`` engine exports every slot the step its admission
  completes (:meth:`take_exports`) and never decodes.
- Observability: ``replica_id`` names the engine in its messages and
  events; ``flight`` (``telemetry/flight.py``) takes a snapshot a step and
  dumps on a finished drain, a leak or an injected fault; the
  ``serve_decode`` fault site fires before each decode launch; a leak
  check emits ``kv_page_leak`` on ``request_log``. ``tracer``
  (``telemetry/trace.py``) times the spans ``admission``, ``prefill`` (one
  a chunk) and ``decode`` (one an iteration, its host sync included) at
  the JAX engine's sites; ``request_trace_sample`` emits one
  ``request_trace`` event a finished request for that share of request
  ids, chosen by a hash of the id (the JAX engine's rule, so the same
  requests are traced by either package).
- Tensor parallelism (``tp=k``, ``serve/tp.py``): one process a shard,
  this engine on rank 0 of a tp world of k ranks. Every device program
  goes through one seam (:meth:`_program`): rank 0 broadcasts the
  program's header and operands and every rank runs the same model call
  on its shard (Megatron column/row splits, ``parallel/sharding.py``;
  one all-reduce closes each sublayer), on a pool each rank allocates
  sharded on the KV heads. Every host structure above the seam (tables,
  cursors, refcounts, the trie, the scheduler, the samplers) lives on
  rank 0 and is blind to the mode; tp=0 runs the same programs on the
  whole model with no collective.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque
from typing import Iterable

import numpy as np
import torch

from k8s_distributed_deeplearning_torch import faults as _faults
from k8s_distributed_deeplearning_torch.models import generate
from k8s_distributed_deeplearning_torch.serve import quant as quant_lib
from k8s_distributed_deeplearning_torch.serve import tp as tp_lib
from k8s_distributed_deeplearning_torch.serve.page_pool import PagePool
from k8s_distributed_deeplearning_torch.serve.prefix_cache import PrefixCache
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, RequestOutput, SamplingParams)
from k8s_distributed_deeplearning_torch.serve.sched import (
    TenantConfig, TenantScheduler)
from k8s_distributed_deeplearning_torch.telemetry.trace import Tracer
from k8s_distributed_deeplearning_torch.utils.device import resolve_device
from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats

_NULL_TRACER = Tracer(enabled=False)


def _set_cfg(model, cfg) -> None:
    """Point ``model`` and each submodule that shares its config at
    ``cfg``."""
    old = model.cfg
    for m in model.modules():
        if getattr(m, "cfg", None) is old:
            m.cfg = cfg


def _sample_slots(logits: torch.Tensor, temps: np.ndarray,
                  top_ks: np.ndarray, top_ps: np.ndarray,
                  gens: list) -> torch.Tensor:
    """Per-slot sampling: logits [B, V]; ``temps``/``top_ks``/``top_ps``
    host arrays [B] (``temperature <= 0`` => greedy, ``top_k == 0`` and
    ``top_p == 1.0`` => off); ``gens[i]`` the generator of slot i's request
    (None for greedy rows). Same k-then-p filtering as
    :func:`models.generate.filter_logits`. Returns [B] int64 on the
    logits' device."""
    toks = logits.argmax(-1)
    for i in np.flatnonzero(temps > 0.0):
        row = logits[i] / max(float(temps[i]), 1e-6)
        row = generate.filter_logits(row, top_k=int(top_ks[i]),
                                     top_p=float(top_ps[i]))
        toks[i] = torch.multinomial(torch.softmax(row, -1), 1,
                                    generator=gens[i])[0]
    return toks


def _validate_tp_cfg(cfg, tp: int, what: str) -> None:
    """The shardability check of a model under ``tp``, raised at the
    engine's constructor (and mirrored in ``launch/validate.py`` against
    rendered manifests)."""
    heads = getattr(cfg, "n_heads", None)
    if heads is None:
        raise ValueError(
            f"tp={tp} requires a TransformerConfig-style model config "
            f"(n_heads/n_kv_heads/mlp_dim); {what} has cfg={cfg!r}")
    kv = cfg.resolved_kv_heads
    mlp = cfg.resolved_mlp_dim
    if heads % tp:
        raise ValueError(
            f"{what}: n_heads ({heads}) is not divisible by tp ({tp}) — "
            "every shard must own whole attention heads")
    if kv % tp:
        raise ValueError(
            f"{what}: num_kv_heads ({kv}) is not divisible by tp ({tp}) — "
            "the paged pool shards along the KV head dim, so every shard "
            f"must hold kv_heads/tp whole heads (try tp in "
            f"{[d for d in (1, 2, 4, 8) if d <= kv and kv % d == 0]})")
    if mlp % tp:
        raise ValueError(
            f"{what}: mlp_dim ({mlp}) is not divisible by tp ({tp}) — "
            "the column-parallel gate/up projections split the hidden dim")
    if cfg.activation != "swiglu":
        raise ValueError(
            f"{what}: serving TP needs a bias-free down projection "
            f"(activation='swiglu'), got activation={cfg.activation!r} — "
            "a whole down_proj bias would be all-reduced tp times")


class _InFlight:
    """Host-side record for the request occupying a slot."""

    __slots__ = ("req", "tokens", "t_submit", "t_admit", "t_first",
                 "cached_prompt_tokens", "prefill_chunks", "grow_left",
                 "spec_proposed", "spec_accepted", "imported")

    def __init__(self, req: Request, first_token: int, t_admit: float,
                 t_first: float, prefill_chunks: int, grow_left: int,
                 cached_prompt_tokens: int = 0):
        self.req = req
        self.tokens = [first_token]
        self.t_submit = req._t_submit if req._t_submit is not None else t_admit
        self.t_admit = t_admit
        self.t_first = t_first
        self.cached_prompt_tokens = cached_prompt_tokens
        self.prefill_chunks = prefill_chunks
        self.grow_left = grow_left   # reserved-but-unallocated decode pages
        self.spec_proposed = 0       # draft tokens proposed for the request
        self.spec_accepted = 0       # draft tokens accepted AND emitted
        # Adopted by import_request_kv: it never popped this engine's
        # queue, so no scheduler slot is owed back.
        self.imported = False


class _PendingPrefill:
    """A slot whose prompt is still being prefilled. ``pos`` is the
    prefill cursor (the prompt's first ``pos`` tokens are in the slot's
    pages: the mapped prefix-cache hit, then finished chunks); ``nodes``
    pins the trie nodes behind the mapped hit until admission completes;
    ``table`` is the slot's PRIVATE block-table row until then: the
    engine-wide row stays all-scratch meanwhile, because the decode step
    writes a rider row for every slot."""

    __slots__ = ("req", "prompt", "n", "pos", "hit_tokens", "nodes",
                 "t_pop", "chunks", "grow", "table")

    def __init__(self, req: Request, prompt: np.ndarray, hit_tokens: int,
                 nodes: list, t_pop: float, grow: int, table: np.ndarray):
        self.req = req
        self.prompt = prompt
        self.n = int(prompt.shape[0])
        self.pos = hit_tokens
        self.hit_tokens = hit_tokens
        self.nodes = nodes
        self.t_pop = t_pop
        self.chunks = 0
        self.grow = grow
        self.table = table


class ServeEngine:
    """Synchronous continuous-batching engine over a paged KV pool.

    Usage::

        model = LlamaLM(cfg)                          # on the GPU
        eng = ServeEngine(model, num_slots=8, prefill_chunk_tokens=512,
                          prefix_cache_mb=256)
        outputs = eng.run([Request(prompt=[...], max_new_tokens=64)])

    or drive :meth:`step` in a loop while :meth:`busy`. ``device``
    (default ``"cuda"``) must be where ``model`` lives; without a CUDA
    device the default raises, and ``device="cpu"`` runs the plain PyTorch
    versions of the kernels. ``kv_pool_pages`` (None = ``num_slots *
    max_blocks``) sizes the pool; ``prefill_chunk_tokens`` (None = off)
    bounds each iteration's prefill work and must be a positive multiple
    of ``min_bucket``; ``prefix_block_tokens`` (default ``min_bucket``) is
    the page size.

    ``prefix_cache_mb`` (None or 0 = off) bounds the prefix-reuse trie,
    whose pages come out of the same pool: a cached block is one
    refcounted page, mapped into the slots that hit it.

    ``tenants`` (TenantConfigs; None = one unlimited default tenant, i.e.
    FCFS) configures the multi-tenant scheduler; ``max_queue`` bounds each
    tenant that sets no ``max_queue`` of its own.

    ``draft_model`` and ``spec_k`` (both or neither) turn on speculative
    decoding: the draft proposes ``spec_k`` greedy tokens a slot through
    its own paged arena over the same page indices and tables, and one
    target pass verifies the window with exact-match accept. The output is
    the non-speculative engine's, greedy or sampled. The draft must live
    on the engine's device, share the target's vocabulary and cover its
    ``max_seq_len``; it may be ``model`` itself.

    ``kv_quant="int8"`` makes every layer's pool int8 ``(pool_k, pool_v,
    k_scale, v_scale)``, the scales ``[num_pages, page_tokens, kv]`` f32,
    and sets ``kv_quant`` on ``model.cfg`` (and on the draft's, whose
    arena is int8 too). ``weight_quant="int8"`` quantizes ``model``'s (and
    the draft's) matmul weights IN PLACE
    (:func:`serve.quant.quantize_model`, one scale per channel shared
    across layers, as the JAX engine's scanned params): the fp weights are
    gone afterwards. Both modes change the models themselves, where the
    JAX engine clones its models and keeps their params. Engines may share
    one model (its weights held once, as the JAX engines share
    ``params``), and then share its modes: a model already quantized is
    not quantized again, and an engine asking for fp weights or fp KV of a
    model set to int8 raises.

    ``replica_id`` names the engine in a fleet; ``prefill_only`` makes it
    a disaggregated prefill worker (its admitted slots are exported, see
    :meth:`take_exports`; not with ``spec_k``); ``flight`` is a
    :class:`telemetry.flight.FlightRecorder`; ``request_log`` a
    ``MetricsLogger``-shaped ``emit`` target for ``kv_page_leak`` and
    ``request_trace`` (default: the tracer's logger). ``tracer`` is a
    :class:`telemetry.trace.Tracer` for the engine's spans (None = off);
    ``request_trace_sample`` in [0, 1] is the share of request ids whose
    finish emits a ``request_trace`` event (0 = none).

    ``tp`` (0 = the whole model on one device) shards the model and the
    pool over a tp world of exactly ``tp`` ranks that this process leads
    as rank 0 (``serve/tp.py`` ``launch``; the serve CLI's ``--tp``
    starts one); ``tp=1`` is a world of one through the same seam. The
    model and any draft must shard (heads, KV heads and mlp_dim divisible
    by tp, a bias-free SwiGLU MLP). The models may live on rank 0's
    device or on the host: the engine reads their weights one tensor at
    a time into the shards, keeps only their configs (:attr:`cfg`) and
    leaves them as they are, so a caller that drops its models holds
    only rank 0's shard on the card. Under ``weight_quant="int8"`` each
    rank holds fp weights at the int8 grid points (dequantized at load,
    as the JAX engine under tp), so the bytes saved read 0; the pool
    each rank allocates is its ``kv/tp`` heads' lanes.
    """

    def __init__(self, model, *, num_slots: int = 8, max_queue: int = 256,
                 eos_id: int | None = None, pad_id: int = 0,
                 min_bucket: int = 32,
                 prefill_chunk_tokens: int | None = None,
                 prefix_cache_mb: float | None = None,
                 prefix_block_tokens: int | None = None,
                 kv_pool_pages: int | None = None,
                 tenants: Iterable[TenantConfig] | None = None,
                 stats: ServingStats | None = None,
                 device: str | torch.device = "cuda",
                 draft_model=None, spec_k: int = 0,
                 kv_quant: str | None = None,
                 weight_quant: str | None = None,
                 replica_id: str | None = None,
                 prefill_only: bool = False,
                 flight=None, request_log=None,
                 tracer: Tracer | None = None,
                 request_trace_sample: float = 0.0,
                 tp: int = 0):
        dev = resolve_device(device)
        if num_slots < 2:
            raise ValueError(f"num_slots must be >= 2, got {num_slots}")
        if not 0.0 <= request_trace_sample <= 1.0:
            raise ValueError(
                f"request_trace_sample must be in [0, 1], got "
                f"{request_trace_sample}")
        for what, mode in (("kv_quant", kv_quant),
                           ("weight_quant", weight_quant)):
            if mode not in (None, "int8"):
                raise ValueError(
                    f"{what} must be None or 'int8', got {mode!r}")
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is None:
                continue
            param_dev = next(m.parameters()).device
            if tp and param_dev.type == "cpu":      # read into the shards
                continue
            if param_dev.type != dev.type or (
                    dev.index is not None and param_dev.index != dev.index):
                raise ValueError(
                    f"{what} lives on {param_dev}, engine asked for {dev}: "
                    "build the model on the engine's device")
        cfg = model.cfg
        if prefill_chunk_tokens is not None and (
                prefill_chunk_tokens < min_bucket
                or prefill_chunk_tokens % min_bucket):
            raise ValueError(
                f"prefill_chunk_tokens ({prefill_chunk_tokens}) must be a "
                f"positive multiple of min_bucket ({min_bucket})")
        if prefix_cache_mb is not None and prefix_cache_mb < 0:
            raise ValueError(
                f"prefix_cache_mb must be >= 0 (0 = off), got "
                f"{prefix_cache_mb}")
        if (draft_model is None) != (spec_k == 0):
            raise ValueError(
                "speculative decoding needs BOTH a draft model and "
                f"spec_k >= 1 (got draft_model={draft_model!r}, "
                f"spec_k={spec_k})")
        if prefill_only and spec_k:
            raise ValueError(
                "prefill_only is incompatible with speculative decoding "
                "(spec_k > 0): exported KV blobs carry only the target "
                "arena, and a prefill worker never decodes — run the "
                "draft on the decode workers instead")
        if draft_model is not None:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            dcfg = draft_model.cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size ({dcfg.vocab_size}) != target "
                    f"vocab_size ({cfg.vocab_size}) — draft proposals must "
                    "be target token ids")
            if dcfg.max_seq_len < cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len ({dcfg.max_seq_len}) < target "
                    f"max_seq_len ({cfg.max_seq_len}) — the draft cache "
                    "shares the target's block tables and must cover every "
                    "position")
        self.tp = int(tp)
        world = None
        if self.tp < 0:
            raise ValueError(f"tp must be >= 0 (0 = single-device), got {tp}")
        if self.tp:
            _validate_tp_cfg(cfg, self.tp, "target model")
            if draft_model is not None:
                _validate_tp_cfg(draft_model.cfg, self.tp, "draft model")
            world = tp_lib.current()
            if world is None or world.size != self.tp:
                have = ("none is running" if world is None
                        else f"this process's has {world.size}")
                raise ValueError(
                    f"tp={self.tp} needs a tp world of {self.tp} ranks, "
                    f"but {have} — start one with serve.tp.launch("
                    f"{self.tp}) in this process (the serve CLI's --tp "
                    "does), or lower tp")
            if world.rank != 0:
                raise ValueError(
                    f"a tp engine lives on rank 0 of its world, not rank "
                    f"{world.rank}: followers run serve.tp.follow")
            if dev.type != world.device.type or (
                    dev.index is not None and dev != world.device):
                raise ValueError(
                    f"engine asked for {dev}, but rank 0 of the tp world "
                    f"runs on {world.device}")
            for what, m in (("model", model), ("draft_model", draft_model)):
                where = None if m is None else next(m.parameters()).device
                if where is not None and where not in (
                        world.device, torch.device("cpu")):
                    raise ValueError(
                        f"{what} lives on {where}, but rank 0 of the tp "
                        f"world runs on {world.device}: build it there or "
                        "on the host")
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is None:
                continue
            if kv_quant is None and m.cfg.kv_quant is not None:
                raise ValueError(
                    f"{what} is set to kv_quant={m.cfg.kv_quant!r} (an "
                    "engine on the same model asked for it): engines "
                    "sharing a model share its kv_quant")
            if weight_quant is None and quant_lib.is_quantized(m):
                raise ValueError(
                    f"{what}'s weights are int8 (an engine on the same "
                    "model quantized them): engines sharing a model share "
                    "its weight_quant")
        # Under tp the engine keeps no model, only the configs: the
        # weights live in the shards.
        self.model = None if world is not None else model
        self.draft_model = None if world is not None else draft_model
        self.spec_k = int(spec_k)
        self.device = (world.device if world is not None
                       else next(model.parameters()).device)
        self.num_slots = num_slots
        self.max_seq_len = int(cfg.max_seq_len)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.min_bucket = min_bucket
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.stats = stats if stats is not None else ServingStats()
        self.kv_quant = kv_quant
        self.weight_quant = weight_quant
        self.queue = TenantScheduler(tenants, default_max_queue=max_queue)
        self._draining = False
        self._drain_finalized = False
        self.replica_id = replica_id
        self.tracer = tracer if tracer is not None else _NULL_TRACER
        self.request_trace_sample = float(request_trace_sample)
        self.request_log = (request_log if request_log is not None
                            else self.tracer.logger)
        self.flight = flight
        self._last_decode_ms: float | None = None
        self._last_prefill_ms: float | None = None
        if flight is not None:
            # Dump the ring when a fault fires anywhere in the process,
            # before the fault's action runs (weakly held).
            _faults.add_fire_hook(self)
        self.prefill_only = bool(prefill_only)
        self._exports: list[dict] = []
        bt = (prefix_block_tokens if prefix_block_tokens is not None
              else min_bucket)
        if bt < 1 or bt > self.max_seq_len:
            raise ValueError(
                f"prefix_block_tokens ({bt}) must be in "
                f"[1, max_seq_len={self.max_seq_len}]")
        self.page_tokens = int(bt)
        self.max_blocks = -(-self.max_seq_len // self.page_tokens)
        # A verify window writes up to spec_k positions past a cursor that
        # may sit at max_seq_len - 2: the table rows get scratch columns
        # for them, so every position a window writes or reads has a
        # column (where JAX's gather clamps an index past the row).
        self.table_cols = -(-(self.max_seq_len + self.spec_k)
                            // self.page_tokens)
        usable = (int(kv_pool_pages) if kv_pool_pages is not None
                  else num_slots * self.max_blocks)
        if usable < 1:
            raise ValueError(
                f"kv_pool_pages must be >= 1, got {kv_pool_pages}")
        # +1: page 0 is the scratch page.
        self.pool = PagePool(usable + 1, self.page_tokens)
        self._tp_world = world
        self._tp_id = 0
        weight_saved = 0
        if world is not None:
            # Each rank's shard is built from the models' weights (the
            # int8 grid under weight_quant), one tensor at a time; the
            # models stay as they are.
            self._tp_id, self._shard = tp_lib.create_shard(
                world, (model, draft_model), num_pages=self.pool.num_pages,
                page_tokens=self.page_tokens, kv_quant=kv_quant,
                weight_quant=weight_quant)
        else:
            # The arguments hold: now change the models for the modes.
            models = [model] + ([draft_model] if draft_model is not None
                                and draft_model is not model else [])
            if kv_quant is not None:
                for m in models:
                    if m.cfg.kv_quant != kv_quant:
                        _set_cfg(m, dataclasses.replace(m.cfg,
                                                        kv_quant=kv_quant))
            if weight_quant == "int8":
                fp_nbytes = quant_lib.fp_nbytes(model)
                for m in models:
                    if not quant_lib.is_quantized(m):   # shared, done
                        quant_lib.quantize_model(m)
                weight_saved = fp_nbytes - quant_lib.quantized_nbytes(model)
            self._shard = tp_lib.Shard(
                (model, draft_model),
                (self._init_pool(model.cfg),
                 self._init_pool(draft_model.cfg)
                 if draft_model is not None else None))
        self._cache, self._draft_cache = self._shard.caches
        # The target's config (under kv_quant, as the engine set it).
        self.cfg = cfg if world is not None else model.cfg
        # Host register file; kv_lens doubles as the next write position,
        # table rows default to all-scratch (page 0).
        self._tokens = np.full(num_slots, pad_id, np.int32)
        self._kv_lens = np.zeros(num_slots, np.int32)
        self._tables = np.zeros((num_slots, self.table_cols), np.int32)
        self._temps = np.zeros(num_slots, np.float32)
        self._top_ks = np.zeros(num_slots, np.int32)
        self._top_ps = np.ones(num_slots, np.float32)
        self._gens: list[torch.Generator | None] = [None] * num_slots
        self._slots: list[_InFlight | None] = [None] * num_slots
        self._pending: dict[int, _PendingPrefill] = {}
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache_mb is not None and prefix_cache_mb > 0:
            self.prefix_cache = PrefixCache(
                int(prefix_cache_mb * 2 ** 20), block_tokens=self.page_tokens,
                block_nbytes=self._block_nbytes(self.page_tokens),
                release_page=self._release_trie_page)
        self.last_step_prefill_tokens = 0
        self._step_prefill_budget: int | None = None
        self._record_pool_gauges()
        self.stats.record_quant(kv_quant, weight_quant,
                                kv_bytes_saved=self._kv_bytes_saved(),
                                weight_bytes_saved=weight_saved)

    def _init_pool(self, cfg) -> list[tuple]:
        """The whole pool of ``cfg`` (tp=0; see ``serve/tp.py``
        ``paged_pool``)."""
        return tp_lib.paged_pool(cfg, self.pool.num_pages, self.page_tokens,
                                 self.kv_quant, self.device)

    def _kv_bytes_saved(self) -> int:
        """Device bytes the int8 pools (target and draft) save against the
        fp pools they replace (the JAX formula): each int8 lane would have
        cost the compute dtype's itemsize, less the f32 scales. Under tp
        the whole world's: each rank holds 1/tp of every tensor."""
        if self.kv_quant != "int8":
            return 0
        fp_item = torch.finfo(self.cfg.dtype).bits // 8
        saved = 0
        for arena in (self._cache, self._draft_cache):
            for layer in arena or ():
                for t in layer:
                    saved += (-4 * t.numel() if t.dtype == torch.float32
                              else (fp_item - 1) * t.numel())
        return max(0, saved * max(self.tp, 1))

    def _block_nbytes(self, block_tokens: int, *,
                      kv_quant: str | None = "unset") -> int:
        """KV bytes of ``block_tokens`` positions over every layer of the
        target, K and V: under int8 one byte per lane plus a 4-byte scale
        per KV head, else the compute dtype's itemsize per lane
        (``kv_quant`` overrides the engine's mode)."""
        cfg = self.cfg
        mode = self.kv_quant if kv_quant == "unset" else kv_quant
        hd = cfg.resolved_head_dim
        lanes = cfg.resolved_kv_heads * hd
        per_token = (lanes + (lanes // hd) * 4 if mode == "int8"
                     else lanes * (torch.finfo(cfg.dtype).bits // 8))
        return 2 * cfg.n_layers * block_tokens * per_token

    def _need_pages(self, req: Request) -> int:
        """Worst-case pages: prompt [0, n) plus decode growth
        [n, n + max_new - 1) (the last sampled token is never written).
        No prefix-hit credit: the admission probe runs before the trie
        lookup pins anything."""
        total = len(req.prompt) + req.max_new_tokens - 1
        return -(-total // self.page_tokens)

    # ---------------------------------------------------------------- API

    def submit(self, req: Request, *, requeue: bool = False) -> str:
        """Queue a request under its tenant's policy. Raises QueueFull
        (scoped to the tenant) when that tenant's queue is at capacity,
        EngineDraining once :meth:`drain` was called, and ValueError for a
        request that could never run or names an unregistered tenant.

        ``requeue=True`` re-enters a request that was admitted once and
        given back (cancelled as "migrated", say) at the HEAD of its
        deadline class, with its first ``_t_submit`` (so its deadline)
        kept and its tenant's rate and round-robin cost already paid."""
        if self._draining:
            raise EngineDraining(
                f"engine{self._named()} is draining — admitting nothing "
                f"new (request {req.request_id})")
        n = len(req.prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if n + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len}) — the slot's "
                "block table would overflow")
        need = self._need_pages(req)
        if need > self.pool.num_pages - 1:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.pool.num_pages - 1} — raise kv_pool_pages or "
                "lower max_new_tokens")
        if not requeue or req._t_submit is None:
            req._t_submit = time.perf_counter()
        req._finished = False
        if requeue:
            self.queue.requeue(req)
        else:
            self.queue.submit(req)
        return req.request_id

    def _named(self) -> str:
        return f" {self.replica_id!r}" if self.replica_id else ""

    def busy(self) -> bool:
        """True while queued requests, prefills, occupied slots or (on a
        prefill-only engine) exports not yet taken remain."""
        return bool(len(self.queue) or self._pending or self._exports
                    or any(s is not None for s in self._slots))

    def occupied_slots(self) -> int:
        """Decode slots running a request (pending prefills excluded)."""
        return sum(s is not None for s in self._slots)

    def load(self) -> int:
        """Queued + mid-prefill + decoding request count."""
        return len(self.queue) + len(self._pending) + self.occupied_slots()

    def drain(self, *, flush: bool = False) -> list[Request]:
        """Stop admitting (:meth:`submit` raises EngineDraining) while
        :meth:`step` finishes what the engine holds. ``flush=True`` also
        hands the still-queued requests back, untouched, for the caller to
        place elsewhere. Idempotent."""
        self._draining = True
        return self.queue.drain() if flush else []

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` has been called."""
        return self._draining

    @property
    def drained(self) -> bool:
        """True when draining and no work remains."""
        return self._draining and not self.busy()

    def cancel(self, request_id: str, reason: str = "aborted"
               ) -> RequestOutput | None:
        """End ONE request wherever it is: queued (removed, no tokens),
        mid-prefill (pinned trie nodes released, pages freed) or decoding
        (partial tokens, slot freed), with finish_reason *reason*. None
        for an unknown or finished request id."""
        req = self.queue.remove(request_id)
        if req is not None:
            now = time.perf_counter()
            t0 = req._t_submit if req._t_submit is not None else now
            out = RequestOutput(
                request_id=req.request_id, prompt_len=len(req.prompt),
                tokens=[], finish_reason=reason, queue_s=now - t0,
                ttft_s=None, latency_s=now - t0)
            self.stats.record_completion(latency_s=out.latency_s,
                                         n_tokens=0, reason=reason)
            self._emit_request_trace(req, out)
            self._notify_finish(req, reason)
            return out
        for slot in list(self._pending):
            if self._pending[slot].req.request_id == request_id:
                return self._cancel_pending(slot, reason)
        for slot, fl in enumerate(self._slots):
            if fl is not None and fl.req.request_id == request_id:
                return self._finish(slot, reason)
        return None

    # ---------------------------------------------- KV page shipping API
    # A request's KV pages move BY VALUE between engines: a gather by page
    # index on the device and one host copy a pool tensor on the exporter,
    # a copy in and an ``index_copy_`` into fresh pages on the importer.
    # The pools never share device memory, and the blob survives the
    # exporter (the wire codec is serve/disagg.py's). Works at any decode
    # cursor: the prefill->decode handoff exports right after admission,
    # the gateway's drain path mid-decode.
    #
    # Blob layout (the port's own; a JAX engine's blob does not import):
    # ``pages`` is one host array a pool tensor, in the order of
    # ``self._cache`` flattened: layer 0's (pool_k, pool_v) or, under int8
    # KV, (pool_k, pool_v, k_scale, v_scale), then layer 1's, ...; each
    # holds the slot's ``n_pages`` written pages in table order,
    # ``[n_pages, page_tokens, ...]``. bf16 pages travel as their raw
    # int16 view (numpy has no bfloat16); ``page_dtypes`` names each
    # tensor's torch dtype. ``generator_state`` is the slot's
    # ``torch.Generator.get_state()`` (uint8; None for a greedy request)
    # and ``generator_device`` the device type it was drawn on.

    def take_exports(self) -> list[dict]:
        """Hand over (and clear) the export blobs a prefill-only engine
        staged: the coordinator's pickup after each :meth:`step`."""
        out, self._exports = self._exports, []
        return out

    def export_request_kv(self, request_id: str) -> dict:
        """Stage an occupied slot's KV state on the host and release the
        slot WITHOUT finishing the request: it continues on whichever
        engine imports the blob. The blob carries what the decode needs
        to resume the same stream: prompt and emitted tokens, the KV
        cursor, the next input token, the sampling registers and the
        generator state, and the written pages of every pool tensor by
        value. Raises KeyError for a request not in a decode slot (queued
        or mid-prefill requests have nothing worth shipping) and
        ValueError on a speculative engine (the draft arena is not
        shipped)."""
        if self.spec_k:
            raise ValueError(
                "export_request_kv on a speculative engine: the draft "
                "arena's KV is not shipped, so the import side could not "
                "verify drafts — disable spec_k or migrate by token "
                "resubmission instead")
        slot = next((i for i, fl in enumerate(self._slots)
                     if fl is not None
                     and fl.req.request_id == request_id), None)
        if slot is None:
            raise KeyError(
                f"request {request_id!r} does not occupy a decode slot "
                "(only admitted requests have KV pages to export)")
        fl = self._slots[slot]
        req, sp = fl.req, fl.req.sampling
        kv_len = int(self._kv_lens[slot])
        nb = -(-kv_len // self.page_tokens)
        idx = self._host_to_device(self._tables[slot, :nb].astype(np.int64))
        staged, dtypes = [], []
        for rows in self._program(tp_lib.EXPORT, (), idx):
            dtypes.append(str(rows.dtype).removeprefix("torch."))
            if rows.dtype == torch.bfloat16:
                rows = rows.view(torch.int16)
            staged.append(rows.cpu().numpy())
        gen = self._gens[slot]
        blob = {
            "request_id": req.request_id,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "emitted": [int(t) for t in fl.tokens],
            "kv_len": kv_len,
            "next_token": int(self._tokens[slot]),
            "generator_state": (gen.get_state().numpy().copy()
                                if gen is not None else None),
            "generator_device": (self.device.type if gen is not None
                                 else None),
            "temperature": float(sp.temperature),
            "top_k": int(sp.top_k),
            "top_p": float(sp.top_p),
            "seed": int(req.seed),
            "tenant": req.tenant,
            "deadline_s": req.deadline_s,
            "trace_id": req.trace_id,
            "t_submit": fl.t_submit,
            "t_admit": fl.t_admit,
            "t_first": fl.t_first,
            "cached_prompt_tokens": fl.cached_prompt_tokens,
            "prefill_chunks": fl.prefill_chunks,
            "page_tokens": self.page_tokens,
            "n_pages": nb,
            "kv_quant": self.kv_quant,
            "page_dtypes": dtypes,
            "pages": staged,
        }
        # Release the slot WITHOUT the terminal path: no on_finish, no
        # completion record; the request lives on elsewhere.
        self._clear_slot(slot)
        self._release_slot_pages(slot, fl.grow_left)
        if not fl.imported:
            self.queue.release(req)
        self.stats.record_disagg_export(
            pages=nb, nbytes=sum(a.nbytes for a in staged))
        self._record_pool_gauges()
        return blob

    def _pool_tensors(self) -> list[torch.Tensor]:
        """The target arena's tensors in blob order (under tp, rank 0's
        shard of each)."""
        return self._shard.pool_tensors()

    def _free_slot(self) -> int | None:
        for slot in range(self.num_slots):
            if self._slots[slot] is None and slot not in self._pending:
                return slot
        return None

    def _import_need(self, blob: dict) -> tuple[int, int]:
        """(shipped pages, growth reservation) an import costs. Growth is
        recomputed from the request: the exporter may have claimed growth
        pages it never wrote, and those are not shipped."""
        nb = int(blob["n_pages"])
        total = -(-(len(blob["prompt"]) + int(blob["max_new_tokens"]) - 1)
                  // self.page_tokens)
        return nb, max(0, total - nb)

    def _generator_mismatch(self, blob: dict) -> bool:
        return (blob.get("generator_state") is not None
                and blob.get("generator_device") != self.device.type)

    def can_import(self, blob: dict) -> bool:
        """True when :meth:`import_request_kv` would succeed right now: not
        draining, the page geometry, KV mode and generator device match, a
        slot is free, and the pool covers the shipped pages plus the
        remaining growth (evicting unpinned trie pages if that closes the
        gap)."""
        if (self._draining or self.spec_k
                or int(blob["page_tokens"]) != self.page_tokens
                or blob.get("kv_quant") != self.kv_quant
                or self._generator_mismatch(blob)):
            return False
        if (len(blob["prompt"]) + int(blob["max_new_tokens"])
                > self.max_seq_len):
            return False
        if self._free_slot() is None:
            return False
        nb, grow = self._import_need(blob)
        while self.pool.available() < nb + grow:
            if (self.prefix_cache is None
                    or not self.prefix_cache.evict_lru_unpinned()):
                return False
        return True

    def import_request_kv(self, blob: dict,
                          request: Request | None = None) -> int:
        """Adopt an exported request: allocate pages tagged ``imported``,
        scatter the staged KV into them, install the slot's registers and
        generator state, and resume decoding at the shipped cursor (the
        uninterrupted stream, greedy or sampled). *request* is the live
        Request to attach (the in-process path passes it, so streaming
        callbacks survive the hop); None rebuilds one from the blob.
        Emitted tokens are not fired again. Returns the slot; raises
        EngineDraining, ValueError or RuntimeError when the blob cannot be
        adopted here (gate with :meth:`can_import`), with the pool left as
        it was."""
        if self._draining:
            raise EngineDraining(
                f"engine{self._named()} is draining — importing nothing "
                f"new (request {blob.get('request_id')})")
        if self.spec_k:
            raise ValueError(
                "import_request_kv on a speculative engine: the blob "
                "carries no draft-arena KV to verify drafts against")
        if int(blob["page_tokens"]) != self.page_tokens:
            raise ValueError(
                f"page geometry mismatch: blob pages hold "
                f"{blob['page_tokens']} tokens, this pool's hold "
                f"{self.page_tokens} — disagg roles must share "
                "prefix_block_tokens/min_bucket")
        if blob.get("kv_quant") != self.kv_quant:
            raise ValueError(
                f"kv_quant mismatch: blob pages are "
                f"{blob.get('kv_quant') or 'fp'}, this pool is "
                f"{self.kv_quant or 'fp'} — disagg roles must share "
                "kv_quant (pages ship as raw arena values)")
        if self._generator_mismatch(blob):
            raise ValueError(
                f"generator mismatch: the blob's sampling state was drawn "
                f"on {blob.get('generator_device')!r}, this engine draws "
                f"on {self.device.type!r} — a generator's state does not "
                "carry across device types")
        emitted = [int(t) for t in blob["emitted"]]
        if not emitted:
            raise ValueError("blob has no emitted tokens — nothing was "
                             "admitted, resubmit the prompt instead")
        req = request if request is not None else _request_from_blob(blob)
        n = len(req.prompt)
        if self.eos_id is not None and emitted[-1] == self.eos_id:
            raise ValueError(
                f"request {req.request_id} already emitted EOS — it is "
                "terminal, not importable")
        if len(emitted) >= req.max_new_tokens:
            raise ValueError(
                f"request {req.request_id} already emitted "
                f"{len(emitted)}/{req.max_new_tokens} tokens — terminal, "
                "not importable")
        if n + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds this engine's max_seq_len ({self.max_seq_len})")
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError("no free slot to import into — gate with "
                               "can_import()")
        nb, grow = self._import_need(blob)
        while self.pool.available() < nb + grow:
            if (self.prefix_cache is None
                    or not self.prefix_cache.evict_lru_unpinned()):
                raise RuntimeError(
                    f"pool cannot cover import: need {nb} shipped + "
                    f"{grow} growth pages, {self.pool.available()} "
                    "available — gate with can_import()")
        tensors = self._pool_tensors()
        staged = blob["pages"]
        if len(staged) != len(tensors):
            raise ValueError(
                f"blob has {len(staged)} pool tensors, this engine's pool "
                f"has {len(tensors)} — different model geometry")
        pages = self.pool.alloc(nb, owner="imported")
        self.pool.reserve(grow)
        try:
            vals = []
            for t, arr, name in zip(tensors, staged, blob["page_dtypes"]):
                # Blobs carry full-width pages, under tp too.
                want = (nb,) + tuple(t.shape[1:-1]) + (
                    t.shape[-1] * max(self.tp, 1),)
                if tuple(arr.shape) != want or name != str(
                        t.dtype).removeprefix("torch."):
                    raise ValueError(
                        f"staged pool tensor {name} {tuple(arr.shape)} != "
                        f"this pool's {t.dtype} {want} — different model "
                        "geometry or dtype")
                v = torch.from_numpy(np.ascontiguousarray(arr))
                vals.append((v.view(t.dtype) if t.dtype == torch.bfloat16
                             else v).to(self.device))
            self._program(tp_lib.IMPORT, (),
                          self._host_to_device(np.asarray(pages, np.int64)),
                          *vals)
        except Exception:
            # Roll the allocation back before raising: a rejected import
            # leaves the pool as it was and the engine serving.
            for page in pages:
                self.pool.deref(int(page))
            self.pool.unreserve(grow)
            raise
        row = self._tables[slot]
        row[:] = 0
        row[:nb] = pages
        now = time.perf_counter()
        fl = _InFlight(req, emitted[0], float(blob.get("t_admit") or now),
                       float(blob.get("t_first") or now),
                       int(blob.get("prefill_chunks", 0)), grow,
                       cached_prompt_tokens=int(
                           blob.get("cached_prompt_tokens", 0)))
        fl.tokens = emitted
        fl.imported = True
        fl.t_submit = float(blob.get("t_submit") or now)
        req._t_submit = fl.t_submit
        req._finished = False        # re-arm the exactly-once latch
        gen = None
        if blob.get("generator_state") is not None:
            gen = torch.Generator(device=self.device)
            gen.set_state(torch.from_numpy(np.asarray(
                blob["generator_state"], np.uint8).copy()))
        self._slots[slot] = fl
        self._tokens[slot] = int(blob["next_token"])
        self._kv_lens[slot] = int(blob["kv_len"])
        self._temps[slot] = req.sampling.temperature
        self._top_ks[slot] = req.sampling.top_k
        self._top_ps[slot] = req.sampling.top_p
        self._gens[slot] = gen
        self.stats.record_disagg_import(
            pages=nb, nbytes=sum(int(np.asarray(a).nbytes) for a in staged))
        self._record_pool_gauges()
        return slot

    def step(self) -> list[RequestOutput]:
        """One serving iteration: cancel expired requests, admit queued
        requests into free slots (page budget permitting), run at most
        ``prefill_chunk_tokens`` real tokens of prefill, then advance every
        occupied slot: one token, or under speculative decoding 1 to
        ``spec_k + 1``. Returns the requests finished this iteration."""
        outputs: list[RequestOutput] = []
        now = time.perf_counter()
        for slot, fl in enumerate(self._slots):
            if fl is not None and self._expired(fl.req, now):
                outputs.append(self._finish(slot, "timeout"))
        for slot in list(self._pending):
            if self._expired(self._pending[slot].req, now):
                outputs.append(self._cancel_pending(slot, "timeout"))
        for req in self.queue.sweep_expired(now):
            outputs.append(self._timeout_unadmitted(req))
        self.last_step_prefill_tokens = 0
        self._step_prefill_budget = self.prefill_chunk_tokens
        flight_on = self.flight is not None and self.flight.enabled
        t_pf = time.perf_counter() if flight_on else 0.0
        # A request that finishes AT admission frees its slot and pages for
        # the next queued one within the same iteration, budget permitting.
        while True:
            self._admit_free_slots(outputs)
            freed = self._run_prefills(outputs)
            if not (freed and len(self.queue)):
                break
        if flight_on and self.last_step_prefill_tokens:
            self._last_prefill_ms = round(
                (time.perf_counter() - t_pf) * 1e3, 3)
        if self.prefill_only:
            # The prefill role: every slot that completed admission this
            # step is exported instead of decoded (a request that finished
            # AT admission is terminal in ``outputs`` and never ships).
            for fl in self._slots:
                if fl is not None:
                    self._exports.append(
                        self.export_request_kv(fl.req.request_id))
            self._step_epilogue()
            return outputs
        active = self.occupied_slots()
        if active == 0:
            self._step_epilogue()
            return outputs
        # Decode-growth pages: a slot whose next write positions cross
        # into unmapped blocks claims from its reserved pages. A window
        # writes up to spec_k positions past the cursor, but never past
        # the request's own budget (n + max_new - 2 is the last position
        # an emitted token can take): writes beyond land in the scratch
        # page, and the selections they feed are never emitted.
        for slot, fl in enumerate(self._slots):
            if fl is None:
                continue
            first = int(self._kv_lens[slot])
            last = first
            if self.spec_k:
                limit = len(fl.req.prompt) + fl.req.max_new_tokens - 2
                last = min(first + self.spec_k, limit)
            for blk in range(first // self.page_tokens,
                             last // self.page_tokens + 1):
                if self._tables[slot, blk] == 0:
                    self._tables[slot, blk] = self.pool.alloc_reserved(1)[0]
                    fl.grow_left -= 1
        inj = _faults.active()
        if inj is not None:
            inj.fire("serve_decode")
        t_dec = time.perf_counter() if flight_on else 0.0
        if self.spec_k:
            self._spec_decode(active, outputs)
        else:
            self._plain_decode(active, outputs)
        if flight_on:
            self._last_decode_ms = round(
                (time.perf_counter() - t_dec) * 1e3, 3)
        self._step_epilogue()
        return outputs

    def _plain_decode(self, active: int,
                      outputs: list[RequestOutput]) -> None:
        """One token for every occupied slot."""
        with self.tracer.span("decode", active=active):
            nxt = self._decode_step()
        self.stats.record_step(active, self.num_slots)
        for slot, fl in enumerate(self._slots):
            if fl is None:
                continue
            tok = int(nxt[slot])
            # The previous token was just written at kv_lens; the sampled
            # one is the next step's input.
            self._kv_lens[slot] += 1
            self._tokens[slot] = tok
            fl.tokens.append(tok)
            if fl.req.on_token is not None:
                fl.req.on_token(tok)
            if self.eos_id is not None and tok == self.eos_id:
                outputs.append(self._finish(slot, "eos"))
            elif len(fl.tokens) >= fl.req.max_new_tokens:
                outputs.append(self._finish(slot, "length"))

    def _spec_decode(self, active: int,
                     outputs: list[RequestOutput]) -> None:
        """One speculative iteration: the draft's window, one verify pass,
        then the host's accept bookkeeping. Each slot emits the longest
        run of drafts equal to the target's own selections, then the
        target's selection after them (1 to spec_k + 1 tokens); the
        cursor advance is the accept, and rejected positions stay past
        it, never attended, rewritten by the next window."""
        with self.tracer.span("decode", active=active, spec_k=self.spec_k):
            window = self._spec_draft_step()
            sel, states = self._spec_verify_step(window)
            window = window.cpu().numpy()
            sel = sel.cpu().numpy()
        matches = (window[:, 1:] == sel[:, :-1]).astype(np.int32)
        acc = np.cumprod(matches, axis=1).sum(axis=1)
        emitted_total = 0
        proposed = 0
        accepted_counts: list[int] = []
        for slot, fl in enumerate(self._slots):
            if fl is None:
                continue
            a = int(acc[slot])
            # In emission order: the accepted drafts, then the target's
            # correction (a < spec_k) or bonus (a == spec_k) token.
            cand = [int(window[slot, i]) for i in range(1, a + 1)]
            cand.append(int(sel[slot, a]))
            proposed += self.spec_k
            m = 0
            finished = None
            for tok in cand:
                m += 1
                fl.tokens.append(tok)
                if fl.req.on_token is not None:
                    fl.req.on_token(tok)
                if self.eos_id is not None and tok == self.eos_id:
                    finished = "eos"
                    break
                if len(fl.tokens) >= fl.req.max_new_tokens:
                    finished = "length"
                    break
            acc_emitted = min(m, a)
            accepted_counts.append(acc_emitted)
            fl.spec_proposed += self.spec_k
            fl.spec_accepted += acc_emitted
            emitted_total += m
            self._kv_lens[slot] += m
            self._tokens[slot] = cand[m - 1]
            if states[slot]:
                # The generator as it stood after the m-th emitted draw.
                self._gens[slot].set_state(states[slot][m - 1])
            if finished is not None:
                outputs.append(self._finish(slot, finished))
        self.stats.record_step(active, self.num_slots, tokens=emitted_total)
        self.stats.record_spec_step(proposed, accepted_counts)

    def run(self, requests: Iterable[Request] | None = None,
            max_steps: int | None = None) -> list[RequestOutput]:
        """Submit *requests* as queue capacity allows and step until queue,
        prefills and slots are drained. Outputs in completion order."""
        feed = deque(requests) if requests is not None else deque()
        outputs: list[RequestOutput] = []
        steps = 0
        while True:
            while feed:
                try:
                    self.submit(feed[0])
                except QueueFull:
                    break            # back-pressure: resume after this step
                feed.popleft()
            if not (self.busy() or feed):
                break
            outs = self.step()
            outputs.extend(outs)
            if (not outs and len(self.queue) and not self._pending
                    and not any(s is not None for s in self._slots)):
                # Every queued tenant is rate-limited: nothing decodes, so
                # yield while the buckets refill.
                time.sleep(0.001)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return outputs

    def shutdown(self) -> list[RequestOutput]:
        """Abort everything — queued (no tokens), mid-prefill (pinned trie
        nodes released, pages freed) and in-flight (partial tokens) — with
        finish_reason "aborted", then check that no page is left held
        (:meth:`_check_page_leaks`). The engine is reusable afterwards."""
        outs: list[RequestOutput] = []
        now = time.perf_counter()
        for req in self.queue.drain():
            t0 = req._t_submit if req._t_submit is not None else now
            out = RequestOutput(
                request_id=req.request_id, prompt_len=len(req.prompt),
                tokens=[], finish_reason="aborted", queue_s=now - t0,
                ttft_s=None, latency_s=now - t0)
            outs.append(out)
            self._emit_request_trace(req, out)
            self._notify_finish(req, "aborted")
        for slot in list(self._pending):
            outs.append(self._cancel_pending(slot, "aborted"))
        for slot, fl in enumerate(self._slots):
            if fl is not None:
                outs.append(self._finish(slot, "aborted"))
        self._check_page_leaks("shutdown")
        return outs

    # --------------------------------------------------- device programs

    def _host_to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _program(self, prog: int, args: tuple, *operands):
        """The seam every device program goes through (``serve/tp.py``):
        under tp, broadcast the program and its operands to the
        followers; then run it on this rank's shard."""
        if self._tp_world is not None:
            self._tp_world.send(prog, self._tp_id, args, operands)
        return self._shard.run(prog, args, operands)

    def tp_consistency_check(self) -> bool:
        """Under tp: True when every rank's last logits are bit-equal (so
        their activations, and the K/V each rank writes, agree); one
        all-reduced hash. True at tp=0."""
        if self._tp_world is None:
            return True
        return self._program(tp_lib.HASH, ())

    def tp_kernel_check(self, tables: np.ndarray, positions: np.ndarray,
                        *, atol: float, rtol: float = 0.0,
                        seed: int = 0) -> list[list[float]]:
        """Under tp: every rank's paged-attention kernel held to its plain
        version on that rank's own pool shard (the target's layer 0) at
        ``positions`` ``[B, sq]`` through ``tables``, random queries;
        ``[[max abs error, share of atol + rtol x |plain|], ...]`` by
        rank."""
        if self._tp_world is None:
            raise ValueError("tp_kernel_check needs a tp engine")
        return self._program(
            tp_lib.CHECK, (seed, round(atol * 1e9), round(rtol * 1e9)),
            self._host_to_device(tables.astype(np.int32)),
            self._host_to_device(positions.astype(np.int32)))

    def close(self) -> None:
        """Under tp: the followers drop this engine's shards (its pools
        and weights). The engine is unusable afterwards."""
        if self._tp_world is not None and tp_lib.current() is self._tp_world:
            self._tp_world.send(tp_lib.CLOSE, self._tp_id)
        self._tp_world = None

    def _decode_step(self) -> np.ndarray:
        """Every slot advances one token through its block table; returns
        the sampled tokens [num_slots] (the iteration's one host sync)."""
        logits = self._program(
            tp_lib.DECODE, (0,), self._host_to_device(self._tokens),
            self._host_to_device(self._kv_lens),
            self._host_to_device(self._tables))
        nxt = _sample_slots(logits, self._temps, self._top_ks, self._top_ps,
                            self._gens)
        return nxt.cpu().numpy()

    def _spec_draft_step(self) -> torch.Tensor:
        """Draft half: ``spec_k + 1`` greedy single-token steps of the
        draft model through its arena (JAX scans them into one program;
        eager here). Returns the window [num_slots, spec_k + 1] int32 on
        the device: column 0 each slot's last emitted token, then the
        proposals. The last step only writes the last proposal's K/V (no
        LM head), so a fully accepted window leaves the draft arena
        gap-free at the advanced cursor."""
        tok = self._host_to_device(self._tokens)
        kv = self._host_to_device(self._kv_lens)
        tables = self._host_to_device(self._tables)
        cols = [tok]
        for i in range(self.spec_k):
            logits = self._program(tp_lib.DECODE, (1,), cols[-1], kv + i,
                                   tables)
            cols.append(logits.argmax(-1).to(torch.int32))
        self._program(tp_lib.FORWARD, (1, -1), cols[-1][:, None],
                      (kv + self.spec_k)[:, None], tables)
        return torch.stack(cols, 1)

    def _spec_verify_step(self, window: torch.Tensor):
        """Verify half: ONE target pass over the window, written at
        ``kv_lens + [0, W)``, then each position's selection with the
        slot's sampling rule, in window order. Returns ``(sel [B, W],
        states)``: ``states[i]`` is slot i's generator state after each
        position's draw (empty for a greedy slot)."""
        logits = self._program(
            tp_lib.VERIFY, (), window, self._host_to_device(self._kv_lens),
            self._host_to_device(self._tables))
        states: list[list] = [[] for _ in range(self.num_slots)]
        sampled = np.flatnonzero(self._temps > 0.0)
        if not sampled.size:
            return logits.argmax(-1), states
        cols = []
        for j in range(window.shape[1]):
            cols.append(_sample_slots(logits[:, j], self._temps,
                                      self._top_ks, self._top_ps,
                                      self._gens))
            for i in sampled:
                states[i].append(self._gens[i].get_state())
        return torch.stack(cols, 1), states

    def _prefill(self, chunk: np.ndarray, table: np.ndarray, start: int,
                 logits_index: int | None, *, draft: bool = False):
        """Write ``chunk`` at positions ``start + [0, C)`` through
        ``table`` into the target's arena (``draft``: the draft's) and
        return the logits ``logits_index`` picks."""
        positions = (start + torch.arange(chunk.shape[1], dtype=torch.int32,
                                          device=self.device))[None]
        return self._program(
            tp_lib.FORWARD, (int(draft),
                             -1 if logits_index is None else logits_index),
            self._host_to_device(chunk), positions,
            self._host_to_device(table))

    def _prefill_both(self, chunk: np.ndarray, table: np.ndarray,
                      start: int, logits_index: int | None):
        """:meth:`_prefill` into the target's arena and, under
        speculative decoding, the same write into the draft's (no LM
        head there)."""
        out = self._prefill(chunk, table, start, logits_index)
        if self.spec_k:
            self._prefill(chunk, table, start, None, draft=True)
        return out

    # ----------------------------------------------------------- internals

    @staticmethod
    def _expired(req: Request, now: float) -> bool:
        return (req.deadline_s is not None and req._t_submit is not None
                and now - req._t_submit > req.deadline_s)

    @staticmethod
    def _notify_finish(req: Request, reason: str) -> None:
        """Fire ``on_finish`` exactly once per submission."""
        if req._finished:
            return
        req._finished = True
        if req.on_finish is not None:
            req.on_finish(reason)

    def _record_pool_gauges(self) -> None:
        c = self.pool.counters()
        self.stats.record_kv_pool(c["pages_total"], c["pages_used"],
                                  c["pages_shared"],
                                  by_owner=self.pool.owners_summary())

    def _step_epilogue(self) -> None:
        """Every :meth:`step` return: refresh the pool gauges, append the
        step's flight snapshot, and once a draining engine has no work
        left, check it for page leaks and dump the flight ring."""
        self._record_pool_gauges()
        fr = self.flight
        if fr is not None and fr.enabled:
            s = self.stats
            fr.record(
                f"engine:{self.replica_id or 'serve'}",
                step=s.steps,
                queued=len(self.queue),
                tenant_depths=self.queue.depths(),
                pending_prefills=len(self._pending),
                occupied_slots=self.occupied_slots(),
                pool={"used": s.kv_pages_used, "total": s.kv_pages_total,
                      "shared": s.kv_pages_shared,
                      "reserved": self.pool.reserved},
                pool_owners=dict(s.kv_pages_by_owner),
                spec_proposed=s.spec_proposed_tokens,
                spec_accepted=s.spec_accepted_tokens,
                last_decode_ms=self._last_decode_ms,
                last_prefill_ms=self._last_prefill_ms,
                draining=self._draining)
        if self._draining and not self._drain_finalized and not self.busy():
            self._drain_finalized = True
            leak = self._check_page_leaks("drain")
            if fr is not None:
                fr.dump("drain", extra=self._flight_extra(leak))

    def _release_trie_page(self, page: int) -> None:
        """Trie eviction: drop the trie's reference and, when a slot still
        maps the page, attribute it back to the slot."""
        self.pool.deref(page)
        if self.pool.refcount(page):
            self.pool.tag(page, "slot")

    def _check_page_leaks(self, origin: str) -> dict | None:
        """Once every request is terminal nothing is pinned: empty the
        prefix trie (a cache is retention, not a leak), then any page
        still live or reservation outstanding is an accounting leak.
        A leak emits ``kv_page_leak`` on ``request_log`` (origin, replica,
        pages leaked and reserved, by-owner counts, the pages held), is
        counted in ``stats`` (``kv_page_leaks``) and its record is
        returned; None when the pool is clean."""
        if self.prefix_cache is not None:
            while self.prefix_cache.evict_lru_unpinned():
                pass
        self._record_pool_gauges()
        c = self.pool.counters()
        if not c["pages_used"] and not self.pool.reserved:
            return None
        leak = {"origin": origin,
                "replica": self.replica_id,
                "pages_leaked": c["pages_used"],
                "pages_reserved": self.pool.reserved,
                "by_owner": self.pool.owners_summary(),
                "pages_held": self.pool.held_pages()}
        if self.request_log is not None:
            self.request_log.emit("kv_page_leak", **leak)
        self.stats.record_page_leak(leak)
        return leak

    def _flight_extra(self, leak: dict | None = None) -> dict:
        """Terminal context for a flight-dump header: who holds the pool,
        by owner class and by page."""
        extra = {"replica": self.replica_id,
                 "pool": self.pool.counters(),
                 "pages_by_owner": self.pool.owners_summary(),
                 "pages_held": self.pool.held_pages()}
        if leak is not None:
            extra["leak"] = leak
        return extra

    def _on_fault(self, site: str, action: str) -> None:
        """``faults.add_fire_hook`` callback: an injected fault is about to
        run (``exit`` never returns), so dump the ring now."""
        if self.flight is not None:
            self.flight.dump("fault", extra={
                "site": site, "action": action, **self._flight_extra()})

    def _timeout_unadmitted(self, req: Request) -> RequestOutput:
        now = time.perf_counter()
        t0 = req._t_submit if req._t_submit is not None else now
        out = RequestOutput(
            request_id=req.request_id, prompt_len=len(req.prompt),
            tokens=[], finish_reason="timeout", queue_s=now - t0,
            ttft_s=None, latency_s=now - t0)
        self._emit_request_trace(req, out)
        self._notify_finish(req, "timeout")
        return out

    def _sampled(self, request_id: str) -> bool:
        """Whether *request_id*'s finish is traced: a pure hash of the id
        (crc32, the JAX engine's rule), so the same request traces, or
        does not, on every replica and rerun."""
        s = self.request_trace_sample
        if s <= 0.0 or self.request_log is None:
            return False
        if s >= 1.0:
            return True
        return zlib.crc32(request_id.encode()) < s * 2 ** 32

    def _emit_request_trace(self, req: Request, out: RequestOutput) -> None:
        """The lifecycle funnel: every terminal path (``_finish``,
        ``_cancel_pending``, ``_timeout_unadmitted``, a queued cancel and
        shutdown's queued drain) lands here with its RequestOutput; a
        sampled request emits one ``request_trace`` event with the JAX
        engine's fields."""
        if not self._sampled(out.request_id):
            return
        n = len(out.tokens)
        self.request_log.emit(
            "request_trace",
            request_id=out.request_id,
            trace_id=req.trace_id,
            replica=self.replica_id,
            migrated_from=req.migrated_from,
            tenant=req.tenant,
            priority=self.queue.priority_of(req.tenant),
            prompt_len=out.prompt_len,
            cached_prompt_tokens=out.cached_prompt_tokens,
            prefill_chunks=out.prefill_chunks,
            queue_ms=round(out.queue_s * 1e3, 3),
            ttft_ms=(round(out.ttft_s * 1e3, 3)
                     if out.ttft_s is not None else None),
            latency_ms=round(out.latency_s * 1e3, 3),
            new_tokens=n,
            decode_steps=max(0, n - 1),
            tokens_per_s=(round(n / out.latency_s, 1)
                          if n and out.latency_s > 0 else None),
            spec_proposed=out.spec_proposed,
            spec_accepted=out.spec_accepted,
            kv_quant=self.kv_quant,
            weight_quant=self.weight_quant,
            finish_reason=out.finish_reason)
        self.stats.record_request_trace()

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_seq_len)

    def _fits(self, req: Request) -> bool:
        """Admission-time page probe: can the pool cover the request's
        worst-case need right now? Trie-only pages are reclaimable: evict
        unpinned LRU leaves until it fits or the trie runs dry. False
        defers the request in place."""
        need = self._need_pages(req)
        while self.pool.available() < need:
            if (self.prefix_cache is None
                    or not self.prefix_cache.evict_lru_unpinned()):
                return False
        return True

    def _admit_free_slots(self, outputs: list[RequestOutput]) -> None:
        for slot in range(self.num_slots):
            while (self._slots[slot] is None and slot not in self._pending
                   and len(self.queue)):
                req = self.queue.pop(fits=self._fits)
                if req is None:
                    return
                if self._expired(req, time.perf_counter()):
                    self.queue.release(req)
                    outputs.append(self._timeout_unadmitted(req))
                    continue
                self._begin_admission(slot, req)
                break

    def _begin_admission(self, slot: int, req: Request) -> None:
        """Map the longest trie-cached prefix into a private table row
        (each matched page ref'd, no device copy), allocate pages for the
        rest of the prompt, reserve worst-case decode growth, and park the
        slot as a pending prefill from the hit on. Cannot fail: ``_fits``
        checked the (hit-blind) need before the pop."""
        n = len(req.prompt)
        t_pop = time.perf_counter()
        prompt = np.asarray(req.prompt, np.int32)
        bt = self.page_tokens
        hit, nodes = 0, []
        table = np.zeros(self.table_cols, np.int32)
        with self.tracer.span("admission", prompt_len=n, slot=slot):
            if self.prefix_cache is not None:
                hit, nodes = self.prefix_cache.acquire(prompt.tolist())
                self.stats.record_prefix_lookup(hit, n)
                for j, node in enumerate(nodes):
                    self.pool.ref(node.page)
                    table[j] = node.page
            n_prompt_blocks = -(-n // bt)
            table[hit // bt:n_prompt_blocks] = self.pool.alloc(
                n_prompt_blocks - hit // bt)
            grow = -(-(n + req.max_new_tokens - 1) // bt) - n_prompt_blocks
            self.pool.reserve(grow)
        self._pending[slot] = _PendingPrefill(req, prompt, hit, nodes,
                                              t_pop, grow, table)
        t0 = req._t_submit if req._t_submit is not None else t_pop
        self.stats.record_admission(queue_s=t_pop - t0, prompt_len=n)

    def _run_prefills(self, outputs: list[RequestOutput]) -> bool:
        """Advance pending prefills FIFO within this step's token budget:
        exact C-token intermediate chunks, then the bucketed final chunk
        that completes admission. Returns True when a request finished AT
        admission and freed its slot."""
        freed = False
        c = self.prefill_chunk_tokens
        for slot in list(self._pending):
            pend = self._pending[slot]
            while True:
                rem = pend.n - pend.pos
                budget = self._step_prefill_budget
                if c is not None and rem > c:
                    if budget is not None and budget < c:
                        break       # out of budget; resume next iteration
                    with self.tracer.span("prefill", chunk=c, slot=slot):
                        self._prefill_both(
                            pend.prompt[None, pend.pos:pend.pos + c],
                            pend.table[None], pend.pos, None)
                    pend.pos += c
                    pend.chunks += 1
                    self._charge_prefill(c)
                    continue
                if budget is not None and rem > budget:
                    break
                out = self._finish_admission(slot, pend)
                self._charge_prefill(rem)
                if out is not None:
                    outputs.append(out)
                    freed = True
                break
        return freed

    def _charge_prefill(self, tokens: int) -> None:
        self.last_step_prefill_tokens += int(tokens)
        if self._step_prefill_budget is not None:
            self._step_prefill_budget = max(
                0, self._step_prefill_budget - int(tokens))

    def _finish_admission(self, slot: int,
                          pend: _PendingPrefill) -> RequestOutput | None:
        """Run the final chunk, right-padded to its bucket, sample the
        first token from its last real column, hand the trie the prompt's
        new whole blocks, and activate the slot. Returns a RequestOutput
        when the request finished at admission (first token EOS, or a
        one-token budget)."""
        req, n = pend.req, pend.n
        rem = n - pend.pos
        sp = req.sampling
        bucket = self._bucket(rem)
        chunk = np.full((1, bucket), self.pad_id, np.int32)
        chunk[0, :rem] = pend.prompt[pend.pos:]
        # Install the row engine-wide now; the cursor moves to n below,
        # before the next decode, so rider writes land past the prompt.
        self._tables[slot, :] = pend.table
        gen = None
        if sp.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(req.seed)
        with self.tracer.span("prefill", bucket=bucket, slot=slot,
                              cached=pend.hit_tokens):
            logits = self._prefill_both(chunk, self._tables[slot:slot + 1],
                                        pend.pos, rem - 1)
            first = int(_sample_slots(
                logits, np.array([sp.temperature], np.float32),
                np.array([sp.top_k], np.int32),
                np.array([sp.top_p], np.float32), [gen])[0])
        if self.prefix_cache is not None:
            # The trie takes its own reference on each new whole prompt
            # block's page: the K/V outlives the slot, and later requests
            # map it.
            def page_for_block(i: int) -> int:
                page = int(self._tables[slot, i])
                self.pool.ref(page)
                self.pool.tag(page, "trie")
                return page

            _, evicted = self.prefix_cache.insert(pend.prompt.tolist(),
                                                  page_for_block)
            if evicted:
                self.stats.record_prefix_evictions(evicted)
            self.prefix_cache.release(pend.nodes)
            pend.nodes = []
        del self._pending[slot]
        now = time.perf_counter()
        # prefill_chunks: the intermediate chunks + the final sampling one.
        fl = _InFlight(req, first, pend.t_pop, now, pend.chunks + 1,
                       pend.grow, cached_prompt_tokens=pend.hit_tokens)
        self._slots[slot] = fl
        self._tokens[slot] = first
        self._kv_lens[slot] = n          # next write position
        self._temps[slot] = sp.temperature
        self._top_ks[slot] = sp.top_k
        self._top_ps[slot] = sp.top_p
        self._gens[slot] = gen
        self.stats.record_first_token(ttft_s=now - fl.t_submit)
        if req.on_token is not None:
            req.on_token(first)
        if self.eos_id is not None and first == self.eos_id:
            return self._finish(slot, "eos")
        if req.max_new_tokens == 1:
            return self._finish(slot, "length")
        return None

    def _release_slot_pages(self, slot: int, grow_left: int,
                            row: np.ndarray | None = None) -> None:
        """Deref every mapped page (freeing those the trie does not also
        hold), reset the row to all-scratch, return unused growth
        reservation. *row* is a pending slot's private row."""
        if row is None:
            row = self._tables[slot]
        for page in row[row != 0]:
            self.pool.deref(int(page))
        row[:] = 0
        if grow_left:
            self.pool.unreserve(grow_left)

    def _cancel_pending(self, slot: int, reason: str) -> RequestOutput:
        pend = self._pending.pop(slot)
        if self.prefix_cache is not None and pend.nodes:
            self.prefix_cache.release(pend.nodes)
            pend.nodes = []
        self._release_slot_pages(slot, pend.grow, row=pend.table)
        now = time.perf_counter()
        t0 = pend.req._t_submit if pend.req._t_submit is not None else now
        out = RequestOutput(
            request_id=pend.req.request_id, prompt_len=pend.n, tokens=[],
            finish_reason=reason, queue_s=pend.t_pop - t0, ttft_s=None,
            latency_s=now - t0, cached_prompt_tokens=pend.hit_tokens,
            prefill_chunks=pend.chunks)
        self.stats.record_completion(latency_s=out.latency_s, n_tokens=0,
                                     reason=reason)
        self.queue.release(pend.req)
        self._emit_request_trace(pend.req, out)
        self._notify_finish(pend.req, reason)
        return out

    def _finish(self, slot: int, reason: str) -> RequestOutput:
        fl = self._slots[slot]
        now = time.perf_counter()
        out = RequestOutput(
            request_id=fl.req.request_id, prompt_len=len(fl.req.prompt),
            tokens=list(fl.tokens), finish_reason=reason,
            queue_s=fl.t_admit - fl.t_submit,
            ttft_s=fl.t_first - fl.t_submit,
            latency_s=now - fl.t_submit,
            cached_prompt_tokens=fl.cached_prompt_tokens,
            prefill_chunks=fl.prefill_chunks,
            spec_proposed=fl.spec_proposed,
            spec_accepted=fl.spec_accepted)
        self._clear_slot(slot)
        self._release_slot_pages(slot, fl.grow_left)
        self.stats.record_completion(latency_s=out.latency_s,
                                     n_tokens=len(out.tokens), reason=reason)
        if not fl.imported:
            self.queue.release(fl.req)
        self._emit_request_trace(fl.req, out)
        self._notify_finish(fl.req, reason)
        return out

    def _clear_slot(self, slot: int) -> None:
        """Reset a decode slot's registers to a free rider's."""
        self._slots[slot] = None
        self._tokens[slot] = self.pad_id
        self._kv_lens[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 1.0
        self._gens[slot] = None


def _request_from_blob(blob: dict) -> Request:
    """The Request an importer rebuilds from an export blob when the
    caller attaches none (``serve/disagg.py`` ``request_from_blob``)."""
    return Request(
        prompt=[int(t) for t in blob["prompt"]],
        max_new_tokens=int(blob["max_new_tokens"]),
        sampling=SamplingParams(temperature=float(blob["temperature"]),
                                top_k=int(blob["top_k"]),
                                top_p=float(blob["top_p"])),
        request_id=str(blob["request_id"]),
        seed=int(blob["seed"]),
        tenant=blob.get("tenant") or "default",
        deadline_s=blob.get("deadline_s"),
        **({"trace_id": blob["trace_id"]} if blob.get("trace_id") else {}))
