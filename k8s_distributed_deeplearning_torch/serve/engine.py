"""Continuous-batching serving engine over a paged KV pool.

Port of the core of ``k8s_distributed_deeplearning_tpu/serve/engine.py``
(``ServeEngine``): the same host-side design, with PyTorch calls where the
JAX engine runs its three compiled programs.

- The KV cache is ONE pool of fixed-size pages per layer
  (``[num_pages, page_tokens, kv·head_dim]``, K and V). Each slot owns a
  host-side block table row mapping its virtual sequence onto pool pages.
  Page bookkeeping is host-side (:class:`serve.page_pool.PagePool`):
  admission allocates the prompt's pages and RESERVES the request's
  worst-case decode growth, so the mid-decode page-boundary allocation
  cannot fail; back-pressure exists only at admission.
- Admission prefills straight into the pool: intermediate chunks of
  exactly ``prefill_chunk_tokens`` real tokens (no LM head), then a final
  chunk right-padded to a power-of-two bucket that samples the first token
  from column ``length - 1``. Pad writes past the table land in the
  scratch page 0; pad writes inside the last page sit past the cursor and
  are never attended.
- Every iteration runs one decode step for all slots. Free slots ride
  along with all-scratch tables: their writes land in page 0 and are never
  attended. The host register file (tokens, cursors, tables, sampling
  params) is numpy, shipped to the device each step, and the sampled
  tokens come back in the iteration's one host sync.
- Sampling is per slot: greedy rows take the argmax; a sampled request
  draws from its own ``torch.Generator`` seeded with ``Request.seed``, so
  its stream depends only on the request, not on its slot.

- Quantized serving (``kv_quant="int8"``, ``weight_quant="int8"``): int8
  KV pages with per-token-per-head f32 scales, read by the int8 branch of
  the paged-attention kernel; per-channel int8 matmul weights
  (``serve/quant.py``), dequantized at use.

Not ported yet: the prefix cache, the multi-tenant scheduler, speculative
decoding, tensor parallelism, KV export/import, drain/cancel, the flight
recorder and fault sites.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

import numpy as np
import torch

from k8s_distributed_deeplearning_torch.models import generate
from k8s_distributed_deeplearning_torch.serve import quant as quant_lib
from k8s_distributed_deeplearning_torch.serve.page_pool import PagePool
from k8s_distributed_deeplearning_torch.serve.request import (
    QueueFull, Request, RequestOutput)
from k8s_distributed_deeplearning_torch.serve.scheduler import RequestQueue
from k8s_distributed_deeplearning_torch.utils.device import resolve_device
from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats


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


class _InFlight:
    """Host-side record for the request occupying a slot."""

    __slots__ = ("req", "tokens", "t_submit", "t_admit", "t_first",
                 "prefill_chunks", "grow_left")

    def __init__(self, req: Request, first_token: int, t_admit: float,
                 t_first: float, prefill_chunks: int, grow_left: int):
        self.req = req
        self.tokens = [first_token]
        self.t_submit = req._t_submit if req._t_submit is not None else t_admit
        self.t_admit = t_admit
        self.t_first = t_first
        self.prefill_chunks = prefill_chunks
        self.grow_left = grow_left   # reserved-but-unallocated decode pages


class _PendingPrefill:
    """A slot whose prompt is still being prefilled. ``pos`` is the
    prefill cursor; ``table`` is the slot's PRIVATE block-table row until
    admission completes — the engine-wide row stays all-scratch meanwhile,
    because the decode step writes a rider row for every slot."""

    __slots__ = ("req", "prompt", "n", "pos", "t_pop", "chunks", "grow",
                 "table")

    def __init__(self, req: Request, prompt: np.ndarray, t_pop: float,
                 grow: int, table: np.ndarray):
        self.req = req
        self.prompt = prompt
        self.n = int(prompt.shape[0])
        self.pos = 0
        self.t_pop = t_pop
        self.chunks = 0
        self.grow = grow
        self.table = table


class ServeEngine:
    """Synchronous continuous-batching engine over a paged KV pool.

    Usage::

        model = LlamaLM(cfg)                          # on the GPU
        eng = ServeEngine(model, num_slots=8, prefill_chunk_tokens=512)
        outputs = eng.run([Request(prompt=[...], max_new_tokens=64)])

    or drive :meth:`step` in a loop while :meth:`busy`. ``device``
    (default ``"cuda"``) must be where ``model`` lives; without a CUDA
    device the default raises, and ``device="cpu"`` runs the plain PyTorch
    versions of the kernels. ``kv_pool_pages`` (None = ``num_slots *
    max_blocks``) sizes the pool; ``prefill_chunk_tokens`` (None = off)
    bounds each iteration's prefill work and must be a positive multiple
    of ``min_bucket``; ``prefix_block_tokens`` (default ``min_bucket``) is
    the page size.

    ``kv_quant="int8"`` makes every layer's pool int8 ``(pool_k, pool_v,
    k_scale, v_scale)``, the scales ``[num_pages, page_tokens, kv]`` f32,
    and sets ``kv_quant`` on ``model.cfg``. ``weight_quant="int8"``
    quantizes ``model``'s matmul weights IN PLACE
    (:func:`serve.quant.quantize_model`, one scale per channel shared
    across layers, as the JAX engine's scanned params): the model's fp
    weights are gone afterwards. Both modes change ``model`` itself, where
    the JAX engine clones its model and keeps its params.
    """

    def __init__(self, model, *, num_slots: int = 8, max_queue: int = 256,
                 eos_id: int | None = None, pad_id: int = 0,
                 min_bucket: int = 32,
                 prefill_chunk_tokens: int | None = None,
                 prefix_block_tokens: int | None = None,
                 kv_pool_pages: int | None = None,
                 stats: ServingStats | None = None,
                 device: str | torch.device = "cuda",
                 kv_quant: str | None = None,
                 weight_quant: str | None = None):
        dev = resolve_device(device)
        if num_slots < 2:
            raise ValueError(f"num_slots must be >= 2, got {num_slots}")
        for what, mode in (("kv_quant", kv_quant),
                           ("weight_quant", weight_quant)):
            if mode not in (None, "int8"):
                raise ValueError(
                    f"{what} must be None or 'int8', got {mode!r}")
        param_dev = next(model.parameters()).device
        if param_dev.type != dev.type or (
                dev.index is not None and param_dev.index != dev.index):
            raise ValueError(
                f"model lives on {param_dev}, engine asked for {dev}: build "
                "the model on the engine's device")
        cfg = model.cfg
        if prefill_chunk_tokens is not None and (
                prefill_chunk_tokens < min_bucket
                or prefill_chunk_tokens % min_bucket):
            raise ValueError(
                f"prefill_chunk_tokens ({prefill_chunk_tokens}) must be a "
                f"positive multiple of min_bucket ({min_bucket})")
        self.model = model
        self.device = param_dev
        self.num_slots = num_slots
        self.max_seq_len = int(cfg.max_seq_len)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.min_bucket = min_bucket
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.stats = stats if stats is not None else ServingStats()
        self.kv_quant = kv_quant
        self.weight_quant = weight_quant
        self.queue = RequestQueue(max_queue)
        bt = (prefix_block_tokens if prefix_block_tokens is not None
              else min_bucket)
        if bt < 1 or bt > self.max_seq_len:
            raise ValueError(
                f"prefix_block_tokens ({bt}) must be in "
                f"[1, max_seq_len={self.max_seq_len}]")
        self.page_tokens = int(bt)
        self.max_blocks = -(-self.max_seq_len // self.page_tokens)
        usable = (int(kv_pool_pages) if kv_pool_pages is not None
                  else num_slots * self.max_blocks)
        if usable < 1:
            raise ValueError(
                f"kv_pool_pages must be >= 1, got {kv_pool_pages}")
        # +1: page 0 is the scratch page.
        self.pool = PagePool(usable + 1, self.page_tokens)
        # The arguments hold: now change the model for the modes.
        if kv_quant is not None and cfg.kv_quant != kv_quant:
            _set_cfg(model, dataclasses.replace(cfg, kv_quant=kv_quant))
        weight_saved = 0
        if weight_quant == "int8":
            fp_nbytes = quant_lib.params_nbytes(model)
            quant_lib.quantize_model(model)
            weight_saved = fp_nbytes - quant_lib.quantized_nbytes(model)
        kv = cfg.resolved_kv_heads
        shape = (self.pool.num_pages, self.page_tokens,
                 kv * cfg.resolved_head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if kv_quant == "int8":
            self._cache = [
                (zeros(shape, torch.int8), zeros(shape, torch.int8),
                 zeros(shape[:2] + (kv,), torch.float32),
                 zeros(shape[:2] + (kv,), torch.float32))
                for _ in range(cfg.n_layers)]
        else:
            self._cache = [(zeros(shape, cfg.dtype), zeros(shape, cfg.dtype))
                           for _ in range(cfg.n_layers)]
        # Host register file; kv_lens doubles as the next write position,
        # table rows default to all-scratch (page 0).
        self._tokens = np.full(num_slots, pad_id, np.int32)
        self._kv_lens = np.zeros(num_slots, np.int32)
        self._tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self._temps = np.zeros(num_slots, np.float32)
        self._top_ks = np.zeros(num_slots, np.int32)
        self._top_ps = np.ones(num_slots, np.float32)
        self._gens: list[torch.Generator | None] = [None] * num_slots
        self._slots: list[_InFlight | None] = [None] * num_slots
        self._pending: dict[int, _PendingPrefill] = {}
        self.last_step_prefill_tokens = 0
        self._step_prefill_budget: int | None = None
        self._record_pool_gauges()
        self.stats.record_quant(kv_quant, weight_quant,
                                kv_bytes_saved=self._kv_bytes_saved(),
                                weight_bytes_saved=weight_saved)

    def _kv_bytes_saved(self) -> int:
        """Device bytes the int8 pools save against the fp pools they
        replace (the JAX formula): each int8 lane would have cost the
        compute dtype's itemsize, less the f32 scales."""
        if self.kv_quant != "int8":
            return 0
        fp_item = torch.finfo(self.model.cfg.dtype).bits // 8
        saved = 0
        for layer in self._cache:
            for t in layer:
                saved += (-4 * t.numel() if t.dtype == torch.float32
                          else (fp_item - 1) * t.numel())
        return max(0, saved)

    def _block_nbytes(self, block_tokens: int, *,
                      kv_quant: str | None = "unset") -> int:
        """KV bytes of ``block_tokens`` positions over every layer, K and
        V: under int8 one byte per lane plus a 4-byte scale per KV head,
        else the compute dtype's itemsize per lane (``kv_quant`` overrides
        the engine's mode)."""
        cfg = self.model.cfg
        mode = self.kv_quant if kv_quant == "unset" else kv_quant
        hd = cfg.resolved_head_dim
        lanes = cfg.resolved_kv_heads * hd
        per_token = (lanes + (lanes // hd) * 4 if mode == "int8"
                     else lanes * (torch.finfo(cfg.dtype).bits // 8))
        return 2 * cfg.n_layers * block_tokens * per_token

    def _need_pages(self, req: Request) -> int:
        """Worst-case pages: prompt [0, n) plus decode growth
        [n, n + max_new - 1) (the last sampled token is never written)."""
        total = len(req.prompt) + req.max_new_tokens - 1
        return -(-total // self.page_tokens)

    # ---------------------------------------------------------------- API

    def submit(self, req: Request) -> str:
        """Queue a request. Raises QueueFull when the queue is at capacity
        and ValueError for a request that could never run."""
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
        self.queue.submit(req)
        req._t_submit = time.perf_counter()
        req._finished = False
        return req.request_id

    def busy(self) -> bool:
        """True while queued requests, prefills or occupied slots remain."""
        return bool(len(self.queue) or self._pending
                    or any(s is not None for s in self._slots))

    def occupied_slots(self) -> int:
        """Decode slots running a request (pending prefills excluded)."""
        return sum(s is not None for s in self._slots)

    def load(self) -> int:
        """Queued + mid-prefill + decoding request count."""
        return len(self.queue) + len(self._pending) + self.occupied_slots()

    def step(self) -> list[RequestOutput]:
        """One serving iteration: cancel expired requests, admit queued
        requests into free slots (page budget permitting), run at most
        ``prefill_chunk_tokens`` real tokens of prefill, then advance every
        occupied slot one token. Returns the requests finished this
        iteration."""
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
        # A request that finishes AT admission frees its slot and pages for
        # the next queued one within the same iteration, budget permitting.
        while True:
            self._admit_free_slots(outputs)
            freed = self._run_prefills(outputs)
            if not (freed and len(self.queue)):
                break
        active = self.occupied_slots()
        if active == 0:
            self._record_pool_gauges()
            return outputs
        # Decode-growth pages: a slot whose next write crosses into an
        # unmapped block claims one of its reserved pages.
        for slot, fl in enumerate(self._slots):
            if fl is None:
                continue
            blk = int(self._kv_lens[slot]) // self.page_tokens
            if self._tables[slot, blk] == 0:
                self._tables[slot, blk] = self.pool.alloc_reserved(1)[0]
                fl.grow_left -= 1
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
        self._record_pool_gauges()
        return outputs

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
            outputs.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return outputs

    def shutdown(self) -> list[RequestOutput]:
        """Abort everything — queued (no tokens), mid-prefill (pages
        freed) and in-flight (partial tokens) — with finish_reason
        "aborted". The engine is reusable afterwards."""
        outs: list[RequestOutput] = []
        now = time.perf_counter()
        for req in self.queue.drain():
            t0 = req._t_submit if req._t_submit is not None else now
            outs.append(RequestOutput(
                request_id=req.request_id, prompt_len=len(req.prompt),
                tokens=[], finish_reason="aborted", queue_s=now - t0,
                ttft_s=None, latency_s=now - t0))
            self._notify_finish(req, "aborted")
        for slot in list(self._pending):
            outs.append(self._cancel_pending(slot, "aborted"))
        for slot, fl in enumerate(self._slots):
            if fl is not None:
                outs.append(self._finish(slot, "aborted"))
        self._record_pool_gauges()
        return outs

    # --------------------------------------------------- device programs

    def _host_to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode_step(self) -> np.ndarray:
        """Every slot advances one token through its block table; returns
        the sampled tokens [num_slots] (the iteration's one host sync)."""
        logits = generate.slot_decode_step(
            self.model, self._cache, self._host_to_device(self._tokens),
            self._host_to_device(self._kv_lens),
            self._host_to_device(self._tables))
        nxt = _sample_slots(logits, self._temps, self._top_ks, self._top_ps,
                            self._gens)
        return nxt.cpu().numpy()

    def _prefill(self, chunk: np.ndarray, table: np.ndarray, start: int,
                 logits_index: int | None):
        positions = (start + torch.arange(chunk.shape[1], dtype=torch.int32,
                                          device=self.device))[None]
        return generate.prefill_chunk(
            self.model, self._cache, self._host_to_device(chunk),
            positions=positions, block_tables=self._host_to_device(table),
            logits_index=logits_index)

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
                                  c["pages_shared"])

    def _timeout_unadmitted(self, req: Request) -> RequestOutput:
        now = time.perf_counter()
        t0 = req._t_submit if req._t_submit is not None else now
        self._notify_finish(req, "timeout")
        return RequestOutput(
            request_id=req.request_id, prompt_len=len(req.prompt),
            tokens=[], finish_reason="timeout", queue_s=now - t0,
            ttft_s=None, latency_s=now - t0)

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_seq_len)

    def _fits(self, req: Request) -> bool:
        """Admission-time page probe: can the pool cover the request's
        worst-case need right now? False defers it in place."""
        return self.pool.available() >= self._need_pages(req)

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
        """Allocate the prompt's pages into a private table row, reserve
        worst-case decode growth, and park the slot as a pending prefill.
        Cannot fail: ``_fits`` checked the need before the pop."""
        n = len(req.prompt)
        t_pop = time.perf_counter()
        bt = self.page_tokens
        table = np.zeros(self.max_blocks, np.int32)
        n_prompt_blocks = -(-n // bt)
        table[:n_prompt_blocks] = self.pool.alloc(n_prompt_blocks)
        grow = -(-(n + req.max_new_tokens - 1) // bt) - n_prompt_blocks
        self.pool.reserve(grow)
        self._pending[slot] = _PendingPrefill(
            req, np.asarray(req.prompt, np.int32), t_pop, grow, table)
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
                    self._prefill(pend.prompt[None, pend.pos:pend.pos + c],
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
        first token from its last real column, and activate the slot.
        Returns a RequestOutput when the request finished at admission
        (first token EOS, or a one-token budget)."""
        req, n = pend.req, pend.n
        rem = n - pend.pos
        sp = req.sampling
        chunk = np.full((1, self._bucket(rem)), self.pad_id, np.int32)
        chunk[0, :rem] = pend.prompt[pend.pos:]
        # Install the row engine-wide now; the cursor moves to n below,
        # before the next decode, so rider writes land past the prompt.
        self._tables[slot, :] = pend.table
        gen = None
        if sp.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(req.seed)
        logits = self._prefill(chunk, self._tables[slot:slot + 1], pend.pos,
                               rem - 1)
        first = int(_sample_slots(
            logits, np.array([sp.temperature], np.float32),
            np.array([sp.top_k], np.int32), np.array([sp.top_p], np.float32),
            [gen])[0])
        del self._pending[slot]
        now = time.perf_counter()
        # prefill_chunks: the intermediate chunks + the final sampling one.
        fl = _InFlight(req, first, pend.t_pop, now, pend.chunks + 1,
                       pend.grow)
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
        """Deref every mapped page, reset the row to all-scratch, return
        unused growth reservation. *row* is a pending slot's private row."""
        if row is None:
            row = self._tables[slot]
        for page in row[row != 0]:
            self.pool.deref(int(page))
        row[:] = 0
        if grow_left:
            self.pool.unreserve(grow_left)

    def _cancel_pending(self, slot: int, reason: str) -> RequestOutput:
        pend = self._pending.pop(slot)
        self._release_slot_pages(slot, pend.grow, row=pend.table)
        now = time.perf_counter()
        t0 = pend.req._t_submit if pend.req._t_submit is not None else now
        out = RequestOutput(
            request_id=pend.req.request_id, prompt_len=pend.n, tokens=[],
            finish_reason=reason, queue_s=pend.t_pop - t0, ttft_s=None,
            latency_s=now - t0, prefill_chunks=pend.chunks)
        self.stats.record_completion(latency_s=out.latency_s, n_tokens=0,
                                     reason=reason)
        self.queue.release(pend.req)
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
            prefill_chunks=fl.prefill_chunks)
        self._slots[slot] = None
        self._tokens[slot] = self.pad_id
        self._kv_lens[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 1.0
        self._gens[slot] = None
        self._release_slot_pages(slot, fl.grow_left)
        self.stats.record_completion(latency_s=out.latency_s,
                                     n_tokens=len(out.tokens), reason=reason)
        self.queue.release(fl.req)
        self._notify_finish(fl.req, reason)
        return out
