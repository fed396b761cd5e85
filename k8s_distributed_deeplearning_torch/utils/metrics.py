"""Structured serving and training metrics.

Port of the parts of ``k8s_distributed_deeplearning_tpu/utils/metrics.py``
the serving engine, the gateway, the disagg coordinator, the wire
transport, the training loop and the CLIs use: :class:`ServingStats` (the
methods they call, and a ``summary()`` with the JAX package's serving,
prefix-cache, request-trace, gateway, transport, disagg and speculative
fields), a JSON-lines :class:`MetricsLogger` with its ``train_step`` event,
and :func:`mfu`.
"""
from __future__ import annotations

import functools
import json
import sys
import threading
import time
from typing import IO, Any


class MetricsLogger:
    """Emit one JSON object per event to stdout and optionally a file.

    Each event is ONE write of the line and its newline, under a lock:
    a replica server emits from its handler and step threads at once, and
    ``print`` writes the newline separately, so two events could share a
    line."""

    def __init__(self, stream: IO[str] | None = None,
                 path: str | None = None, job: str = "serve",
                 enabled: bool = True):
        self.enabled = enabled             # False on non-primary processes
        self.stream = stream if stream is not None else sys.stdout
        self.job = job
        self._file = open(path, "a") if (path and enabled) else None
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def emit(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        rec = {"event": event, "job": self.job,
               "elapsed_s": round(time.monotonic() - self._t0, 3), **fields}
        line = json.dumps(rec, default=repr) + "\n"
        with self._lock:
            self.stream.write(line)
            self.stream.flush()
            if self._file:
                self._file.write(line)
                self._file.flush()

    def train_step(self, step: int, loss: float, step_time_ms: float,
                   examples_per_sec: float, per_device: float,
                   mfu: float | None = None, **extra: Any) -> None:
        self.emit("train_step", step=step, loss=loss,
                  step_time_ms=step_time_ms,
                  examples_per_sec=examples_per_sec,
                  examples_per_sec_per_device=per_device,
                  **({"mfu": mfu} if mfu is not None else {}), **extra)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


def mfu(flops_per_example: float, examples_per_sec: float, num_devices: int,
        peak_flops_per_device: float) -> float:
    """Model FLOPs utilization: achieved model FLOP/s over peak FLOP/s."""
    if peak_flops_per_device <= 0 or num_devices <= 0:
        return 0.0
    return (flops_per_example * examples_per_sec
            / (peak_flops_per_device * num_devices))


# Published dense peaks of one H100 SXM (NVIDIA's data sheet), by compute
# dtype: bf16 on the tensor cores, f32 outside them.
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _locked(method):
    """Run *method* under ``self._lock``. ServingStats is written by the
    engine/gateway step path and read mid-step by exporter collector
    threads (``summary()``); the RLock makes each record/summary atomic —
    RLock, not Lock, because ``summary()`` reads the ``total_tokens``
    property on the same thread."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return wrapper


class ServingStats:
    """Aggregates the engine's observations into tokens/sec, TTFT and
    latency percentiles, and mean slot occupancy. The clock runs from the
    first recorded event to the last. One emitted token per admission (the
    prefill-sampled first token) plus one per active slot per decode step.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self.t_start: float | None = None
        self.t_last: float | None = None
        self.steps = 0
        self.decode_tokens = 0
        self.occupancy_sum = 0.0
        self.admitted = 0
        self.completed = 0
        self.prompt_tokens = 0
        self.queue_s: list[float] = []
        self.ttft_s: list[float] = []
        self.latency_s: list[float] = []
        self.finish_reasons: dict[str, int] = {}
        # Prefix cache: one lookup per admission (a hit matched >= 1
        # block); the token counts say how much prefill was skipped.
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.prefix_evictions = 0
        # Sampled request_trace lifecycle events emitted.
        self.request_traces = 0
        self.kv_pages_total = 0
        self.kv_pages_used = 0
        self.kv_pages_shared = 0
        # Page ledger: owner class -> live pages, plus the reservation.
        self.kv_pages_by_owner: dict[str, int] = {}
        # Leak checks (shutdown, end of a drain) that found pages still
        # held or reserved with every request terminal, and the last one.
        self.kv_page_leaks = 0
        self.kv_page_leak_last: dict | None = None
        # Failover gateway (serve/gateway.py): dispatches to a replica,
        # migrations off tripped or draining replicas, hedge dispatches,
        # breaker trips, and requests quarantined after too many
        # migrations.
        self.gateway_dispatches = 0
        self.gateway_migrations = 0
        self.gateway_hedges = 0
        self.gateway_breaker_trips = 0
        self.gateway_poisoned = 0
        # Remote-replica transport (serve/transport.py): calls retried
        # after a transient failure, submits and page transfers the
        # replica server deduplicated, and streams resumed after failed
        # polls.
        self.transport_retries = 0
        self.transport_dedup_hits = 0
        self.transport_reconnects = 0
        # Disaggregated prefill/decode (serve/disagg.py): KV exports
        # staged off this engine, imports adopted into it, bytes shipped
        # each way, unified-path fallbacks, and the coordinator's latest
        # backlog a role.
        self.disagg_exports = 0
        self.disagg_imports = 0
        self.disagg_bytes_shipped = 0
        self.disagg_fallbacks = 0
        self.disagg_prefill_depth = 0
        self.disagg_decode_depth = 0
        # Speculative decoding: draft tokens proposed and accepted-and-
        # emitted, iterations run, and the accepted-draft count of each
        # slot-iteration binned (key 0..spec_k).
        self.spec_steps = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_accept_hist: dict[int, int] = {}
        # Quantized serving: the modes (None = fp) and the device bytes the
        # int8 pools and weights save against fp. Gauges, set once when
        # the engine is built.
        self.kv_quant: str | None = None
        self.weight_quant: str | None = None
        self.kv_quant_bytes_saved = 0
        self.weight_quant_bytes_saved = 0

    def _tick(self) -> None:
        now = time.perf_counter()
        if self.t_start is None:
            self.t_start = now
        self.t_last = now

    @_locked
    def record_admission(self, queue_s: float, prompt_len: int) -> None:
        self._tick()
        self.admitted += 1
        self.prompt_tokens += prompt_len
        self.queue_s.append(queue_s)

    @_locked
    def record_first_token(self, ttft_s: float) -> None:
        self._tick()
        self.ttft_s.append(ttft_s)

    @_locked
    def record_step(self, active_slots: int, num_slots: int,
                    tokens: int | None = None) -> None:
        """One decode iteration. ``tokens`` overrides the emitted-token
        count (a speculative iteration emits 1 to spec_k + 1 tokens a
        slot); None counts one per active slot."""
        self._tick()
        self.steps += 1
        self.decode_tokens += active_slots if tokens is None else int(tokens)
        self.occupancy_sum += active_slots / max(num_slots, 1)

    @_locked
    def record_spec_step(self, proposed: int, accepted_counts) -> None:
        """One speculative iteration: ``proposed`` draft tokens in all,
        and each active slot's accepted-and-emitted draft count."""
        self._tick()
        self.spec_steps += 1
        self.spec_proposed_tokens += int(proposed)
        for a in accepted_counts:
            a = int(a)
            self.spec_accepted_tokens += a
            self.spec_accept_hist[a] = self.spec_accept_hist.get(a, 0) + 1

    @_locked
    def record_prefix_lookup(self, hit_tokens: int,
                             prompt_tokens: int) -> None:
        """One prefix-cache lookup at admission: ``hit_tokens`` of the
        ``prompt_tokens``-long prompt came from cached KV."""
        self._tick()
        if hit_tokens > 0:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        self.prefix_hit_tokens += hit_tokens
        self.prefix_lookup_tokens += prompt_tokens

    @_locked
    def record_prefix_evictions(self, n_blocks: int) -> None:
        self._tick()
        self.prefix_evictions += n_blocks

    @_locked
    def record_kv_pool(self, pages_total: int, pages_used: int,
                       pages_shared: int,
                       by_owner: dict | None = None) -> None:
        """Latest pool snapshot; a gauge, so it does not tick the clock.
        ``by_owner`` is the page ledger's attribution (None keeps the
        last one)."""
        self.kv_pages_total = int(pages_total)
        self.kv_pages_used = int(pages_used)
        self.kv_pages_shared = int(pages_shared)
        if by_owner is not None:
            self.kv_pages_by_owner = {k: int(v) for k, v in by_owner.items()}

    @_locked
    def record_page_leak(self, leak: dict) -> None:
        """A leak check found an accounting leak; ``leak`` is the engine's
        record (origin, pages leaked and reserved, by-owner counts)."""
        self.kv_page_leaks += 1
        self.kv_page_leak_last = dict(leak)

    @_locked
    def record_request_trace(self) -> None:
        """One sampled ``request_trace`` lifecycle event was emitted."""
        self._tick()
        self.request_traces += 1

    @_locked
    def record_transport_retry(self) -> None:
        """One remote-replica transport call retried after a transient
        failure (connection error / timeout / injected network fault)."""
        self._tick()
        self.transport_retries += 1

    @_locked
    def record_transport_dedup(self) -> None:
        """One retried submit (or page chunk) was deduplicated by the
        replica server: it had landed but its response was lost."""
        self._tick()
        self.transport_dedup_hits += 1

    @_locked
    def record_transport_reconnect(self) -> None:
        """One token stream resumed from its emitted-token cursor after one
        or more failed polls."""
        self._tick()
        self.transport_reconnects += 1

    @_locked
    def record_gateway_dispatch(self) -> None:
        """One gateway dispatch (first placement, migration or hedge)."""
        self._tick()
        self.gateway_dispatches += 1

    @_locked
    def record_gateway_migration(self) -> None:
        """One live request moved off a tripped or draining replica."""
        self._tick()
        self.gateway_migrations += 1

    @_locked
    def record_gateway_hedge(self) -> None:
        """One duplicate dispatch for a request still without its first
        token."""
        self._tick()
        self.gateway_hedges += 1

    @_locked
    def record_gateway_breaker_trip(self) -> None:
        """One replica's circuit breaker opened."""
        self._tick()
        self.gateway_breaker_trips += 1

    @_locked
    def record_gateway_poisoned(self) -> None:
        """One request spent its migration budget and ended "poisoned"."""
        self._tick()
        self.gateway_poisoned += 1

    @_locked
    def record_disagg_export(self, pages: int, nbytes: int) -> None:
        """One request's KV pages staged off this engine."""
        self._tick()
        self.disagg_exports += 1
        self.disagg_bytes_shipped += int(nbytes)

    @_locked
    def record_disagg_import(self, pages: int, nbytes: int) -> None:
        """One exported request adopted into this engine's pool."""
        self._tick()
        self.disagg_imports += 1
        self.disagg_bytes_shipped += int(nbytes)

    @_locked
    def record_disagg_fallback(self) -> None:
        """One request routed down the unified decode-local prefill
        path."""
        self._tick()
        self.disagg_fallbacks += 1

    @_locked
    def record_disagg_depth(self, prefill: int, decode: int) -> None:
        """The coordinator's latest backlog a role; a gauge, no tick."""
        self.disagg_prefill_depth = int(prefill)
        self.disagg_decode_depth = int(decode)

    @_locked
    def record_quant(self, kv_quant: str | None, weight_quant: str | None,
                     kv_bytes_saved: int, weight_bytes_saved: int) -> None:
        """The engine's quantization modes and bytes saved; set at
        construction, which is not serving activity: no tick."""
        self.kv_quant = kv_quant
        self.weight_quant = weight_quant
        self.kv_quant_bytes_saved = int(kv_bytes_saved)
        self.weight_quant_bytes_saved = int(weight_bytes_saved)

    @_locked
    def record_completion(self, latency_s: float, n_tokens: int,
                          reason: str) -> None:
        self._tick()
        self.completed += 1
        self.latency_s.append(latency_s)
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1

    @property
    def total_tokens(self) -> int:
        """Emitted tokens: one per admission + one per active slot-step."""
        return self.decode_tokens + len(self.ttft_s)

    @staticmethod
    def _pct(xs: list[float], q: float) -> float | None:
        if not xs:
            return None
        s = sorted(xs)
        return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]

    @_locked
    def summary(self) -> dict:
        elapsed = ((self.t_last - self.t_start)
                   if self.t_start is not None and self.t_last is not None
                   else 0.0)
        return {
            "elapsed_s": round(elapsed, 4),
            "requests_admitted": self.admitted,
            "requests_completed": self.completed,
            "finish_reasons": dict(self.finish_reasons),
            "total_tokens": self.total_tokens,
            "prompt_tokens": self.prompt_tokens,
            "tokens_per_sec": (round(self.total_tokens / elapsed, 1)
                               if elapsed > 0 else None),
            "decode_steps": self.steps,
            "mean_slot_occupancy": (round(self.occupancy_sum / self.steps, 4)
                                    if self.steps else None),
            "ttft_p50_ms": _ms(self._pct(self.ttft_s, 0.5)),
            "ttft_p95_ms": _ms(self._pct(self.ttft_s, 0.95)),
            "queue_p50_ms": _ms(self._pct(self.queue_s, 0.5)),
            "queue_p95_ms": _ms(self._pct(self.queue_s, 0.95)),
            "latency_p50_ms": _ms(self._pct(self.latency_s, 0.5)),
            "latency_p95_ms": _ms(self._pct(self.latency_s, 0.95)),
            "prefix_cache_hits": self.prefix_hits,
            "prefix_cache_misses": self.prefix_misses,
            "prefix_cache_evictions": self.prefix_evictions,
            "request_traces_sampled": self.request_traces,
            "kv_pages_total": self.kv_pages_total,
            "kv_pages_used": self.kv_pages_used,
            "kv_pages_shared": self.kv_pages_shared,
            "kv_pages_by_owner": dict(self.kv_pages_by_owner),
            "kv_page_leaks": self.kv_page_leaks,
            "kv_page_leak_last": self.kv_page_leak_last,
            "gateway_dispatches": self.gateway_dispatches,
            "gateway_migrations": self.gateway_migrations,
            "gateway_hedges": self.gateway_hedges,
            "gateway_breaker_trips": self.gateway_breaker_trips,
            "gateway_poisoned": self.gateway_poisoned,
            "transport_retries": self.transport_retries,
            "transport_dedup_hits": self.transport_dedup_hits,
            "transport_reconnects": self.transport_reconnects,
            "disagg_exports": self.disagg_exports,
            "disagg_imports": self.disagg_imports,
            "disagg_bytes_shipped": self.disagg_bytes_shipped,
            "disagg_fallbacks": self.disagg_fallbacks,
            "disagg_prefill_depth": self.disagg_prefill_depth,
            "disagg_decode_depth": self.disagg_decode_depth,
            "kv_quant": self.kv_quant,
            "weight_quant": self.weight_quant,
            "kv_quant_bytes_saved": self.kv_quant_bytes_saved,
            "weight_quant_bytes_saved": self.weight_quant_bytes_saved,
            "spec_steps": self.spec_steps,
            "spec_proposed_tokens": self.spec_proposed_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            # Share of proposed drafts accepted and emitted (None until
            # the first speculative iteration).
            "spec_acceptance_rate": (
                round(self.spec_accepted_tokens / self.spec_proposed_tokens,
                      4) if self.spec_proposed_tokens else None),
            "spec_accept_hist": {str(k): v for k, v in
                                 sorted(self.spec_accept_hist.items())},
            # Share of looked-up prompt tokens served from cached KV
            # (None until the first lookup).
            "prefix_hit_rate": (
                round(self.prefix_hit_tokens / self.prefix_lookup_tokens, 4)
                if self.prefix_lookup_tokens else None),
        }


def _ms(s: float | None) -> float | None:
    return round(s * 1e3, 3) if s is not None else None
