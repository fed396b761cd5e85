"""Bridges between existing state and the Prometheus registry.

The port's own copy of part of ``k8s_distributed_deeplearning_tpu/
telemetry/bridge.py``: the host and device probes, the train loop's gauge
set (``TrainTelemetry``) and the serving, storm, scheduler, gateway and
heartbeat collectors, with the JAX package's metric family names (device
memory too stays ``jax_device_bytes``, its values from
``torch.cuda.memory_stats``), so the fleet plane and dashboards read
either package. The registry (:mod:`telemetry.registry`) is deliberately dumb —
names and numbers; this module owns the *semantics*: how
:class:`utils.metrics.ServingStats` maps onto the scrape surface, and the
host/device resource probes (RSS from ``/proc``, device memory from
``torch.cuda.memory_stats``). Everything here degrades to a no-op off
Linux / without a CUDA device — a scrape must never crash the workload.
The fleet controller's gauges come from ``autoscale_collector``, each
replica's tensor-parallel width from ``tp_collector``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from k8s_distributed_deeplearning_torch.telemetry.registry import (
    MetricsRegistry)

if TYPE_CHECKING:
    from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats


def host_rss_bytes() -> int | None:
    """Resident set size from ``/proc/self/statm`` (None off Linux)."""
    try:
        import os
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def device_memory_stats() -> dict[str, int]:
    """``bytes_in_use``/``peak_bytes_in_use``/``bytes_limit`` summed over
    the process's CUDA devices (the JAX probe's keys, from
    ``torch.cuda.memory_stats`` and each device's total memory). Without a
    CUDA device (or before CUDA is up) returns {} — callers simply skip
    the gauges."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        totals: dict[str, int] = {}
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            got = {"bytes_in_use": stats.get("allocated_bytes.all.current"),
                   "peak_bytes_in_use": stats.get(
                       "allocated_bytes.all.peak"),
                   "bytes_limit": torch.cuda.get_device_properties(
                       d).total_memory}
            for k, v in got.items():
                if v is not None:
                    totals[k] = totals.get(k, 0) + int(v)
        return totals
    except Exception:
        return {}


class TrainTelemetry:
    """The train loop's gauge set, updated at the existing ``log_every``
    cadence (the loss fetch is already the host sync point — piggybacking
    there adds no extra device round-trip)."""

    def __init__(self, registry: MetricsRegistry, rank: int = 0):
        self.registry = registry
        self.rank = rank
        self.steps = registry.counter(
            "train_steps_total", "optimizer steps completed")
        self.step_time = registry.gauge(
            "train_step_time_ms", "mean step wall time over the last window")
        self.examples = registry.gauge(
            "train_examples_per_sec", "global examples (or tokens) per sec")
        self.loss = registry.gauge("train_loss", "last logged training loss")
        self.mfu = registry.gauge(
            "train_mfu", "model FLOPs utilization (0..1)")
        self.checkpoints = registry.counter(
            "train_checkpoints_total", "checkpoint writes")
        self.rss = registry.gauge(
            "process_resident_memory_bytes", "host RSS of this process")
        self.dev_mem = registry.gauge(
            "jax_device_bytes", "summed local-device allocator stats",
            labelnames=("stat",))

    def on_log(self, *, steps_in_window: int, loss: float,
               step_time_ms: float, examples_per_sec: float,
               mfu: float | None) -> None:
        self.steps.inc(steps_in_window)
        self.step_time.set(step_time_ms)
        self.examples.set(examples_per_sec)
        self.loss.set(loss)
        if mfu is not None:
            self.mfu.set(mfu)
        rss = host_rss_bytes()
        if rss is not None:
            self.rss.set(rss)
        for k, v in device_memory_stats().items():
            self.dev_mem.labels(stat=k).set(v)

    def on_checkpoint(self) -> None:
        self.checkpoints.inc()


def serving_collector(registry: MetricsRegistry,
                      stats: "ServingStats") -> None:
    """Register a pull-time collector mapping ``ServingStats.summary()``
    onto serve gauges — the scrape reads whatever the engine has
    aggregated so far, with no push on the decode path."""
    g = {
        "serve_requests_admitted": registry.gauge(
            "serve_requests_admitted", "requests admitted into slots"),
        "serve_requests_completed": registry.gauge(
            "serve_requests_completed", "requests completed"),
        "serve_tokens_per_sec": registry.gauge(
            "serve_tokens_per_sec", "aggregate emitted tokens per second"),
        "serve_total_tokens": registry.gauge(
            "serve_total_tokens", "emitted tokens so far"),
        "serve_mean_slot_occupancy": registry.gauge(
            "serve_mean_slot_occupancy",
            "mean fraction of decode slots doing useful work"),
        "serve_ttft_p50_ms": registry.gauge(
            "serve_ttft_p50_ms", "time-to-first-token p50"),
        "serve_ttft_p95_ms": registry.gauge(
            "serve_ttft_p95_ms", "time-to-first-token p95"),
        "serve_latency_p95_ms": registry.gauge(
            "serve_latency_p95_ms", "request latency p95"),
        "serve_queue_p50_ms": registry.gauge(
            "serve_queue_p50_ms", "admission queue wait p50"),
        "serve_queue_p95_ms": registry.gauge(
            "serve_queue_p95_ms", "admission queue wait p95"),
        "serve_prefix_cache_hits": registry.gauge(
            "serve_prefix_cache_hits",
            "admissions that reused >= 1 cached prefix block"),
        "serve_prefix_cache_misses": registry.gauge(
            "serve_prefix_cache_misses",
            "admissions with no cached prefix"),
        "serve_prefix_cache_evictions": registry.gauge(
            "serve_prefix_cache_evictions",
            "prefix-cache KV blocks evicted under the byte budget"),
        "serve_prefix_hit_rate": registry.gauge(
            "serve_prefix_hit_rate",
            "fraction of looked-up prompt tokens served from cached KV"),
        "serve_request_traces_sampled": registry.gauge(
            "serve_request_traces_sampled",
            "request_trace lifecycle events emitted (graftscope sampling)"),
        "serve_kv_pages_total": registry.gauge(
            "serve_kv_pages_total",
            "usable pages in the paged KV pool (scratch excluded)"),
        "serve_kv_pages_used": registry.gauge(
            "serve_kv_pages_used",
            "KV pool pages currently referenced by a slot or the trie"),
        "serve_kv_pages_shared": registry.gauge(
            "serve_kv_pages_shared",
            "KV pool pages with >= 2 holders (copy-free prefix sharing)"),
        "serve_gateway_dispatches_total": registry.gauge(
            "serve_gateway_dispatches_total",
            "gateway request placements onto a replica (first dispatch, "
            "migration resubmits and hedges included)"),
        "serve_gateway_migrations_total": registry.gauge(
            "serve_gateway_migrations_total",
            "in-flight requests migrated off a tripped/draining replica"),
        "serve_gateway_hedges_total": registry.gauge(
            "serve_gateway_hedges_total",
            "speculative duplicate dispatches for straggling prefills"),
        "serve_gateway_breaker_trips_total": registry.gauge(
            "serve_gateway_breaker_trips_total",
            "per-replica circuit breaker open transitions"),
        "serve_gateway_poisoned_total": registry.gauge(
            "serve_gateway_poisoned_total",
            "requests quarantined after exhausting the gateway's "
            "max_migrations budget (terminal reason 'poisoned')"),
        "serve_transport_retries_total": registry.gauge(
            "serve_transport_retries_total",
            "remote-replica transport calls retried after a transient "
            "failure (connection error / timeout / injected fault)"),
        "serve_transport_dedup_hits_total": registry.gauge(
            "serve_transport_dedup_hits_total",
            "retried submits the replica server deduplicated by "
            "request_id (ambiguous failures resolved exactly-once)"),
        "serve_transport_reconnects_total": registry.gauge(
            "serve_transport_reconnects_total",
            "token streams resumed from their emitted-token cursor "
            "after failed polls"),
        "serve_disagg_exports_total": registry.gauge(
            "serve_disagg_exports_total",
            "requests whose prompt KV pages were exported by a prefill "
            "worker for cross-role shipping (serve/disagg.py)"),
        "serve_disagg_imports_total": registry.gauge(
            "serve_disagg_imports_total",
            "requests adopted by a decode engine from shipped KV pages "
            "(freshly allocated under the 'imported' pool owner)"),
        "serve_disagg_bytes_shipped_total": registry.gauge(
            "serve_disagg_bytes_shipped_total",
            "KV page bytes moved by value between prefill and decode "
            "engines (host-staged, both directions of the transfer)"),
        "serve_disagg_fallbacks_total": registry.gauge(
            "serve_disagg_fallbacks_total",
            "requests the coordinator routed to unified decode-local "
            "prefill because no prefill worker was healthy (disagg is "
            "a performance mode, never an availability dependency)"),
        "serve_disagg_prefill_depth": registry.gauge(
            "serve_disagg_prefill_depth",
            "in-flight requests currently held by prefill workers"),
        "serve_disagg_decode_depth": registry.gauge(
            "serve_disagg_decode_depth",
            "in-flight disagg requests currently decoding"),
        "serve_spec_steps_total": registry.gauge(
            "serve_spec_steps_total",
            "speculative (draft-and-verify) decode iterations run"),
        "serve_spec_proposed_tokens_total": registry.gauge(
            "serve_spec_proposed_tokens_total",
            "draft tokens proposed across all speculative iterations"),
        "serve_spec_accepted_tokens_total": registry.gauge(
            "serve_spec_accepted_tokens_total",
            "draft tokens accepted AND emitted"),
        "serve_spec_acceptance_rate": registry.gauge(
            "serve_spec_acceptance_rate",
            "fraction of proposed draft tokens accepted and emitted"),
        "serve_kv_quant_bytes_saved": registry.gauge(
            "serve_kv_quant_bytes_saved",
            "HBM bytes the int8 KV pool saves vs its fp equivalent "
            "(arena shrink minus the f32 scale siblings' overhead; "
            "0 when kv_quant is off)"),
        "serve_weight_quant_bytes_saved": registry.gauge(
            "serve_weight_quant_bytes_saved",
            "device bytes the int8 serving weights save vs fp params "
            "(0 when weight_quant is off, or under tp where resident "
            "weights stay fp)"),
    }
    quant_mode = registry.gauge(
        "serve_quant_mode",
        "active quantization mode as a 0/1 flag per (kind, mode) label "
        "pair — Prometheus gauges are numeric, so the mode string rides "
        "the label, not the value",
        labelnames=("kind", "mode"))
    spec_hist = registry.gauge(
        "serve_spec_accepted_per_step",
        "slot-iterations by accepted-draft count (0..spec_k) — the "
        "acceptance distribution behind the mean rate",
        labelnames=("accepted",))
    finished = registry.gauge(
        "serve_finished_total",
        "requests finished by reason (eos/length/timeout/abort/...) — "
        "the SLO availability ratio's numerator and denominator",
        labelnames=("reason",))
    pages_by_owner = registry.gauge(
        "serve_kv_pages_by_owner",
        "live KV pool pages by ledger owner class (slot/trie/draft) plus "
        "the reserved decode-growth headroom — who holds memory right now",
        labelnames=("owner",))
    key_map = {"requests_admitted": "serve_requests_admitted",
               "requests_completed": "serve_requests_completed",
               "tokens_per_sec": "serve_tokens_per_sec",
               "total_tokens": "serve_total_tokens",
               "mean_slot_occupancy": "serve_mean_slot_occupancy",
               "ttft_p50_ms": "serve_ttft_p50_ms",
               "ttft_p95_ms": "serve_ttft_p95_ms",
               "latency_p95_ms": "serve_latency_p95_ms",
               "queue_p50_ms": "serve_queue_p50_ms",
               "queue_p95_ms": "serve_queue_p95_ms",
               "prefix_cache_hits": "serve_prefix_cache_hits",
               "prefix_cache_misses": "serve_prefix_cache_misses",
               "prefix_cache_evictions": "serve_prefix_cache_evictions",
               "prefix_hit_rate": "serve_prefix_hit_rate",
               "request_traces_sampled": "serve_request_traces_sampled",
               "kv_pages_total": "serve_kv_pages_total",
               "kv_pages_used": "serve_kv_pages_used",
               "kv_pages_shared": "serve_kv_pages_shared",
               "gateway_dispatches": "serve_gateway_dispatches_total",
               "gateway_migrations": "serve_gateway_migrations_total",
               "gateway_hedges": "serve_gateway_hedges_total",
               "gateway_breaker_trips": "serve_gateway_breaker_trips_total",
               "gateway_poisoned": "serve_gateway_poisoned_total",
               "disagg_exports": "serve_disagg_exports_total",
               "disagg_imports": "serve_disagg_imports_total",
               "disagg_bytes_shipped": "serve_disagg_bytes_shipped_total",
               "disagg_fallbacks": "serve_disagg_fallbacks_total",
               "disagg_prefill_depth": "serve_disagg_prefill_depth",
               "disagg_decode_depth": "serve_disagg_decode_depth",
               "spec_steps": "serve_spec_steps_total",
               "spec_proposed_tokens": "serve_spec_proposed_tokens_total",
               "spec_accepted_tokens": "serve_spec_accepted_tokens_total",
               "spec_acceptance_rate": "serve_spec_acceptance_rate",
               "transport_retries": "serve_transport_retries_total",
               "transport_dedup_hits": "serve_transport_dedup_hits_total",
               "transport_reconnects": "serve_transport_reconnects_total",
               "kv_quant_bytes_saved": "serve_kv_quant_bytes_saved",
               "weight_quant_bytes_saved": "serve_weight_quant_bytes_saved"}

    def collect() -> None:
        summ = stats.summary()
        for src, dst in key_map.items():
            v = summ.get(src)
            if v is not None:
                g[dst].set(float(v))
        for reason, count in summ.get("finish_reasons", {}).items():
            finished.labels(reason=str(reason)).set(float(count))
        for accepted, count in summ.get("spec_accept_hist", {}).items():
            spec_hist.labels(accepted=str(accepted)).set(float(count))
        for owner, count in summ.get("kv_pages_by_owner", {}).items():
            pages_by_owner.labels(owner=str(owner)).set(float(count))
        for kind in ("kv", "weight"):
            mode = summ.get(f"{kind}_quant") or "off"
            quant_mode.labels(kind=kind, mode=str(mode)).set(1.0)

    registry.register_collector(collect)


def storm_collector(registry: MetricsRegistry, monitor,
                    injector=None) -> None:
    """Register a pull-time collector over a graftstorm
    :class:`serve.storm.InvariantMonitor`: the dashboard's soak panel
    watches violations (which must stay at zero) and the open-loop
    requests-in-flight level, plus submission and fault-firing totals so
    a flatlined soak is distinguishable from a healthy quiet one. Same
    zero-push discipline as :func:`serving_collector`."""
    g_viol = registry.gauge(
        "serve_storm_invariant_violations_total",
        "invariant violations detected by the chaos-soak monitor "
        "(conservation / leaks / parity / coherence) — any nonzero "
        "value is a bug, not an operating condition")
    g_flight = registry.gauge(
        "serve_storm_requests_in_flight",
        "storm requests submitted but not yet terminal (open-loop "
        "backlog under chaos)")
    g_sub = registry.gauge(
        "serve_storm_requests_submitted_total",
        "requests the storm traffic generator has submitted so far")
    g_fired = registry.gauge(
        "serve_storm_faults_fired_total",
        "fault injections executed by the storm schedule so far")

    def collect() -> None:
        g_viol.set(float(len(monitor.violations)))
        g_flight.set(float(monitor.in_flight()))
        g_sub.set(float(monitor.submitted_total()))
        g_fired.set(float(len(injector.fired) if injector is not None
                          else 0))

    registry.register_collector(collect)


def tp_collector(registry: MetricsRegistry, engines) -> None:
    """Register a collector exporting each local engine's tensor-parallel
    width: the ``serve_tp`` gauge reports the tp world's size per replica
    (1 = a single-device engine). Engines never change width after
    construction, so the gauge is a config surface, exported at pull time
    like everything else here."""
    g = registry.gauge(
        "serve_tp",
        "tensor-parallel width per serving replica (shard_map mesh size; "
        "1 = single-device)",
        labelnames=("replica",))

    def collect() -> None:
        for i, eng in enumerate(engines):
            rid = getattr(eng, "replica_id", None) or f"r{i}"
            g.labels(replica=str(rid)).set(float(getattr(eng, "tp", 0)
                                                 or 1))

    registry.register_collector(collect)


def sched_collector(registry: MetricsRegistry, sched) -> None:
    """Register a pull-time collector over the multi-tenant scheduler's
    :meth:`serve.sched.TenantScheduler.snapshot`: per-tenant queue depth,
    shed/expiry counts and slots held, plus per-priority-class depth and
    queue-wait p95 — the gauges the Grafana tenant panel and a
    replica-routing front end read. Same zero-push discipline as
    :func:`serving_collector`: nothing happens on the pop path."""
    t_depth = registry.gauge(
        "sched_queue_depth", "queued requests per tenant",
        labelnames=("tenant",))
    t_shed = registry.gauge(
        "sched_shed_total",
        "submits rejected by per-tenant back-pressure", labelnames=("tenant",))
    t_expired = registry.gauge(
        "sched_expired_total",
        "requests swept from the queue past their deadline",
        labelnames=("tenant",))
    t_slots = registry.gauge(
        "sched_slots_in_use", "decode/prefill slots held per tenant",
        labelnames=("tenant",))
    t_wait = registry.gauge(
        "sched_queue_wait_p95_ms",
        "queue wait p95 per tenant (sliding window)", labelnames=("tenant",))
    c_depth = registry.gauge(
        "sched_class_queue_depth", "queued requests per priority class",
        labelnames=("priority",))
    c_wait = registry.gauge(
        "sched_class_queue_wait_p95_ms",
        "queue wait p95 per priority class (sliding window)",
        labelnames=("priority",))

    def collect() -> None:
        snap = sched.snapshot()
        for tid, t in snap["tenants"].items():
            t_depth.labels(tenant=tid).set(t["queue_depth"])
            t_shed.labels(tenant=tid).set(t["shed_total"])
            t_expired.labels(tenant=tid).set(t["expired_total"])
            t_slots.labels(tenant=tid).set(t["in_flight"])
            if t["queue_wait_p95_ms"] is not None:
                t_wait.labels(tenant=tid).set(t["queue_wait_p95_ms"])
        for cls, c in snap["classes"].items():
            c_depth.labels(priority=cls).set(c["queue_depth"])
            if c["queue_wait_p95_ms"] is not None:
                c_wait.labels(priority=cls).set(c["queue_wait_p95_ms"])

    registry.register_collector(collect)


def gateway_collector(registry: MetricsRegistry, gateway) -> None:
    """Register a pull-time collector over the failover gateway's
    :meth:`serve.gateway.ServeGateway.snapshot`: per-replica breaker
    state (0 closed / 1 half-open / 2 open), health score, load and
    drain progress. The aggregate gateway counters ride
    :func:`serving_collector` (the stats object is shared), so this adds
    only the per-replica dimension."""
    state_code = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
    r_state = registry.gauge(
        "serve_gateway_breaker_state",
        "replica breaker state: 0=closed, 1=half_open, 2=open",
        labelnames=("replica",))
    r_health = registry.gauge(
        "serve_gateway_replica_health",
        "gateway-side composite health score per replica (0..1)",
        labelnames=("replica",))
    r_load = registry.gauge(
        "serve_gateway_replica_load",
        "queued + mid-prefill + decoding requests per replica",
        labelnames=("replica",))
    r_draining = registry.gauge(
        "serve_gateway_replica_draining",
        "1 while a replica is draining (0 otherwise); drops back to the "
        "routing set never happen — drain is terminal",
        labelnames=("replica",))
    live = registry.gauge(
        "serve_gateway_live_requests",
        "client requests the gateway currently owns")

    def collect() -> None:
        snap = gateway.snapshot()
        for rid, r in snap["replicas"].items():
            r_state.labels(replica=rid).set(state_code.get(r["state"], 2.0))
            r_health.labels(replica=rid).set(r["health"])
            r_load.labels(replica=rid).set(r["load"])
            r_draining.labels(replica=rid).set(1.0 if r["draining"] else 0.0)
        live.set(snap["live_requests"])

    registry.register_collector(collect)


def autoscale_collector(registry: MetricsRegistry, controller) -> None:
    """Register a pull-time collector over the fleet controller's
    :meth:`serve.autoscale.FleetController.snapshot`: desired vs actual
    replica counts, brownout ladder level, the last decision (coded as
    in ``serve.autoscale.DECISION_CODES``), and the per-decision
    counters — the Grafana elastic-autoscaler panel's source."""
    desired = registry.gauge(
        "serve_autoscale_desired_replicas",
        "replica count the fleet controller is driving toward")
    actual = registry.gauge(
        "serve_autoscale_actual_replicas",
        "non-draining replicas currently in the gateway routing set")
    level = registry.gauge(
        "serve_autoscale_brownout_level",
        "brownout ladder position: 0=normal, 1=shed_batch, "
        "2=+no_hedge, 3=+tight_admission")
    last = registry.gauge(
        "serve_autoscale_last_decision",
        "last control-round decision: 0=hold, 1=up, 2=down, 3=replace, "
        "4=brownout, 5=restore")
    decisions = registry.gauge(
        "serve_autoscale_decisions_total",
        "control-round decisions by kind", labelnames=("decision",))
    failures = registry.gauge(
        "serve_autoscale_actuation_failures_total",
        "backend start/stop actuations that failed (retried on later "
        "rounds)")
    pending = registry.gauge(
        "serve_autoscale_pending_removals",
        "victims drained out but not yet retired/stopped")

    def collect() -> None:
        snap = controller.snapshot()
        desired.set(snap["desired_replicas"])
        actual.set(snap["actual_replicas"])
        level.set(snap["brownout_level"])
        last.set(snap["last_decision_code"])
        for kind, count in snap["decisions"].items():
            decisions.labels(decision=kind).set(float(count))
        failures.set(snap["actuation_failures"])
        pending.set(snap["pending_removals"])

    registry.register_collector(collect)


def heartbeat_collector(registry: MetricsRegistry, directory: str) -> None:
    """Expose heartbeat ages as ``tpujob_heartbeat_age_seconds{rank=...}``
    — the Grafana stall panel's instant vector (run it wherever the
    exporter runs with the heartbeat volume mounted, e.g. the watcher)."""
    import time

    from k8s_distributed_deeplearning_torch.telemetry import heartbeat as hb
    age = registry.gauge("tpujob_heartbeat_age_seconds",
                         "seconds since each rank's last heartbeat",
                         labelnames=("rank",))
    step = registry.gauge("tpujob_heartbeat_step",
                          "last step each rank reported",
                          labelnames=("rank",))

    def collect() -> None:
        now = time.time()
        for rec in hb.read_heartbeats(directory):
            r = str(rec["rank"])
            age.labels(rank=r).set(now - float(rec["ts"]))
            step.labels(rank=r).set(int(rec.get("step", -1)))

    registry.register_collector(collect)
