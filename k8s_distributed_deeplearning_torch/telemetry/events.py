"""Golden registry of JSONL event names — the Loki schema contract.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
events.py``: the same names, so one dashboard and one Loki query read
either package's stream. Every event the port emits is listed here
(``tests/test_torch_wire_telemetry.py`` scans the port's emit sites).

Every ``MetricsLogger.emit(event, ...)`` call in train/, serve/, examples/
and telemetry/ must use a name listed here. Loki queries and the shipped
Grafana dashboard select on ``event="..."`` literals; a renamed or ad-hoc
event silently breaks those panels, so the tier-1 golden-schema test
(``tests/test_events_schema.py``) scans the source tree for emit sites and
fails on any name that is not snake_case or not registered below.

Adding an event = adding it here (with a one-line meaning) in the same PR
as the emit site — the dashboard/query update then has a diff to anchor on.
"""
from __future__ import annotations

import re

# name -> one-line meaning (the HELP string of the log plane).
EVENTS: dict[str, str] = {
    "start": "run began: world size, step budget, hyperparameters",
    "restore": "checkpoint restore-on-start; step it resumed from",
    "train_step": "periodic training step record: loss, step time, "
                  "throughput, MFU",
    "eval": "mid-training or final evaluation metrics",
    # graftlint: disable=event-registry — emitted by examples/train_llama.py,
    # outside the package tree the lint scans.
    "eval_skipped": "an eval cadence point was skipped (and why)",
    "checkpoint": "a checkpoint write completed",
    "preempted": "SIGTERM consensus reached; checkpointed and exiting",
    "serve_request": "one serving request completed: tokens, TTFT, latency",
    "serve_summary": "end-of-run serving aggregate: tokens/sec, percentiles",
    "span": "a traced span closed: name, dur_ms, depth, parent, rank, "
            "thread",
    "request_trace": "sampled end-to-end request lifecycle: queue wait, "
                     "prefill chunks, TTFT, decode steps, tokens/s, "
                     "finish reason (graftscope requests)",
    # graftlint: disable=event-registry — heartbeat/stall are written by
    # the heartbeat file plane and `launch watch`, not via .emit().
    "heartbeat": "per-rank liveness record (also written as heartbeat files)",
    # graftlint: disable=event-registry — see above
    "stall": "watch flagged a rank with a stale heartbeat",
    "sched_shed": "a tenant's bounded admission queue rejected a submit "
                  "(per-tenant back-pressure; tenant attached)",
    "sched_tenant_summary": "end-of-run per-tenant scheduler aggregate: "
                            "queue waits, sheds, expiries, slots held",
    "ckpt_quarantined": "restore found a corrupt/torn checkpoint step and "
                        "moved it aside; falling back to an older step",
    "crash_loop": "consecutive restarts died without checkpoint progress; "
                  "the reconcile loop stopped early (exit codes attached)",
    "slo_alert": "a tenant's SLO burn rate crossed its fast/slow window "
                 "threshold (tenant, sli, window, burn_rate attached)",
    "slo_recovered": "a previously alerting (tenant, sli, window) burn "
                     "rate dropped back under threshold",
    "fleet_scrape_failed": "a fleet replica stopped answering /metrics "
                           "(one event per failure episode, not per poll)",
    "gateway_migrated": "the serving gateway moved one in-flight request "
                        "off a tripped/draining replica (from/to replica "
                        "and the emitted-token cursor attached)",
    "gateway_breaker_open": "a replica's circuit breaker tripped: its "
                            "requests are being migrated and dispatch "
                            "stops until the half-open probe",
    "gateway_breaker_closed": "a half-open probe succeeded: the replica "
                              "is back in the routing set",
    "gateway_poisoned": "a request exhausted the gateway's max_migrations "
                        "budget (its replicas keep dying under it) and "
                        "was quarantined with terminal reason 'poisoned'",
    "replica_drained": "a draining replica finished or migrated all of "
                       "its work (safe to terminate)",
    "spec_summary": "end-of-run speculative-decoding aggregate: draft "
                    "tokens proposed/accepted, acceptance rate, "
                    "accepted-per-step histogram",
    "quant_summary": "end-of-run graftquant aggregate: active kv/weight "
                     "quant modes and the HBM bytes each saved vs fp",
    "quant_calib": "the training loop wrote a graftquant calibration "
                   "dump (per-channel weight absmax stats; path and "
                   "entry count attached)",
    "flight_dump": "the flight recorder wrote (or was asked for) a ring "
                   "dump: reason (breaker_trip/drain/sigterm/fault/"
                   "on_demand), record count, dump path",
    "kv_page_leak": "drain/shutdown leak guard: non-scratch KV pages "
                    "still held after the engine released everything "
                    "(count and by-owner attribution attached)",
    "transport_retry": "a remote-replica transport call failed "
                       "transiently and is being retried with jittered "
                       "backoff (replica, call, attempt, delay attached)",
    "transport_submit_deduped": "a retried submit after an ambiguous "
                                "failure (request landed, response lost) "
                                "was deduplicated by the replica server — "
                                "idempotency by request_id held",
    "transport_reconnect": "a replica's token stream resumed from its "
                           "emitted-token cursor after one or more failed "
                           "polls (replica and cursor positions attached)",
    "gateway_replica_added": "dynamic membership: a replica joined the "
                             "running gateway (breaker state created; "
                             "next submit can route to it)",
    "gateway_replica_removed": "dynamic membership: a drained replica was "
                               "retired from the gateway (breaker state "
                               "dropped with it)",
    "autoscale_up": "the fleet controller added a replica: sustained "
                    "fast-window SLO burn or queue pressure (burn rate, "
                    "load per slot, desired/actual attached)",
    "autoscale_down": "the fleet controller drained an idle replica out "
                      "(migration-backed, zero lost requests; victim and "
                      "desired/actual attached)",
    "autoscale_replace": "the fleet controller is replacing a replica "
                         "whose composite health stayed under the floor "
                         "(or breaker stayed open) — drain out, fresh "
                         "replica in",
    "autoscale_brownout": "at max_replicas with burn still rising the "
                          "controller escalated the reversible "
                          "degradation ladder (level and stage attached)",
    "autoscale_restored": "the brownout ladder fully unwound — burn "
                          "cleared and every degradation lever is back "
                          "to normal",
    "autoscale_summary": "end-of-run fleet controller snapshot (rounds, "
                         "decision counts, actuation failures, final "
                         "desired/actual replicas)",
    "disagg_shipped": "a prefill worker's finished KV pages were adopted "
                      "by a decode worker (request, pages, bytes, "
                      "kv cursor attached)",
    "disagg_fallback": "the disagg coordinator routed a request through "
                       "the unified decode-local prefill path (no healthy "
                       "prefill worker / no adopter; reason and emitted "
                       "cursor attached)",
    "disagg_prefill_down": "a prefill worker died or stopped answering; "
                           "its in-flight requests are being re-routed "
                           "through normal decode-side admission",
    "storm_invariant_violation": "the chaos-soak monitor caught a "
                                 "system-wide invariant break (lost/"
                                 "duplicated request, leaked KV page, "
                                 "parity or counter divergence) — kind, "
                                 "detail and the seed repro line attached",
    "storm_summary": "end-of-soak graftstorm aggregate: requests "
                     "submitted/finished by reason, fault firings by "
                     "site, peak fleet load, violation count, repro line",
}

_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")


def is_snake_case(name: str) -> bool:
    return bool(_SNAKE.match(name))


def known_events() -> frozenset[str]:
    return frozenset(EVENTS)
