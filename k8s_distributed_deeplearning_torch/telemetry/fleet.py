"""Fleet observability: scrape N replicas, federate, score health.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
fleet.py``: the parser, the scraper, the aggregator and the SLO feed give
the JAX module's results on the same exposition texts, and the in-process
gateway (``serve/gateway.py``) routes by the same :class:`HealthPolicy`
weights. Stdlib-only like the rest of the telemetry plane:

- :func:`parse_exposition` — a real parser for the Prometheus text
  format 0.0.4 :meth:`telemetry.registry.MetricsRegistry.render` emits
  (HELP/TYPE lines, escaped label values, ``NaN``/``+Inf``/``-Inf``),
  because the scraper must not choke on anything the exporter can say;
- :class:`FleetScraper` — polls a static endpoint list (or one
  discovered from heartbeat files carrying a ``metrics_addr`` field) with
  a per-endpoint timeout and the shared :func:`utils.retry.retry_transient`
  bounded-exponential-backoff policy, marking replicas stale instead of
  dying when one stops answering;
- :class:`FleetAggregator` — merges families across replicas (every
  sample re-labeled with ``replica=``), computes sum/min/max aggregates,
  and scores each replica's health from the gauges the serving plane
  already exports: queue depth, slot occupancy, KV-pool pressure,
  heartbeat age, and scrape staleness. The score is the router's input:
  one float in [0, 1], 0 = unreachable.

Health score formula (:class:`HealthPolicy`): a weighted penalty sum
clamped to [0, 1]::

    score = 1 - (w_queue    * min(1, queue_depth / queue_full_depth)
               + w_occupancy * slot_occupancy
               + w_kv       * kv_pages_used / kv_pages_total
               + w_heartbeat * min(1, heartbeat_age / heartbeat_stale_s)
               + w_scrape   * min(1, scrape_age / scrape_stale_s))

A replica whose scrape is older than ``stale_after_s`` (or that never
answered) scores 0.0 outright — an unreachable replica must never look
healthier than a busy one. Missing families contribute no penalty: a
replica that doesn't run the scheduler isn't punished for having no
queue gauge. In-process, the gateway reads the same signals off its
engines (``serve/gateway.py`` ``_health_score``) and leaves liveness to
its breakers.
"""
from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Callable

from k8s_distributed_deeplearning_torch.telemetry import heartbeat as hb
from k8s_distributed_deeplearning_torch.utils.retry import retry_transient

__all__ = ["Sample", "Family", "parse_exposition", "discover_endpoints",
           "ReplicaState", "FleetScraper", "HealthPolicy", "HealthReport",
           "FleetAggregator", "feed_slo"]

# ------------------------------------------------------------------ parser

_ESCAPES = {"\\": "\\", "n": "\n", '"': '"'}


@dataclasses.dataclass
class Sample:
    """One exposition line: ``name{labels} value``."""
    name: str
    labels: dict[str, str]
    value: float


@dataclasses.dataclass
class Family:
    """One metric family: HELP/TYPE plus every sample under its name
    (histogram ``_bucket``/``_sum``/``_count`` rows stay attached to the
    declared family)."""
    name: str
    kind: str = "untyped"
    help: str = ""
    samples: list[Sample] = dataclasses.field(default_factory=list)


def _parse_labels(text: str) -> tuple[dict[str, str], int]:
    """Parse ``k="v",...}`` starting after the ``{``; returns (labels,
    index past the closing brace). Handles ``\\\\``, ``\\n``, ``\\"``
    escapes — the inverse of registry._escape_label."""
    labels: dict[str, str] = {}
    i = 0
    while i < len(text):
        if text[i] == "}":
            return labels, i + 1
        if text[i] == ",":
            i += 1
            continue
        eq = text.index("=", i)
        key = text[i:eq].strip()
        if text[eq + 1] != '"':
            raise ValueError(f"label value for {key!r} is not quoted")
        i = eq + 2
        out: list[str] = []
        while True:
            c = text[i]
            if c == "\\":
                out.append(_ESCAPES.get(text[i + 1], text[i + 1]))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                out.append(c)
                i += 1
        labels[key] = "".join(out)
    raise ValueError("unterminated label set (no closing '}')")


def _parse_value(text: str) -> float:
    t = text.strip()
    if t in ("+Inf", "Inf"):
        return float("inf")
    if t == "-Inf":
        return float("-inf")
    if t == "NaN":
        return float("nan")
    return float(t)


def parse_exposition(text: str) -> dict[str, Family]:
    """Parse Prometheus text-format 0.0.4 into families by name.

    Raises ValueError on a malformed line — the caller (the scraper)
    treats that as a failed scrape, exactly like a refused connection;
    a replica emitting garbage must be visible, not half-ingested."""
    families: dict[str, Family] = {}
    declared: list[str] = []    # names with a HELP/TYPE, longest first

    def family_for(sample_name: str) -> Family:
        # _bucket/_sum/_count rows belong to the declared histogram.
        for decl in declared:
            if sample_name == decl or (
                    sample_name.startswith(decl + "_")
                    and sample_name[len(decl):] in ("_bucket", "_sum",
                                                    "_count")):
                return families[decl]
        return families.setdefault(sample_name, Family(sample_name))

    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                kind_line = line.startswith("# TYPE ")
                _, _, rest = line.partition(
                    "# TYPE " if kind_line else "# HELP ")
                name, _, payload = rest.partition(" ")
                fam = families.setdefault(name, Family(name))
                if name not in declared:
                    declared.append(name)
                    declared.sort(key=len, reverse=True)
                if kind_line:
                    fam.kind = payload.strip()
                else:
                    fam.help = payload
                continue
            if line.startswith("#"):
                continue
            brace = line.find("{")
            if brace >= 0:
                name = line[:brace]
                labels, consumed = _parse_labels(line[brace + 1:])
                value = _parse_value(line[brace + 1 + consumed:])
            else:
                name, _, rest = line.partition(" ")
                labels = {}
                # A trailing timestamp (ms) is legal exposition; our own
                # exporter never writes one but the parser tolerates it.
                value = _parse_value(rest.split()[0])
            sample = Sample(name, labels, value)
            family_for(name).samples.append(sample)
        except (ValueError, IndexError) as e:
            raise ValueError(f"exposition line {lineno}: {e} "
                             f"(line: {line[:120]!r})") from e
    return families


# ----------------------------------------------------------------- scraper

def discover_endpoints(heartbeat_dir: str, *,
                       stale_after_s: float | None = None,
                       now: float | None = None,
                       role: str | None = None) -> list[str]:
    """Endpoints advertised by heartbeat records: any rank whose writer
    passed ``metrics_addr="host:port"`` as a beat extra (the discovery
    path for replicas behind no static config).

    *stale_after_s* (same age logic as :func:`heartbeat.detect_stalls`)
    drops beacons older than that many seconds — a replica that died
    without removing its file is never handed back as a live endpoint.
    None keeps the historical behaviour (every beacon counts).

    *role* filters on the beacon's ``role`` extra (disaggregated
    serving advertises "decode" or "prefill"); a beacon WITHOUT a role
    extra counts as "decode" — every server predating role beacons was
    a decode replica, so old beacons keep discovering under the new
    filter. None (default) returns every role."""
    if now is None:
        now = time.time()
    addrs = set()
    for rec in hb.read_heartbeats(heartbeat_dir):
        if not rec.get("metrics_addr"):
            continue
        if (stale_after_s is not None
                and now - float(rec["ts"]) > stale_after_s):
            continue
        if (role is not None
                and str(rec.get("role") or "decode") != role):
            continue
        addrs.add(str(rec["metrics_addr"]))
    return sorted(addrs)


def _normalize_url(endpoint: str) -> str:
    url = endpoint if "://" in endpoint else f"http://{endpoint}"
    scheme, _, rest = url.partition("://")
    if "/" not in rest:
        url += "/metrics"
    return url


@dataclasses.dataclass
class ReplicaState:
    """Everything the fleet knows about one replica's scrape target."""
    replica: str                    # label value ("host:port")
    url: str
    families: dict[str, Family] = dataclasses.field(default_factory=dict)
    last_success: float | None = None
    last_attempt: float | None = None
    consecutive_failures: int = 0
    last_error: str | None = None

    def scrape_age(self, now: float) -> float | None:
        return None if self.last_success is None else now - self.last_success


class _NullLogger:
    def emit(self, event: str, **fields) -> None:
        pass


class FleetScraper:
    """Poll every replica's ``/metrics`` and keep the latest parse.

    *endpoints* is a list of ``host:port`` / URLs (the replica label is
    the host:port part). *fetch* is injectable — ``fetch(url,
    timeout_s) -> str`` — so tests script replicas without sockets; the
    default uses urllib with the per-endpoint *timeout_s*.

    Each :meth:`poll` scrapes all endpoints; a failing endpoint is
    retried *retries* times with full-jitter exponential backoff under
    the *backoff_s* ceiling (the shared ``utils.retry`` policy; *sleep*
    and the jitter *rng* are injectable),
    then marked failed for this round — its last good families stick
    around, aging toward staleness, and one ``fleet_scrape_failed``
    event is emitted per failure episode (not per poll) through
    *logger*."""

    def __init__(self, endpoints: list[str], *, timeout_s: float = 2.0,
                 retries: int = 1, backoff_s: float = 0.2,
                 stale_after_s: float = 10.0,
                 fetch: Callable[[str, float], str] | None = None,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] | None = None,
                 logger=None):
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.stale_after_s = stale_after_s
        self.clock = clock
        self._sleep = sleep
        self._rng = rng
        self._fetch = fetch or self._urllib_fetch
        self.logger = logger if logger is not None else _NullLogger()
        self.replicas: dict[str, ReplicaState] = {}
        for ep in endpoints:
            self.add_endpoint(ep)

    @staticmethod
    def _urllib_fetch(url: str, timeout_s: float) -> str:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read().decode("utf-8", errors="replace")

    def add_endpoint(self, endpoint: str) -> None:
        url = _normalize_url(endpoint)
        replica = url.partition("://")[2].partition("/")[0]
        if replica not in self.replicas:
            self.replicas[replica] = ReplicaState(replica=replica, url=url)

    def poll(self) -> dict[str, ReplicaState]:
        """Scrape every endpoint once (with bounded retry); returns the
        replica map. Never raises on a dead replica — failure is state,
        not control flow."""
        for state in self.replicas.values():
            now = self.clock()
            state.last_attempt = now
            try:
                # Full-jitter backoff: N pollers retrying a shared dead
                # replica must not re-converge in lockstep.
                text = retry_transient(
                    lambda: self._fetch(state.url, self.timeout_s),
                    retries=self.retries, backoff_s=self.backoff_s,
                    sleep=self._sleep, jitter=True, rng=self._rng,
                    is_transient=lambda e: isinstance(
                        e, (OSError, TimeoutError)))
                state.families = parse_exposition(text)
            except Exception as e:   # noqa: BLE001 — a dead replica must
                # not kill the fleet loop; staleness marking owns it.
                state.consecutive_failures += 1
                state.last_error = repr(e)
                if state.consecutive_failures == 1:
                    self.logger.emit("fleet_scrape_failed",
                                     replica=state.replica, url=state.url,
                                     error=repr(e))
                continue
            state.last_success = self.clock()
            state.consecutive_failures = 0
            state.last_error = None
        return self.replicas

    def is_stale(self, state: ReplicaState, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        age = state.scrape_age(now)
        return age is None or age > self.stale_after_s


# -------------------------------------------------------------- aggregator

@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Knobs of the composite health score (module docstring formula).
    Defaults suit a serving replica scraped every few seconds; the chaos
    test tightens the staleness horizons to sub-second scale."""

    queue_full_depth: float = 64.0      # queue depth scoring as "full"
    heartbeat_stale_s: float = 60.0     # hb age scoring as "wedged"
    scrape_stale_s: float = 10.0        # scrape age scoring as "gone"
    unhealthy_below: float = 0.5        # router/watch alarm threshold
    w_queue: float = 0.25
    w_occupancy: float = 0.15
    w_kv: float = 0.20
    w_heartbeat: float = 0.25
    w_scrape: float = 0.15


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One replica's score with the per-component penalties behind it."""
    replica: str
    score: float
    healthy: bool
    components: dict[str, float]    # penalty per component, 0..1 each


def _scalar(families: dict[str, Family], name: str) -> float | None:
    fam = families.get(name)
    if fam is None or not fam.samples:
        return None
    return fam.samples[0].value


def _sample_sum(families: dict[str, Family], name: str) -> float | None:
    fam = families.get(name)
    if fam is None or not fam.samples:
        return None
    return sum(s.value for s in fam.samples)


def _sample_max(families: dict[str, Family], name: str) -> float | None:
    fam = families.get(name)
    if fam is None or not fam.samples:
        return None
    return max(s.value for s in fam.samples)


class FleetAggregator:
    """Merge one :class:`FleetScraper`'s view into router/human food:
    the federated exposition (:meth:`render`), sum/min/max aggregates
    and health scores (:meth:`snapshot`), and the per-tenant counters
    the :class:`telemetry.slo.SLOEngine` consumes."""

    def __init__(self, scraper: FleetScraper, *,
                 policy: HealthPolicy | None = None):
        self.scraper = scraper
        self.policy = policy or HealthPolicy()

    # ---------------------------------------------------------- health
    def health(self, state: ReplicaState,
               now: float | None = None) -> HealthReport:
        now = self.scraper.clock() if now is None else now
        p = self.policy
        if self.scraper.is_stale(state, now):
            age = state.scrape_age(now)
            return HealthReport(
                state.replica, 0.0, False,
                {"scrape": 1.0,
                 "scrape_age_s": round(age, 3) if age is not None else -1.0})
        fams = state.families
        components: dict[str, float] = {}
        queue = _sample_sum(fams, "sched_queue_depth")
        if queue is not None:
            components["queue"] = min(1.0, max(0.0, queue)
                                      / p.queue_full_depth)
        occ = _scalar(fams, "serve_mean_slot_occupancy")
        if occ is not None:
            components["occupancy"] = min(1.0, max(0.0, occ))
        used = _scalar(fams, "serve_kv_pages_used")
        total = _scalar(fams, "serve_kv_pages_total")
        if used is not None and total is not None and total > 0:
            components["kv"] = min(1.0, max(0.0, used / total))
        hb_age = _sample_max(fams, "tpujob_heartbeat_age_seconds")
        if hb_age is not None:
            components["heartbeat"] = min(1.0, max(0.0, hb_age)
                                          / p.heartbeat_stale_s)
        age = state.scrape_age(now)
        components["scrape"] = min(1.0, (age or 0.0) / p.scrape_stale_s)
        weights = {"queue": p.w_queue, "occupancy": p.w_occupancy,
                   "kv": p.w_kv, "heartbeat": p.w_heartbeat,
                   "scrape": p.w_scrape}
        score = 1.0 - sum(weights[k] * v for k, v in components.items())
        score = min(1.0, max(0.0, score))
        return HealthReport(state.replica, round(score, 4),
                            score >= p.unhealthy_below,
                            {k: round(v, 4) for k, v in components.items()})

    def health_reports(self, now: float | None = None
                       ) -> dict[str, HealthReport]:
        now = self.scraper.clock() if now is None else now
        return {r: self.health(s, now)
                for r, s in sorted(self.scraper.replicas.items())}

    # ------------------------------------------------------- federation
    def merged_families(self) -> dict[str, Family]:
        """Every replica's families under one roof, each sample
        re-labeled with ``replica=`` (first label, the federation key)."""
        merged: dict[str, Family] = {}
        for replica, state in sorted(self.scraper.replicas.items()):
            for name, fam in sorted(state.families.items()):
                out = merged.setdefault(
                    name, Family(name, fam.kind, fam.help))
                for s in fam.samples:
                    out.samples.append(Sample(
                        s.name, {"replica": replica, **s.labels}, s.value))
        return merged

    def aggregates(self) -> dict[str, dict]:
        """Cross-replica rollups for unlabeled scalar families: counters
        sum (fleet totals), gauges carry min/max (the spread a router
        cares about). Labeled families stay per-replica in the merged
        exposition — summing across label sets would invent series."""
        out: dict[str, dict] = {}
        per_name: dict[str, list[tuple[str, Family, Sample]]] = {}
        for replica, state in sorted(self.scraper.replicas.items()):
            for name, fam in state.families.items():
                for s in fam.samples:
                    if not s.labels and s.name == name:
                        per_name.setdefault(name, []).append(
                            (replica, fam, s))
        for name, rows in sorted(per_name.items()):
            kind = rows[0][1].kind
            values = [s.value for _, _, s in rows]
            agg = {"kind": kind, "replicas": len(rows)}
            if kind == "counter":
                agg["sum"] = sum(values)
            else:
                agg["sum"] = sum(values)
                agg["min"] = min(values)
                agg["max"] = max(values)
            out[name] = agg
        return out

    def render(self, now: float | None = None) -> str:
        """Federated Prometheus exposition: every replica series with its
        ``replica=`` label plus the fleet-native gauges
        (``fleet_replica_up`` / ``fleet_replica_health`` /
        ``fleet_replica_scrape_age_seconds``)."""
        from k8s_distributed_deeplearning_torch.telemetry.registry import (
            _escape_label, _fmt_value)
        now = self.scraper.clock() if now is None else now
        out: list[str] = []
        for name, fam in sorted(self.merged_families().items()):
            out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.kind}")
            for s in fam.samples:
                pairs = ",".join(f'{k}="{_escape_label(v)}"'
                                 for k, v in s.labels.items())
                out.append(f"{s.name}{{{pairs}}} {_fmt_value(s.value)}")
        fleet_rows = [
            ("fleet_replica_up",
             "1 if the replica answered its last scrape within "
             "stale_after_s", "gauge",
             lambda st, rep: 0.0 if self.scraper.is_stale(st, now) else 1.0),
            ("fleet_replica_health",
             "composite replica health score (0 unreachable .. 1 idle)",
             "gauge", lambda st, rep: rep.score),
            ("fleet_replica_scrape_age_seconds",
             "seconds since the replica's last successful scrape (-1 = "
             "never)", "gauge",
             lambda st, rep: (st.scrape_age(now)
                              if st.scrape_age(now) is not None else -1.0)),
        ]
        reports = self.health_reports(now)
        for name, help_, kind, value_of in fleet_rows:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            for replica, state in sorted(self.scraper.replicas.items()):
                v = value_of(state, reports[replica])
                out.append(f'{name}{{replica="{_escape_label(replica)}"}} '
                           f"{_fmt_value(v)}")
        return "\n".join(out) + "\n"

    # ------------------------------------------------------------ SLO feed
    def finished_totals(self) -> dict[str, float]:
        """Cumulative finished-request counts by reason, summed across
        replicas (``serve_finished_total{reason=}``)."""
        totals: dict[str, float] = {}
        for state in self.scraper.replicas.values():
            fam = state.families.get("serve_finished_total")
            if fam is None:
                continue
            for s in fam.samples:
                reason = s.labels.get("reason", "unknown")
                totals[reason] = totals.get(reason, 0.0) + s.value
        return totals

    def queue_wait_p95_by_tenant(self) -> dict[str, float]:
        """Worst (max) per-tenant queue-wait p95 across replicas — the
        latency SLI must see the slowest replica, not the average."""
        out: dict[str, float] = {}
        for state in self.scraper.replicas.values():
            fam = state.families.get("sched_queue_wait_p95_ms")
            if fam is None:
                continue
            for s in fam.samples:
                tenant = s.labels.get("tenant", "default")
                out[tenant] = max(out.get(tenant, 0.0), s.value)
        return out

    # ------------------------------------------------------------ snapshot
    def snapshot(self, now: float | None = None,
                 slo_engine=None) -> dict:
        """JSON document for the ``/fleet`` endpoint and ``graftscope
        fleet --json``: per-replica health + scrape state, cross-replica
        aggregates, and (when an engine is wired) the SLO snapshot."""
        now = self.scraper.clock() if now is None else now
        reports = self.health_reports(now)
        replicas = {}
        for replica, state in sorted(self.scraper.replicas.items()):
            rep = reports[replica]
            age = state.scrape_age(now)
            replicas[replica] = {
                "url": state.url,
                "up": not self.scraper.is_stale(state, now),
                "health": rep.score,
                "healthy": rep.healthy,
                "components": rep.components,
                "scrape_age_s": round(age, 3) if age is not None else None,
                "consecutive_failures": state.consecutive_failures,
                "last_error": state.last_error,
            }
        doc = {"replicas": replicas,
               "aggregates": self.aggregates(),
               "unhealthy_below": self.policy.unhealthy_below}
        if slo_engine is not None:
            doc["slo"] = slo_engine.snapshot(now)
        return doc

    def to_json(self, now: float | None = None, slo_engine=None) -> str:
        return json.dumps(self.snapshot(now, slo_engine), indent=2,
                          sort_keys=True)


def feed_slo(engine, aggregator: FleetAggregator) -> None:
    """One scrape's worth of SLI input for an
    :class:`telemetry.slo.SLOEngine`: fleet-summed finish-reason counters
    (engine-global until per-tenant finish counters exist — every tenant
    with an availability objective sees the same stream, documented in
    the SLO schema) and the per-tenant worst-replica queue-wait p95."""
    totals = aggregator.finished_totals()
    engine.observe(
        finished={t: dict(totals) for t in engine.objectives},
        queue_wait_p95_ms=aggregator.queue_wait_p95_by_tenant())
