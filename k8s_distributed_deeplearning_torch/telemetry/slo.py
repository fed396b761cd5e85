"""Per-tenant SLO objectives and multi-window burn-rate alerting.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
slo.py``: :class:`SLOTarget` (the promise block a tenant config carries,
``TenantConfig.slo``), :class:`SLOEngine` and :func:`objectives_from_
tenants`, with the JAX package's burn-rate arithmetic and alert events.

- The **error budget** is ``1 - availability``; the **burn rate** over a
  window is the share of bad events in it over the budget (burn 1.0
  spends the budget exactly at the window's end).
- Two windows run a SLI: a **fast** one (``window_s / 12``) with a high
  threshold catches outages in minutes, a **slow** one (the whole
  ``window_s``) with a low threshold catches sustained slow burns.
- Two SLIs: ``availability`` (finished requests by reason; reasons in
  :data:`BAD_REASONS` burn budget) and ``latency`` (the share of
  observation time the tenant's queue-wait p95 sat above
  ``latency_p95_ms``).

Alert transitions are ``slo_alert`` / ``slo_recovered`` events through any
``MetricsLogger``-shaped ``emit``, one alert an episode. stdlib only, and
the clock is injectable. The scheduler does not read the targets; the
serve CLI's ``--autoscale`` feeds the engine finish counts and the fleet
controller (``serve/autoscale.py``) reads its fast-window alerts.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

#: Finish reasons that burn availability budget. Everything else
#: ("eos", "length", "stop", ...) counts as a served-fine request.
BAD_REASONS = frozenset({"timeout", "abort", "error", "shed", "expired"})

#: Default burn-rate thresholds per window, Google SRE workbook shape:
#: the fast window pages only on budget-torching burns, the slow window
#: on sustained overspend.
FAST_BURN_THRESHOLD = 14.4
SLOW_BURN_THRESHOLD = 6.0

#: fast window = objective window / 12 (1h objective -> 5m fast window).
FAST_WINDOW_DIVISOR = 12


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One tenant's promise: what fraction of requests succeed
    (``availability``), how fast the queue must move (``latency_p95_ms``,
    optional), judged over ``window_s`` seconds."""

    availability: float = 0.99
    latency_p95_ms: float | None = None
    window_s: float = 3600.0

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(f"slo availability must be in (0, 1) "
                             f"exclusive, got {self.availability}")
        if self.latency_p95_ms is not None and not self.latency_p95_ms > 0:
            raise ValueError(f"slo latency_p95_ms must be > 0, got "
                             f"{self.latency_p95_ms}")
        if not self.window_s > 0:
            raise ValueError(f"slo window_s must be > 0, got "
                             f"{self.window_s}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    @property
    def fast_window_s(self) -> float:
        return self.window_s / FAST_WINDOW_DIVISOR

    def window_seconds(self, window: str) -> float:
        return self.fast_window_s if window == "fast" else self.window_s

    @classmethod
    def from_dict(cls, doc: dict) -> "SLOTarget":
        if not isinstance(doc, dict):
            raise ValueError(f'slo must be an object like {{"availability": '
                             f"0.99}}, got {type(doc).__name__}")
        known = {"availability", "latency_p95_ms", "window_s"}
        unknown = set(doc) - known
        if unknown:
            raise ValueError(f"slo has unknown fields {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**doc)

    def to_dict(self) -> dict:
        d = {"availability": self.availability, "window_s": self.window_s}
        if self.latency_p95_ms is not None:
            d["latency_p95_ms"] = self.latency_p95_ms
        return d


class _NullLogger:
    def emit(self, event: str, **fields) -> None:
        pass


class _EmitAdapter:
    """Wrap a bare ``emit``-shaped callable as a ``.emit`` object (a
    :class:`utils.metrics.MetricsLogger` passed as ``emit=logger.emit``
    round-trips through this unchanged in behavior)."""

    def __init__(self, fn: Callable[..., None]):
        self._fn = fn

    def emit(self, event: str, **fields) -> None:
        self._fn(event, **fields)


@dataclasses.dataclass(frozen=True)
class BurnAlert:
    """One active breach: (tenant, sli, window) plus the burn that fired."""
    tenant: str
    sli: str                 # "availability" | "latency"
    window: str              # "fast" | "slow"
    burn_rate: float
    threshold: float


class SLOEngine:
    """Evaluate per-tenant burn rates from scraped serving counters.

    *objectives* maps tenant id -> :class:`SLOTarget`. *emit* is a
    ``MetricsLogger.emit``-shaped callable for the alert events (None =
    evaluate silently; :meth:`active_alerts` still reflects state).
    *clock* is wall time, injectable for deterministic window tests.

    Feed it with :meth:`observe` at any cadence (the fleet scraper's poll
    loop is the natural caller): cumulative finished-request counts per
    reason per tenant — deltas are taken internally, and a shrinking
    cumulative count is treated as a counter reset (replica restart) —
    plus the current queue-wait p95 per tenant. Then :meth:`evaluate`
    recomputes every (tenant, sli, window) burn rate, updates the alert
    state machine, and returns the active alerts.
    """

    def __init__(self, objectives: dict[str, SLOTarget], *,
                 emit: Callable[..., None] | None = None,
                 fast_burn_threshold: float = FAST_BURN_THRESHOLD,
                 slow_burn_threshold: float = SLOW_BURN_THRESHOLD,
                 clock: Callable[[], float] = time.time):
        self.objectives = dict(objectives)
        # Bound ``.emit`` attribute (not a plain function) so graftlint's
        # event-registry pass sees the literal slo_alert/slo_recovered
        # sites below just like any MetricsLogger.emit call.
        self.logger = _NullLogger() if emit is None else _EmitAdapter(emit)
        self.thresholds = {"fast": fast_burn_threshold,
                           "slow": slow_burn_threshold}
        self.clock = clock
        # tenant -> deque[(ts, good_delta, bad_delta)]
        self._events: dict[str, deque] = {
            t: deque() for t in self.objectives}
        # tenant -> deque[(ts, dt_s, violated)] — latency threshold samples
        self._latency: dict[str, deque] = {
            t: deque() for t in self.objectives}
        # tenant -> last cumulative {reason: count} seen (for deltas)
        self._prev_finished: dict[str, dict[str, float]] = {}
        self._last_observed: dict[str, float] = {}
        self._active: dict[tuple[str, str, str], BurnAlert] = {}

    # ------------------------------------------------------------------ feed
    def observe(self, *, finished: dict[str, dict[str, float]] | None = None,
                queue_wait_p95_ms: dict[str, float] | None = None,
                now: float | None = None) -> None:
        """Record one scrape: *finished* maps tenant -> cumulative
        finished-request counts by reason; *queue_wait_p95_ms* maps
        tenant -> current windowed p95. Unknown tenants (no objective)
        are ignored."""
        now = self.clock() if now is None else now
        for tenant, by_reason in (finished or {}).items():
            if tenant not in self.objectives:
                continue
            prev = self._prev_finished.get(tenant, {})
            good = bad = 0.0
            for reason, cum in by_reason.items():
                cum = float(cum)
                before = prev.get(reason, 0.0)
                delta = cum - before if cum >= before else cum  # reset
                if delta <= 0:
                    continue
                if reason in BAD_REASONS:
                    bad += delta
                else:
                    good += delta
            self._prev_finished[tenant] = {r: float(c)
                                           for r, c in by_reason.items()}
            if good or bad:
                self._events[tenant].append((now, good, bad))
        for tenant, p95 in (queue_wait_p95_ms or {}).items():
            target = self.objectives.get(tenant)
            if target is None or target.latency_p95_ms is None:
                continue
            last = self._last_observed.get(tenant)
            if last is not None and now > last:
                # The interval since the previous observation carries the
                # verdict of its endpoint sample — a coarse step function
                # over the already-windowed p95 gauge.
                self._latency[tenant].append(
                    (now, now - last, float(p95) > target.latency_p95_ms))
        for tenant in set((finished or {})) | set((queue_wait_p95_ms or {})):
            if tenant in self.objectives:
                self._last_observed[tenant] = now
        self._trim(now)

    def _trim(self, now: float) -> None:
        for tenant, target in self.objectives.items():
            horizon = now - target.window_s
            ev = self._events[tenant]
            while ev and ev[0][0] <= horizon:
                ev.popleft()
            lat = self._latency[tenant]
            while lat and lat[0][0] <= horizon:
                lat.popleft()

    # ------------------------------------------------------------------ math
    def burn_rate(self, tenant: str, sli: str, window: str,
                  now: float | None = None) -> float:
        """Burn rate for one (tenant, sli, window): bad fraction over the
        window divided by the error budget. 0.0 with no traffic — an idle
        tenant burns nothing."""
        now = self.clock() if now is None else now
        target = self.objectives[tenant]
        horizon = now - target.window_seconds(window)
        if sli == "availability":
            good = bad = 0.0
            for ts, g, b in self._events[tenant]:
                if ts > horizon:
                    good += g
                    bad += b
            total = good + bad
            if total <= 0:
                return 0.0
            return (bad / total) / target.error_budget
        if sli == "latency":
            seen = violated = 0.0
            for ts, dt, bad_interval in self._latency[tenant]:
                if ts > horizon:
                    seen += dt
                    if bad_interval:
                        violated += dt
            if seen <= 0:
                return 0.0
            return (violated / seen) / target.error_budget
        raise ValueError(f"unknown sli {sli!r}")

    def _slis(self, tenant: str) -> tuple[str, ...]:
        target = self.objectives[tenant]
        return (("availability", "latency")
                if target.latency_p95_ms is not None else ("availability",))

    # --------------------------------------------------------------- alerts
    def evaluate(self, now: float | None = None) -> list[BurnAlert]:
        """Recompute every burn rate; fire/clear alerts episodically.
        Returns the currently active alerts (stable tenant/sli/window
        order)."""
        now = self.clock() if now is None else now
        self._trim(now)
        for tenant in sorted(self.objectives):
            for sli in self._slis(tenant):
                for window in ("fast", "slow"):
                    burn = self.burn_rate(tenant, sli, window, now)
                    key = (tenant, sli, window)
                    threshold = self.thresholds[window]
                    if burn > threshold and key not in self._active:
                        self._active[key] = BurnAlert(
                            tenant, sli, window, round(burn, 4), threshold)
                        self.logger.emit("slo_alert", tenant=tenant,
                                         sli=sli, window=window,
                                         burn_rate=round(burn, 4),
                                         threshold=threshold)
                    elif burn <= threshold and key in self._active:
                        del self._active[key]
                        self.logger.emit("slo_recovered", tenant=tenant,
                                         sli=sli, window=window,
                                         burn_rate=round(burn, 4),
                                         threshold=threshold)
        return self.active_alerts()

    def active_alerts(self) -> list[BurnAlert]:
        return [self._active[k] for k in sorted(self._active)]

    def snapshot(self, now: float | None = None) -> dict:
        """JSON-ready view for the ``/fleet`` endpoint and ``graftscope
        fleet``: per tenant the objective, every burn rate, and active
        alerts."""
        now = self.clock() if now is None else now
        tenants = {}
        for tenant in sorted(self.objectives):
            target = self.objectives[tenant]
            burns = {f"{sli}_{window}": round(
                         self.burn_rate(tenant, sli, window, now), 4)
                     for sli in self._slis(tenant)
                     for window in ("fast", "slow")}
            tenants[tenant] = {"objective": target.to_dict(),
                               "burn_rates": burns}
        return {"tenants": tenants,
                "thresholds": dict(self.thresholds),
                "active_alerts": [dataclasses.asdict(a)
                                  for a in self.active_alerts()]}


def objectives_from_tenants(tenants) -> dict[str, SLOTarget]:
    """Extract tenant id -> :class:`SLOTarget` from an iterable of
    :class:`serve.sched.tenant.TenantConfig` (tenants without an ``slo``
    block are skipped — no promise, nothing to burn)."""
    return {t.tenant_id: t.slo for t in tenants
            if getattr(t, "slo", None) is not None}
