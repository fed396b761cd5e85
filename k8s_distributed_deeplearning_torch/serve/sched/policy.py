"""Policy core: per-tenant EDF queues drained by deficit-weighted round
robin under strict priority classes, with token-bucket rate limits and
slot quotas enforced at pop time.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/sched/
policy.py``: the engine's admission queue (``submit``/``pop``/
``drain``/``__len__`` plus ``sweep_expired`` and ``release``); with no
tenant config it is FCFS over one default tenant:

- **Within a tenant: EDF.** A heap keyed by absolute deadline
  (``_t_submit + deadline_s``; none sorts last, FIFO among equals);
  :meth:`sweep_expired` takes dead requests off the heap top.
- **Across tenants of one class: DRR.** Costs are service tokens (prompt
  + max_new_tokens); each tenant accrues deficit in weight-scaled quantum
  rounds and pays its head's cost on pop.
- **Across classes: strict priority.** "interactive" before "normal"
  before "batch"; a lower class runs only when every higher class is
  empty or blocked by its own rate or slot limits.
- **Per-tenant back-pressure.** A tenant over its ``max_queue`` gets
  :class:`QueueFull` naming that tenant; the shed is counted per tenant.
- **Blocked is not empty.** ``pop() -> None`` with ``len(self) > 0``
  means every queued tenant is rate- or quota-blocked right now.

``clock`` is injectable, so tests drive token buckets and deadlines with
a fake clock.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from collections import deque
from typing import Callable, Iterable

from k8s_distributed_deeplearning_torch.serve.request import QueueFull, Request
from k8s_distributed_deeplearning_torch.serve.sched.tenant import (
    DEFAULT_TENANT, PRIORITY_CLASSES, TenantConfig)

# DRR quantum in service tokens per round. Any positive constant yields
# the same steady-state shares (credit rounds are batched); this is just
# the granularity of one round's bookkeeping.
_QUANTUM = 32.0

# Queue-wait samples kept per tenant for the p95 gauges (scrape-time
# percentile over a sliding window, zero cost on the pop path beyond an
# append).
_WAIT_WINDOW = 2048


def _cost(req: Request) -> float:
    """Service tokens a request will consume: prompt prefill + the decode
    budget. The unit of DRR deficits and token buckets."""
    return float(len(req.prompt) + req.max_new_tokens)


class _TenantState:
    """Mutable runtime state behind one :class:`TenantConfig`."""

    __slots__ = ("cfg", "heap", "deficit", "tokens", "t_refill", "in_flight",
                 "shed", "popped", "expired", "wait_s")

    def __init__(self, cfg: TenantConfig, now: float):
        self.cfg = cfg
        # (deadline_abs, seq, Request) — EDF order, FIFO tiebreak.
        self.heap: list[tuple[float, int, Request]] = []
        self.deficit = 0.0
        self.tokens = cfg.burst if cfg.burst is not None else 0.0
        self.t_refill = now
        self.in_flight = 0
        self.shed = 0
        self.popped = 0
        self.expired = 0
        self.wait_s: deque[float] = deque(maxlen=_WAIT_WINDOW)

    def refill(self, now: float) -> None:
        cfg = self.cfg
        if cfg.rate_tokens_per_s is None:
            return
        self.tokens = min(cfg.burst,
                          self.tokens
                          + (now - self.t_refill) * cfg.rate_tokens_per_s)
        self.t_refill = now

    def blocked(self, now: float) -> bool:
        """Rate- or quota-blocked for its HEAD request at *now* (callers
        guarantee a non-empty heap)."""
        cfg = self.cfg
        if cfg.max_slots is not None and self.in_flight >= cfg.max_slots:
            return True
        if cfg.rate_tokens_per_s is not None:
            self.refill(now)
            # Requeued (migrated) heads already paid their token cost at
            # their FIRST pop — a rate block here would double-bill the
            # failover. Slot quota above still applies: migration moves a
            # request, it does not mint extra concurrency.
            if self.heap[0][2]._requeued:
                return False
            # Oversized requests (cost > burst) admit on a full bucket and
            # drive it into debt — they pay their true cost in wait time
            # instead of starving forever.
            if self.tokens < min(_cost(self.heap[0][2]), cfg.burst):
                return True
        return False


class TenantScheduler:
    """SLO-aware multi-tenant admission queue (see module docstring).

    ``tenants=None`` registers the single :data:`DEFAULT_TENANT` with no
    limits: FCFS (every deadline-less request sorts equal, FIFO
    tiebreak). ``default_max_queue`` bounds any tenant that does not set
    its own ``max_queue``.

    ``clock`` is injectable for deterministic token-bucket tests; it must
    be the same clock that stamps ``Request._t_submit``
    (``time.perf_counter`` in the engine).
    """

    def __init__(self, tenants: Iterable[TenantConfig] | None = None, *,
                 default_max_queue: int = 256,
                 clock: Callable[[], float] = time.perf_counter):
        if default_max_queue < 1:
            raise ValueError(
                f"default_max_queue must be >= 1, got {default_max_queue}")
        self._clock = clock
        self.default_max_queue = default_max_queue
        now = clock()
        cfgs = (list(tenants) if tenants is not None
                else [TenantConfig(DEFAULT_TENANT)])
        if not cfgs:
            raise ValueError("at least one tenant is required")
        self._tenants: dict[str, _TenantState] = {}
        for cfg in cfgs:
            if cfg.tenant_id in self._tenants:
                raise ValueError(f"duplicate tenant id {cfg.tenant_id!r}")
            self._tenants[cfg.tenant_id] = _TenantState(cfg, now)
        # Per-class rings in registration order + a rotation cursor each.
        self._rings: dict[str, list[_TenantState]] = {
            cls: [ts for ts in self._tenants.values()
                  if ts.cfg.priority == cls]
            for cls in PRIORITY_CLASSES}
        self._rr: dict[str, int] = {cls: 0 for cls in PRIORITY_CLASSES}
        self._seq = itertools.count()
        # Head-of-line sequence for requeued (migrated) requests: negative
        # and descending, so among equal deadlines a requeue sorts before
        # every normal submit AND before earlier requeues of other
        # requests (LIFO among requeues — the most recently displaced
        # request has waited longest overall).
        self._rseq = itertools.count(-1, -1)
        self._n = 0

    # ------------------------------------------------------------- submit

    def submit(self, req: Request) -> None:
        """Enqueue under the request's tenant. Raises ValueError for an
        unknown tenant and :class:`QueueFull` — scoped to that tenant —
        when its bounded queue is at capacity."""
        tid = req.tenant or DEFAULT_TENANT
        ts = self._tenants.get(tid)
        if ts is None:
            raise ValueError(
                f"unknown tenant {tid!r} (registered: "
                f"{sorted(self._tenants)}) — requests must name a "
                "configured tenant")
        bound = (ts.cfg.max_queue if ts.cfg.max_queue is not None
                 else self.default_max_queue)
        if len(ts.heap) >= bound:
            ts.shed += 1
            raise QueueFull(
                f"tenant {tid!r} admission queue is full ({bound} pending) "
                f"— per-tenant back-pressure, other tenants are unaffected "
                f"(request {req.request_id})")
        if req._t_submit is None:
            req._t_submit = self._clock()
        dl = (req._t_submit + req.deadline_s
              if req.deadline_s is not None else math.inf)
        heapq.heappush(ts.heap, (dl, next(self._seq), req))
        self._n += 1

    def requeue(self, req: Request) -> None:
        """Re-enqueue a request that was already admitted once and had to
        be given back (a migration, or a drained replica) AT THE HEAD of
        its deadline class: the original ``deadline_abs`` is preserved
        (``_t_submit`` was stamped at the first submit and carries over),
        the tenant's token bucket is NOT re-charged at the next pop (the
        first pop already billed the full prompt+decode cost), and the
        ``max_queue`` bound is bypassed — shedding a request we promised
        to migrate would turn a replica failure into a client-visible
        loss. Raises ValueError for an unknown tenant (same contract as
        :meth:`submit`)."""
        tid = req.tenant or DEFAULT_TENANT
        ts = self._tenants.get(tid)
        if ts is None:
            raise ValueError(
                f"unknown tenant {tid!r} (registered: "
                f"{sorted(self._tenants)}) — requests must name a "
                "configured tenant")
        if req._t_submit is None:
            req._t_submit = self._clock()
        req._requeued = True
        dl = (req._t_submit + req.deadline_s
              if req.deadline_s is not None else math.inf)
        heapq.heappush(ts.heap, (dl, next(self._rseq), req))
        self._n += 1

    def remove(self, request_id: str) -> Request | None:
        """Remove one queued request by id (``ServeEngine.cancel``), or
        None when it is not queued. O(n) scan
        + heapify of the owning tenant's heap — cancellation is the rare
        path; the pop path stays O(log n)."""
        for ts in self._tenants.values():
            for i, (_, _, req) in enumerate(ts.heap):
                if req.request_id == request_id:
                    ts.heap[i] = ts.heap[-1]
                    ts.heap.pop()
                    heapq.heapify(ts.heap)
                    self._n -= 1
                    if not ts.heap:
                        ts.deficit = 0.0
                    return req
        return None

    # ---------------------------------------------------------------- pop

    def pop(self, fits=None) -> Request | None:
        """Next admissible request under the policy, or None when every
        queued tenant is rate- or quota-blocked (or nothing is queued).
        A returned request holds one slot against its tenant's quota
        until :meth:`release`.

        ``fits`` (optional predicate) is the engine's resource probe —
        e.g. "does the KV page pool cover this request's worst-case
        need". It runs on the policy's CHOSEN head BEFORE any state
        mutates: a False verdict returns None with the request still
        queued at its tenant's head (deficits, rate tokens and quotas
        untouched), so admission back-pressure composes with DRR without
        double-charging the deferred request."""
        if not self._n:
            return None
        now = self._clock()
        for cls in PRIORITY_CLASSES:
            ring = self._rings[cls]
            if not any(ts.heap for ts in ring):
                continue
            chosen = self._drr_pick(ring, cls, now)
            if chosen is None:
                continue            # class fully blocked: try the next one
            ts, idx = chosen
            if fits is not None and not fits(ts.heap[0][2]):
                return None         # resource-blocked: defer in place
            _, _, req = heapq.heappop(ts.heap)
            self._n -= 1
            if req._requeued:
                # Migrated request: its first pop paid the full service
                # cost (deficit + rate tokens); this pop is the prepaid
                # continuation, not a second admission.
                req._requeued = False
            else:
                cost = _cost(req)
                ts.deficit -= cost
                if ts.cfg.rate_tokens_per_s is not None:
                    ts.tokens -= cost
            if not ts.heap:
                ts.deficit = 0.0    # classic DRR: an emptied queue forfeits
            ts.in_flight += 1
            ts.popped += 1
            if req._t_submit is not None:
                ts.wait_s.append(now - req._t_submit)
            # Keep serving this tenant while its deficit covers its next
            # head; otherwise the cursor moves on (the DRR rotation).
            if not ts.heap or ts.deficit < _cost(ts.heap[0][2]):
                self._rr[cls] = (idx + 1) % len(ring)
            else:
                self._rr[cls] = idx
            return req
        return None

    def _drr_pick(self, ring: list[_TenantState], cls: str,
                  now: float) -> tuple[_TenantState, int] | None:
        """One DRR selection within a class: scan from the rotation
        cursor for a tenant whose deficit covers its head cost; when none
        qualifies, credit every unblocked tenant the same (batched) number
        of weight-scaled quantum rounds and scan once more. Returns
        (tenant, ring index) or None when the class is fully blocked."""
        for attempt in range(2):
            n = len(ring)
            start = self._rr[cls] % n
            needed: list[tuple[float, _TenantState]] = []
            for i in range(n):
                ts = ring[(start + i) % n]
                if not ts.heap or ts.blocked(now):
                    continue
                head = ts.heap[0][2]
                # A requeued head is deficit-free (billed at first pop).
                cost = 0.0 if head._requeued else _cost(head)
                if ts.deficit >= cost:
                    return ts, (start + i) % n
                needed.append((cost, ts))
            if not needed or attempt:
                return None
            # Batched credit: the fewest whole rounds that make at least
            # one tenant eligible — identical shares to crediting one
            # quantum per visit, without O(cost/quantum) Python laps.
            rounds = min(math.ceil((cost - ts.deficit)
                                   / (_QUANTUM * ts.cfg.weight))
                         for cost, ts in needed)
            rounds = max(rounds, 1)
            for _, ts in needed:
                ts.deficit += rounds * _QUANTUM * ts.cfg.weight
        return None

    # ------------------------------------------------------ engine surface

    def release(self, req: Request) -> None:
        """A popped request reached a terminal state (finished, cancelled,
        or expired at pop): return its slot to the tenant's quota."""
        ts = self._tenants.get(req.tenant or DEFAULT_TENANT)
        if ts is not None and ts.in_flight > 0:
            ts.in_flight -= 1

    def sweep_expired(self, now: float | None = None) -> list[Request]:
        """Remove and return every queued request whose deadline has
        already passed — EDF keys the heaps by deadline, so the expired
        set is exactly a prefix of each heap. Swept requests never held a
        slot, so no :meth:`release` is owed for them."""
        if now is None:
            now = self._clock()
        out: list[Request] = []
        for ts in self._tenants.values():
            h = ts.heap
            while h and h[0][0] < now:
                _, _, req = heapq.heappop(h)
                ts.expired += 1
                self._n -= 1
                out.append(req)
            if not h:
                ts.deficit = 0.0
        return out

    def drain(self) -> list[Request]:
        """Remove and return everything queued, in submit order (the
        shutdown path — deficits and rotation reset with the queues)."""
        items: list[tuple[float, int, Request]] = []
        for ts in self._tenants.values():
            items.extend(ts.heap)
            ts.heap.clear()
            ts.deficit = 0.0
        self._n = 0
        items.sort(key=lambda e: e[1])
        return [req for _, _, req in items]

    def __len__(self) -> int:
        return self._n

    # ----------------------------------------------------------- telemetry

    def tenant_ids(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    def depths(self) -> dict[str, int]:
        """Per-tenant queue depth only: one len() per tenant, cheap enough
        for every step (:meth:`snapshot` sorts wait percentiles)."""
        return {tid: len(ts.heap) for tid, ts in self._tenants.items()
                if ts.heap}

    def priority_of(self, tenant_id: str | None) -> str | None:
        """The priority class a tenant's requests run under (None for an
        unregistered tenant)."""
        ts = self._tenants.get(tenant_id or DEFAULT_TENANT)
        return ts.cfg.priority if ts is not None else None

    def snapshot(self) -> dict:
        """Point-in-time view for the CLI's ``sched_tenant_summary``
        events: per-tenant depth/shed/quota state and per-priority-class
        queue-wait percentiles."""
        tenants: dict[str, dict] = {}
        by_class: dict[str, dict] = {}
        for tid, ts in self._tenants.items():
            waits = list(ts.wait_s)
            tenants[tid] = {
                "priority": ts.cfg.priority,
                "weight": ts.cfg.weight,
                "queue_depth": len(ts.heap),
                "in_flight": ts.in_flight,
                "shed_total": ts.shed,
                "expired_total": ts.expired,
                "popped_total": ts.popped,
                "rate_tokens_available": (
                    round(ts.tokens, 3)
                    if ts.cfg.rate_tokens_per_s is not None else None),
                "queue_wait_p95_ms": _p95_ms(waits),
            }
            c = by_class.setdefault(ts.cfg.priority,
                                    {"queue_depth": 0, "_waits": []})
            c["queue_depth"] += len(ts.heap)
            c["_waits"].extend(waits)
        classes = {
            cls: {"queue_depth": c["queue_depth"],
                  "queue_wait_p95_ms": _p95_ms(c.pop("_waits"))}
            for cls, c in by_class.items()}
        return {"tenants": tenants, "classes": classes}


def _p95_ms(waits: list[float]) -> float | None:
    if not waits:
        return None
    s = sorted(waits)
    return round(s[min(len(s) - 1, int(round(0.95 * (len(s) - 1))))] * 1e3, 3)
