"""graftgate: failover gateway over N in-process ServeEngine replicas —
health-routed dispatch, per-replica circuit breakers, bounded hedging,
replica drain, and IN-FLIGHT REQUEST MIGRATION.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
gateway.py``, over the port's engines. The gateway owns the client-facing
request lifecycle and treats each replica as a disposable executor:

- **Health-routed dispatch**: new requests go to the healthiest,
  least-loaded replica, scored with :class:`telemetry.fleet.HealthPolicy`'s
  weights over queue depth, slot occupancy and KV-page pressure read off
  the engines.
- **Per-replica circuit breaker**: ``failures_to_trip`` consecutive
  dispatch failures (an exception out of the replica's step, or a step
  over ``stall_trip_s``) OPEN it: dispatch stops and every live request
  on the replica migrates off. After a backoff the breaker goes
  HALF-OPEN and the next iteration probes the replica with one step;
  success CLOSES it, failure re-opens it with the backoff doubled (up to
  ``max_probe_backoff_s``).
- **In-flight migration**: the gateway streams through per-dispatch
  shadow callbacks and keeps the client-visible token cursor a request.
  A tripped replica's requests are resubmitted to a peer as ``prompt +
  tokens streamed`` (:meth:`Request.resume_from_tokens`, greedy streams
  continue unchanged); a drained replica's decoding requests move by
  their KV pages (``export_request_kv`` -> ``import_request_kv``), with
  resubmission as the fallback. Dead shadows are muted before the victim
  is torn down, so no token is forwarded twice and ``on_finish`` fires
  once a client request.
- **Bounded hedging**: a request without its first token
  ``hedge_after_s`` after dispatch gets ``max_hedges`` duplicate
  dispatches on peers; the first shadow to produce a token wins, the
  loser is cancelled (engine reason ``hedge_lost``).
- **Drain** (:meth:`drain_replica`), **poison quarantine** (a request
  that has used ``max_migrations`` ends "poisoned") and :meth:`snapshot`.
- **Dynamic membership**: :meth:`add_replica` folds a new engine into
  the running gateway (breaker and health state created at runtime, the
  next submit can route to it); :meth:`remove_replica` retires one
  through the drain+migrate path and drops its state with it. This is
  the surface ``serve/autoscale.py`` drives, along with two reversible
  brownout levers: ``shed_classes`` (tenant priority classes refused at
  the door) and ``max_live_requests`` (an admission cap).

Chaos surface: the ``gateway_dispatch`` fault site fires before each
replica's step with ``step=<replica index>``, so a step-scoped plan
targets exactly one replica (``ioerror`` = its dispatch fails, ``stall`` =
it straggles).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Iterable, Sequence

from k8s_distributed_deeplearning_torch import faults as _faults
from k8s_distributed_deeplearning_torch.serve.engine import ServeEngine
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, RequestOutput)
from k8s_distributed_deeplearning_torch.telemetry.fleet import HealthPolicy
from k8s_distributed_deeplearning_torch.utils.metrics import (
    MetricsLogger, ServingStats)

# Breaker states (snapshot()/gateway_collector export these literals).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Shadow:
    """One dispatch of a client request onto one replica: the per-replica
    Request clone carrying gateway closures. ``alive=False`` mutes its
    callbacks — flipped BEFORE the replica is cancelled/shut down, which
    is what makes the migration splice exactly-once without unwinding
    anything inside the engine."""

    __slots__ = ("rid", "req", "alive")

    def __init__(self, rid: str, req: Request):
        self.rid = rid
        self.req = req
        self.alive = True


class _GwRequest:
    """Gateway-side lifecycle record for ONE client request.

    ``emitted`` is the client-visible token cursor (every token forwarded
    to ``on_token`` so far) — the migration resubmission is
    ``prompt + emitted``. ``winner`` is the shadow whose stream feeds the
    client (first shadow to produce a token; a migration resubmission is
    the winner immediately, since its stream *continues* the cursor).
    ``finished`` is the exactly-once latch for the client ``on_finish``.
    """

    __slots__ = ("req", "emitted", "finished", "winner", "shadows",
                 "hedges", "migrations", "t_submit", "t_dispatch",
                 "t_first")

    def __init__(self, req: Request, now: float):
        self.req = req
        self.emitted: list[int] = []
        self.finished = False
        self.winner: _Shadow | None = None
        self.shadows: dict[str, _Shadow] = {}     # rid -> live shadow
        self.hedges = 0
        self.migrations = 0
        self.t_submit = now
        self.t_dispatch = now
        self.t_first: float | None = None


class _Replica:
    """One managed engine + its breaker state machine."""

    __slots__ = ("engine", "rid", "index", "state", "consecutive",
                 "backoff", "next_probe_t", "draining", "drained_emitted")

    def __init__(self, engine: ServeEngine, rid: str, index: int,
                 backoff: float):
        self.engine = engine
        self.rid = rid
        self.index = index
        self.state = CLOSED
        self.consecutive = 0
        self.backoff = backoff
        self.next_probe_t = 0.0
        self.draining = False
        self.drained_emitted = False


class ServeGateway:
    """Failover front for N replicas sharing one client request surface.

    Usage::

        gw = ServeGateway([eng_a, eng_b], hedge_after_s=0.5)
        gw.submit(Request(prompt=[...], max_new_tokens=64,
                          on_token=stream, on_finish=done))
        outputs = gw.run()            # or step() per iteration

    ``step()`` advances every routable replica one engine iteration
    (firing the ``gateway_dispatch`` fault site per replica first) and
    returns the client requests that reached a terminal state. Replica
    failures never surface to the caller as exceptions — they become
    breaker trips and migrations; the only client-visible failure mode
    is ``finish_reason="aborted"`` when NO healthy replica can take a
    request.

    ``stats`` (shared with the engines in the CLI wiring) carries the
    gateway counters into ``summary()``.
    ``clock`` is injectable for breaker tests. ``stall_trip_s`` of None
    disables stall detection (an engine iteration on CPU tiny models is
    milliseconds; real deployments set this to a few decode periods).
    """

    def __init__(self, replicas: Sequence[ServeEngine], *,
                 policy: HealthPolicy | None = None,
                 failures_to_trip: int = 3,
                 probe_backoff_s: float = 0.5,
                 max_probe_backoff_s: float = 30.0,
                 stall_trip_s: float | None = None,
                 hedge_after_s: float | None = None,
                 max_hedges: int = 1,
                 max_migrations: int | None = 8,
                 stats: ServingStats | None = None,
                 logger: MetricsLogger | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 flight=None):
        if not replicas:
            raise ValueError("gateway needs at least one replica")
        if failures_to_trip < 1:
            raise ValueError(
                f"failures_to_trip must be >= 1, got {failures_to_trip}")
        if probe_backoff_s <= 0 or max_probe_backoff_s < probe_backoff_s:
            raise ValueError(
                f"need 0 < probe_backoff_s <= max_probe_backoff_s, got "
                f"{probe_backoff_s} / {max_probe_backoff_s}")
        if hedge_after_s is not None and hedge_after_s <= 0:
            raise ValueError(
                f"hedge_after_s must be > 0 (None = off), got "
                f"{hedge_after_s}")
        if max_migrations is not None and max_migrations < 1:
            raise ValueError(
                f"max_migrations must be >= 1 (None = unbounded), got "
                f"{max_migrations}")
        self.policy = policy if policy is not None else HealthPolicy()
        self.failures_to_trip = failures_to_trip
        self.probe_backoff_s = probe_backoff_s
        self.max_probe_backoff_s = max_probe_backoff_s
        self.stall_trip_s = stall_trip_s
        self.hedge_after_s = hedge_after_s
        self.max_hedges = max_hedges
        # Poison-request quarantine: a request whose replica keeps dying
        # under it gets this many migrations, then a terminal "poisoned"
        # — otherwise one pathological prompt (a decode-crasher) would
        # migration-loop the whole fleet forever. None = unbounded (the
        # pre-quarantine behaviour, for tests that count migrations).
        self.max_migrations = max_migrations
        self.stats = stats if stats is not None else ServingStats()
        self.logger = logger
        # Flight recorder (telemetry/flight.py): the gateway records the
        # breaker/routing view each step and dumps the ring on a breaker
        # trip — BEFORE evacuation tears the victim engine down, so the
        # dump still names the pages held at death. None = off.
        self.flight = flight
        if flight is not None:
            _faults.add_fire_hook(self)
        self._clock = clock
        # Guards the membership structures (_replicas/_by_rid/_next_index)
        # only: the injector's fire hook and the exporter's collector
        # threads read them mid-step via _flight_extra/snapshot while the
        # main thread adds/removes replicas. Engine calls stay OUTSIDE
        # the lock — membership is copied under it, then inspected.
        self._lock = threading.Lock()
        self._replicas: list[_Replica] = []
        self._by_rid: dict[str, _Replica] = {}
        for i, eng in enumerate(replicas):
            rid = eng.replica_id if eng.replica_id is not None else f"r{i}"
            if eng.replica_id is None:
                eng.replica_id = rid      # request_trace replica= field
            if rid in self._by_rid:
                raise ValueError(f"duplicate replica_id {rid!r}")
            h = _Replica(eng, rid, i, probe_backoff_s)
            self._replicas.append(h)
            self._by_rid[rid] = h
        # Replica indices are MONOTONIC across the gateway's lifetime
        # (never reused after remove_replica) so a step-scoped
        # gateway_dispatch fault plan keeps naming the same replica.
        self._next_index = len(self._replicas)
        # Brownout levers (serve/autoscale.py): tenant classes shed at
        # the door, and a cap on concurrently admitted client requests.
        self.shed_classes: frozenset[str] = frozenset()
        self.max_live_requests: int | None = None
        self._live: dict[str, _GwRequest] = {}     # request_id -> record
        self._completed: list[RequestOutput] = []

    # ---------------------------------------------------------------- API

    def submit(self, req: Request) -> str:
        """Route *req* to the healthiest admitting replica. Raises
        :class:`QueueFull` when no routable replica can admit it right
        now (back-pressure — retry after completions), and ValueError
        for requests no replica could ever run (propagated from the
        engine's static checks)."""
        if req.request_id in self._live:
            raise ValueError(
                f"request {req.request_id} is already live in the gateway")
        if (self.max_live_requests is not None
                and len(self._live) >= self.max_live_requests):
            raise QueueFull(
                f"gateway admission tightened to {self.max_live_requests} "
                f"live requests (brownout) — retry after completions")
        if self.shed_classes:
            klass = self._tenant_class(req.tenant)
            if klass in self.shed_classes:
                raise QueueFull(
                    f"tenant {req.tenant!r} class {klass!r} is shed "
                    f"(brownout) — retry after the fleet recovers")
        g = _GwRequest(req, self._clock())
        exclude: set[str] = set()
        while True:
            h = self._route(exclude)
            if h is None:
                raise QueueFull(
                    f"no healthy replica can admit request "
                    f"{req.request_id} — retry after completions")
            try:
                self._dispatch(g, h)
                break
            except (QueueFull, EngineDraining):
                exclude.add(h.rid)
        self._live[req.request_id] = g
        return req.request_id

    def step(self) -> list[RequestOutput]:
        """One gateway iteration: advance every routable replica one
        engine step (half-open breakers probe here), score the outcome
        into the breaker, evacuate trips, then hedge stragglers.
        Returns client requests that finished during the iteration."""
        inj = _faults.active()
        for h in self._replicas:
            now = self._clock()
            if h.state == OPEN:
                if now < h.next_probe_t:
                    continue
                h.state = HALF_OPEN
            failed = False
            t0 = self._clock()
            try:
                if inj is not None:
                    inj.fire("gateway_dispatch", step=h.index)
                if h.engine.busy() or h.state == HALF_OPEN:
                    h.engine.step()
            except Exception as e:   # noqa: BLE001 — ANY exception out of
                # a replica's dispatch is that replica's failure, not the
                # gateway's: score it and keep the other replicas serving.
                failed = True
                self._dispatch_failure(h, repr(e))
            if not failed:
                dt = self._clock() - t0
                if self.stall_trip_s is not None and dt > self.stall_trip_s:
                    self._dispatch_failure(
                        h, f"step stalled {dt:.3f}s "
                           f"(trip at {self.stall_trip_s:.3f}s)")
                else:
                    self._dispatch_success(h)
            if (h.draining and not h.drained_emitted
                    and h.engine.drained):
                h.drained_emitted = True
                if self.logger is not None:
                    self.logger.emit("replica_drained", replica=h.rid)
        if self.flight is not None and self.flight.enabled:
            self.flight.record(
                "gateway",
                breakers={h.rid: h.state for h in self._replicas},
                draining=[h.rid for h in self._replicas if h.draining],
                live_requests=len(self._live),
                replica_load={
                    h.rid: int(load())
                    for h in self._replicas
                    if (load := getattr(h.engine, "load", None)) is not None})
        self._maybe_hedge(self._clock())
        out, self._completed = self._completed, []
        return out

    def busy(self) -> bool:
        """True while any client request is live or any replica still
        holds work (drain stragglers)."""
        return bool(self._live) or any(
            h.engine.busy() for h in self._replicas)

    def run(self, requests: Iterable[Request] | None = None,
            max_steps: int | None = None) -> list[RequestOutput]:
        """Feed *requests* under back-pressure and step until every
        client request reaches a terminal state (same contract as
        :meth:`ServeEngine.run`)."""
        feed: deque[Request] = (deque(requests) if requests is not None
                                else deque())
        outputs: list[RequestOutput] = []
        steps = 0
        while True:
            while feed:
                try:
                    self.submit(feed[0])
                except QueueFull:
                    break
                feed.popleft()
            if not (self.busy() or feed):
                break
            outs = self.step()
            outputs.extend(outs)
            if not outs and all(h.state == OPEN for h in self._replicas):
                # Every breaker is open: nothing can step until a probe
                # timer expires — yield instead of spinning.
                time.sleep(0.001)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return outputs

    def add_replica(self, engine, *, rid: str | None = None) -> str:
        """Fold a new replica into the running gateway: breaker and
        health state are created fresh (CLOSED, zero failures) and the
        very next :meth:`submit`/:meth:`step` can route to it. Returns
        the replica id. Raises ValueError on a duplicate id."""
        if rid is None:
            rid = getattr(engine, "replica_id", None)
        with self._lock:
            index = self._next_index
            if rid is None:
                rid = f"r{index}"
            if rid in self._by_rid:
                raise ValueError(f"duplicate replica_id {rid!r}")
            self._next_index += 1
            h = _Replica(engine, rid, index, self.probe_backoff_s)
            self._replicas.append(h)
            self._by_rid[rid] = h
            n = len(self._replicas)
        if getattr(engine, "replica_id", None) is None:
            engine.replica_id = rid       # request_trace replica= field
        if self.logger is not None:
            self.logger.emit("gateway_replica_added", replica=rid,
                             replicas=n)
        return rid

    def remove_replica(self, rid: str, *, force: bool = False) -> None:
        """Retire one replica from the gateway: drain it (the
        migration-backed path — queued and in-flight work moves to peers
        with its emitted-token cursor, zero lost requests), then drop its
        breaker/health state. Raises ValueError for an unknown id or the
        last replica, and RuntimeError if the engine has not finished
        draining yet (call again after more steps; ``force=True`` skips
        both the last-replica and the drained checks — shutdown paths)."""
        with self._lock:
            h = self._by_rid.get(rid)
            if h is None:
                raise ValueError(
                    f"unknown replica {rid!r} (have {sorted(self._by_rid)})")
            if len(self._replicas) <= 1 and not force:
                raise ValueError(
                    f"refusing to remove the last replica {rid!r} "
                    f"(force=True to tear the gateway down)")
        if not h.draining:
            self.drain_replica(rid)
        if not h.engine.drained and not force:
            raise RuntimeError(
                f"replica {rid!r} is still draining — step the gateway "
                f"until its engine reports drained, then remove")
        with self._lock:
            self._replicas.remove(h)
            del self._by_rid[rid]
            n = len(self._replicas)
        if self.logger is not None:
            self.logger.emit("gateway_replica_removed", replica=rid,
                             replicas=n)

    def replica_engine(self, rid: str):
        """The engine behind *rid* (autoscale backends stop it after the
        gateway has retired the membership)."""
        return self._by_rid[rid].engine

    def replica_ids(self) -> list[str]:
        return [h.rid for h in self._replicas]

    def _tenant_class(self, tenant: str) -> str | None:
        """Priority class of *tenant* per the first replica scheduler
        that knows it (TenantScheduler.priority_of); None when no
        scheduler claims the tenant (stub engines, plain-list queues)."""
        for h in self._replicas:
            pr = getattr(getattr(h.engine, "queue", None),
                         "priority_of", None)
            if pr is None:
                continue
            klass = pr(tenant)
            if klass is not None:
                return klass
        return None

    def drain_replica(self, rid: str) -> None:
        """Cooperatively drain one replica: flush its queued requests and
        migrate them AND its in-flight work to peers, leaving it to
        finish empty (engine cancel reason ``migrated``). Idempotent;
        raises ValueError for an unknown replica id."""
        h = self._by_rid.get(rid)
        if h is None:
            raise ValueError(
                f"unknown replica {rid!r} (have {sorted(self._by_rid)})")
        if h.draining:
            return
        h.draining = True
        flushed = h.engine.drain(flush=True)
        for sreq in flushed:
            g = self._live.get(sreq.request_id)
            if g is None:
                continue
            sh = g.shadows.pop(rid, None)
            if sh is not None:
                sh.alive = False
            self._migrate(g, from_rid=rid)
        self._evacuate(h, kill=False)
        if h.engine.drained and not h.drained_emitted:
            h.drained_emitted = True
            if self.logger is not None:
                self.logger.emit("replica_drained", replica=rid)

    def shutdown(self) -> list[RequestOutput]:
        """Abort everything on every replica; each live client request
        completes once with ``finish_reason="aborted"``."""
        for g in self._live.values():
            for sh in g.shadows.values():
                sh.alive = False
            g.shadows.clear()
        for h in self._replicas:
            h.engine.shutdown()
        for g in list(self._live.values()):
            self._finish_client(g, "aborted")
        out, self._completed = self._completed, []
        return out

    def breaker_state(self, rid: str) -> str:
        return self._by_rid[rid].state

    def snapshot(self) -> dict:
        """Point-in-time gateway view: the bridge's ``gateway_collector``,
        the CLI summary and the fleet controller read this."""
        now = self._clock()
        with self._lock:
            members = list(self._replicas)
        replicas = {}
        for h in members:
            replicas[h.rid] = {
                "state": h.state,
                "consecutive_failures": h.consecutive,
                "health": round(self._health_score(h), 4),
                "load": h.engine.load(),
                "slots": getattr(h.engine, "num_slots", 0),
                "draining": h.draining,
                "drained": h.engine.drained,
                "next_probe_in_s": (round(max(0.0, h.next_probe_t - now), 3)
                                    if h.state == OPEN else 0.0),
            }
        return {
            "replicas": replicas,
            "live_requests": len(self._live),
            "gateway_dispatches": self.stats.gateway_dispatches,
            "gateway_migrations": self.stats.gateway_migrations,
            "gateway_hedges": self.stats.gateway_hedges,
            "gateway_breaker_trips": self.stats.gateway_breaker_trips,
        }

    # ------------------------------------------------------------ routing

    def _health_score(self, h: _Replica) -> float:
        """HealthPolicy composite over the in-process signals: queue
        depth, slot occupancy, KV-page pressure. The liveness components
        (heartbeat/scrape staleness) are the breaker's job here, so they
        contribute zero penalty and the floor is 1 - (w_queue +
        w_occupancy + w_kv), not 0."""
        p, eng = self.policy, h.engine
        pen_q = min(1.0, len(eng.queue) / max(p.queue_full_depth, 1.0))
        pen_occ = eng.occupied_slots() / max(eng.num_slots, 1)
        c = eng.pool.counters()
        pen_kv = (c["pages_used"] / c["pages_total"]
                  if c["pages_total"] else 0.0)
        return 1.0 - (p.w_queue * pen_q + p.w_occupancy * pen_occ
                      + p.w_kv * pen_kv)

    def _route(self, exclude: set[str] | frozenset = frozenset()
               ) -> _Replica | None:
        """Healthiest, least-loaded routable replica (closed or
        currently-probing half-open breaker, not draining, not in
        *exclude*), or None."""
        best: _Replica | None = None
        best_key: tuple | None = None
        for h in self._replicas:
            if (h.rid in exclude or h.state == OPEN or h.draining
                    or h.engine.draining):
                continue
            # Prefer closed breakers over a half-open probe target.
            key = (h.state != CLOSED, -self._health_score(h),
                   h.engine.load(), h.index)
            if best_key is None or key < best_key:
                best, best_key = h, key
        return best

    # --------------------------------------------------- dispatch/splice

    def _dispatch(self, g: _GwRequest, h: _Replica, *,
                  requeue: bool = False,
                  migrated_from: str | None = None) -> None:
        """Place one shadow of *g* on replica *h*. May raise QueueFull /
        EngineDraining (caller picks another target)."""
        if g.emitted:
            sreq = g.req.resume_from_tokens(g.emitted,
                                            migrated_from=migrated_from)
        else:
            sreq = dataclasses.replace(g.req, migrated_from=migrated_from,
                                       _finished=False, _requeued=False)
        sh = _Shadow(h.rid, sreq)
        sreq.on_token = (lambda tok, g=g, sh=sh:
                         self._on_shadow_token(g, sh, tok))
        sreq.on_finish = (lambda reason, g=g, sh=sh:
                          self._on_shadow_finish(g, sh, reason))
        h.engine.submit(sreq, requeue=requeue)
        if g.req._t_submit is None:
            # Anchor the client request's deadline clock to the FIRST
            # engine submit: resume_from_tokens carries it, so a migrated
            # request's deadline_abs never resets.
            g.req._t_submit = sreq._t_submit
        g.shadows[h.rid] = sh
        g.t_dispatch = self._clock()
        if g.emitted:
            # A migration resubmission CONTINUES the client cursor: its
            # stream is authoritative from the moment it is placed.
            g.winner = sh
        self.stats.record_gateway_dispatch()

    def _on_shadow_token(self, g: _GwRequest, sh: _Shadow,
                         tok: int) -> None:
        if not sh.alive or g.finished:
            return
        if g.winner is None:
            g.winner = sh
            for other in list(g.shadows.values()):
                if other is not sh and other.alive:
                    self._cancel_shadow(g, other, "hedge_lost")
        if g.winner is not sh:
            return                     # racing loser: drop its stream
        if g.t_first is None:
            g.t_first = self._clock()
        g.emitted.append(tok)
        if g.req.on_token is not None:
            g.req.on_token(tok)

    def _on_shadow_finish(self, g: _GwRequest, sh: _Shadow,
                          reason: str) -> None:
        if not sh.alive:
            return                     # muted: migrated/cancelled shadow
        sh.alive = False
        g.shadows.pop(sh.rid, None)
        if g.finished:
            return
        if g.winner is not None and g.winner is not sh:
            return                     # a loser finishing never ends the
            #                            client stream
        self._finish_client(g, reason)

    def _cancel_shadow(self, g: _GwRequest, sh: _Shadow,
                       reason: str) -> None:
        """Mute then cancel one shadow on ITS engine (safe mid-step: the
        losing shadow always lives on a different replica than the one
        whose token fanout is running)."""
        sh.alive = False
        g.shadows.pop(sh.rid, None)
        self._by_rid[sh.rid].engine.cancel(sh.req.request_id, reason)

    def _finish_client(self, g: _GwRequest, reason: str) -> None:
        """The client-facing terminal: exactly once per request across
        any number of migrations/hedges."""
        if g.finished:
            return
        g.finished = True
        self._live.pop(g.req.request_id, None)
        now = self._clock()
        out = RequestOutput(
            request_id=g.req.request_id, prompt_len=len(g.req.prompt),
            tokens=list(g.emitted), finish_reason=reason,
            queue_s=g.t_dispatch - g.t_submit,
            ttft_s=(g.t_first - g.t_submit
                    if g.t_first is not None else None),
            latency_s=now - g.t_submit)
        self._completed.append(out)
        if g.req.on_finish is not None:
            g.req.on_finish(reason)

    # ------------------------------------------------------------ breaker

    def _dispatch_success(self, h: _Replica) -> None:
        if h.state == HALF_OPEN:
            h.state = CLOSED
            h.backoff = self.probe_backoff_s
            if self.logger is not None:
                self.logger.emit("gateway_breaker_closed", replica=h.rid)
        h.consecutive = 0

    def _dispatch_failure(self, h: _Replica, why: str) -> None:
        h.consecutive += 1
        if h.state == HALF_OPEN:
            # Failed probe: re-open with the backoff doubled (bounded) —
            # a doubling schedule, stretched across probe attempts.
            h.backoff = min(h.backoff * 2.0, self.max_probe_backoff_s)
            self._trip(h, why)
        elif h.consecutive >= self.failures_to_trip:
            self._trip(h, why)

    def _trip(self, h: _Replica, why: str) -> None:
        h.state = OPEN
        h.next_probe_t = self._clock() + h.backoff
        self.stats.record_gateway_breaker_trip()
        if self.logger is not None:
            self.logger.emit("gateway_breaker_open", replica=h.rid,
                             reason=why, retry_in_s=round(h.backoff, 3))
        if self.flight is not None:
            # Capture the black box NOW — _evacuate shuts the victim
            # engine down, which derefs every page it holds; the dump
            # must name who held memory at the moment of death.
            self.flight.dump("breaker_trip",
                             extra=self._flight_extra(h, why))
        self._evacuate(h, kill=True)

    def _flight_extra(self, h: _Replica | None = None,
                      why: str | None = None) -> dict:
        """Terminal context for a flight-dump header: every breaker's
        state plus — when a specific replica is dying — its reason and
        its pool's page ledger. getattr-guarded so stub engines/pools
        (tests) without the ledger surface still dump cleanly."""
        with self._lock:
            members = list(self._replicas)
        extra: dict = {
            "breakers": {r.rid: r.state for r in members},
            "live_requests": len(self._live),
        }
        if h is not None:
            extra["replica"] = h.rid
            extra["trip_error"] = why
            pool = getattr(h.engine, "pool", None)
            if pool is not None:
                counters = getattr(pool, "counters", None)
                owners = getattr(pool, "owners_summary", None)
                held = getattr(pool, "held_pages", None)
                if counters is not None:
                    extra["pool"] = counters()
                if owners is not None:
                    extra["pages_by_owner"] = owners()
                if held is not None:
                    extra["pages_held"] = held()
        return extra

    def _on_fault(self, site: str, action: str) -> None:
        """faults.add_fire_hook callback: dump the routing/breaker view
        before an injected fault (possibly ``os._exit``) executes."""
        if self.flight is not None:
            self.flight.dump("fault", extra={
                "site": site, "action": action, **self._flight_extra()})

    # ---------------------------------------------------------- migration

    def _evacuate(self, h: _Replica, *, kill: bool) -> None:
        """Move every live client request off replica *h*. ``kill=True``
        (breaker trip) tears the whole engine down — shadows are muted
        FIRST so the shutdown's "aborted" fanout is silent at the
        gateway. ``kill=False`` (drain) cancels per-request with reason
        ``migrated`` so the replica's stats/traces say what happened."""
        victims: list[_GwRequest] = []
        for g in list(self._live.values()):
            sh = g.shadows.pop(h.rid, None)
            if sh is not None:
                sh.alive = False
                victims.append(g)
        if kill:
            h.engine.shutdown()
        for g in victims:
            if not kill and self._migrate_shipped(g, h):
                continue        # pages moved by value: no re-prefill
            if not kill:
                h.engine.cancel(g.req.request_id, "migrated")
            self._migrate(g, from_rid=h.rid)

    def _migrate_shipped(self, g: _GwRequest, h: _Replica) -> bool:
        """Drain-path migration upgrade: when the source replica is
        ALIVE and in-process, move the request's KV pages by value
        (``export_request_kv`` -> ``import_request_kv``) instead of
        re-prefilling ``prompt + emitted`` on the target. Token
        resubmission (:meth:`_migrate`) stays the crash-path fallback —
        any failure here simply returns False and the caller takes it
        (the emitted cursor in *g* is authoritative either way, so the
        client stream splices bit-identically on both paths)."""
        if g.finished or any(sh.alive for sh in g.shadows.values()):
            return False
        if (self.max_migrations is not None
                and g.migrations >= self.max_migrations):
            return False       # quarantine: _migrate poisons, not ships
        src = h.engine
        if not hasattr(src, "export_request_kv"):
            return False        # remote replica: crash-path resume only
        target = self._route({h.rid})
        if target is None or not hasattr(target.engine,
                                         "import_request_kv"):
            return False
        try:
            blob = src.export_request_kv(g.req.request_id)
        except (KeyError, ValueError):
            return False        # queued/mid-prefill or speculative slot
        # The export released the source slot WITHOUT the engine's
        # terminal path (no completion record), and the later
        # cancel(..., "migrated") in _evacuate is a no-op on a request
        # the engine no longer holds — so the migrated-away terminal
        # reason is recorded here, once per successful export, whether
        # the shipped import below lands or _migrate resubmits.
        self.stats.record_completion(latency_s=self._clock() - g.t_submit,
                                     n_tokens=0, reason="migrated")
        sreq = dataclasses.replace(g.req, migrated_from=h.rid,
                                   _finished=False, _requeued=False)
        sh = _Shadow(target.rid, sreq)
        sreq.on_token = (lambda tok, g=g, sh=sh:
                         self._on_shadow_token(g, sh, tok))
        sreq.on_finish = (lambda reason, g=g, sh=sh:
                          self._on_shadow_finish(g, sh, reason))
        try:
            if not target.engine.can_import(blob):
                raise EngineDraining("target cannot adopt")
            target.engine.import_request_kv(blob, request=sreq)
        except (EngineDraining, ValueError, RuntimeError):
            # The exported slot is gone either way — the blob is host
            # memory only, so dropping it leaks nothing, and _migrate
            # resumes from g.emitted through normal admission.
            return False
        g.shadows[target.rid] = sh
        g.winner = sh           # continues the client cursor
        g.t_dispatch = self._clock()
        g.migrations += 1
        self.stats.record_gateway_migration()
        if self.logger is not None:
            self.logger.emit("gateway_migrated",
                             request_id=g.req.request_id,
                             from_replica=h.rid, to_replica=target.rid,
                             tokens_emitted=len(g.emitted),
                             shipped_pages=int(blob["n_pages"]))
        return True

    def _migrate(self, g: _GwRequest, *, from_rid: str) -> None:
        """Resubmit one client request elsewhere as prompt + cursor.
        A surviving hedge shadow makes migration unnecessary; no healthy
        target makes it impossible (client sees "aborted" — once)."""
        if g.finished:
            return
        if any(sh.alive for sh in g.shadows.values()):
            return       # hedge peer still carries this request
        if (self.max_migrations is not None
                and g.migrations >= self.max_migrations):
            # Poison quarantine: this request has already burned its
            # migration budget — the replicas it lands on keep dying
            # under it. Terminal "poisoned" (exactly once, same latch as
            # every other reason) instead of another lap of the fleet.
            self.stats.record_gateway_poisoned()
            if self.logger is not None:
                self.logger.emit("gateway_poisoned",
                                 request_id=g.req.request_id,
                                 migrations=g.migrations,
                                 from_replica=from_rid,
                                 tokens_emitted=len(g.emitted))
            self._finish_client(g, "poisoned")
            return
        exclude = {from_rid}
        while True:
            target = self._route(exclude)
            if target is None:
                self._finish_client(g, "aborted")
                return
            try:
                self._dispatch(g, target, requeue=True,
                               migrated_from=from_rid)
                break
            except (QueueFull, EngineDraining):
                exclude.add(target.rid)
        g.migrations += 1
        self.stats.record_gateway_migration()
        if self.logger is not None:
            self.logger.emit("gateway_migrated",
                             request_id=g.req.request_id,
                             from_replica=from_rid,
                             to_replica=target.rid,
                             tokens_emitted=len(g.emitted))

    # ------------------------------------------------------------ hedging

    def _maybe_hedge(self, now: float) -> None:
        """One bounded duplicate dispatch for requests still waiting on
        their FIRST token ``hedge_after_s`` after (re)dispatch. Never
        hedges a started stream — the emitted cursor must stay the single
        source of truth, and a post-first-token straggler is breaker
        territory."""
        if self.hedge_after_s is None:
            return
        for g in list(self._live.values()):
            if (g.finished or g.emitted or g.winner is not None
                    or g.hedges >= self.max_hedges
                    or now - g.t_dispatch < self.hedge_after_s):
                continue
            alive = {sh.rid for sh in g.shadows.values() if sh.alive}
            if not alive:
                continue               # mid-migration edge; next step
            target = self._route(alive)
            if target is None:
                continue
            try:
                self._dispatch(g, target)
            except (QueueFull, EngineDraining):
                continue
            g.hedges += 1
            self.stats.record_gateway_hedge()
