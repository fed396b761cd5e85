"""graftstorm: a deterministic chaos soak over the serving stack.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
storm.py``, over the port's engines: sustained open-loop traffic against
the whole in-process topology while a seeded randomized fault schedule
fires, with system-wide invariants checked as it runs. A failure replays
from its seed.

Three pieces, one seed:

- **Traffic** (:func:`generate_traffic`): open-loop arrivals (Poisson a
  step), a tenant mix, prompt- and output-length and prefix-sharing
  draws, all from ``random.Random(seed)``: the JAX package's workload,
  request for request.
- **Schedule** (:func:`build_fault_plan`): probabilistic ``p`` faults
  (``faults/plan.py``) over the topology's live sites, their parameters
  drawn from the same seed; the plan's ``seed`` makes the injector's
  per-fault streams replay the same firing sequence.
- **Invariants** (:class:`InvariantMonitor`): request conservation
  (every submitted request reaches exactly one terminal state,
  ``on_finish`` exactly once), no KV page held after the drain, token
  parity against an unfaulted oracle for the deterministic (greedy)
  requests, counter/event coherence, and bounded queue and slot
  accounting, checked every few steps and at teardown.

Every timing decision runs on a :class:`VirtualClock` that moves a fixed
``dt`` a harness step (breaker probes, stall faults), so a soak is a pure
function of (seed, config). Topologies: a :class:`ServeGateway` over N
decode replicas, with ``autoscale=True`` a :class:`FleetController`
over it (``serve/autoscale.py``: scale-up, drain-backed scale-down and the
``autoscale_actuate`` fault site under fire), or with ``prefill > 0`` a
:class:`DisaggCoordinator` with in-process prefill workers (KV page
shipping under fire). ``--metrics-port`` serves the storm gauges
(``telemetry/bridge.py`` ``storm_collector``) while the soak runs. Engines
come from a factory::

    python -m k8s_distributed_deeplearning_torch.serve.storm --device cpu \
        --steps 48 --max-seq-len 128
"""
from __future__ import annotations

__all__ = ["StormConfig", "StormReport", "InvariantMonitor",
           "VirtualClock", "generate_traffic", "build_fault_plan",
           "run_storm", "main"]

import argparse
import dataclasses
import json
import random
import sys
from collections import deque
from typing import Callable, Sequence

from k8s_distributed_deeplearning_torch.faults import inject as _inject
from k8s_distributed_deeplearning_torch.faults.plan import Fault, FaultPlan
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, RequestOutput, SamplingParams)


class VirtualClock:
    """Deterministic time for the soak: a float that only moves when the
    harness says so. ``now`` is the injectable ``clock=`` callable and
    ``sleep`` the injectable ``sleep=`` — a stall fault "sleeps" by
    advancing virtual time, so a 300-virtual-second outage costs zero
    wall-clock and replays exactly."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    __call__ = now

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    sleep = advance


@dataclasses.dataclass
class StormConfig:
    """One soak, fully determined by these fields + the engine factory.

    ``steps`` is the chaos window (faults active, arrivals flowing);
    after it the schedule deactivates and the harness drains — a fleet
    that cannot quiesce within ``drain_steps`` more is itself an
    invariant violation. ``arrival_rate`` is the open-loop mean arrivals
    per step (Poisson); back-pressured submissions retry in order, they
    are never dropped. ``fault_rate`` bounds the per-visit probability
    drawn for each scheduled fault."""

    seed: int = 0
    steps: int = 120
    drain_steps: int = 4000
    replicas: int = 2
    dt: float = 0.05                  # virtual seconds per harness step
    arrival_rate: float = 1.0
    tenant_mix: tuple[tuple[str, float], ...] = (
        ("default", 0.5), ("tenant-a", 0.3), ("tenant-b", 0.2))
    prompt_len: tuple[int, int] = (4, 24)
    out_len: tuple[int, int] = (4, 16)
    shared_prefix_rate: float = 0.25
    shared_prefix_len: int = 8
    sampled_fraction: float = 0.0     # sampled requests skip the parity set
    temperature: float = 0.8          # for the sampled fraction
    vocab: int = 32000
    fault_rate: tuple[float, float] = (0.05, 0.25)
    faults_per_site: int = 2
    fault_sites: tuple[str, ...] | None = None   # None = per-topology set
    max_migrations: int = 8
    failures_to_trip: int = 3
    autoscale: bool = False
    autoscale_min: int = 1
    autoscale_max: int = 3
    prefill: int = 0                  # >0: DisaggCoordinator front
    oracle: bool = True
    check_every: int = 8
    max_queue: int = 256              # per-tenant engine queue bound

    def global_queue_bound(self) -> int:
        """What the monitor's queue-depth invariant compares against.
        The engine's ``max_queue`` bounds EACH tenant's queue (engine.py
        admission contract), so the largest depth a healthy engine can
        legitimately reach is one full queue per tenant in the mix —
        anything beyond that means admission stopped enforcing its
        bound."""
        return self.max_queue * max(1, len(self.tenant_mix))

    def tenant_configs(self):
        """The :class:`TenantConfig` list an engine factory must register
        so the traffic's tenant mix is admissible (an unknown tenant is a
        submit-time ValueError, not a chaos outcome)."""
        from k8s_distributed_deeplearning_torch.serve.sched.tenant import (
            TenantConfig)
        return [TenantConfig(tenant_id=t, weight=max(w, 0.01))
                for t, w in self.tenant_mix]

    def repro(self) -> str:
        """The minimal replay line — attached to every violation."""
        bits = [f"--seed {self.seed}", f"--steps {self.steps}",
                f"--replicas {self.replicas}",
                f"--arrival-rate {self.arrival_rate}"]
        if self.autoscale:
            bits.append(f"--autoscale --autoscale-max {self.autoscale_max}")
        if self.prefill:
            bits.append(f"--prefill {self.prefill}")
        return ("python -m k8s_distributed_deeplearning_torch.serve.storm "
                + " ".join(bits))


# Actions a soak can survive in-process, per site. exit/sigterm kill the
# harness process itself and partition/drop only make sense where a
# retry layer exists — this table is the SAFE intersection of
# faults/plan.py's _SITE_ACTIONS, not a replacement for it.
_SOAK_ACTIONS = {
    "gateway_dispatch": ("ioerror", "stall"),
    "serve_decode": ("stall",),
    "autoscale_actuate": ("ioerror", "stall"),
    "transport_pages": ("ioerror", "drop", "stall"),
    "transport_send": ("ioerror", "drop", "stall"),
    "transport_recv": ("ioerror", "drop", "stall"),
}


def default_sites(cfg: StormConfig) -> tuple[str, ...]:
    """The fault sites the configured topology actually visits — a
    scheduled fault at a never-visited site would vacuously pass the
    distinct-sites gate."""
    if cfg.prefill > 0:
        sites = ["serve_decode", "transport_pages"]
    else:
        sites = ["gateway_dispatch", "serve_decode"]
        if cfg.autoscale:
            sites.append("autoscale_actuate")
    return tuple(sites)


def generate_traffic(cfg: StormConfig) -> list[dict]:
    """The open-loop workload: a list of request *specs* (plain dicts —
    fresh :class:`Request` objects are built per run, so the oracle and
    the storm run never share callback state). Deterministic in
    ``cfg.seed``."""
    rng = random.Random(cfg.seed)
    prefix = [rng.randrange(cfg.vocab)
              for _ in range(cfg.shared_prefix_len)]
    tenants = [t for t, _ in cfg.tenant_mix]
    weights = [w for _, w in cfg.tenant_mix]
    specs: list[dict] = []
    for step in range(cfg.steps):
        # Poisson(rate) via inverse-CDF walk on one uniform draw per
        # arrival count — Knuth's method, deterministic under the rng.
        n, threshold, acc = 0, 2.718281828459045 ** -cfg.arrival_rate, 1.0
        while True:
            acc *= rng.random()
            if acc <= threshold:
                break
            n += 1
        for _ in range(n):
            plen = rng.randint(*cfg.prompt_len)
            shared = rng.random() < cfg.shared_prefix_rate
            prompt = (list(prefix) if shared else []) + [
                rng.randrange(cfg.vocab) for _ in range(plen)]
            sampled = rng.random() < cfg.sampled_fraction
            specs.append({
                "widx": len(specs),
                "step": step,
                "prompt": prompt,
                "max_new_tokens": rng.randint(*cfg.out_len),
                "tenant": rng.choices(tenants, weights=weights)[0],
                "deterministic": not sampled,
                "temperature": cfg.temperature if sampled else 0.0,
                "seed": rng.randrange(2 ** 31),
            })
    return specs


def build_fault_plan(cfg: StormConfig,
                     sites: Sequence[str] | None = None) -> FaultPlan:
    """Compose the seeded randomized schedule: ``faults_per_site``
    probabilistic faults per live site, action/probability/window drawn
    from the seed. Low-visit sites (the controller actuates a handful of
    times per soak, not thousands) draw from the upper half of the rate
    range so the schedule exercises them rather than lottery-ticketing
    them."""
    rng = random.Random((cfg.seed << 16) ^ 0x57042)
    sites = tuple(sites) if sites is not None else (
        cfg.fault_sites or default_sites(cfg))
    lo, hi = cfg.fault_rate
    faults = []
    for site in sites:
        actions = _SOAK_ACTIONS[site]
        for _ in range(max(1, cfg.faults_per_site)):
            action = rng.choice(actions)
            p_lo = lo if site != "autoscale_actuate" else max(lo, 0.5)
            p_hi = hi if site != "autoscale_actuate" else max(hi, 0.9)
            faults.append(Fault(
                site=site, action=action,
                p=round(rng.uniform(p_lo, p_hi), 4),
                after=rng.randint(0, 8),
                count=rng.randint(2, 6),
                seconds=(round(rng.uniform(cfg.dt, 4 * cfg.dt), 4)
                         if action == "stall" else 0.0)))
    return FaultPlan(faults=tuple(faults),
                     seed=cfg.seed).validate_or_raise()


class _EventCounter:
    """MetricsLogger shim counting event names on the way through — the
    coherence invariant compares these counts against the stats
    counters. Forwards to a real logger when one is wired."""

    def __init__(self, inner=None):
        self.inner = inner
        self.counts: dict[str, int] = {}
        self.enabled = True

    def emit(self, event: str, **fields) -> None:
        self.counts[event] = self.counts.get(event, 0) + 1
        if self.inner is not None:
            self.inner.emit(event, **fields)


class InvariantMonitor:
    """The soak's referee: wraps every request's callbacks, watches every
    output, and checks the system-wide invariants live and at teardown.

    Violations accumulate as dicts ``{kind, detail, step}`` — bounded by
    deduplication on (kind, detail), so a persistent leak is one entry,
    not one per check. ``flight`` (optional) gets a ``dump`` per NEW
    violation kind: the postmortem must capture state at first detection,
    not after the drain rewrote it."""

    def __init__(self, *, oracle: dict[int, list[int]] | None = None,
                 repro: str = "", logger=None, flight=None,
                 max_queue: int | None = None):
        self.oracle = oracle
        self.repro = repro
        self.logger = logger
        self.flight = flight
        self.max_queue = max_queue
        self.violations: list[dict] = []
        self._seen: set[tuple[str, str]] = set()
        self._reqs: dict[str, dict] = {}     # request_id -> record
        self._finished = 0
        self.finish_reasons: dict[str, int] = {}
        self.peak_in_flight = 0
        self.step = 0

    # ------------------------------------------------------------ intake

    def wrap_request(self, req: Request, *, widx: int,
                     deterministic: bool) -> Request:
        """Interpose on ``on_token``/``on_finish``: the monitor is the
        client, so the exactly-once and stream-integrity contracts are
        checked at the same surface a real caller would observe."""
        rec = {"widx": widx, "deterministic": deterministic,
               "tokens": [], "finishes": 0, "outputs": 0, "reason": None}
        self._reqs[req.request_id] = rec

        def on_token(tok: int) -> None:
            if rec["finishes"]:
                self.violation("token_after_finish",
                               f"widx={widx} got a token after on_finish")
            rec["tokens"].append(int(tok))

        def on_finish(reason: str) -> None:
            rec["finishes"] += 1
            if rec["finishes"] > 1:
                self.violation("duplicate_finish",
                               f"widx={widx} on_finish fired "
                               f"{rec['finishes']} times")
                return
            rec["reason"] = reason
            self._finished += 1
            self.finish_reasons[reason] = \
                self.finish_reasons.get(reason, 0) + 1

        req.on_token = on_token
        req.on_finish = on_finish
        return req

    def on_output(self, out: RequestOutput) -> None:
        rec = self._reqs.get(out.request_id)
        if rec is None:
            self.violation("unknown_output",
                           f"terminal output for a request never "
                           f"submitted: {out.request_id}")
            return
        rec["outputs"] += 1
        if rec["outputs"] > 1:
            self.violation("duplicate_output",
                           f"widx={rec['widx']} surfaced "
                           f"{rec['outputs']} terminal outputs")
        if rec["reason"] is not None and out.finish_reason != rec["reason"]:
            self.violation("reason_divergence",
                           f"widx={rec['widx']} on_finish said "
                           f"{rec['reason']!r}, output says "
                           f"{out.finish_reason!r}")
        if list(out.tokens) != rec["tokens"]:
            self.violation("stream_output_divergence",
                           f"widx={rec['widx']} streamed "
                           f"{len(rec['tokens'])} tokens but the output "
                           f"carries {len(out.tokens)}")

    # ------------------------------------------------------------- live

    def submitted_total(self) -> int:
        return len(self._reqs)

    def in_flight(self) -> int:
        return len(self._reqs) - self._finished

    def check_step(self, engines: Sequence[object]) -> None:
        """Bounded queue/slot/pool accounting on the live fleet."""
        self.peak_in_flight = max(self.peak_in_flight, self.in_flight())
        for e in engines:
            rid = getattr(e, "replica_id", None) or "?"
            slots = getattr(e, "num_slots", None)
            occupied = getattr(e, "occupied_slots", None)
            if callable(occupied):
                occupied = occupied()
            if slots is not None and occupied is not None \
                    and occupied > slots:
                self.violation("slot_overflow",
                               f"replica {rid}: {occupied} occupied "
                               f"slots > num_slots {slots}")
            q = getattr(e, "queue", None)
            if q is not None and self.max_queue is not None \
                    and len(q) > self.max_queue:
                self.violation("queue_overflow",
                               f"replica {rid}: queue depth {len(q)} > "
                               f"bound {self.max_queue}")
            pool = getattr(e, "pool", None)
            counters = getattr(pool, "counters", None)
            if counters is not None:
                c = counters()
                if c["pages_used"] > c["pages_total"] \
                        or c["pages_used"] < 0 \
                        or c.get("pages_reserved", 0) < 0:
                    self.violation("pool_accounting",
                                   f"replica {rid}: incoherent pool "
                                   f"counters {c}")

    # ---------------------------------------------------------- teardown

    def finalize(self, engines: Sequence[object], *, stats=None,
                 events: dict[str, int] | None = None) -> None:
        """The exhaustive post-drain sweep: conservation, leaks, parity,
        coherence. Call AFTER the fleet is shut down."""
        for rid, rec in self._reqs.items():
            if rec["finishes"] == 0:
                self.violation("lost_request",
                               f"widx={rec['widx']} ({rid}) never "
                               "reached a terminal state")
            if rec["outputs"] == 0 and rec["finishes"]:
                self.violation("missing_output",
                               f"widx={rec['widx']} finished "
                               f"({rec['reason']}) but never surfaced a "
                               "terminal RequestOutput")
            if (self.oracle is not None and rec["deterministic"]
                    and rec["reason"] in ("eos", "length")):
                want = self.oracle.get(rec["widx"])
                if want is not None and rec["tokens"] != want:
                    self.violation("token_parity",
                                   f"widx={rec['widx']} diverged from "
                                   f"the unfaulted oracle at token "
                                   f"{_first_diff(rec['tokens'], want)}")
        for e in engines:
            rid = getattr(e, "replica_id", None) or "?"
            pool = getattr(e, "pool", None)
            counters = getattr(pool, "counters", None)
            if counters is None:
                continue
            c = counters()
            if c["pages_used"] != 0 or c.get("pages_reserved", 0) != 0:
                owners = getattr(pool, "owners_summary", None)
                detail = (f"replica {rid}: pages_used={c['pages_used']} "
                          f"pages_reserved={c['pages_reserved']} "
                          "after drain")
                if owners is not None:
                    detail += f" owners={owners()}"
                self.violation("kv_page_leak", detail)
        if stats is not None and events is not None:
            migrations = events.get("gateway_migrated", 0)
            if stats.gateway_migrations != migrations:
                self.violation("counter_event_divergence",
                               f"stats.gateway_migrations="
                               f"{stats.gateway_migrations} != "
                               f"gateway_migrated events {migrations}")
            poisoned = events.get("gateway_poisoned", 0)
            if stats.gateway_poisoned != poisoned:
                self.violation("counter_event_divergence",
                               f"stats.gateway_poisoned="
                               f"{stats.gateway_poisoned} != "
                               f"gateway_poisoned events {poisoned}")
            if stats.gateway_poisoned != \
                    self.finish_reasons.get("poisoned", 0):
                self.violation("counter_event_divergence",
                               f"stats.gateway_poisoned="
                               f"{stats.gateway_poisoned} != 'poisoned' "
                               f"finishes "
                               f"{self.finish_reasons.get('poisoned', 0)}")
            if stats.transport_dedup_hits > stats.transport_retries:
                self.violation("counter_event_divergence",
                               f"dedup hits {stats.transport_dedup_hits} "
                               f"> retries {stats.transport_retries} — a "
                               "dedup without a retry is a phantom "
                               "submission")

    # ---------------------------------------------------------- plumbing

    def violation(self, kind: str, detail: str) -> None:
        if (kind, detail) in self._seen:
            return
        self._seen.add((kind, detail))
        self.violations.append({"kind": kind, "detail": detail,
                                "step": self.step})
        if self.logger is not None:
            self.logger.emit("storm_invariant_violation", kind=kind,
                             detail=detail, step=self.step,
                             repro=self.repro)
        if self.flight is not None:
            # The postmortem: dump at FIRST detection, while the state
            # that broke the invariant is still in the ring.
            try:
                self.flight.dump("storm_invariant",
                                 extra={"kind": kind, "detail": detail,
                                        "repro": self.repro})
            except Exception:   # noqa: BLE001 — forensics never masks
                pass


def _first_diff(a: list[int], b: list[int]) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"{i} ({x} != {y})"
    return f"len {len(a)} != {len(b)}"


@dataclasses.dataclass
class StormReport:
    """What a soak returns — deliberately wall-clock-free, so two
    same-seed runs produce byte-identical reports (the replay gate
    compares ``to_dict()`` directly)."""

    seed: int
    steps_run: int
    submitted: int
    finished: int
    finish_reasons: dict[str, int]
    fired: list[tuple[str, str]]
    distinct_sites: list[str]
    peak_in_flight: int
    peak_load_frac: float
    migrations: int
    poisoned: int
    violations: list[dict]
    parity_checked: int
    plan_json: str
    repro: str

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fired"] = [list(x) for x in self.fired]
        return d

    @property
    def ok(self) -> bool:
        return not self.violations


def run_storm(cfg: StormConfig, *,
              make_engine: Callable[[int], object],
              make_prefill_engine: Callable[[int], object] | None = None,
              plan: FaultPlan | None = None,
              logger=None, flight=None,
              on_monitor: Callable[[object, object], None] | None = None,
              ) -> StormReport:
    """Run one soak: oracle pass (unfaulted, ``make_engine(-1)``), chaos
    window, drain, teardown sweep. ``make_engine(i)`` builds decode
    replica *i* and ``make_prefill_engine(i)`` a ``prefill_only`` engine
    (topology ``prefill > 0``); every engine built is leak-checked at
    teardown. ``on_monitor(monitor, injector)`` is called once the live
    monitor and fault injector exist."""
    specs = generate_traffic(cfg)
    events = _EventCounter(logger)

    # -- oracle: the same workload, no faults, one fresh engine ----------
    oracle: dict[int, list[int]] | None = None
    if cfg.oracle:
        eng = make_engine(-1)
        reqs = []
        by_rid: dict[str, int] = {}
        for s in specs:
            r = _make_request(s)
            by_rid[r.request_id] = s["widx"]
            reqs.append(r)
        oracle = {}
        for out in eng.run(reqs):
            if out.finish_reason in ("eos", "length"):
                oracle[by_rid[out.request_id]] = list(out.tokens)
        eng.shutdown()

    # -- topology --------------------------------------------------------
    clock = VirtualClock()
    all_engines: list = []

    def _decode(i: int):
        e = make_engine(i)
        all_engines.append(e)
        return e

    if plan is None:
        plan = build_fault_plan(cfg)
    monitor = InvariantMonitor(oracle=oracle, repro=cfg.repro(),
                               logger=events, flight=flight,
                               max_queue=cfg.global_queue_bound())
    from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats
    stats = ServingStats()
    controller = None
    prefill_workers: list = []
    if cfg.prefill > 0:
        from k8s_distributed_deeplearning_torch.serve.disagg import (
            DisaggCoordinator, PrefillWorker)
        mk_pre = make_prefill_engine or make_engine
        for i in range(cfg.prefill):
            e = mk_pre(cfg.replicas + i)
            all_engines.append(e)
            prefill_workers.append(PrefillWorker(e))
        front = DisaggCoordinator(
            [_decode(i) for i in range(cfg.replicas)], prefill_workers,
            stats=stats, logger=events, clock=clock.now)
    else:
        from k8s_distributed_deeplearning_torch.serve.gateway import (
            ServeGateway)
        front = ServeGateway(
            [_decode(i) for i in range(cfg.replicas)],
            stats=stats, logger=events, clock=clock.now, flight=flight,
            max_migrations=cfg.max_migrations,
            failures_to_trip=cfg.failures_to_trip,
            probe_backoff_s=4 * cfg.dt,
            max_probe_backoff_s=64 * cfg.dt)
        if cfg.autoscale:
            from k8s_distributed_deeplearning_torch.serve.autoscale import (
                EngineFactoryBackend, FleetController)
            controller = FleetController(
                front, EngineFactoryBackend(
                    lambda: _decode(len(all_engines))),
                min_replicas=cfg.autoscale_min,
                max_replicas=cfg.autoscale_max,
                interval_s=4 * cfg.dt,
                up_cooldown_s=8 * cfg.dt, down_cooldown_s=32 * cfg.dt,
                sustain_rounds=2, load_high=1.2, load_low=0.1,
                logger=events, clock=clock.now)

    # -- chaos window + drain -------------------------------------------
    inj = _inject.activate(plan, sleep=clock.sleep, clock=clock.now)
    if on_monitor is not None:
        on_monitor(monitor, inj)
    fired: list[tuple[str, str]] = []
    slot_capacity = peak_load = 0.0
    pending = deque(specs)
    backlog: deque[Request] = deque()
    step_i = 0
    try:
        while True:
            draining = step_i >= cfg.steps
            if draining and not backlog and not pending \
                    and not front.busy():
                break
            if step_i >= cfg.steps + cfg.drain_steps:
                monitor.violation(
                    "failed_to_quiesce",
                    f"fleet still busy {cfg.drain_steps} steps after "
                    "the chaos window closed")
                break
            if draining and inj is not None:
                # Chaos stops at the window edge; the drain must succeed
                # CLEAN — a fleet that only quiesces while lucky is not
                # drained, it is stuck.
                fired = list(inj.fired)
                _inject.deactivate()
                inj = None
            monitor.step = step_i
            clock.advance(cfg.dt)
            while pending and pending[0]["step"] <= step_i:
                backlog.append(_make_request(pending.popleft(),
                                             monitor=monitor))
            while backlog:
                try:
                    front.submit(backlog[0])
                except (QueueFull, EngineDraining):
                    break          # back-pressure: keep order, retry
                backlog.popleft()
            for out in front.step():
                monitor.on_output(out)
            if controller is not None:
                controller.maybe_round(clock.now())
            live = [e for e in all_engines]
            occupied = slots = 0
            for e in live:
                n = getattr(e, "num_slots", None)
                o = getattr(e, "occupied_slots", None)
                if callable(o):
                    o = o()
                if n and o is not None:
                    slots += int(n)
                    occupied += int(o)
            if slots:
                slot_capacity = max(slot_capacity, float(slots))
                peak_load = max(peak_load, occupied / slots)
            if step_i % max(1, cfg.check_every) == 0:
                monitor.check_step(live)
            step_i += 1
    finally:
        if inj is not None:
            fired = list(inj.fired)
            _inject.deactivate()

    # -- teardown + exhaustive sweep ------------------------------------
    shutdown = getattr(front, "shutdown", None)
    if shutdown is not None:
        shutdown()
    for e in all_engines:
        sd = getattr(e, "shutdown", None)
        if sd is not None:
            sd()
    monitor.check_step(all_engines)
    monitor.finalize(all_engines, stats=stats, events=events.counts)

    parity_checked = sum(
        1 for rec in monitor._reqs.values()
        if oracle is not None and rec["deterministic"]
        and rec["reason"] in ("eos", "length")
        and rec["widx"] in oracle)
    report = StormReport(
        seed=cfg.seed, steps_run=step_i,
        submitted=monitor.submitted_total(),
        finished=monitor._finished,
        finish_reasons=dict(sorted(monitor.finish_reasons.items())),
        fired=fired,
        distinct_sites=sorted({s for s, _ in fired}),
        peak_in_flight=monitor.peak_in_flight,
        peak_load_frac=round(peak_load, 4),
        migrations=stats.gateway_migrations,
        poisoned=stats.gateway_poisoned,
        violations=list(monitor.violations),
        parity_checked=parity_checked,
        plan_json=plan.to_json(),
        repro=cfg.repro())
    events.emit("storm_summary", seed=cfg.seed, steps=step_i,
                submitted=report.submitted, finished=report.finished,
                finish_reasons=report.finish_reasons,
                faults_fired=len(fired),
                distinct_sites=report.distinct_sites,
                peak_load_frac=report.peak_load_frac,
                violations=len(report.violations), repro=report.repro)
    return report


def _make_request(spec: dict, monitor: InvariantMonitor | None = None
                  ) -> Request:
    req = Request(
        prompt=list(spec["prompt"]),
        max_new_tokens=spec["max_new_tokens"],
        sampling=SamplingParams(temperature=spec["temperature"]),
        tenant=spec["tenant"],
        seed=spec["seed"])
    if monitor is not None:
        monitor.wrap_request(req, widx=spec["widx"],
                             deterministic=spec["deterministic"])
    return req


# ------------------------------------------------------------------ CLI


def main(argv: list[str] | None = None) -> int:
    """The soak as a job over the port's engines. The flags mirror
    :class:`StormConfig` and the JAX package's ``launch storm``; models
    are built after the flags are checked. Runs on the GPU unless
    ``--device cpu`` is given."""
    ap = argparse.ArgumentParser(
        prog="python -m k8s_distributed_deeplearning_torch.serve.storm",
        description="deterministic chaos soak over the serving stack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=120,
                    help="chaos-window harness steps")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small"])
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--arrival-rate", type=float, default=1.0)
    ap.add_argument("--fault-rate", type=float, nargs=2,
                    default=(0.05, 0.25), metavar=("LO", "HI"))
    ap.add_argument("--max-migrations", type=int, default=8)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--autoscale-max", type=int, default=3)
    ap.add_argument("--prefill", type=int, default=0,
                    help="prefill workers (>0 swaps in the disagg front)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics with the storm gauges while "
                         "the soak runs")
    ap.add_argument("--report-json", default=None,
                    help="write the StormReport as JSON to this path")
    ap.add_argument("--flight-ring", type=int, default=0)
    ap.add_argument("--flight-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error(f"--steps must be >= 1, got {args.steps}")
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.seed < 0:
        ap.error(f"--seed must be >= 0, got {args.seed}")
    if args.autoscale and args.prefill:
        ap.error("--autoscale and --prefill are mutually exclusive "
                 "(the disagg coordinator replaces the gateway the "
                 "controller actuates through)")
    import torch

    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve.engine import ServeEngine
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger)

    cfg = StormConfig(
        seed=args.seed, steps=args.steps, replicas=args.replicas,
        arrival_rate=args.arrival_rate,
        fault_rate=tuple(args.fault_rate),
        max_migrations=args.max_migrations,
        autoscale=args.autoscale, autoscale_max=args.autoscale_max,
        prefill=args.prefill,
        prompt_len=(4, min(24, args.max_seq_len // 4)),
        out_len=(4, min(16, args.max_seq_len // 4)))
    if args.preset == "small":
        mcfg = llama.config_tiny(
            vocab_size=32000, dim=768, n_layers=12, n_heads=12,
            n_kv_heads=4, mlp_dim=2048, max_seq_len=args.max_seq_len,
            dtype=torch.bfloat16)
    else:
        mcfg = llama.config_tiny(max_seq_len=args.max_seq_len,
                                 dtype=torch.float32)
    # One model, its weights held once, shared by every engine.
    model = llama.LlamaLM(mcfg, device=args.device, seed=args.seed)
    logger = MetricsLogger(job="storm")
    flight = None
    if args.flight_ring:
        from k8s_distributed_deeplearning_torch.telemetry.flight import (
            FlightRecorder)
        flight = FlightRecorder(args.flight_ring, dump_dir=args.flight_dir,
                                logger=logger, job="storm")

    def make_engine(i: int):
        return ServeEngine(model, num_slots=args.slots,
                           max_queue=cfg.max_queue,
                           tenants=cfg.tenant_configs(),
                           replica_id=f"s{i}" if i >= 0 else "oracle",
                           flight=flight, device=args.device)

    def make_prefill_engine(i: int):
        return ServeEngine(model, num_slots=args.slots,
                           max_queue=cfg.max_queue,
                           tenants=cfg.tenant_configs(),
                           replica_id=f"p{i}", prefill_only=True,
                           flight=flight, device=args.device)

    cfg = dataclasses.replace(cfg, vocab=mcfg.vocab_size)
    server = None
    on_monitor = None
    if args.metrics_port is not None:
        # Live observability for a long soak: the storm gauges behind
        # /metrics, the same exporter the serving CLI uses.
        from k8s_distributed_deeplearning_torch.telemetry import bridge
        from k8s_distributed_deeplearning_torch.telemetry.exporter import (
            MetricsExporter)
        from k8s_distributed_deeplearning_torch.telemetry.registry import (
            MetricsRegistry)
        registry = MetricsRegistry()
        monitor_box: list = []
        inj_box: list = []

        class _Lazy:
            """The monitor exists only inside run_storm: the collector's
            reads go through this late-bound box (filled by run_storm's
            on_monitor hook once the soak starts)."""
            violations = property(
                lambda self: monitor_box[0].violations
                if monitor_box else [])

            def in_flight(self):
                return monitor_box[0].in_flight() if monitor_box else 0

            def submitted_total(self):
                return (monitor_box[0].submitted_total()
                        if monitor_box else 0)

        class _LazyInj:
            fired = property(
                lambda self: inj_box[0].fired if inj_box else [])

        on_monitor = (lambda mon, inj:
                      (monitor_box.append(mon), inj_box.append(inj)))
        bridge.storm_collector(registry, _Lazy(), injector=_LazyInj())
        server = MetricsExporter(registry, port=args.metrics_port,
                                 flight=flight).start()
    try:
        report = run_storm(cfg, make_engine=make_engine,
                           make_prefill_engine=make_prefill_engine,
                           logger=logger, flight=flight,
                           on_monitor=on_monitor)
    finally:
        if server is not None:
            server.stop()
    doc = report.to_dict()
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(doc, f, indent=2)
    print(json.dumps({"seed": report.seed,
                      "submitted": report.submitted,
                      "finished": report.finished,
                      "finish_reasons": report.finish_reasons,
                      "faults_fired": len(report.fired),
                      "distinct_sites": report.distinct_sites,
                      "peak_load_frac": report.peak_load_frac,
                      "parity_checked": report.parity_checked,
                      "violations": report.violations,
                      "repro": report.repro}, indent=2))
    if report.violations:
        print(f"storm: {len(report.violations)} invariant violation(s) — "
              f"replay: {report.repro}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
