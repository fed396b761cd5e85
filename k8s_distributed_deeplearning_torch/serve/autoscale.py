"""graftpilot: SLO-driven elastic fleet controller — scale up on burn,
drain-safe scale down, replace sick replicas, and BROWNOUT at max scale.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
autoscale.py``: the same decisions, decision records, ``snapshot()`` keys
and events, over the port's gateway, engines and wire clients.

The fleet plane *observes* (telemetry/fleet.py health scores, slo.py
burn rates) and the gateway *reacts* (breakers, migration, drain) — but
nothing in the tree decides how many replicas should exist. This module
is that decider: a clock-injectable control loop over the gateway's
dynamic membership (:meth:`serve.gateway.ServeGateway.add_replica` /
``remove_replica``) that drives the replica set toward its SLO.

Decisions (each gated by hysteresis + per-direction cooldowns + a flap
damper, so a noisy signal cannot thrash the fleet):

- **up** — the interactive fast-window burn rate crossed its threshold,
  or fleet load (queued + in-flight per slot) is sustained above
  ``load_high``. Actuation: ``backend.start_replica()`` then
  ``gateway.add_replica`` — breakers and health state are created at
  runtime, and the next ``submit()`` can route to the newcomer.
- **down** — the fleet is sustained-idle (load below ``load_low``, no
  burn). Actuation: :meth:`ServeGateway.drain_replica` on the victim
  (migration-backed — every queued and in-flight request moves to a
  peer with its emitted-token cursor, zero lost requests), then
  ``remove_replica`` + ``backend.stop_replica`` once it reports
  drained. A victim that CRASHES mid-drain still converges: the
  breaker evacuates it, ``drained`` goes true on the empty engine, and
  the next round finalizes the removal.
- **replace** — a replica whose composite health (the gateway's
  :class:`telemetry.fleet.HealthPolicy` score) stays below
  ``unhealthy_below`` — or whose breaker stays OPEN — for
  ``unhealthy_rounds`` consecutive rounds is drained out and a fresh
  replica is started in its place. Repair, not scaling: it bypasses the
  up/down cooldowns (but has its own) and never changes ``desired``.
- **brownout** — at ``max_replicas`` with burn still climbing, adding
  capacity is off the table, so the controller walks a REVERSIBLE
  degradation ladder instead of letting every tenant burn:
  ``shed_batch`` (batch-class tenants are shed at the gateway door)
  → ``no_hedge`` (prefill hedging off — no duplicate dispatch load)
  → ``tight_admission`` (gateway admission capped at fleet slot
  capacity). Each escalation emits ``autoscale_brownout``; when burn
  clears the ladder unwinds stage by stage and ``autoscale_restored``
  fires as the last stage lifts.

Actuation is pluggable (``backend``):

- :class:`EngineFactoryBackend` — in-process ``ServeEngine`` replicas
  from a factory closure (the CLI's default and the test harness).
- :class:`LocalProcessBackend` — spawn/reap real ``launch serve
  --replica-server`` subprocesses: port-file handshake for the bound
  port, heartbeat-dir advertisement for discovery, a
  :class:`serve.transport.ReplicaClient` handed to the gateway.
- :class:`K8sParallelismBackend` — patch the Indexed replica Job's
  ``parallelism``/``completions`` through the retry-wrapped
  :class:`launch.watch.Kubectl`; membership then arrives asynchronously
  via heartbeat discovery (pass ``discover=`` to the controller).

Chaos surface: the ``autoscale_actuate`` fault site fires before every
backend call (``step`` carries the control-round index), so a plan can
fail actuation with ``ioerror``, stall it, or kill the controller
process mid-actuation; the loop converges anyway, never exceeds
``max_replicas``, and never flaps faster than its cooldowns.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from collections import deque
from typing import Callable, Iterable

from k8s_distributed_deeplearning_torch import faults as _faults

#: The reversible degradation ladder, in escalation order. validate.py
#: checks $TPUJOB_AUTOSCALE_BROWNOUT names against this tuple offline.
BROWNOUT_STAGE_NAMES = ("shed_batch", "no_hedge", "tight_admission")

#: snapshot()/bridge gauge encoding of the last decision.
DECISION_CODES = {"hold": 0, "up": 1, "down": 2, "replace": 3,
                  "brownout": 4, "restore": 5}

#: Exceptions a failed actuation surfaces as — anything else is a bug in
#: the backend, not a fleet condition, and should propagate.
_ACTUATION_ERRORS = (OSError, RuntimeError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class BrownoutStage:
    """One reversible degradation lever: ``apply(gateway)`` engages it,
    ``restore(gateway)`` undoes it exactly."""

    name: str
    apply: Callable
    restore: Callable


def default_brownout_stages(
        names: Iterable[str] = BROWNOUT_STAGE_NAMES
) -> tuple[BrownoutStage, ...]:
    """The standard ladder (or a subset/reorder by *names*):

    - ``shed_batch`` — the gateway sheds submissions from batch-class
      tenants at the door (``gateway.shed_classes``); interactive and
      normal traffic keeps flowing.
    - ``no_hedge`` — prefill hedging off (``gateway.hedge_after_s``):
      under overload a hedge is pure duplicate load.
    - ``tight_admission`` — cap the gateway's live-request count at the
      fleet's slot capacity (``gateway.max_live_requests``): everything
      admitted is being decoded, nothing marinates in a queue past its
      deadline.
    """
    saved: dict = {}

    def _shed_on(gw):
        gw.shed_classes = frozenset({"batch"})

    def _shed_off(gw):
        gw.shed_classes = frozenset()

    def _hedge_off(gw):
        saved["hedge_after_s"] = gw.hedge_after_s
        gw.hedge_after_s = None

    def _hedge_on(gw):
        gw.hedge_after_s = saved.pop("hedge_after_s", None)

    def _tighten(gw):
        slots = 0
        for r in gw.snapshot()["replicas"].values():
            if not r["draining"]:
                slots += int(r.get("slots", 0))
        gw.max_live_requests = max(1, slots)

    def _loosen(gw):
        gw.max_live_requests = None

    stages = {
        "shed_batch": BrownoutStage("shed_batch", _shed_on, _shed_off),
        "no_hedge": BrownoutStage("no_hedge", _hedge_off, _hedge_on),
        "tight_admission": BrownoutStage("tight_admission", _tighten,
                                         _loosen),
    }
    out = []
    for n in names:
        if n not in stages:
            raise ValueError(f"unknown brownout stage {n!r} "
                             f"(known: {BROWNOUT_STAGE_NAMES})")
        out.append(stages[n])
    return tuple(out)


# ------------------------------------------------------------- backends


class EngineFactoryBackend:
    """In-process actuation: every ``start_replica`` builds a fresh
    :class:`serve.engine.ServeEngine` from *factory* (sharing the model/
    params the caller closed over); ``stop_replica`` shuts it down. The
    CLI's default backend and the unit-test harness."""

    def __init__(self, factory: Callable[[], object]):
        self._factory = factory

    def start_replica(self):
        return self._factory()

    def stop_replica(self, rid: str, engine) -> None:
        engine.shutdown()


class LocalProcessBackend:
    """Spawn/reap ``launch serve --replica-server`` subprocesses.

    Handshake: the child binds an ephemeral port (``--metrics-port 0``),
    writes it to ``--port-file``, and advertises its ``metrics_addr``
    through *heartbeat_dir* — the same discovery surface a remote
    gateway scrapes. ``start_replica`` blocks (bounded) on the port
    file, then returns a :class:`serve.transport.ReplicaClient` for
    :meth:`ServeGateway.add_replica`. ``stop_replica`` asks the server
    to shut down over the wire and reaps the child process.
    """

    def __init__(self, heartbeat_dir: str, *,
                 preset: str = "tiny", slots: int = 2,
                 extra_args: Iterable[str] = (),
                 client_kwargs: dict | None = None,
                 python: str = sys.executable,
                 spawn_timeout_s: float = 60.0,
                 sleep: Callable[[float], None] = time.sleep,
                 role: str = "decode"):
        self.heartbeat_dir = heartbeat_dir
        self.preset = preset
        self.slots = slots
        # Spawned servers advertise this role in their beacons; a
        # prefill backend starts prefill-only engines (--role prefill).
        self.role = str(role)
        self.extra_args = tuple(extra_args)
        self.client_kwargs = dict(client_kwargs or {})
        self.python = python
        self.spawn_timeout_s = spawn_timeout_s
        self._sleep = sleep
        self._procs: dict[str, subprocess.Popen] = {}
        os.makedirs(heartbeat_dir, exist_ok=True)
        from k8s_distributed_deeplearning_torch.telemetry import heartbeat
        ranks = [int(r["rank"]) for r in heartbeat.read_heartbeats(
            heartbeat_dir)]
        self._next_rank = max(ranks, default=-1) + 1

    def start_replica(self):
        rank = self._next_rank
        self._next_rank += 1
        port_file = os.path.join(self.heartbeat_dir,
                                 f"autoscale-port-{rank}")
        cmd = [self.python, "-m",
               "k8s_distributed_deeplearning_torch.launch", "serve",
               "--replica-server", "--preset", self.preset,
               "--slots", str(self.slots), "--metrics-port", "0",
               "--port-file", port_file,
               "--heartbeat-dir", self.heartbeat_dir,
               "--replica-rank", str(rank),
               "--role", self.role, *self.extra_args]
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + self.spawn_timeout_s
        port = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise OSError(f"replica-server rank {rank} exited "
                              f"rc={proc.returncode} before handshake")
            try:
                with open(port_file) as f:
                    port = int(f.read().strip())
                break
            except (OSError, ValueError):
                self._sleep(0.05)
        if port is None:
            proc.kill()
            raise TimeoutError(
                f"replica-server rank {rank} did not write {port_file} "
                f"within {self.spawn_timeout_s}s")
        from k8s_distributed_deeplearning_torch.serve.transport import (
            ReplicaClient)
        client = ReplicaClient(f"127.0.0.1:{port}",
                               replica_id=f"r{rank}",
                               **self.client_kwargs)
        self._procs[client.replica_id] = proc
        return client

    def stop_replica(self, rid: str, engine) -> None:
        engine.shutdown()            # /shutdown → server main loop exits
        proc = self._procs.pop(rid, None)
        if proc is None:
            return
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)

    def reap_all(self) -> None:
        """Best-effort teardown of every child (test/CLI cleanup)."""
        for rid in list(self._procs):
            proc = self._procs.pop(rid)
            proc.kill()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass


class K8sParallelismBackend:
    """Patch the Indexed replica Job's ``parallelism``/``completions``
    through the retry-wrapped :class:`launch.watch.Kubectl`.

    Membership can resolve two ways. With *endpoint_template* (a format
    string with an ``{i}`` completion-index placeholder — Indexed-Job
    pod DNS is deterministic), ``start_replica`` returns a
    :class:`serve.transport.ReplicaClient` for the new index
    immediately; the pod races the client, and the gateway's breaker
    probes it into the routing set when it comes up. Without a
    template, ``start_replica`` returns None and membership arrives
    asynchronously — pass :func:`heartbeat_discoverer` as the
    controller's ``discover`` hook. Scale-down removes the HIGHEST
    completion index (the Job controller's semantics), so
    :meth:`victim_rid` steers the controller at that replica."""

    def __init__(self, kubectl, job: str, namespace: str, *,
                 initial_replicas: int = 1,
                 endpoint_template: str | None = None,
                 client_kwargs: dict | None = None):
        self.kubectl = kubectl
        self.job = job
        self.namespace = namespace
        self.endpoint_template = endpoint_template
        self.client_kwargs = dict(client_kwargs or {})
        self._desired = initial_replicas

    def _patch(self, n: int) -> None:
        self.kubectl.patch_job(
            self.job, self.namespace,
            f'{{"spec":{{"parallelism":{n},"completions":{n}}}}}')

    def start_replica(self):
        self._desired += 1
        self._patch(self._desired)
        if self.endpoint_template is None:
            return None              # joins via heartbeat discovery
        index = self._desired - 1
        from k8s_distributed_deeplearning_torch.serve.transport import (
            ReplicaClient)
        return ReplicaClient(self.endpoint_template.format(i=index),
                             replica_id=f"r{index}",
                             **self.client_kwargs)

    def stop_replica(self, rid: str, engine) -> None:
        engine.shutdown()
        self._desired = max(0, self._desired - 1)
        self._patch(self._desired)

    def victim_rid(self, rids: Iterable[str]) -> str | None:
        """Highest completion index — the pod the Job controller reaps
        when parallelism drops (replica ids are ``r<rank>``)."""
        def rank(rid: str) -> int:
            try:
                return int(rid.lstrip("r"))
            except ValueError:
                return -1
        rids = list(rids)
        return max(rids, key=rank) if rids else None


def heartbeat_discoverer(heartbeat_dir: str, *,
                         stale_after_s: float | None = 10.0,
                         client_kwargs: dict | None = None,
                         role: str | None = "decode"
                         ) -> Callable[[Iterable[str]], list]:
    """``discover`` hook for async backends: returns the ReplicaClients
    for endpoints advertised in *heartbeat_dir* that the gateway does
    not already know (by endpoint), fresh beacons only.

    *role* filters beacons by their advertised role (default "decode",
    beacons without the extra count as decode) — a disaggregated
    deployment shares one heartbeat directory across roles, and a
    decode controller adopting a prefill worker as a decode replica
    would route decodes at an engine that only ever prefills. One
    controller per role, each with its own role-filtered discoverer,
    gives each role its own desired count and scaling signals."""
    client_kwargs = dict(client_kwargs or {})
    seen: set[str] = set()

    def discover(known_rids: Iterable[str]) -> list:
        from k8s_distributed_deeplearning_torch.serve.transport import (
            ReplicaClient)
        from k8s_distributed_deeplearning_torch.telemetry.fleet import (
            discover_endpoints)
        fresh = discover_endpoints(heartbeat_dir,
                                   stale_after_s=stale_after_s,
                                   role=role)
        new = []
        for ep in fresh:
            if ep in seen:
                continue
            seen.add(ep)
            new.append(ReplicaClient(ep, **client_kwargs))
        return new

    return discover


# ----------------------------------------------------------- controller


class _PendingRemoval:
    """A draining victim awaiting ``drained``; ``replace`` owes the
    fleet a replacement start once the removal finalizes."""

    __slots__ = ("rid", "engine", "replace", "removed", "stopped")

    def __init__(self, rid: str, engine, *, replace: bool):
        self.rid = rid
        self.engine = engine
        self.replace = replace
        self.removed = False         # gateway membership retired
        self.stopped = False         # backend actuation done


class FleetController:
    """The control loop. Call :meth:`control_round` at a steady cadence
    (or :meth:`maybe_round` from a hot loop — it self-limits to
    ``interval_s``); each round senses, decides ONE action, actuates.

    *gateway* is a :class:`serve.gateway.ServeGateway` (duck-typed:
    ``snapshot``/``add_replica``/``drain_replica``/``remove_replica``
    plus the brownout attributes). *backend* provides
    ``start_replica``/``stop_replica`` (see module docstring). *slo* is
    an optional :class:`telemetry.slo.SLOEngine`; when present the
    controller calls ``evaluate()`` each round and treats any fast-
    window alert as overload. *discover* (optional) returns new
    engine-likes to fold into the gateway — the async-membership path
    for :class:`K8sParallelismBackend`.

    ``clock`` is injectable; every timing decision reads it, never the
    wallclock, so the chaos matrix runs on a fake clock.
    """

    def __init__(self, gateway, backend, *,
                 slo=None,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 interval_s: float = 1.0,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 15.0,
                 sustain_rounds: int = 2,
                 load_high: float = 1.5,
                 load_low: float = 0.25,
                 unhealthy_below: float = 0.5,
                 unhealthy_rounds: int = 3,
                 flap_window_s: float = 60.0,
                 max_flips_per_window: int = 4,
                 brownout_stages: Iterable[BrownoutStage] | None = None,
                 discover: Callable[[Iterable[str]], list] | None = None,
                 logger=None,
                 clock: Callable[[], float] = time.monotonic,
                 role: str = "decode"):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"need min_replicas <= max_replicas, got "
                             f"{min_replicas} > {max_replicas}")
        if up_cooldown_s < 0 or down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if sustain_rounds < 1:
            raise ValueError(f"sustain_rounds must be >= 1, got "
                             f"{sustain_rounds}")
        if not 0.0 <= load_low < load_high:
            raise ValueError(f"need 0 <= load_low < load_high, got "
                             f"{load_low} / {load_high}")
        self.gateway = gateway
        self.backend = backend
        self.slo = slo
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = interval_s
        self.up_cooldown_s = up_cooldown_s
        self.down_cooldown_s = down_cooldown_s
        self.sustain_rounds = sustain_rounds
        self.load_high = load_high
        self.load_low = load_low
        self.unhealthy_below = unhealthy_below
        self.unhealthy_rounds = unhealthy_rounds
        self.flap_window_s = flap_window_s
        self.max_flips_per_window = max_flips_per_window
        self.stages = (tuple(brownout_stages)
                       if brownout_stages is not None
                       else default_brownout_stages())
        self.discover = discover
        self.logger = logger
        self._clock = clock
        # Which serving role this controller owns. Disaggregated fleets
        # run one controller per role ("decode", "prefill"), each with
        # its own desired count, cooldowns and scaling signals — prefill
        # scales on prompt admission pressure, decode on token-stream
        # SLO burn — over a role-filtered discoverer/backend. The label
        # rides on every event and the snapshot so dashboards and
        # postmortems can tell the two control loops apart.
        self.role = str(role)
        active = [r for r in gateway.snapshot()["replicas"].values()
                  if not r["draining"]]
        self.desired = min(max(len(active), min_replicas), max_replicas)
        self._round = 0
        self._last_round_t: float | None = None
        self._last_up_t = -float("inf")
        self._last_down_t = -float("inf")
        self._last_replace_t = -float("inf")
        self._over_rounds = 0
        self._calm_rounds = 0
        self._sick_rounds: dict[str, int] = {}
        self._flips: deque[float] = deque()
        self._pending: dict[str, _PendingRemoval] = {}
        self._brownout_level = 0
        self._decisions = {k: 0 for k in DECISION_CODES}
        self._last_decision = "hold"
        self._actuation_failures = 0
        self._flap_damped_rounds = 0

    # ------------------------------------------------------------ public

    def maybe_round(self, now: float | None = None) -> dict | None:
        """Rate-limited :meth:`control_round` — safe to call from a hot
        serving loop; runs at most once per ``interval_s``."""
        now = self._clock() if now is None else now
        if (self._last_round_t is not None
                and now - self._last_round_t < self.interval_s):
            return None
        return self.control_round(now)

    def control_round(self, now: float | None = None) -> dict:
        """One sense→decide→actuate iteration. Returns the decision
        record (also folded into :meth:`snapshot`)."""
        now = self._clock() if now is None else now
        self._last_round_t = now
        self._round += 1
        self._fold_in_discovered()
        self._finalize_removals(now)
        sense = self._sense(now)
        decision = self._decide(sense, now)
        self._decisions[decision["decision"]] += 1
        self._last_decision = decision["decision"]
        return decision

    def brownout_level(self) -> int:
        return self._brownout_level

    def snapshot(self) -> dict:
        """Point-in-time controller view — the bridge's
        ``autoscale_collector`` and the CLI summary read this."""
        reps = self.gateway.snapshot()["replicas"]
        actual = sum(1 for r in reps.values() if not r["draining"])
        return {
            "role": self.role,
            "desired_replicas": self.desired,
            "actual_replicas": actual,
            "draining_replicas": sum(1 for r in reps.values()
                                     if r["draining"]),
            "brownout_level": self._brownout_level,
            "brownout_stage": (self.stages[self._brownout_level - 1].name
                               if self._brownout_level else None),
            "last_decision": self._last_decision,
            "last_decision_code": DECISION_CODES[self._last_decision],
            "rounds": self._round,
            "decisions": dict(self._decisions),
            "actuation_failures": self._actuation_failures,
            "flap_damped_rounds": self._flap_damped_rounds,
            "pending_removals": len(self._pending),
        }

    # ------------------------------------------------------------- sense

    def _sense(self, now: float) -> dict:
        snap = self.gateway.snapshot()
        reps = snap["replicas"]
        active = {rid: r for rid, r in reps.items() if not r["draining"]}
        load = sum(int(r["load"]) for r in active.values())
        slots = sum(int(r.get("slots", 0)) for r in active.values())
        load_per_slot = load / slots if slots else float(load)
        fast_burn = 0.0
        if self.slo is not None:
            self.slo.evaluate(now)
            for a in self.slo.active_alerts():
                if a.window == "fast":
                    fast_burn = max(fast_burn, a.burn_rate)
        overloaded = (fast_burn > 0.0 or load_per_slot >= self.load_high)
        # Idle is a LOAD statement, not a quiescence statement: scale-down
        # at partial load is safe because removal is drain-backed (the
        # victim's work migrates, nothing is lost).
        idle = fast_burn == 0.0 and load_per_slot <= self.load_low
        if overloaded:
            self._over_rounds += 1
            self._calm_rounds = 0
        else:
            self._over_rounds = 0
            self._calm_rounds += 1
        # Per-replica sickness streaks: open breaker or composite health
        # under the floor. Drained/draining replicas are on their way
        # out already and never counted.
        for rid, r in active.items():
            sick = (r["state"] == "open"
                    or r["health"] < self.unhealthy_below)
            self._sick_rounds[rid] = (self._sick_rounds.get(rid, 0) + 1
                                      if sick else 0)
        for rid in list(self._sick_rounds):
            if rid not in active:
                del self._sick_rounds[rid]
        return {"load_per_slot": round(load_per_slot, 4),
                "fast_burn": fast_burn, "overloaded": overloaded,
                "idle": idle, "actual": len(active), "replicas": reps}

    # ------------------------------------------------------------ decide

    def _decide(self, sense: dict, now: float) -> dict:
        d = {"round": self._round, "decision": "hold", **{
            k: sense[k] for k in ("load_per_slot", "fast_burn",
                                  "actual")}}
        actual = sense["actual"]
        over = self._over_rounds >= self.sustain_rounds
        calm = self._calm_rounds >= self.sustain_rounds
        idle = sense["idle"] and calm

        # Repair first: a sick replica poisons every other signal.
        victim = self._sick_victim()
        if (victim is not None
                and now - self._last_replace_t >= self.up_cooldown_s):
            self._last_replace_t = now
            self._begin_removal(victim, replace=True)
            if self.logger is not None:
                self.logger.emit(
                    "autoscale_replace", round=self._round, role=self.role,
                    replica=victim,
                    health=sense["replicas"][victim]["health"],
                    breaker=sense["replicas"][victim]["state"])
            d.update(decision="replace", replica=victim)
            return d

        # Reconcile owed capacity (failed earlier start, finished
        # replace) and sustained overload — both are "up" pressure.
        want_up = (over and self.desired < self.max_replicas) \
            or actual + self._draining_count() < self.desired
        if want_up and now - self._last_up_t >= self.up_cooldown_s:
            if self._flap_damped(now):
                d.update(decision="hold", damped=True)
                return d
            if over and self.desired < self.max_replicas:
                self.desired += 1
            started = self._start_one()
            self._last_up_t = now
            self._record_flip(now)
            if self.logger is not None:
                self.logger.emit(
                    "autoscale_up", round=self._round, role=self.role,
                    desired=self.desired, actual=actual,
                    fast_burn=sense["fast_burn"],
                    load_per_slot=sense["load_per_slot"],
                    started=started)
            d.update(decision="up", desired=self.desired,
                     started=started)
            return d

        # At max and still burning: walk the brownout ladder up.
        if (over and self.desired >= self.max_replicas
                and self._brownout_level < len(self.stages)
                and now - self._last_up_t >= self.up_cooldown_s):
            stage = self.stages[self._brownout_level]
            stage.apply(self.gateway)
            self._brownout_level += 1
            self._last_up_t = now
            if self.logger is not None:
                self.logger.emit(
                    "autoscale_brownout", round=self._round, role=self.role,
                    level=self._brownout_level, stage=stage.name,
                    fast_burn=sense["fast_burn"])
            d.update(decision="brownout", level=self._brownout_level,
                     stage=stage.name)
            return d

        # Burn cleared: unwind the ladder BEFORE shrinking the fleet —
        # restoring service beats saving a replica.
        if (calm and self._brownout_level > 0
                and now - self._last_down_t >= self.down_cooldown_s):
            self._brownout_level -= 1
            stage = self.stages[self._brownout_level]
            stage.restore(self.gateway)
            self._last_down_t = now
            if self._brownout_level == 0:
                if self.logger is not None:
                    self.logger.emit("autoscale_restored",
                                     round=self._round, role=self.role,
                                     fast_burn=sense["fast_burn"])
                d.update(decision="restore", stage=stage.name)
            else:
                d.update(decision="restore", stage=stage.name,
                         level=self._brownout_level)
            return d

        # Sustained idle: drain one out (never below min_replicas,
        # counting victims already on their way out).
        remaining = actual - len([p for p in self._pending.values()
                                  if not p.removed])
        if (idle and self.desired > self.min_replicas
                and remaining > self.min_replicas
                and now - self._last_down_t >= self.down_cooldown_s):
            if self._flap_damped(now):
                d.update(decision="hold", damped=True)
                return d
            victim = self._down_victim(sense["replicas"])
            if victim is not None:
                self.desired -= 1
                self._last_down_t = now
                self._record_flip(now)
                self._begin_removal(victim, replace=False)
                if self.logger is not None:
                    self.logger.emit(
                        "autoscale_down", round=self._round, role=self.role,
                        desired=self.desired, actual=actual,
                        victim=victim,
                        load_per_slot=sense["load_per_slot"])
                d.update(decision="down", desired=self.desired,
                         victim=victim)
                return d
        return d

    # ----------------------------------------------------------- actuate

    def _fire_site(self) -> None:
        inj = _faults.active()
        if inj is not None:
            inj.fire("autoscale_actuate", step=self._round)

    def _start_one(self) -> bool:
        """One backend start + gateway add. False on actuation failure
        (counted; the reconcile path retries after the up cooldown)."""
        try:
            self._fire_site()
            eng = self.backend.start_replica()
        except _ACTUATION_ERRORS:
            self._actuation_failures += 1
            return False
        if eng is not None:
            self.gateway.add_replica(eng)
        return True

    def _begin_removal(self, rid: str, *, replace: bool) -> None:
        reps = self.gateway.snapshot()["replicas"]
        if rid not in reps or rid in self._pending:
            return
        engine = self.gateway.replica_engine(rid)
        self.gateway.drain_replica(rid)
        self._pending[rid] = _PendingRemoval(rid, engine,
                                             replace=replace)
        self._sick_rounds.pop(rid, None)

    def _finalize_removals(self, now: float) -> None:
        """Retire drained victims: gateway membership first (in-process
        bookkeeping, cannot fail transiently), then the backend stop
        (actuation — retried next round on failure), then any owed
        replacement start."""
        for rid, p in list(self._pending.items()):
            if not p.removed:
                if not getattr(p.engine, "drained", False):
                    continue
                try:
                    self.gateway.remove_replica(rid)
                except (ValueError, RuntimeError):
                    pass             # already gone / raced a shutdown
                p.removed = True
            if not p.stopped:
                try:
                    self._fire_site()
                    self.backend.stop_replica(rid, p.engine)
                except _ACTUATION_ERRORS:
                    self._actuation_failures += 1
                    continue         # retry the stop next round
                p.stopped = True
            del self._pending[rid]
            if p.replace:
                self._start_one()    # repair: not a scaling flip

    def _fold_in_discovered(self) -> None:
        if self.discover is None:
            return
        known = set(self.gateway.snapshot()["replicas"])
        for eng in self.discover(known):
            rid = getattr(eng, "replica_id", None)
            if rid is not None and rid in known:
                continue
            self.gateway.add_replica(eng)

    # ----------------------------------------------------------- helpers

    def _draining_count(self) -> int:
        return sum(1 for p in self._pending.values() if not p.removed)

    def _sick_victim(self) -> str | None:
        for rid, rounds in sorted(self._sick_rounds.items()):
            if rounds >= self.unhealthy_rounds and rid not in self._pending:
                return rid
        return None

    def _down_victim(self, reps: dict) -> str | None:
        """Least-loaded healthy active replica (backend override wins —
        the k8s Job controller only ever reaps the highest index)."""
        candidates = [rid for rid, r in reps.items()
                      if not r["draining"] and rid not in self._pending
                      and r["state"] == "closed"]
        if not candidates:
            return None
        override = getattr(self.backend, "victim_rid", None)
        if override is not None:
            return override(candidates)
        return min(candidates, key=lambda rid: (reps[rid]["load"], rid))

    def _flap_damped(self, now: float) -> bool:
        while self._flips and now - self._flips[0] > self.flap_window_s:
            self._flips.popleft()
        if len(self._flips) >= self.max_flips_per_window:
            self._flap_damped_rounds += 1
            return True
        return False

    def _record_flip(self, now: float) -> None:
        self._flips.append(now)
