"""Declarative fault plans: WHAT fails, WHERE, and WHEN — as data.

The port's own copy of ``k8s_distributed_deeplearning_tpu/faults/plan.py``,
unchanged in behaviour: the sites, actions, JSON and validation are the
JAX package's, so a plan file is shared across the two packages. The
locations below are the JAX package's; in the port every site has its
caller at the same point.

A :class:`FaultPlan` is a JSON-serializable list of :class:`Fault` records.
It travels as the ``TPUJOB_FAULT_PLAN`` env var (inline JSON, or ``@/path``
to a JSON file) so the exact same chaos scenario runs in-process under
pytest, under the local gang executor, and on a real cluster through the
rendered manifest (``JobConfig.fault_plan`` → ``launch/render.py``).

Determinism is the whole point: every fault names its trigger exactly —
the site (a named hook point in the code), the rank, the step or visit
count, and the attempt (restart number) it fires on. Two runs of the same
plan inject identically, which is what lets ``tests/test_faults.py`` prove
"recovers to a final state consistent with the unfaulted run" rather than
"usually survives some noise".

Sites (where the hook points live):

- ``step``             train loop, start of each step (``train/loop.py``)
- ``data_wait``        train loop, before pulling the next batch
- ``shard_read``       ``TokenShardBatcher._make_batch`` (``train/data.py``)
- ``checkpoint_saved`` train loop, right after a checkpoint write completes
- ``heartbeat``        gates ``HeartbeatWriter.beat`` in the train loop
- ``serve_decode``     serving engine, before each decode iteration
- ``gateway_dispatch`` serving gateway (``serve/gateway.py``), before it
                       steps each replica — ``step`` carries the REPLICA
                       INDEX, so a step-scoped fault targets exactly one
                       replica of an in-process fleet (``ioerror`` = that
                       replica's dispatch fails, ``stall`` = it straggles)
- ``executor``         the PARENT gang executor (``launch/local_executor``):
                       kills worker *rank* from outside after *seconds* —
                       the kubelet/node-failure emulation
- ``transport_send``   serving transport (``serve/transport.py``), client
                       side, before each HTTP call leaves — ``ioerror``/
                       ``drop`` here mean the request NEVER reached the
                       replica (retry is unambiguous), ``stall`` is send
                       latency, ``partition`` makes the link raise for
                       *seconds*
- ``transport_recv``   serving transport, replica side, after the handler
                       ran but before the response is written — ``drop``/
                       ``ioerror`` here are the AMBIGUOUS failure (request
                       landed, response lost), the case idempotent submit
                       exists for; ``stall`` is response latency
- ``transport_pages``  KV page shipping (``serve/disagg.py`` over
                       ``serve/transport.py``), client side, before each
                       ``/pages`` chunk leaves — ``ioerror``/``drop`` lose
                       a chunk in flight (idempotent transfer keys make
                       the retry exactly-once), ``stall`` is shipping
                       latency, ``partition`` severs the prefill→decode
                       link for *seconds*
- ``autoscale_actuate`` fleet controller (``serve/autoscale.py``), before
                       each backend start/stop actuation — ``step``
                       carries the CONTROL-ROUND index; ``ioerror`` = the
                       actuation fails (spawn/patch error, retried next
                       round), ``stall`` = slow actuation, ``exit`` = the
                       controller process dies mid-actuation

Actions (what happens when the trigger matches):

- ``exit``     ``os._exit(exit_code)`` — a hard kill, no cleanup, no
               atexit, the SIGKILL-equivalent from inside
- ``sigterm``  ``os.kill(os.getpid(), SIGTERM)`` — the K8s eviction signal
- ``stall``    ``time.sleep(seconds)`` — a hung data source / slow volume
- ``ioerror``  raise ``OSError`` (transient: fires ``count`` times after
               ``after`` visits, then stops — the retryable-blip shape)
- ``truncate`` truncate the largest file of the newest checkpoint step
               under the hook's path (torn mid-write)
- ``corrupt``  flip bytes of that file, size-preserving (bitrot/bad DMA)
- ``stop``     suppress the hooked side effect from ``step`` onward
               (heartbeat writer goes silent — the zombie-rank mode)
- ``drop``     raise ``TimeoutError`` — the message vanished on the wire
               and nobody will say so; the caller finds out by deadline.
               Distinct from ``ioerror`` (an immediate, honest connection
               error) because the two teach retry layers different
               lessons: transport sites only
- ``partition`` raise ``OSError`` now AND for the next ``seconds`` of
               wall-clock at this site — a severed link stays severed
               until it heals, unlike the count-scoped ``ioerror`` blip.
               Transport sites only; needs ``seconds`` > 0

Triggers come in three flavours, mutually exclusive per fault:

- step-scoped: ``step`` equals the hook's step — exact and restart-proof
- visit-scoped: skip ``after`` visits, then fire ``count`` times — the
  transient-blip shape
- probabilistic (graftstorm): ``p`` in (0, 1] fires each visit with that
  probability, drawn from a per-fault ``random.Random`` stream seeded
  from the PLAN-level ``seed`` + the fault's index + the rank — so the
  same plan replays the identical firing sequence on the same visit
  sequence, which is what makes a randomized chaos soak a repro line
  instead of an anecdote. ``after``/``count`` still bound the window
  (skip the first ``after`` visits; stop after ``count`` fires). ``p``
  requires the plan to carry ``seed``; validation rejects the dangling
  half.
"""
from __future__ import annotations

import dataclasses
import json

SITES = ("step", "data_wait", "shard_read", "checkpoint_saved", "heartbeat",
         "serve_decode", "gateway_dispatch", "executor", "transport_send",
         "transport_recv", "transport_pages", "autoscale_actuate")
ACTIONS = ("exit", "sigterm", "stall", "ioerror", "truncate", "corrupt",
           "stop", "drop", "partition")

# Which actions make sense at which sites — a plan naming a nonsensical
# pair is a bug in the scenario, not a scenario.
_SITE_ACTIONS = {
    "step": ("exit", "sigterm", "stall"),
    "data_wait": ("stall", "ioerror", "exit", "sigterm"),
    "shard_read": ("ioerror", "stall"),
    "checkpoint_saved": ("truncate", "corrupt", "exit"),
    "heartbeat": ("stop",),
    "serve_decode": ("stall", "exit", "sigterm"),
    "gateway_dispatch": ("ioerror", "stall", "exit", "sigterm"),
    "executor": ("exit", "sigterm"),
    "transport_send": ("ioerror", "stall", "drop", "partition"),
    "transport_recv": ("ioerror", "stall", "drop", "partition"),
    "transport_pages": ("ioerror", "stall", "drop", "partition"),
    "autoscale_actuate": ("ioerror", "stall", "exit"),
}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected failure. Fields not relevant to the action keep their
    defaults (validation rejects contradictory combinations).

    ``rank``: which process fires (None = every rank). ``step``: fire when
    the hook's step equals this (None = fire by visit count instead:
    skip the first ``after`` visits, then fire ``count`` times).
    ``attempt``: which restart incarnation fires (0 = the first run only —
    the default, so a kill-fault doesn't re-kill the recovered job forever;
    None = every attempt). ``seconds`` feeds ``stall`` and the ``executor``
    kill delay; ``exit_code`` feeds ``exit``. ``p`` makes the trigger
    probabilistic per visit (seeded by the plan's ``seed`` — see module
    docstring); mutually exclusive with ``step``.
    """

    site: str
    action: str
    rank: int | None = None
    step: int | None = None
    after: int = 0
    count: int = 1
    seconds: float = 0.0
    exit_code: int = 43
    attempt: int | None = 0
    p: float | None = None

    def problems(self) -> list[str]:
        errs = []
        if self.site not in SITES:
            errs.append(f"unknown site {self.site!r} (one of {SITES})")
        if self.action not in ACTIONS:
            errs.append(f"unknown action {self.action!r} (one of {ACTIONS})")
        if not errs and self.action not in _SITE_ACTIONS[self.site]:
            errs.append(f"action {self.action!r} is not valid at site "
                        f"{self.site!r} (valid: {_SITE_ACTIONS[self.site]})")
        if self.action == "stall" and self.seconds <= 0:
            errs.append("stall needs seconds > 0")
        if self.action == "partition" and self.seconds <= 0:
            errs.append("partition needs seconds > 0 (the outage window)")
        if self.site == "executor":
            if self.rank is None:
                errs.append("executor faults must name a rank (the victim)")
            if self.step is not None:
                errs.append("executor faults are delay-based (seconds), "
                            "not step-based")
        if self.count < 1:
            errs.append(f"count must be >= 1, got {self.count}")
        if self.after < 0:
            errs.append(f"after must be >= 0, got {self.after}")
        if self.rank is not None and self.rank < 0:
            errs.append(f"rank must be >= 0, got {self.rank}")
        if self.p is not None:
            if not isinstance(self.p, (int, float)) \
                    or isinstance(self.p, bool) \
                    or not 0.0 < float(self.p) <= 1.0:
                errs.append(f"p must be in (0, 1], got {self.p!r}")
            if self.step is not None:
                errs.append("p and step are mutually exclusive triggers "
                            "(probabilistic-per-visit vs exact-step)")
            if self.site == "executor":
                errs.append("executor faults are delay-based (seconds), "
                            "not probabilistic")
        return errs


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered collection of faults, serializable to/from JSON.

    ``seed`` feeds the per-fault RNG streams of probabilistic (``p``)
    triggers; a plan with no ``p`` faults does not need one (and omits
    it from its JSON, keeping pre-storm plans byte-identical)."""

    faults: tuple[Fault, ...] = ()
    seed: int | None = None

    def to_json(self) -> str:
        doc: dict = {"faults": [dataclasses.asdict(f)
                                for f in self.faults]}
        if self.seed is not None:
            doc["seed"] = self.seed
        return json.dumps(doc)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"fault plan is not valid JSON: {e}") from e
        if not isinstance(doc, dict) or not isinstance(doc.get("faults"),
                                                       list):
            raise ValueError(
                'fault plan must be {"faults": [...], "seed"?: int}, got '
                f"{type(doc).__name__}")
        extra = set(doc) - {"faults", "seed"}
        if extra:
            raise ValueError(
                f"fault plan has unknown top-level fields {sorted(extra)} "
                '(known: ["faults", "seed"])')
        known = {f.name for f in dataclasses.fields(Fault)}
        faults = []
        for i, rec in enumerate(doc["faults"]):
            if not isinstance(rec, dict):
                raise ValueError(f"faults[{i}] is not an object")
            unknown = set(rec) - known
            if unknown:
                raise ValueError(
                    f"faults[{i}] has unknown fields {sorted(unknown)} "
                    f"(known: {sorted(known)})")
            try:
                faults.append(Fault(**rec))
            except TypeError as e:
                raise ValueError(f"faults[{i}]: {e}") from e
        return cls(faults=tuple(faults), seed=doc.get("seed"))

    def problems(self) -> list[str]:
        """Validation errors (empty = plan is well-formed). Used by
        ``launch/validate.py`` so a bad plan fails at render time, not
        half an hour into the chaos run."""
        errs: list[str] = []
        if self.seed is not None and (not isinstance(self.seed, int)
                                      or isinstance(self.seed, bool)):
            errs.append(f"seed must be an int, got {self.seed!r}")
        for i, f in enumerate(self.faults):
            errs.extend(f"faults[{i}]: {p}" for p in f.problems())
            if f.p is not None and self.seed is None:
                errs.append(
                    f"faults[{i}]: p={f.p} needs a plan-level seed — an "
                    "unseeded probabilistic fault cannot replay, which "
                    "defeats the repro-line contract")
        return errs

    def validate_or_raise(self) -> "FaultPlan":
        errs = self.problems()
        if errs:
            raise ValueError("invalid fault plan:\n  " + "\n  ".join(errs))
        return self
