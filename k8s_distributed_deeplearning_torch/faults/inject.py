"""The runtime half of fault injection: hook points call in, plans fire.

The port's own copy of ``k8s_distributed_deeplearning_tpu/faults/
inject.py``: same firing rules, same per-fault random streams, so the same
plan fires the same sequence on the same visits in both packages.

Activation is process-global and resolved ONCE: :func:`active` reads
``$TPUJOB_FAULT_PLAN`` (inline JSON, or ``@/path`` to a JSON file) the
first time any hook asks, and caches the result — including the common
"no plan" case, so the steady-state cost of an un-faulted run is one
``is not None`` check per hook site (the <2% telemetry-overhead gate in
``bench.py`` also covers these hooks riding in ``train/loop.py``).

Identity comes from the gang env contract: the firing rank is
``$TPUJOB_PROCESS_ID`` and the restart incarnation is ``$TPUJOB_ATTEMPT``
(stamped by ``launch/local_executor.py``; a real cluster can set it from
the Job's retry count, and its absence means attempt 0). In-process tests
bypass the env with :func:`activate`/:func:`deactivate`.

Hook-site usage pattern (zero-cost when no plan)::

    inj = faults.active()            # once, outside the loop
    ...
    if inj is not None:
        inj.fire("step", step=step)  # per iteration
"""
from __future__ import annotations

import os
import random
import signal
import sys
import time
import weakref
from typing import Callable

from k8s_distributed_deeplearning_torch.faults.plan import Fault, FaultPlan
from k8s_distributed_deeplearning_torch.utils import ckpt as ckpt_paths

FAULT_PLAN_ENV = "TPUJOB_FAULT_PLAN"
ATTEMPT_ENV = "TPUJOB_ATTEMPT"
RANK_ENV = "TPUJOB_PROCESS_ID"


class FaultInjector:
    """Executes a validated plan for one (rank, attempt) incarnation.

    Per-fault visit counters implement the ``after``/``count`` windows for
    call-count-triggered faults (transient IOErrors); step-triggered faults
    compare against the hook's ``step`` directly, so they are deterministic
    under restarts regardless of how many hook visits preceded them.

    Probabilistic (``p``) faults draw from per-fault ``random.Random``
    streams seeded by ``(plan.seed, fault index, rank)`` — independent
    streams, so adding a fault to the plan never perturbs the draws of
    the faults before it, and the same plan replays the identical firing
    sequence on the same visit sequence (graftstorm's repro contract).
    """

    def __init__(self, plan: FaultPlan, *, rank: int = 0, attempt: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        plan.validate_or_raise()
        self.plan = plan
        self.rank = rank
        self.attempt = attempt
        self._sleep = sleep
        self._clock = clock
        self._visits = [0] * len(plan.faults)
        self._fires = [0] * len(plan.faults)
        # str seeds hash through SHA-512 in random.Random — stable across
        # processes and platforms, unlike hash() of a tuple.
        self._rngs = [
            random.Random(f"{plan.seed}:{i}:{rank}") if f.p is not None
            else None
            for i, f in enumerate(plan.faults)]
        # Active partition windows: site -> monotonic deadline. A fired
        # "partition" fault severs its site for the fault's ``seconds`` —
        # EVERY subsequent fire at that site raises until the window
        # closes, modelling an outage rather than a per-call blip.
        self._partition_until: dict[str, float] = {}
        self.fired: list[tuple[str, str]] = []   # (site, action) log

    def _applies(self, f: Fault, site: str) -> bool:
        return (f.site == site
                and (f.rank is None or f.rank == self.rank)
                and (f.attempt is None or f.attempt == self.attempt))

    def _triggered(self, i: int, f: Fault, step: int | None) -> bool:
        if f.step is not None:
            return step == f.step
        self._visits[i] += 1
        if f.p is not None:
            # Probabilistic per-visit trigger inside the after/count
            # window: skip the first ``after`` visits, stop for good
            # after ``count`` fires. The RNG is consumed ONLY on
            # in-window visits, so the draw sequence is a pure function
            # of the visit sequence.
            if self._visits[i] <= f.after or self._fires[i] >= f.count:
                return False
            if self._rngs[i].random() >= f.p:
                return False
            self._fires[i] += 1
            return True
        return f.after < self._visits[i] <= f.after + f.count

    def fire(self, site: str, *, step: int | None = None,
             path: str | None = None) -> None:
        """Give every matching fault at *site* its chance to fire. *step*
        feeds step-triggered faults; *path* (a checkpoint directory) feeds
        the corrupt/truncate actions."""
        until = self._partition_until.get(site)
        if until is not None:
            if self._clock() < until:
                raise OSError(f"injected partition at site {site!r} "
                              f"(rank {self.rank}): link severed")
            del self._partition_until[site]
        for i, f in enumerate(self.plan.faults):
            if not self._applies(f, site) or f.action == "stop":
                continue
            if not self._triggered(i, f, step):
                continue
            self.fired.append((site, f.action))
            # Last-gasp hooks run BEFORE the action executes: "exit" is an
            # immediate os._exit and "sigterm"/"ioerror" unwind the caller,
            # so this is the only instant a flight recorder can still dump
            # the black box of the process the fault is about to kill.
            _run_fire_hooks(site, f.action)
            self._execute(f, path)

    def suppressed(self, site: str, *, step: int | None = None) -> bool:
        """True when a ``stop`` fault silences *site* (from its ``step``
        onward when step-scoped, unconditionally otherwise)."""
        for f in self.plan.faults:
            if f.action != "stop" or not self._applies(f, site):
                continue
            if f.step is None or (step is not None and step >= f.step):
                return True
        return False

    def _execute(self, f: Fault, path: str | None) -> None:
        if f.action == "exit":
            print(f"fault-injection: hard exit({f.exit_code}) at site "
                  f"{f.site!r} rank {self.rank}", file=sys.stderr, flush=True)
            os._exit(f.exit_code)
        if f.action == "sigterm":
            print(f"fault-injection: SIGTERM to self at site {f.site!r} "
                  f"rank {self.rank}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if f.action == "stall":
            self._sleep(f.seconds)
            return
        if f.action == "ioerror":
            raise OSError(f"injected transient IO error at site {f.site!r} "
                          f"(rank {self.rank})")
        if f.action == "drop":
            # The message vanished on the wire: nobody reports an error,
            # the caller discovers by deadline. TimeoutError (an OSError
            # subclass) so transport is_transient predicates retry it.
            raise TimeoutError(f"injected message drop at site {f.site!r} "
                               f"(rank {self.rank})")
        if f.action == "partition":
            self._partition_until[f.site] = self._clock() + f.seconds
            raise OSError(f"injected partition at site {f.site!r} "
                          f"(rank {self.rank}): link severed for "
                          f"{f.seconds}s")
        if f.action in ("truncate", "corrupt"):
            if path is None:
                raise ValueError(
                    f"{f.action} fault fired at site {f.site!r} but the "
                    "hook passed no checkpoint path")
            damage_newest_checkpoint(path, mode=f.action)
            return
        raise AssertionError(f"unhandled action {f.action!r}")


def damage_newest_checkpoint(directory: str, *, mode: str = "truncate"
                             ) -> str | None:
    """Damage the largest file of the newest committed step under
    *directory*: ``truncate`` halves it (torn write), ``corrupt`` flips a
    byte run in the middle, size-preserving (bitrot). The step's manifest
    is left intact — that asymmetry is exactly what restore verification
    detects. Returns the damaged file's path (None when nothing to damage).
    """
    step = ckpt_paths.latest_step_on_disk(directory)
    if step is None:
        return None
    root = os.path.join(directory, str(step))
    victim, vsize = None, -1
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            size = os.stat(p).st_size
            if size > vsize:
                victim, vsize = p, size
    if victim is None:
        return None
    if mode == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(max(0, vsize // 2))
    else:
        with open(victim, "r+b") as f:
            f.seek(vsize // 2)
            run = f.read(64) or b"\x00"
            f.seek(vsize // 2)
            f.write(bytes(b ^ 0xFF for b in run))
    return victim


# Last-gasp observers (weakrefs): objects whose ``_on_fault(site, action)``
# runs between a fault's trigger bookkeeping and its execution. The flight
# recorder's dump-on-injected-fault path — registered by components (engine,
# gateway) that own a recorder, dropped automatically when they die. Hook
# errors are swallowed: forensics must never mask the fault under test.
_fire_hooks: list["weakref.ref"] = []


def add_fire_hook(obj) -> None:
    """Register ``obj._on_fault(site, action)`` as a last-gasp observer.
    Held by weakref — no unregister needed."""
    _fire_hooks.append(weakref.ref(obj))


def _run_fire_hooks(site: str, action: str) -> None:
    if not _fire_hooks:
        return
    for r in list(_fire_hooks):
        obj = r()
        if obj is None:
            try:
                _fire_hooks.remove(r)
            except ValueError:
                pass
            continue
        try:
            obj._on_fault(site, action)
        except Exception:
            pass


# Process-global activation cache. _resolved distinguishes "not yet looked
# at the env" from "looked: no plan" — the latter is the hot no-op path.
_injector: FaultInjector | None = None
_resolved = False


def active() -> FaultInjector | None:
    """The process's injector, or None when no plan is configured. Reads
    the env once; see :func:`activate`/:func:`deactivate` for tests."""
    global _injector, _resolved
    if not _resolved:
        _resolved = True
        raw = os.environ.get(FAULT_PLAN_ENV, "").strip()
        if raw:
            if raw.startswith("@"):
                with open(raw[1:]) as f:
                    raw = f.read()
            _injector = FaultInjector(
                FaultPlan.from_json(raw),
                rank=int(os.environ.get(RANK_ENV, "0") or 0),
                attempt=int(os.environ.get(ATTEMPT_ENV, "0") or 0))
    return _injector


def activate(plan: FaultPlan, *, rank: int = 0, attempt: int = 0,
             sleep: Callable[[float], None] = time.sleep,
             clock: Callable[[], float] = time.monotonic) -> FaultInjector:
    """Install *plan* as the process's active injector (in-process tests;
    worker processes use the env instead). Returns the injector.
    ``clock`` is injectable so partition windows run on a virtual clock
    (graftstorm) instead of the wallclock."""
    global _injector, _resolved
    _injector = FaultInjector(plan, rank=rank, attempt=attempt, sleep=sleep,
                              clock=clock)
    _resolved = True
    return _injector


def deactivate() -> None:
    """Clear the active injector AND the resolution cache, so the next
    :func:`active` re-reads the env (test isolation)."""
    global _injector, _resolved
    _injector = None
    _resolved = False
