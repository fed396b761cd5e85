"""PyTorch port, the fleet controller (``serve/autoscale.py``) and the
gateway's dynamic membership, against the JAX package's.

The controller is host code, so every case runs the same script on both
packages over the same fakes (a gateway over scripted fake engines, a
fake backend, one fake clock, the same fault plan made active in each
package's own ``faults``) and holds the port to JAX's decision records,
``snapshot()``s, gateway views and emitted events round for round, equal
and not close: the matrix of JAX's ``tests/test_autoscale.py`` (sustained
load and fast-window SLO burn, ioerror and stall at ``autoscale_actuate``,
drain then stop, a crash mid-drain, a stop failure retried, a sick
replica replaced, the brownout ladder, oscillating load, ``maybe_round``'s
rate limit). The membership cases run on real engines too (tiny
topology, f32, the JAX weights carried over by ``models/convert.py``):
add under load, remove mid-decode with streams equal to the JAX
gateway's token ids, the brownout levers' refusals word for word. Then
discovery (stale beacons), the k8s backend over a fake kubectl, a real
replica-server process spawned and stopped by ``LocalProcessBackend``,
the serve CLI's ``--autoscale*`` checks against JAX's, the bridge's
gauges, and the autoscaled storm's report against JAX's.
"""
import ast
import inspect
import io
import json
import os
import re
import subprocess
import time
from contextlib import redirect_stderr
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch import faults as t_faults
from k8s_distributed_deeplearning_torch.launch import watch as t_watch
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import QueueFull as TQueueFull
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import autoscale as t_auto
from k8s_distributed_deeplearning_torch.serve import cli as t_cli
from k8s_distributed_deeplearning_torch.serve import gateway as t_gateway
from k8s_distributed_deeplearning_torch.serve import storm as t_storm
from k8s_distributed_deeplearning_torch.telemetry import bridge as t_bridge
from k8s_distributed_deeplearning_torch.telemetry import fleet as t_fleet
from k8s_distributed_deeplearning_torch.telemetry import heartbeat as t_hb
from k8s_distributed_deeplearning_torch.telemetry import registry as t_reg
from k8s_distributed_deeplearning_torch.telemetry import slo as t_slo
from k8s_distributed_deeplearning_torch.utils.metrics import (
    ServingStats as TStats)
from k8s_distributed_deeplearning_tpu import faults as j_faults
from k8s_distributed_deeplearning_tpu.launch import watch as j_watch
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import QueueFull as JQueueFull
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import autoscale as j_auto
from k8s_distributed_deeplearning_tpu.serve import cli as j_cli
from k8s_distributed_deeplearning_tpu.serve import gateway as j_gateway
from k8s_distributed_deeplearning_tpu.serve import storm as j_storm
from k8s_distributed_deeplearning_tpu.telemetry import bridge as j_bridge
from k8s_distributed_deeplearning_tpu.telemetry import fleet as j_fleet
from k8s_distributed_deeplearning_tpu.telemetry import heartbeat as j_hb
from k8s_distributed_deeplearning_tpu.telemetry import registry as j_reg
from k8s_distributed_deeplearning_tpu.telemetry import slo as j_slo
from k8s_distributed_deeplearning_tpu.utils.metrics import (
    ServingStats as JStats)

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    for f in (t_faults, j_faults):
        f.deactivate()
    yield
    for f in (t_faults, j_faults):
        f.deactivate()


class _Pkg:
    """One package's controller, gateway, fault, SLO and stats modules
    behind one surface, so a script runs unchanged on both."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.auto, self.gw, self.faults, self.slo = (
                j_auto, j_gateway, j_faults, j_slo)
            self.Stats, self.Request, self.QueueFull = (
                JStats, JRequest, JQueueFull)
        else:
            self.auto, self.gw, self.faults, self.slo = (
                t_auto, t_gateway, t_faults, t_slo)
            self.Stats, self.Request, self.QueueFull = (
                TStats, TRequest, TQueueFull)


PKGS = (_Pkg("jax"), _Pkg("torch"))


def _both(script):
    """Run *script* on each package; the port's trace must equal JAX's."""
    traces = [script(p) for p in PKGS]
    assert traces[1] == traces[0]
    assert traces[0], "the script recorded nothing"
    return traces[1]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def names(self):
        return [e for e, _ in self.events]


class _FakePool:
    def counters(self):
        return {"pages_total": 8, "pages_used": 0, "pages_shared": 0}


class _ClassedQueue(list):
    """Plain-list queue that knows tenant priority classes: the surface
    ``ServeGateway._tenant_class`` duck-types against."""

    def priority_of(self, tenant):
        return {"bulk": "batch", "chat": "interactive"}.get(tenant)


class _FakeEngine:
    """Enough engine for controller and breaker state: instant steps,
    settable load, a latched drain (JAX's test fake, package-free)."""

    def __init__(self, replica_id=None, occupied=0, slots=2,
                 auto_drain=True, queue=None):
        self.replica_id = replica_id
        self.queue = queue if queue is not None else []
        self.num_slots = slots
        self.pool = _FakePool()
        self.steps = 0
        self.submitted = []
        self.shutdowns = 0
        self._occupied = occupied
        self._auto_drain = auto_drain
        self._draining = False
        self._drained = False

    def busy(self):
        return False

    def occupied_slots(self):
        return self._occupied

    def load(self):
        return self._occupied + len(self.queue)

    def step(self):
        self.steps += 1
        return []

    def submit(self, req, *, requeue=False):
        self.submitted.append(req)

    def cancel(self, request_id, reason="aborted"):
        return None

    def drain(self, *, flush=False):
        self._draining = True
        if self._auto_drain:
            self._drained = True
        return []

    @property
    def draining(self):
        return self._draining

    @property
    def drained(self):
        return self._drained

    def shutdown(self):
        self.shutdowns += 1
        self._draining = True
        self._drained = True
        return []


class _Backend:
    """EngineFactoryBackend's shape with start/stop bookkeeping."""

    def __init__(self):
        self.started = []
        self.stopped = []

    def start_replica(self):
        e = _FakeEngine()
        self.started.append(e)
        return e

    def stop_replica(self, rid, engine):
        self.stopped.append(rid)
        engine.shutdown()


def _fleet(P, n=1, *, occupied=0, logger=None, clk=None, **gw_kw):
    engines = [_FakeEngine(replica_id=f"r{i}", occupied=occupied)
               for i in range(n)]
    kw = dict(stats=P.Stats(), logger=logger)
    if clk is not None:
        kw["clock"] = clk
    return P.gw.ServeGateway(engines, **kw, **gw_kw), engines


def _ctl(P, gw, backend, clk, **kw):
    kw.setdefault("interval_s", 0.0)
    kw.setdefault("up_cooldown_s", 1.0)
    kw.setdefault("down_cooldown_s", 1.0)
    kw.setdefault("sustain_rounds", 2)
    return P.auto.FleetController(gw, backend, clock=clk, **kw)


def _set_load(gw, occ):
    for rid in gw.replica_ids():
        gw.replica_engine(rid)._occupied = occ


def _actuation_fault(P, action, *, step=None, seconds=None):
    return P.faults.FaultPlan((P.faults.Fault(
        site="autoscale_actuate", action=action, step=step,
        seconds=seconds),))


def _kill_replica_plan(P, index):
    return P.faults.FaultPlan((P.faults.Fault(
        site="gateway_dispatch", action="ioerror", step=index,
        attempt=None),))


def _round(ctl, gw, clk, trace, now=None):
    """One control round, recorded: the decision, the controller's and
    the gateway's snapshots, and the membership."""
    d = ctl.control_round(clk.t if now is None else now)
    trace.append((d, ctl.snapshot(), gw.snapshot(), gw.replica_ids()))
    return d


# ------------------------------------------------------------ validation


def test_controller_and_stage_validation():
    def script(P):
        gw, _ = _fleet(P, 1)
        be = _Backend()
        said = []
        for kw in (dict(min_replicas=0),
                   dict(min_replicas=3, max_replicas=2),
                   dict(sustain_rounds=0),
                   dict(load_low=2.0, load_high=1.0),
                   dict(up_cooldown_s=-1.0)):
            with pytest.raises(ValueError) as err:
                P.auto.FleetController(gw, be, **kw)
            said.append(str(err.value))
        with pytest.raises(ValueError, match="unknown brownout stage") as err:
            P.auto.default_brownout_stages(("shed_batch", "nope"))
        said.append(str(err.value))
        said.append([s.name for s in P.auto.default_brownout_stages(
            ("no_hedge", "shed_batch"))])
        return said

    said = _both(script)
    assert said[-1] == ["no_hedge", "shed_batch"]
    assert t_auto.BROWNOUT_STAGE_NAMES == j_auto.BROWNOUT_STAGE_NAMES
    assert t_auto.DECISION_CODES == j_auto.DECISION_CODES


def test_autoscale_fault_site_plan_validation():
    def script(P):
        return [_actuation_fault(P, "ioerror", step=2).problems(),
                _actuation_fault(P, "stall", seconds=0.01).problems(),
                P.faults.FaultPlan((P.faults.Fault(
                    site="autoscale_actuate", action="exit"),)).problems(),
                P.faults.FaultPlan((P.faults.Fault(
                    site="autoscale_actuate",
                    action="truncate"),)).problems()]

    probs = _both(script)
    assert probs[:3] == [[], [], []] and probs[3]


# -------------------------------------------------------------- scale up


def test_scale_up_on_sustained_load_respects_cooldown():
    def script(P):
        clk, ev, trace = _Clock(), _Events(), []
        gw, _ = _fleet(P, 1, occupied=4, logger=ev)  # 4 load / 2 slots
        ctl = _ctl(P, gw, _Backend(), clk, max_replicas=3, logger=ev)
        assert _round(ctl, gw, clk, trace)["decision"] == "hold"
        clk.advance(0.1)
        d = _round(ctl, gw, clk, trace)
        assert d["decision"] == "up" and d["started"]
        clk.advance(0.2)
        _set_load(gw, 4)
        assert _round(ctl, gw, clk, trace)["decision"] == "hold"
        clk.advance(1.0)
        assert _round(ctl, gw, clk, trace)["decision"] == "up"
        for _ in range(5):
            clk.advance(1.1)
            _set_load(gw, 4)
            assert _round(ctl, gw, clk, trace)["decision"] in (
                "hold", "brownout")
            assert len(gw.replica_ids()) <= 3
        return trace, ev.events

    trace, events = _both(script)
    assert trace[-1][1]["desired_replicas"] == 3
    assert [e for e, _ in events].count("autoscale_up") == 2


def test_scale_up_on_slo_fast_burn():
    def script(P):
        clk, trace = _Clock(), []
        gw, _ = _fleet(P, 1)
        slo = P.slo.SLOEngine({"default": P.slo.SLOTarget(
            availability=0.99, window_s=60.0)}, clock=clk)
        ctl = _ctl(P, gw, _Backend(), clk, slo=slo)
        slo.observe(finished={"default": {"timeout": 40}}, now=clk.t)
        _round(ctl, gw, clk, trace)
        clk.advance(0.1)
        d = _round(ctl, gw, clk, trace)
        assert d["decision"] == "up" and d["fast_burn"] > 14.4
        clk.advance(30.0)
        slo.observe(finished={"default": {"timeout": 40, "eos": 500}},
                    now=clk.t)
        for _ in range(4):
            clk.advance(1.1)
            _round(ctl, gw, clk, trace)
        return trace

    trace = _both(script)
    assert trace[-1][0]["decision"] in ("down", "hold")
    assert trace[-1][1]["actual_replicas"] >= 1


# --------------------------------------------------------- chaos: faults


def test_actuation_ioerror_counts_failure_and_reconciles():
    def script(P):
        clk, trace = _Clock(), []
        gw, _ = _fleet(P, 1, occupied=4)
        be = _Backend()
        ctl = _ctl(P, gw, be, clk, max_replicas=2)
        P.faults.activate(_actuation_fault(P, "ioerror"))
        try:
            _round(ctl, gw, clk, trace)
            clk.advance(0.1)
            d = _round(ctl, gw, clk, trace)
        finally:
            P.faults.deactivate()
        assert d["decision"] == "up" and not d["started"]
        clk.advance(1.1)
        d = _round(ctl, gw, clk, trace)
        assert d["decision"] == "up" and d["started"]
        return trace, len(be.started)

    trace, started = _both(script)
    assert trace[1][1]["actuation_failures"] == 1 and trace[1][3] == ["r0"]
    assert trace[-1][1]["desired_replicas"] == 2 and started == 1


def test_actuation_stall_slows_but_does_not_fail():
    def script(P):
        clk, trace = _Clock(), []
        gw, _ = _fleet(P, 1, occupied=4)
        ctl = _ctl(P, gw, _Backend(), clk)
        P.faults.activate(_actuation_fault(P, "stall", seconds=0.01))
        try:
            _round(ctl, gw, clk, trace)
            clk.advance(0.1)
            _round(ctl, gw, clk, trace)
        finally:
            P.faults.deactivate()
        return trace

    trace = _both(script)
    d, snap, _, rids = trace[-1]
    assert d["decision"] == "up" and d["started"]
    assert snap["actuation_failures"] == 0 and len(rids) == 2


# ------------------------------------------------------------ scale down


def test_scale_down_drains_then_stops_backend():
    def script(P):
        clk, ev, trace = _Clock(), _Events(), []
        gw, engines = _fleet(P, 2, logger=ev)
        be = _Backend()
        ctl = _ctl(P, gw, be, clk, sustain_rounds=1, logger=ev)
        d = _round(ctl, gw, clk, trace)
        assert d["decision"] == "down" and engines[0].draining
        clk.advance(0.1)
        _round(ctl, gw, clk, trace)
        for _ in range(5):
            clk.advance(1.1)
            assert _round(ctl, gw, clk, trace)["decision"] == "hold"
        return trace, be.stopped, engines[0].shutdowns, ev.events

    trace, stopped, shutdowns, events = _both(script)
    assert trace[0][0]["victim"] == "r0" and trace[0][3] == ["r0", "r1"]
    assert trace[1][3] == ["r1"] and stopped == ["r0"] and shutdowns == 1
    names = [e for e, _ in events]
    assert "autoscale_down" in names and "gateway_replica_removed" in names
    assert trace[-1][1]["pending_removals"] == 0


def test_replica_crash_during_scale_down_converges():
    def script(P):
        clk, trace = _Clock(), []
        gw, engines = _fleet(P, 2, clk=clk, failures_to_trip=1)
        victim = engines[0]
        victim._auto_drain = False
        be = _Backend()
        ctl = _ctl(P, gw, be, clk, sustain_rounds=1)
        assert _round(ctl, gw, clk, trace)["decision"] == "down"
        clk.advance(0.1)
        _round(ctl, gw, clk, trace)
        assert len(gw.replica_ids()) == 2            # stuck mid-drain
        P.faults.activate(_kill_replica_plan(P, 0))
        try:
            gw.step()
        finally:
            P.faults.deactivate()
        assert victim.drained
        clk.advance(0.1)
        _round(ctl, gw, clk, trace)
        return trace, be.stopped

    trace, stopped = _both(script)
    snap = trace[-1][1]
    assert trace[-1][3] == ["r1"] and stopped == ["r0"]
    assert snap["pending_removals"] == 0
    assert snap["desired_replicas"] == 1 == snap["actual_replicas"]


def test_stop_failure_retries_next_round():
    def script(P):
        clk, trace = _Clock(), []
        gw, _ = _fleet(P, 2)
        be = _Backend()
        ctl = _ctl(P, gw, be, clk, sustain_rounds=1)
        assert _round(ctl, gw, clk, trace)["decision"] == "down"
        P.faults.activate(_actuation_fault(P, "ioerror"))
        try:
            clk.advance(0.1)
            _round(ctl, gw, clk, trace)
        finally:
            P.faults.deactivate()
        stopped_then = list(be.stopped)
        clk.advance(0.1)
        _round(ctl, gw, clk, trace)
        return trace, stopped_then, be.stopped

    trace, stopped_then, stopped = _both(script)
    assert trace[1][3] == ["r1"] and stopped_then == []
    assert trace[1][1]["pending_removals"] == 1
    assert trace[1][1]["actuation_failures"] == 1
    assert stopped == ["r0"] and trace[2][1]["pending_removals"] == 0


# --------------------------------------------------------------- replace


def test_replace_sick_replica_repairs_in_place():
    def script(P):
        clk, ev, trace = _Clock(), _Events(), []
        gw, _ = _fleet(P, 2, logger=ev, clk=clk, failures_to_trip=1)
        be = _Backend()
        ctl = _ctl(P, gw, be, clk, unhealthy_rounds=2, sustain_rounds=50,
                   logger=ev)
        P.faults.activate(_kill_replica_plan(P, 0))
        try:
            gw.step()
        finally:
            P.faults.deactivate()
        assert gw.breaker_state("r0") == "open"
        assert _round(ctl, gw, clk, trace)["decision"] == "hold"
        clk.advance(0.1)
        d = _round(ctl, gw, clk, trace)
        assert d["decision"] == "replace" and d["replica"] == "r0"
        clk.advance(0.1)
        _round(ctl, gw, clk, trace)
        with pytest.raises(KeyError):
            gw.breaker_state("r0")                   # retired with it
        return trace, be.stopped, len(be.started), ev.events

    trace, stopped, started, events = _both(script)
    rids = trace[-1][3]
    assert "r0" not in rids and len(rids) == 2
    assert stopped == ["r0"] and started == 1
    assert trace[-1][1]["desired_replicas"] == 2
    assert [e for e, _ in events].count("autoscale_replace") == 1


# -------------------------------------------------------------- brownout


def _ladder_walk(P, clk, ctl, gw, eng, trace):
    """Overload at max: the three stages up, a held round, then three
    restores once the load clears."""
    eng._occupied = 4
    for _ in range(4):
        clk.advance(1.1)
        _round(ctl, gw, clk, trace)
    eng._occupied = 0
    for _ in range(3):
        clk.advance(1.1)
        _round(ctl, gw, clk, trace)


def test_brownout_ladder_escalates_and_restores():
    def script(P):
        clk, ev, trace = _Clock(), _Events(), []
        eng = _FakeEngine(replica_id="r0", occupied=4, queue=_ClassedQueue())
        gw = P.gw.ServeGateway([eng], logger=ev, hedge_after_s=0.5)
        ctl = _ctl(P, gw, _Backend(), clk, min_replicas=1, max_replicas=1,
                   sustain_rounds=1, logger=ev)
        d = _round(ctl, gw, clk, trace)
        assert d["decision"] == "brownout" and d["stage"] == "shed_batch"
        assert gw.shed_classes == frozenset({"batch"})
        with pytest.raises(P.QueueFull, match="shed") as err:
            gw.submit(P.Request(prompt=[1, 2], max_new_tokens=2,
                                tenant="bulk"))
        shed_msg = str(err.value)
        gw.submit(P.Request(prompt=[1, 2], max_new_tokens=2, tenant="chat"))
        levers = []
        for _ in range(2):
            clk.advance(1.1)
            _round(ctl, gw, clk, trace)
            levers.append((gw.hedge_after_s, gw.max_live_requests))
        clk.advance(1.1)
        assert _round(ctl, gw, clk, trace)["decision"] == "hold"
        eng._occupied = 0
        for _ in range(3):
            clk.advance(1.1)
            assert _round(ctl, gw, clk, trace)["decision"] == "restore"
        levers.append((gw.shed_classes, gw.hedge_after_s,
                       gw.max_live_requests, ctl.brownout_level()))
        return trace, shed_msg, levers, ev.events

    trace, shed_msg, levers, events = _both(script)
    assert [t[0].get("stage") for t in trace[:3]] == [
        "shed_batch", "no_hedge", "tight_admission"]
    assert levers[0] == (None, None) and levers[1] == (None, 2)
    assert levers[2] == (frozenset(), 0.5, None, 0)
    names = [e for e, _ in events]
    assert names.count("autoscale_brownout") == 3
    assert names.count("autoscale_restored") == 1
    assert names.index("autoscale_restored") > max(
        i for i, n in enumerate(names) if n == "autoscale_brownout")


def test_brownout_second_walk_restores_the_pre_walk_hedge():
    """``no_hedge`` saves and restores ``hedge_after_s``: a second walk
    of the ladder ends on the value from before the first, the levers'
    restore is exact, equal to JAX's."""
    def script(P):
        clk, trace = _Clock(), []
        eng = _FakeEngine(replica_id="r0", queue=_ClassedQueue())
        gw = P.gw.ServeGateway([eng], hedge_after_s=0.25)
        ctl = _ctl(P, gw, _Backend(), clk, min_replicas=1, max_replicas=1,
                   sustain_rounds=1)
        walks = []
        for _ in range(2):
            _ladder_walk(P, clk, ctl, gw, eng, trace)
            walks.append((gw.shed_classes, gw.hedge_after_s,
                          gw.max_live_requests, ctl.brownout_level()))
        return trace, walks

    trace, walks = _both(script)
    assert walks == [(frozenset(), 0.25, None, 0)] * 2
    assert [t[0]["decision"] for t in trace].count("restore") == 6


# ------------------------------------------------------ oscillating load


def test_oscillating_load_is_damped_and_converges():
    def script(P):
        clk, trace = _Clock(), []
        gw, _ = _fleet(P, 1)
        ctl = _ctl(P, gw, _Backend(), clk, min_replicas=1, max_replicas=3,
                   sustain_rounds=1, flap_window_s=100.0,
                   max_flips_per_window=4)
        for i in range(40):
            clk.advance(1.1)
            _set_load(gw, 4 if i % 2 == 0 else 0)
            _round(ctl, gw, clk, trace)
        clk.advance(200.0)
        _set_load(gw, 0)
        for _ in range(12):
            clk.advance(1.1)
            _round(ctl, gw, clk, trace)
            _set_load(gw, 0)
        return trace

    trace = _both(script)
    flips = [t[0]["decision"] for t in trace[:40]
             if t[0]["decision"] in ("up", "down")]
    assert len(flips) <= 4
    assert trace[39][1]["flap_damped_rounds"] > 0
    for _, snap, _, rids in trace[:40]:
        assert 1 <= snap["actual_replicas"] <= 3
    assert len(trace[-1][3]) == 1
    assert trace[-1][1]["actual_replicas"] == 1
    assert trace[-1][1]["desired_replicas"] == 1


def test_maybe_round_rate_limits_to_interval():
    def script(P):
        clk = _Clock()
        gw, _ = _fleet(P, 1)
        ctl = _ctl(P, gw, _Backend(), clk, interval_s=0.5)
        out = [ctl.maybe_round(clk.t)]
        clk.advance(0.1)
        out.append(ctl.maybe_round(clk.t))
        clk.advance(0.5)
        out.append(ctl.maybe_round(clk.t))
        return out, ctl.snapshot()

    out, snap = _both(script)
    assert out[0] is not None and out[1] is None and out[2] is not None
    assert snap["rounds"] == 2


# -------------------------------------- gateway dynamic membership units


def test_add_replica_routes_within_one_step():
    def script(P):
        ev = _Events()
        busy = _FakeEngine(occupied=2)
        gw = P.gw.ServeGateway([busy], logger=ev)
        gw.submit(P.Request(prompt=[1, 2], max_new_tokens=2))
        fresh = _FakeEngine()
        rid = gw.add_replica(fresh)
        state = gw.breaker_state("r1")
        gw.submit(P.Request(prompt=[1, 2], max_new_tokens=2))
        routed = (len(fresh.submitted), len(busy.submitted))
        with pytest.raises(ValueError, match="duplicate replica_id") as err:
            gw.add_replica(_FakeEngine(replica_id="r1"))
        gw.remove_replica("r1")
        return (rid, fresh.replica_id, state, *routed, str(err.value),
                gw.add_replica(_FakeEngine()), ev.events)

    out = _both(script)
    assert out[:5] == ("r1", "r1", "closed", 1, 1)
    assert out[6] == "r2"
    assert [e for e, _ in out[7]].count("gateway_replica_added") == 2


def test_remove_replica_guards_and_force():
    def script(P):
        ev = _Events()
        gw, engines = _fleet(P, 2, logger=ev)
        said = []
        with pytest.raises(ValueError, match="unknown replica") as err:
            gw.remove_replica("r9")
        said.append(str(err.value))
        engines[0]._auto_drain = False
        with pytest.raises(RuntimeError, match="drain") as err:
            gw.remove_replica("r0")
        said.append(str(err.value))
        said.append(engines[0].draining)
        gw.remove_replica("r0", force=True)
        said.append(gw.replica_ids())
        with pytest.raises(ValueError, match="last replica") as err:
            gw.remove_replica("r1")
        said.append(str(err.value))
        return said, ev.events

    said, events = _both(script)
    assert said[2] is True and said[3] == ["r1"]
    assert [e for e, _ in events].count("gateway_replica_removed") == 1


def test_remove_replica_retires_breaker_state():
    def script(P):
        gw, _ = _fleet(P, 2, failures_to_trip=1)
        P.faults.activate(_kill_replica_plan(P, 0))
        try:
            gw.step()
        finally:
            P.faults.deactivate()
        before = gw.breaker_state("r0")
        gw.remove_replica("r0")
        with pytest.raises(KeyError):
            gw.breaker_state("r0")
        return before, gw.snapshot()

    before, snap = _both(script)
    assert before == "open" and "r0" not in snap["replicas"]


# ------------------------------------------ membership on real engines


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=64)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


def _engines(P, tiny, n, stats, **kw):
    jmodel, params, tmodel = tiny
    kw.setdefault("num_slots", 2)
    if P.name == "jax":
        return [JEngine(jmodel, params, eos_id=None, stats=stats,
                        replica_id=f"r{i}", **kw) for i in range(n)]
    return [TEngine(tmodel, device="cpu", eos_id=None, stats=stats,
                    replica_id=f"r{i}", **kw) for i in range(n)]


def _workload(n, seed=3, p_lo=4, p_hi=12, m_lo=8, m_hi=12):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=int(rng.integers(p_lo, p_hi)))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rng.integers(m_lo, m_hi)) for _ in range(n)]


def _drive(gw, outs, max_steps=400):
    for _ in range(max_steps):
        if not gw.busy():
            return
        outs.extend(gw.step())
    raise AssertionError(f"gateway did not finish in {max_steps} steps")


def test_remove_replica_mid_decode_bit_identical(tiny):
    """``remove_replica`` on a replica holding live decodes is
    drain+migrate: every stream, the moved ones included, equals the JAX
    gateway's token ids, nothing is lost, and the member's breaker goes
    with it."""
    prompts, max_news = _workload(4)

    def script(P):
        stats = P.Stats()
        engines = _engines(P, tiny, 2, stats)
        gw = P.gw.ServeGateway(engines, stats=stats)
        reqs = [P.Request(prompt=p, max_new_tokens=m)
                for p, m in zip(prompts, max_news)]
        for r in reqs:
            gw.submit(r)
        loads = [e.load() for e in engines]
        outs = []
        for _ in range(3):
            outs.extend(gw.step())
        occupied = engines[0].occupied_slots()
        gw.remove_replica("r0")
        with pytest.raises(KeyError):
            gw.breaker_state("r0")
        _drive(gw, outs)
        by = {o.request_id: o for o in outs}
        return (loads, occupied, gw.replica_ids(), stats.gateway_migrations,
                [(by[r.request_id].finish_reason,
                  [int(t) for t in by[r.request_id].tokens]) for r in reqs],
                [e.pool.counters()["pages_used"] for e in engines])

    out = _both(script)
    assert out[0] == [2, 2] and out[1] == 2 and out[2] == ["r1"]
    assert out[3] == 2
    assert [len(t) for _, t in out[4]] == max_news
    assert all(reason == "length" for reason, _ in out[4])
    assert out[5] == [0, 0]


def test_add_replica_under_load_routes_within_one_step(tiny):
    """A replica added to a loaded gateway takes the very next submit,
    and one gateway step later it has prefilled it and streamed its
    first token; the streams equal the JAX gateway's."""
    prompts, max_news = _workload(4, seed=5)

    def script(P):
        stats = P.Stats()
        first, fresh = _engines(P, tiny, 2, stats)
        gw = P.gw.ServeGateway([first], stats=stats)
        reqs = [P.Request(prompt=p, max_new_tokens=m)
                for p, m in zip(prompts, max_news)]
        for r in reqs[:3]:
            gw.submit(r)
        outs = list(gw.step())
        rid = gw.add_replica(fresh)
        gw.submit(reqs[3])
        routed = (first.load(), fresh.load())
        outs.extend(gw.step())
        streamed = fresh.occupied_slots()
        _drive(gw, outs)
        by = {o.request_id: o for o in outs}
        return (rid, routed, streamed,
                [[int(t) for t in by[r.request_id].tokens] for r in reqs])

    rid, routed, streamed, streams = _both(script)
    assert rid == "r1" and routed == (3, 1) and streamed == 1
    assert [len(s) for s in streams] == max_news


TENANTS = [{"id": "chat", "priority": "interactive"},
           {"id": "bulk", "priority": "batch"}]


def test_brownout_levers_refuse_on_real_engines(tiny):
    """``shed_classes`` refuses the batch-class tenant at the door (the
    class read from the engines' tenant scheduler) and
    ``max_live_requests`` caps admission, each with JAX's exception and
    words; lifting both admits again."""
    def script(P):
        if P.name == "jax":
            from k8s_distributed_deeplearning_tpu.serve.sched import (
                parse_tenants)
        else:
            from k8s_distributed_deeplearning_torch.serve.sched import (
                parse_tenants)
        tenants = parse_tenants(json.dumps({"tenants": TENANTS}))
        stats = P.Stats()
        gw = P.gw.ServeGateway(_engines(P, tiny, 2, stats, tenants=tenants),
                               stats=stats)
        said = [gw._tenant_class("bulk"), gw._tenant_class("chat"),
                gw._tenant_class("nobody")]
        gw.shed_classes = frozenset({"batch"})
        with pytest.raises(P.QueueFull) as err:
            gw.submit(P.Request(prompt=[1, 2, 3], max_new_tokens=2,
                                tenant="bulk", request_id="b0"))
        said.append(str(err.value))
        gw.submit(P.Request(prompt=[1, 2, 3], max_new_tokens=2,
                            tenant="chat", request_id="c0"))
        gw.max_live_requests = 1
        with pytest.raises(P.QueueFull) as err:
            gw.submit(P.Request(prompt=[4, 5], max_new_tokens=2,
                                tenant="chat", request_id="c1"))
        said.append(str(err.value))
        gw.shed_classes, gw.max_live_requests = frozenset(), None
        gw.submit(P.Request(prompt=[1, 2, 3], max_new_tokens=2,
                            tenant="bulk", request_id="b1"))
        outs = []
        _drive(gw, outs)
        said.append(sorted((o.request_id, [int(t) for t in o.tokens])
                           for o in outs))
        return said

    said = _both(script)
    assert said[:3] == ["batch", "interactive", None]
    assert "is shed (brownout)" in said[3]
    assert "tightened to 1 live requests" in said[4]
    assert [rid for rid, _ in said[5]] == ["b1", "c0"]


# ----------------------------------- discovery, backends, the CLI


def _beacon(hb, directory, rank, ts, addr):
    hb.HeartbeatWriter(directory, rank, clock=lambda: ts).beat(
        step=1, metrics_addr=addr)


def test_discovery_filters_stale_beacons(tmp_path):
    def script(P):
        hb, fleet = (j_hb, j_fleet) if P.name == "jax" else (t_hb, t_fleet)
        d = str(tmp_path / P.name)
        _beacon(hb, d, 0, ts=100.0, addr="127.0.0.1:1111")
        _beacon(hb, d, 1, ts=195.0, addr="127.0.0.1:2222")
        out = [fleet.discover_endpoints(d),
               fleet.discover_endpoints(d, stale_after_s=10.0, now=200.0)]
        w = hb.HeartbeatWriter(d, 1, clock=lambda: 195.0)
        w.remove()
        w.remove()
        out.append(fleet.discover_endpoints(d, stale_after_s=10.0,
                                            now=200.0))
        out.append(os.path.exists(os.path.join(d, "rank-1.json")))
        return out

    out = _both(script)
    assert out == [["127.0.0.1:1111", "127.0.0.1:2222"],
                   ["127.0.0.1:2222"], [], False]


def test_heartbeat_discoverer_hook_yields_each_endpoint_once(tmp_path):
    now = time.time()

    def script(P):
        hb = j_hb if P.name == "jax" else t_hb
        d = str(tmp_path / P.name)
        _beacon(hb, d, 0, ts=now, addr="127.0.0.1:1111")
        _beacon(hb, d, 1, ts=now - 60.0, addr="127.0.0.1:2222")
        hook = P.auto.heartbeat_discoverer(d, stale_after_s=10.0)
        out = [[c.endpoint for c in hook(known_rids=[])], hook([])]
        _beacon(hb, d, 2, ts=now, addr="127.0.0.1:3333")
        out.append([c.endpoint for c in hook([])])
        return out

    out = _both(script)
    assert out == [["http://127.0.0.1:1111"], [], ["http://127.0.0.1:3333"]]


def test_k8s_backend_patches_parallelism_and_names_victim():
    """The backend over a fake kubectl, then the port's own ``Kubectl``
    over a scripted runner: the patch argv equals JAX's, and a failed
    patch surfaces as the OSError the controller counts."""
    def script(P):
        calls = []

        class _Kubectl:
            def patch_job(self, name, namespace, patch):
                calls.append((name, namespace, json.loads(patch)))

        be = P.auto.K8sParallelismBackend(
            _Kubectl(), "svc-replica", "prod", initial_replicas=2,
            endpoint_template="svc-replica-{i}.svc-replica.prod:9100")
        client = be.start_replica()
        be.stop_replica("r2", _FakeEngine())
        watch = j_watch if P.name == "jax" else t_watch
        argv = []

        def runner(args, input_text):
            argv.append(args)
            return (1, "", "forbidden") if len(argv) == 2 else (0, "", "")

        k = watch.Kubectl(runner=runner)
        be2 = P.auto.K8sParallelismBackend(k, "j", "ns")
        be2.start_replica()
        with pytest.raises(OSError) as err:
            be2.stop_replica("r1", _FakeEngine())
        return (calls, client.replica_id, client.endpoint,
                be.victim_rid(["r0", "r2", "r1"]), be.victim_rid([]),
                argv, str(err.value))

    out = _both(script)
    assert out[0] == [("svc-replica", "prod",
                       {"spec": {"parallelism": 3, "completions": 3}}),
                      ("svc-replica", "prod",
                       {"spec": {"parallelism": 2, "completions": 2}})]
    assert out[1:5] == ("r2", "http://svc-replica-2.svc-replica.prod:9100",
                        "r2", None)
    assert out[5][0][:3] == ["patch", "job", "j"]


def test_local_process_backend_spawns_and_stops_a_replica_server(
        tmp_path, tiny, monkeypatch):
    """``LocalProcessBackend`` spawns one port replica server (``python -m
    k8s_distributed_deeplearning_torch.launch serve --replica-server`` on
    the CPU), hands its client to a gateway that serves a greedy request
    through it, and stops it: the child drains, prints
    ``replica_drained`` and exits 0."""
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    hb_dir, log = str(tmp_path / "hb"), tmp_path / "replica-0.log"
    procs, popen = [], subprocess.Popen

    def logged_popen(cmd, **kw):
        # The backend discards the child's output; keep it for the check.
        with open(log, "w") as f:
            procs.append(popen(cmd, stdout=f, stderr=subprocess.STDOUT))
        return procs[-1]

    monkeypatch.setattr(t_auto.subprocess, "Popen", logged_popen)
    be = t_auto.LocalProcessBackend(
        hb_dir, preset="tiny", slots=2,
        extra_args=("--device", "cpu", "--max-seq-len", "64"))
    try:
        client = be.start_replica()
        assert client.replica_id == "r0"
        stats = TStats()
        gw = t_gateway.ServeGateway([client], stats=stats)
        outs = []
        gw.submit(TRequest(prompt=[5, 6, 7, 8], max_new_tokens=5,
                           request_id="w0"))
        for _ in range(2000):
            outs.extend(gw.step())
            if outs:
                break
            time.sleep(0.005)
        assert [o.finish_reason for o in outs] == ["length"]
        assert len(outs[0].tokens) == 5
        assert t_fleet.discover_endpoints(hb_dir) == [
            client.endpoint.split("://")[1]]
        be.stop_replica("r0", client)
    finally:
        be.reap_all()
    assert [p.returncode for p in procs] == [0]
    assert '"event": "replica_drained"' in log.read_text()


def test_cli_brownout_literal_matches_ladder():
    """The CLI checks --autoscale-brownout against a literal copy of
    BROWNOUT_STAGE_NAMES before any heavy import; the two agree."""
    m = re.search(r"known = (\([^)]*\))", inspect.getsource(t_cli))
    assert m, "cli.py lost its literal brownout tuple"
    assert ast.literal_eval(m.group(1)) == t_auto.BROWNOUT_STAGE_NAMES


def _cli_error(main, argv):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as ex:
        main(argv)
    assert ex.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


AUTOSCALE_REJECTED = {
    "disagg_prefill": ["--autoscale", "--disagg-prefill", "1"],
    "replica_server": ["--autoscale", "--replica-server",
                       "--metrics-port", "0"],
    "min_zero": ["--autoscale", "--autoscale-min", "0"],
    "min_over_max": ["--autoscale", "--autoscale-min", "3",
                     "--autoscale-max", "2"],
    "up_cooldown": ["--autoscale", "--autoscale-up-cooldown-s", "0"],
    "down_cooldown": ["--autoscale", "--autoscale-down-cooldown-s", "-1"],
    "brownout_typo": ["--autoscale", "--autoscale-brownout",
                      "shed_batch,warp_speed"],
    "k8s_local": ["--autoscale", "--autoscale-k8s-job", "svc-replica"],
    "static_list": ["--autoscale", "--replica-endpoints", "127.0.0.1:1"],
    "k8s_no_autoscale": ["--autoscale-k8s-job", "svc-replica"],
    "template_no_autoscale": ["--autoscale-endpoint-template", "h-{i}:1"],
}


@pytest.mark.parametrize("case", sorted(AUTOSCALE_REJECTED))
def test_cli_autoscale_rejections_equal_jax(case):
    """Each ``--autoscale*`` combination the JAX CLI rejects, the port's
    rejects with the same message."""
    argv = AUTOSCALE_REJECTED[case]
    said = _cli_error(t_cli.main, ["--device", "cpu"] + argv)
    assert said == _cli_error(j_cli.main, argv)


def test_cli_autoscale_scales_and_summarizes(capsys):
    """``--autoscale`` over local engines on the CPU: the queue scales the
    fleet up within the ceiling, every request finishes, and
    ``autoscale_summary`` carries the controller's snapshot keys."""
    assert t_cli.main([
        "--device", "cpu", "--autoscale", "--autoscale-max", "3",
        "--requests", "10", "--slots", "2", "--max-seq-len", "64",
        "--prompt-len", "4", "8", "--out-len", "6", "10",
        "--autoscale-interval-s", "0.0001",
        "--autoscale-up-cooldown-s", "0.0001",
        "--autoscale-down-cooldown-s", "1000"]) == 0
    events = [json.loads(line) for line in capsys.readouterr().out
              .splitlines() if line.startswith("{")]
    names = [e["event"] for e in events]
    assert names.count("serve_request") == 10
    assert "autoscale_up" in names and "gateway_replica_added" in names
    summ = events[-1]
    assert summ["event"] == "autoscale_summary"
    clk, gw = _Clock(), _fleet(PKGS[0], 1)[0]
    keys = set(j_auto.FleetController(gw, _Backend(), clock=clk).snapshot())
    assert keys <= set(summ)
    assert 2 <= summ["actual_replicas"] <= 3
    assert summ["decisions"]["up"] >= 1


def test_bridge_autoscale_collector_equals_jax():
    """The seven ``serve_autoscale_*`` families render byte for byte as
    JAX's over the same controller state."""
    def script(P):
        reg_mod, bridge = ((j_reg, j_bridge) if P.name == "jax"
                           else (t_reg, t_bridge))
        clk = _Clock()
        gw, _ = _fleet(P, 1, occupied=4)
        ctl = _ctl(P, gw, _Backend(), clk, max_replicas=2)
        for _ in range(3):
            clk.advance(1.1)
            ctl.control_round(clk.t)
        reg = reg_mod.MetricsRegistry()
        bridge.autoscale_collector(reg, ctl)
        return reg.render()

    text = _both(script)
    fams = {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")}
    assert len(fams) == 7 and all(f.startswith("serve_autoscale_")
                                  for f in fams)


def test_storm_autoscale_report_equals_jax(tiny):
    """``run_storm(StormConfig(autoscale=True))`` over the port's engines:
    no violation, the controller actuated under ``autoscale_actuate``
    faults, and the report equals JAX's field for field (the repro line
    names each package's entry point)."""
    jmodel, params, tmodel = tiny
    reports = {}
    for name, mod in (("jax", j_storm), ("torch", t_storm)):
        cfg = mod.StormConfig(seed=6, steps=24, autoscale=True,
                              prompt_len=(4, 16), out_len=(4, 12),
                              vocab=256, arrival_rate=2.0)
        if name == "jax":
            def mk(i, cfg=cfg):
                return JEngine(jmodel, params, num_slots=2,
                               max_queue=cfg.max_queue,
                               tenants=cfg.tenant_configs(),
                               replica_id=f"s{i}" if i >= 0 else "oracle")
        else:
            def mk(i, cfg=cfg):
                return TEngine(tmodel, num_slots=2, max_queue=cfg.max_queue,
                               tenants=cfg.tenant_configs(),
                               replica_id=f"s{i}" if i >= 0 else "oracle",
                               device="cpu")
        rep = mod.run_storm(cfg, make_engine=mk)
        d = rep.to_dict()
        d.pop("repro")
        reports[name] = d
    rep = reports["torch"]
    assert rep == reports["jax"]
    assert rep["violations"] == [] and rep["submitted"] == rep["finished"]
    assert "autoscale_actuate" in rep["distinct_sites"]
