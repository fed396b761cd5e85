"""PyTorch port, the fleet's telemetry and fault plans against the JAX
package: a fault plan's JSON and its validation equal JAX's (every site
validates, those with no caller in the port too); a port flight dump is
read by JAX's ``load_dump`` (also the engine's dumps on a drain and on an
injected ``serve_decode`` fault); ``SLOEngine``'s burn rates, alerts and
events equal JAX's on the same observations; the engines' leak events
name the replica and carry JAX's fields; the page pool's owner ledger is
JAX's; ``Request.resume_from_tokens`` keeps the trace id.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch import faults as t_faults
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import page_pool as t_pool
from k8s_distributed_deeplearning_torch.serve import TenantConfig as TTenant
from k8s_distributed_deeplearning_torch.telemetry import fleet as t_fleet
from k8s_distributed_deeplearning_torch.telemetry import slo as t_slo
from k8s_distributed_deeplearning_torch.telemetry.flight import (
    FlightRecorder as TFlight)
from k8s_distributed_deeplearning_tpu import faults as j_faults
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import page_pool as j_pool
from k8s_distributed_deeplearning_tpu.serve import TenantConfig as JTenant
from k8s_distributed_deeplearning_tpu.telemetry import fleet as j_fleet
from k8s_distributed_deeplearning_tpu.telemetry import slo as j_slo
from k8s_distributed_deeplearning_tpu.telemetry.flight import (
    FlightRecorder as JFlight)
from k8s_distributed_deeplearning_tpu.telemetry.flight import load_dump

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    for f in (t_faults, j_faults):
        f.deactivate()
    yield
    for f in (t_faults, j_faults):
        f.deactivate()


# ----------------------------------------------------------- fault plans


def _every_site_plan(faults):
    """One valid fault at every site, step-, visit- and p-triggered."""
    recs = []
    for i, site in enumerate(faults.SITES):
        action = faults.plan._SITE_ACTIONS[site][0]
        kw = dict(site=site, action=action)
        if action in ("stall", "partition"):
            kw["seconds"] = 0.5
        if site == "executor":
            kw.update(rank=1, seconds=2.0)
        elif i % 3 == 0:
            kw["step"] = i
        elif i % 3 == 1:
            kw.update(after=2, count=3)
        else:
            kw.update(p=0.25, count=2)
        recs.append(faults.Fault(**kw))
    return faults.FaultPlan(faults=tuple(recs), seed=17)


def test_fault_plan_json_round_trips_equal_to_jax():
    """Every site, including those with no caller in the port yet
    (training, executor, wire transport, autoscale), validates; the JSON
    is JAX's byte for byte and each package parses the other's."""
    assert t_faults.SITES == j_faults.SITES
    assert t_faults.ACTIONS == j_faults.ACTIONS
    tp, jp = _every_site_plan(t_faults), _every_site_plan(j_faults)
    assert tp.problems() == jp.problems() == []
    assert tp.to_json() == jp.to_json()
    assert t_faults.FaultPlan.from_json(jp.to_json()) == tp
    assert j_faults.FaultPlan.from_json(tp.to_json()) == jp
    old = t_faults.FaultPlan((t_faults.Fault(site="serve_decode",
                                             action="stall", seconds=0.1),))
    assert "seed" not in json.loads(old.to_json())


BAD = [
    dict(site="nowhere", action="stall"),
    dict(site="serve_decode", action="truncate"),
    dict(site="serve_decode", action="stall"),
    dict(site="executor", action="exit", step=3),
    dict(site="gateway_dispatch", action="ioerror", count=0, after=-1),
    dict(site="serve_decode", action="stall", seconds=1.0, p=1.5),
    dict(site="serve_decode", action="stall", seconds=1.0, p=0.5, step=2),
    dict(site="transport_pages", action="partition"),
]


@pytest.mark.parametrize("rec", BAD, ids=[str(i) for i in range(len(BAD))])
def test_fault_plan_validation_messages_equal_jax(rec):
    errs = []
    for faults in (t_faults, j_faults):
        plan = faults.FaultPlan((faults.Fault(**rec),))
        errs.append(plan.problems())
        with pytest.raises(ValueError, match="invalid fault plan"):
            plan.validate_or_raise()
    assert errs[0] == errs[1] and errs[0]


@pytest.mark.parametrize("text", [
    "not json", '{"faults": 3}', '{"faults": [], "extra": 1}',
    '{"faults": [{"site": "step", "action": "exit", "bogus": 1}]}'])
def test_fault_plan_parse_errors_equal_jax(text):
    said = []
    for faults in (t_faults, j_faults):
        with pytest.raises(ValueError) as err:
            faults.FaultPlan.from_json(text)
        said.append(str(err.value).split(":")[0])
    assert said[0] == said[1]


# -------------------------------------------------------- flight recorder


def test_port_flight_dump_is_read_by_jax_load_dump(tmp_path):
    fr = TFlight(4, dump_dir=str(tmp_path), job="r9")
    for i in range(6):
        fr.record("engine:r9", step=i, pool={"used": i})
    path = fr.dump("drain", extra={"replica": "r9", "flight": 7})
    header, records = load_dump(path)
    assert header["flight"] == 1 and header["reason"] == "drain"
    assert header["job"] == "r9" and header["records"] == 4
    assert header["replica"] == "r9"
    assert [r["step"] for r in records] == [2, 3, 4, 5]
    assert records == fr.last_dump["records"]
    assert all(r["source"] == "engine:r9" for r in records)
    off = TFlight(0)
    off.record("x", a=1)
    assert off.snapshot() == [] and off.dump("fault") is None


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


def test_engine_flight_dumps_on_drain_and_fault(tiny, tmp_path):
    """An engine with a recorder snapshots every step, dumps on a
    finished drain (with the pool's ledger) and, through the fire hook,
    on an injected ``serve_decode`` fault before its action runs; the
    dumps carry the records and header keys JAX's engine writes."""
    jmodel, params, tmodel = tiny
    keys = {}
    for side in ("jax", "torch"):
        fr = (TFlight if side == "torch" else JFlight)(
            32, dump_dir=str(tmp_path / side), job=side)
        if side == "torch":
            eng = TEngine(tmodel, num_slots=2, device="cpu", flight=fr,
                          replica_id="r1")
            faults, req = t_faults, TRequest
        else:
            eng = JEngine(jmodel, params, num_slots=2, flight=fr,
                          replica_id="r1")
            faults, req = j_faults, JRequest
        slept = []
        faults.activate(faults.FaultPlan((faults.Fault(
            site="serve_decode", action="stall", seconds=0.25, after=1,
            count=1),)), sleep=slept.append)
        eng.submit(req(prompt=[1, 2, 3, 4], max_new_tokens=4))
        eng.drain()
        while eng.busy():
            eng.step()
        faults.deactivate()
        assert slept == [0.25]
        dumps = [load_dump(p) for p in fr.dumps]
        assert [h["reason"] for h, _ in dumps] == ["fault", "drain"]
        fault, drain = dumps
        assert fault[0]["site"] == "serve_decode"
        assert drain[0]["replica"] == "r1" and drain[0].get("leak") is None
        assert drain[0]["pool"]["pages_used"] == 0
        keys[side] = (sorted(fault[0]), sorted(drain[0]),
                      sorted(drain[1][-1]), len(drain[1]),
                      drain[0]["pages_by_owner"])
    assert keys["torch"] == keys["jax"]


# ------------------------------------------------------------------- SLO


def _observe_script(mod):
    t = [1000.0]
    emitted = []
    eng = mod.SLOEngine(
        {"a": mod.SLOTarget(availability=0.99, latency_p95_ms=200.0,
                            window_s=120.0),
         "b": mod.SLOTarget(availability=0.9, window_s=60.0)},
        emit=lambda ev, **f: emitted.append((ev, f)), clock=lambda: t[0])
    seen = []
    fin = {"a": {}, "b": {}}
    rng = np.random.default_rng(4)
    for step in range(60):
        t[0] += 2.5
        for tenant in fin:
            for reason in ("length", "eos", "timeout", "shed"):
                bump = int(rng.integers(0, 4 if reason in ("length", "eos")
                                        else (3 if 20 <= step < 30 else 1)))
                fin[tenant][reason] = fin[tenant].get(reason, 0) + bump
        if step == 40:
            fin["b"] = {"length": 1}            # a replica restart
        eng.observe(finished={k: dict(v) for k, v in fin.items()},
                    queue_wait_p95_ms={"a": 350.0 if 25 <= step < 35
                                       else 50.0, "zz": 9.0})
        alerts = eng.evaluate()
        seen.append(([dataclasses.asdict(a) for a in alerts],
                     round(eng.burn_rate("a", "availability", "fast"), 9),
                     round(eng.burn_rate("a", "latency", "slow"), 9)))
    return seen, emitted, eng.snapshot()


def test_slo_engine_equals_jax():
    tseen, temitted, tsnap = _observe_script(t_slo)
    jseen, jemitted, jsnap = _observe_script(j_slo)
    assert tseen == jseen and temitted == jemitted and tsnap == jsnap
    kinds = [e for e, _ in temitted]
    assert "slo_alert" in kinds and "slo_recovered" in kinds


def test_objectives_from_tenants_equal_jax():
    spec = [dict(tenant_id="a", slo={"availability": 0.95}),
            dict(tenant_id="b")]
    tcfgs = [TTenant(tenant_id=s["tenant_id"],
                     slo=t_slo.SLOTarget.from_dict(s["slo"])
                     if "slo" in s else None) for s in spec]
    jcfgs = [JTenant(tenant_id=s["tenant_id"],
                     slo=j_slo.SLOTarget.from_dict(s["slo"])
                     if "slo" in s else None) for s in spec]
    got = {k: v.to_dict() for k, v in
           t_slo.objectives_from_tenants(tcfgs).items()}
    want = {k: v.to_dict() for k, v in
            j_slo.objectives_from_tenants(jcfgs).items()}
    assert got == want == {"a": {"availability": 0.95, "window_s": 3600.0}}
    assert dataclasses.asdict(t_fleet.HealthPolicy()) == \
        dataclasses.asdict(j_fleet.HealthPolicy())


# ------------------------------------------------------- leaks, ledger


class _Log:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))


def test_leak_event_names_the_replica_as_jax(tiny):
    """A page held after every request is terminal: both engines emit
    ``kv_page_leak`` naming the replica, with the same fields and
    counts."""
    jmodel, params, tmodel = tiny
    got = {}
    for side in ("jax", "torch"):
        log = _Log()
        if side == "torch":
            eng = TEngine(tmodel, num_slots=2, device="cpu",
                          replica_id="r7", request_log=log)
        else:
            eng = JEngine(jmodel, params, num_slots=2, replica_id="r7",
                          request_log=log)
        stray = eng.pool.alloc(2, owner="imported")
        eng.pool.reserve(1)
        eng.shutdown()
        (event, fields), = [e for e in log.events if e[0] == "kv_page_leak"]
        assert fields["replica"] == "r7"
        assert fields["pages_held"] == {"imported": sorted(stray)}
        got[side] = fields
    assert got["torch"] == got["jax"]


def test_page_pool_owner_ledger_equals_jax():
    assert t_pool.OWNERS == j_pool.OWNERS
    seen = []
    for mod in (t_pool, j_pool):
        pool = mod.PagePool(9, 4)
        a = pool.alloc(2)
        b = pool.alloc(3, owner="imported")
        pool.reserve(2)
        g = pool.alloc_reserved(1, owner="draft")
        pool.ref(a[0])
        pool.tag(a[0], "trie")
        pool.deref(b[1])
        seen.append((a, b, g, pool.owners_summary(), pool.held_pages(),
                     pool.counters()))
    assert seen[0] == seen[1]


def test_resume_from_tokens_keeps_identity():
    r = TRequest(prompt=[1, 2, 3], max_new_tokens=5, seed=9,
                 tenant="default", deadline_s=3.0)
    s = r.resume_from_tokens([7, 8], migrated_from="r0")
    assert s.prompt == [1, 2, 3, 7, 8] and s.max_new_tokens == 3
    assert (s.request_id, s.trace_id, s.seed, s.migrated_from) == (
        r.request_id, r.trace_id, 9, "r0")
    assert r.trace_id.startswith("tr-") and r.migrated_from is None
    assert TRequest(prompt=[1], max_new_tokens=1).trace_id != r.trace_id
    with pytest.raises(ValueError, match="nothing left to resume"):
        r.resume_from_tokens([1, 2, 3, 4, 5])
