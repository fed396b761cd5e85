"""PyTorch port, the multi-tenant scheduler: the port's
``TenantScheduler`` against JAX's on the same operations with one
injected clock each (a hypothesis-drawn sequence of submits, requeues,
pops with a ``fits`` probe, releases, sweeps, removals and clock
advances over tenants with priorities, weights, token buckets, slot
quotas and deadlines: every result equal), the tenant config's errors
message for message, and the engine's admission order under tenants
against the JAX engine's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import QueueFull as TQueueFull
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import sched as t_sched
from k8s_distributed_deeplearning_torch.telemetry.slo import (
    SLOTarget as TSLOTarget)
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import QueueFull as JQueueFull
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import sched as j_sched
from k8s_distributed_deeplearning_tpu.telemetry.slo import (
    SLOTarget as JSLOTarget)

torch.set_num_threads(2)

# Tenants of the drawn sequences: every policy knob in play.
TENANTS = [
    dict(tenant_id="chat", priority="interactive", weight=2.0,
         rate_tokens_per_s=40.0, burst_tokens=60.0, max_slots=2),
    dict(tenant_id="api", priority="normal", weight=3.0, max_queue=3),
    dict(tenant_id="web", priority="normal", weight=1.0,
         rate_tokens_per_s=25.0),
    dict(tenant_id="bulk", priority="batch", max_slots=1, max_queue=4),
]


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _schedulers(default_max_queue=5):
    out = []
    for mod in (t_sched, j_sched):
        clock = FakeClock()
        cfgs = [mod.TenantConfig(**kw) for kw in TENANTS]
        out.append((mod.TenantScheduler(cfgs, clock=clock,
                                        default_max_queue=default_max_queue),
                    clock))
    return out


def _outcome(fn):
    """A call's result, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        kind = ("QueueFull" if isinstance(e, (TQueueFull, JQueueFull))
                else type(e).__name__)
        return (kind, str(e))


def _ids(reqs):
    if reqs is None:
        return None
    if isinstance(reqs, list):
        return [r.request_id for r in reqs]
    return reqs.request_id


OPS = st.lists(st.tuples(
    st.sampled_from(["submit", "submit", "submit", "pop", "pop",
                     "requeue", "release", "sweep", "remove", "advance"]),
    st.integers(0, 4),                 # tenant (4 = unregistered)
    st.integers(1, 40),                # prompt length
    st.integers(1, 30),                # max_new_tokens
    st.sampled_from([None, None, 0.5, 2.0, 5.0]),   # deadline_s
    st.integers(0, 80)),               # fits limit / clock step (x 0.05 s)
    min_size=1, max_size=60)


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS)
def test_pop_order_equals_jax(ops):
    """One drawn sequence on both schedulers: each pop returns the same
    request (or None), each submit the same QueueFull or error, each
    sweep and removal the same requests, and after every operation the
    same length and snapshot."""
    (ts, tclock), (js, jclock) = _schedulers()
    live: dict[str, tuple] = {}       # request id -> (port req, JAX req)
    popped: list[str] = []
    n = 0
    names = [kw["tenant_id"] for kw in TENANTS] + ["ghost"]
    for op, tenant, plen, new, dl, x in ops:
        if op in ("submit", "requeue") and (op == "submit" or popped):
            if op == "submit":
                rid = f"q{n}"
                n += 1
                pair = tuple(cls(prompt=[1] * plen, max_new_tokens=new,
                                 tenant=names[tenant], deadline_s=dl,
                                 request_id=rid)
                             for cls in (TRequest, JRequest))
                live[rid] = pair
                got = (_outcome(lambda: ts.submit(pair[0])),
                       _outcome(lambda: js.submit(pair[1])))
            else:
                rid = popped.pop(x % len(popped))
                pair = live[rid]
                got = (_outcome(lambda: ts.requeue(pair[0])),
                       _outcome(lambda: js.requeue(pair[1])))
        elif op == "pop":
            limit = 10 + x

            def fits(req, limit=limit):
                return len(req.prompt) + req.max_new_tokens <= limit

            got = (_ids(ts.pop(fits=fits if x % 3 else None)),
                   _ids(js.pop(fits=fits if x % 3 else None)))
            if got[0] is not None:
                popped.append(got[0])
        elif op == "release" and popped:
            pair = live[popped.pop(x % len(popped))]
            ts.release(pair[0])
            js.release(pair[1])
            got = (None, None)
        elif op == "sweep":
            got = (_ids(ts.sweep_expired()), _ids(js.sweep_expired()))
        elif op == "remove" and n:
            rid = f"q{x % n}"
            got = (_ids(ts.remove(rid)), _ids(js.remove(rid)))
        else:
            tclock.t += 0.05 * x
            jclock.t += 0.05 * x
            got = (None, None)
        assert got[0] == got[1], (op, got)
        assert len(ts) == len(js)
        assert ts.snapshot() == js.snapshot()
        assert ts.depths() == js.depths()
    assert _ids(ts.drain()) == _ids(js.drain())


def test_default_tenant_is_fifo_and_drain_keeps_submit_order():
    for mod, cls in ((t_sched, TRequest), (j_sched, JRequest)):
        s = mod.TenantScheduler(clock=FakeClock())
        reqs = [cls(prompt=[1] * (i + 1), max_new_tokens=2,
                    request_id=f"f{i}") for i in range(5)]
        for r in reqs:
            s.submit(r)
        assert _ids(s.pop()) == "f0"
        assert _ids(s.drain()) == [f"f{i}" for i in range(1, 5)]
        assert s.tenant_ids() == ("default",)
        assert s.priority_of(None) == "normal"


BAD_CONFIGS = [
    dict(tenant_id=""), dict(tenant_id="a", priority="urgent"),
    dict(tenant_id="a", weight=0), dict(tenant_id="a", rate_tokens_per_s=-1),
    dict(tenant_id="a", burst_tokens=100),
    dict(tenant_id="a", rate_tokens_per_s=5, burst_tokens=0),
    dict(tenant_id="a", max_slots=0), dict(tenant_id="a", max_queue=0),
    dict(tenant_id="a", slo="fast"),
    dict(tenant_id="a", slo={"availability": 1.0}),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_tenant_config_errors_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        j_sched.TenantConfig(**kw)
    with pytest.raises(ValueError) as got:
        t_sched.TenantConfig(**kw)
    assert str(got.value) == str(want.value)


BAD_SPECS = [
    "not json", "[]", '{"tenants": []}', '{"tenants": ["x"]}',
    '{"tenants": [{"priority": "batch"}]}',
    '{"tenants": [{"id": "a", "color": "red"}]}',
    '{"tenants": [{"id": "a"}, {"id": "a"}]}',
    '{"tenants": [{"id": "a", "weight": -2}]}',
    '{"tenants": [{"id": "a", "max_slots": "two"}]}',
    '{"tenants": [{"id": "a", "slo": {"availability": 0.9, "p99": 1}}]}',
    '{"tenants": [{"id": "a", "slo": {"window_s": 0}}]}',
]


@pytest.mark.parametrize("spec", BAD_SPECS,
                         ids=[str(i) for i in range(len(BAD_SPECS))])
def test_parse_tenants_errors_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        j_sched.parse_tenants(spec)
    with pytest.raises((ValueError, TypeError)) as got:
        t_sched.parse_tenants(spec)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_load_tenants_inline_and_file(tmp_path):
    doc = json.dumps({"tenants": [
        {"id": "chat", "priority": "interactive", "weight": 4,
         "rate_tokens_per_s": 2000, "burst_tokens": 8000, "max_slots": 6,
         "max_queue": 64, "slo": {"availability": 0.999,
                                  "latency_p95_ms": 250}},
        {"id": "backfill", "priority": "batch"}]})
    path = tmp_path / "tenants.json"
    path.write_text(doc)
    for spec in (doc, f"@{path}"):
        got = t_sched.load_tenants(spec)
        want = j_sched.load_tenants(spec)
        assert [(c.tenant_id, c.priority, c.weight, c.burst, c.max_slots,
                 c.max_queue) for c in got] == [
            (c.tenant_id, c.priority, c.weight, c.burst, c.max_slots,
             c.max_queue) for c in want]
        assert got[0].slo.to_dict() == want[0].slo.to_dict()
        assert isinstance(got[0].slo, TSLOTarget)
    with pytest.raises(OSError):
        t_sched.load_tenants(f"@{tmp_path}/missing.json")
    assert TSLOTarget(0.99).error_budget == JSLOTarget(0.99).error_budget


# ------------------------------------------------------ engine admission


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


def _mixed(cls, n_bulk=8, n_chat=3):
    rng = np.random.default_rng(4)
    reqs = [cls(prompt=rng.integers(0, 256, 6 + i % 3).astype(np.int32),
                max_new_tokens=6, tenant="bulk", request_id=f"b{i}")
            for i in range(n_bulk)]
    reqs += [cls(prompt=rng.integers(0, 256, 5).astype(np.int32),
                 max_new_tokens=3, tenant="chat", request_id=f"c{i}")
             for i in range(n_chat)]
    return reqs


def test_slot_quota_and_priority_admission_equal_jax(tiny):
    """An interactive tenant beside a batch tenant capped at 2 of 3
    slots, everything submitted up front: the completion order, streams,
    queue waits' order and per-tenant counters equal the JAX engine's,
    and the batch tenant never holds more than its quota."""
    jmodel, params, tmodel = tiny
    spec = json.dumps({"tenants": [
        {"id": "chat", "priority": "interactive"},
        {"id": "bulk", "priority": "batch", "max_slots": 2}]})
    runs = []
    for eng, cls in ((JEngine(jmodel, params, num_slots=3, max_queue=64,
                              tenants=j_sched.parse_tenants(spec)),
                      JRequest),
                     (TEngine(tmodel, num_slots=3, max_queue=64,
                              tenants=t_sched.parse_tenants(spec),
                              device="cpu"), TRequest)):
        for r in _mixed(cls):
            eng.submit(r)
        done = []
        while eng.busy():
            done.extend(eng.step())
            assert eng.queue.snapshot()["tenants"]["bulk"]["in_flight"] <= 2
        snap = eng.queue.snapshot()["tenants"]
        runs.append(([(o.request_id, o.tokens, o.finish_reason)
                      for o in done],
                     {t: (s["popped_total"], s["in_flight"], s["shed_total"])
                      for t, s in snap.items()}))
    assert runs[0] == runs[1]
    assert runs[1][1] == {"chat": (3, 0, 0), "bulk": (8, 0, 0)}
    assert eng._check_page_leaks("test") is None


def test_per_tenant_back_pressure_equals_jax(tiny):
    """A tenant's own queue bound sheds only that tenant, with JAX's
    message; an unregistered tenant is refused with JAX's message."""
    jmodel, params, tmodel = tiny
    cfg = dict(tenant_id="bulk", priority="batch", max_queue=2)
    errors = []
    for eng, cls, mod in (
            (JEngine(jmodel, params, num_slots=2, max_queue=8,
                     tenants=[j_sched.TenantConfig("chat"),
                              j_sched.TenantConfig(**cfg)]),
             JRequest, j_sched),
            (TEngine(tmodel, num_slots=2, max_queue=8, device="cpu",
                     tenants=[t_sched.TenantConfig("chat"),
                              t_sched.TenantConfig(**cfg)]),
             TRequest, t_sched)):
        got = []
        for i in range(3):
            got.append(_outcome(lambda: eng.submit(cls(
                prompt=[1, 2, 3], max_new_tokens=2, tenant="bulk",
                request_id=f"b{i}"))))
        got.append(_outcome(lambda: eng.submit(cls(
            prompt=[1, 2, 3], max_new_tokens=2, tenant="chat",
            request_id="c0"))))
        got.append(_outcome(lambda: eng.submit(cls(
            prompt=[1, 2, 3], max_new_tokens=2, tenant="nobody",
            request_id="x0"))))
        got.append(sorted(o.request_id for o in eng.run()))
        errors.append(got)
    assert errors[0] == errors[1]
    assert errors[1][2][0] == "QueueFull" and errors[1][4][0] == "ValueError"
