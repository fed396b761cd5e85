"""PyTorch port, the chaos soak (``serve/storm.py``) against the JAX
package's: the traffic, the fault schedule and the injector's firing
sequence equal JAX's for the same seed; ``run_storm`` over the port's
engines (tiny topology, f32, 64 positions) in the gateway and the disagg
topologies holds every invariant, and its report equals JAX's
``run_storm`` on the same config and weights, count for count; a planted
KV page leak is caught; the autoscaled topology runs; the soak's CLI
runs on the CPU.
"""
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_distributed_deeplearning_torch import faults as t_faults
from k8s_distributed_deeplearning_torch.faults import inject as t_inject
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import storm as t_storm
from k8s_distributed_deeplearning_tpu import faults as j_faults
from k8s_distributed_deeplearning_tpu.faults import inject as j_inject
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import storm as j_storm
from k8s_distributed_deeplearning_tpu.serve.engine import (
    ServeEngine as JEngine)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    for f in (t_faults, j_faults):
        f.deactivate()
    yield
    for f in (t_faults, j_faults):
        f.deactivate()


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


CONFIGS = {
    "default": {},
    "disagg": dict(prefill=1, replicas=1),
    "autoscale": dict(autoscale=True, seed=9),
    "sampled": dict(seed=11, sampled_fraction=0.4, arrival_rate=2.5,
                    shared_prefix_rate=0.6),
    "sites": dict(seed=2, fault_sites=("transport_send", "transport_recv",
                                       "gateway_dispatch"),
                  faults_per_site=3, fault_rate=(0.2, 0.6)),
}


def _cfgs(kind):
    kw = dict(seed=5, steps=40)
    kw.update(CONFIGS[kind])
    return j_storm.StormConfig(**kw), t_storm.StormConfig(**kw)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_traffic_and_fault_plan_equal_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    assert t_storm.generate_traffic(tcfg) == j_storm.generate_traffic(jcfg)
    assert len(t_storm.generate_traffic(tcfg)) > 0
    assert t_storm.default_sites(tcfg) == j_storm.default_sites(jcfg)
    tp, jp = t_storm.build_fault_plan(tcfg), j_storm.build_fault_plan(jcfg)
    assert tp.to_json() == jp.to_json() and tp.problems() == []
    assert (t_faults.FaultPlan.from_json(jp.to_json()) == tp)


def test_injector_firing_sequence_replays_and_equals_jax():
    """The same plan fires on the same visits in both packages (the
    per-fault streams are seeded by plan seed, fault index and rank), and
    a replay fires the same sequence."""
    def fired(inject, faults):
        plan = faults.FaultPlan(faults=(
            faults.Fault(site="serve_decode", action="stall", p=0.3,
                         count=4, seconds=0.01),
            faults.Fault(site="gateway_dispatch", action="ioerror", p=0.2,
                         after=3, count=5),
            faults.Fault(site="transport_pages", action="drop", p=0.5,
                         count=2)), seed=13)
        inj = inject.FaultInjector(plan, rank=1, sleep=lambda s: None)
        hits = []
        for v in range(300):
            for site in ("serve_decode", "gateway_dispatch",
                         "transport_pages"):
                before = len(inj.fired)
                try:
                    inj.fire(site, step=v)
                except OSError:
                    pass
                if len(inj.fired) > before:
                    hits.append((v, inj.fired[-1]))
        return hits

    a = fired(t_inject, t_faults)
    assert a == fired(t_inject, t_faults) == fired(j_inject, j_faults)
    assert 0 < len(a) <= 11


def _engines(side, tiny, cfg):
    jmodel, params, tmodel = tiny
    if side == "jax":
        def mk(i, **kw):
            return JEngine(jmodel, params, num_slots=4,
                           max_queue=cfg.max_queue,
                           tenants=cfg.tenant_configs(),
                           replica_id=f"s{i}" if i >= 0 else "oracle", **kw)
    else:
        def mk(i, **kw):
            return TEngine(tmodel, num_slots=4, max_queue=cfg.max_queue,
                           tenants=cfg.tenant_configs(),
                           replica_id=f"s{i}" if i >= 0 else "oracle",
                           device="cpu", **kw)
    return mk, lambda i: mk(i, prefill_only=True)


TOPOLOGIES = {
    # seed 3 at failures_to_trip 2 trips breakers and migrates 11 live
    # requests in this window; the disagg run sheds blobs through
    # transport_pages faults.
    "gateway": dict(seed=3, steps=24, failures_to_trip=2,
                    fault_rate=(0.1, 0.4)),
    "disagg": dict(seed=3, steps=24, prefill=1, fault_rate=(0.1, 0.4)),
}


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_run_storm_on_port_engines_equals_jax(tiny, topology):
    """Zero violations, every submitted request finished, the greedy ones
    checked against the unfaulted oracle, no page held; the report equals
    JAX's on the same config, field for field (the repro line names each
    package's own entry point)."""
    reports = {}
    for side, mod in (("jax", j_storm), ("torch", t_storm)):
        cfg = mod.StormConfig(prompt_len=(4, 16), out_len=(4, 12), vocab=256,
                              **TOPOLOGIES[topology])
        mk, mk_pre = _engines(side, tiny, cfg)
        built = []

        def track(i, mk=mk, built=built):
            e = mk(i)
            built.append(e)
            return e

        rep = mod.run_storm(cfg, make_engine=track,
                            make_prefill_engine=mk_pre)
        d = rep.to_dict()
        d.pop("repro")
        reports[side] = d
        if side == "torch":
            assert rep.violations == []
            assert rep.submitted == rep.finished > 0
            assert rep.parity_checked > 0
            assert all(e.pool.counters()["pages_used"] == 0 for e in built)
            sites = set(rep.distinct_sites)
            assert sites == ({"gateway_dispatch", "serve_decode"}
                             if topology == "gateway"
                             else {"serve_decode", "transport_pages"})
            if topology == "gateway":
                assert rep.migrations > 0
    assert reports["torch"] == reports["jax"]


def test_planted_kv_leak_is_caught(tiny):
    """A replica whose shutdown leaves one page held: the teardown sweep
    reports ``kv_page_leak`` naming the replica, and the engine's own
    check emits the event on its request log."""
    cfg = t_storm.StormConfig(seed=5, steps=8, prompt_len=(4, 8),
                              out_len=(2, 4), vocab=256)
    mk, _ = _engines("torch", tiny, cfg)
    logs = []

    class _Log:
        def emit(self, event, **fields):
            logs.append((event, fields))

    def leaky(i):
        e = mk(i)
        if i == 0:
            e.request_log = _Log()
            shutdown = e.shutdown

            def shutdown_and_leak():
                out = shutdown()
                e.pool.alloc(1)
                return out
            e.shutdown = shutdown_and_leak
        return e

    rep = t_storm.run_storm(cfg, make_engine=leaky)
    kinds = {v["kind"]: v["detail"] for v in rep.violations}
    assert set(kinds) == {"kv_page_leak"}
    assert kinds["kv_page_leak"].startswith("replica s0:")
    assert rep.submitted == rep.finished > 0
    leaks = [f for e, f in logs if e == "kv_page_leak"]
    assert leaks and all(f["replica"] == "s0" and f["pages_leaked"] == 1
                         for f in leaks)


def test_autoscale_topology_raises_until_ported(tiny, tmp_path):
    """The autoscaled topology is ported (``serve/autoscale.py``): it no
    longer raises. ``run_storm`` with ``autoscale=True`` holds every
    invariant over the port's engines, and the soak's CLI runs with
    ``--autoscale`` (the report against JAX's is in
    ``tests/test_torch_autoscale.py``)."""
    cfg = t_storm.StormConfig(autoscale=True, steps=8, prompt_len=(4, 8),
                              out_len=(2, 4), vocab=256)
    mk, _ = _engines("torch", tiny, cfg)
    rep = t_storm.run_storm(cfg, make_engine=mk)
    assert rep.violations == [] and rep.submitted == rep.finished > 0
    out = tmp_path / "report.json"
    with redirect_stdout(io.StringIO()):
        rc = t_storm.main(["--autoscale", "--device", "cpu", "--steps", "8",
                           "--max-seq-len", "64", "--report-json",
                           str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["violations"] == [] and "--autoscale" in doc["repro"]


def test_monitor_catches_divergence_and_duplicates():
    mon = t_storm.InvariantMonitor(oracle={0: [1, 2, 3]})
    req = t_storm._make_request({"widx": 0, "step": 0, "prompt": [4, 5],
                                 "max_new_tokens": 3, "tenant": "default",
                                 "deterministic": True, "temperature": 0.0,
                                 "seed": 1}, monitor=mon)
    for tok in (1, 2, 9):
        req.on_token(tok)
    req.on_finish("length")
    req.on_finish("length")
    mon.finalize([])
    kinds = [v["kind"] for v in mon.violations]
    assert kinds == ["duplicate_finish", "missing_output", "token_parity"]


def test_storm_cli_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = t_storm.main(["--device", "cpu", "--steps", "10",
                           "--max-seq-len", "64", "--prefill", "1",
                           "--replicas", "1", "--report-json", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["violations"] == [] and doc["submitted"] == doc["finished"]
    assert "k8s_distributed_deeplearning_torch.serve.storm" in doc["repro"]
