"""PyTorch port, the failover gateway (``serve/gateway.py``) over the port's
engines, each case against the JAX gateway's outcome on the same script
and the same weights (tiny topology, f32, 64 positions): routing, the
breaker's trip, half-open probe, doubled backoff and recovery, the hedge,
drain (by shipped pages), a replica killed through ``gateway_dispatch``
(its live requests migrate and every greedy stream equals JAX's
``generate``), shutdown after a migration, poison quarantine,
``on_finish`` exactly once a request; and the serve CLI's fleet flags,
its refusal of the unported one (tensor parallelism), its autoscaler
flags' checks against the JAX CLI's, and SIGTERM draining every replica.
"""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

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
from k8s_distributed_deeplearning_torch.serve import cli as t_cli
from k8s_distributed_deeplearning_torch.serve import gateway as t_gateway
from k8s_distributed_deeplearning_torch.utils.metrics import (
    ServingStats as TStats)
from k8s_distributed_deeplearning_tpu import faults as j_faults
from k8s_distributed_deeplearning_tpu.models import generate as j_generate
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import gateway as j_gateway
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


class _Side:
    """One package's gateway, engine, request, stats and fault modules
    behind one surface, so a script runs unchanged on both."""

    def __init__(self, name, tiny):
        jmodel, params, tmodel = tiny
        self.name = name
        if name == "jax":
            self.gw, self.req, self.stats_cls = (j_gateway, JRequest,
                                                 JStats)
            self.faults = j_faults
            self._engine = lambda **kw: JEngine(jmodel, params, **kw)
        else:
            self.gw, self.req, self.stats_cls = (t_gateway, TRequest,
                                                 TStats)
            self.faults = t_faults
            self._engine = lambda **kw: TEngine(tmodel, device="cpu", **kw)

    def fleet(self, n=2, **kw):
        stats = self.stats_cls()
        kw.setdefault("num_slots", 2)
        return [self._engine(eos_id=None, stats=stats, replica_id=f"r{i}",
                             **kw) for i in range(n)], stats

    def kill(self, index):
        """A step-scoped ioerror at ``gateway_dispatch``: replica *index*'s
        dispatch fails on every gateway step while active."""
        plan = self.faults.FaultPlan((self.faults.Fault(
            site="gateway_dispatch", action="ioerror", step=index,
            attempt=None),))
        self.faults.activate(plan)


SIDES = ("jax", "torch")


def _workload(n, seed=0, p_lo=4, p_hi=17, m_lo=3, m_hi=16):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=int(rng.integers(p_lo, p_hi)))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rng.integers(m_lo, m_hi)) for _ in range(n)]


def _ref_greedy(tiny, prompt, max_new):
    jmodel, params, _ = tiny
    return np.asarray(j_generate.generate(
        jmodel, params, jnp.asarray(prompt)[None, :],
        max_new_tokens=max_new))[0].tolist()


def _drive(gw, outs, max_steps=600):
    for _ in range(max_steps):
        if not gw.busy():
            return
        outs.extend(gw.step())
    raise AssertionError(f"gateway did not finish in {max_steps} steps")


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def names(self):
        return [e for e, _ in self.events]

    def fields(self, name):
        return [f for e, f in self.events if e == name]


class _FakePool:
    def counters(self):
        return {"pages_total": 8, "pages_used": 0, "pages_shared": 0}


class _FakeEngine:
    """Just enough engine for breaker and routing state: instant steps."""

    def __init__(self, replica_id=None):
        self.replica_id = replica_id
        self.queue = []
        self.num_slots = 2
        self.pool = _FakePool()
        self.steps = 0
        self._draining = False

    def busy(self):
        return False

    def occupied_slots(self):
        return 0

    def load(self):
        return 0

    def step(self):
        self.steps += 1
        return []

    def submit(self, req, *, requeue=False):
        pass

    def drain(self, *, flush=False):
        self._draining = True
        return []

    @property
    def draining(self):
        return self._draining

    @property
    def drained(self):
        return self._draining

    def shutdown(self):
        return []


# ----------------------------------------------------- breaker, no model


def test_breaker_trip_probe_backoff_recovery_equals_jax(tiny):
    """The breaker's lifecycle on an injected clock, the same on both
    gateways: two failures trip it, a failed half-open probe re-opens it
    with the backoff doubled, a healthy probe closes it and resets the
    schedule."""
    trace = {}
    for name in SIDES:
        side = _Side(name, tiny)
        t = [1000.0]
        ev = _Events()
        gw = side.gw.ServeGateway([_FakeEngine(), _FakeEngine()],
                                  failures_to_trip=2, probe_backoff_s=1.0,
                                  max_probe_backoff_s=4.0,
                                  clock=lambda: t[0], logger=ev)
        seen = []
        side.kill(0)
        for dt in (0.0, 0.0, 0.0, 1.1, 1.1):
            t[0] += dt
            gw.step()
            snap = gw.snapshot()["replicas"]["r0"]
            seen.append((gw.breaker_state("r0"), gw.breaker_state("r1"),
                         snap["next_probe_in_s"]))
        side.faults.deactivate()
        t[0] += 1.0
        gw.step()
        seen.append((gw.breaker_state("r0"), gw._by_rid["r0"].backoff,
                     gw.stats.gateway_breaker_trips, ev.names()))
        trace[name] = seen
    assert trace["jax"] == trace["torch"]
    s = trace["torch"]
    assert [x[0] for x in s[:5]] == ["closed", "open", "open", "open",
                                     "open"]
    assert 1.9 <= s[3][2] <= 2.0             # backoff doubled
    assert s[5][:3] == ("closed", 1.0, 2)


def test_gateway_validation_and_unknown_replica(tiny):
    eng = _FakeEngine()
    with pytest.raises(ValueError, match="at least one replica"):
        t_gateway.ServeGateway([])
    with pytest.raises(ValueError, match="failures_to_trip"):
        t_gateway.ServeGateway([eng], failures_to_trip=0)
    with pytest.raises(ValueError, match="hedge_after_s"):
        t_gateway.ServeGateway([eng], hedge_after_s=0)
    gw = t_gateway.ServeGateway([_FakeEngine("a"), _FakeEngine("b")])
    with pytest.raises(ValueError, match="unknown replica"):
        gw.drain_replica("zz")
    with pytest.raises(ValueError, match="duplicate"):
        t_gateway.ServeGateway([_FakeEngine("a"), _FakeEngine("a")])
    assert gw.replica_ids() == ["a", "b"]


# --------------------------------------------------------- real engines


def test_routing_spreads_load_and_matches_generate(tiny):
    """Submissions alternate across equally healthy replicas, as JAX's,
    and every stream equals JAX's one-shot ``generate``."""
    prompts, max_news = _workload(6, seed=4)
    loads, outs = {}, {}
    for name in SIDES:
        side = _Side(name, tiny)
        engines, _ = side.fleet(2)
        gw = side.gw.ServeGateway(engines)
        reqs = [side.req(prompt=p, max_new_tokens=m, request_id=f"q{i}")
                for i, (p, m) in enumerate(zip(prompts, max_news))]
        for r in reqs[:4]:
            gw.submit(r)
        loads[name] = [e.load() for e in engines]
        outs[name] = {o.request_id: o.tokens for o in gw.run(reqs[4:])}
    assert loads["jax"] == loads["torch"] == [2, 2]
    assert outs["torch"] == outs["jax"]
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        assert outs["torch"][f"q{i}"] == _ref_greedy(tiny, p, m)


def _kill_script(side, tiny, prompts, max_news):
    engines, stats = side.fleet(2, prefix_cache_mb=4, kv_pool_pages=16)
    ev = _Events()
    gw = side.gw.ServeGateway(engines, stats=stats, logger=ev,
                              failures_to_trip=1)
    finishes = {}
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        r = side.req(prompt=p, max_new_tokens=m, request_id=f"k{i}")
        r.on_finish = (lambda reason, rid=r.request_id:
                       finishes.setdefault(rid, []).append(reason))
        gw.submit(r)
    outs = []
    for _ in range(3):
        outs.extend(gw.step())
    occupied = engines[0].occupied_slots()
    side.kill(0)
    try:
        outs.extend(gw.step())
    finally:
        side.faults.deactivate()
    state = gw.breaker_state("r0")
    _drive(gw, outs)
    return ({o.request_id: (o.tokens, o.finish_reason) for o in outs},
            finishes, occupied, state, stats.gateway_breaker_trips,
            stats.gateway_migrations,
            [(m["from_replica"], m["to_replica"], m["tokens_emitted"])
             for m in ev.fields("gateway_migrated")], engines)


def test_replica_kill_migrates_and_streams_equal_jax(tiny):
    """r0 dies mid-decode (an injected dispatch ioerror trips its breaker
    and tears it down); its two live requests resume on r1 as prompt +
    streamed tokens. Every greedy stream equals JAX's ``generate``; the
    breaker, migration counts and events equal the JAX gateway's on the
    same script; on_finish fires once a request; no page is held."""
    prompts, max_news = _workload(4, seed=5, m_lo=10, m_hi=14)
    got = {name: _kill_script(_Side(name, tiny), tiny, prompts, max_news)
           for name in SIDES}
    assert got["torch"][:7] == got["jax"][:7]
    outs, finishes, occupied, state, trips, migrations, moved, engines = \
        got["torch"]
    assert occupied == 2 and state == "open" and trips == 1
    assert migrations == 2 == len(moved)
    assert all(f == "r0" and t == "r1" for f, t, _ in moved)
    assert any(n > 0 for _, _, n in moved)      # mid-decode, cursor moved
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        assert outs[f"k{i}"] == (_ref_greedy(tiny, p, m), "length")
        assert finishes[f"k{i}"] == ["length"]
    engines[1].shutdown()              # flushes r1's prefix trie
    assert all(e.pool.counters()["pages_used"] == 0 for e in engines)


def test_hedge_covers_straggler_and_cancels_loser(tiny):
    """A request stuck behind a replica whose dispatch keeps failing (the
    breaker set never to trip) is hedged once after hedge_after_s; the
    peer's stream wins, the loser ends ``hedge_lost``; as in JAX."""
    prompts, max_news = _workload(1, seed=7, m_lo=8, m_hi=9)
    got = {}
    for name in SIDES:
        side = _Side(name, tiny)
        engines, stats = side.fleet(2)
        t = [0.0]
        ev = _Events()
        gw = side.gw.ServeGateway(engines, stats=stats, logger=ev,
                                  hedge_after_s=0.5,
                                  failures_to_trip=10_000,
                                  clock=lambda: t[0])
        reasons = []
        req = side.req(prompt=prompts[0], max_new_tokens=max_news[0],
                       on_finish=reasons.append)
        side.kill(0)
        outs = []
        try:
            gw.submit(req)
            gw.step()
            before = stats.gateway_hedges
            t[0] += 1.0
            _drive(gw, outs)
        finally:
            side.faults.deactivate()
        got[name] = (before, stats.gateway_hedges,
                     [(o.tokens, o.finish_reason) for o in outs], reasons,
                     stats.finish_reasons.get("hedge_lost"),
                     engines[0].load(), "gateway_breaker_open" in ev.names())
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (0, 1) and got["torch"][4] == 1
    assert got["torch"][2] == [(_ref_greedy(tiny, prompts[0], max_news[0]),
                                "length")]


def test_drain_replica_ships_pages(tiny):
    """Draining a replica mid-decode moves its request by value (one
    export, one import; no re-prefill); the stream stays JAX's; the
    drained replica takes no new work; nothing is held after."""
    prompts, max_news = _workload(1, seed=6, m_lo=12, m_hi=13)
    want = _ref_greedy(tiny, prompts[0], max_news[0])
    got = {}
    for name in SIDES:
        side = _Side(name, tiny)
        engines, stats = side.fleet(2)
        ev = _Events()
        gw = side.gw.ServeGateway(engines, stats=stats, logger=ev)
        streamed = []
        gw.submit(side.req(prompt=prompts[0], max_new_tokens=max_news[0],
                           request_id="g0", on_token=streamed.append))
        for _ in range(4):
            gw.step()
        src = "r0" if engines[0].occupied_slots() else "r1"
        gw.drain_replica(src)
        gw.drain_replica(src)                # idempotent
        extra = side.req(prompt=prompts[0], max_new_tokens=max_news[0],
                         request_id="g1")
        gw.submit(extra)
        outs = []
        _drive(gw, outs)
        got[name] = ({o.request_id: o.tokens for o in outs}, streamed,
                     stats.disagg_exports, stats.disagg_imports,
                     stats.gateway_migrations,
                     [m.get("shipped_pages")
                      for m in ev.fields("gateway_migrated")],
                     "replica_drained" in ev.names(),
                     [e.pool.counters()["pages_used"] for e in engines])
    assert got["torch"] == got["jax"]
    outs, streamed, exports, imports, migrations, shipped, drained, used = \
        got["torch"]
    assert outs == {"g0": want, "g1": want} and streamed == want
    assert exports == imports == migrations == 1 and shipped[0] >= 1
    assert drained and used == [0, 0]


def test_shutdown_after_migration_finishes_once(tiny):
    for name in SIDES:
        side = _Side(name, tiny)
        engines, stats = side.fleet(2)
        gw = side.gw.ServeGateway(engines, stats=stats, failures_to_trip=1)
        reasons = []
        gw.submit(side.req(prompt=list(range(3, 9)), max_new_tokens=30,
                           on_finish=reasons.append))
        for _ in range(2):
            gw.step()
        side.kill(0)
        try:
            gw.step()
        finally:
            side.faults.deactivate()
        assert stats.gateway_migrations == 1
        (out,) = gw.shutdown()
        assert out.finish_reason == "aborted" and reasons == ["aborted"]
        assert not gw.busy() and gw.step() == []
        assert all(e.pool.counters()["pages_used"] == 0 for e in engines)


def test_poison_quarantine_caps_migrations(tiny):
    """r0 and r1 keep failing their dispatch: a request that migrated off
    r0 onto r1 has used its ``max_migrations`` (1) when r1 dies under it,
    and ends "poisoned" once instead of a lap to r2, as in JAX."""
    got = {}
    for name in SIDES:
        side = _Side(name, tiny)
        engines, stats = side.fleet(3)
        t = [0.0]
        gw = side.gw.ServeGateway(engines, stats=stats, failures_to_trip=1,
                                  max_migrations=1, probe_backoff_s=0.1,
                                  clock=lambda: t[0])
        reasons = []
        gw.submit(side.req(prompt=[5, 6, 7, 8], max_new_tokens=20,
                           on_finish=reasons.append))
        plan = side.faults.FaultPlan(tuple(
            side.faults.Fault(site="gateway_dispatch", action="ioerror",
                              step=i, attempt=None) for i in (0, 1)))
        gw.step()
        side.faults.activate(plan)
        outs = []
        try:
            for _ in range(20):
                t[0] += 0.2
                outs.extend(gw.step())
                if not gw._live:
                    break
        finally:
            side.faults.deactivate()
        got[name] = ([o.finish_reason for o in outs], reasons,
                     stats.gateway_poisoned, stats.gateway_migrations)
    assert got["torch"] == got["jax"]
    assert got["torch"] == (["poisoned"], ["poisoned"], 1, 1)


def test_snapshot_and_fault_site_validation(tiny):
    side = _Side("torch", tiny)
    engines, stats = side.fleet(2)
    gw = t_gateway.ServeGateway(engines, stats=stats)
    gw.submit(TRequest(prompt=[1, 2, 3], max_new_tokens=3))
    snap = gw.snapshot()
    assert set(snap["replicas"]) == {"r0", "r1"}
    assert snap["live_requests"] == 1 and snap["gateway_dispatches"] == 1
    assert snap["replicas"]["r0"]["state"] == "closed"
    bad = t_faults.Fault(site="gateway_dispatch", action="truncate")
    assert any("not valid at site" in e for e in bad.problems())
    gw.shutdown()


# -------------------------------------------------------------------- CLI


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("fleet", [["--replicas", "2", "--hedge-after-s",
                                    "5", "--flight-ring", "16"],
                                   ["--replicas", "2", "--disagg-prefill",
                                    "1"]], ids=["gateway", "disagg"])
def test_cli_fleet_flags(fleet, tmp_path):
    events = _cli(["--device", "cpu", "--requests", "6", "--slots", "2",
                   "--max-seq-len", "64", "--prompt-len", "4", "12",
                   "--out-len", "3", "6", "--flight-dir", str(tmp_path)]
                  + fleet)
    kinds = [e["event"] for e in events]
    assert kinds.count("serve_request") == 6
    summ = events[-1]
    assert summ["event"] == "serve_summary" and summ["replicas"] == 2
    assert summ["requests_completed"] >= 6
    if "--disagg-prefill" in fleet:
        # A blob no decode engine has a free slot for takes the unified
        # fallback.
        assert summ["disagg_exports"] == 6
        assert summ["disagg_imports"] + summ["disagg_fallbacks"] == 6
    else:
        assert summ["gateway_dispatches"] == 6


@pytest.mark.parametrize("flags", [
    ["--tp", "2"], ["--autoscale"], ["--autoscale-min", "2"],
    ["--autoscale-max", "3"], ["--autoscale-interval-s", "1"],
    ["--autoscale-up-cooldown-s", "1"], ["--autoscale-down-cooldown-s", "1"],
    ["--autoscale-brownout", "shed_batch"], ["--autoscale-k8s-job", "j"],
    ["--autoscale-k8s-namespace", "ns"],
    ["--autoscale-endpoint-template", "h-{i}:1"]],
    ids=lambda f: f[0])
def test_cli_unported_fleet_flags_raise(flags):
    """The fleet flags are all ported now: tensor parallelism
    (``tests/test_torch_tp_serve.py``) and the autoscaler's flags
    (``tests/test_torch_autoscale.py``). Each passes the parser and meets
    the JAX CLI's own checks, here ``--replicas 0`` (or the flag's own
    refusal), refused with the JAX CLI's message."""
    from k8s_distributed_deeplearning_tpu.serve import cli as j_cli
    said = []
    for main, argv in ((t_cli.main, ["--device", "cpu"]), (j_cli.main, [])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                pytest.raises(SystemExit) as ex:
            main(argv + flags + ["--replicas", "0"])
        assert ex.value.code == 2
        said.append(err.getvalue().strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    assert said[0] == said[1]


def test_cli_sigterm_drains_replicas_and_exits_zero():
    """SIGTERM to a running 2-replica serve CLI: drain mode, the fleet
    finishes what it holds, one replica_drained a replica, exit 0, and
    fewer completions than requested (the unsubmitted tail is shed)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_distributed_deeplearning_torch.serve",
         "--device", "cpu", "--preset", "tiny", "--max-seq-len", "64",
         "--replicas", "2", "--slots", "2", "--requests", "64",
         "--max-queue", "4", "--prompt-len", "4", "12", "--out-len", "8",
         "16"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(REPO))
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if '"serve_request"' in line:
                break
        assert lines and '"serve_request"' in lines[-1], "".join(lines)
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=120)
    except Exception:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-2000:]
    out = "".join(lines) + rest
    assert out.count('"replica_drained"') == 2
    assert '"serve_summary"' in out
    assert out.count('"serve_request"') < 64
