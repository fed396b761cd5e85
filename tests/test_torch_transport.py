"""PyTorch port, the wire transport (``serve/transport.py``): the port's
``ReplicaServer`` and ``ReplicaClient`` over real localhost HTTP, held to
the JAX package's ``tests/test_transport.py`` and to the JAX engine.

- The JAX file's fake-engine cases, copied: idempotent submit across an
  ambiguous failure, exactly-once stream splicing over a lost poll
  response, poll exhaustion and the reconnect count, a partition window,
  typed rejections without retries, a restarted replica raising for the
  breaker, ``/readyz`` 503 on drain while ``/healthz`` stays 200, the
  drain retry's accumulated flush list, heartbeat discovery and the
  health snapshot.
- ``request_to_wire`` emits the JAX module's JSON for the same request;
  a JAX ``ReplicaClient`` drives a port ``ReplicaServer`` (the control
  plane's format is shared).
- ``transport_send`` and ``transport_recv`` each fire with ``ioerror``,
  ``drop`` and ``partition``, and every token still arrives exactly once.
- A port gateway over two port replica servers streams JAX's greedy
  tokens (tiny preset, f32, weights through ``models/convert.py``); a
  replica closed mid-decode at a known step migrates its streams, and a
  wire drain empties a replica.
- The serve CLI parses every flag of the JAX serve CLI, and its
  replica-server and gateway processes hand over on SIGTERM.

No test races a request against the clock: a replica is closed after a
known number of engine steps (its engine is gated), ports are ephemeral,
and every wait has its own deadline.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from k8s_distributed_deeplearning_torch import faults
from k8s_distributed_deeplearning_torch.faults.plan import Fault, FaultPlan
from k8s_distributed_deeplearning_torch.serve.request import (EngineDraining,
                                                              QueueFull,
                                                              Request,
                                                              SamplingParams)
from k8s_distributed_deeplearning_torch.serve.transport import (
    ReplicaClient, ReplicaServer, discover_replica_clients,
    request_from_wire, request_to_wire)
from k8s_distributed_deeplearning_torch.telemetry.registry import (
    MetricsRegistry)
from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.deactivate()
    yield
    faults.deactivate()


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def names(self):
        return [e for e, _ in self.events]


# ------------------------------------------- fault-site / plan registry


def test_transport_fault_sites_accept_network_actions():
    for site in ("transport_send", "transport_recv"):
        for action in ("ioerror", "stall", "drop"):
            seconds = 0.1 if action == "stall" else 0.0
            assert not FaultPlan((Fault(site=site, action=action,
                                        seconds=seconds),)).problems()
        assert not FaultPlan((Fault(site=site, action="partition",
                                    seconds=0.5),)).problems()
        # A zero-length partition is a no-op masquerading as chaos.
        assert FaultPlan((Fault(site=site, action="partition"),)).problems()
        # Checkpoint-damage actions make no sense on the wire.
        assert FaultPlan((Fault(site=site, action="truncate"),)).problems()


# --------------------------------------------------- wire serialization


def test_wire_request_roundtrip_preserves_decode_inputs():
    req = Request(prompt=np.arange(3, 8, dtype=np.int32), max_new_tokens=7,
                  sampling=SamplingParams(temperature=0.5, top_k=3,
                                          top_p=0.9),
                  tenant="t1", seed=9, deadline_s=4.0)
    msg = json.loads(json.dumps(request_to_wire(req, deadline_s=2.5)))
    back = request_from_wire(msg)
    assert list(back.prompt) == [3, 4, 5, 6, 7]
    assert back.max_new_tokens == 7
    assert (back.sampling.temperature, back.sampling.top_k,
            back.sampling.top_p) == (0.5, 3, 0.9)
    assert back.request_id == req.request_id
    assert back.trace_id == req.trace_id      # graftscope stitching key
    assert back.tenant == "t1" and back.seed == 9
    # The wire carries REMAINING budget, re-anchored server-side.
    assert back.deadline_s == 2.5
    with pytest.raises((KeyError, ValueError, TypeError)):
        request_from_wire({"prompt": [1, 2]})   # no max_new_tokens


# -------------------------------------------------- fake wire engine


class _WirePool:
    def counters(self):
        return {"pages_total": 16, "pages_used": 1, "pages_shared": 0}


class _WireEngine:
    """Deterministic engine behind a real ReplicaServer: each
    step emits ``prompt[-1] + n + 1`` per live request — the expected
    stream for prompt p, budget m is ``[p[-1]+1, ..., p[-1]+m]``, so
    exactly-once delivery is assertable token by token."""

    def __init__(self, replica_id=None, num_slots=2, max_queue=4):
        self.replica_id = replica_id
        self.stats = ServingStats()
        self.pool = _WirePool()
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.live = []                 # [request, emitted]
        self.queue = []                # queued beyond the slots
        self.submits = []
        self.fail_submit = None
        self._draining = False

    def busy(self):
        return bool(self.live or self.queue)

    def occupied_slots(self):
        return len(self.live)

    def load(self):
        return len(self.live) + len(self.queue)

    def submit(self, req, *, requeue=False):
        if self.fail_submit is not None:
            raise self.fail_submit
        if self._draining and not requeue:
            raise EngineDraining("draining")
        if self.load() >= self.num_slots + self.max_queue:
            raise QueueFull("queue full")
        self.submits.append(req.request_id)
        if len(self.live) < self.num_slots:
            self.live.append([req, 0])
        else:
            self.queue.append(req)

    def step(self):
        for entry in list(self.live):
            req, n = entry
            entry[1] += 1
            tok = int(req.prompt[-1]) + n + 1
            if req.on_token is not None:
                req.on_token(tok)
            if entry[1] >= req.max_new_tokens:
                self.live.remove(entry)
                if req.on_finish is not None:
                    req.on_finish("length")
        while self.queue and len(self.live) < self.num_slots:
            self.live.append([self.queue.pop(0), 0])
        return []

    def cancel(self, request_id, reason="aborted"):
        for entry in list(self.live):
            if entry[0].request_id == request_id:
                self.live.remove(entry)
                if entry[0].on_finish is not None:
                    entry[0].on_finish(reason)
                return entry[0]
        for req in list(self.queue):
            if req.request_id == request_id:
                self.queue.remove(req)
                if req.on_finish is not None:
                    req.on_finish(reason)
                return req
        return None

    def drain(self, *, flush=False):
        self._draining = True
        if flush:
            out, self.queue = list(self.queue), []
            return out
        return []

    @property
    def draining(self):
        return self._draining

    @property
    def drained(self):
        return self._draining and not self.live and not self.queue

    def shutdown(self):
        self.live.clear()
        self.queue.clear()
        return []


@pytest.fixture
def wire():
    eng = _WireEngine(replica_id="r0")
    srv = ReplicaServer(eng, registry=MetricsRegistry(),
                        idle_wait_s=0.002).start()
    yield eng, srv
    srv.close()


def _client(srv, **kw):
    kw.setdefault("replica_id", "r0")
    kw.setdefault("timeout_s", 5.0)
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("rng", lambda: 1.0)
    return ReplicaClient(srv.address, **kw)


def _wait(pred, deadline_s=60.0, msg="condition"):
    t0 = time.time()
    while not pred():
        if time.time() - t0 > deadline_s:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


def _drive_client(client, deadline_s=60.0):
    t0 = time.time()
    while client.busy():
        client.step()
        if time.time() - t0 > deadline_s:
            raise AssertionError("client did not quiesce")
        time.sleep(0.002)


def _expected(req):
    base = int(req.prompt[-1])
    return [base + i + 1 for i in range(req.max_new_tokens)]


# -------------------------------------------------- wire happy path


def test_wire_stream_end_to_end(wire):
    eng, srv = wire
    client = _client(srv)
    toks, fins = [], []
    req = Request(prompt=[5, 6, 7], max_new_tokens=4)
    req.on_token = toks.append
    req.on_finish = fins.append
    client.submit(req)
    assert client.busy()
    _drive_client(client)
    assert toks == _expected(req)
    assert fins == ["length"]
    assert eng.submits == [req.request_id]
    assert not client._streams


def test_ambiguous_submit_retry_admits_exactly_once(wire):
    """THE idempotency criterion: the first /submit lands server-side but
    its response is dropped on the wire (transport_recv after the
    handler). The client's retry of the SAME dispatch key hits the
    dedup ledger — one admission, one stream, one on_finish."""
    eng, srv = wire
    client = _client(srv)
    toks, fins = [], []
    req = Request(prompt=[10], max_new_tokens=5)
    req.on_token = toks.append
    req.on_finish = fins.append
    faults.activate(FaultPlan((Fault(site="transport_recv", action="drop",
                                     count=1),)))
    try:
        client.submit(req)
    finally:
        faults.deactivate()
    assert eng.submits == [req.request_id]        # admitted ONCE
    assert client.stats.transport_retries == 1
    assert eng.stats.transport_dedup_hits == 1    # retry answered duplicate
    _drive_client(client)
    assert toks == _expected(req)                 # stream intact
    assert fins == ["length"]                     # exactly-once terminal


def test_lost_poll_response_splices_exactly_once(wire):
    """A poll whose response is severed after the handler ran must not
    double-deliver on retry: the client never advanced its cursor, the
    server re-answers tokens[cursor:] — the splice is bit-exact."""
    eng, srv = wire
    client = _client(srv)
    toks, fins = [], []
    req = Request(prompt=[20], max_new_tokens=6)
    req.on_token = toks.append
    req.on_finish = fins.append
    client.submit(req)
    _wait(lambda: not eng.busy(), msg="server-side generation")
    faults.activate(FaultPlan((Fault(site="transport_recv", action="drop",
                                     count=1),)))
    try:
        client.step()
    finally:
        faults.deactivate()
    assert toks == _expected(req)
    assert fins == ["length"]
    assert client.stats.transport_retries == 1


def test_poll_exhaustion_raises_then_reconnect_is_counted(wire):
    """Transport exhaustion surfaces to the gateway's breaker as a raise;
    the first successful poll after failures records a reconnect (the
    stream resumed from its cursor, nothing lost)."""
    eng, srv = wire
    ev = _Events()
    client = _client(srv, retries=1, logger=ev)
    toks, fins = [], []
    req = Request(prompt=[30], max_new_tokens=3)
    req.on_token = toks.append
    req.on_finish = fins.append
    client.submit(req)
    faults.activate(FaultPlan((Fault(site="transport_send", action="ioerror",
                                     count=2),)))
    try:
        with pytest.raises(OSError):
            client.step()
    finally:
        faults.deactivate()
    assert client.stats.transport_retries == 1
    _drive_client(client)
    assert client.stats.transport_reconnects == 1
    assert toks == _expected(req) and fins == ["length"]
    assert "transport_retry" in ev.names()
    assert "transport_reconnect" in ev.names()


def test_partition_window_severs_both_attempts_then_heals(wire):
    """partition is stateful: the first fire opens a window and every
    subsequent attempt at the site fails until it closes — a submit
    caught inside maps to EngineDraining (route elsewhere), and its
    abandoned dispatch key can never double-admit."""
    eng, srv = wire
    client = _client(srv, retries=1)
    req = Request(prompt=[40], max_new_tokens=2)
    inj = faults.activate(FaultPlan((Fault(site="transport_send",
                                           action="partition",
                                           seconds=30.0),)))
    try:
        with pytest.raises(EngineDraining, match="unreachable"):
            client.submit(req)
    finally:
        faults.deactivate()
    assert ("transport_send", "partition") in inj.fired
    assert eng.submits == []                      # never left the client
    assert not client._streams                    # no orphan stream
    # Network healed (plan cleared): the same request admits cleanly.
    fins = []
    req.on_finish = fins.append
    client.submit(req)
    _drive_client(client)
    assert eng.submits == [req.request_id] and fins == ["length"]


def test_typed_rejections_map_without_retries(wire):
    """Server-mapped statuses surface as their typed exceptions and are
    never retried — HTTPError is an OSError subclass, so this guards the
    map-before-transient-predicate ordering."""
    eng, srv = wire
    sleeps = []
    client = _client(srv, sleep=sleeps.append)
    for exc, expect in ((QueueFull("full"), QueueFull),
                        (EngineDraining("draining"), EngineDraining),
                        (ValueError("too long"), ValueError)):
        eng.fail_submit = exc
        with pytest.raises(expect, match="replica answered"):
            client.submit(Request(prompt=[1], max_new_tokens=1))
    eng.fail_submit = None
    assert sleeps == []                           # zero retry sleeps


def test_replica_restart_lost_streams_raise_for_breaker(wire):
    eng, srv = wire
    client = _client(srv)
    req = Request(prompt=[50], max_new_tokens=4)
    client.submit(req)
    with srv._cond:                               # simulate process restart
        srv._records.clear()
        eng.live.clear()
    with pytest.raises(RuntimeError, match="lost 1 dispatched stream"):
        client.step()


def test_readyz_flips_503_on_drain_while_healthz_stays_200(wire):
    """The probe split the k8s render depends on: readiness gates routing
    (503 while draining), liveness gates restart (200 while draining —
    restarting a draining pod loses the work the drain protects)."""
    eng, srv = wire

    def _get(path):
        with urllib.request.urlopen(f"http://{srv.address}{path}",
                                    timeout=5.0) as resp:
            return resp.status, json.loads(resp.read().decode())

    assert _get("/healthz")[0] == 200
    code, body = _get("/readyz")
    assert code == 200 and body["ready"] is True
    client = _client(srv)
    client.drain()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get("/readyz")
    assert ei.value.code == 503
    code, body = _get("/healthz")                 # still alive, draining
    assert code == 200 and body["draining"] is True
    assert client.draining                        # piggybacked to the client


def test_drain_retry_returns_accumulated_flush_list(wire):
    """A drain whose response was lost must be retryable without the
    flushed requests falling through: the server returns the FULL
    accumulated flush list, not the call's delta."""
    eng, srv = wire
    client = _client(srv)
    # A budget no step loop can finish inside the test: the third
    # request must still be QUEUED when the drain flushes it.
    reqs = [Request(prompt=[60 + i], max_new_tokens=10_000_000)
            for i in range(3)]
    for r in reqs:
        client.submit(r)
    _wait(lambda: len(eng.queue) == 1, msg="third request queued")
    faults.activate(FaultPlan((Fault(site="transport_recv", action="drop",
                                     count=1),)))
    try:
        flushed = client.drain(flush=True)
    finally:
        faults.deactivate()
    # First drain's flush landed server-side, its response died; the
    # retried call's engine flush is empty — the ledger still reports it.
    assert [r.request_id for r in flushed] == [reqs[2].request_id]
    assert client.stats.transport_retries == 1
    assert eng.draining
    # The flushed request left the client's streams (gateway remigrates
    # it); the live two keep streaming to completion.
    assert len(client._streams) == 2


def test_heartbeat_discovery_builds_clients(tmp_path):
    eng = _WireEngine(replica_id="r0")
    srv = ReplicaServer(eng, registry=MetricsRegistry(),
                        heartbeat_dir=str(tmp_path), rank=0).start()
    try:
        clients = discover_replica_clients(str(tmp_path), backoff_s=0.001)
        assert [c.endpoint for c in clients] == [f"http://{srv.address}"]
        fins = []
        req = Request(prompt=[70], max_new_tokens=2)
        req.on_finish = fins.append
        clients[0].submit(req)
        _drive_client(clients[0])
        assert fins == ["length"]
    finally:
        srv.close()


def test_health_snapshot_piggybacks_and_scrapes():
    eng = _WireEngine(replica_id="r0")
    registry = MetricsRegistry()
    srv = ReplicaServer(eng, registry=registry, idle_wait_s=0.002)
    # The instantaneous slot/load gauges the client's scrape path reads
    # (the default registry wires these; the fake-engine fixture opts out
    # of the full collectors, so register just the gauges here).
    srv._register_engine_gauges(registry)
    srv.start()
    try:
        client = _client(srv, health_refresh_s=0.0)
        req = Request(prompt=[80], max_new_tokens=10_000_000)
        client.submit(req)
        _wait(lambda: eng.occupied_slots() == 1, msg="slot occupied")
        # /metrics scrape path (the same exposition the fleet plane
        # reads).
        assert client.num_slots == eng.num_slots
        assert client.occupied_slots() == 1
        # The poll piggyback path carries the KV counters.
        client.step()
        assert client.pool.counters()["pages_total"] == 16
        client.cancel(req.request_id, "aborted")
        _wait(lambda: not eng.busy(), msg="cancel to land")
    finally:
        srv.close()




# ------------------------------------------------- the wire format is JAX's


def test_request_to_wire_equals_jax_json():
    """The same request serializes to the JAX module's JSON, key for key,
    and the port parses the JAX document back to the same request."""
    from k8s_distributed_deeplearning_tpu.serve import transport as j_wire
    from k8s_distributed_deeplearning_tpu.serve.request import (
        Request as JRequest, SamplingParams as JSampling)
    kw = dict(prompt=np.arange(3, 9, dtype=np.int32), max_new_tokens=7,
              tenant="t1", seed=9, deadline_s=4.0, request_id="rq-1",
              trace_id="tr-1", migrated_from="r3")
    t = Request(sampling=SamplingParams(temperature=0.5, top_k=3,
                                        top_p=0.9), **kw)
    j = JRequest(sampling=JSampling(temperature=0.5, top_k=3, top_p=0.9),
                 **kw)
    for deadline in (None, 2.5):
        got = json.dumps(request_to_wire(t, deadline_s=deadline),
                         sort_keys=True)
        want = json.dumps(j_wire.request_to_wire(j, deadline_s=deadline),
                          sort_keys=True)
        assert got == want
    back = request_from_wire(json.loads(want))
    assert (list(back.prompt), back.max_new_tokens, back.request_id,
            back.trace_id, back.migrated_from, back.tenant, back.seed,
            back.deadline_s) == ([3, 4, 5, 6, 7, 8], 7, "rq-1", "tr-1",
                                 "r3", "t1", 9, 2.5)


# --------------------------------------------- the two sites, every action


@pytest.mark.parametrize("action", ["ioerror", "drop", "partition"])
@pytest.mark.parametrize("site", ["transport_send", "transport_recv"])
def test_fault_site_fires_and_stream_stays_exactly_once(wire, site, action):
    """Each network action at each site on a poll: ``ioerror`` and
    ``drop`` are one lost attempt the bounded retry absorbs; a
    ``partition`` severs every attempt until it heals, the poll raises
    for the breaker, and the next poll after the heal splices the stream
    from its cursor. Either way every token arrives once."""
    eng, srv = wire
    client = _client(srv, retries=2)
    toks, fins = [], []
    req = Request(prompt=[90], max_new_tokens=5)
    req.on_token = toks.append
    req.on_finish = fins.append
    client.submit(req)
    _wait(lambda: not eng.busy(), msg="server-side generation")
    fault = (Fault(site=site, action=action, seconds=600.0)
             if action == "partition" else
             Fault(site=site, action=action, count=1))
    inj = faults.activate(FaultPlan((fault,)))
    try:
        if action == "partition":
            with pytest.raises(OSError):
                client.step()
        else:
            client.step()
    finally:
        faults.deactivate()
    assert (site, action) in inj.fired
    if action == "partition":
        assert client.stats.transport_retries == 2
        client.step()                      # healed: the stream resumes
        assert client.stats.transport_reconnects == 1
    else:
        assert client.stats.transport_retries == 1
    assert toks == _expected(req)
    assert fins == ["length"]
    assert eng.submits == [req.request_id]


# ------------------------------------------------ the real model on the CPU


MAX_NEW = 10


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp
    import torch

    from k8s_distributed_deeplearning_torch.models import convert as t_conv
    from k8s_distributed_deeplearning_torch.models import llama as t_llama
    from k8s_distributed_deeplearning_tpu.models import llama as j_llama
    torch.set_num_threads(2)
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=64)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_conv.from_flax_params(tcfg, params))
    return jmodel, params, tmodel, tcfg


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, int(n)).astype(np.int32)
            for n in (5, 11, 7, 9, 6)]


@pytest.fixture(scope="module")
def refs(tiny, prompts):
    """The JAX in-process engine's greedy stream of each prompt."""
    from k8s_distributed_deeplearning_tpu.serve import (
        Request as JRequest, ServeEngine as JEngine)
    jmodel, params, _, _ = tiny
    eng = JEngine(jmodel, params, num_slots=2, eos_id=None)
    outs = eng.run([JRequest(prompt=list(p), max_new_tokens=MAX_NEW,
                             request_id=f"q{i}")
                    for i, p in enumerate(prompts)])
    return {o.request_id: o.tokens for o in outs}


class _Gated:
    """A port engine whose server-side step loop stops after *budget*
    steps: ``busy()`` turns False, so the loop idles on its condition. A
    replica gated this way is provably mid-stream when the test closes
    it, however loaded the machine is."""

    def __init__(self, engine, budget=None):
        self._engine = engine
        self.budget = budget
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def busy(self):
        return self._engine.busy() and (self.budget is None
                                        or self.steps < self.budget)

    def step(self):
        self.steps += 1
        return self._engine.step()


def _engine(tiny, rid, **kw):
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    return ServeEngine(tiny[2], num_slots=2, eos_id=None, device="cpu",
                       replica_id=rid, **kw)


def _fleet(tiny, budgets=(None, None)):
    engines = [_Gated(_engine(tiny, f"r{i}"), b)
               for i, b in enumerate(budgets)]
    servers = [ReplicaServer(e, handler_timeout=60.0).start()
               for e in engines]
    stats = ServingStats()
    clients = [ReplicaClient(s.address, replica_id=f"r{i}", stats=stats,
                             timeout_s=60.0, backoff_s=0.01,
                             health_refresh_s=0.0, rng=lambda: 1.0)
               for i, s in enumerate(servers)]
    return engines, servers, clients, stats


def _tracked(prompts, idx):
    streams, finishes, reqs = {}, {}, []
    for i in idx:
        rid = f"q{i}"
        reqs.append(Request(
            prompt=list(prompts[i]), max_new_tokens=MAX_NEW, request_id=rid,
            on_token=lambda t, rid=rid: streams.setdefault(rid, []).append(
                int(t)),
            on_finish=lambda r, rid=rid: finishes.setdefault(rid, []).append(
                r)))
    return reqs, streams, finishes


def _drive_gateway(gw, outs, deadline_s=240.0):
    t0 = time.time()
    while gw.busy():
        outs.extend(gw.step())
        assert time.time() - t0 < deadline_s, "gateway did not quiesce"
        time.sleep(0.002)


def test_remote_gateway_streams_equal_jax_engine(tiny, prompts, refs):
    """A port gateway over two port replica servers (real sockets, the
    default registry's collectors and slot gauges behind the routing
    scrape) streams every request's greedy tokens equal to the JAX
    in-process engine's, ``on_finish`` once each."""
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    engines, servers, clients, stats = _fleet(tiny)
    try:
        gw = ServeGateway(clients, stats=stats)
        reqs, streams, finishes = _tracked(prompts, range(4))
        for r in reqs:
            gw.submit(r)
        outs = []
        _drive_gateway(gw, outs)
        assert sorted(o.request_id for o in outs) == sorted(
            r.request_id for r in reqs)
        for r in reqs:
            assert streams[r.request_id] == refs[r.request_id]
            assert finishes[r.request_id] == ["length"]
        assert all(e.steps > 0 for e in engines)      # both replicas served
    finally:
        for s in servers:
            s.close()


def test_remote_replica_closed_mid_decode_migrates_bit_identically(
        tiny, prompts, refs):
    """r0's step loop stops after 3 steps (gated), so its requests are
    mid-stream whatever the machine's load; closing its server fails the
    next poll, the breaker trips, and the gateway resubmits from ITS
    cursor onto r1: every stream equals the JAX engine's."""
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    engines, servers, clients, stats = _fleet(tiny, budgets=(3, None))
    for c in clients:
        c.retries = 1
    try:
        gw = ServeGateway(clients, stats=stats, failures_to_trip=1)
        reqs, streams, finishes = _tracked(prompts, range(4))
        for r in reqs:
            gw.submit(r)
        outs = []
        t0 = time.time()
        while engines[0].steps < 3 or engines[0]._engine.occupied_slots() \
                == 0:
            outs.extend(gw.step())
            assert time.time() - t0 < 120.0, "r0 never reached its budget"
            time.sleep(0.002)
        on_r0 = {st.req.request_id for st in clients[0]._streams.values()}
        assert on_r0, "no request was placed on r0"
        servers[0].close()                 # the replica process is gone
        _drive_gateway(gw, outs)
        assert stats.gateway_breaker_trips >= 1
        assert stats.gateway_migrations >= len(on_r0)
        for r in reqs:
            assert streams[r.request_id] == refs[r.request_id]
            assert finishes[r.request_id] == ["length"]
    finally:
        for s in servers[1:]:
            s.close()


def test_wire_drain_empties_a_replica_and_routes_around_it(tiny, prompts,
                                                           refs):
    """``drain_replica`` over the wire: r0's server drains (``/readyz``
    503), its streams migrate to r1 with the JAX engine's tokens, and a
    request submitted afterwards never touches r0."""
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    engines, servers, clients, stats = _fleet(tiny, budgets=(2, None))
    try:
        gw = ServeGateway(clients, stats=stats)
        reqs, streams, finishes = _tracked(prompts, range(4))
        for r in reqs:
            gw.submit(r)
        outs = []
        t0 = time.time()
        while engines[0].steps < 2:
            outs.extend(gw.step())
            assert time.time() - t0 < 120.0
            time.sleep(0.002)
        gw.drain_replica("r0")
        assert clients[0].draining
        engines[0].budget = None           # let the drain finish its work
        _drive_gateway(gw, outs)
        _wait(lambda: servers[0].drained, msg="r0 drained")
        extra, estreams, efin = _tracked(prompts, [4])
        before = engines[0].steps
        gw.submit(extra[0])
        _drive_gateway(gw, outs)
        assert engines[0].steps == before  # r0 never stepped again
        for r in reqs + extra:
            got = estreams if r in extra else streams
            fin = efin if r in extra else finishes
            assert got[r.request_id] == refs[r.request_id]
            assert fin[r.request_id] == ["length"]
    finally:
        for s in servers:
            s.close()


def test_jax_client_drives_port_server(tiny, prompts, refs):
    """A JAX ``ReplicaClient`` submits JAX requests to a port
    ``ReplicaServer`` over ``/submit`` and streams them over ``/poll``:
    the control plane's JSON is shared, and the tokens are the JAX
    engine's."""
    from k8s_distributed_deeplearning_tpu.serve.request import (
        Request as JRequest)
    from k8s_distributed_deeplearning_tpu.serve.transport import (
        ReplicaClient as JClient)
    srv = ReplicaServer(_engine(tiny, "r0"), handler_timeout=60.0).start()
    try:
        client = JClient(srv.address, replica_id="r0", timeout_s=60.0,
                         backoff_s=0.01, health_refresh_s=0.0)
        streams, fins = {}, {}
        for i in (0, 1):
            rid = f"q{i}"
            client.submit(JRequest(
                prompt=list(prompts[i]), max_new_tokens=MAX_NEW,
                request_id=rid,
                on_token=lambda t, rid=rid: streams.setdefault(
                    rid, []).append(int(t)),
                on_finish=lambda r, rid=rid: fins.setdefault(
                    rid, []).append(r)))
        _drive_client(client, deadline_s=240.0)
        for rid in ("q0", "q1"):
            assert streams[rid] == refs[rid]
            assert fins[rid] == ["length"]
        assert client.num_slots == 2 and client.load() == 0
    finally:
        srv.close()


# ------------------------------------------------------------------- CLI


def _parser_of(main, monkeypatch):
    """The argparse parser a CLI's ``main`` builds, caught at its
    ``parse_args`` call."""
    import argparse

    class _Caught(Exception):
        pass

    seen = {}

    def catch(self, *a, **kw):
        seen["parser"] = self
        raise _Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Caught):
            main([])
    return seen["parser"]


def _flags(parser) -> dict:
    return {opt: act for act in parser._actions for opt in act.option_strings
            if opt.startswith("--") and opt != "--help"}


def test_cli_parses_every_jax_serve_flag(monkeypatch):
    """Every flag of the JAX serve CLI is declared by the port's and
    parses there (none exits 2 with "unrecognized arguments"); every one
    is ported (``--tp``: ``tests/test_torch_tp_serve.py``; the
    ``--autoscale*`` flags: ``tests/test_torch_autoscale.py``), with
    JAX's defaults for ``--tp`` and the autoscaler's."""
    from k8s_distributed_deeplearning_torch.serve import cli as t_cli
    from k8s_distributed_deeplearning_tpu.serve import cli as j_cli
    j_flags = _flags(_parser_of(j_cli.main, monkeypatch))
    t_parser = _parser_of(t_cli.main, monkeypatch)
    t_flags = _flags(t_parser)
    assert set(j_flags) <= set(t_flags), sorted(set(j_flags) - set(t_flags))
    samples = {int: "1", float: "0.5", None: "x"}
    for flag, act in sorted(j_flags.items()):
        if act.nargs == 0:
            argv = [flag]
        else:
            value = (act.choices[0] if act.choices
                     else samples.get(act.type, "x"))
            argv = [flag] + [str(value)] * (act.nargs if isinstance(
                act.nargs, int) else 1)
        t_parser.parse_args(argv)          # SystemExit(2) fails the test
    assert not hasattr(t_cli, "_UNPORTED")
    for flag in (f for f in j_flags
                 if f.startswith("--autoscale") or f == "--tp"):
        assert t_flags[flag].default == j_flags[flag].default, flag


def test_cli_trace_emits_spans_and_request_traces(capsys):
    """``--trace`` (which argparse refused before) puts the engine's
    spans on the JSONL stream, and ``--request-trace-sample 1`` one
    ``request_trace`` a finished request."""
    from k8s_distributed_deeplearning_torch.serve import cli as t_cli
    assert t_cli.main(["--trace", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-seq-len", "64",
                       "--prompt-len", "4", "12", "--out-len", "2", "4",
                       "--request-trace-sample", "1"]) == 0
    events = [json.loads(line) for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    spans = {e["name"] for e in events if e["event"] == "span"}
    assert {"admission", "prefill", "decode"} <= spans
    traces = [e for e in events if e["event"] == "request_trace"]
    assert len(traces) == 3
    assert events[-1]["event"] == "serve_summary"
    assert events[-1]["request_traces_sampled"] == 3


def test_cli_rejects_wire_flags_out_of_place():
    """JAX's argument checks for the wire modes, word for word."""
    from k8s_distributed_deeplearning_torch.serve import cli as t_cli
    for argv, needle in (
            (["--replica-server"], "requires --metrics-port"),
            (["--port-file", "p"], "only makes sense with --replica-server"),
            (["--role", "prefill"], "only makes sense with --replica-server"),
            (["--disagg"], "needs a remote decode fleet"),
            (["--debug-dir", "d"], "requires --metrics-port"),
            (["--request-trace-sample", "2"], "must be in [0, 1]"),
            (["--replica-endpoints", "a:1", "--replica-discovery-dir", "d"],
             "mutually exclusive")):
        with pytest.raises(SystemExit) as done:
            t_cli.main(["--device", "cpu"] + argv)
        assert done.value.code == 2, (argv, needle)


def _read_port(path: Path, proc, deadline: float) -> int:
    while time.time() < deadline:
        if path.exists() and path.read_text().strip():
            return int(path.read_text())
        assert proc.poll() is None, proc.communicate()[1][-2000:]
        time.sleep(0.1)
    raise AssertionError(f"{path} never appeared")


def test_cli_replica_servers_and_gateway_hand_over_on_sigterm(tmp_path):
    """The handshake across real process boundaries (tiny preset, CPU):
    two replica-server processes on ephemeral ports, found through their
    heartbeat beacons by a gateway process; SIGTERM to the gateway drains
    the fleet through the wire and exits 0, then SIGTERM to each replica
    drains it, prints ``replica_drained`` and ``serve_summary`` and exits
    0."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    hb = tmp_path / "hb"
    base = [sys.executable, "-u", "-m",
            "k8s_distributed_deeplearning_torch.serve", "--device", "cpu",
            "--preset", "tiny"]
    procs = []
    try:
        for i in range(2):
            procs.append(subprocess.Popen(
                base + ["--replica-server", "--max-seq-len", "64",
                        "--slots", "2", "--max-queue", "1",
                        "--metrics-port", "0",
                        "--port-file", str(tmp_path / f"port-{i}"),
                        "--heartbeat-dir", str(hb), "--replica-rank",
                        str(i)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=str(REPO)))
        deadline = time.time() + 120
        ports = [_read_port(tmp_path / f"port-{i}", p, deadline)
                 for i, p in enumerate(procs)]
        assert len(set(ports)) == 2
        gw = subprocess.Popen(
            base + ["--replica-discovery-dir", str(hb), "--requests", "256",
                    "--prompt-len", "4", "12", "--out-len", "40", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(REPO))
        procs.append(gw)
        lines = []
        while time.time() < deadline:
            line = gw.stdout.readline()
            if not line:
                break
            lines.append(line)
            if '"serve_request"' in line:
                break
        assert lines and '"serve_request"' in lines[-1], "".join(lines)
        gw.send_signal(signal.SIGTERM)
        rest, err = gw.communicate(timeout=120)
        assert gw.returncode == 0, err[-2000:]
        out = "".join(lines) + rest
        # One whole JSON event a line, the drain's events included (the
        # SIGTERM handler only flips a flag; the loop does the rest).
        assert all(json.loads(line)["event"] for line in out.splitlines())
        assert '"serve_summary"' in out
        # The tail was shed: at most 2 x (2 slots + 1 queued) requests are
        # in flight at once, and 256 of 40-50 tokens take thousands of
        # engine steps, so SIGTERM lands long before the feed runs dry.
        assert out.count('"serve_request"') < 256
        for p in procs[:2]:
            p.send_signal(signal.SIGTERM)
        for p in procs[:2]:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            assert '"replica_drained"' in out and '"serve_summary"' in out
        assert not list(hb.glob("rank-*.json"))     # beacons removed
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
