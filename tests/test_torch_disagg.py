"""PyTorch port, KV page shipping and disaggregated prefill/decode: the
port's ``export_request_kv`` / ``can_import`` / ``import_request_kv``, the
wire codec of ``serve/disagg.py`` and its ``DisaggCoordinator``, against
the JAX package on the same weights (tiny topology, f32, 64 positions).

- The codec round-trips bf16, f32 and int8 pools (and the int8 scale
  pages and a sampled request's generator state) bit for bit.
- A prefill-only engine's export, through the codec, imported into a
  decode engine, gives the greedy tokens of JAX's unified engine.
- A hop in mid-decode gives the port's own uninterrupted stream, greedy
  and sampled.
- A blob that does not fit (layers, page size, kv_quant, generator
  device, shape, dtype) is refused and the pool is left as it was.
- The coordinator with one prefill and two decode engines gives JAX's
  coordinator's tokens and counts; its fallbacks (no prefill worker, a
  worker killed mid-chunk, no engine able to adopt) keep the streams and
  hold no page.
- Engines sharing one model quantize its weights once.
- Over the wire (``serve/transport.py``, real localhost HTTP): a
  coordinator with a ``RemotePrefillWorker`` and a ``ReplicaClient``
  decode target streams JAX's tokens and discovers workers by role; the
  ``/pages`` ledger answers a re-sent transfer ``duplicate`` exactly
  once; a dropped chunk is transparent; a partition falls back without a
  double adoption; a lost ``/exports`` response re-delivers without a
  second ship; a mid-decode hop over ``/pages`` continues the stream; and
  an ambiguous ship failure retries the same target with the same key
  once, never a second target (JAX's ``tests/test_disagg.py`` cases).
"""
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch import faults as t_faults
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import (
    SamplingParams as TSampling)
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import disagg as t_disagg
from k8s_distributed_deeplearning_torch.serve import quant as t_quant
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import disagg as j_disagg

torch.set_num_threads(2)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    t_faults.deactivate()
    yield
    t_faults.deactivate()


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


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, int(n)).astype(np.int32)
            for n in (9, 23, 40, 50, 45, 33)]


@pytest.fixture(scope="module")
def refs(tiny, prompts):
    """JAX's unified engine: each prompt's greedy stream."""
    jmodel, params, _ = tiny
    eng = JEngine(jmodel, params, num_slots=2, eos_id=None)
    out = {}
    for i, p in enumerate(prompts):
        (o,) = eng.run([JRequest(prompt=list(p), max_new_tokens=MAX_NEW,
                                 request_id=f"ref{i}")])
        out[i] = o.tokens
    return out


def _mk(tiny, **kw):
    kw.setdefault("num_slots", 2)
    return TEngine(tiny[2], eos_id=None, device="cpu", **kw)


def _assert_clean(*engines):
    for eng in engines:
        c = eng.pool.counters()
        assert c["pages_used"] == 0, (eng.replica_id, c)
        assert eng.pool.reserved == 0


def _exported(src, req):
    """Submit *req* to a prefill-only engine and step until its blob."""
    src.submit(req)
    blobs = []
    while not blobs:
        src.step()
        blobs = src.take_exports()
    (blob,) = blobs
    return blob


def _wire(blob):
    return t_disagg.decode_blob(json.loads(json.dumps(
        t_disagg.encode_blob(blob))))


def _mid_decode_blob(eng, req, steps):
    eng.submit(req)
    for _ in range(steps):
        eng.step()
    return eng.export_request_kv(req.request_id)


# ---------------------------------------------------------------- codec


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_codec_round_trips_pools_bit_for_bit(kind):
    """Pages of every pool tensor (bf16 as its int16 view, int8 with its
    f32 scale pages) and a sampled request's generator state survive the
    JSON codec bit for bit, and an import writes exactly those bits into
    the new pool's pages."""
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    cfg = t_llama.config_tiny(dtype=dtype, max_seq_len=64)
    model = t_llama.LlamaLM(cfg, device="cpu", seed=3)
    kw = {"kv_quant": "int8"} if kind == "int8" else {}
    src = TEngine(model, num_slots=2, device="cpu", **kw)
    dst = TEngine(model, num_slots=2, device="cpu", **kw)
    req = TRequest(prompt=list(range(5, 45)), max_new_tokens=12,
                   sampling=TSampling(temperature=0.9), seed=7,
                   request_id="s0")
    blob = _mid_decode_blob(src, req, 3)
    want_dtypes = ({"int8", "float32"} if kind == "int8" else {kind})
    assert set(blob["page_dtypes"]) == want_dtypes
    assert len(blob["pages"]) == 2 * cfg.n_layers * (2 if kind == "int8"
                                                     else 1)
    rt = _wire(blob)
    assert "t_submit" not in rt and rt["page_dtypes"] == blob["page_dtypes"]
    for a, b in zip(rt["pages"], blob["pages"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert rt["generator_state"].tobytes() == \
        blob["generator_state"].tobytes()
    slot = dst.import_request_kv(rt)
    nb = blob["n_pages"]
    pages = torch.as_tensor(dst._tables[slot, :nb].astype(np.int64))
    for t, a in zip(dst._pool_tensors(), blob["pages"]):
        got = t.index_select(0, pages)
        got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert got.numpy().tobytes() == a.tobytes()
    assert dst.pool.owners_summary()["imported"] == nb
    dst.shutdown()
    _assert_clean(src, dst)


def test_transfer_key_and_request_from_blob(tiny):
    src = _mk(tiny)
    req = TRequest(prompt=[3, 4, 5, 6], max_new_tokens=9,
                   sampling=TSampling(temperature=0.7, top_k=5), seed=11,
                   request_id="k0", tenant="default", deadline_s=30.0)
    blob = _mid_decode_blob(src, req, 2)
    assert t_disagg.transfer_key(blob) == f"k0:{blob['kv_len']}"
    assert t_disagg.blob_nbytes(blob) == sum(a.nbytes for a in blob["pages"])
    back = t_disagg.request_from_blob(blob)
    assert (back.request_id, back.seed, back.tenant, back.deadline_s,
            back.trace_id) == ("k0", 11, "default", 30.0, req.trace_id)
    assert back.sampling == req.sampling and back.prompt == [3, 4, 5, 6]
    with pytest.raises(KeyError):
        t_disagg.decode_blob({"pages": []})


# --------------------------------------------------------- engine level


def test_prefill_only_export_import_equals_jax_unified(tiny, prompts, refs):
    """Prefill-only export -> codec -> import under ``imported`` ->
    the greedy tokens of JAX's unified engine; no page held anywhere."""
    src = _mk(tiny, prefill_only=True, replica_id="p0")
    blob = _exported(src, TRequest(prompt=list(prompts[2]),
                                   max_new_tokens=MAX_NEW,
                                   request_id="rt0"))
    _assert_clean(src)              # by value: the prefill pool is empty
    assert not src.busy()
    dst = _mk(tiny, replica_id="d0")
    assert dst.can_import(blob)
    dst.import_request_kv(_wire(blob))
    assert dst.pool.owners_summary()["imported"] == blob["n_pages"] == \
        -(-len(prompts[2]) // dst.page_tokens)
    fin = []
    while dst.busy():
        fin.extend(dst.step())
    (out,) = fin
    assert out.tokens == refs[2] and out.finish_reason == "length"
    assert src.stats.disagg_exports == dst.stats.disagg_imports == 1
    _assert_clean(dst)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_mid_decode_hop_equals_uninterrupted_stream(tiny, prompts, sampled):
    """Export at decode cursor 4 and import into another engine: the
    stream equals the port's own uninterrupted run (the generator state
    travels in the blob), and on_token fires once a token."""
    sp = TSampling(temperature=0.8, top_k=40) if sampled else TSampling()

    def req(tokens):
        return TRequest(prompt=list(prompts[1]), max_new_tokens=14,
                        sampling=sp, seed=21, request_id="h0",
                        on_token=tokens.append)

    solo = []
    (ref,) = _mk(tiny).run([req(solo)])
    streamed = []
    a, b = _mk(tiny, replica_id="a"), _mk(tiny, replica_id="b")
    r = req(streamed)
    blob = _mid_decode_blob(a, r, 4)
    assert len(blob["emitted"]) == 5
    assert (blob["generator_state"] is not None) == sampled
    assert b.can_import(blob)
    b.import_request_kv(_wire(blob), request=r)
    outs = []
    while b.busy():
        outs.extend(b.step())
    assert outs[0].tokens == ref.tokens == solo == streamed
    _assert_clean(a, b)


def _other_model(**kw):
    cfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64, **kw)
    return t_llama.LlamaLM(cfg, device="cpu", seed=1)


MISMATCHES = {
    "layers": (lambda tiny: TEngine(_other_model(n_layers=3), num_slots=2,
                                    device="cpu"), None, True),
    "page_tokens": (lambda tiny: _mk(tiny, min_bucket=16), None, False),
    "kv_quant": (lambda tiny: TEngine(_other_model(), num_slots=2,
                                      device="cpu", kv_quant="int8"),
                 None, False),
    "generator_device": (lambda tiny: _mk(tiny),
                         lambda b: b.update(generator_device="cuda"), False),
    "shape": (lambda tiny: TEngine(_other_model(n_kv_heads=4), num_slots=2,
                                   device="cpu"), None, True),
    "dtype": (lambda tiny: _mk(tiny),
              lambda b: b.update(page_dtypes=["bfloat16"]
                                 * len(b["pages"])), True),
}


@pytest.mark.parametrize("what", sorted(MISMATCHES))
def test_mismatched_blob_is_refused_and_pool_left_as_it_was(tiny, what):
    """``can_import`` says no where the blob's header shows the mismatch,
    and ``import_request_kv`` raises ValueError with the pool's counters,
    reservation and free pages unchanged (the layer count is checked
    before the allocation, the shape and dtype after it, which is rolled
    back)."""
    make, forge, in_arrays = MISMATCHES[what]
    src = _mk(tiny)
    blob = _mid_decode_blob(src, TRequest(
        prompt=list(range(1, 30)), max_new_tokens=8,
        sampling=TSampling(temperature=0.5), request_id="m0"), 2)
    if forge is not None:
        forge(blob)
    dst = make(tiny)
    before = (dst.pool.counters(), dst.pool.available(),
              dst.pool.owners_summary(), list(dst.pool._free))
    if not in_arrays:
        assert not dst.can_import(blob)
    with pytest.raises(ValueError):
        dst.import_request_kv(blob)
    assert (dst.pool.counters(), dst.pool.available(),
            dst.pool.owners_summary(), sorted(dst.pool._free)) == \
        (before[0], before[1], before[2], sorted(before[3]))
    assert not dst.busy() and dst.stats.disagg_imports == 0


def test_import_refuses_terminal_and_draining(tiny):
    src = _mk(tiny)
    blob = _mid_decode_blob(src, TRequest(prompt=[1, 2, 3],
                                          max_new_tokens=6,
                                          request_id="t0"), 2)
    dst = _mk(tiny)
    done = dict(blob, emitted=blob["emitted"] + [0] * 6)
    with pytest.raises(ValueError, match="terminal"):
        dst.import_request_kv(done)
    dst.drain()
    assert not dst.can_import(blob)
    with pytest.raises(Exception, match="draining"):
        dst.import_request_kv(blob)
    _assert_clean(dst)
    with pytest.raises(KeyError):
        src.export_request_kv("nobody")


def test_prefill_only_rejects_spec_and_remote_worker_waits(tiny):
    with pytest.raises(ValueError, match="prefill_only"):
        _mk(tiny, prefill_only=True, draft_model=tiny[2], spec_k=2)
    with pytest.raises(ValueError, match="prefill_only=True"):
        t_disagg.PrefillWorker(_mk(tiny))
    # The remote worker is ported now: it names itself after its client,
    # as the JAX worker does.
    client = types.SimpleNamespace(replica_id=None,
                                   endpoint="http://127.0.0.1:9")
    worker = t_disagg.RemotePrefillWorker(client)
    assert worker.worker_id == "http://127.0.0.1:9" and worker.alive
    client.replica_id = "p7"
    assert t_disagg.RemotePrefillWorker(client).worker_id == "p7"


def test_shared_model_quantizes_weights_once():
    """A second ``weight_quant="int8"`` engine on the same model finds it
    quantized and leaves it (the same int8 weights, the same bytes saved);
    an engine asking for fp weights or fp KV of an int8 model raises."""
    model = _other_model()
    a = TEngine(model, num_slots=2, device="cpu", weight_quant="int8",
                kv_quant="int8")
    w = {n: p.clone() for n, p in model.named_parameters()}
    b = TEngine(model, num_slots=2, device="cpu", weight_quant="int8",
                kv_quant="int8")
    assert all(torch.equal(w[n], p) for n, p in model.named_parameters())
    assert (a.stats.weight_quant_bytes_saved
            == b.stats.weight_quant_bytes_saved > 0)
    assert t_quant.fp_nbytes(model) == t_quant.fp_nbytes(_other_model())
    with pytest.raises(ValueError, match="weight_quant"):
        TEngine(model, num_slots=2, device="cpu", kv_quant="int8")
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(model, num_slots=2, device="cpu", weight_quant="int8")
    src_out = a.run([TRequest(prompt=[5, 6, 7], max_new_tokens=4)])
    assert b.run([TRequest(prompt=[5, 6, 7], max_new_tokens=4)])[0].tokens \
        == src_out[0].tokens


# ---------------------------------------------------------- coordinator


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def names(self):
        return [e for e, _ in self.events]


def test_coordinator_equals_jax_coordinator(tiny, prompts, refs):
    """One prefill and two decode engines: the port's coordinator gives
    JAX's coordinator's tokens, shipping counts and events."""
    jmodel, params, _ = tiny
    results = []
    for side in ("jax", "torch"):
        log = _Events()
        if side == "jax":
            def mk(**kw):
                return JEngine(jmodel, params, num_slots=2, eos_id=None,
                               **kw)
            mod, req_cls = j_disagg, JRequest
        else:
            def mk(**kw):
                return _mk(tiny, **kw)
            mod, req_cls = t_disagg, TRequest
        pre = mod.PrefillWorker(mk(prefill_only=True))
        d1, d2 = mk(), mk()
        coord = mod.DisaggCoordinator([d1, d2], [pre], logger=log)
        outs = coord.run([req_cls(prompt=list(prompts[i]),
                                  max_new_tokens=MAX_NEW,
                                  request_id=f"c{i}") for i in range(4)])
        results.append((
            {o.request_id: (o.tokens, o.finish_reason) for o in outs},
            [d1.stats.disagg_imports, d2.stats.disagg_imports],
            pre.engine.stats.disagg_exports, coord.stats.disagg_fallbacks,
            log.names()))
        for e in (pre.engine, d1, d2):
            assert e.pool.counters()["pages_used"] == 0
    assert results[0] == results[1]
    toks, imports, exports, fallbacks, names = results[1]
    assert {rid: t for rid, (t, _) in toks.items()} == {
        f"c{i}": refs[i] for i in range(4)}
    assert sum(imports) == exports == 4 and fallbacks == 0
    assert names.count("disagg_shipped") == 4


def test_fallback_without_prefill_worker(tiny, prompts, refs):
    dec = _mk(tiny)
    coord = t_disagg.DisaggCoordinator([dec])
    outs = coord.run([TRequest(prompt=list(prompts[0]),
                               max_new_tokens=MAX_NEW, request_id="n0")])
    assert outs[0].tokens == refs[0]
    assert coord.stats.disagg_fallbacks == 1
    assert dec.stats.disagg_imports == 0
    _assert_clean(dec)


def test_prefill_killed_mid_chunk_falls_back(tiny, prompts, refs):
    """Chunked prefill (32-token chunks); the worker is killed after one
    coordinator step, every prompt mid-chunk: every request completes
    with JAX's greedy tokens, none lost, no page held."""
    log = _Events()
    pre = t_disagg.PrefillWorker(
        _mk(tiny, prefill_only=True, num_slots=3, prefill_chunk_tokens=32),
        worker_id="pw")
    dec = _mk(tiny, num_slots=3)
    coord = t_disagg.DisaggCoordinator([dec], [pre], logger=log)
    for i in (3, 4, 5):
        coord.submit(TRequest(prompt=list(prompts[i]),
                              max_new_tokens=MAX_NEW, request_id=f"k{i}"))
    coord.step()
    assert pre.engine.stats.disagg_exports == 0
    coord.kill_prefill("pw")
    outs = []
    for _ in range(500):
        if not coord.busy():
            break
        outs.extend(coord.step())
    assert len(outs) == 3
    for o in outs:
        assert o.tokens == refs[int(o.request_id[1:])]
        assert o.finish_reason == "length"
    assert coord.stats.disagg_fallbacks == 3
    assert "disagg_prefill_down" in log.names()
    _assert_clean(dec)
    with pytest.raises(ValueError):
        coord.kill_prefill("pw")


def test_no_adopter_falls_back_and_streams_splice(tiny, prompts, refs):
    """The only decode engine has another page size, so no engine can
    adopt a blob: the coordinator resubmits prompt + first token and the
    stream still equals JAX's unified one."""
    pre = t_disagg.PrefillWorker(_mk(tiny, prefill_only=True))
    dec = _mk(tiny, min_bucket=16)
    log = _Events()
    coord = t_disagg.DisaggCoordinator([dec], [pre], logger=log)
    got = []
    outs = coord.run([TRequest(prompt=list(prompts[1]),
                               max_new_tokens=MAX_NEW, request_id="x0",
                               on_token=got.append)])
    assert outs[0].tokens == refs[1] == got
    assert coord.stats.disagg_fallbacks == 1
    fb = [f for e, f in log.events if e == "disagg_fallback"]
    assert fb[0]["reason"] == "no_decode_adopter"
    assert fb[0]["tokens_emitted"] == 1
    _assert_clean(pre.engine, dec)


def test_transport_pages_fault_falls_back(tiny, prompts, refs):
    """An injected ``transport_pages`` ioerror on the in-process shipping
    path: the blob is dropped, the request resumes by resubmission, the
    stream is JAX's."""
    plan = t_faults.FaultPlan((t_faults.Fault(
        site="transport_pages", action="ioerror", attempt=None),))
    pre = t_disagg.PrefillWorker(_mk(tiny, prefill_only=True))
    dec = _mk(tiny)
    coord = t_disagg.DisaggCoordinator([dec], [pre])
    t_faults.activate(plan)
    outs = coord.run([TRequest(prompt=list(prompts[0]),
                               max_new_tokens=MAX_NEW, request_id="f0")])
    assert t_faults.active().fired == [("transport_pages", "ioerror")]
    assert outs[0].tokens == refs[0]
    assert coord.stats.disagg_fallbacks == 1
    _assert_clean(pre.engine, dec)


# ------------------------------------------------------------------ wire


class _FakePrefill:
    """Duck-typed prefill worker: exports one single-page blob per
    submitted request on the next step."""

    def __init__(self, worker_id="p0"):
        self.worker_id = worker_id
        self.alive = True
        self._pending = []

    def submit(self, req, *, requeue=False):
        self._pending.append(req)

    def step(self):
        pass

    def take_exports(self):
        blobs = [{"request_id": r.request_id, "kv_len": len(r.prompt),
                  "n_pages": 1, "pages": [np.zeros((4,), np.float32)]}
                 for r in self._pending]
        self._pending.clear()
        return blobs

    def load(self):
        return 0


class _FakeWireDecode:
    """Wire-style decode target (no ``import_request_kv``, so the
    coordinator ships through ``ship_pages`` with a transfer key)."""

    def __init__(self, *, fail_ships=0):
        self.draining = False
        self.fail_ships = fail_ships
        self.ship_calls = []
        self.submitted = []
        self._active = []

    def load(self):
        return 0

    def busy(self):
        return bool(self._active)

    def ship_pages(self, blob, *, req=None, transfer_key=None):
        self.ship_calls.append(transfer_key)
        if self.fail_ships > 0:
            self.fail_ships -= 1
            raise OSError("injected: connection reset mid-transfer")
        self._active.append(req)
        return {"ok": True, "adopted": True}

    def submit(self, req, *, requeue=False):
        self.submitted.append(req.request_id)
        self._active.append(req)

    def step(self):
        active, self._active = self._active, []
        for req in active:
            for _ in range(req.max_new_tokens):
                req.on_token(5)
            req.on_finish("length")


def _fake_req(rid):
    return TRequest(prompt=[1, 2, 3, 4], max_new_tokens=3, request_id=rid)


def test_wire_ship_oserror_retries_same_target_same_key_once():
    flaky, other = _FakeWireDecode(fail_ships=1), _FakeWireDecode()
    coord = t_disagg.DisaggCoordinator([flaky, other], [_FakePrefill()])
    outs = coord.run([_fake_req("w0")])
    assert len(outs) == 1 and outs[0].finish_reason == "length"
    # Ambiguous failure: the SAME target, the SAME key, once more.
    assert flaky.ship_calls == ["w0:4", "w0:4"]
    assert other.ship_calls == []
    assert coord.stats.disagg_fallbacks == 0


def test_wire_ship_double_oserror_falls_back_never_second_target():
    dead, other = _FakeWireDecode(fail_ships=2), _FakeWireDecode()
    coord = t_disagg.DisaggCoordinator([dead, other], [_FakePrefill()])
    outs = coord.run([_fake_req("w1")])
    assert len(outs) == 1 and outs[0].finish_reason == "length"
    assert dead.ship_calls == ["w1:4", "w1:4"]
    assert other.ship_calls == []        # a second target could decode twice
    assert coord.stats.disagg_fallbacks == 1
    assert dead.submitted == ["w1"]      # the fallback's normal admission


def _wire_pair(tiny, hb_dir):
    """One prefill-role and one decode-role port replica server on
    ephemeral ports, with role beacons in *hb_dir*, and a client each."""
    from k8s_distributed_deeplearning_torch.serve.transport import (
        ReplicaClient, ReplicaServer)
    pre_eng = _mk(tiny, prefill_only=True)
    dec_eng = _mk(tiny)
    pre_srv = ReplicaServer(pre_eng, role="prefill", heartbeat_dir=hb_dir,
                            rank=0, handler_timeout=60.0).start()
    dec_srv = ReplicaServer(dec_eng, role="decode", heartbeat_dir=hb_dir,
                            rank=1, handler_timeout=60.0).start()
    clients = [ReplicaClient(srv.address, replica_id=name, timeout_s=60.0,
                             backoff_s=0.01, health_refresh_s=0.0,
                             rng=lambda: 1.0)
               for srv, name in ((pre_srv, "pre"), (dec_srv, "dec"))]
    return pre_eng, dec_eng, pre_srv, dec_srv, clients[0], clients[1]


def _drive(coord, deadline_s=120.0):
    outs, t0 = [], time.time()
    while coord.busy():
        outs.extend(coord.step())
        assert time.time() - t0 < deadline_s, "coordinator did not quiesce"
        time.sleep(0.002)
    return outs


def test_wire_disagg_parity_and_role_discovery(tiny, prompts, refs,
                                               tmp_path):
    """Prompt -> prefill server -> ``/exports`` -> ``/pages`` -> decode
    server: JAX's greedy tokens, each delivered once and in order (the
    first token comes from the prefill side before the blob ships), one
    export and one import; the role beacons keep discovery honest."""
    from k8s_distributed_deeplearning_torch.serve.transport import (
        discover_replica_clients)
    from k8s_distributed_deeplearning_torch.telemetry.fleet import (
        discover_endpoints)
    hb = str(tmp_path)
    pre_eng, dec_eng, pre_srv, dec_srv, pre_cli, dec_cli = _wire_pair(
        tiny, hb)
    try:
        coord = t_disagg.DisaggCoordinator(
            [dec_cli], [t_disagg.RemotePrefillWorker(pre_cli)])
        got = {}
        for i in (1, 2):
            coord.submit(TRequest(
                prompt=list(prompts[i]), max_new_tokens=MAX_NEW,
                request_id=f"wire{i}",
                on_token=lambda t, i=i: got.setdefault(i, []).append(t)))
        outs = _drive(coord)
        assert {o.request_id: o.tokens for o in outs} == {
            "wire1": refs[1], "wire2": refs[2]}
        assert got == {1: refs[1], 2: refs[2]}
        assert all(o.finish_reason == "length" for o in outs)
        assert pre_eng.stats.disagg_exports == 2
        assert dec_eng.stats.disagg_imports == 2
        assert coord.stats.disagg_fallbacks == 0
        assert discover_endpoints(hb, role="decode") == [dec_srv.address]
        assert discover_endpoints(hb, role="prefill") == [pre_srv.address]
        assert [c.endpoint for c in discover_replica_clients(hb)] == [
            f"http://{dec_srv.address}"]
        _wait_clean(pre_eng, dec_eng)
    finally:
        pre_srv.close()
        dec_srv.close()


def _wait_clean(*engines, deadline_s=30.0):
    """The servers' step loops release pages on their own threads."""
    t0 = time.time()
    while any(e.pool.counters()["pages_used"] or e.pool.reserved
              for e in engines):
        assert time.time() - t0 < deadline_s, [
            (e.replica_id, e.pool.counters()) for e in engines]
        time.sleep(0.01)


def test_wire_pages_ledger_answers_duplicate_exactly_once(tiny, prompts,
                                                          refs, tmp_path):
    """A re-sent transfer (the same key) gets the ORIGINAL adoption
    result back: one import, one decode stream, no second slot."""
    _, dec_eng, pre_srv, dec_srv, _, dec_cli = _wire_pair(
        tiny, str(tmp_path))
    src = _mk(tiny, prefill_only=True)
    try:
        blob = _exported(src, TRequest(prompt=list(prompts[2]),
                                       max_new_tokens=MAX_NEW,
                                       request_id="led0"))
        key = t_disagg.transfer_key(blob)
        emitted = [int(t) for t in blob["emitted"]]
        got, fin = [], []
        req = t_disagg.request_from_blob(blob)
        req.on_token = got.append
        req.on_finish = fin.append
        body1 = dec_cli.ship_pages(blob, req=req, transfer_key=key,
                                   chunk_chars=4096)
        assert body1["adopted"] and not body1.get("duplicate")
        body2 = dec_cli.ship_pages(blob, transfer_key=key)
        assert body2.get("duplicate") is True
        assert body2["slot"] == body1["slot"]
        assert dec_eng.stats.disagg_imports == 1
        assert dec_eng.stats.transport_dedup_hits == 1
        t0 = time.time()
        while not fin:
            dec_cli.step()
            assert time.time() - t0 < 120.0
        assert emitted + got == refs[2] and fin == ["length"]
        _wait_clean(src, dec_eng)
    finally:
        pre_srv.close()
        dec_srv.close()


def test_wire_drop_fault_is_transparent(tiny, prompts, refs, tmp_path):
    """``transport_pages`` drop (count=1): the chunk vanishes, the bounded
    retry re-sends it, adoption happens once and the stream is JAX's."""
    pre_eng, dec_eng, pre_srv, dec_srv, pre_cli, dec_cli = _wire_pair(
        tiny, str(tmp_path))
    try:
        coord = t_disagg.DisaggCoordinator(
            [dec_cli], [t_disagg.RemotePrefillWorker(pre_cli)])
        coord.submit(TRequest(prompt=list(prompts[0]),
                              max_new_tokens=MAX_NEW, request_id="drop0"))
        inj = t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
            site="transport_pages", action="drop", count=1),)))
        outs = _drive(coord)
        assert ("transport_pages", "drop") in inj.fired
        assert outs[0].tokens == refs[0]
        assert dec_eng.stats.disagg_imports == 1
        assert coord.stats.disagg_fallbacks == 0
        _wait_clean(pre_eng, dec_eng)
    finally:
        dec_srv.close()
        pre_srv.close()


def test_wire_partition_falls_back_without_double_adopt(tiny, prompts,
                                                        refs, tmp_path):
    """A ``transport_pages`` partition: every ship attempt (the
    coordinator's one same-target retry included) fails, the request
    falls back through normal decode admission with JAX's tokens, and is
    adopted zero times."""
    pre_eng, dec_eng, pre_srv, dec_srv, pre_cli, dec_cli = _wire_pair(
        tiny, str(tmp_path))
    try:
        coord = t_disagg.DisaggCoordinator(
            [dec_cli], [t_disagg.RemotePrefillWorker(pre_cli)])
        coord.submit(TRequest(prompt=list(prompts[0]),
                              max_new_tokens=MAX_NEW, request_id="part0"))
        t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
            site="transport_pages", action="partition", seconds=600.0),)))
        outs = _drive(coord)
        assert outs[0].tokens == refs[0]
        assert outs[0].finish_reason == "length"
        assert coord.stats.disagg_fallbacks == 1
        assert dec_eng.stats.disagg_imports == 0, "no double adoption"
        _wait_clean(pre_eng, dec_eng)
    finally:
        t_faults.deactivate()
        dec_srv.close()
        pre_srv.close()


def test_wire_lost_exports_response_redelivers_once(tiny, prompts, refs,
                                                    tmp_path):
    """The prefill server's ``/exports`` response is lost after the
    handler ran (``transport_recv`` drop): the hold re-delivers the blob
    on the retry, the client hands it over once, and the stream is
    JAX's."""
    pre_eng, dec_eng, pre_srv, dec_srv, pre_cli, dec_cli = _wire_pair(
        tiny, str(tmp_path))
    try:
        pre_cli.submit(TRequest(prompt=list(prompts[1]),
                                max_new_tokens=MAX_NEW, request_id="ex0"))
        t0 = time.time()
        while pre_eng.stats.disagg_exports == 0:
            assert time.time() - t0 < 60.0
            time.sleep(0.005)
        t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
            site="transport_recv", action="drop", count=1),)))
        try:
            blobs = pre_cli.take_remote_exports()
        finally:
            t_faults.deactivate()
        assert [b["request_id"] for b in blobs] == ["ex0"]
        assert pre_cli.stats.transport_retries == 1
        assert pre_cli.take_remote_exports() == []      # acked, dropped
        assert pre_srv._export_hold == {}
        got, fin = [], []
        req = t_disagg.request_from_blob(blobs[0])
        req.on_token, req.on_finish = got.append, fin.append
        dec_cli.ship_pages(blobs[0], req=req)
        while not fin:
            dec_cli.step()
            assert time.time() - t0 < 120.0
        assert [int(t) for t in blobs[0]["emitted"]] + got == refs[1]
    finally:
        dec_srv.close()
        pre_srv.close()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_wire_mid_decode_hop_equals_uninterrupted(tiny, prompts, sampled,
                                                  tmp_path):
    """A request exported at decode cursor 4 and shipped over ``/pages``
    into a decode server continues the port's own uninterrupted stream,
    greedy and sampled (the generator state travels in the blob)."""
    sp = (TSampling(temperature=0.9, top_k=20) if sampled
          else TSampling())

    def req(**kw):
        return TRequest(prompt=list(prompts[3]), max_new_tokens=MAX_NEW,
                        sampling=sp, seed=11, request_id="hop0", **kw)

    (want,) = _mk(tiny).run([req()])
    _, dec_eng, pre_srv, dec_srv, _, dec_cli = _wire_pair(
        tiny, str(tmp_path))
    try:
        blob = _mid_decode_blob(_mk(tiny), req(), 4)
        assert len(blob["emitted"]) == 5       # decode cursor 4
        got, fin = [], []
        r = t_disagg.request_from_blob(blob)
        r.on_token, r.on_finish = got.append, fin.append
        assert dec_cli.ship_pages(blob, req=r, chunk_chars=65536)["adopted"]
        t0 = time.time()
        while not fin:
            dec_cli.step()
            assert time.time() - t0 < 120.0
        assert [int(t) for t in blob["emitted"]] + got == want.tokens
    finally:
        pre_srv.close()
        dec_srv.close()
