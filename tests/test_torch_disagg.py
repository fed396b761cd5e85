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
"""
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_disagg.RemotePrefillWorker(object())


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
