"""Rank worker for tests/test_torch_tp_serve.py: tensor-parallel serving
on a gloo world of CPU processes.

Imports torch and the port only, so the spawned rank processes never
import JAX. Each rank joins the tp world (``serve/tp.py`` ``init_world``)
on localhost. In a world of two, every rank first checks the model's
all-reduce on single modules (sharded Attention and MLP against the
whole module); then rank 0 drives the serving scenarios named in
``<dir>/in.json`` while the other ranks run the real follower loop. The
weights come from ``<dir>/in.npz`` (port state dicts, keyed by model);
rank 0 writes the streams to ``<dir>/out.json``, and every rank writes
``<dir>/rank_<r>.json``: how many distinct pool pointer sets each of its
shards showed over all its programs (1 = the pool is updated in place).
"""
import json

import numpy as np
import torch

from k8s_distributed_deeplearning_torch.models import llama
from k8s_distributed_deeplearning_torch.models.transformer import (
    MLP, Attention)
from k8s_distributed_deeplearning_torch.parallel import sharding
from k8s_distributed_deeplearning_torch.serve import (Request,
                                                      SamplingParams,
                                                      ServeEngine)
from k8s_distributed_deeplearning_torch.serve import tp as tp_lib
from k8s_distributed_deeplearning_torch.serve.gateway import ServeGateway
from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats

TINY = dict(max_seq_len=128, dtype=torch.float32)
DRAFT = dict(dim=32, n_layers=1, n_heads=2, n_kv_heads=2, mlp_dim=64)


def _model(data, key, **over):
    cfg = llama.config_tiny(**TINY, **over)
    model = llama.LlamaLM(cfg, device="cpu")
    prefix = f"{key}/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v.copy())
                           for k, v in data.items() if k.startswith(prefix)})
    return model


def mixed_reqs(vocab, seed=0, tag="r", greedy=False):
    """JAX's ``_mixed_reqs`` (tests/test_tp_serve.py): 4 requests,
    greedy/sampled alternating (all greedy with ``greedy``), two sharing a
    24-token prefix, lengths that cross the chunked-prefill bucket."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=24).astype(np.int32)
    reqs = []
    for i, n in enumerate((7, 19, 34, 12)):
        tail = rng.integers(1, vocab, size=n).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i >= 2 else tail
        sp = (SamplingParams() if i % 2 == 0 or greedy else
              SamplingParams(temperature=0.8, top_k=20, top_p=0.9))
        reqs.append(Request(prompt=prompt, max_new_tokens=12, sampling=sp,
                            seed=i + 1, request_id=f"{tag}{i}"))
    return reqs


def migration_reqs(vocab):
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(1, vocab, size=9 + 3 * i).astype(
                        np.int32), max_new_tokens=10 + i, request_id=f"m{i}")
            for i in range(4)]


def _tokens(outs):
    return {o.request_id: [int(t) for t in o.tokens] for o in outs}


def _check(eng, out):
    out.setdefault("consistent", []).append(eng.tp_consistency_check())
    eng.close()


def _mixed(data, tp, out):
    model = _model(data, "target")
    res = {}
    for t in sorted({0, tp}):
        eng = ServeEngine(model, num_slots=4, min_bucket=8,
                          prefill_chunk_tokens=16, prefix_cache_mb=4,
                          device="cpu", tp=t)
        toks = _tokens(eng.run(mixed_reqs(model.cfg.vocab_size)))
        toks.update(_tokens(eng.run(mixed_reqs(model.cfg.vocab_size,
                                               tag="s"))))
        res[str(t)] = {"tokens": toks,
                       "hits": eng.stats.summary()["prefix_cache_hits"]}
        if t:
            _check(eng, out)
    out["mixed"] = res


def _spec(data, tp, out):
    model, draft = _model(data, "target"), _model(data, "draft", **DRAFT)
    res = {}
    for t in sorted({0, tp}):
        eng = ServeEngine(model, num_slots=4, min_bucket=8, device="cpu",
                          draft_model=draft, spec_k=4, tp=t)
        res[str(t)] = {"tokens": _tokens(eng.run(mixed_reqs(
            model.cfg.vocab_size))), "spec_steps": eng.stats.spec_steps}
        if t:
            _check(eng, out)
    plain = ServeEngine(model, num_slots=4, min_bucket=8, device="cpu",
                        tp=tp)
    res["plain"] = _tokens(plain.run(mixed_reqs(model.cfg.vocab_size)))
    _check(plain, out)
    out["spec"] = res


def _migration(data, tp, out):
    model = _model(data, "target")
    stats = ServingStats()
    engines = [ServeEngine(model, num_slots=2, eos_id=None, min_bucket=8,
                           stats=stats, replica_id=f"r{i}", device="cpu",
                           tp=tp) for i in range(2)]
    gw = ServeGateway(engines, stats=stats)
    for req in migration_reqs(model.cfg.vocab_size):
        gw.submit(req)
    outs = []
    for _ in range(3):                       # both replicas mid-decode
        outs.extend(gw.step())
    gw.drain_replica("r0")
    for _ in range(600):
        if not gw.busy():
            break
        outs.extend(gw.step())
    out["migration"] = {"tokens": _tokens(outs), "busy": gw.busy(),
                        "migrations": stats.gateway_migrations}
    for eng in engines:
        _check(eng, out)


def _int8(data, tp, out):
    model = _model(data, "scanned")
    eng = ServeEngine(model, num_slots=4, min_bucket=8, device="cpu",
                      kv_quant="int8", weight_quant="int8", tp=tp)
    toks = _tokens(eng.run(mixed_reqs(model.cfg.vocab_size, greedy=True)))
    out["int8"] = {"tokens": toks, "weight_quant_bytes_saved":
                   eng.stats.summary()["weight_quant_bytes_saved"],
                   "kv_quant_bytes_saved":
                   eng.stats.summary()["kv_quant_bytes_saved"]}
    _check(eng, out)


def _handoff(model, reqs, pre_tp, dec_tp, out, **kw):
    """A prefill-only engine's exports imported by a decode engine."""
    pre = ServeEngine(model, num_slots=4, min_bucket=8, prefill_only=True,
                      device="cpu", tp=pre_tp, **kw)
    dec = ServeEngine(model, num_slots=4, min_bucket=8, device="cpu",
                      tp=dec_tp, **kw)
    for req in reqs:
        pre.submit(req)
    outs, blobs = [], []
    while pre.busy():
        outs.extend(pre.step())
        blobs.extend(pre.take_exports())
    for blob in blobs:
        dec.import_request_kv(blob)
    outs.extend(dec.run())
    widths = [list(np.asarray(a).shape) for a in blobs[0]["pages"]]
    for eng in (pre, dec):
        if eng.tp:
            _check(eng, out)
    return _tokens(outs), widths


def _export(data, tp, out):
    model = _model(data, "target")
    vocab = model.cfg.vocab_size
    unified = ServeEngine(model, num_slots=4, min_bucket=8, device="cpu")
    res = {"unified": _tokens(unified.run(mixed_reqs(vocab)))}
    res["tp_to_0"], res["widths_tp"] = _handoff(model, mixed_reqs(vocab),
                                                tp, 0, out)
    res["0_to_tp"], res["widths_0"] = _handoff(model, mixed_reqs(vocab),
                                               0, tp, out)
    out["export"] = res


def _deep(data, tp, out):
    """Handoffs at depths whose import carries more pool tensors than one
    header broadcast describes: 6 layers fp (2 tensors a layer) and 3
    layers under int8 KV (4 a layer), seeded weights."""
    res = {}
    for name, layers, kw in (("fp6", 6, {}),
                             ("int8_3", 3, {"kv_quant": "int8"})):
        model = llama.LlamaLM(llama.config_tiny(**TINY, n_layers=layers),
                              device="cpu", seed=5)
        vocab = model.cfg.vocab_size
        unified = ServeEngine(model, num_slots=4, min_bucket=8,
                              device="cpu", **kw)
        r = {"unified": _tokens(unified.run(mixed_reqs(vocab))),
             "pool_tensors": len(unified._pool_tensors())}
        r["tp_to_0"], _ = _handoff(model, mixed_reqs(vocab), tp, 0, out,
                                   **kw)
        r["0_to_tp"], _ = _handoff(model, mixed_reqs(vocab), 0, tp, out,
                                   **kw)
        res[name] = r
    out["deep"] = res


def _donation(data, tp, out):
    model = _model(data, "target")
    eng = ServeEngine(model, num_slots=2, eos_id=None, device="cpu", tp=tp)
    eng.submit(Request(prompt=np.arange(1, 9, dtype=np.int32),
                       max_new_tokens=8))
    for _ in range(10):
        if eng.occupied_slots():
            break
        eng.step()
    before = [t.data_ptr() for t in eng._pool_tensors()]
    eng.step()                               # a pure decode step
    after = [t.data_ptr() for t in eng._pool_tensors()]
    out["donation"] = {"same": before == after,
                       "pool_lanes": [t.shape[-1]
                                      for t in eng._pool_tensors()],
                       "keeps_model": eng.model is not None}
    _check(eng, out)


def _gauge(data, tp, out):
    """The ``serve_tp`` gauge over a tp engine and a single-device one."""
    from k8s_distributed_deeplearning_torch.telemetry import bridge
    from k8s_distributed_deeplearning_torch.telemetry.registry import (
        MetricsRegistry)

    model = _model(data, "target")
    engines = [ServeEngine(model, num_slots=2, replica_id="r0", device="cpu",
                           tp=tp),
               ServeEngine(model, num_slots=2, replica_id="r1",
                           device="cpu")]
    reg = MetricsRegistry()
    bridge.tp_collector(reg, engines)
    out["gauge"] = reg.render()
    _check(engines[0], out)


SCENARIOS = {"mixed": _mixed, "spec": _spec, "migration": _migration,
             "int8": _int8, "export": _export, "deep": _deep,
             "donation": _donation,
             "gauge": _gauge}


def _modules(rank, world, directory):
    """Sharded Attention and MLP (each rank its slice, the all-reduce in
    the module) against the whole module, on the same seeded weights and
    input: ``<dir>/mod_<rank>.npz``."""
    cfg = llama.config_tiny(**TINY)
    local = tp_lib.local_spec(llama.LlamaLM(cfg, device="cpu"), world)[2]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, cfg.dim)).astype(np.float32))
    res = {}
    for name, cls in (("attn", Attention), ("mlp", MLP)):
        gen = torch.Generator().manual_seed(1)
        whole = cls(cfg, device="cpu")
        for p in whole.parameters():
            with torch.no_grad():
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
        part = cls(local, device="cpu")
        state = whole.state_dict()
        part.load_state_dict({k: sharding.serve_tp_shard(k, v, rank, world)
                              for k, v in state.items()})
        kw = {"rope": None} if name == "attn" else {}
        with torch.no_grad():
            res[f"{name}_whole"] = whole(x, **kw).numpy()
            res[f"{name}_tp"] = part(x, **kw).numpy()
    np.savez(f"{directory}/mod_{rank}.npz", **res)


def _count_pools():
    """Wrap ``Shard.run``: after every program, note each shard's pool
    pointers. Returns the record."""
    seen: dict[int, set] = {}
    run = tp_lib.Shard.run

    def counted(self, prog, args, ops):
        result = run(self, prog, args, ops)
        if not hasattr(self, "_seen_key"):   # ids of dead shards recur
            self._seen_key = len(seen)
        seen.setdefault(self._seen_key, set()).add(
            tuple(t.data_ptr() for t in self.pool_tensors()))
        return result

    tp_lib.Shard.run = counted
    return seen


def run_rank(rank: int, world: int, port: int, directory: str) -> None:
    torch.set_num_threads(1)
    with open(f"{directory}/in.json") as f:
        scenarios = json.load(f)["scenarios"]
    tpw = tp_lib.init_world(rank, world, port, "cpu", timeout_s=120)
    seen = _count_pools()
    try:
        if world > 1:
            _modules(rank, world, directory)
        if rank:
            tp_lib.follow(tpw)
        else:
            data = dict(np.load(f"{directory}/in.npz"))
            out = {"backend": tpw.backend}
            for name in scenarios:
                SCENARIOS[name](data, world, out)
            with open(f"{directory}/out.json", "w") as f:
                json.dump(out, f)
    finally:
        if rank == 0:
            tp_lib.shutdown()
        else:
            tp_lib.leave()
    with open(f"{directory}/rank_{rank}.json", "w") as f:
        json.dump({"shards": len(seen),
                   "pointer_sets": max((len(v) for v in seen.values()),
                                       default=0)}, f)
