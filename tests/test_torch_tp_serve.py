"""PyTorch port, tensor-parallel serving: ``ServeEngine(tp=k)`` over a gloo
world of CPU processes, against the JAX package's ``ServeEngine(tp=k)``
(``tests/test_tp_serve.py``) on the same weights.

Two spawned worlds (``tests/torch_tp_worker.py``: rank 0 drives, the
other rank runs the real follower loop), each with its own deadline, run
every serving scenario once; the JAX engines run here, on the fake
8-device CPU mesh of ``tests/conftest.py``:

- greedy streams of the port at tp=2 equal the JAX engine's at tp=2, and
  at tp=1 (a world of one) the JAX engine's at tp=0, for mixed sampling
  with prefix hits and chunked prefill, speculative decoding and the
  gateway's mid-decode drain migration; sampled streams equal the port's
  own tp=0 streams for the same seeds;
- int8 KV with int8 weights at tp=2 equal JAX's tp=2 int8 engine;
- a tp=2 prefill-only engine's exports, decoded by a tp=0 engine (and
  the other way round), give the unified engine's stream, on full-width
  pages, also at depths whose import header needs two broadcasts;
- every rank's pool keeps its pointers over every program (the port's
  reading of JAX's donation tests), and every rank's last logits are
  bit-equal at the end of each scenario;
- sharded Attention and MLP outputs equal the whole module's within
  1e-5 (f32).

The ``serve_tp`` gauge over a real tp engine comes from the world of two
too. In process: the constructor's refusals (JAX's messages), the launch
layer (``render``/``validate`` with serve_tp), the serve CLI's ``--tp``,
the rule table's shards and the mesh module.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_tp_worker
from k8s_distributed_deeplearning_torch.config import JobConfig as TJob
from k8s_distributed_deeplearning_torch.launch import render as t_render
from k8s_distributed_deeplearning_torch.launch import validate as t_validate
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.models import transformer as t_tf
from k8s_distributed_deeplearning_torch.parallel import mesh as t_mesh
from k8s_distributed_deeplearning_torch.parallel import sharding as t_shard
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import tp as t_tp
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import SamplingParams as JSP
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import ServeGateway as JGateway
from k8s_distributed_deeplearning_tpu.utils.metrics import ServingStats

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240        # each world's own deadline
MODULE_ATOL = 1e-5           # sharded vs whole module, f32
SCENARIOS = {2: ["mixed", "spec", "migration", "int8", "export", "deep",
                 "donation", "gauge"],
             1: ["mixed", "spec", "migration", "donation"]}


# ------------------------------------------------------------ the weights


def _jax_model(seed=0, scan_layers=False, **over):
    cfg = j_llama.config_tiny(max_seq_len=128, dtype=jnp.float32,
                              scan_layers=scan_layers, **over)
    model = j_llama.LlamaLM(cfg)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


@pytest.fixture(scope="module")
def weights():
    """JAX's fixtures (``tests/test_tp_serve.py`` ``tiny``/``draft``),
    plus a scanned tiny for the int8 case, and the port's state dicts
    converted from them."""
    out = {"target": _jax_model(0),
           "draft": _jax_model(1, **torch_tp_worker.DRAFT),
           "scanned": _jax_model(0, scan_layers=True)}
    state = {}
    for key, (jm, params) in out.items():
        over = torch_tp_worker.DRAFT if key == "draft" else {}
        tcfg = t_llama.config_tiny(**torch_tp_worker.TINY, **over)
        for name, v in t_convert.from_flax_params(tcfg, params).items():
            state[f"{key}/{name}"] = v.numpy()
    return out, state


def _spawn(tmp: Path, world: int, state: dict) -> dict:
    """Run a tp world of ``world`` gloo ranks over the scenarios of
    :data:`SCENARIOS`; a rank that raises fails the test, a world still
    running after :data:`SPAWN_TIMEOUT_S` is killed and fails it."""
    np.savez(tmp / "in.npz", **state)
    (tmp / "in.json").write_text(json.dumps(
        {"scenarios": SCENARIOS[world]}))
    # The store's port is bound as it is picked: no other test's world
    # can take it between the pick and the ranks' connect.
    store = t_tp.store_server(world, SPAWN_TIMEOUT_S)
    ctx = mp.spawn(torch_tp_worker.run_rank,
                   args=(world, store.port, str(tmp)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the tp world of {world} did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    out = json.loads((tmp / "out.json").read_text())
    out["ranks"] = [json.loads((tmp / f"rank_{r}.json").read_text())
                    for r in range(world)]
    out["modules"] = ([dict(np.load(tmp / f"mod_{r}.npz"))
                       for r in range(world)] if world > 1 else [])
    return out


@pytest.fixture(scope="module")
def port2(weights, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("tp2"), 2, weights[1])


@pytest.fixture(scope="module")
def port1(weights, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("tp1"), 1, weights[1])


# ------------------------------------------------------- the JAX side


def _jreqs(vocab, tag="r", greedy=False):
    return [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                     sampling=(JSP() if r.sampling.temperature <= 0 else
                               JSP(temperature=r.sampling.temperature,
                                   top_k=r.sampling.top_k,
                                   top_p=r.sampling.top_p)),
                     seed=r.seed, request_id=r.request_id)
            for r in torch_tp_worker.mixed_reqs(vocab, tag=tag,
                                                greedy=greedy)]


def _jtokens(outs):
    return {o.request_id: [int(t) for t in o.tokens] for o in outs}


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engines' streams, scenario by scenario, at tp=2 and tp=0
    (JAX's own tests hold tp=0 == tp=1 == tp=2)."""
    (model, params), (dmodel, dparams), (smodel, sparams) = (
        weights[0]["target"], weights[0]["draft"], weights[0]["scanned"])
    vocab = model.cfg.vocab_size
    out = {}
    for tp in (0, 2):
        eng = JEngine(model, params, num_slots=4, min_bucket=8,
                      prefill_chunk_tokens=16, prefix_cache_mb=4, tp=tp)
        toks = _jtokens(eng.run(_jreqs(vocab)))
        toks.update(_jtokens(eng.run(_jreqs(vocab, tag="s"))))
        out[("mixed", tp)] = toks
        eng = JEngine(model, params, num_slots=4, min_bucket=8,
                      draft_model=dmodel, draft_params=dparams, spec_k=4,
                      tp=tp)
        out[("spec", tp)] = _jtokens(eng.run(_jreqs(vocab)))
        stats = ServingStats()
        engines = [JEngine(model, params, num_slots=2, eos_id=None,
                           min_bucket=8, stats=stats, replica_id=f"r{i}",
                           tp=tp) for i in range(2)]
        gw = JGateway(engines, stats=stats)
        for r in torch_tp_worker.migration_reqs(vocab):
            gw.submit(JRequest(prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens,
                               request_id=r.request_id))
        outs = []
        for _ in range(3):
            outs.extend(gw.step())
        gw.drain_replica("r0")
        for _ in range(600):
            if not gw.busy():
                break
            outs.extend(gw.step())
        out[("migration", tp)] = _jtokens(outs)
    eng = JEngine(smodel, sparams, num_slots=4, min_bucket=8,
                  kv_quant="int8", weight_quant="int8", tp=2)
    out[("int8", 2)] = _jtokens(eng.run(_jreqs(vocab, greedy=True)))
    return out


def _greedy(tokens: dict) -> dict:
    """The greedy requests' streams (even index: r0, r2, s0, s2)."""
    return {k: v for k, v in tokens.items() if int(k[-1]) % 2 == 0}


# ------------------------------------------------------------ streams


@pytest.mark.parametrize("world", [2, 1])
def test_mixed_streams_equal_jax(world, port1, port2, jax_streams):
    """Mixed greedy/sampled requests through prefix hits and chunked
    prefill: greedy streams equal JAX's (tp=2 at tp=2, tp=0 at tp=1),
    sampled ones the port's tp=0 streams, with trie hits on both."""
    run = (port2 if world == 2 else port1)["mixed"]
    port = run[str(world)]
    assert port["hits"] >= 1 and run["0"]["hits"] >= 1
    assert port["tokens"] == run["0"]["tokens"]
    jax_tp = 2 if world == 2 else 0
    assert _greedy(port["tokens"]) == _greedy(jax_streams[("mixed", jax_tp)])


@pytest.mark.parametrize("world", [2, 1])
def test_speculative_streams_equal_jax(world, port1, port2, jax_streams):
    """Draft/verify at spec_k 4 with a draft whose KV heads split: the
    sharded draft pool, the verify window and rank 0's accept
    bookkeeping agree with JAX's engine and the port's tp=0 one, and
    spec equals plain under tp."""
    run = (port2 if world == 2 else port1)["spec"]
    port = run[str(world)]
    assert port["spec_steps"] > 0
    assert port["tokens"] == run["0"]["tokens"] == run["plain"]
    jax_tp = 2 if world == 2 else 0
    assert _greedy(port["tokens"]) == _greedy(jax_streams[("spec", jax_tp)])


@pytest.mark.parametrize("world", [2, 1])
def test_drain_migration_streams_equal_jax(world, port1, port2,
                                           jax_streams):
    """Two tp engines in one rank-0 process behind the gateway; a drain
    with both mid-decode migrates, and the streams equal JAX's."""
    mig = (port2 if world == 2 else port1)["migration"]
    assert not mig["busy"] and mig["migrations"] >= 1
    jax_tp = 2 if world == 2 else 0
    assert mig["tokens"] == jax_streams[("migration", jax_tp)]


def test_int8_streams_equal_jax(port2, jax_streams):
    """Int8 KV and int8 weights at tp=2 (each rank's weights at the int8
    grid points, its int8 pool and scales on its KV heads) equal JAX's
    tp=2 int8 engine; the weight bytes saved read 0, as JAX's under
    tp."""
    run = port2["int8"]
    assert run["tokens"] == jax_streams[("int8", 2)]
    assert run["weight_quant_bytes_saved"] == 0
    assert run["kv_quant_bytes_saved"] > 0


def test_export_import_full_width_pages(port2):
    """A tp=2 prefill-only engine's blobs, decoded by a tp=0 engine, and a
    tp=0 prefill engine's, decoded by a tp=2 engine, give the unified
    engine's streams; the blob pages are full width either way."""
    run = port2["export"]
    assert run["tp_to_0"] == run["unified"]
    assert run["0_to_tp"] == run["unified"]
    assert run["widths_tp"] == run["widths_0"]
    lanes = (t_llama.config_tiny().resolved_kv_heads
             * t_llama.config_tiny().resolved_head_dim)
    assert all(w[-1] == lanes for w in run["widths_tp"])


@pytest.mark.parametrize("case", ["fp6", "int8_3"])
def test_deep_export_import_spans_two_header_broadcasts(case, port2):
    """Handoffs at 6 layers fp and at 3 under int8 KV, both ways: an
    import's header (5 words, the page index's 3, then dtype, rank and 3
    dims a pool tensor) passes the :data:`serve.tp._HEADER` words of one
    broadcast, and both give the unified engine's streams."""
    run = port2["deep"][case]
    assert 5 + 3 + 5 * run["pool_tensors"] > t_tp._HEADER
    assert run["tp_to_0"] == run["unified"]
    assert run["0_to_tp"] == run["unified"]


@pytest.mark.parametrize("world", [2, 1])
def test_pool_updates_in_place_on_every_rank(world, port1, port2):
    """Every shard on every rank kept one set of pool pointers over all
    its programs, a pure decode step included (the port's reading of
    JAX's donation tests); each rank's pool holds its kv/tp heads'
    lanes; the engine keeps no model (the weights live in the shards);
    and every tp engine's ranks ended with bit-equal logits."""
    run = port2 if world == 2 else port1
    assert run["donation"]["same"]
    assert not run["donation"]["keeps_model"]
    lanes = (t_llama.config_tiny().resolved_kv_heads
             * t_llama.config_tiny().resolved_head_dim)
    assert set(run["donation"]["pool_lanes"]) == {lanes // world}
    for rank in run["ranks"]:
        assert rank["shards"] >= 1 and rank["pointer_sets"] == 1
    assert run["consistent"] and all(run["consistent"])
    assert run["backend"] == "gloo"


@pytest.mark.parametrize("module", ["attn", "mlp"])
def test_sharded_module_all_reduce_equals_whole(module, port2):
    """Each rank's Attention/MLP slice, all-reduced in the module, equals
    the whole module on the same input within :data:`MODULE_ATOL`."""
    for mod in port2["modules"]:
        np.testing.assert_allclose(mod[f"{module}_tp"],
                                   mod[f"{module}_whole"], rtol=0,
                                   atol=MODULE_ATOL)


# --------------------------------------------- in process, no world


@pytest.fixture(scope="module")
def tiny_port():
    return t_llama.LlamaLM(t_llama.config_tiny(**torch_tp_worker.TINY),
                           device="cpu")


def test_tp_ctor_rejects_indivisible_heads(tiny_port):
    # config_tiny: n_heads=4, n_kv_heads=2 — tp=3 divides neither.
    with pytest.raises(ValueError, match="n_heads.*not divisible by tp"):
        TEngine(tiny_port, num_slots=2, device="cpu", tp=3)


def test_tp_ctor_rejects_indivisible_kv_heads():
    cfg = t_llama.config_tiny(max_seq_len=64, dtype=torch.float32,
                              n_heads=4, n_kv_heads=1)
    with pytest.raises(ValueError, match="num_kv_heads.*try tp in"):
        TEngine(t_llama.LlamaLM(cfg, device="cpu"), num_slots=2,
                device="cpu", tp=2)


def test_tp_ctor_rejects_indivisible_draft(tiny_port):
    """The micro draft (one KV head) under a shardable target: the error
    names the draft."""
    cfg = tiny_port.cfg
    dcfg = t_llama.config_tiny(vocab_size=cfg.vocab_size, dim=32,
                               n_layers=1, n_heads=2, n_kv_heads=1,
                               mlp_dim=64, max_seq_len=cfg.max_seq_len,
                               dtype=cfg.dtype)
    with pytest.raises(ValueError, match="draft model.*not divisible"):
        TEngine(tiny_port, num_slots=2, device="cpu", spec_k=2, tp=2,
                draft_model=t_llama.LlamaLM(dcfg, device="cpu"))


def test_tp_ctor_rejects_too_small_a_world(tiny_port):
    """The world-size check (JAX's device count): no tp world in this
    process, so a shardable tp=2 is refused, naming the fix."""
    assert t_tp.current() is None
    with pytest.raises(ValueError, match=r"tp world of 2 ranks.*"
                       r"serve\.tp\.launch\(2\)"):
        TEngine(tiny_port, num_slots=2, device="cpu", tp=2)


def test_tp_ctor_rejects_negative_and_biased_activation(tiny_port):
    with pytest.raises(ValueError, match="tp must be >= 0"):
        TEngine(tiny_port, num_slots=2, device="cpu", tp=-1)
    cfg = t_llama.config_tiny(max_seq_len=64, dtype=torch.float32,
                              activation="gelu")
    with pytest.raises(ValueError, match="bias-free down projection"):
        TEngine(t_llama.LlamaLM(cfg, device="cpu"), num_slots=2,
                device="cpu", tp=2)


def test_tp_axis_refuses_gelu_and_factory_mlps():
    """The model's two refusals under ``tp_axis``, JAX's messages."""
    cfg = t_llama.config_tiny(activation="gelu", tp_axis="tp")
    with pytest.raises(NotImplementedError,
                       match="bias-free down projection"):
        t_tf.MLP(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="only the dense MLP"):
        t_tf.Block(t_llama.config_tiny(tp_axis="tp"), device="cpu",
                   mlp_factory=lambda c, device=None: t_tf.MLP(c, device))


def test_rule_table_shards_whole_heads(tiny_port):
    """The serving rule table: q/k/v and gate/up by output rows, o_proj
    and down by input columns, everything else whole; the slices of all
    ranks put back together give the tensor; the pool's last dim splits
    into whole KV heads."""
    specs = t_shard.serve_tp_param_specs(tiny_port)
    state = tiny_port.state_dict()
    split = {n: d for n, d in specs.items() if d is not None}
    assert {n.split(".")[-2] for n in split} == {
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj"}
    assert all(d == (1 if n.split(".")[-2] in ("o_proj", "down_proj")
                     else 0) for n, d in split.items())
    for name, full in state.items():
        parts = [t_shard.serve_tp_shard(name, full, r, 2) for r in (0, 1)]
        dim = specs[name]
        if dim is None:
            assert all(p is full for p in parts)
        else:
            assert torch.equal(torch.cat(parts, dim), full)
            assert t_shard.serve_tp_full_shape(name, parts[0].shape,
                                               2) == tuple(full.shape)
    hd = tiny_port.cfg.resolved_head_dim
    pool = torch.arange(3 * 2 * 2 * hd).view(3, 2, 2 * hd)
    assert torch.equal(t_shard.serve_tp_cache_shard(pool, 1, 2),
                       pool[..., hd:])
    assert t_shard.SERVE_TP_AXIS == "tp"
    assert dict(t_shard.SERVE_TP_RULES) == {"heads": "tp", "kv": "tp",
                                            "mlp": "tp"}


def test_mesh_topology_and_probes():
    """``parallel/mesh.py`` without a world: a world of one, the CPU's
    platform, no fast interconnect, no peak figure off the H100, a measured
    (positive) host bandwidth; make_mesh and axis_group refuse without a
    process group or an axis."""
    topo = t_mesh.topology()
    assert (topo.world_size, topo.num_processes, topo.process_index) == (
        1, 1, 0)
    assert topo.platform == "cpu"
    assert not t_mesh.fast_interconnect_available()
    assert t_mesh.peak_flops_per_device() is None
    assert t_mesh.interconnect_bandwidth_estimate(1 << 20, 2) > 0
    with pytest.raises(RuntimeError, match="needs a process group"):
        t_mesh.make_mesh({"tp": 1})
    with pytest.raises(ValueError, match="no mesh has an axis named"):
        t_mesh.axis_group("nope")
    assert t_tp.backend_for("cpu", 2)[0] == "gloo"


# ----------------------------------------------------- launch layer


def _replica_docs(**kw):
    return t_render.render_all(TJob(serve_replicas=2, **kw))


def _replica_container(docs):
    rep = next(d for d in docs if d["kind"] == "Job" and
               (d["metadata"].get("labels") or {}).get("role")
               == "serve-replica")
    return rep["spec"]["template"]["spec"]["containers"][0]


def test_render_tp_chips_env_and_flag():
    """serve_tp renders three ways that agree (the card request, the
    ``TPUJOB_SERVE_TP`` env and ``--tp`` on the serve command) and the
    result validates clean."""
    docs = _replica_docs(serve_tp=2)
    assert t_validate.validate(docs) == []
    c = _replica_container(docs)
    assert int(c["resources"]["limits"]["nvidia.com/gpu"]) == 2
    env = {e["name"]: e.get("value") for e in c["env"]}
    assert env["TPUJOB_SERVE_TP"] == "2"
    assert "--tp 2" in " ".join(c["command"])


def test_validate_catches_tp_chip_mismatch_and_indivisible_preset():
    docs = _replica_docs(serve_tp=2)
    _replica_container(docs)["resources"]["limits"]["nvidia.com/gpu"] = 4
    assert any("TPUJOB_SERVE_TP (2) != nvidia.com/gpu limit (4)" in e
               for e in t_validate.validate(docs))
    # tiny preset: n_heads=4, kv=2 — tp=8 divides neither.
    assert any("not divisible by TPUJOB_SERVE_TP (8)" in e
               for e in t_validate.validate(_replica_docs(serve_tp=8)))
    docs = _replica_docs(serve_tp=2)
    for e in _replica_container(docs)["env"]:
        if e["name"] == "TPUJOB_SERVE_TP":
            e["value"] = "zero"
    assert any("must be an integer >= 1" in e
               for e in t_validate.validate(docs))


def test_validate_catches_tp_pool_overflow():
    docs = _replica_docs(serve_tp=2)
    _replica_container(docs)["resources"]["limits"]["memory"] = "1Mi"
    assert any("per-shard KV pool" in e and "exceeds the container "
               "memory limit" in e for e in t_validate.validate(docs))


def test_tp_gauge_exported_per_replica(port2):
    """``serve_tp`` (the port's ``tp_collector``) reports each replica's
    width: a real tp=2 engine on rank 0 of the world of two, and 1 for a
    single-device engine beside it."""
    text = port2["gauge"]
    assert 'serve_tp{replica="r0"} 2' in text
    assert 'serve_tp{replica="r1"} 1' in text


# ------------------------------------------------------------- the CLI


def _cli(*argv, timeout=180):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "k8s_distributed_deeplearning_torch.serve",
         "--device", "cpu", "--preset", "tiny", *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout)


def test_cli_tp2_spawns_its_follower_and_serves():
    """``--tp 2``: the CLI process is rank 0, spawns its follower, names
    the backend, serves every request and exits 0 with the follower
    stopped."""
    done = _cli("--tp", "2", "--requests", "4", "--slots", "2",
                "--max-seq-len", "128", "--prompt-len", "4", "12",
                "--out-len", "3", "6")
    assert done.returncode == 0, done.stderr[-2000:]
    assert "tp world: rank 1 of 2 on cpu, backend gloo" in done.stderr
    events = [json.loads(line) for line in done.stdout.splitlines()
              if line.startswith("{")]
    assert events[0]["event"] == "start"
    assert events[0]["role"] == "tp_world"
    assert events[0]["backend"] == "gloo"
    summ = events[-1]
    assert summ["event"] == "serve_summary"
    assert summ["requests_completed"] == 4
    assert (summ["tp"], summ["tp_backend"]) == (2, "gloo")


def test_cli_tp3_fails_on_divisibility():
    """An indivisible target (``--tp 3``) or draft (the micro draft's one
    KV head at ``--tp 2``) fails with the divisibility message before any
    follower starts."""
    for argv, needle in (
            (["--tp", "3"], "n_heads (4) is not divisible by tp (3)"),
            (["--tp", "2", "--draft-model", "micro", "--spec-k", "2"],
             "draft model: num_kv_heads (1) is not divisible by tp (2)")):
        done = _cli(*argv)
        assert done.returncode == 2, argv
        assert needle in done.stderr
        assert "tp world" not in done.stderr
