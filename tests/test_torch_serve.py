"""PyTorch port, serving: the port's ``ServeEngine(device="cpu")`` against
the JAX ``ServeEngine`` on the same weights (greedy token streams must be
identical, chunked and unchunked), page accounting, sampling
(``filter_logits`` masks equal JAX's exactly; sampled streams depend only
on the request's seed), the CLI, the default-device rule, and an AST scan
that the port imports nothing of JAX or the JAX package.
"""
import ast
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import generate as t_generate
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import (
    SamplingParams as TSampling)
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import cli as t_cli
from k8s_distributed_deeplearning_tpu.models import generate as j_generate
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine

REPO = Path(__file__).resolve().parents[1]
ENTRY = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "k8s_distributed_deeplearning_tpu")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg = j_llama.config_tiny(dtype=jnp.float32, **ENTRY)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, **ENTRY)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


def _workload(n=6, seed=0, p_lo=5, p_hi=70, m_lo=3, m_hi=12):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=int(rng.integers(p_lo, p_hi + 1)))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rng.integers(m_lo, m_hi + 1)) for _ in range(n)]


@pytest.mark.parametrize("chunk", [None, 32], ids=["unchunked", "chunk32"])
def test_greedy_streams_identical_to_jax_engine(models, chunk):
    """4 slots, 6 requests of 5-70 prompt tokens: slot reuse, mid-stream
    admission, bucketed final chunks and (chunk32) multi-chunk prefill.
    Every greedy token stream equals the JAX engine's, and so does each
    request's prefill-chunk count. No page leaks."""
    jmodel, params, tmodel = models
    prompts, max_news = _workload()
    jeng = JEngine(jmodel, params, num_slots=4, prefill_chunk_tokens=chunk)
    jouts = {o.request_id: o for o in jeng.run(
        [JRequest(prompt=p, max_new_tokens=m, request_id=f"r{i}")
         for i, (p, m) in enumerate(zip(prompts, max_news))])}
    teng = TEngine(tmodel, num_slots=4, prefill_chunk_tokens=chunk,
                   device="cpu")
    free0 = teng.pool.available()
    touts = {o.request_id: o for o in teng.run(
        [TRequest(prompt=p, max_new_tokens=m, request_id=f"r{i}")
         for i, (p, m) in enumerate(zip(prompts, max_news))])}
    assert sorted(touts) == sorted(jouts)
    for rid, jo in jouts.items():
        to = touts[rid]
        assert to.tokens == jo.tokens, rid
        assert to.finish_reason == jo.finish_reason == "length"
        assert to.prefill_chunks == jo.prefill_chunks
    assert teng.pool.available() == free0
    assert teng.pool.reserved == 0 and not teng.busy()
    summ = teng.stats.summary()
    assert summ["requests_completed"] == 6
    assert summ["total_tokens"] == sum(max_news)


def test_eos_at_admission_and_shutdown_release_pages(models):
    """A request whose first token is EOS finishes at admission and frees
    its slot; shutdown aborts queued, mid-prefill and decoding requests
    and returns every page."""
    _, _, tmodel = models
    prompts, _ = _workload(n=5, seed=3)
    probe = TEngine(tmodel, num_slots=2, device="cpu")
    first = probe.run([TRequest(prompt=prompts[0], max_new_tokens=1)])
    eos = first[0].tokens[0]
    eng = TEngine(tmodel, num_slots=2, eos_id=eos, device="cpu")
    out = eng.run([TRequest(prompt=prompts[0], max_new_tokens=8)])
    assert out[0].finish_reason == "eos" and out[0].tokens == [eos]
    eng = TEngine(tmodel, num_slots=2, prefill_chunk_tokens=32,
                  device="cpu")
    free0 = eng.pool.available()
    finished = []
    for p in prompts:
        eng.submit(TRequest(prompt=p, max_new_tokens=20,
                            on_finish=finished.append))
    eng.step()
    assert eng.busy()
    outs = eng.shutdown()
    assert len(outs) == 5 and set(finished) == {"aborted"}
    assert eng.pool.available() == free0 and not eng.busy()


def test_deadlines_time_out_queued_and_decoding_requests(models):
    """A request past its deadline at admission ends with no tokens; one
    that passes it mid-decode ends with its partial stream. Both report
    "timeout" once, the other request is unaffected, and no page leaks."""
    _, _, tmodel = models
    prompts, _ = _workload(n=3, seed=5)
    eng = TEngine(tmodel, num_slots=2, device="cpu")
    free0 = eng.pool.available()
    finished = []
    late = TRequest(prompt=prompts[0], max_new_tokens=8, deadline_s=0.0,
                    request_id="late", on_finish=finished.append)
    slow = TRequest(prompt=prompts[1], max_new_tokens=20, request_id="slow",
                    on_finish=finished.append)
    ok = TRequest(prompt=prompts[2], max_new_tokens=6, request_id="ok")
    for r in (late, slow, ok):
        eng.submit(r)
    outs = {o.request_id: o for o in eng.step()}
    assert outs["late"].finish_reason == "timeout"
    assert outs["late"].tokens == [] and outs["late"].ttft_s is None
    slow.deadline_s = 0.0
    outs.update({o.request_id: o for o in eng.run()})
    assert outs["slow"].finish_reason == "timeout"
    assert 1 <= len(outs["slow"].tokens) < 20
    assert outs["ok"].finish_reason == "length"
    assert len(outs["ok"].tokens) == 6
    assert finished == ["timeout", "timeout"]
    assert eng.pool.available() == free0 and eng.pool.reserved == 0


@pytest.mark.parametrize("k,p", [(5, None), (None, 0.7), (7, 0.9),
                                 (1, 0.5), (None, 1.0), (300, 0.3)])
def test_filter_logits_masks_equal_jax(k, p):
    logits = np.random.default_rng(7).standard_normal((4, 50)).astype(
        np.float32) * 3
    want = np.asarray(j_generate.filter_logits(jnp.asarray(logits), k, p))
    got = t_generate.filter_logits(torch.from_numpy(logits), k, p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[~np.isneginf(got)],
                                  logits[~np.isneginf(want)])


def test_sampled_streams_depend_only_on_the_request(models):
    """Two sampled requests (top-k, top-p) among greedy ones: their token
    streams repeat exactly across runs whatever the submission order, and
    so the slot each lands in."""
    _, _, tmodel = models
    prompts, max_news = _workload(seed=9)
    sampling = {1: TSampling(temperature=0.9, top_k=20),
                4: TSampling(temperature=1.2, top_p=0.8)}

    def run(order):
        reqs = [TRequest(prompt=prompts[i], max_new_tokens=max_news[i],
                         sampling=sampling.get(i, TSampling()),
                         request_id=f"r{i}", seed=100 + i) for i in order]
        eng = TEngine(tmodel, num_slots=4, device="cpu")
        return {o.request_id: o.tokens for o in eng.run(reqs)}

    a = run(range(6))
    b = run([5, 4, 3, 2, 1, 0])
    assert a == b
    c = run([4, 1, 0, 2, 3, 5])
    assert c == a


def test_cli_emits_serve_summary():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = t_cli.main(["--device", "cpu", "--slots", "2", "--requests",
                         "3", "--prompt-len", "4", "40", "--out-len", "2",
                         "5", "--max-seq-len", "64",
                         "--prefill-chunk-tokens", "32"])
    assert rc == 0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [e["event"] for e in events].count("serve_request") == 3
    summ = events[-1]
    assert summ["event"] == "serve_summary"
    assert summ["requests_completed"] == 3 and summ["device"] == "cpu"
    for key in ("tokens_per_sec", "ttft_p50_ms", "latency_p95_ms",
                "mean_slot_occupancy", "kv_pages_total"):
        assert key in summ


def test_entry_points_default_to_cuda(models):
    """Without a CUDA device, the default device raises instead of moving
    to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, _, tmodel = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tmodel)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_llama.LlamaLM(t_llama.config_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["--requests", "1"])


def _port_files():
    files = sorted((REPO / "k8s_distributed_deeplearning_torch").rglob(
        "*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "kernel_breakdown.py",
                    REPO / "examples" / "generate_llama_torch.py",
                    REPO / "examples" / "train_mnist_torch.py",
                    REPO / "examples" / "train_zoo_torch.py",
                    REPO / "tests" / "torch_tp_worker.py"]


def test_import_scan_covers_every_subpackage():
    """The scan reaches the training slice's subpackages, the fleet's
    (faults, telemetry, the serving fleet modules), the wire half's
    (transport, retry, the registry, exporter, heartbeat, tracer, events,
    bridge and profiling modules), graftscope's readers (timeline and
    its CLI), the fleet controller, the launch layer, the model zoo, the
    examples, and tensor-parallel serving (the runtime, the mesh, the
    rule table and the tp rank worker)."""
    files = _port_files()
    dirs = {p.parent.name for p in files}
    assert {"models", "ops", "serve", "utils", "train", "parallel",
            "faults", "telemetry", "examples", "launch"} <= dirs
    names = {p.name for p in files}
    assert {"disagg.py", "gateway.py", "storm.py", "flight.py", "fleet.py",
            "slo.py", "plan.py", "inject.py", "transport.py", "retry.py",
            "registry.py", "exporter.py", "heartbeat.py", "trace.py",
            "events.py", "bridge.py", "profiling.py", "timeline.py",
            "graftscope.py", "generate_llama_torch.py", "autoscale.py",
            "render.py", "validate.py", "watch.py", "elastic.py",
            "local_executor.py", "train_mnist_torch.py",
            "train_zoo_torch.py", "bert.py", "vit.py", "resnet.py",
            "tp.py", "mesh.py", "sharding.py", "torch_tp_worker.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_nothing_of_jax(path):
    """Scanned as source (not sys.modules, which JAX-importing tests fill):
    no import of jax, flax, optax or the JAX package, anywhere in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")
