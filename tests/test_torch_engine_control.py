"""PyTorch port, request control in the serving engine: ``cancel`` of a
queued, a pending-prefill and an in-flight request, ``drain(flush=...)``,
``submit(requeue=True)`` and ``shutdown`` against the JAX engine on the
same weights and the same sequence of calls (outputs and finish reasons
equal, ``on_finish`` once per request, no page held afterwards), and the
serve CLI's prefix-cache, tenant and speculative flags: a run on the CPU,
and each refusal word for word as the JAX CLI's.
"""
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import (
    EngineDraining as TDraining)
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import cli as t_cli
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import (
    EngineDraining as JDraining)
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import cli as j_cli

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sides():
    """(engine factory, request class, draining error) for JAX and the
    port, on the same weights (tiny topology, 128 positions)."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=128)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=128)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return [(lambda **kw: JEngine(jmodel, params, **kw), JRequest,
             JDraining),
            (lambda **kw: TEngine(tmodel, device="cpu", **kw), TRequest,
             TDraining)]


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, 256, n).astype(np.int32)
            for name, n in (("a", 8), ("b", 100), ("c", 12), ("d", 20),
                            ("e", 9))}


def _key(o):
    return (o.request_id, o.tokens, o.finish_reason, o.prefill_chunks,
            o.cached_prompt_tokens, o.ttft_s is None)


def _assert_clean(eng):
    assert not eng.busy() and eng.pool.reserved == 0
    assert eng.pool.counters()["pages_used"] == 0
    if isinstance(eng, TEngine):
        assert eng._check_page_leaks("test") is None


def test_cancel_in_each_state_equals_jax(sides):
    """Two slots, 32-token chunks: "a" decodes, "b" (100 tokens) is
    mid-prefill, "c" and "d" wait. Cancelling "c" (queued), "b"
    (pending) and "a" (in flight) gives the JAX engine's outputs; a
    second cancel and an unknown id give None; "d" and a later "e" run
    to the end; every on_finish fired once."""
    prompts = _prompts()
    runs = []
    for make, cls, _ in sides:
        eng = make(num_slots=2, prefill_chunk_tokens=32,
                   prefix_cache_mb=1)
        calls: dict[str, list] = {}
        reqs = {k: cls(prompt=p, max_new_tokens=10, request_id=k,
                       on_finish=calls.setdefault(k, []).append)
                for k, p in prompts.items()}
        for k in "abcd":
            eng.submit(reqs[k])
        out = [_key(o) for o in eng.step()]
        assert eng.load() == 4 and len(eng._pending) == 1
        out.append(_key(eng.cancel("c", "aborted")))
        out.append(_key(eng.cancel("b", "migrated")))
        out += [_key(o) for o in eng.step()]
        out.append(_key(eng.cancel("a")))
        out.append(eng.cancel("a"))
        out.append(eng.cancel("nobody"))
        eng.submit(reqs["e"])
        out += [_key(o) for o in eng.run()]
        _assert_clean(eng)
        runs.append((out, calls))
    assert runs[0] == runs[1]
    out, calls = runs[1]
    reasons = {o[0]: o[2] for o in out if o}
    assert reasons == {"a": "aborted", "b": "migrated", "c": "aborted",
                       "d": "length", "e": "length"}
    assert calls == {k: [reasons[k]] for k in "abcde"}


def test_requeue_enters_at_the_head_equals_jax(sides):
    """A request cancelled as "migrated" mid-decode and submitted again
    with ``requeue=True`` is admitted before requests queued earlier,
    keeps its first submit time, and the run equals the JAX engine's."""
    prompts = _prompts(1)
    runs = []
    for make, cls, _ in sides:
        eng = make(num_slots=2)
        reqs = {k: cls(prompt=p, max_new_tokens=6, request_id=k)
                for k, p in prompts.items()}
        for k in "abcd":
            eng.submit(reqs[k])
        out = [_key(o) for o in eng.step()]
        t0 = reqs["a"]._t_submit
        out.append(_key(eng.cancel("a", "migrated")))
        eng.submit(reqs["a"], requeue=True)
        assert reqs["a"]._t_submit == t0
        order = []
        while eng.busy():
            for o in eng.step():
                order.append(o.request_id)
                out.append(_key(o))
        _assert_clean(eng)
        runs.append((out, order))
    assert runs[0] == runs[1]
    order = runs[1][1]
    assert order.index("a") < order.index("c") < order.index("d")


@pytest.mark.parametrize("flush", [False, True])
def test_drain_equals_jax(sides, flush):
    """``drain(flush=...)``: nothing new is admitted (submit raises the
    JAX message), what the engine holds finishes, flushed requests come
    back untouched, and ``drained`` turns true with no page held."""
    prompts = _prompts(2)
    runs = []
    for make, cls, draining in sides:
        eng = make(num_slots=2)
        reqs = {k: cls(prompt=p, max_new_tokens=5, request_id=k)
                for k, p in prompts.items()}
        for k in "abcd":
            eng.submit(reqs[k])
        out = [_key(o) for o in eng.step()]
        flushed = [r.request_id for r in eng.drain(flush=flush)]
        assert eng.draining and not eng.drained
        with pytest.raises(draining) as refused:
            eng.submit(reqs["e"])
        while eng.busy():
            out += [_key(o) for o in eng.step()]
        assert eng.drained
        assert eng.drain() == []
        _assert_clean(eng)
        runs.append((out, flushed, str(refused.value)))
    assert runs[0] == runs[1]
    assert runs[1][1] == (["c", "d"] if flush else [])


def test_shutdown_aborts_every_state_once_equals_jax(sides):
    """Queued, pending and in-flight requests all end "aborted" once; a
    second shutdown aborts nothing; the pool is empty, the trie
    included."""
    prompts = _prompts(3)
    runs = []
    for make, cls, _ in sides:
        eng = make(num_slots=2, prefill_chunk_tokens=32, prefix_cache_mb=1)
        calls: list[str] = []
        for k in "abcde":
            eng.submit(cls(prompt=prompts[k], max_new_tokens=12,
                           request_id=k, on_finish=calls.append))
        eng.step()
        outs = sorted(_key(o) for o in eng.shutdown())
        assert eng.shutdown() == []
        _assert_clean(eng)
        runs.append((outs, sorted(calls)))
    assert runs[0] == runs[1]
    assert runs[1][1] == ["aborted"] * 5


@pytest.mark.parametrize("origin", ["shutdown", "drain"])
def test_page_leak_is_recorded_in_stats(sides, origin):
    """A page still held, or a reservation outstanding, once every request
    is terminal is counted in ``stats`` by the shutdown check and by the
    one at the end of a drain, with its by-owner record; a clean pool
    counts nothing."""
    make = sides[1][0]
    eng = make(num_slots=2, prefill_chunk_tokens=32)
    eng.submit(TRequest(prompt=_prompts()["a"], max_new_tokens=3,
                        request_id="a"))
    eng.run()
    eng.shutdown()
    assert eng.stats.summary()["kv_page_leaks"] == 0
    stray = eng.pool.alloc(2)
    eng.pool.reserve(1)
    if origin == "shutdown":
        eng.shutdown()
    else:
        eng.drain()
        eng.step()
    summ = eng.stats.summary()
    assert summ["kv_page_leaks"] == 1
    assert summ["kv_page_leak_last"] == {
        "origin": origin, "replica": None, "pages_leaked": 2,
        "pages_reserved": 1,
        "by_owner": {"slot": 2, "trie": 0, "draft": 0, "imported": 0,
                     "reserved": 1},
        "pages_held": {"slot": sorted(stray)}}
    assert eng.pool.held_pages() == {"slot": sorted(stray)}


# ------------------------------------------------------------------- CLI


def _cli_lines(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_cli_prefix_tenants_and_spec_flags():
    """A shared 64-token prefix through the cache, two tenants and a
    micro draft at spec_k 3, on the CPU: every request finishes, later
    ones hit the cache, and the spec and tenant summaries come out."""
    tenants = json.dumps({"tenants": [
        {"id": "chat", "priority": "interactive"},
        {"id": "bulk", "priority": "batch", "max_slots": 1}]})
    events = _cli_lines([
        "--device", "cpu", "--slots", "2", "--requests", "5",
        "--prompt-len", "4", "12", "--out-len", "3", "6",
        "--max-seq-len", "128", "--shared-prefix-len", "64",
        "--prefix-cache-mb", "4", "--tenants", tenants,
        "--draft-model", "micro", "--spec-k", "3"])
    kinds = [e["event"] for e in events]
    assert kinds.count("serve_request") == 5
    hits = [e["cached_prompt_tokens"] for e in events
            if e["event"] == "serve_request"]
    assert max(hits) == 64
    spec = next(e for e in events if e["event"] == "spec_summary")
    assert spec["spec_k"] == 3 and spec["spec_proposed_tokens"] > 0
    by_tenant = {e["tenant"]: e for e in events
                 if e["event"] == "sched_tenant_summary"}
    assert {t: e["popped_total"] for t, e in by_tenant.items()} == {
        "chat": 3, "bulk": 2}
    summ = events[-1]
    assert summ["event"] == "serve_summary"
    assert summ["requests_completed"] == 5
    assert summ["prefix_cache_hits"] >= 1 and summ["spec_steps"] > 0


BAD_FLAGS = [
    ["--prefix-cache-mb", "-1"],
    ["--shared-prefix-len", "-3"],
    ["--spec-k", "2"],
    ["--draft-model", "micro"],
    ["--draft-model", "tiny", "--spec-k", "-1"],
    ["--shared-prefix-len", "400", "--max-seq-len", "512"],
    ["--tenants", '{"tenants": [{"id": "a", "weight": 0}]}'],
    ["--tenants", "@/nonexistent/tenants.json"],
]


@pytest.mark.parametrize("flags", BAD_FLAGS,
                         ids=[str(i) for i in range(len(BAD_FLAGS))])
def test_cli_refusals_equal_jax(flags):
    """Each bad flag exits 2 with the JAX CLI's message (after argparse's
    ``error:``; the program names differ)."""
    said = []
    for main in (j_cli.main, t_cli.main):
        err = io.StringIO()
        with redirect_stderr(err), redirect_stdout(io.StringIO()), \
                pytest.raises(SystemExit) as done:
            main(["--device", "cpu"] * (main is t_cli.main) + flags)
        assert done.value.code == 2
        said.append(err.getvalue().strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    assert said[0] == said[1]
