"""PyTorch port, speculative decoding in the serving engine: the port's
``ServeEngine(draft_model=..., spec_k=...)`` against the JAX engine on the
same target and draft weights. Greedy streams equal JAX's speculative and
non-speculative streams (and the per-request proposed/accepted counts
equal JAX's), a self-draft accepts every proposal, EOS inside a window
ends the stream at the same token, a sampled speculative stream equals
the port's own non-speculative one for the same seed, the constructor's
errors equal JAX's, and a request that fills ``max_seq_len`` exactly runs
with its window past the table's last block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import (
    SamplingParams as TSampling)
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.utils.metrics import (
    ServingStats as TStats)
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine

MAX_SEQ = 64

torch.set_num_threads(2)


def _pair(seed, noise=None, **over):
    """A JAX model with params from ``seed`` and the port's copy. With
    ``noise``, the params are ``tiny``'s plus ``noise`` x each tensor's
    standard deviation of Gaussian noise drawn from ``seed``."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=MAX_SEQ,
                               **over)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0 if noise else seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    if noise:
        leaves, tree = jax.tree_util.tree_flatten(params)
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_unflatten(tree, [
            p + noise * jnp.std(p) * rng.standard_normal(p.shape).astype(
                np.float32) for p in leaves])
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                               **over)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def tiny():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    """The target's weights with noise: the draft agrees with the target
    on some tokens and not others, so acceptance is partial and both the
    accept and the rollback paths run."""
    return _pair(7, noise=0.5)


def _workload(n, seed=0, p_lo=4, p_hi=17, m_lo=3, m_hi=16):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, int(rng.integers(p_lo, p_hi))).astype(
        np.int32) for _ in range(n)]
    return prompts, [int(rng.integers(m_lo, m_hi)) for _ in range(n)]


def _run(eng, cls, prompts, max_news, **kw):
    outs = {o.request_id: o for o in eng.run(
        [cls(prompt=p, max_new_tokens=m, request_id=f"r{i}", **kw)
         for i, (p, m) in enumerate(zip(prompts, max_news))])}
    return [outs[f"r{i}"] for i in range(len(prompts))]


def _clean(eng):
    assert eng._check_page_leaks("test") is None
    assert eng.pool.reserved == 0 and not eng.busy()


@pytest.fixture(scope="module")
def jax_base(tiny):
    """The JAX engine's non-speculative streams, by workload seed."""
    jmodel, params, _ = tiny
    out = {}
    for seed in (1, 3, 4):
        prompts, max_news = _workload(8, seed=seed)
        eng = JEngine(jmodel, params, num_slots=3)
        out[seed] = [o.tokens for o in _run(eng, JRequest, prompts,
                                            max_news)]
    return out


@pytest.mark.parametrize("spec_k", [1, 3, 4])
def test_greedy_streams_equal_jax(tiny, draft, jax_base, spec_k):
    """8 requests over 3 slots (slot reuse, admission mid-stream): every
    greedy stream equals the JAX engine's speculative stream and its
    non-speculative one, and so do each request's proposed and accepted
    draft counts."""
    jmodel, params, tmodel = tiny
    jdraft, dparams, tdraft = draft
    prompts, max_news = _workload(8, seed=spec_k)
    jeng = JEngine(jmodel, params, num_slots=3, draft_model=jdraft,
                   draft_params=dparams, spec_k=spec_k)
    jouts = _run(jeng, JRequest, prompts, max_news)
    teng = TEngine(tmodel, num_slots=3, draft_model=tdraft, spec_k=spec_k,
                   device="cpu")
    touts = _run(teng, TRequest, prompts, max_news)
    for to, jo, base in zip(touts, jouts, jax_base[spec_k]):
        assert to.tokens == jo.tokens == base, to.request_id
        assert to.finish_reason == jo.finish_reason == "length"
        assert (to.spec_proposed, to.spec_accepted) == (
            jo.spec_proposed, jo.spec_accepted), to.request_id
    tsum, jsum = teng.stats.summary(), jeng.stats.summary()
    for key in ("decode_steps", "total_tokens", "spec_steps",
                "spec_proposed_tokens", "spec_accepted_tokens",
                "spec_accept_hist", "spec_acceptance_rate"):
        assert tsum[key] == jsum[key], key
    assert 0 < tsum["spec_acceptance_rate"] < 1
    _clean(teng)


def test_self_draft_accepts_everything(tiny):
    """Draft == target: every proposal is accepted, the histogram sits in
    the spec_k bin, fewer iterations than without speculation, and the
    streams and emitted-token count equal the non-speculative run's."""
    _, _, tmodel = tiny
    spec_k = 4
    prompts, _ = _workload(5, seed=33)
    max_news = [6, 11, 16, 11, 6]
    base_stats, stats = TStats(), TStats()
    base = _run(TEngine(tmodel, num_slots=3, stats=base_stats,
                        device="cpu"), TRequest, prompts, max_news)
    eng = TEngine(tmodel, num_slots=3, stats=stats, draft_model=tmodel,
                  spec_k=spec_k, device="cpu")
    outs = _run(eng, TRequest, prompts, max_news)
    assert [o.tokens for o in outs] == [o.tokens for o in base]
    summ, bsumm = stats.summary(), base_stats.summary()
    assert summ["spec_acceptance_rate"] == 1.0
    assert set(summ["spec_accept_hist"]) == {str(spec_k)}
    assert summ["decode_steps"] < bsumm["decode_steps"]
    assert summ["total_tokens"] == bsumm["total_tokens"]
    for o in outs:
        assert o.spec_accepted == o.spec_proposed > 0
    _clean(eng)


def test_eos_mid_window_ends_the_stream_as_jax(tiny, draft):
    """An EOS id taken from a reference stream: requests that meet it
    inside a window end at it with nothing after it, as in the JAX
    engine, and the next queued request decodes untouched."""
    jmodel, params, tmodel = tiny
    jdraft, dparams, tdraft = draft
    prompts, max_news = _workload(6, seed=1, m_lo=6, m_hi=12)
    probe = _run(TEngine(tmodel, num_slots=2, device="cpu"), TRequest,
                 prompts[:1], max_news[:1])[0]
    eos = probe.tokens[2]
    jouts = _run(JEngine(jmodel, params, num_slots=2, eos_id=eos,
                         draft_model=jdraft, draft_params=dparams,
                         spec_k=4), JRequest, prompts, max_news)
    teng = TEngine(tmodel, num_slots=2, eos_id=eos, draft_model=tdraft,
                   spec_k=4, device="cpu")
    touts = _run(teng, TRequest, prompts, max_news)
    n_eos = 0
    for to, jo in zip(touts, jouts):
        assert to.tokens == jo.tokens and to.finish_reason == \
            jo.finish_reason
        if to.finish_reason == "eos":
            n_eos += 1
            assert to.tokens[-1] == eos and eos not in to.tokens[:-1]
    assert n_eos >= 1
    _clean(teng)


@pytest.mark.parametrize("spec_k", [1, 3])
def test_sampled_streams_equal_the_ports_own(tiny, draft, spec_k):
    """Sampled requests (temperature, top-k, top-p) beside greedy ones:
    each speculative stream equals the port's non-speculative stream for
    the same seed (torch's generator is not JAX's PRNG, so the reference
    here is the port itself)."""
    _, _, tmodel = tiny
    _, _, tdraft = draft
    prompts, max_news = _workload(6, seed=21, m_lo=6, m_hi=14)
    modes = [TSampling(temperature=0.9, top_k=17, top_p=0.9),
             TSampling(), TSampling(temperature=1.3),
             TSampling(temperature=0.7, top_p=0.8), TSampling(),
             TSampling(temperature=1.0, top_k=5)]

    def run(eng):
        reqs = [TRequest(prompt=p, max_new_tokens=m, sampling=sp,
                         seed=100 + i, request_id=f"r{i}")
                for i, (p, m, sp) in enumerate(zip(prompts, max_news,
                                                   modes))]
        outs = {o.request_id: o.tokens for o in eng.run(reqs)}
        return [outs[f"r{i}"] for i in range(len(reqs))]

    want = run(TEngine(tmodel, num_slots=3, device="cpu"))
    eng = TEngine(tmodel, num_slots=3, draft_model=tdraft, spec_k=spec_k,
                  device="cpu")
    assert run(eng) == want
    _clean(eng)


def test_constructor_errors_equal_jax(tiny, draft):
    jmodel, params, tmodel = tiny
    jdraft, dparams, tdraft = draft
    with pytest.raises(ValueError) as want:
        JEngine(jmodel, params, num_slots=2, spec_k=3)
    with pytest.raises(ValueError) as got:
        TEngine(tmodel, num_slots=2, spec_k=3, device="cpu")
    assert str(got.value) == str(want.value)
    # A draft without spec_k: the message names the draft (each side's
    # own repr), then spec_k.
    with pytest.raises(ValueError, match="BOTH") as want:
        JEngine(jmodel, params, num_slots=2, draft_model=jdraft,
                draft_params=dparams)
    with pytest.raises(ValueError, match="BOTH") as got:
        TEngine(tmodel, num_slots=2, draft_model=tdraft, device="cpu")
    assert str(got.value).endswith(", spec_k=0)")
    assert str(want.value).endswith(", spec_k=0)")
    cases = [(dict(spec_k=-1), draft)]
    for over in (dict(vocab_size=257), dict(max_seq_len=MAX_SEQ // 2)):
        jcfg = j_llama.config_tiny(dtype=jnp.float32, **{
            "max_seq_len": MAX_SEQ, **over})
        jm = j_llama.LlamaLM(jcfg)
        jp = jm.init(jax.random.key(9), jnp.zeros((1, 8), jnp.int32))[
            "params"]
        tm = t_llama.LlamaLM(t_llama.config_tiny(
            dtype=torch.float32, **{"max_seq_len": MAX_SEQ, **over}),
            device="cpu")
        cases.append((dict(spec_k=3), (jm, jp, tm)))
    for kw, (jd, dp, td) in cases:
        with pytest.raises(ValueError) as want:
            JEngine(jmodel, params, num_slots=2, draft_model=jd,
                    draft_params=dp, **kw)
        with pytest.raises(ValueError) as got:
            TEngine(tmodel, num_slots=2, draft_model=td, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_window_past_max_seq_len(tiny, draft):
    """n + max_new_tokens == max_seq_len at spec_k 4: the last windows
    write past the request's budget and past the table's last block
    (onto the scratch columns). The streams equal JAX's non-speculative
    ones and no page leaks."""
    jmodel, params, tmodel = tiny
    _, _, tdraft = draft
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (40, 57)]
    max_news = [MAX_SEQ - 40, MAX_SEQ - 57]
    want = [o.tokens for o in _run(JEngine(jmodel, params, num_slots=2),
                                   JRequest, prompts, max_news)]
    for d in (tdraft, tmodel):
        eng = TEngine(tmodel, num_slots=2, draft_model=d, spec_k=4,
                      device="cpu")
        assert eng.table_cols == eng.max_blocks + 1
        outs = _run(eng, TRequest, prompts, max_news)
        assert [o.tokens for o in outs] == want
        assert all(o.finish_reason == "length" for o in outs)
        _clean(eng)


def test_spec_with_prefix_cache_and_chunked_prefill(tiny, draft):
    """Shared-prefix requests through the trie and 32-token chunks with a
    draft: the draft arena mirrors every prefill (chunks and the final
    chunk after a mapped hit). Streams and hits equal JAX's."""
    jmodel, params, tmodel = tiny
    jdraft, dparams, tdraft = draft
    rng = np.random.default_rng(44)
    stem = rng.integers(0, 256, 40).astype(np.int32)
    prompts = [np.concatenate([stem, rng.integers(
        0, 256, int(rng.integers(2, 9))).astype(np.int32)])
        for _ in range(6)]
    max_news = [int(rng.integers(5, 12)) for _ in range(6)]
    kw = dict(num_slots=3, prefix_cache_mb=4, prefill_chunk_tokens=32)
    jouts = _run(JEngine(jmodel, params, draft_model=jdraft,
                         draft_params=dparams, spec_k=4, **kw),
                 JRequest, prompts, max_news)
    teng = TEngine(tmodel, draft_model=tdraft, spec_k=4, device="cpu", **kw)
    touts = _run(teng, TRequest, prompts, max_news)
    assert sum(o.cached_prompt_tokens > 0 for o in touts) >= 1
    for to, jo in zip(touts, jouts):
        assert to.tokens == jo.tokens
        assert to.cached_prompt_tokens == jo.cached_prompt_tokens
    _clean(teng)


def test_int8_arenas_equal_jax(tiny, draft):
    """``kv_quant="int8"`` with a draft: both arenas hold int8 pages and
    f32 scales, and the streams equal the JAX engine's under the same
    mode."""
    jmodel, params, _ = tiny
    jdraft, dparams, _ = draft
    _, _, tmodel = _pair(0)
    _, _, tdraft = _pair(7, noise=0.5)
    prompts, max_news = _workload(4, seed=8)
    jouts = _run(JEngine(jmodel, params, num_slots=2, kv_quant="int8",
                         draft_model=jdraft, draft_params=dparams,
                         spec_k=3), JRequest, prompts, max_news)
    teng = TEngine(tmodel, num_slots=2, kv_quant="int8", draft_model=tdraft,
                   spec_k=3, device="cpu")
    for arena in (teng._cache, teng._draft_cache):
        assert all(tuple(t.dtype for t in layer) == (
            torch.int8, torch.int8, torch.float32, torch.float32)
            for layer in arena)
    touts = _run(teng, TRequest, prompts, max_news)
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert teng.stats.summary()["kv_quant_bytes_saved"] == \
        teng._kv_bytes_saved() > 0
    _clean(teng)
