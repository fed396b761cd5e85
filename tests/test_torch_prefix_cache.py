"""PyTorch port, the prefix cache on shared pool pages: the port's
``ServeEngine(prefix_cache_mb=...)`` against the JAX engine on the same
weights and requests (greedy streams, cached prompt tokens, the trie's
counters and the serving summary equal), and the port's ``PrefixCache``
against JAX's on the same sequence of acquire/insert/release. Every
engine run ends with no page held (``_check_page_leaks`` is None).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import PrefixCache as TCache
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import PrefixCache as JCache
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine

BLOCK = 32          # min_bucket, the default page and trie block
PREFIX_KEYS = ("prefix_cache_hits", "prefix_cache_misses",
               "prefix_cache_evictions", "prefix_hit_rate")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def med():
    """The JAX prefix-cache suite's model (tiny topology, 256 positions)
    and the port's with the same weights."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=256)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=256)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


def _shared_prefix_prompts(n, prefix_len, tail_lo, tail_hi, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=prefix_len)
    return [np.concatenate([shared, rng.integers(
        0, 256, size=int(rng.integers(tail_lo, tail_hi)))]).astype(np.int32)
        for _ in range(n)]


def _both(med, batches, max_new, **kw):
    """Serve each batch of prompts in turn (``run`` per batch, so a later
    batch sees the trie the earlier ones left) through both engines.
    Returns (port engine, JAX engine, port outputs, JAX outputs), outputs
    by request id."""
    jmodel, params, tmodel = med
    jeng = JEngine(jmodel, params, **kw)
    teng = TEngine(tmodel, device="cpu", **kw)
    jouts, touts = {}, {}
    k = 0
    for prompts in batches:
        ids = [f"r{k + i}" for i in range(len(prompts))]
        k += len(prompts)
        jouts.update({o.request_id: o for o in jeng.run(
            [JRequest(prompt=p, max_new_tokens=max_new, request_id=r)
             for p, r in zip(prompts, ids)])})
        touts.update({o.request_id: o for o in teng.run(
            [TRequest(prompt=p, max_new_tokens=max_new, request_id=r)
             for p, r in zip(prompts, ids)])})
    return teng, jeng, touts, jouts


def _assert_same(teng, jeng, touts, jouts):
    assert sorted(touts) == sorted(jouts)
    for rid, jo in jouts.items():
        to = touts[rid]
        assert to.tokens == jo.tokens, rid
        assert to.finish_reason == jo.finish_reason
        assert to.cached_prompt_tokens == jo.cached_prompt_tokens, rid
        assert to.prefill_chunks == jo.prefill_chunks, rid
    if jeng.prefix_cache is None:
        assert teng.prefix_cache is None
    else:
        assert teng.prefix_cache.counters() == jeng.prefix_cache.counters()
    tsum, jsum = teng.stats.summary(), jeng.stats.summary()
    for key in PREFIX_KEYS + ("kv_pages_used", "kv_pages_shared"):
        assert tsum[key] == jsum[key], key
    assert teng._check_page_leaks("test") is None
    assert teng.pool.reserved == 0 and not teng.busy()


def test_prefix_hit_streams_and_counters_equal_jax(med):
    """A 40-token shared prefix over 4 requests, 2 slots: the first two
    admit cold, the last two map the shared block. Streams, hits, the
    trie's counters and the summary equal the JAX engine's."""
    prompts = _shared_prefix_prompts(4, prefix_len=40, tail_lo=8,
                                     tail_hi=24)
    teng, jeng, touts, jouts = _both(med, [prompts], 6, num_slots=2,
                                     prefix_cache_mb=64)
    hits = [touts[f"r{i}"].cached_prompt_tokens for i in range(4)]
    assert hits[:2] == [0, 0] and min(hits[2:]) >= BLOCK
    c = teng.prefix_cache.counters()
    assert (c["hits"], c["misses"], c["inserted_blocks"]) == (2, 2, 1)
    _assert_same(teng, jeng, touts, jouts)


def test_fully_cached_prompt_still_samples_first_token(med):
    """An identical prompt served twice: the second hit stops one block
    short of the prompt's end, so the first token comes from real
    logits."""
    prompt = np.random.default_rng(7).integers(0, 256, 2 * BLOCK).astype(
        np.int32)
    teng, jeng, touts, jouts = _both(med, [[prompt], [prompt]], 5,
                                     num_slots=2, prefix_cache_mb=64)
    assert touts["r0"].cached_prompt_tokens == 0
    assert touts["r1"].cached_prompt_tokens == BLOCK
    assert touts["r1"].tokens == touts["r0"].tokens
    _assert_same(teng, jeng, touts, jouts)


@pytest.mark.parametrize("chunk", [None, BLOCK], ids=["unchunked",
                                                      "chunk32"])
def test_chunked_prefill_plus_cache_equal_jax(med, chunk):
    """A 64-token shared prefix and 20-60-token tails: a mapped hit moves
    the prefill cursor, and (chunk32) the chunks resume after it."""
    prompts = _shared_prefix_prompts(3, prefix_len=2 * BLOCK, tail_lo=20,
                                     tail_hi=60, seed=11)
    teng, jeng, touts, jouts = _both(med, [prompts], 5, num_slots=2,
                                     prefix_cache_mb=64,
                                     prefill_chunk_tokens=chunk)
    assert touts["r2"].cached_prompt_tokens == 2 * BLOCK
    _assert_same(teng, jeng, touts, jouts)


def test_eviction_under_the_byte_budget_equals_jax(med):
    """A budget of two blocks and three distinct one-block prompts: the
    third insert evicts the least recently used block. The port's block
    cost equals JAX's, and so does every counter after each request."""
    jmodel, params, tmodel = med
    probe = TEngine(tmodel, num_slots=2, prefix_cache_mb=1, device="cpu")
    bn = probe.prefix_cache.block_nbytes
    assert bn == JEngine(jmodel, params, num_slots=2,
                         prefix_cache_mb=1).prefix_cache.block_nbytes
    rng = np.random.default_rng(9)
    batches = [[rng.integers(0, 256, 40).astype(np.int32)]
               for _ in range(3)]
    teng, jeng, touts, jouts = _both(med, batches, 4, num_slots=2,
                                     prefix_cache_mb=2 * bn / 2 ** 20)
    c = teng.prefix_cache.counters()
    assert (c["inserted_blocks"], c["evictions"], c["blocks"]) == (3, 1, 2)
    assert c["used_bytes"] == sum(nd.nbytes
                                  for nd in teng.prefix_cache._nodes)
    _assert_same(teng, jeng, touts, jouts)


def test_cache_off_reports_nothing_cached(med):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 12).astype(np.int32) for _ in range(2)]
    teng, jeng, touts, jouts = _both(med, [prompts], 4, num_slots=2)
    assert teng.prefix_cache is None
    assert teng.stats.summary()["prefix_hit_rate"] is None
    _assert_same(teng, jeng, touts, jouts)


def test_pages_are_shared_not_copied(med):
    """While two requests decode on one cached prefix, its pages are held
    by the trie and both slots (refcount 3), attributed to the trie; after
    the run the trie alone holds them."""
    _, _, tmodel = med
    prompts = _shared_prefix_prompts(3, prefix_len=2 * BLOCK, tail_lo=4,
                                     tail_hi=8, seed=3)
    eng = TEngine(tmodel, num_slots=2, prefix_cache_mb=64, device="cpu")
    eng.run([TRequest(prompt=prompts[0], max_new_tokens=2)])
    for p in prompts[1:]:
        eng.submit(TRequest(prompt=p, max_new_tokens=8))
    eng.step()
    pages = [nd.page for nd in eng.prefix_cache._nodes]
    assert len(pages) == 2
    assert [eng.pool.refcount(p) for p in pages] == [3, 3]
    owners = eng.pool.owners_summary()
    assert owners["trie"] == 2 and eng.pool.held_pages()["trie"] == sorted(
        pages)
    eng.run()
    assert [eng.pool.refcount(p) for p in pages] == [1, 1]
    assert eng.stats.summary()["kv_pages_by_owner"]["trie"] == 2
    assert eng._check_page_leaks("test") is None
    assert eng.pool.counters()["pages_used"] == 0


def test_engine_flag_validation_equals_jax(med):
    jmodel, params, tmodel = med
    with pytest.raises(ValueError) as want:
        JEngine(jmodel, params, num_slots=2, prefix_cache_mb=-1)
    with pytest.raises(ValueError) as got:
        TEngine(tmodel, num_slots=2, prefix_cache_mb=-1, device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ PrefixCache alone


def _pair(**kw):
    """The port's and JAX's PrefixCache, each with its own page source
    (the same ids) and list of released pages."""
    out = []
    for cls in (TCache, JCache):
        released = []
        pages = iter(range(1, 1000))
        cache = cls(release_page=released.append, **kw)
        out.append((cache, released, lambda i, pages=pages: next(pages)))
    return out


def test_refcount_pins_blocks_under_insert_pressure():
    """JAX's unit case on both caches: a pinned path survives an insert
    that needs its bytes (the insert is skipped); after release, the same
    insert evicts it and returns its pages. Results and counters equal."""
    results = []
    for cache, released, page_for in _pair(capacity_bytes=64,
                                           block_tokens=4, block_nbytes=32):
        t1, t2 = list(range(8)), list(range(100, 108))
        r = [cache.insert(t1, page_for)]
        hit, nodes = cache.acquire(t1 + [99])
        r += [hit, len(nodes), cache.insert(t2, page_for), list(released)]
        cache.release(nodes)
        r += [cache.insert(t2, page_for), sorted(released),
              cache.counters()]
        with pytest.raises(RuntimeError, match="without a matching"):
            cache.release(nodes)
        results.append(r)
    assert results[0] == results[1]
    assert results[0][:5] == [(2, 0), 8, 2, (0, 0), []]
    assert results[0][5:7] == [(2, 2), [1, 2]]


def test_acquire_touches_lru_order():
    results = []
    for cache, _, page_for in _pair(capacity_bytes=64, block_tokens=4,
                                    block_nbytes=32):
        a, b = [1] * 4, [2] * 4
        cache.insert(a, page_for)
        cache.insert(b, page_for)
        cache.release(cache.acquire(a + [0])[1])     # b becomes LRU
        cache.insert([3] * 4, page_for)              # evicts b, not a
        results.append((cache.acquire(a + [0])[0],
                        cache.acquire(b + [0])[0], cache.counters()))
    assert results[0] == results[1]
    assert results[0][:2] == (4, 0)


@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_equal_jax(seed):
    """200 operations drawn from a seed (insert, acquire with and without
    a cap, release of a held pin, eviction) over a 6-block budget and an
    alphabet of 3 tokens, so prefixes collide: every result, every
    released page and the counters after each operation equal JAX's."""
    rng = np.random.default_rng(seed)
    (tc, trel, tpage), (jc, jrel, jpage) = _pair(
        capacity_bytes=6 * 16, block_tokens=2, block_nbytes=16)
    held: list[tuple[list, list]] = []
    for _ in range(200):
        op = rng.integers(0, 4)
        tokens = rng.integers(0, 3, int(rng.integers(1, 9))).tolist()
        if op == 0:
            got = (tc.insert(tokens, tpage), jc.insert(tokens, jpage))
        elif op == 1:
            cap = int(rng.integers(0, 9)) if rng.random() < 0.3 else None
            (th, tn), (jh, jn) = (tc.acquire(tokens, cap),
                                  jc.acquire(tokens, cap))
            held.append((tn, jn))
            got = ((th, [n.page for n in tn]), (jh, [n.page for n in jn]))
        elif op == 2 and held:
            tn, jn = held.pop(int(rng.integers(0, len(held))))
            tc.release(tn)
            jc.release(jn)
            got = (None, None)
        else:
            got = (tc.evict_lru_unpinned(), jc.evict_lru_unpinned())
        assert got[0] == got[1]
        assert trel == jrel
        assert tc.counters() == jc.counters()
        assert len(tc) == len(jc)


def test_constructor_errors_equal_jax():
    for kw in (dict(capacity_bytes=64, block_tokens=0, block_nbytes=8),
               dict(capacity_bytes=64, block_tokens=4),
               dict(capacity_bytes=64, block_tokens=4, block_nbytes=0)):
        with pytest.raises(ValueError) as want:
            JCache(**kw)
        with pytest.raises(ValueError) as got:
            TCache(**kw)
        assert str(got.value) == str(want.value)
