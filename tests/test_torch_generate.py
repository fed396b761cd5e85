"""PyTorch port, generation (``models/generate.py`` and the dense KV cache
of ``models/transformer.py``) against the JAX package's on the same
weights (through ``models/convert.py``) and the same numpy-seeded inputs:
``prefill`` logits and every cache leaf (K, V, document ids, cursor),
scanned and unrolled; shared-cursor ``decode_step``s; ``prefill_chunk``
from ``start``, an overlapping chunk re-run included; dense
``slot_decode_step`` at unequal cursors and ``slot_verify_step`` windows on
the dense cache and on the paged pool; packed-document isolation;
``generate`` token streams (greedy unpadded, left-padded, with EOS), its
validations and its cache window; sampling; and ``MoELM`` generation on the
ragged and index dispatches.

Config: the JAX generation tests' (``config_tiny(max_seq_len=64)``: dim 64,
2 layers, 4/2 heads) in float32 on both sides. Tolerances: logits 1e-4
(O(1) values; both sides sum in f32 in different orders, observed
differences ~1e-6), cache leaves 1e-5 (the K/V projections and RoPE of one
token, observed ~1e-7), token streams exactly. The JAX ragged MoE prefill
runs ``pallas_gmm`` in interpret mode; the port's takes the plain grouped
matmul on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import generate as t_generate
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.models import moe as t_moe
from k8s_distributed_deeplearning_tpu.models import generate as j_generate
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.models import moe as j_moe
from k8s_distributed_deeplearning_tpu.models import (
    transformer as j_transformer)

TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file's tests run (several test
    processes share the host), the caller's count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(scan_layers=True, max_seq_len=64):
    """The same tiny Llama in both packages, the port's weights converted
    from the JAX params."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, scan_layers=scan_layers,
                               max_seq_len=max_seq_len)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((2, 12), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=max_seq_len)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def scanned():
    return _pair(scan_layers=True)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_layers(cache, n_layers):
    """Each layer's {cached_key, cached_value, cached_seg, cache_index}
    leaves of a JAX dense cache, scanned or unrolled."""
    tr = cache["transformer"]
    if "blocks" in tr:
        attn = tr["blocks"]["attn"]
        return [{k: np.asarray(v)[i] for k, v in attn.items()}
                for i in range(n_layers)]
    return [{k: np.asarray(v) for k, v in tr[f"block_{i}"]["attn"].items()}
            for i in range(n_layers)]


def _assert_cache_equal(tcache, jcache, n_layers):
    layers = _jax_layers(jcache, n_layers)
    for i, leaves in enumerate(layers):
        np.testing.assert_allclose(tcache.keys[i].numpy(),
                                   leaves["cached_key"], **CACHE_TOL)
        np.testing.assert_allclose(tcache.values[i].numpy(),
                                   leaves["cached_value"], **CACHE_TOL)
        np.testing.assert_array_equal(tcache.seg.numpy(),
                                      leaves["cached_seg"])
        assert tcache.index == int(leaves["cache_index"]), i


def _left_padded(lens, seed=0, vocab=256):
    """Rows of real tokens padded at the front to max(lens), the mask, and
    each row's real tokens alone."""
    s = max(lens)
    rng = np.random.default_rng(seed)
    rows, mask, alone = [], [], []
    for n in lens:
        real = rng.integers(0, vocab, size=n).astype(np.int32)
        rows.append(np.concatenate([np.zeros(s - n, np.int32), real]))
        mask.append(np.concatenate([np.zeros(s - n, np.int32),
                                    np.ones(n, np.int32)]))
        alone.append(real[None])
    return np.stack(rows), np.stack(mask), alone


# ------------------------------------------------------- steps on the cache


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_prefill_logits_and_cache_match_jax(scan_layers, padded):
    """Prefill logits within 1e-4, and every cache leaf: K and V within
    1e-5, the document ids and the cursor exactly. ``padded``: a
    left-padded batch with positions counting real tokens and segment ids
    (0 on the pads), as ``generate`` prefills one."""
    jmodel, params, tmodel = _pair(scan_layers=scan_layers)
    toks = _tokens(1, 2, 12)
    kw = {}
    if padded:
        mask = np.array([[0] * 5 + [1] * 7, [1] * 12], np.int32)
        start = 12 - mask.sum(-1)
        pos = np.clip(np.arange(12)[None] - start[:, None], 0, None)
        kw = dict(positions=pos.astype(np.int32), segment_ids=mask)
    jlogits, jcache = j_generate.prefill(
        jmodel, params, jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tlogits, tcache = t_generate.prefill(
        tmodel, _t(toks), **{k: _t(v) for k, v in kw.items()})
    assert tcache.length == 64 and tcache.index == 12
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_cache_equal(tcache, jcache, tmodel.cfg.n_layers)


def test_decode_steps_match_jax_and_the_full_forward(scanned):
    """A 5-token prefix, then one token at a time: every step's logits
    equal JAX's and the full forward's at that position, and the caches
    stay equal."""
    jmodel, params, tmodel = scanned
    toks = _tokens(2, 2, 12)
    with torch.no_grad():
        full = tmodel(_t(toks)).numpy()
    _, jcache = j_generate.prefill(jmodel, params, jnp.asarray(toks[:, :5]))
    _, tcache = t_generate.prefill(tmodel, _t(toks[:, :5]))
    for i in range(5, 12):
        jl, jcache = j_generate.decode_step(jmodel, params, jcache,
                                            jnp.asarray(toks[:, i]))
        tl = t_generate.decode_step(tmodel, tcache, _t(toks[:, i]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, i], **TOL)
    _assert_cache_equal(tcache, jcache, tmodel.cfg.n_layers)


def test_prefill_chunk_from_start_matches_jax(scanned):
    """A prefix, a chunk at the cursor, then an overlapping chunk from an
    earlier ``start``: logits and caches equal JAX's at every step, and the
    re-run rewrites the overlapped columns with the same values."""
    jmodel, params, tmodel = scanned
    toks = _tokens(3, 2, 16)
    _, jcache = j_generate.prefill(jmodel, params, jnp.asarray(toks[:, :6]))
    _, tcache = t_generate.prefill(tmodel, _t(toks[:, :6]))
    for start, stop in ((None, 10), (8, 14)):
        lo = 6 if start is None else start
        jl, jcache = j_generate.prefill_chunk(
            jmodel, params, jcache, jnp.asarray(toks[:, lo:stop]),
            start=start)
        before = tcache.keys[0][:, 8:10].clone()
        tl = t_generate.prefill_chunk(tmodel, tcache, _t(toks[:, lo:stop]),
                                      start=start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_equal(tcache, jcache, tmodel.cfg.n_layers)
        assert tcache.index == stop
    torch.testing.assert_close(tcache.keys[0][:, 8:10], before, rtol=0,
                               atol=1e-6)


def test_slot_decode_and_verify_on_the_dense_cache_match_jax(scanned):
    """Slot mode on a dense cache: rows at unequal cursors take one token
    each, then a 4-token verify window; logits and the K/V columns equal
    JAX's, and the shared cursor and document ids stay as they were."""
    jmodel, params, tmodel = scanned
    toks = _tokens(4, 2, 20)
    _, jcache = j_generate.prefill(jmodel, params, jnp.asarray(toks[:, :12]))
    _, tcache = t_generate.prefill(tmodel, _t(toks[:, :12]))
    cursors = np.array([7, 12], np.int32)
    jl, jcache = j_generate.slot_decode_step(
        jmodel, params, jcache, jnp.asarray(toks[:, 12]),
        jnp.asarray(cursors))
    tl = t_generate.slot_decode_step(tmodel, tcache, _t(toks[:, 12]),
                                     _t(cursors))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    window = toks[:, 13:17]
    jl, jcache = j_generate.slot_verify_step(
        jmodel, params, jcache, jnp.asarray(window),
        jnp.asarray(cursors + 1))
    tl = t_generate.slot_verify_step(tmodel, tcache, _t(window),
                                     _t(cursors + 1))
    assert tl.shape == (2, 4, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(tcache, jcache, tmodel.cfg.n_layers)
    assert tcache.index == 12


def _pools(cfg, pages, page_tokens):
    lanes = cfg.resolved_kv_heads * cfg.resolved_head_dim
    jshape = (cfg.n_layers, pages, page_tokens, lanes)
    jcache = {"transformer": {"blocks": {"attn": {
        "cached_key": jnp.zeros(jshape, jnp.float32),
        "cached_value": jnp.zeros(jshape, jnp.float32)}}}}
    tcache = [(torch.zeros(pages, page_tokens, lanes),
               torch.zeros(pages, page_tokens, lanes))
              for _ in range(cfg.n_layers)]
    return jcache, tcache


def test_slot_verify_on_the_paged_pool_matches_jax(scanned):
    """The paged form: two rows prefill through their block tables, then
    a 4-token verify window at unequal cursors (the port's plain paged
    attention on CPU tensors, JAX's XLA gather); logits and the rows'
    pages equal JAX's."""
    jmodel, params, tmodel = scanned
    cfg = tmodel.cfg
    tables = np.array([[3, 7, 1, 9], [2, 5, 11, 4]], np.int32)
    jcache, tcache = _pools(cfg, 12, 8)
    toks = _tokens(5, 2, 24)
    pos = np.broadcast_to(np.arange(18), (2, 18)).astype(np.int32)
    _, jcache = j_generate.prefill_chunk(
        jmodel, params, jcache, jnp.asarray(toks[:, :18]),
        positions=jnp.asarray(pos), block_tables=jnp.asarray(tables))
    t_generate.prefill_chunk(tmodel, tcache, _t(toks[:, :18]),
                             positions=_t(pos), block_tables=_t(tables),
                             logits_index=None)
    cursors = np.array([14, 18], np.int32)
    window = toks[:, 18:22]
    jl, jcache = j_generate.slot_verify_step(
        jmodel, params, jcache, jnp.asarray(window), jnp.asarray(cursors),
        block_tables=jnp.asarray(tables))
    tl = t_generate.slot_verify_step(tmodel, tcache, _t(window),
                                     _t(cursors), block_tables=_t(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jk = np.asarray(jcache["transformer"]["blocks"]["attn"]["cached_key"])
    live = sorted(set(tables.ravel()))
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(tcache[layer][0].numpy()[live],
                                   jk[layer][live], **CACHE_TOL)


def test_packed_decode_isolates_documents(scanned):
    """JAX ``test_packed_decode_isolates_documents``, against JAX: a packed
    row [doc1 | doc2] prefilled with segment ids and per-document
    positions, then a decode step continuing doc 2, gives JAX's logits,
    and the logits of doc 2 decoded alone."""
    jmodel, params, tmodel = scanned
    rng = np.random.default_rng(3)
    d1 = rng.integers(0, 256, size=(1, 5)).astype(np.int32)
    d2 = rng.integers(0, 256, size=(1, 4)).astype(np.int32)
    packed = np.concatenate([d1, d2], axis=1)
    seg = np.array([[1] * 5 + [2] * 4], np.int32)
    pos = np.asarray(j_transformer.packed_positions(jnp.asarray(seg)))
    jlp, jcp = j_generate.prefill(jmodel, params, jnp.asarray(packed),
                                  positions=jnp.asarray(pos),
                                  segment_ids=jnp.asarray(seg))
    tlp, tcp = t_generate.prefill(tmodel, _t(packed), positions=_t(pos),
                                  segment_ids=_t(seg))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **TOL)
    nxt = np.argmax(np.asarray(jlp)[:, -1], -1).astype(np.int32)
    step_kw = dict(positions=np.full((1, 1), 4, np.int32),
                   segment_ids=np.full((1, 1), 2, np.int32))
    jstep, _ = j_generate.decode_step(
        jmodel, params, jcp, jnp.asarray(nxt),
        **{k: jnp.asarray(v) for k, v in step_kw.items()})
    tstep = t_generate.decode_step(tmodel, tcp, _t(nxt),
                                   **{k: _t(v) for k, v in step_kw.items()})
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), **TOL)
    tlr, tcr = t_generate.prefill(tmodel, _t(d2))
    np.testing.assert_allclose(tlp.numpy()[:, 5:], tlr.numpy(), **TOL)
    tref = t_generate.decode_step(tmodel, tcr, _t(nxt))
    np.testing.assert_allclose(tstep.numpy(), tref.numpy(), **TOL)


def test_dense_decode_rejects_what_jax_rejects(scanned):
    """Decode without block tables runs the dense cache; a caller mask,
    segment ids in slot mode and a missing cache raise."""
    _, _, tmodel = scanned
    toks = _t(_tokens(6, 2, 8))
    _, cache = t_generate.prefill(tmodel, toks)
    with pytest.raises(NotImplementedError, match="decode mode"):
        tmodel.transformer(toks, decode=True, cache=cache,
                           mask=torch.ones(2, 1, 8, 8, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="slot decode"):
        tmodel(toks[:, :1], decode=True, cache=cache,
               cache_positions=torch.tensor([8, 8]),
               segment_ids=torch.ones(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="DenseCache"):
        tmodel(toks, decode=True)
    with pytest.raises(ValueError, match="overflows"):
        t_generate.prefill_chunk(tmodel, cache, _t(_tokens(7, 2, 57)))


# ---------------------------------------------------------------- generate


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_greedy_generate_equals_jax(scan_layers):
    jmodel, params, tmodel = _pair(scan_layers=scan_layers)
    prompt = _tokens(8, 2, 6)
    want = j_generate.generate(jmodel, params, jnp.asarray(prompt),
                               max_new_tokens=8)
    got = t_generate.generate(tmodel, prompt, max_new_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_left_padded_generate_equals_jax_and_each_row_alone(scanned):
    """JAX ``test_left_padded_batch_matches_unpadded_rows``'s lengths: the
    padded batch's streams equal JAX's, and each row equals that row
    generated alone, unpadded."""
    jmodel, params, tmodel = scanned
    batch, mask, alone = _left_padded([12, 7, 3])
    want = j_generate.generate(jmodel, params, jnp.asarray(batch),
                               max_new_tokens=6,
                               prompt_mask=jnp.asarray(mask))
    got = t_generate.generate(tmodel, batch, max_new_tokens=6,
                              prompt_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, row in enumerate(alone):
        one = t_generate.generate(tmodel, row, max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy()[i], one.numpy()[0],
                                      err_msg=f"row {i}")


@pytest.mark.parametrize("eos_at", [(0, 0), (1, 3)],
                         ids=["first_token", "mid_stream"])
def test_generate_with_eos_equals_jax(scanned, eos_at):
    """``eos_id`` set to a token the greedy stream emits (row, step): the
    stream equals JAX's, that row pads with ``pad_id`` after it."""
    jmodel, params, tmodel = scanned
    prompt = _tokens(9, 2, 4)
    greedy = t_generate.generate(tmodel, prompt, max_new_tokens=6).numpy()
    row, step = eos_at
    eos = int(greedy[row, step])
    want = j_generate.generate(jmodel, params, jnp.asarray(prompt),
                               max_new_tokens=6, eos_id=eos, pad_id=255)
    got = t_generate.generate(tmodel, prompt, max_new_tokens=6, eos_id=eos,
                              pad_id=255).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    first = list(got[row]).index(eos)
    assert first <= step and (got[row, first + 1:] == 255).all()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_top_k_1_equals_greedy(scanned):
    _, _, tmodel = scanned
    prompt = np.array([[5, 9, 3]], np.int32)
    greedy = t_generate.generate(tmodel, prompt, max_new_tokens=8)
    topk1 = t_generate.generate(tmodel, prompt, max_new_tokens=8,
                                temperature=0.8, top_k=1,
                                generator=_gen(3))
    assert torch.equal(greedy, topk1)


def test_top_k_stream_stays_in_the_top_k(scanned):
    """At a high temperature every sampled token is among the k most
    likely at its position (the full forward's logits)."""
    _, _, tmodel = scanned
    prompt = np.array([[5, 9, 3], [7, 1, 2]], np.int32)
    out = t_generate.generate(tmodel, prompt, max_new_tokens=12,
                              temperature=5.0, top_k=5, generator=_gen(0))
    seq = torch.cat([torch.from_numpy(prompt).long(), out.long()], dim=1)
    with torch.no_grad():
        logits = tmodel(seq[:, :-1])[:, 2:]
    top = logits.topk(5, dim=-1).indices
    assert bool((top == out.long()[..., None]).any(-1).all())


def test_sampled_streams_depend_only_on_the_seed(scanned):
    _, _, tmodel = scanned
    prompt = np.array([[5, 9, 3], [7, 1, 2]], np.int32)
    kw = dict(max_new_tokens=12, temperature=5.0, top_p=0.9)
    a = t_generate.generate(tmodel, prompt, generator=_gen(0), **kw)
    b = t_generate.generate(tmodel, prompt, generator=_gen(0), **kw)
    c = t_generate.generate(tmodel, prompt, generator=_gen(1), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a >= 0) & (a < 256)).all())


VALIDATIONS = {
    "sampling_without_rng": (dict(temperature=0.5), 4, 2),
    "top_p_range": (dict(temperature=1.0, top_p=1.5, rng=True), 2, 2),
    "top_k_range": (dict(temperature=1.0, top_k=0, rng=True), 2, 2),
    "top_k_greedy": (dict(top_k=5), 2, 2),
    "top_p_greedy": (dict(top_p=0.5), 2, 2),
    "max_new_tokens": (dict(), 4, 0),
    "cache_overflow": (dict(), 12, 60),
    "right_padded_mask": (dict(prompt_mask=[[1, 1, 0, 1]]), 4, 2),
    "mask_shape": (dict(prompt_mask=np.ones((1, 5), np.int32)), 4, 2),
}


@pytest.mark.parametrize("case", sorted(VALIDATIONS))
def test_generate_validations_raise_jax_messages(scanned, case):
    """Each JAX ``generate`` validation raises ValueError in the port, its
    message holding JAX's."""
    jmodel, params, tmodel = scanned
    kw, s, new = VALIDATIONS[case]
    prompt = _tokens(10, 1, s)
    jkw, tkw = dict(kw), dict(kw)
    if jkw.pop("rng", False):
        tkw.pop("rng")
        jkw["rng"], tkw["generator"] = jax.random.key(0), _gen(0)
    if "prompt_mask" in kw:
        jkw["prompt_mask"] = jnp.asarray(kw["prompt_mask"])
        tkw["prompt_mask"] = np.asarray(kw["prompt_mask"])
    with pytest.raises(ValueError) as jexc:
        j_generate.generate(jmodel, params, jnp.asarray(prompt),
                            max_new_tokens=new, **jkw)
    with pytest.raises(ValueError) as texc:
        t_generate.generate(tmodel, prompt, max_new_tokens=new, **tkw)
    assert str(jexc.value) in str(texc.value)


@pytest.mark.parametrize("prompt_len", [6, 127, 200, 300])
def test_cache_window_equals_jax(monkeypatch, prompt_len):
    """``generate``'s cache has the 128-aligned window JAX sizes its
    model to (min(max_seq_len, ceil128(S + new)))."""
    jmodel, params, tmodel = _pair(max_seq_len=512)
    seen = {}

    def j_record(model, *a, **kw):
        seen["jax"] = model.cfg.max_seq_len
        return jnp.zeros((1, kw["max_new_tokens"]), jnp.int32)

    prefill = t_generate.prefill

    def t_record(*a, **kw):
        logits, cache = prefill(*a, **kw)
        seen["torch"] = cache.length
        return logits, cache

    monkeypatch.setattr(j_generate, "_generate", j_record)
    monkeypatch.setattr(t_generate, "prefill", t_record)
    prompt = _tokens(11, 1, prompt_len)
    j_generate.generate(jmodel, params, jnp.asarray(prompt),
                        max_new_tokens=2)
    t_generate.generate(tmodel, prompt, max_new_tokens=2)
    assert seen["torch"] == seen["jax"] == t_generate.cache_window(
        512, prompt_len, 2)


# --------------------------------------------------------------------- MoE


def _moe_pair(dispatch):
    """JAX ``test_moe_generate_greedy``'s model (``config_tiny(max_seq_len
    =64)``, 4 experts, top-2, capacity factor 2) with ``dispatch``, in both
    packages."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=64)
    kw = dict(num_experts=4, top_k=2, capacity_factor=2.0, dispatch=dispatch)
    jmodel = j_moe.MoELM(jcfg, j_moe.MoEConfig(**kw))
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((2, 6), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64)
    tmodel = t_moe.MoELM(tcfg, t_moe.MoEConfig(**kw), device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("dispatch", ["ragged", "index"])
def test_moe_generate_equals_jax(monkeypatch, dispatch):
    """A 4 x 40 prompt (160 tokens >= 128: the ragged prefill takes the
    grouped matmul, three a layer; its decode steps, 4 tokens, the index
    path): prefill logits within 1e-4 of JAX's and greedy streams equal,
    unpadded and left-padded."""
    jmodel, params, tmodel = _moe_pair(dispatch)
    calls = []
    ragged = t_moe.MoEMLP._ragged_dispatch

    def counted(self, tokens, *a):
        calls.append(tokens.shape[0])
        return ragged(self, tokens, *a)

    monkeypatch.setattr(t_moe.MoEMLP, "_ragged_dispatch", counted)
    prompt = _tokens(12, 4, 40)
    jl, _ = j_generate.prefill(jmodel, params, jnp.asarray(prompt))
    tl, _ = t_generate.prefill(tmodel, _t(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    want = j_generate.generate(jmodel, params, jnp.asarray(prompt),
                               max_new_tokens=8)
    calls.clear()
    got = t_generate.generate(tmodel, prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = tmodel.cfg.n_layers
    assert calls == ([160] * n if dispatch == "ragged" else [])
    batch, mask, _ = _left_padded([40, 33, 36, 21], seed=13)
    want = j_generate.generate(jmodel, params, jnp.asarray(batch),
                               max_new_tokens=8,
                               prompt_mask=jnp.asarray(mask))
    got = t_generate.generate(tmodel, batch, max_new_tokens=8,
                              prompt_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
