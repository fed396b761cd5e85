"""PyTorch port, Llama model: the flax -> torch weight converter and the
forward pass against JAX ``LlamaLM.apply`` (scanned and unrolled layer
stacks, packed segment ids), the paged ``prefill_chunk`` /
``slot_decode_step`` logits and pool contents against JAX's on the same
pool, tables and positions, and the building blocks (RoPE pairs, RMSNorm).

Config: ``__graft_entry__.entry()``'s (``config_tiny(dim=128, n_layers=2,
n_heads=4, n_kv_heads=2)``) in float32 on both sides. Tolerance 1e-4 on
O(1) logits: both sides compute in f32, and XLA's and PyTorch's CPU
matmuls sum in different orders (observed differences are ~1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import generate as t_generate
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.models import (
    transformer as t_transformer)
from k8s_distributed_deeplearning_torch.ops import attention as t_attention
from k8s_distributed_deeplearning_tpu.models import generate as j_generate
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.models import (
    transformer as j_transformer)

TOL = dict(atol=1e-4, rtol=1e-4)
ENTRY = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2)

torch.set_num_threads(2)


def _pair(scan_layers=True, **kw):
    """The same tiny Llama in both packages, the port's weights converted
    from the JAX params."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, scan_layers=scan_layers,
                               **ENTRY, **kw)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, **ENTRY, **kw)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def scanned():
    return _pair(scan_layers=True)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_forward_matches_jax(scan_layers):
    jmodel, params, tmodel = _pair(scan_layers=scan_layers)
    toks = _tokens(1, 3, 40)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_converter_covers_every_weight(scanned):
    _, params, tmodel = scanned
    sd = t_convert.from_flax_params(tmodel.cfg, params)
    assert set(sd) == set(tmodel.state_dict())
    for name, w in tmodel.state_dict().items():
        assert sd[name].shape == w.shape, name


@pytest.mark.parametrize("with_positions", [False, True],
                         ids=["segments", "segments+positions"])
def test_packed_segments_match_jax(scanned, with_positions):
    """Packed rows: attention stays inside each document; with
    per-document positions RoPE restarts at every document start."""
    jmodel, params, tmodel = scanned
    toks = _tokens(2, 2, 32)
    seg = np.repeat(np.array([[1, 2, 3], [1, 1, 2]]), [10, 12, 10],
                    axis=1).astype(np.int32)
    kw_j = {"segment_ids": jnp.asarray(seg)}
    kw_t = {"segment_ids": torch.from_numpy(seg)}
    if with_positions:
        pos = np.array(j_transformer.packed_positions(jnp.asarray(seg)))
        np.testing.assert_array_equal(
            t_transformer.packed_positions(torch.from_numpy(seg)).numpy(),
            pos)
        kw_j["positions"] = jnp.asarray(pos)
        kw_t["positions"] = torch.from_numpy(pos)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks),
                                   **kw_j))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks), **kw_t).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rope_rotates_interleaved_pairs_like_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 5)).astype(np.int32)
    jcos, jsin = j_transformer.rope_frequencies(16, 64, 500000.0)
    tcos, tsin = t_transformer.rope_frequencies(16, 64, 500000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    for p in (None, pos):
        want = np.asarray(j_transformer.apply_rope(
            jnp.asarray(x), jcos, jsin,
            None if p is None else jnp.asarray(p)))
        got = t_transformer.apply_rope(
            torch.from_numpy(x), tcos, tsin,
            None if p is None else torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_rmsnorm_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 7, 32)).astype(
        np.float32)
    jnorm = j_transformer.RMSNorm(dtype=jnp.float32)
    want = np.asarray(jnorm.apply(jnorm.init(jax.random.key(0),
                                             jnp.asarray(x)),
                                  jnp.asarray(x)))
    got = t_transformer.RMSNorm(32, dtype=torch.float32)(
        torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_flash_impl_is_not_ported_yet():
    """The flash kernels are ported now: impl="flash" no longer raises. On
    CPU tensors it runs their plain versions, which agree with the einsum
    path (the kernels themselves are held to the Pallas kernels in
    tests/test_torch_flash_attn.py and on the card)."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    out = t_attention.multi_head_attention(q, q, q, causal=True, impl="flash")
    ref = t_attention.multi_head_attention(q, q, q, causal=True, impl="xla")
    torch.testing.assert_close(out, ref, **TOL)


def test_serving_stores_weights_in_the_compute_dtype():
    """The param-dtype split keeps serving's storage: a default config
    stores its projection, embedding and head weights in the compute dtype
    (bf16), with f32 norm scales; param_dtype=float32 stores f32."""
    bf16 = t_llama.LlamaLM(t_llama.config_tiny(), device="cpu")
    f32 = t_llama.LlamaLM(t_llama.config_tiny(param_dtype=torch.float32),
                          device="cpu")
    for name, p in bf16.named_parameters():
        want = torch.float32 if name.endswith("scale") else torch.bfloat16
        assert p.dtype == want, name
    assert all(p.dtype == torch.float32 for p in f32.parameters())


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_f32_params_give_the_same_logits(scanned, scan_layers):
    """f32 params at f32 compute give exactly the logits of the model with
    the default storage; with bf16 compute they are cast at each use and
    agree with the JAX model (bf16 compute, f32 params) to bf16 rounding."""
    jmodel, params, tmodel = scanned
    cfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32,
                              **ENTRY)
    f32 = t_llama.LlamaLM(cfg, device="cpu")
    f32.load_state_dict(t_convert.from_flax_params(cfg, params))
    toks = torch.from_numpy(_tokens(8, 2, 24))
    with torch.no_grad():
        assert torch.equal(f32(toks), tmodel(toks))
    jcfg = j_llama.config_tiny(dtype=jnp.bfloat16, scan_layers=scan_layers,
                               **ENTRY)
    jparams = params
    if not scan_layers:
        jparams = j_llama.LlamaLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    want = np.asarray(j_llama.LlamaLM(jcfg).apply({"params": jparams},
                                                  jnp.asarray(toks.numpy())))
    bcfg = t_llama.config_tiny(param_dtype=torch.float32, **ENTRY)
    mixed = t_llama.LlamaLM(bcfg, device="cpu")
    mixed.load_state_dict(t_convert.from_flax_params(bcfg, jparams))
    assert mixed.transformer.tok_embed.weight.dtype == torch.float32
    with torch.no_grad():
        got = mixed(toks).numpy()
    # bf16 compute on both sides, rounded at the same points: logits of
    # O(1) agree to a few bf16 ulps (eps 2^-8).
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def _jax_pool(cfg, pages, bt):
    shape = (cfg.n_layers, pages, bt,
             cfg.resolved_kv_heads * cfg.resolved_head_dim)
    return {"transformer": {"blocks": {"attn": {
        "cached_key": jnp.zeros(shape, jnp.float32),
        "cached_value": jnp.zeros(shape, jnp.float32)}}}}


def test_paged_prefill_and_decode_match_jax(scanned):
    """Two rows prefill two chunks each through their own block tables
    (the second chunk right-padded past the table's end, so pads land in
    the scratch page), then decode three tokens at their own cursors.
    Logits agree at every step, and so does every page the rows own."""
    jmodel, params, tmodel = scanned
    cfg = tmodel.cfg
    pages, bt, nb = 12, 8, 4                      # 32 virtual columns
    tables = np.array([[3, 7, 1, 9], [2, 5, 11, 4]], np.int32)
    jcache = _jax_pool(jmodel.cfg, pages, bt)
    lanes = cfg.resolved_kv_heads * cfg.resolved_head_dim
    tcache = [(torch.zeros(pages, bt, lanes), torch.zeros(pages, bt, lanes))
              for _ in range(cfg.n_layers)]
    toks = _tokens(5, 2, 40)
    for start, width in ((0, 20), (20, 16)):      # 20..35: pads past 31
        chunk = toks[:, start:start + width]
        pos = np.broadcast_to(np.arange(start, start + width),
                              (2, width)).astype(np.int32)
        want, jcache = j_generate.prefill_chunk(
            jmodel, params, jcache, jnp.asarray(chunk),
            positions=jnp.asarray(pos), block_tables=jnp.asarray(tables))
        got = t_generate.prefill_chunk(
            tmodel, tcache, torch.from_numpy(chunk),
            positions=torch.from_numpy(pos),
            block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        one = t_generate.prefill_chunk(
            tmodel, [(k.clone(), v.clone()) for k, v in tcache],
            torch.from_numpy(chunk), positions=torch.from_numpy(pos),
            block_tables=torch.from_numpy(tables), logits_index=3)
        np.testing.assert_allclose(one.numpy(), got.numpy()[:, 3], **TOL)
    cursors = np.array([25, 30], np.int32)
    nxt = toks[:, 25:27].copy()
    nxt[1] = toks[1, 30]
    for step in range(2):
        tok = nxt[:, 0] if step == 0 else np.argmax(got, -1).astype(np.int32)
        want, jcache = j_generate.slot_decode_step(
            jmodel, params, jcache, jnp.asarray(tok), jnp.asarray(cursors),
            block_tables=jnp.asarray(tables))
        got = t_generate.slot_decode_step(
            tmodel, tcache, torch.from_numpy(tok),
            torch.from_numpy(cursors),
            torch.from_numpy(tables)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        cursors = cursors + 1
    jk = np.asarray(jcache["transformer"]["blocks"]["attn"]["cached_key"])
    live = sorted(set(tables.ravel()))                # page 0 is scratch
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(tcache[layer][0].numpy()[live],
                                   jk[layer][live], **TOL)
