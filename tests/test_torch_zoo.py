"""PyTorch port, the transformer zoo: the core's BERT/ViT features
(``models/transformer.py``: flax-semantics LayerNorm, the GELU MLP with
biases, learned positions, embeddings in place of tokens, dropout),
``models/bert.py`` and ``models/vit.py``, each against the JAX package on
the same weights (through ``models/convert.py``) and the same numpy-seeded
inputs.

Config: the JAX packages' ``config_tiny``s (dim 64, 2 layers, 4 heads, MLP
128) in float32 on both sides. Tolerances: hidden states 1e-5 (LayerNorm
outputs of O(1), sums in different orders), logits 1e-4, loss and
accuracy 1e-5, each gradient tensor's relative L2 distance 1e-5 against
``jax.grad``. JAX's masks and dropout come from its own PRNG, so masks
cross over as inputs, and active dropout is held to same-seed determinism
and its statistics.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import bert as t_bert
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import (
    transformer as t_transformer)
from k8s_distributed_deeplearning_torch.models import vit as t_vit
from k8s_distributed_deeplearning_tpu.models import bert as j_bert
from k8s_distributed_deeplearning_tpu.models import (
    transformer as j_transformer)
from k8s_distributed_deeplearning_tpu.models import vit as j_vit

HIDDEN_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    """The same TransformerConfig in both packages, f32 compute."""
    return (j_transformer.TransformerConfig(dtype=jnp.float32, **kw),
            t_transformer.TransformerConfig(dtype=torch.float32, **kw))


TINY = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, mlp_dim=128,
            max_seq_len=32)
# name: (config overrides, scan_layers, input: "tokens" | "embeds",
# explicit positions). Each turns on one of the core's zoo features.
FEATURES = {
    "layernorm_gelu_rope": (dict(activation="gelu", norm="layernorm"),
                            True, "tokens", False),
    "learned_positions": (dict(activation="gelu", norm="layernorm",
                               position="learned", causal=False), True,
                          "tokens", False),
    "learned_explicit_positions_unrolled": (
        dict(activation="gelu", norm="layernorm", position="learned"),
        False, "tokens", True),
    "embeddings_in": (dict(activation="gelu", norm="layernorm",
                           position="none", causal=False), True, "embeds",
                      False),
    "dropout_deterministic": (dict(activation="gelu", norm="layernorm",
                                   position="learned", causal=False,
                                   dropout_rate=0.3), True, "tokens",
                              False),
    "swiglu_layernorm": (dict(norm="layernorm"), True, "tokens", False),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_transformer_feature_matches_jax(name):
    over, scan, kind, explicit = FEATURES[name]
    jcfg, tcfg = _cfgs(**TINY, **over)
    jcfg = dataclasses.replace(jcfg, scan_layers=scan)
    rng = np.random.default_rng(7)
    if kind == "tokens":
        x = rng.integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    else:
        x = rng.normal(size=(2, 12, TINY["dim"])).astype(np.float32)
    kw_j, kw_t = {}, {}
    if explicit:
        pos = rng.integers(0, TINY["max_seq_len"], (2, 12)).astype(np.int32)
        kw_j, kw_t = {"positions": jnp.asarray(pos)}, {"positions": _t(pos)}
    jm = j_transformer.Transformer(jcfg)
    params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x),
                              **kw_j)["params"]
    want = _np(jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                                 **kw_j))
    tm = t_transformer.Transformer(tcfg, device="cpu",
                                   token_embed=kind == "tokens")
    sd = t_convert.encoder_from_flax(tcfg, params, "")
    tm.load_state_dict(sd)
    assert set(sd) == set(tm.state_dict())
    if kind == "embeds":
        assert "tok_embed" not in params and tm.tok_embed is None
    with torch.no_grad():
        got = tm(_t(x), deterministic=True, **kw_t).numpy()
    np.testing.assert_allclose(got, want, **HIDDEN_TOL)


def test_layernorm_copies_flax_rounding_in_bf16():
    """bf16 input, f32 statistics and affine, bf16 output: flax
    ``nn.LayerNorm`` (epsilon 1e-6) and the port agree to one bf16
    rounding of the output."""
    import flax.linen as nn
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 9, 64)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    want = nn.LayerNorm(dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x, jnp.bfloat16))
    ln = t_transformer.LayerNorm(64, dtype=torch.bfloat16)
    ln.load_state_dict({"scale": _t(scale), "bias": _t(bias)})
    with torch.no_grad():
        got = ln(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want).astype(np.float32),
                               atol=2 ** -6, rtol=2 ** -7)


def test_active_dropout_is_seeded_and_scaled():
    """``deterministic=False``: the same generator seed gives the same
    output, another seed another one; the kept share of a large draw is
    within 3 sigma of 1 - rate and kept values are x / (1 - rate); the
    global generator is not touched."""
    rate = 0.25
    x = torch.randn(64, 128, 96)
    gen = torch.Generator()
    gen.manual_seed(5)
    y = t_transformer.dropout(x, rate, gen)
    kept = y != 0
    share = float(kept.float().mean())
    sigma = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(share - (1 - rate)) <= 3 * sigma
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate))

    _, tcfg = _cfgs(**TINY, activation="gelu", norm="layernorm",
                    position="learned", causal=False, dropout_rate=0.2)
    tm = t_transformer.Transformer(tcfg, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    t_transformer.init_weights(tm, g)
    toks = torch.randint(0, TINY["vocab_size"], (2, 10), generator=g)

    def run(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        with torch.no_grad():
            return tm(toks, deterministic=False, generator=gen)

    state = torch.random.get_rng_state()
    a, b, c = run(11), run(11), run(12)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        det = tm(toks)
    assert not torch.equal(a, det)
    with pytest.raises(ValueError, match="generator"):
        tm(toks, deterministic=False)


def test_dropout_masks_repeat_under_remat():
    """A remat block recomputes its forward in the backward: each layer's
    generator is re-seeded there, so gradients with remat equal those
    without."""
    _, tcfg = _cfgs(**TINY, activation="gelu", norm="layernorm",
                    position="learned", causal=False, dropout_rate=0.3)
    grads = []
    for remat in (False, True):
        tm = t_transformer.Transformer(
            dataclasses.replace(tcfg, remat=remat), device="cpu")
        g = torch.Generator()
        g.manual_seed(0)
        t_transformer.init_weights(tm, g)
        toks = torch.randint(0, TINY["vocab_size"], (2, 10), generator=g)
        gen = torch.Generator()
        gen.manual_seed(9)
        tm(toks, deterministic=False, generator=gen).square().sum().backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n])


def test_config_rejects_unknown_recipes():
    for field, value in (("activation", "relu"), ("norm", "batch"),
                         ("position", "alibi")):
        with pytest.raises(ValueError, match=field):
            t_transformer.TransformerConfig(**{field: value})


def test_learned_dense_decode_needs_positions():
    """JAX ``transformer.py:779``: dense decode of a learned-position model
    without positions raises the same error."""
    from k8s_distributed_deeplearning_torch.models import generate as t_gen
    bcfg = j_bert.config_tiny()
    btoks = jnp.zeros((1, 8), jnp.int32)
    enc = j_transformer.Transformer(bcfg)
    eparams = jax.jit(enc.init)(jax.random.key(2), btoks)["params"]
    with pytest.raises(NotImplementedError) as jerr:
        enc.apply({"params": eparams}, btoks, decode=True, mutable=["cache"])
    tcfg = t_bert.config_tiny(dtype=torch.float32)
    tm = t_transformer.Transformer(tcfg, device="cpu")
    cache = t_transformer.DenseCache.create(tcfg, 1, 64)
    with pytest.raises(NotImplementedError) as terr:
        tm(torch.zeros(1, 8, dtype=torch.long), decode=True, cache=cache)
    assert str(terr.value) == str(jerr.value)
    assert cache.index == 0
    del t_gen


# ------------------------------------------------------------------ BERT

def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    w = torch.from_numpy(np.asarray(want, np.float64))
    return float((got.double() - w).norm() / w.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def bert_pair():
    jcfg = j_bert.config_tiny(dtype=jnp.float32)
    jm = j_bert.BertMLM(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(5, jcfg.vocab_size, (2, 32)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.key(1),
                              jnp.asarray(tokens))["params"]
    # A non-zero mlm_bias, so its gradient and its add are exercised.
    params = jax.tree.map(lambda x: x, params)
    params["mlm_bias"] = jnp.asarray(
        rng.normal(size=(jcfg.vocab_size,)).astype(np.float32) * 0.1)
    inputs, targets, weights = j_bert.mask_tokens(
        jnp.asarray(tokens), jax.random.key(2), vocab_size=jcfg.vocab_size,
        mask_id=3)
    batch = {"inputs": _np(inputs), "targets": _np(targets),
             "weights": _np(weights)}
    tcfg = t_bert.config_tiny(dtype=torch.float32)
    tm = t_bert.BertMLM(tcfg, device="cpu")
    sd = t_convert.bert_from_flax(tcfg, params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return jm, params, tm, tcfg, batch


def test_bert_logits_loss_and_gradients_match_jax(bert_pair):
    jm, params, tm, tcfg, batch = bert_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits = _np(jax.jit(jm.apply)({"params": params},
                                         jbatch["inputs"]))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_bert.loss_fn(jm, p, jbatch), has_aux=True))(params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tm(tbatch["inputs"])
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGIT_TOL)
    tm.zero_grad()
    loss, aux = t_bert.loss_fn(tm, tbatch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5, rel=1e-5)
    assert float(aux["accuracy"]) == pytest.approx(float(jaux["accuracy"]),
                                                   abs=1e-5)
    want = t_convert.bert_from_flax(tcfg, jax.tree.map(_np, jgrads))
    for n, p in tm.named_parameters():
        assert _rel_l2(p.grad, want[n].numpy()) <= GRAD_RTOL, n


def test_bert_tied_head_has_no_decode_matrix(bert_pair):
    _, _, tm, tcfg, _ = bert_pair
    for n, p in tm.named_parameters():
        assert not (p.ndim == 2 and tcfg.vocab_size in p.shape
                    and n != "encoder.tok_embed.weight"), n


def test_mask_tokens_keeps_bert_proportions():
    """JAX ``tests/test_model_zoo.py:114`` on the port's masking, then
    BERT's 80/10/10 split of the selected positions on a large draw, each
    share within 3 sigma."""
    gen = torch.Generator()
    gen.manual_seed(1)
    tokens = torch.randint(5, 250, (4, 128), generator=gen)
    inputs, targets, weights = t_bert.mask_tokens(
        tokens, gen, vocab_size=256, mask_id=3)
    w = weights.numpy()
    assert 0.05 < w.mean() < 0.30
    changed = (inputs != tokens).numpy()
    assert changed.mean() < w.mean() + 1e-6
    assert torch.equal(targets, tokens)

    big = torch.randint(5, 250, (64, 512), generator=gen)
    inputs, _, weights = t_bert.mask_tokens(big, gen, vocab_size=256,
                                            mask_id=3)
    sel = weights.bool()
    # Shares of a 32,768-token draw; the limits are ~5 binomial sigma
    # (torch's CPU generator spreads a little wider than binomial).
    assert abs(float(sel.float().mean()) - 0.15) <= 0.01
    masked = float((inputs[sel] == 3).float().mean())
    kept = float((inputs[sel] == big[sel]).float().mean())
    assert abs(masked - 0.8) <= 0.03
    # Unchanged: the 10 % kept plus the random draws that hit the token.
    assert abs(kept - 0.1) <= 0.03
    assert not bool((inputs[~sel] != big[~sel]).any())


# ------------------------------------------------------------------- ViT

@pytest.fixture(scope="module")
def vit_pair():
    jcfg = j_vit.config_tiny(dtype=jnp.float32)
    jm = j_vit.ViT(jcfg, patch_size=8, num_classes=10)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4,)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.key(1),
                              jnp.asarray(images))["params"]
    # A random head (JAX initialises it at 0, where every encoder
    # gradient is exactly 0) and a random [CLS] token.
    params = dict(params)
    params["head"] = {
        "kernel": jnp.asarray(rng.normal(size=(64, 10)).astype(np.float32)
                              * 0.2),
        "bias": jnp.asarray(rng.normal(size=(10,)).astype(np.float32))}
    params["cls_token"] = jnp.asarray(
        rng.normal(size=(1, 1, 64)).astype(np.float32))
    tcfg = t_vit.config_tiny(dtype=torch.float32)
    tm = t_vit.ViT(tcfg, patch_size=8, num_classes=10, image_size=32,
                   device="cpu")
    sd = t_convert.vit_from_flax(tcfg, params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return jm, params, tm, tcfg, {"image": images, "label": labels}


def test_vit_logits_loss_and_gradients_match_jax(vit_pair):
    jm, params, tm, tcfg, batch = vit_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits = _np(jax.jit(jm.apply)({"params": params},
                                         jbatch["image"]))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_vit.loss_fn(jm, p, jbatch), has_aux=True))(params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tm(tbatch["image"])
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGIT_TOL)
    tm.zero_grad()
    loss, aux = t_vit.loss_fn(tm, tbatch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5, rel=1e-5)
    assert float(aux["accuracy"]) == pytest.approx(float(jaux["accuracy"]),
                                                   abs=1e-5)
    want = t_convert.vit_from_flax(tcfg, jax.tree.map(_np, jgrads))
    for n, p in tm.named_parameters():
        assert _rel_l2(p.grad, want[n].numpy()) <= GRAD_RTOL, n


def test_vit_flops_and_l16_parameter_count_match_jax():
    """JAX ``tests/test_model_zoo.py:181``: ViT-L/16 at 224² has JAX's
    parameter count (~304 M), and ``flops_per_image`` equals JAX's."""
    jcfg = j_vit.config_vit_l16()
    jm = j_vit.ViT(jcfg, patch_size=16, num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tm = t_vit.ViT(t_vit.config_vit_l16(param_dtype=torch.bfloat16),
                   patch_size=16, num_classes=1000, device="cpu")
    got = sum(p.numel() for p in tm.parameters())
    assert got == want and 0.29e9 < got < 0.32e9
    assert t_vit.flops_per_image(tm) == pytest.approx(
        j_vit.flops_per_image(jm), rel=1e-12)


# ------------------------------------------------------ learned positions

def test_generate_with_learned_positions_matches_jax(monkeypatch):
    """JAX ``tests/test_generate.py:77`` across packages: a tiny causal
    Llama with ``position="learned"`` generates JAX's greedy tokens,
    unpadded and left-padded, over a cache of the full ``max_seq_len``
    (JAX keeps the full window for learned positions)."""
    from k8s_distributed_deeplearning_torch.models import generate as t_gen
    from k8s_distributed_deeplearning_torch.models import llama as t_llama
    from k8s_distributed_deeplearning_tpu.models import generate as j_gen
    from k8s_distributed_deeplearning_tpu.models import llama as j_llama

    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=64,
                               position="learned")
    jm = j_llama.LlamaLM(jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.key(1),
                              jnp.asarray(tokens))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64,
                               position="learned")
    tm = t_llama.LlamaLM(tcfg, device="cpu")
    tm.load_state_dict(t_convert.from_flax_params(tcfg, params))
    widths = []
    prefill = t_gen.prefill

    def spy(model, prompt, **kw):
        widths.append(kw.get("cache_len"))
        return prefill(model, prompt, **kw)

    monkeypatch.setattr(t_gen, "prefill", spy)
    want = np.asarray(j_gen.generate(jm, params, jnp.asarray(tokens[:, :6]),
                                     max_new_tokens=8))
    got = t_gen.generate(tm, _t(tokens[:, :6]), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert widths == [64]

    lens, s = [4, 6], 6
    padded = np.zeros((2, s), np.int32)
    mask = np.zeros((2, s), np.int32)
    for r, n in enumerate(lens):
        padded[r, s - n:] = tokens[r, :n]
        mask[r, s - n:] = 1
    want = np.asarray(j_gen.generate(jm, params, jnp.asarray(padded),
                                     max_new_tokens=5,
                                     prompt_mask=jnp.asarray(mask)))
    got = t_gen.generate(tm, _t(padded), max_new_tokens=5,
                         prompt_mask=_t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    for r, n in enumerate(lens):
        row = t_gen.generate(tm, _t(tokens[r:r + 1, :n]), max_new_tokens=5)
        np.testing.assert_array_equal(got.numpy()[r], row.numpy()[0])
