"""PyTorch port, quantized serving: int8 KV pages and per-channel int8
weights, against the JAX package's graftquant on the same weights.

- Weight quantization: the port's int8 values and scales equal JAX
  ``quantize_params`` exactly, scanned (one scale per channel shared by
  the layers) and unrolled, with the same leaf selection; the round trip
  is grid-stable; a calibration dict keyed by JAX paths clips the same.
- The paged-attention plain version's int8 branch against the Pallas
  kernel in interpret mode (f32 to 1e-6; bf16 q within one bf16 step),
  and against itself on an explicitly dequantized pool.
- Quantize on write: int8 cells and scales equal the JAX arithmetic.
- Engine: greedy streams of ``ServeEngine(kv_quant="int8",
  weight_quant="int8", device="cpu")`` equal the JAX engine's, unchunked
  and chunked, with no page leaks; the byte accounting equals JAX's.
- Modes, the quant-off pool, validation messages and the CLI.

Everything runs in float32 on ``config_tiny(max_seq_len=64)`` (head_dim
16), where the port's int8 kernel path and the JAX engine's XLA path
dequantize to the same f32 values.
"""
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.models import transformer as t_tf
from k8s_distributed_deeplearning_torch.ops import paged_attn as t_paged
from k8s_distributed_deeplearning_torch.serve import Request as TRequest
from k8s_distributed_deeplearning_torch.serve import ServeEngine as TEngine
from k8s_distributed_deeplearning_torch.serve import cli as t_cli
from k8s_distributed_deeplearning_torch.serve import quant as t_quant
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.ops.pallas_paged_attn import (
    paged_decode_attention as j_paged)
from k8s_distributed_deeplearning_tpu.serve import Request as JRequest
from k8s_distributed_deeplearning_tpu.serve import ServeEngine as JEngine
from k8s_distributed_deeplearning_tpu.serve import quant as j_quant

torch.set_num_threads(2)
QUANT = dict(kv_quant="int8", weight_quant="int8")
# Engine cases: (workload seed, engine options). Seeds 14 and 22 are the
# JAX quant tests' eval set; the chunked case prefills 4-16 token prompts
# in 8-token chunks.
ENGINE_CASES = {"seed14": (14, {}), "seed22": (22, {}),
                "seed14_chunk8": (14, dict(min_bucket=8,
                                           prefill_chunk_tokens=8))}


def _jax_params(scan_layers: bool):
    cfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=64,
                              scan_layers=scan_layers)
    model = j_llama.LlamaLM(cfg)
    params = model.init(jax.random.key(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _port(params):
    cfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64)
    model = t_llama.LlamaLM(cfg, device="cpu")
    model.load_state_dict(t_convert.from_flax_params(cfg, params))
    return model


def _workload(n, seed):
    """The JAX quant tests' ``_workload`` (prompts of 4-16 tokens, 3-15 new
    tokens, vocab 256)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=int(rng.integers(4, 17))).astype(
        np.int32) for _ in range(n)]
    return prompts, [int(rng.integers(3, 16)) for _ in range(n)]


def _jax_scales(scales) -> dict:
    return {j_quant._path_name(p): np.asarray(s) for p, s in
            jax.tree_util.tree_flatten_with_path(scales)[0]}


@pytest.fixture(scope="module")
def scanned():
    return _jax_params(True)


@pytest.fixture(scope="module")
def jax_runs(scanned):
    """Each JAX engine run once: streams and the engine, per case."""
    jmodel, params = scanned
    out = {}
    for case, (seed, kw) in ENGINE_CASES.items():
        prompts, max_news = _workload(8, seed)
        eng = JEngine(jmodel, params, num_slots=3, eos_id=None, **QUANT,
                      **kw)
        outs = {o.request_id: o for o in eng.run(
            [JRequest(prompt=p, max_new_tokens=m, request_id=f"r{i}")
             for i, (p, m) in enumerate(zip(prompts, max_news))])}
        out[case] = (eng, {rid: list(o.tokens) for rid, o in outs.items()})
    return out


# ----------------------------------------------------------- weight quant


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_weight_quant_equals_jax(scanned, scan):
    """Int8 values and scales equal JAX ``quantize_params`` exactly, and
    the port quantizes exactly the leaves JAX quantizes."""
    _, params = scanned if scan else _jax_params(False)
    qp, sc = j_quant.quantize_params(params)
    j_scales = _jax_scales(sc)
    want_q = t_convert.from_flax_params(
        t_llama.config_tiny(dtype=torch.float32, max_seq_len=64), qp)
    model = _port(params)
    t_quant.quantize_model(model, scan_layers=scan)
    assert t_quant.is_quantized(model)
    seen = set()
    for name, m in t_quant._quantizable(model):
        path = t_quant.jax_path_name(name, scan)
        seen.add(path)
        assert m.weight.dtype == torch.int8, name
        torch.testing.assert_close(m.weight.float(), want_q[name + ".weight"],
                                   atol=0, rtol=0)
        np.testing.assert_array_equal(m.weight_scale.numpy(),
                                      j_scales[path].reshape(-1))
    assert seen == {p for p, s in j_scales.items() if s.ndim > 0}
    # Embedding, norms and head stay fp.
    assert model.head.lm_head.weight.dtype == torch.float32
    assert model.transformer.tok_embed.weight.dtype == torch.float32


def test_scanned_scales_are_shared_across_layers(scanned):
    """Under scan_layers one scale tensor serves a module in every layer
    (the flax leaf's stacked layer axis); unrolled, each layer has its
    own."""
    model = _port(scanned[1])
    t_quant.quantize_model(model)
    blocks = model.transformer.blocks
    assert (blocks[0].attn.q_proj.weight_scale
            is blocks[1].attn.q_proj.weight_scale)
    assert blocks[0].attn.q_proj.weight_scale.shape == (16,)    # head_dim
    assert blocks[0].mlp.gate_proj.weight_scale.shape == (128,)
    model = _port(scanned[1])
    t_quant.quantize_model(model, scan_layers=False)
    assert (blocks := model.transformer.blocks)[0].attn.q_proj.weight_scale \
        is not blocks[1].attn.q_proj.weight_scale


def test_weight_round_trip_is_grid_stable(scanned):
    """Dequantized weights are the int8 grid points, within half a scale of
    the fp weights, and quantizing them again gives the same int8 values
    and scales."""
    model = _port(scanned[1])
    fp = {n: m.weight.detach().clone() for n, m in t_quant._quantizable(
        model)}
    t_quant.quantize_model(model)
    first = {n: (m.weight.clone(), m.weight_scale.clone())
             for n, m in t_quant._quantizable(model)}
    t_quant.dequantize_model(model)
    assert not t_quant.is_quantized(model)
    for n, m in t_quant._quantizable(model):
        q, s = first[n]
        rows = s.repeat(q.shape[0] // s.shape[0])[:, None]
        torch.testing.assert_close(m.weight, q.float() * rows, atol=0, rtol=0)
        assert bool(((fp[n] - m.weight).abs() <= rows / 2 + 1e-7).all()), n
    t_quant.quantize_model(model)
    for n, m in t_quant._quantizable(model):
        assert torch.equal(m.weight, first[n][0]), n
        assert torch.equal(m.weight_scale, first[n][1]), n


def test_calibration_clips_the_same_scales(scanned, tmp_path):
    _, params = scanned
    target = "transformer/blocks/attn/q_proj/kernel/value"
    calib = {"weights": {target: [1e-3] * 16}}
    path = tmp_path / "calib.json"
    path.write_text(json.dumps(calib))
    loaded = t_quant.load_calibration(str(path))
    j_scales = _jax_scales(j_quant.quantize_params(params, loaded)[1])
    model = _port(params)
    t_quant.quantize_model(model, loaded)
    for name, m in t_quant._quantizable(model):
        want = j_scales[t_quant.jax_path_name(name)].reshape(-1)
        np.testing.assert_array_equal(m.weight_scale.numpy(), want)
    assert bool((model.transformer.blocks[1].attn.q_proj.weight_scale
                 <= 1e-3 / 127.0 + 1e-12).all())
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    with pytest.raises(ValueError, match="calibration"):
        t_quant.load_calibration(str(bad))


def test_int8_dense_feeds_the_dequantized_weight():
    """An int8 Dense computes ``x @ ((f32(q) * scale).to(dtype))ᵀ``: the
    weight rounded once to the compute dtype, per-head scales broadcast
    over the heads."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        d = t_tf.Dense(32, 4 * 8, dtype=dtype, param_dtype=dtype)
        q = torch.randint(-127, 128, (32, 32), generator=gen,
                          dtype=torch.int8)
        s = torch.rand(8, generator=gen) * 1e-2
        d.set_int8(q, s)
        x = torch.randn(3, 32, generator=gen).to(dtype)
        w = (q.float().view(4, 8, 32) * s[None, :, None]).to(dtype)
        want = torch.nn.functional.linear(x, w.view(32, 32))
        torch.testing.assert_close(d(x), want, atol=0, rtol=0)


# ------------------------------------------------------ int8 plain version


def _quantize_pool(pool, hd):
    pages, bt, kvhd = pool.shape
    w = pool.reshape(pages, bt, kvhd // hd, hd).astype(np.float32)
    sc = np.max(np.abs(w), axis=-1) / 127.0
    q = np.clip(np.round(w / np.where(sc > 0, sc, 1.0)[..., None]),
                -127, 127).astype(np.int8)
    return q.reshape(pool.shape), sc.astype(np.float32)


def _int8_case(b, sq, h, hkv, pages, bt, nb, hd=8, seed=None):
    """The JAX quant kernel test's case: random pools quantized per token
    and head, distinct pages per row, cursors across the virtual range."""
    rng = np.random.default_rng(b * 10 + sq if seed is None else seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    pool_k = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    pool_v = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, pages))[:b * nb].reshape(
        b, nb).astype(np.int32)
    base = rng.integers(sq - 1, nb * bt, size=b)
    pos = (base[:, None] - (sq - 1) + np.arange(sq)[None, :]).astype(
        np.int32)
    qk, sk = _quantize_pool(pool_k, hd)
    qv, sv = _quantize_pool(pool_v, hd)
    return q, qk, qv, tables, pos, sk, sv


def _jax_int8(q, qk, qv, tables, pos, sk, sv, q_dtype=jnp.float32):
    return np.asarray(j_paged(
        jnp.asarray(q, q_dtype), jnp.asarray(qk), jnp.asarray(qv),
        jnp.asarray(tables), jnp.asarray(pos), k_scale=jnp.asarray(sk),
        v_scale=jnp.asarray(sv), interpret=True).astype(jnp.float32))


def _torch_int8(fn, q, qk, qv, tables, pos, sk, sv, q_dtype=torch.float32):
    t = torch.from_numpy
    return fn(t(q).to(q_dtype), t(qk), t(qv), t(tables), t(pos),
              k_scale=t(sk), v_scale=t(sv)).float().numpy()


JAX_SHAPES = [(2, 1, 4, 2, 16, 8, 4),    # test_quant.py's decode case
              (3, 5, 4, 4, 32, 16, 3)]   # and its verify-window case


@pytest.mark.parametrize("b,sq,h,hkv,pages,bt,nb", JAX_SHAPES)
@pytest.mark.parametrize("fn", [t_paged.paged_decode_attention_reference,
                                t_paged.paged_decode_attention],
                         ids=["reference", "wrapper_cpu"])
def test_int8_plain_version_matches_pallas(fn, b, sq, h, hkv, pages, bt, nb):
    args = _int8_case(b, sq, h, hkv, pages, bt, nb)
    np.testing.assert_allclose(_torch_int8(fn, *args), _jax_int8(*args),
                               atol=1e-6, rtol=1e-6)


def test_int8_bf16_q_within_one_bf16_step():
    """bf16 q over int8 pools: the Pallas kernel dequantizes K and V to f32
    and keeps P in f32, then rounds the output to bf16 once; the plain
    version does the same, so each output lies within one bf16 step
    (2^(e-7) for |out| in [2^e, 2^(e+1))) of the kernel's. P rounded to
    bf16, as the fp branch does, misses that bound."""
    args = _int8_case(2, 4, 8, 2, 64, 16, 6, hd=16, seed=3)
    want = _jax_int8(*args, q_dtype=jnp.bfloat16)
    got = _torch_int8(t_paged.paged_decode_attention_reference, *args,
                      q_dtype=torch.bfloat16)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step)

    # The same arithmetic with P rounded to bf16 before P.V.
    q, qk, qv, tables, pos, sk, sv = (torch.from_numpy(a) for a in args)
    b, sq, h, hd = q.shape
    s_virt, hkv = tables.shape[1] * qk.shape[1], sk.shape[-1]
    k = (qk[tables.long()].float().reshape(b, s_virt, hkv, hd)
         * sk[tables.long()].reshape(b, s_virt, hkv, 1))
    v = (qv[tables.long()].float().reshape(b, s_virt, hkv, hd)
         * sv[tables.long()].reshape(b, s_virt, hkv, 1))
    qg = q.to(torch.bfloat16).float().reshape(b, sq, hkv, h // hkv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * hd ** -0.5
    allow = torch.arange(s_virt)[None, None, :] <= pos.long()[:, :, None]
    probs = torch.softmax(scores.masked_fill(~allow[:, None, None],
                                             float("-inf")), -1)
    rounded = torch.einsum("bkgqs,bskd->bqkgd",
                           probs.to(torch.bfloat16).float(), v)
    rounded = rounded.reshape(b, sq, h, hd).to(torch.bfloat16).float()
    assert np.any(np.abs(rounded.numpy() - want) > step)


@pytest.mark.parametrize("b,sq,h,hkv,pages,bt,nb", JAX_SHAPES)
def test_int8_equals_explicitly_dequantized_pool(b, sq, h, hkv, pages, bt,
                                                 nb):
    """The int8 branch dequantizes as the plain fp path on a pool
    dequantized beforehand (``f32(int8) * scale``), and both equal the
    Pallas kernel on that fp pool."""
    q, qk, qv, tables, pos, sk, sv = _int8_case(b, sq, h, hkv, pages, bt, nb)
    hd = q.shape[-1]

    def deq(x, s):
        return (x.reshape(pages, bt, hkv, hd).astype(np.float32)
                * s[..., None]).reshape(pages, bt, hkv * hd)

    dk, dv = deq(qk, sk), deq(qv, sv)
    t = torch.from_numpy
    fp = t_paged.paged_decode_attention_reference(
        t(q), t(dk), t(dv), t(tables), t(pos)).numpy()
    got = _torch_int8(t_paged.paged_decode_attention_reference, q, qk, qv,
                      tables, pos, sk, sv)
    np.testing.assert_allclose(got, fp, atol=1e-6, rtol=1e-6)
    want = np.asarray(j_paged(*(jnp.asarray(a) for a in (q, dk, dv, tables,
                                                        pos)),
                              interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_quantize_on_write_equals_jax_arithmetic():
    """K/V of a chunk [B, S, kv, hd] (one all-zero token, and one head
    whose scale is exactly 1 with values halfway between integers, which
    round half to even): int8 cells and f32 scales equal the JAX paged
    write's arithmetic (transformer.py:486-499) exactly."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, 2, 16)) * 3).astype(np.float32)
    x[0, 1] = 0.0
    x[1, 2, 0] = np.arange(16, dtype=np.float32) - 7.5
    x[1, 2, 0, 0] = 127.0
    w = jnp.asarray(x)
    sc = jnp.max(jnp.abs(w), axis=-1) / 127.0
    want_q = np.asarray(jnp.clip(jnp.round(
        w / jnp.where(sc > 0.0, sc, 1.0)[..., None]), -127, 127).astype(
            jnp.int8))
    got_q, got_s = t_tf.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(sc))
    assert not got_q[0, 1].any() and not got_s[0, 1].any()
    assert got_s[1, 2, 0] == 1.0
    assert got_q[1, 2, 0, 1:5].tolist() == [-6, -6, -4, -4]


# ------------------------------------------------------------ the engine


def _port_engine(params, **kw):
    eng = TEngine(_port(params), num_slots=3, device="cpu", **kw)
    return eng, eng.pool.available()


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_quantized_engine_streams_identical_to_jax(scanned, jax_runs, case):
    """kv + weight int8: every greedy stream equals the JAX engine's, and
    no page leaks."""
    seed, kw = ENGINE_CASES[case]
    prompts, max_news = _workload(8, seed)
    eng, free0 = _port_engine(scanned[1], **QUANT, **kw)
    outs = {o.request_id: list(o.tokens) for o in eng.run(
        [TRequest(prompt=p, max_new_tokens=m, request_id=f"r{i}")
         for i, (p, m) in enumerate(zip(prompts, max_news))])}
    assert outs == jax_runs[case][1]
    assert eng.pool.available() == free0 and eng.pool.reserved == 0
    if kw:
        assert eng.stats.summary()["requests_completed"] == 8


def test_plain_path_matches_kernel_path_under_quant(scanned):
    """``attention_impl="xla"`` (gather, dequantize to the compute dtype,
    fp attention; the JAX XLA branch) gives the streams of the default
    path (the int8 kernel's plain version): in f32 both dequantize to the
    same values."""
    prompts, max_news = _workload(6, 9)
    streams = []
    for impl in ("auto", "xla"):
        cfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64,
                                  attention_impl=impl)
        model = t_llama.LlamaLM(cfg, device="cpu")
        model.load_state_dict(t_convert.from_flax_params(cfg, scanned[1]))
        eng = TEngine(model, num_slots=3, device="cpu", **QUANT)
        streams.append({o.request_id: o.tokens for o in eng.run(
            [TRequest(prompt=p, max_new_tokens=m, request_id=f"r{i}")
             for i, (p, m) in enumerate(zip(prompts, max_news))])})
    assert streams[0] == streams[1]


def test_byte_accounting_equals_jax(scanned, jax_runs):
    """Bytes per page (fp and int8) and the KV bytes saved equal the JAX
    engine's. The weight bytes saved differ by 4 bytes per unquantized
    leaf: JAX keeps a scalar f32 sentinel scale for each (embedding, two
    norm scales stacked over the layers, final norm, LM head: 5 leaves
    scanned) and counts it as quantized bytes; the port keeps none."""
    jeng = jax_runs["seed14"][0]
    eng, _ = _port_engine(scanned[1], **QUANT)
    for mode in (None, "int8"):
        assert (eng._block_nbytes(eng.page_tokens, kv_quant=mode)
                == jeng._block_nbytes(jeng.page_tokens, kv_quant=mode))
    assert eng._block_nbytes(eng.page_tokens) == jeng._block_nbytes(
        jeng.page_tokens)
    summ, jsumm = eng.stats.summary(), jeng.stats.summary()
    assert summ["kv_quant_bytes_saved"] == jsumm["kv_quant_bytes_saved"] > 0
    n_passthrough = sum(1 for _, s in _jax_scales(
        j_quant.quantize_params(scanned[1])[1]).items() if s.ndim == 0)
    assert n_passthrough == 5
    assert (summ["weight_quant_bytes_saved"]
            == jsumm["weight_quant_bytes_saved"] + 4 * n_passthrough)
    assert summ["kv_quant"] == summ["weight_quant"] == "int8"


def test_unknown_modes_raise_and_quant_off_has_no_scales(scanned):
    model = _port(scanned[1])
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(model, num_slots=2, device="cpu", kv_quant="fp8")
    with pytest.raises(ValueError, match="weight_quant"):
        TEngine(model, num_slots=2, device="cpu", weight_quant="int4")
    with pytest.raises(ValueError, match="kv_quant"):
        t_llama.config_tiny(kv_quant="int4")
    eng = TEngine(model, num_slots=2, device="cpu")
    assert all(len(layer) == 2 for layer in eng._cache)
    assert all(t.dtype == torch.float32 for layer in eng._cache
               for t in layer)
    summ = eng.stats.summary()
    assert summ["kv_quant"] is None and summ["weight_quant"] is None
    assert summ["kv_quant_bytes_saved"] == 0
    assert model.cfg.kv_quant is None and not t_quant.is_quantized(model)
    qeng = TEngine(model, num_slots=2, device="cpu", kv_quant="int8")
    assert model.cfg.kv_quant == "int8"
    assert all(blk.attn.cfg is model.cfg
               for blk in model.transformer.blocks)
    for pool_k, pool_v, k_scale, v_scale in qeng._cache:
        assert pool_k.dtype == pool_v.dtype == torch.int8
        assert k_scale.dtype == v_scale.dtype == torch.float32
        assert k_scale.shape == pool_k.shape[:2] + (2,)


def test_scale_validation_messages():
    q = torch.zeros(2, 1, 4, 8)
    pk = torch.zeros(8, 4, 16, dtype=torch.int8)
    sk = torch.zeros(8, 4, 2)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        t_paged.paged_decode_attention(q, pk, pk, tables, pos, k_scale=sk)
    with pytest.raises(ValueError, match="per-token-per-head"):
        t_paged.paged_decode_attention(q, pk, pk, tables, pos,
                                       k_scale=sk[:, :, :1], v_scale=sk)
    with pytest.raises(TypeError, match="int8 pools"):
        t_paged.paged_decode_attention(q, pk.float(), pk.float(), tables,
                                       pos, k_scale=sk, v_scale=sk)


def test_cli_serves_quantized():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = t_cli.main(["--kv-quant", "int8", "--weight-quant", "int8",
                         "--device", "cpu", "--slots", "2", "--requests",
                         "3", "--prompt-len", "4", "40", "--out-len", "2",
                         "5", "--max-seq-len", "64"])
    assert rc == 0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    quant = next(e for e in events if e["event"] == "quant_summary")
    assert quant["kv_quant"] == quant["weight_quant"] == "int8"
    assert quant["kv_quant_bytes_saved"] > 0
    assert quant["weight_quant_bytes_saved"] > 0
    summ = events[-1]
    assert summ["event"] == "serve_summary"
    assert summ["requests_completed"] == 3
    assert summ["kv_quant"] == summ["weight_quant"] == "int8"
