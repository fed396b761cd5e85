"""PyTorch port, the tensor-core prefill route of paged attention
(``csrc/paged_prefill.cu``) on the CPU, where the kernel cannot run.

- ``_route``: the engine's prefill chunks (bf16, 32-512 queries, Llama-3
  8B's 32/8 heads at head_dim 128, the small preset's 12/4 at 64) take
  the prefill kernel; bf16 decode takes the decode kernel; f32 q, other
  head dims and fewer than one 64-row tile per KV head (but more than the
  decode kernel's 16 rows) take the split kernel.
- A torch model of the kernel's arithmetic, written here, tile by tile
  over 64-key tiles as the kernel walks them, against the JAX Pallas
  kernel in interpret mode at Llama-3 8B's heads cut to a few pages:
  int8 (``S = k_scale * (Q . K_int8)`` in f32; ``p' = p * v_scale`` split
  into bf16 ``hi + lo``; bf16 products summed in f32) within the card's
  int8 limit, and fp (p rounded to bf16 at the running max) within 2e-2.
- CPU tensors take the plain version and count no launch on any route.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``) and in ``chip_smoke.py`` phase A.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models.transformer import quantize_kv
from k8s_distributed_deeplearning_torch.ops import paged_attn
from k8s_distributed_deeplearning_tpu.ops import pallas_paged_attn

KT = 64                              # the kernel's key tile
NEG_INF = -1e30
# bf16 output against the Pallas kernel, per element: |model - Pallas| <=
# 2^-10 x the output's RMS + 2^-7 x |Pallas| for int8 (the card's limit:
# the order of the f32 sums, the 2^-16 the hi/lo split leaves of p', and
# one bf16 step of the output); 2e-2 absolute for fp (p rounded to bf16 at
# the running max against Pallas' block-wise max, O(1) outputs in bf16).
INT8_TOL_BF16 = (2 ** -10, 2 ** -7)
FP_TOL = 2e-2


@pytest.mark.parametrize("sq", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("group,hd", [(4, 128), (3, 64)],
                         ids=["llama3_8b", "small"])
def test_engine_prefill_shapes_take_the_prefill_route(sq, quant, group, hd):
    assert paged_attn._route(sq, group, hd, torch.bfloat16,
                             quant) == "prefill"


@pytest.mark.parametrize("sq,group,hd,dtype", [
    (1, 4, 128, torch.bfloat16),      # decode
    (1, 8, 64, torch.bfloat16),
])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_shapes_take_the_decode_route(sq, group, hd, dtype, quant):
    """Decode left the split kernel for its own tensor-core kernel
    (``csrc/paged_decode.cu``); ``tests/test_torch_paged_decode.py`` holds
    that route's rule and arithmetic."""
    assert paged_attn._route(sq, group, hd, dtype, quant) == "decode"


@pytest.mark.parametrize("sq,group,hd,dtype", [
    (512, 4, 128, torch.float32),     # f32 q
    (512, 4, 8, torch.bfloat16),      # other head dims
    (512, 4, 80, torch.bfloat16),
    (512, 4, 256, torch.bfloat16),
    (15, 4, 128, torch.bfloat16),     # sq x group < 64
    (21, 3, 64, torch.bfloat16),
])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_other_shapes_take_the_split_route(sq, group, hd, dtype, quant):
    assert paged_attn._route(sq, group, hd, dtype, quant) == "split"


def _case(rng, b, sq, h, hkv, pages, bt, nb, hd):
    """Random pools, distinct real pages per row, the last ``sq``
    positions of live lengths drawn across the table."""
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    pool_k = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    pool_v = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, pages))[:b * nb].reshape(
        b, nb).astype(np.int32)
    base = rng.integers(sq - 1, nb * bt, size=b)
    pos = (base[:, None] - (sq - 1) + np.arange(sq)[None, :]).astype(
        np.int32)
    return q, pool_k, pool_v, tables, pos


def _quantized(pool, hd):
    x, s = quantize_kv(torch.from_numpy(pool).view(*pool.shape[:2], -1, hd))
    return x.view(pool.shape).numpy(), s.numpy()


def kernel_model(q, pool_k, pool_v, tables, positions, k_scale=None,
                 v_scale=None):
    """The prefill kernel's arithmetic, in torch: 64-key tiles in order,
    an online softmax in f32, Pallas' guards (NEG_INF, p = 0 where
    s <= NEG_INF/2, l floored at 1e-30). Products of bf16 values are exact
    in f32 (the tensor cores' inputs: bf16 q, bf16 or int8 K/V).
    fp: P.V takes p rounded to bf16 at the running max. int8: S is
    k_scale x (Q . K_int8); P.V takes p' = p x v_scale split into
    hi = bf16(p') and lo = bf16(p' - hi), two products against V_int8."""
    b, sq, h, hd = q.shape
    _, bt, kvhd = pool_k.shape
    hkv = kvhd // hd
    group = h // hkv
    tl = tables.long()
    s_virt = tables.shape[1] * bt
    k = pool_k[tl].reshape(b, s_virt, hkv, hd).float()
    v = pool_v[tl].reshape(b, s_virt, hkv, hd).float()
    quant = k_scale is not None
    if quant:
        ks = k_scale[tl].reshape(b, s_virt, hkv).permute(0, 2, 1)
        vs = v_scale[tl].reshape(b, s_virt, hkv).permute(0, 2, 1)
    qf = q.float().reshape(b, sq, hkv, group, hd)
    scale = hd ** -0.5
    m = torch.full((b, hkv, group, sq), NEG_INF)
    l = torch.zeros(b, hkv, group, sq)
    o = torch.zeros(b, hkv, group, sq, hd)
    for c0 in range(0, s_virt, KT):
        c1 = min(c0 + KT, s_virt)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, k[:, c0:c1])
        if quant:
            s = s * ks[:, :, None, None, c0:c1]
        s = s * scale
        allow = (torch.arange(c0, c1)[None, None, :]
                 <= positions.long()[:, :, None])          # [b, sq, c]
        s = torch.where(allow[:, None, None], s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= NEG_INF / 2, torch.tensor(0.0), p)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        if quant:
            p = p * vs[:, :, None, None, c0:c1]
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            pv = (torch.einsum("bkgqc,bckd->bkgqd", hi, v[:, c0:c1])
                  + torch.einsum("bkgqc,bckd->bkgqd", lo, v[:, c0:c1]))
        else:
            pv = torch.einsum("bkgqc,bckd->bkgqd",
                              p.to(torch.bfloat16).float(), v[:, c0:c1])
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def _pallas(q, pool_k, pool_v, tables, pos, scales=()):
    kw = (dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
          if scales else {})
    return np.asarray(pallas_paged_attn.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True,
        **kw).astype(jnp.float32))


# (b, sq, h, hkv, pages, page_tokens, n_blocks, head_dim): Llama-3 8B's
# heads and 32-token pages cut to 6 pages a row (three 64-key tiles, the
# last live one partial), and a 16-query chunk on 16-token pages.
MODEL_SHAPES = [(2, 64, 32, 8, 16, 32, 6, 128),
                (1, 16, 32, 8, 12, 16, 9, 128)]


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_kernel_arithmetic_matches_pallas(shape):
    q, pk, pv, tables, pos = _case(np.random.default_rng(sum(shape)), *shape)
    hd = shape[-1]
    (kq, ks), (vq, vs) = _quantized(pk, hd), _quantized(pv, hd)
    q = q.astype(jnp.bfloat16).astype(np.float32)   # bf16 q on both sides
    want = _pallas(q, kq, vq, tables, pos, (ks, vs))
    t = torch.from_numpy
    got = kernel_model(t(q).bfloat16(), t(kq), t(vq), t(tables), t(pos),
                       t(ks), t(vs)).float().numpy()
    limit = (INT8_TOL_BF16[0] * np.sqrt(np.mean(want ** 2))
             + INT8_TOL_BF16[1] * np.abs(want))
    err = np.abs(got - want)
    assert np.all(err <= limit), float(np.max(err / limit))


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fp_kernel_arithmetic_matches_pallas(shape):
    q, pk, pv, tables, pos = (
        a.astype(jnp.bfloat16).astype(np.float32) if a.dtype == np.float32
        else a for a in _case(np.random.default_rng(sum(shape) + 1), *shape))
    want = _pallas(q, pk.astype(jnp.bfloat16), pv.astype(jnp.bfloat16),
                   tables, pos)
    t = torch.from_numpy
    got = kernel_model(t(q).bfloat16(), t(pk).bfloat16(), t(pv).bfloat16(),
                       t(tables), t(pos)).float().numpy()
    np.testing.assert_allclose(got, want, atol=FP_TOL, rtol=FP_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_cpu_tensors_take_the_plain_version_on_either_route(quant):
    """A prefill-shaped bf16 chunk on the CPU is the plain version's, bit
    for bit, and no route counts a launch."""
    shape = (2, 64, 32, 8, 16, 32, 6, 128)
    q, pk, pv, tables, pos = _case(np.random.default_rng(41), *shape)
    t = torch.from_numpy
    kw = {}
    if quant:
        (pk, ks), (pv, vs) = _quantized(pk, 128), _quantized(pv, 128)
        kw = dict(k_scale=t(ks), v_scale=t(vs))
        pools = (t(pk), t(pv))
    else:
        pools = (t(pk).bfloat16(), t(pv).bfloat16())
    args = (t(q).bfloat16(), *pools, t(tables), t(pos))
    assert paged_attn._route(64, 4, 128, torch.bfloat16, quant) == "prefill"
    fn = paged_attn.paged_decode_attention
    before = (fn.launches, fn.launches_int8, fn.launches_prefill,
              fn.launches_prefill_int8)
    out = fn(*args, **kw)
    assert torch.equal(out, paged_attn.paged_decode_attention_reference(
        *args, **kw))
    assert (fn.launches, fn.launches_int8, fn.launches_prefill,
            fn.launches_prefill_int8) == before


def test_private_launcher_refuses_cpu_tensors():
    """The launcher behind the routes takes CUDA tensors only."""
    q, pk, pv, tables, pos = (torch.from_numpy(a) for a in _case(
        np.random.default_rng(43), 1, 16, 32, 8, 12, 16, 9, 128))
    with pytest.raises(ValueError, match="device cpu"):
        paged_attn._launch(q.bfloat16(), pk.bfloat16(), pv.bfloat16(),
                           tables, pos, route="prefill")
