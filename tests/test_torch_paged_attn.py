"""PyTorch port, paged attention: the plain version against the JAX Pallas
kernel (interpret mode) on the JAX kernel tests' shapes, the cursor and
scratch-page invariants and input validation (the CUDA kernel itself is
held to the plain version in tests/test_torch_cuda_kernels.py).

Both sides run in float32; atol/rtol 2e-5 is the JAX kernel tests' own
bound for an online softmax against a plain one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops.paged_attn import (
    paged_decode_attention, paged_decode_attention_reference)
from k8s_distributed_deeplearning_tpu.ops import pallas_paged_attn

TOL = dict(atol=2e-5, rtol=2e-5)


def _case(rng, b, sq, h, hkv, pages, bt, nb, hd=8):
    """Random pools + per-row tables mapping every block to a distinct real
    page; positions cover the whole virtual range (the JAX tests' _case)."""
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    pool_k = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    pool_v = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, pages))[:b * nb]
    tables = perm.reshape(b, nb).astype(np.int32)
    base = rng.integers(sq - 1, nb * bt, size=b)
    positions = (base[:, None] - (sq - 1) + np.arange(sq)[None, :]).astype(
        np.int32)
    return q, pool_k, pool_v, tables, positions


def _jax(*arrays, **kw):
    return np.asarray(pallas_paged_attn.paged_decode_attention(
        *(jnp.asarray(a) for a in arrays), interpret=True, **kw))


def _torch(fn, *arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


SHAPES = [
    (2, 1, 4, 2, 16, 8, 4),      # classic single-token decode, GQA 2:1
    (3, 5, 4, 4, 32, 16, 3),     # speculative verify window, MHA
    (2, 3, 8, 2, 64, 4, 6),      # wide window, GQA 4:1, small pages
]


@pytest.mark.parametrize("b,sq,h,hkv,pages,bt,nb", SHAPES)
@pytest.mark.parametrize("fn", [paged_decode_attention_reference,
                                paged_decode_attention],
                         ids=["reference", "wrapper_cpu"])
def test_matches_jax_kernel(fn, b, sq, h, hkv, pages, bt, nb):
    rng = np.random.default_rng(b * 100 + sq * 10 + h)
    args = _case(rng, b, sq, h, hkv, pages, bt, nb)
    np.testing.assert_allclose(_torch(fn, *args), _jax(*args), **TOL)


def test_explicit_softmax_scale_matches_jax():
    rng = np.random.default_rng(5)
    args = _case(rng, 2, 2, 4, 2, 16, 8, 3)
    np.testing.assert_allclose(
        _torch(paged_decode_attention_reference, *args, softmax_scale=0.25),
        _jax(*args, softmax_scale=0.25), **TOL)


def test_stale_kv_beyond_cursor_never_attended():
    """Rewriting every pool token beyond each row's cursor changes no
    output bit, and the result still matches the JAX kernel."""
    rng = np.random.default_rng(11)
    q, pk, pv, tables, pos = _case(rng, 3, 2, 4, 2, 32, 8, 4)
    out = _torch(paged_decode_attention_reference, q, pk, pv, tables, pos)
    bt = pk.shape[1]
    pk2, pv2 = pk.copy(), pv.copy()
    for bi in range(tables.shape[0]):
        cursor = int(pos[bi].max())
        for blk in range(tables.shape[1]):
            for t in range(bt):
                if blk * bt + t > cursor:
                    pk2[tables[bi, blk], t] = 1e4
                    pv2[tables[bi, blk], t] = -1e4
    out2 = _torch(paged_decode_attention_reference, q, pk2, pv2, tables, pos)
    np.testing.assert_array_equal(out, out2)
    np.testing.assert_allclose(out2, _jax(q, pk2, pv2, tables, pos), **TOL)


def test_scratch_page_blocks_are_inert():
    """Table entries past the live length point at scratch page 0; giving
    those blocks a huge-valued page instead changes nothing."""
    rng = np.random.default_rng(13)
    b, sq, hd, pages, bt, nb = 2, 1, 8, 16, 8, 4
    q = rng.standard_normal((b, sq, 4, hd)).astype(np.float32)
    pool_k = rng.standard_normal((pages, bt, 2 * hd)).astype(np.float32)
    pool_v = rng.standard_normal((pages, bt, 2 * hd)).astype(np.float32)
    pool_k[7] = 1e4
    pool_v[7] = -1e4
    tables = np.array([[1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
    pos = np.array([[12], [5]], np.int32)       # live: 2 blocks / 1 block
    out = _torch(paged_decode_attention_reference, q, pool_k, pool_v,
                 tables, pos)
    np.testing.assert_allclose(out, _jax(q, pool_k, pool_v, tables, pos),
                               **TOL)
    garbage = np.where(tables == 0, 7, tables).astype(np.int32)
    out2 = _torch(paged_decode_attention_reference, q, pool_k, pool_v,
                  garbage, pos)
    np.testing.assert_array_equal(out, out2)


def test_fully_masked_row_is_exactly_zero():
    """A query whose cursor precedes every column emits exactly 0 (the
    kernel's p = 0 guard and max(l, 1e-30) floor), not NaN."""
    rng = np.random.default_rng(17)
    q, pk, pv, tables, pos = _case(rng, 2, 2, 4, 2, 16, 8, 3)
    pos[0, 0] = -1
    out = _torch(paged_decode_attention_reference, q, pk, pv, tables, pos)
    assert np.all(out[0, 0] == 0.0)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, _jax(q, pk, pv, tables, pos), **TOL)


def test_cpu_wrapper_does_not_count_launches():
    rng = np.random.default_rng(19)
    args = _case(rng, 2, 1, 4, 2, 16, 8, 4)
    before = paged_decode_attention.launches
    _torch(paged_decode_attention, *args)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize("mutate,match", [
    (lambda a: a.__setitem__("q", a["q"][0]), "q must be"),
    (lambda a: a.__setitem__("pool_v", a["pool_v"][:-1]), "identical"),
    (lambda a: a.__setitem__("q", a["q"][..., :3]), "multiple of head_dim"),
    (lambda a: a.__setitem__("q", a["q"][:, :, :3]), "not divisible"),
    (lambda a: a.__setitem__("block_tables", a["block_tables"][:1]),
     "block_tables must be"),
    (lambda a: a.__setitem__("positions", a["positions"][:, :0]),
     "positions must be"),
])
def test_validation_matches_jax_wrapper(mutate, match):
    rng = np.random.default_rng(23)
    q, pk, pv, tables, pos = (torch.from_numpy(a) for a in
                              _case(rng, 2, 1, 4, 2, 16, 8, 4))
    args = dict(q=q, pool_k=pk, pool_v=pv, block_tables=tables,
                positions=pos)
    mutate(args)
    with pytest.raises(ValueError, match=match):
        paged_decode_attention(**args)
