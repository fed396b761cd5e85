"""PyTorch port, flash attention: the plain versions the CPU runs against
the Pallas kernels (``pallas_flash``) in interpret mode.

The same numpy-seeded f32 inputs go through ``pallas_flash._fwd`` /
``jax.grad(pallas_flash.flash_attention)`` and through the port's
``flash_attention_reference`` / ``flash_attention`` (the
``autograd.Function``, whose CPU branch runs the plain versions), on the
JAX kernel tests' shapes: b 2, s 32-64, d 16, h/hkv of 2/2, 4/2, 4/1 and
12/4, causal and not, sq != sk both ways, segment ids. Tolerance 2e-5 on
O(1) values: both sides compute in f32 and sum in different orders
(observed differences are ~1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import attention as t_attention
from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_tpu.ops import attention as j_attention
from k8s_distributed_deeplearning_tpu.ops import pallas_flash as pf

TOL = dict(atol=2e-5, rtol=2e-5)

torch.set_num_threads(2)

# (b, sq, sk, h, hkv, d, causal, segments)
SHAPES = [
    (2, 64, 64, 2, 2, 16, False, False),
    (2, 64, 64, 2, 2, 16, True, False),
    (2, 32, 32, 4, 2, 16, True, False),
    (2, 32, 32, 4, 1, 16, True, False),
    (2, 32, 32, 12, 4, 16, True, False),
    (2, 32, 64, 4, 2, 16, True, False),
    (2, 64, 32, 4, 2, 16, True, False),
    (2, 64, 64, 4, 2, 16, False, True),
    (2, 48, 48, 4, 2, 16, True, True),
]


def _inputs(shape, seed):
    b, sq, sk, h, hkv, d, _, seg = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    segq = segk = None
    if seg:
        segk = np.sort(rng.integers(0, 3, (b, sk)), axis=1).astype(np.int32)
        segq = segk[:, sk - sq:].copy()
    return q, k, v, do, segq, segk


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_pallas(shape):
    """o and the log-sum-exp (Pallas [B*kv, group, Sq] = port [B, H, Sq])."""
    q, k, v, _, segq, segk = _inputs(shape, sum(shape[:6]))
    causal, d = shape[6], shape[5]
    want_o, want_lse = pf._fwd(_j(q), _j(k), _j(v), _j(segq), _j(segk),
                               causal=causal, scale=d ** -0.5,
                               interpret=True)
    o, lse = fa.flash_attention_reference(
        _t(q), _t(k), _t(v), causal=causal, q_segment_ids=_t(segq),
        kv_segment_ids=_t(segk))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(lse.shape),
                               **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradients_match_pallas(shape):
    """o and dq/dk/dv through the port's autograd.Function against
    jax.grad through the Pallas custom VJP."""
    q, k, v, do, segq, segk = _inputs(shape, 100 + sum(shape[:6]))
    causal = shape[6]

    def f(q, k, v):
        o = pf.flash_attention(q, k, v, causal=causal, q_segment_ids=_j(segq),
                               kv_segment_ids=_j(segk), interpret=True)
        return (o * jnp.asarray(do)).sum(), o

    (_, want_o), want = jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal,
                           q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), **TOL)
    for name, got, ref in zip("qkv", (tq, tk, tv), want):
        assert got.grad.shape == ref.shape, f"d{name} shape"
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")


def test_fully_masked_rows_are_zero():
    """A query whose segment id no key carries, and causal rows with
    sq > sk that see no column, give exactly 0 in O and in dq, lse is
    NEG_INF, and the Pallas kernel agrees."""
    q, k, v, do, _, _ = _inputs((2, 48, 32, 4, 2, 16, True, False), 7)
    segk = np.ones((2, 32), np.int32)
    segq = np.ones((2, 48), np.int32)
    segq[0, 20:25] = 5
    want_o, _ = pf._fwd(_j(q), _j(k), _j(v), _j(segq), _j(segk), causal=True,
                        scale=0.25, interpret=True)
    tq = torch.from_numpy(q).requires_grad_()
    o, lse = fa.flash_attention_reference(
        tq.detach(), _t(k), _t(v), causal=True, q_segment_ids=_t(segq),
        kv_segment_ids=_t(segk))
    out = fa.flash_attention(tq, _t(k), _t(v), causal=True,
                             q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    out.backward(torch.from_numpy(do))
    for rows in (slice(0, 16), slice(20, 25)):   # 0..15: sq - sk = 16
        assert torch.all(o[0, rows] == 0)
        assert torch.all(out[0, rows] == 0)
        assert torch.all(tq.grad[0, rows] == 0)
        assert torch.all(lse[0, :, rows] <= -1e29)
        assert np.all(np.asarray(want_o)[0, rows] == 0)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)


def test_default_impl_rule_matches_jax():
    """auto picks the kernels where the JAX rule picks flash on its
    accelerator, with cuda in the place of tpu; the CPU takes the einsum
    path."""
    for s, kv in ((512, None), (1024, None), (2048, 1024), (1024, 1000),
                  (1536, 4096), (1000, 1000)):
        assert (t_attention.default_impl(s, kv, "cuda")
                == j_attention.default_impl(s, kv, "tpu"))
        assert t_attention.default_impl(s, kv, "cpu") == "xla"


def test_flash_impl_dispatches_to_flash_attention():
    """impl="flash" runs flash_attention (its plain version on the CPU)
    and agrees with the einsum path, segment ids included."""
    q, k, v, _, segq, _ = _inputs((2, 64, 64, 4, 2, 16, True, True), 3)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    seg = torch.from_numpy(segq)
    flash = t_attention.multi_head_attention(*args, causal=True,
                                             segment_ids=seg, impl="flash")
    xla = t_attention.multi_head_attention(*args, causal=True,
                                           segment_ids=seg, impl="xla")
    auto = t_attention.multi_head_attention(*args, causal=True,
                                            segment_ids=seg, impl="auto")
    torch.testing.assert_close(flash, xla, **TOL)
    assert torch.equal(auto, xla)


def test_flash_impl_refuses_a_general_mask(monkeypatch):
    """The kernels take causal and segment masking only: impl="flash" with
    a general mask raises instead of running the einsum path, and
    impl="auto" with one takes the einsum path even where the rule picks
    flash (as it does on the card at S >= 1024)."""
    monkeypatch.setattr(t_attention, "default_impl", lambda *a: "flash")
    q, k, v, _, _, _ = _inputs((1, 32, 32, 4, 2, 16, True, False), 5)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    mask = torch.from_numpy(
        np.random.default_rng(6).random((1, 1, 32, 32)) > 0.3)
    mask[..., 0] = True
    with pytest.raises(ValueError, match="general mask"):
        t_attention.multi_head_attention(*args, causal=True, mask=mask,
                                         impl="flash")
    want = t_attention.dot_product_attention(*args, causal=True, mask=mask)
    for impl in ("auto", "xla"):
        got = t_attention.multi_head_attention(*args, causal=True, mask=mask,
                                               impl=impl)
        assert torch.equal(got, want), impl


def test_validation_matches_the_pallas_wrapper():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, k)
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="together"):
        fa.flash_attention(q, k, k, q_segment_ids=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="kv_segment_ids"):
        fa.flash_attention(q, k, k, q_segment_ids=torch.zeros(1, 8),
                           kv_segment_ids=torch.zeros(1, 7))
