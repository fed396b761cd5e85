"""PyTorch port, the bf16 flash backward's delta (``ops/flash_attn.py``
``flash_delta_reference``, the plain version of ``flash_bwd_delta`` and
``csrc/flash_delta.cu``) on the CPU.

The JAX wrapper (``pallas_flash.py:669``) computes delta = rowsum(dO · O)
from the bf16 output O, which rounds P to bf16 for P·V and then rounds
itself: ~2^-9 of |dO||O| away from the sum of P·dP that the backward
kernels' own P and dP give. dQ_i = sum_j dS_ij k_j turns the miss into a
term that dominates dQ wherever the values a row attends are nearly equal
(deep encoders at initialisation). These tests hold: the plain delta to
the f64 sum of P·dP; the bf16 backward's dQ with it to an f64 evaluation
about as closely as the einsum path's bf16 autograd, where rowsum(dO · O)
misses by several times that; the CPU backward taking the new delta in
bf16 and rowsum(dO · O) in f32; the kernel wrapper's route rule (the
wgmma kernel at head_dim 64/128, the small one at 16/32) and its refusing
CPU tensors, f32 and a wgmma route forced at 16/32, with no launch
counted on any route. Tolerances:
delta 1e-5 of the f64 (f32 sums); dQ distances are relative L2 against
f64, compared between the paths.
"""
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import attention as t_attn
from k8s_distributed_deeplearning_torch.ops import flash_attn as fa


def _inputs(seed, b=1, s=256, h=2, hkv=1, d=64, shared=0.0, spread=1.0):
    """q and dO ~ N(0, 1); k and v each ``shared`` x one row common to all
    positions plus a part of their own, N(0, 1) for k and ``spread`` x
    N(0, 1) for v: with a large shared part, the keys and values a row
    attends are nearly equal, as in a deep encoder at initialisation."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, do = t(b, s, h, d), t(b, s, h, d)
    k = shared * t(1, 1, hkv, d) + t(b, s, hkv, d)
    v = shared * t(1, 1, hkv, d) + spread * t(b, s, hkv, d)
    return q, k, v, do


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,segments", [(False, False), (True, False),
                                             (True, True)])
def test_plain_delta_is_the_sum_of_p_dp(causal, segments, d):
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(0, d=d))
    seg = None
    if segments:
        seg = torch.ones(1, 256, dtype=torch.int32)
        seg[:, 100:] = 2
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                          q_segment_ids=seg,
                                          kv_segment_ids=seg)
    got = fa.flash_delta_reference(q, k, v, lse, do, causal=causal,
                                   q_segment_ids=seg, kv_segment_ids=seg)
    # f64 from the same bf16 values and the same lse.
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.expand(-1, -1, 2, -1)) \
        * d ** -0.5
    allow = torch.ones(256, 256, dtype=torch.bool)
    if causal:
        allow = torch.tril(allow)
    if seg is not None:
        allow = allow & (seg[0][:, None] == seg[0][None, :])
    p = torch.exp(s - lse.double()[..., None]).masked_fill(~allow, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd.expand(-1, -1, 2, -1))
    want = (p * dp).sum(-1)
    assert got.shape == (1, 2, 256) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
    # rowsum(dO · O) of the bf16 output is not it.
    pallas = (do.float() * o.float()).sum(-1).transpose(1, 2)
    assert float((pallas - got).abs().max()) > 1e-4


def _dq(q, k, v, do, delta=None):
    o, lse = fa.flash_attention_reference(q, k, v)
    return fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            delta=delta)[0]


@pytest.mark.parametrize("shared,spread,worse", [(3.0, 1.0, 4.0),
                                                 (3.0, 0.3, 4.0),
                                                 (0.0, 1.0, None)])
def test_bf16_dq_with_the_sum_of_p_dp_tracks_f64(shared, spread, worse):
    """Keys and values with a large shared part: the bf16 flash backward's
    dQ with the port's delta is as close to f64 as the einsum path's bf16
    autograd (1.25x + 2^-10, F_bf16's rule), and with the JAX wrapper's
    rowsum(dO · O) more than ``worse`` times further (read: 16-21x);
    without a shared part the rule holds as well."""
    q, k, v, do = _inputs(1, shared=shared, spread=spread)
    qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
    t_attn.dot_product_attention(qd, kd, vd).backward(do.double())
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    qe = qb.clone().requires_grad_()
    t_attn.dot_product_attention(qe, kb, vb).backward(dob)

    def rel(x):
        return float((x.double() - qd.grad).norm() / qd.grad.norm())

    port = rel(_dq(qb, kb, vb, dob))
    o, _ = fa.flash_attention_reference(qb, kb, vb)
    rowsum = (dob.float() * o.float()).sum(-1).transpose(1, 2)
    jax_like = rel(_dq(qb, kb, vb, dob, delta=rowsum))
    einsum = rel(qe.grad)
    assert port <= 1.25 * einsum + 2 ** -10, (port, einsum)
    if worse is not None:
        assert jax_like > worse * einsum, (jax_like, einsum)


def test_cpu_backward_takes_the_new_delta_in_bf16_only():
    q, k, v, do = _inputs(2)
    for dtype in (torch.bfloat16, torch.float32):
        qq, kk, vv, dd = (x.to(dtype) for x in (q, k, v, do))
        o, lse = fa.flash_attention_reference(qq, kk, vv, causal=True)
        got = fa.flash_backward(qq, kk, vv, o, lse, dd, None, None, True,
                                64 ** -0.5)
        if dtype == torch.bfloat16:
            delta = fa.flash_delta_reference(qq, kk, vv, lse, dd,
                                             causal=True)
        else:
            delta = (dd * o).sum(-1).transpose(1, 2)
        want = fa.flash_attention_bwd_reference(
            qq, kk, vv, o, lse, dd, causal=True, delta=delta)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _counts():
    w = fa.flash_bwd_delta
    return w.launches, w.launches_wgmma, w.launches_small


def test_delta_wrapper_refuses_and_counts_nothing_on_cpu():
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(3))
    _, lse = fa.flash_attention_reference(q, k, v)
    before = _counts()
    with pytest.raises(ValueError, match="device"):
        fa.flash_bwd_delta(q, k, v, do, lse, None, None, False, 0.125)
    assert _counts() == before


@pytest.mark.parametrize("d,route", [(16, "small"), (32, "small"),
                                     (64, "wgmma"), (128, "wgmma")])
def test_delta_route_by_head_dim(d, route):
    assert fa._delta_route(d) == route


@pytest.mark.parametrize("d", [16, 32])
def test_delta_wgmma_route_refuses_small_head_dims(d):
    """A wgmma route forced at head_dim 16 or 32 raises before any launch,
    whatever the device, as the other wrappers' forced routes do."""
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(4, d=d))
    _, lse = fa.flash_attention_reference(q, k, v)
    before = _counts()
    with pytest.raises(TypeError, match="wgmma"):
        fa.flash_bwd_delta(q, k, v, do, lse, None, None, False, d ** -0.5,
                           route="wgmma")
    with pytest.raises(ValueError, match="route"):
        fa.flash_bwd_delta(q, k, v, do, lse, None, None, False, d ** -0.5,
                           route="mma")
    assert _counts() == before


@pytest.mark.parametrize("route", [None, "wgmma", "small"])
def test_delta_wrapper_refuses_f32(route):
    q, k, v, do = _inputs(5)
    _, lse = fa.flash_attention_reference(q, k, v)
    before = _counts()
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_bwd_delta(q, k, v, do, lse, None, None, False, 0.125,
                           route=route)
    assert _counts() == before
