"""PyTorch port, grouped matmul (``ops/gmm.py``) against the JAX package's
``ops/pallas_gmm.py``: the grouped layout, the forward product and both
gradients through the port's autograd against ``jax.grad`` through the
Pallas ``custom_vjp``, which runs in interpret mode on the CPU, as
``tests/test_pallas_gmm.py`` runs it. On CPU tensors the port's wrappers
take their plain versions.

Inputs come from numpy with a seed; padding rows of ``lhs`` are zero (the
MoE layer's contract). Tolerances, f32 on both sides: 1e-5 relative and
absolute (the same products, summed in different orders; observed ~1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import transformer as t_tr
from k8s_distributed_deeplearning_torch.ops import gmm as t_gmm
from k8s_distributed_deeplearning_tpu.ops import pallas_gmm as j_gmm

TOL = dict(rtol=1e-5, atol=1e-5)

torch.set_num_threads(2)

# (group sizes, total rows, block_m): the JAX kernel tests' cases (spans,
# an empty group, everything in one expert, even groups), then tail blocks
# and several empty groups at the MoE tests' block of 8.
LAYOUT_CASES = [
    ([100, 0, 300, 57], 512, 128),
    ([0, 0, 0, 512], 512, 128),
    ([0, 256, 0, 0], 256, 128),
    ([128, 128, 128, 128], 512, 128),
    ([3, 5, 0, 9], 17, 8),
    ([0, 0, 40, 0], 40, 8),
    ([7, 1, 16, 8], 32, 8),
]


@pytest.mark.parametrize("sizes,total,bm", LAYOUT_CASES,
                         ids=lambda c: str(c))
def test_layout_matches_jax(sizes, total, bm):
    want = j_gmm.grouped_layout(jnp.asarray(sizes, jnp.int32), total,
                                block_m=bm)
    got = t_gmm.grouped_layout(torch.tensor(sizes, dtype=torch.int32), total,
                               block_m=bm)
    assert (got.m_pad, got.block_m) == (want.m_pad, want.block_m)
    for name in ("row_offset", "block_expert", "block_live", "block_first"):
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want,
                                                                    name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.group_sizes.numpy(), sizes)
    live = t_gmm.live_rows(got).numpy()
    assert live.sum() == sum(sizes)
    off = got.row_offset.numpy()
    for e, s in enumerate(sizes):
        assert live[off[e]:off[e] + s].all()


def _case(seed, sizes, k, n, bm, e=None):
    """A layout, lhs with zero padding rows, rhs [E, K, N] and a cotangent,
    as numpy f32 arrays."""
    rng = np.random.default_rng(seed)
    e = e or len(sizes)
    total = int(sum(sizes))
    lay = t_gmm.grouped_layout(torch.tensor(sizes, dtype=torch.int32), total,
                               block_m=bm)
    lhs = np.zeros((lay.m_pad, k), np.float32)
    off = lay.row_offset.numpy()
    for i, s in enumerate(sizes):
        lhs[off[i]:off[i] + s] = rng.standard_normal((s, k))
    rhs = rng.standard_normal((e, k, n)).astype(np.float32)
    cot = rng.standard_normal((lay.m_pad, n)).astype(np.float32)
    return lay, lhs, rhs, cot


def _jax_layout(sizes, bm):
    return j_gmm.grouped_layout(jnp.asarray(sizes, jnp.int32),
                                int(sum(sizes)), block_m=bm)


GMM_CASES = [[10, 0, 30, 6], [0, 0, 0, 40], [8, 8, 8, 8], [1, 2, 0, 13]]


@pytest.mark.parametrize("sizes", GMM_CASES, ids=str)
def test_gmm_forward_matches_pallas(sizes):
    lay, lhs, rhs, _ = _case(0, sizes, 32, 48, 8)
    want = np.asarray(j_gmm.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                                _jax_layout(sizes, 8), interpret=True))
    got = t_gmm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), lay)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Rows that hold no token come out exactly 0.
    dead = ~t_gmm.live_rows(lay).numpy()
    assert np.all(got.numpy()[dead] == 0.0)


@pytest.mark.parametrize("sizes", [[5, 0, 13, 6], [0, 21, 3, 0]], ids=str)
def test_gmm_gradients_match_pallas_custom_vjp(sizes):
    """dlhs and drhs through the port's autograd (gmm with rhs read
    transposed, then tgmm) against jax.grad through the Pallas custom_vjp,
    with an empty expert and partially live blocks."""
    lay, lhs, rhs, cot = _case(1, sizes, 24, 40, 8)
    jlay = _jax_layout(sizes, 8)

    def jloss(l, r):
        return jnp.sum(j_gmm.gmm(l, r, jlay, interpret=True) * cot)

    jdl, jdr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lhs),
                                              jnp.asarray(rhs))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    (t_gmm.gmm(tl, tr, lay) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jdl), **TOL)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jdr), **TOL)
    # An expert with no rows gets a zero weight gradient.
    for e, s in enumerate(sizes):
        if s == 0:
            assert np.all(tr.grad.numpy()[e] == 0.0)


def test_dead_blocks_are_neither_read_nor_written():
    """The Pallas kernels' block semantics: tgmm sums over the rows of each
    expert's live blocks (numpy definition) and gmm writes 0 over a dead
    block, whatever a dead block holds; rows of live blocks count as they
    are."""
    sizes = [9, 0, 17, 2]
    lay, lhs, rhs, cot = _case(2, sizes, 16, 24, 8)
    live_block = np.repeat(lay.block_live.numpy(), 8).astype(bool)
    lhs = lhs + (~live_block)[:, None] * 5.0
    got = t_gmm.tgmm(torch.from_numpy(lhs), torch.from_numpy(cot), 4, lay)
    off = lay.row_offset.numpy()
    spans = [-(-s // 8) * 8 for s in sizes]
    want = np.stack([lhs[o:o + n].T @ cot[o:o + n]
                     for o, n in zip(off, spans)])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    out = t_gmm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), lay)
    assert np.all(out.numpy()[~live_block] == 0.0)


def test_transposed_weight_read_equals_the_transpose():
    """The backward's rhsᵀ read in place gives the product with the
    materialized transpose, bit for bit in the plain version."""
    sizes = [4, 11, 0, 9]
    lay, lhs, rhs, _ = _case(3, sizes, 32, 16, 8)
    r = torch.from_numpy(rhs)                      # [E, K=32, N=16]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (lay.m_pad, 16)).astype(np.float32))
    a = t_gmm.gmm_forward(g, r, lay, transpose_rhs=True)
    b = t_gmm.gmm_forward(g, r.transpose(1, 2).contiguous(), lay)
    assert a.shape == (lay.m_pad, 32)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bf16_rounds_once_from_f32():
    """bf16 operands: the product is summed in f32 and rounded to bf16 once
    (the Pallas preferred_element_type=f32 then astype); gradients come out
    in the primal dtypes."""
    sizes = [6, 3, 0, 15]
    lay, lhs, rhs, cot = _case(5, sizes, 32, 24, 8)
    lb = torch.from_numpy(lhs).bfloat16().requires_grad_()
    rb = torch.from_numpy(rhs).bfloat16().requires_grad_()
    out = t_gmm.gmm(lb, rb, lay)
    assert out.dtype == torch.bfloat16
    want = t_gmm.gmm_reference(lb.detach().float(), rb.detach().float(), lay)
    torch.testing.assert_close(out, want.bfloat16(), atol=0, rtol=0)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert lb.grad.dtype == rb.grad.dtype == torch.bfloat16


def test_cpu_calls_launch_no_kernel_and_other_devices_raise():
    sizes = [3, 4, 0, 1]
    lay, lhs, rhs, cot = _case(6, sizes, 8, 8, 8)
    before = (t_gmm.gmm_forward.launches, t_gmm.tgmm.launches)
    t_gmm.gmm_forward(torch.from_numpy(lhs), torch.from_numpy(rhs), lay)
    t_gmm.tgmm(torch.from_numpy(lhs), torch.from_numpy(cot), 4, lay)
    assert (t_gmm.gmm_forward.launches, t_gmm.tgmm.launches) == before
    meta = torch.empty(lay.m_pad, 8, device="meta")
    with pytest.raises(ValueError, match="no grouped matmul"):
        t_gmm.gmm_forward(meta, torch.empty(4, 8, 8, device="meta"), lay)
    with pytest.raises(ValueError, match="contract"):
        t_gmm.gmm_forward(torch.zeros(lay.m_pad, 16), torch.from_numpy(rhs),
                          lay)


def test_remat_policies_save_the_gmm_operator():
    """"dots" and "dots_attn" save the grouped matmul's output, as JAX's
    policies save the outputs tagged "gmm_out"; "nothing" saves nothing."""
    op = torch.ops.k8s_ddl_torch.gmm.default
    assert op in t_tr.REMAT_POLICIES["dots"]
    assert op in t_tr.REMAT_POLICIES["dots_attn"]
    assert op not in t_tr.REMAT_POLICIES["nothing"]


def test_gmm_route_rule():
    """bf16 takes the wgmma kernels (csrc/gmm_wgmma.cu), f32 the mma.sync
    and CUDA-core kernels (csrc/gmm.cu): by dtype alone."""
    assert t_gmm._gmm_route(torch.bfloat16) == "wgmma"
    assert t_gmm._gmm_route(torch.float32) == "mma"


def _counts():
    return (t_gmm.gmm_forward.launches, t_gmm.gmm_forward.launches_wgmma,
            t_gmm.tgmm.launches, t_gmm.tgmm.launches_wgmma)


@pytest.mark.parametrize("fn", ["gmm", "tgmm"])
@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_named_route_on_cpu_tensors_raises(fn, route):
    """A named route asks for a kernel; CPU tensors have none, so it raises
    rather than take the plain version, and counts nothing."""
    lay, lhs, rhs, cot = _case(7, [5, 0, 9], 16, 24, 8)
    lhs_t = torch.from_numpy(lhs).bfloat16()
    before = _counts()
    with pytest.raises(ValueError, match="no grouped matmul kernel"):
        if fn == "gmm":
            t_gmm.gmm_forward(lhs_t, torch.from_numpy(rhs).bfloat16(), lay,
                              route=route)
        else:
            t_gmm.tgmm(lhs_t, torch.from_numpy(cot).bfloat16(), 3, lay,
                       route=route)
    assert _counts() == before


def test_cpu_calls_count_no_launch_on_either_route():
    """bf16 and f32 calls on CPU tensors, forward, dlhs, tgmm and autograd,
    leave launches and launches_wgmma as they were."""
    sizes = [4, 0, 7, 1]
    lay, lhs, rhs, cot = _case(8, sizes, 16, 24, 8)
    before = _counts()
    for dtype in (torch.bfloat16, torch.float32):
        l = torch.from_numpy(lhs).to(dtype).requires_grad_()
        r = torch.from_numpy(rhs).to(dtype).requires_grad_()
        g = torch.from_numpy(cot).to(dtype)
        t_gmm.gmm_forward(g, r.detach(), lay, transpose_rhs=True)
        t_gmm.tgmm(l.detach(), g, 4, lay)
        (t_gmm.gmm(l, r, lay).float() * g.float()).sum().backward()
    assert _counts() == before


# A ragged, skewed layout at widths that cut the wgmma kernels' 64-deep
# stage and 128-wide tile (K 136, N 200), at the kernels' block_m of 128:
# 600 rows, an empty expert, a one-row expert and one with 40 % of them.
SKEWED_SIZES, SKEWED_K, SKEWED_N = [240, 0, 1, 200, 159], 136, 200
# bf16, per element: |port - Pallas| <= 2^-10 x RMS + 2^-7 x |Pallas|
# (phase G's GMM_TOL): both sum exact products of the bf16 operands in
# f32, in different orders, and round once to bf16, so sums on either side
# of a rounding boundary land one bf16 step (<= 2^-7 of the value) apart.
BF16_TOL = (2 ** -10, 2 ** -7)


def _bf16_close(got, want, what):
    ref = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - ref)
    limit = BF16_TOL[0] * np.sqrt(np.mean(ref ** 2)) + BF16_TOL[1] * np.abs(
        ref)
    assert np.all(err <= limit), (what, float((err / limit).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_on_a_skewed_layout(dtype):
    """The forward, dlhs and drhs that the wgmma kernels are held to on the
    card (the plain versions, through the port's autograd) against the
    Pallas kernels in interpret mode through their custom_vjp: f32 to
    1e-5, bf16 within phase G's bf16 limit; rows that hold no token, dead
    blocks of dlhs and the empty expert's gradient exactly 0."""
    lay, lhs, rhs, cot = _case(9, SKEWED_SIZES, SKEWED_K, SKEWED_N,
                               t_gmm.KERNEL_BLOCK_M)
    jlay = _jax_layout(SKEWED_SIZES, t_gmm.KERNEL_BLOCK_M)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl, jr = jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt)

    def jloss(l, r):
        out = j_gmm.gmm(l, r, jlay, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jdl, jdr) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jl, jr)
    tl = torch.from_numpy(lhs).to(tdt).requires_grad_()
    tr = torch.from_numpy(rhs).to(tdt).requires_grad_()
    out = t_gmm.gmm(tl, tr, lay)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tl.grad.dtype == tr.grad.dtype == tdt
    for what, got, want in (("out", out.detach(), jout),
                            ("dlhs", tl.grad, jdl), ("drhs", tr.grad, jdr)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=what, **TOL)
        else:
            _bf16_close(got, want.astype(jnp.float32), what)
    # Rows that hold no token come out 0 (lhs's padding rows are 0), and
    # dead blocks 0 in dlhs too, whatever the cotangent holds there.
    assert torch.all(out.detach()[~t_gmm.live_rows(lay)] == 0)
    dead_block = ~lay.block_live.bool().repeat_interleave(lay.block_m)
    assert torch.all(tl.grad[dead_block] == 0)
    assert torch.all(tr.grad[1] == 0)
