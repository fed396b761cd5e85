"""PyTorch port, the f32 flash-attention backward on the tensor cores
(``csrc/flash_bwd_f32.cu``, the ``"tf32x3"`` route) on the CPU, where the
kernels cannot run.

- A torch model of the two kernels' arithmetic, written here: the dQ kernel
  walks 32-key tiles in order; the dK/dV kernel walks 64-row tiles of
  flattened (position, group head) query rows, each in two 32-row halves
  whose sums meet at the end (first half + second half). Every product is
  the three-pass TF32 split: each operand is rounded to TF32 as
  ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero: ``(bits +
  0x1000) & ~0x1FFF`` on the int32 view), ``hi = rna(x)``, ``lo = rna(x -
  hi)``, and a product is ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` summed in
  f32; P = exp(s * scale - lse), 0 where masked; dS = P (dP - delta)
  scale, all f32. It is held against the Pallas backward
  (``pallas_flash._bwd``) in interpret mode on the same f32 inputs and
  forward residuals, and against the port's plain version, at phase D's
  f32 limit (``chip_smoke.py`` ``FLASH_TOL[torch.float32]``): per element
  1e-4 x max(RMS of its row, RMS of the output) + 1e-4 x |reference|.
  The split leaves ~2^-22 of each product out, the sums run in another
  order: both far inside that limit. Cases: head_dim 16, 32, 64 and 128,
  groups 1, 3 and 4, causal and not, sq < sk, segment ids with rows that
  see no key (exactly 0), lengths of 48, 80, 96, 112 and 160 that cut the
  32-key, 64-row and 128-row tiles.
- The same model with one TF32 pass (``a_hi.b_hi`` alone) exceeds that
  limit: the test can tell the split from its absence.

The kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k tf32x3``) and in ``chip_smoke.py``
phase D.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_tpu.ops import pallas_flash as pf

torch.set_num_threads(2)

KT = 32                           # keys a K/V tile of the dQ kernel
QT = 64                           # flattened rows a Q/dO tile (dK/dV)
F32_TOL = (1e-4, 1e-4)            # chip_smoke.py FLASH_TOL[torch.float32]


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32``: the low 13 bits of the
    f32 pattern rounded off, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes):
    """a @ b as the kernels compute it: three TF32 passes (the split), or
    one (``a_hi.b_hi``)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _flat(x, hkv):
    """[B, S, H, D] -> [B, Hkv, S * group, D]: row i * group + t is position
    i of head hkv * group + t, the kernels' flattened row."""
    b, s, h, d = x.shape
    return x.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, s * (h // hkv), d)


def _flat_stat(x, hkv):
    """[B, H, S] -> [B, Hkv, S * group], rows as in :func:`_flat`."""
    b, h, s = x.shape
    return x.reshape(b, hkv, h // hkv, s).transpose(2, 3).reshape(
        b, hkv, s * (h // hkv))


def kernel_model(q, k, v, do, lse, delta, *, causal, scale, segq=None,
                 segk=None, passes=3):
    """The two kernels' arithmetic in torch (see the module docstring).
    q, k, v, do f32 ``[B, S, H, D]``; lse, delta f32 ``[B, H, sq]``.
    Returns dq, dk, dv in f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = sq * g
    qf, dof = _flat(q, hkv), _flat(do, hkv)
    kf, vf = k.transpose(1, 2), v.transpose(1, 2)
    ls, dl = _flat_stat(lse, hkv), _flat_stat(delta, hkv)
    pos = torch.arange(rows) // g
    allow = torch.ones(b, rows, sk, dtype=torch.bool)
    if causal:
        allow &= (pos[:, None] + (sk - sq) >= torch.arange(sk)[None])[None]
    if segq is not None:
        allow &= segq[:, pos][:, :, None] == segk[:, None, :]
    allow = allow[:, None]                           # [B, 1, rows, sk]

    def p_ds(s, ok, lse_, dl_, dp):
        p = torch.where(ok, torch.exp(s * scale - lse_), 0.0)
        return p, p * (dp - dl_) * scale

    dq = torch.zeros(b, hkv, rows, d)
    for c0 in range(0, sk, KT):                      # the dQ kernel
        kt, vt = kf[:, :, c0:c0 + KT], vf[:, :, c0:c0 + KT]
        _, ds = p_ds(product(qf, kt.transpose(-1, -2), passes),
                     allow[..., c0:c0 + KT], ls[..., None], dl[..., None],
                     product(dof, vt.transpose(-1, -2), passes))
        dq = dq + product(ds, kt, passes)
    halves = [[torch.zeros(b, hkv, sk, d) for _ in range(2)]
              for _ in range(2)]                     # [half][dk, dv]
    for r0 in range(0, rows, QT):                    # the dK/dV kernel
        for half in range(2):
            lo, hi = r0 + 32 * half, min(r0 + 32 * half + 32, rows)
            if lo >= hi:
                continue
            qt, dot = qf[:, :, lo:hi], dof[:, :, lo:hi]
            pt, dst = p_ds(product(kf, qt.transpose(-1, -2), passes),
                           allow[:, :, lo:hi].transpose(-1, -2),
                           ls[:, :, None, lo:hi], dl[:, :, None, lo:hi],
                           product(vf, dot.transpose(-1, -2), passes))
            dk_h, dv_h = halves[half]
            halves[half] = [dk_h + product(dst, qt, passes),
                            dv_h + product(pt, dot, passes)]
    dk = halves[0][0] + halves[1][0]
    dv = halves[0][1] + halves[1][1]
    dq = dq.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, d)
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


def _share(got, want, tol):
    """The largest share of the limit atol x max(RMS of its head_dim row,
    RMS of the output) + rtol x |want| that |got - want| uses
    (chip_smoke.py ``_flash_err``)."""
    atol, rtol = tol
    err = (got - want).abs()
    scale = want.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(want.square().mean().sqrt()))
    return float((err / (atol * scale + rtol * want.abs())).max())


# (b, sq, sk, h, hkv, head_dim, causal, segments)
SHAPES = [
    (2, 64, 64, 4, 4, 16, True, False),
    (1, 96, 96, 12, 4, 32, True, False),
    (1, 48, 160, 8, 2, 64, True, False),
    (1, 112, 112, 8, 2, 128, False, False),
    (2, 80, 80, 6, 2, 64, True, True),
    (1, 96, 96, 3, 3, 128, True, True),
    (1, 48, 48, 4, 1, 16, False, True),
    (1, 32, 80, 9, 3, 32, False, False),
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
        segq[0, 5:9] = 7                 # rows that see no key
    return q, k, v, do, segq, segk


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _case(shape):
    """The Pallas backward (interpret mode) on seeded f32 inputs, and what
    the model and the plain version need: (model kwargs, Pallas dq/dk/dv,
    plain dq/dk/dv)."""
    q, k, v, do, segq, segk = _inputs(shape, 11 + sum(shape[:6]))
    causal, d = shape[6], shape[5]
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = pf._fwd(jq, jk, jv, _j(segq), _j(segk), causal=causal,
                     scale=scale, interpret=True)
    want = [_t(x) for x in pf._bwd(
        causal, scale, True, (jq, jk, jv, _j(segq), _j(segk), o, lse),
        jdo)[:3]]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to = _t(o)
    tlse = _t(lse).reshape(shape[0], shape[3], shape[1])
    delta = (tdo * to).sum(-1).transpose(1, 2).contiguous()
    plain = fa.flash_attention_bwd_reference(
        tq, tk, tv, to, tlse, tdo, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    kw = dict(q=tq, k=tk, v=tv, do=tdo, lse=tlse, delta=delta,
              causal=causal, scale=scale, segq=_t(segq), segk=_t(segk))
    return kw, want, plain


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_matches_pallas_backward(shape):
    """The three-pass model against the Pallas backward in interpret mode
    and the port's plain version, within phase D's f32 limit."""
    kw, want, plain = _case(shape)
    got = kernel_model(**kw)
    for name, mine, ref, ref_plain in zip(("dq", "dk", "dv"), got, want,
                                          plain):
        assert mine.shape == ref.shape and mine.dtype == torch.float32
        assert torch.isfinite(mine).all(), name
        for what, r in (("Pallas", ref), ("the plain version", ref_plain)):
            share = _share(mine, r, F32_TOL)
            assert share <= 1.0, (
                f"{name} vs {what}: |model - reference| reaches {share} of "
                f"the limit {F32_TOL[0]} x max(rms(row), rms) + "
                f"{F32_TOL[1]} x |reference|")
    if kw["segq"] is not None:           # rows that see no key: exactly 0
        assert torch.all(got[0][0, 5:9] == 0)


def test_one_tf32_pass_exceeds_the_f32_limit():
    """One TF32 pass moves the gradients past phase D's f32 limit (as the
    kernels' header note says), so the test above tells the split from
    its absence: hd 64 and 128, causal."""
    shares = []
    for shape in (SHAPES[2], SHAPES[5]):
        kw, want, _ = _case(shape)
        three = kernel_model(**kw)
        one = kernel_model(**kw, passes=1)
        assert max(_share(m, r, F32_TOL) for m, r in zip(three, want)) <= 1
        shares.append(max(_share(m, r, F32_TOL) for m, r in zip(one, want)))
    assert max(shares) > 1.0, shares


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated cvt.rna: 13 low bits cleared, halfway cases rounded
    away from zero, hi + lo within 2^-22 of x."""
    one = 1.0 + 2.0 ** -11                 # halfway between TF32 neighbours
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.14159265, -2.5e-3])
    hi = tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert hi[0] == 1.0 + 2.0 ** -10 and hi[1] == -(1.0 + 2.0 ** -10)
    assert hi[2] == 1.0
    lo = tf32(x - hi)
    assert torch.all((x - hi - lo).abs() <= x.abs() * 2.0 ** -21)


def test_cpu_f32_backward_takes_the_plain_version_and_counts_no_launch():
    q, k, v, do, _, _ = _inputs((1, 64, 64, 4, 2, 32, True, False), 3)
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_tf32x3,
              fa.flash_bwd_dkv.launches, fa.flash_bwd_dkv.launches_tf32x3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=True)
    o.backward(torch.from_numpy(do))
    want = fa.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), o.detach(),
        fa.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(),
                                     causal=True)[1],
        torch.from_numpy(do), causal=True)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, ref)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_tf32x3,
            fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dkv.launches_tf32x3) == counts


def test_tf32x3_route_refuses_cpu_tensors():
    """A named tf32x3 route on CPU tensors raises: no plain fallback."""
    q, k, v, do, _, _ = _inputs((1, 16, 16, 2, 2, 64, True, False), 1)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    stat = torch.zeros(1, 2, 16)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="device cpu"):
            fn(tq, tk, tv, tdo, stat, stat, None, None, True, 0.125,
               route="tf32x3")
