"""PyTorch port, the f32 flash-attention forward on the tensor cores
(``csrc/flash_fwd_f32.cu`` ``flash_fwd_tf32x3``, the ``"tf32x3"`` route) on
the CPU, where the kernel cannot run.

- The route rule: ``_fwd_route`` sends float32 at every head dim (16, 32,
  64, 128) to ``"tf32x3"``; a named route on CPU tensors, and the tf32x3
  route with bf16 inputs, refuse; CPU calls take the plain version and
  count no launch.
- A torch model of the kernel's arithmetic, written here: flattened
  (position, group head) query rows walk 32-key tiles in order; every
  product is the three-pass TF32 split, each operand rounded to TF32 as
  ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero: ``(bits +
  0x1000) & ~0x1FFF`` on the int32 view), ``hi = rna(x)``, ``lo = rna(x -
  hi)``, a product ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` in f32. S = Q.K^T,
  -inf where masked; m = max(m, max(s) x scale log2 e); alpha = 2^(m_old
  - m); p = 2^(s x scale log2 e - m) with the product and the difference
  rounded once (the kernel's FFMA; the exponential is ``ex2.approx``,
  about 2 ulp, emulated by ``torch.exp2``); l = alpha l + sum(p); O =
  alpha O + P.V, the tile's P.V summed from zero and taken in with one
  rounding (``add_part``, an FMA); at the end O / max(l, 1e-30) and lse =
  m ln 2 + log(max(l, 1e-30)), -1e30 for a row that sees no key. S takes
  the three passes into one accumulator, as ``csrc/paged_attn_f32.cu``
  does: the model's exact sums cannot show the tensor cores' truncating
  accumulation, and a tile's S chains only D / 8 k-steps; the forward has
  no cancellation like the backward's dP - delta, for which
  ``flash_dq_tf32x3`` keeps the small passes apart.
  The model is held against the Pallas forward (``pallas_flash._fwd``) in
  interpret mode, as ``tests/test_torch_flash_fwd.py`` runs it, and against
  the port's plain version, on the same numpy-seeded f32 inputs, at phase
  D's f32 limits (``chip_smoke.py`` ``FLASH_TOL[torch.float32]`` and
  ``LSE_ATOL``): per element 1e-4 x max(RMS of its row, RMS of the output)
  + 1e-4 x |reference|, lse within 1e-3. The split leaves ~2^-22 of each
  product out and the sums run in another order: both far inside that
  limit. Cases: head_dim 16, 32, 64 and 128, groups 1, 2 and 4, causal and
  not, sq < sk, sq > sk (leading rows see no key), segment ids with rows
  that see no key, lengths of 77, 80, 100, 112, 136 and 200 that cut the
  32-key and 128-row tiles. A row that sees no key gives O exactly 0 and
  the plain version's lse.
- The same model with one TF32 pass (``a_hi.b_hi`` alone) exceeds that
  limit: the test can tell the split from its absence.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k flash_fwd_tf32x3``) and in
``chip_smoke.py`` phases D, F, I and Q.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_tpu.ops import pallas_flash as pf

torch.set_num_threads(2)

KT = 32                           # keys a K/V tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
F32_TOL = (1e-4, 1e-4)            # chip_smoke.py FLASH_TOL[torch.float32]
LSE_ATOL = 1e-3                   # chip_smoke.py LSE_ATOL


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_f32_takes_the_tf32x3_forward(head_dim):
    assert fa._fwd_route(torch.float32, head_dim) == "tf32x3"


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32``: the low 13 bits of the
    f32 pattern rounded off, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes):
    """a @ b as the kernel computes it: three TF32 passes (the split), or
    one (``a_hi.b_hi``)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _fma(a, b, c):
    """a x b + c rounded once to f32, as FFMA does (the f64 product of two
    f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _flat(x, hkv):
    """[B, S, H, D] -> [B, Hkv, S * group, D]: row i * group + t is position
    i of head hkv * group + t, the kernel's flattened row."""
    b, s, h, d = x.shape
    return x.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, s * (h // hkv), d)


def _allow(b, sq, sk, g, causal, segq, segk):
    """[B, 1, rows, sk]: flattened row r sees key j."""
    pos = torch.arange(sq * g) // g
    allow = torch.ones(b, sq * g, sk, dtype=torch.bool)
    if causal:
        allow &= (pos[:, None] + (sk - sq) >= torch.arange(sk)[None])[None]
    if segq is not None:
        allow &= segq[:, pos][:, :, None] == segk[:, None, :]
    return allow[:, None]


def fwd_model(q, k, v, *, causal, scale, segq=None, segk=None, passes=3):
    """``flash_fwd_tf32x3``'s arithmetic (see the module docstring). q, k,
    v f32 ``[B, S, H, D]``. Returns o ``[B, sq, H, D]`` and lse
    ``[B, H, sq]``, f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = _flat(q, hkv)
    kf, vf = k.transpose(1, 2), v.transpose(1, 2)
    allow = _allow(b, sq, sk, g, causal, segq, segk)
    sl = torch.tensor(np.float32(scale * LOG2E))
    m = torch.full((b, hkv, sq * g, 1), NEG_INF)
    l = torch.zeros(b, hkv, sq * g, 1)
    acc = torch.zeros(b, hkv, sq * g, d)
    for c0 in range(0, sk, KT):
        kt, vt = kf[:, :, c0:c0 + KT], vf[:, :, c0:c0 + KT]
        s = torch.where(allow[..., c0:c0 + KT],
                        product(qf, kt.transpose(-1, -2), passes),
                        -torch.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * sl)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(_fma(s, sl, -mn))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = _fma(acc, alpha, product(p, vt, passes))
        m = mn
    norm = l.clamp_min(1e-30)
    o = (acc / norm).reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4)
    m_nat = torch.where(m <= NEG_INF / 2, torch.tensor(NEG_INF), m * LN2)
    lse = (m_nat + torch.log(norm))[..., 0]          # [B, Hkv, rows]
    lse = lse.reshape(b, hkv, sq, g).permute(0, 1, 3, 2).reshape(b, h, sq)
    return o.reshape(b, sq, h, d), lse


def _share(got, want, tol):
    """The largest share of the limit atol x max(RMS of its head_dim row,
    RMS of the output) + rtol x |want| that |got - want| uses
    (chip_smoke.py ``_flash_err``)."""
    atol, rtol = tol
    err = (got - want).abs()
    scale = want.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(want.square().mean().sqrt()))
    return float((err / (atol * scale + rtol * want.abs())).max())


def _lse_close(got, want, what):
    """lse within LSE_ATOL where the reference row sees a key; rows that
    see none both at or below -1e29 (chip_smoke.py phase D)."""
    seen = want > -1e29
    assert torch.equal(got <= -1e29, ~seen), what
    if seen.any():
        err = float((got[seen] - want[seen]).abs().max())
        assert err <= LSE_ATOL, f"{what}: lse error {err} > {LSE_ATOL}"


# (b, sq, sk, h, hkv, head_dim, causal, segments)
SHAPES = [
    (2, 64, 64, 4, 4, 16, True, False),
    (1, 80, 200, 8, 2, 64, True, False),
    (1, 200, 136, 8, 4, 128, True, False),
    (2, 80, 80, 6, 3, 64, True, True),
    (1, 112, 112, 8, 2, 128, False, False),
    (1, 77, 77, 4, 1, 16, False, True),
    (1, 136, 136, 4, 2, 32, True, True),
    (1, 100, 100, 4, 2, 128, True, True),
]


def _inputs(shape, seed):
    b, sq, sk, h, hkv, d, _, seg = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    segq = segk = None
    if seg:
        segk = np.sort(rng.integers(0, 3, (b, sk)), axis=1).astype(np.int32)
        segq = segk[:, sk - sq:].copy()
        segq[0, 5:9] = 7                 # rows that see no key
    return q, k, v, segq, segk


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _case(shape):
    """The Pallas forward (interpret mode) and the plain version on seeded
    f32 inputs: (model kwargs, Pallas (o, lse), plain (o, lse))."""
    q, k, v, segq, segk = _inputs(shape, 13 + sum(shape[:6]))
    b, sq, _, h, _, d, causal, _ = shape
    scale = d ** -0.5
    o, lse = pf._fwd(*(jnp.asarray(x) for x in (q, k, v)), _j(segq),
                     _j(segk), causal=causal, scale=scale, interpret=True)
    want = (_t(o), _t(lse).reshape(b, h, sq))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = fa.flash_attention_reference(
        tq, tk, tv, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    kw = dict(q=tq, k=tk, v=tv, causal=causal, scale=scale, segq=_t(segq),
              segk=_t(segk))
    return kw, want, plain


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fwd_model_matches_pallas_forward(shape):
    """The three-pass model against the Pallas forward in interpret mode
    and the port's plain version, within phase D's f32 limits; rows that
    see no key give O = 0 and the plain lse exactly."""
    kw, want, plain = _case(shape)
    o, lse = fwd_model(**kw)
    assert o.shape == want[0].shape and o.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    for what, (ref_o, ref_lse) in (("Pallas", want),
                                   ("the plain version", plain)):
        share = _share(o, ref_o, F32_TOL)
        assert share <= 1.0, (
            f"o vs {what}: |model - reference| reaches {share} of the limit "
            f"{F32_TOL[0]} x max(rms(row), rms) + {F32_TOL[1]} x "
            f"|reference|")
        _lse_close(lse, ref_lse, f"lse vs {what}")
    blind = plain[1] <= -1e29
    if shape[6] and shape[1] > shape[2] or shape[7]:
        assert blind.any()
    assert torch.equal(lse[blind], plain[1][blind])
    assert torch.all(o[blind.transpose(1, 2)] == 0)


def test_one_tf32_pass_exceeds_the_f32_limit():
    """One TF32 pass moves O past phase D's f32 limit (as the kernel's
    header note says), so the test above tells the split from its
    absence: head_dim 64 and 128, causal."""
    shares = []
    for shape in (SHAPES[1], SHAPES[2]):
        kw, want, _ = _case(shape)
        three = fwd_model(**kw)[0]
        one = fwd_model(**kw, passes=1)[0]
        assert _share(three, want[0], F32_TOL) <= 1.0
        shares.append(_share(one, want[0], F32_TOL))
    assert max(shares) > 1.0, shares


def test_cpu_f32_forward_takes_the_plain_version_and_counts_no_launch():
    q, k, v, _, _ = _inputs((1, 64, 64, 4, 2, 32, True, False), 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = (fa.flash_fwd.launches, fa.flash_fwd.launches_tf32x3)
    got = fa.flash_fwd(tq, tk, tv, None, None, True, 32 ** -0.5)
    want = fa.flash_attention_reference(tq, tk, tv, causal=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(fa.flash_attention(tq, tk, tv, causal=True), want[0])
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_tf32x3) == before


def test_tf32x3_forward_refuses_cpu_tensors_and_bf16():
    """A named tf32x3 route on CPU tensors raises, in f32 and in bf16: no
    plain fallback."""
    q, k, v, _, _ = _inputs((1, 16, 16, 2, 2, 64, True, False), 1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = (fa.flash_fwd.launches, fa.flash_fwd.launches_tf32x3)
    with pytest.raises(ValueError, match="device cpu"):
        fa.flash_fwd(tq, tk, tv, None, None, True, 0.125, route="tf32x3")
    with pytest.raises(ValueError, match="device cpu"):
        fa.flash_fwd(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), None,
                     None, True, 0.125, route="tf32x3")
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_tf32x3) == before
