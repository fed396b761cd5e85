"""PyTorch port, the bf16 flash kernels at head_dim 16 and 32
(``csrc/flash_small.cu``, the ``"small"`` route) on the CPU, where the
kernels cannot run.

- The route rules: ``_fwd_route`` sends bf16 at head_dim 16 and 32 to
  ``flash_fwd_small`` (``"small"``); ``_bwd_route`` sends dQ there to
  ``flash_dq_small`` and dK/dV to ``flash_dkv_small`` (both ``"small"``);
  float32 (``"tf32x3"``) and head_dim 64/128 (``"wgmma"``) keep their own.
  ``_dkv_small_splits`` sizes the dK/dV cluster.
- A torch model of each kernel's arithmetic, written here.
  Forward: flattened (position, group head) query rows walk 128-key tiles
  in order; masked scores are -inf; per tile m = max(m, max(s) x scale x
  log2 e), alpha = 2^(m_old - m), p = 2^(s x scale log2 e - m) with the
  product and the difference rounded once (the kernel's FFMA), l = alpha l
  + sum(p), O = alpha O + bf16(p) . V in f32; at the end O x (1 /
  max(l, 1e-30)) rounded to bf16 and lse = m ln 2 + log(max(l, 1e-30)),
  -1e30 + log(1e-30) (= -1e30) for a row that sees no key.
  dK/dV: 64-key tiles; from the first flattened row that sees a tile's
  first key, 64-row steps split over ``splits`` CTAs in contiguous shares;
  P = 2^(s x scale log2 e - lse x log2 e) (one rounding, lse x log2 e
  rounded first), 0 where masked; dS = bf16(P (dP - delta) scale); each CTA
  sums bf16(P)^T . dO and dS^T . Q over its steps in f32 from zero, and the
  CTAs' partials are added in rank order (the cluster's merge) before the
  one bf16 cast.
  dQ: flattened query rows walk 64-key tiles in order; P = 2^(s x scale
  log2 e - lse x log2 e) as in dK/dV, 0 where masked (-inf scores);
  dS = bf16(P (dP - delta) scale); dQ = sum of dS . K over the tiles in
  f32 from zero, rounded once to bf16.
  Each model is held against the Pallas kernels in interpret mode
  (``pallas_flash._fwd`` and ``pallas_flash._bwd``, run as
  ``tests/test_torch_flash_fwd.py`` runs them) and against the port's
  plain version, on the same bf16 inputs, at head_dim 16 and 32, groups 1,
  2 and 4, causal and not, sq < sk and sq > sk, segment ids with rows that
  see no key and keys no row sees, and lengths that cut the 128-key,
  64-key and 64-row tiles. Tolerance: phase D's bf16 limits
  (``chip_smoke.py`` ``FLASH_TOL`` and ``LSE_ATOL``): per element within
  2^-5 x max(RMS of its row, RMS of the output) + 2^-6 x |reference|,
  lse within 1e-3. Both sides round p, P and dS to bf16 at the same
  points, so they differ by the order of the f32 sums, the last bits of
  the exponential (a bf16 step now and then) and where the running max
  moves, and by the one rounding of each output (2^-7 of the value).
- A row that sees no key: O and dQ exactly 0, lse the plain version's
  -1e30, and nothing in dK/dV from it; a key no row sees: dK = dV = 0
  exactly.
- CPU tensors take the plain version and count no launch on any route; a
  named route on CPU tensors (the forward, dQ and dK/dV), and the small
  route in f32 or at head_dim 64, refuse.

The kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k flash_small``) and in
``chip_smoke.py`` phases D and Q.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_tpu.ops import pallas_flash as pf

torch.set_num_threads(2)

FWD_KT = 128                       # the forward's key tile
DQ_KT = 64                         # dQ's key tile
DKV_KEYS = RT = 64                 # dK/dV's key tile and row step
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
BF16_TOL = (2 ** -5, 2 ** -6)      # chip_smoke.py FLASH_TOL[torch.bfloat16]
LSE_ATOL = 1e-3                    # chip_smoke.py LSE_ATOL


@pytest.mark.parametrize("head_dim", [16, 32])
def test_bf16_small_head_dims_take_the_small_forward(head_dim):
    assert fa._fwd_route(torch.bfloat16, head_dim) == "small"


@pytest.mark.parametrize("head_dim", [16, 32])
def test_bf16_small_head_dims_split_the_backward_by_kernel(head_dim):
    """dK/dV and dQ both on the small kernels of csrc/flash_small.cu."""
    assert fa._bwd_route(torch.bfloat16, head_dim, "dkv") == "small"
    assert fa._bwd_route(torch.bfloat16, head_dim, "dq") == "small"


@pytest.mark.parametrize("dtype,head_dim,fwd,bwd", [
    (torch.float32, 16, "tf32x3", "tf32x3"),
    (torch.float32, 32, "tf32x3", "tf32x3"),
    (torch.bfloat16, 64, "wgmma", "wgmma"),
    (torch.bfloat16, 128, "wgmma", "wgmma")])
def test_other_calls_keep_their_routes(dtype, head_dim, fwd, bwd):
    assert fa._fwd_route(dtype, head_dim) == fwd
    for which in ("dq", "dkv"):
        assert fa._bwd_route(dtype, head_dim, which) == bwd


def test_bwd_route_names_its_kernel():
    with pytest.raises(ValueError, match="which"):
        fa._bwd_route(torch.bfloat16, 16, "dkdv")


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float32, 16), (torch.bfloat16, 64), (torch.bfloat16, 128),
    (torch.float32, 32)])
def test_small_route_refuses_what_its_kernels_do_not_take(dtype, head_dim):
    with pytest.raises(TypeError, match="small route takes bfloat16"):
        fa._check_small(dtype, head_dim)


@pytest.mark.parametrize("args,want", [
    ((8, 2, 1024, 1024, 2, True, 132), 2),   # phase Q's attention
    ((8, 2, 1024, 1024, 2, False, 132), 2),
    ((1, 1, 1024, 1024, 1, True, 132), 8),   # few key tiles: fill the card
    ((2, 2, 64, 64, 2, True, 132), 2),       # two steps: at most two CTAs
    ((64, 8, 4096, 4096, 4, True, 132), 8),  # 256 steps: the cap
    ((16, 8, 2048, 2048, 1, False, 132), 2),
    ((1, 2, 200, 100, 2, True, 132), 4),     # sq > sk: tile 0's rows
])
def test_dkv_small_splits(args, want):
    """About 16 steps a CTA on the heaviest key tile, about two CTAs an SM,
    never more CTAs than that tile has steps, never more than 8."""
    got = fa._dkv_small_splits(*args)
    assert got == want
    assert 1 <= got <= fa.SMALL_MAX_SPLITS


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


def _allow(b, sq, sk, g, causal, segq, segk):
    """[B, 1, rows, sk]: flattened row r sees key j."""
    pos = torch.arange(sq * g) // g
    allow = torch.ones(b, sq * g, sk, dtype=torch.bool)
    if causal:
        allow &= (pos[:, None] + (sk - sq) >= torch.arange(sk)[None])[None]
    if segq is not None:
        allow &= segq[:, pos][:, :, None] == segk[:, None, :]
    return allow[:, None]


def _fma(a, b, c):
    """a x b + c rounded once to f32, as FFMA does (the f64 product of two
    f32 values is exact)."""
    return (a.double() * b + c.double()).float()


def fwd_model(q, k, v, *, causal, scale, segq=None, segk=None):
    """``flash_fwd_small``'s arithmetic (see the module docstring). q, k, v
    bf16 ``[B, S, H, D]``. Returns o bf16 ``[B, sq, H, D]`` and lse f32
    ``[B, H, sq]``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = _flat(q.float(), hkv)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    allow = _allow(b, sq, sk, g, causal, segq, segk)
    sl = float(np.float32(scale * LOG2E))
    m = torch.full((b, hkv, sq * g, 1), NEG_INF)
    l = torch.zeros(b, hkv, sq * g, 1)
    acc = torch.zeros(b, hkv, sq * g, d)
    for c0 in range(0, sk, FWD_KT):
        kt, vt = kf[:, :, c0:c0 + FWD_KT], vf[:, :, c0:c0 + FWD_KT]
        s = torch.where(allow[..., c0:c0 + FWD_KT],
                        qf @ kt.transpose(-1, -2), -torch.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * sl)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(_fma(s, sl, -mn))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p.to(torch.bfloat16).float() @ vt
        m = mn
    norm = l.clamp_min(1e-30)
    o = (acc * (1.0 / norm)).reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4)
    m_nat = torch.where(m <= NEG_INF / 2, torch.tensor(NEG_INF), m * LN2)
    lse = (m_nat + torch.log(norm))[..., 0]          # [B, Hkv, rows]
    lse = lse.reshape(b, hkv, sq, g).permute(0, 1, 3, 2).reshape(b, h, sq)
    return o.reshape(b, sq, h, d).to(torch.bfloat16), lse


def dkv_model(q, k, v, do, lse, delta, *, causal, scale, splits, segq=None,
              segk=None):
    """``flash_dkv_small``'s arithmetic (see the module docstring), with
    ``splits`` CTAs a key tile. q, k, v, do bf16; lse, delta f32
    ``[B, H, sq]``. Returns dk, dv bf16 ``[B, sk, Hkv, D]``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = sq * g
    qf, dof = _flat(q.float(), hkv), _flat(do.float(), hkv)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    lse2 = (_flat_stat(lse, hkv) * np.float32(LOG2E)).float()
    dl = _flat_stat(delta, hkv)
    allow = _allow(b, sq, sk, g, causal, segq, segk)
    sl = float(np.float32(scale * LOG2E))
    dk = torch.zeros(b, hkv, sk, d)
    dv = torch.zeros(b, hkv, sk, d)
    for j0 in range(0, sk, DKV_KEYS):
        keys = slice(j0, j0 + DKV_KEYS)
        r_begin = max(0, j0 - (sk - sq)) * g if causal else 0
        r_begin = min(r_begin, rows)
        n_steps = -(-(rows - r_begin) // RT)
        parts = []
        for rank in range(splits):
            lo, hi = n_steps * rank // splits, n_steps * (rank + 1) // splits
            pk = torch.zeros_like(dk[:, :, keys])
            pv = torch.zeros_like(dv[:, :, keys])
            for u in range(lo, hi):
                r = slice(r_begin + u * RT, min(r_begin + (u + 1) * RT, rows))
                st = kf[:, :, keys] @ qf[:, :, r].transpose(-1, -2)
                p = torch.where(allow[:, :, r, keys].transpose(-1, -2),
                                torch.exp2(_fma(st, sl, -lse2[:, :, None, r])),
                                0.0)
                dpt = vf[:, :, keys] @ dof[:, :, r].transpose(-1, -2)
                ds = (p * (dpt - dl[:, :, None, r]) * scale).to(
                    torch.bfloat16).float()
                pv = pv + p.to(torch.bfloat16).float() @ dof[:, :, r]
                pk = pk + ds @ qf[:, :, r]
            parts.append((pk, pv))
        tk, tv = parts[0]
        for pk, pv in parts[1:]:                     # rank order
            tk, tv = tk + pk, tv + pv
        dk[:, :, keys], dv[:, :, keys] = tk, tv
    return (dk.transpose(1, 2).to(torch.bfloat16),
            dv.transpose(1, 2).to(torch.bfloat16))


def dq_model(q, k, v, do, lse, delta, *, causal, scale, segq=None,
             segk=None):
    """``flash_dq_small``'s arithmetic (see the module docstring). q, k, v,
    do bf16; lse, delta f32 ``[B, H, sq]``. Returns dq bf16
    ``[B, sq, H, D]``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf, dof = _flat(q.float(), hkv), _flat(do.float(), hkv)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    lse2 = (_flat_stat(lse, hkv) * np.float32(LOG2E)).float()[..., None]
    dl = _flat_stat(delta, hkv)[..., None]
    allow = _allow(b, sq, sk, g, causal, segq, segk)
    sl = float(np.float32(scale * LOG2E))
    dq = torch.zeros(b, hkv, sq * g, d)
    for c0 in range(0, sk, DQ_KT):
        kt, vt = kf[:, :, c0:c0 + DQ_KT], vf[:, :, c0:c0 + DQ_KT]
        s = torch.where(allow[..., c0:c0 + DQ_KT],
                        qf @ kt.transpose(-1, -2), -torch.inf)
        p = torch.exp2(_fma(s, sl, -lse2))
        dp = dof @ vt.transpose(-1, -2)
        ds = (p * (dp - dl) * scale).to(torch.bfloat16).float()
        dq = dq + ds @ kt
    dq = dq.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4)
    return dq.reshape(b, sq, h, d).to(torch.bfloat16)


def _close(got, want, tol, what):
    """Per element: |got - want| <= atol x max(RMS of its head_dim row, RMS
    of the whole output) + rtol x |want| (chip_smoke.py ``_flash_err``)."""
    atol, rtol = tol
    ref = want.float()
    err = (got.float() - ref).abs()
    scale = ref.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(ref.square().mean().sqrt()))
    share = float((err / (atol * scale + rtol * ref.abs())).max())
    assert share <= 1.0, (
        f"{what}: |model - reference| reaches {share} of the limit {atol} x "
        f"max(rms(row), rms) + {rtol} x |reference| (max err "
        f"{float(err.max())})")


def _lse_close(got, want, what):
    """lse within LSE_ATOL where the reference row sees a key; rows that
    see none both at or below -1e29 (chip_smoke.py phase D)."""
    seen = want > -1e29
    assert torch.equal(got <= -1e29, ~seen), what
    if seen.any():
        err = float((got[seen] - want[seen]).abs().max())
        assert err <= LSE_ATOL, f"{what}: lse error {err} > {LSE_ATOL}"


# (b, sq, sk, h, hkv, head_dim, causal, segments): head_dim 16 and 32,
# groups 1, 2 and 4, causal and not, sq < sk, sq > sk (leading rows see no
# key), segment ids with rows that see no key and keys no row sees, and
# lengths (77, 100, 136, 160, 200) that cut the 128-key, 64-key and 64-row
# tiles; the last shape has 16 row steps on key tile 0.
SHAPES = [
    (2, 128, 128, 4, 2, 16, True, False),
    (1, 96, 96, 4, 4, 32, False, False),
    (1, 64, 200, 8, 2, 16, True, False),
    (1, 160, 160, 8, 2, 32, True, True),
    (2, 100, 100, 2, 1, 16, False, True),
    (1, 200, 136, 4, 2, 32, True, False),
    (1, 77, 77, 4, 1, 16, True, True),
    (1, 256, 256, 4, 1, 16, True, False),
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
        segq = segk[:, sk - sq:].copy() if sq <= sk else np.sort(
            rng.integers(0, 3, (b, sq)), axis=1).astype(np.int32)
        segq[0, 5:9] = 7                 # rows that see no key
        segk[b - 1, 10:13] = 8           # keys no row sees
    return q, k, v, do, segq, segk


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def _ids(s):
    return "x".join(map(str, s))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_fwd_model_matches_pallas_forward(shape):
    """The forward's model against the Pallas forward in interpret mode and
    the port's plain version, on the same bf16 inputs; rows that see no key
    give O = 0 and the plain lse exactly."""
    q, k, v, _, segq, segk = _inputs(shape, 11 + sum(shape[:6]))
    causal, d = shape[6], shape[5]
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o, lse = pf._fwd(jq, jk, jv, _j(segq), _j(segk), causal=causal,
                     scale=scale, interpret=True)
    want_o = _t(np.asarray(o.astype(jnp.float32)))
    want_lse = _t(np.asarray(lse)).reshape(shape[0], shape[3], shape[1])
    tq, tk, tv = _bf16(q, k, v)
    got_o, got_lse = fwd_model(tq, tk, tv, causal=causal, scale=scale,
                               segq=_t(segq), segk=_t(segk))
    plain_o, plain_lse = fa.flash_attention_reference(
        tq, tk, tv, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    assert got_o.shape == want_o.shape and got_o.dtype == torch.bfloat16
    assert torch.isfinite(got_o.float()).all()
    assert torch.isfinite(got_lse).all()
    _close(got_o, want_o, BF16_TOL, "o vs Pallas")
    _close(got_o, plain_o, BF16_TOL, "o vs the plain version")
    _lse_close(got_lse, want_lse, "lse vs Pallas")
    _lse_close(got_lse, plain_lse, "lse vs the plain version")
    blind = plain_lse <= -1e29
    assert torch.equal(got_lse[blind], plain_lse[blind])
    assert torch.all(got_o[blind.transpose(1, 2)] == 0)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_dkv_model_matches_pallas_backward(shape):
    """The dK/dV model, at the wrapper's cluster size for 132 SMs and
    unsplit, against the Pallas backward in interpret mode and the port's
    plain version on the same bf16 inputs and forward residuals; keys no
    row sees give exactly 0."""
    q, k, v, do, segq, segk = _inputs(shape, 7 + sum(shape[:6]))
    b, sq, sk, h, hkv, d, causal, _ = shape
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = pf._fwd(jq, jk, jv, _j(segq), _j(segk), causal=causal,
                     scale=scale, interpret=True)
    want = pf._bwd(causal, scale, True,
                   (jq, jk, jv, _j(segq), _j(segk), o, lse), jdo)[1:3]
    tq, tk, tv, tdo = _bf16(q, k, v, do)
    to = _t(np.asarray(o.astype(jnp.float32))).to(torch.bfloat16)
    tlse = _t(np.asarray(lse)).reshape(b, h, sq)
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    plain = fa.flash_attention_bwd_reference(
        tq, tk, tv, to, tlse, tdo, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk), delta=delta)[1:]
    splits = fa._dkv_small_splits(b, hkv, sq, sk, h // hkv, causal, 132)
    for n in sorted({splits, 1}):
        got = dkv_model(tq, tk, tv, tdo, tlse, delta, causal=causal,
                        scale=scale, splits=n, segq=_t(segq), segk=_t(segk))
        for name, mine, ref, ref_plain in zip(("dk", "dv"), got, want, plain):
            ref = _t(np.asarray(ref.astype(jnp.float32)))
            assert mine.shape == ref.shape and mine.dtype == torch.bfloat16
            assert torch.isfinite(mine.float()).all(), name
            _close(mine, ref, BF16_TOL, f"{name} vs Pallas, {n} CTAs")
            _close(mine, ref_plain, BF16_TOL,
                   f"{name} vs the plain version, {n} CTAs")
            if segk is not None:         # keys no row sees: exactly 0
                assert torch.all(mine[b - 1, 10:13] == 0)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_dq_model_matches_pallas_backward(shape):
    """The dQ model against the Pallas backward in interpret mode and the
    port's plain version on the same bf16 inputs and forward residuals;
    rows that see no key give exactly 0."""
    q, k, v, do, segq, segk = _inputs(shape, 5 + sum(shape[:6]))
    b, sq, sk, h, hkv, d, causal, _ = shape
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = pf._fwd(jq, jk, jv, _j(segq), _j(segk), causal=causal,
                     scale=scale, interpret=True)
    want = _t(np.asarray(pf._bwd(
        causal, scale, True, (jq, jk, jv, _j(segq), _j(segk), o, lse),
        jdo)[0].astype(jnp.float32)))
    tq, tk, tv, tdo = _bf16(q, k, v, do)
    to = _t(np.asarray(o.astype(jnp.float32))).to(torch.bfloat16)
    tlse = _t(np.asarray(lse)).reshape(b, h, sq)
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    plain = fa.flash_attention_bwd_reference(
        tq, tk, tv, to, tlse, tdo, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk), delta=delta)[0]
    got = dq_model(tq, tk, tv, tdo, tlse, delta, causal=causal,
                   scale=scale, segq=_t(segq), segk=_t(segk))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    _close(got, want, BF16_TOL, "dq vs Pallas")
    _close(got, plain, BF16_TOL, "dq vs the plain version")
    blind = (tlse <= -1e29).transpose(1, 2)          # [B, sq, H]
    if causal and sq > sk or segq is not None:
        assert blind.any()
    assert torch.all(got[blind] == 0) and torch.all(plain[blind] == 0)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    q, k, v, do, _, _ = _inputs((1, 64, 64, 4, 2, 16, True, False), 3)
    counts = (lambda: (fa.flash_fwd.launches, fa.flash_fwd.launches_small,
                       fa.flash_bwd_dq.launches,
                       fa.flash_bwd_dq.launches_small,
                       fa.flash_bwd_dkv.launches,
                       fa.flash_bwd_dkv.launches_small))
    before = counts()
    tq, tk, tv = (x.requires_grad_() for x in _bf16(q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True)
    tdo, = _bf16(do)
    out.backward(tdo)
    want_o, want_lse = fa.flash_attention_reference(
        tq.detach(), tk.detach(), tv.detach(), causal=True)
    assert torch.equal(out, want_o)
    want = fa.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), want_o, want_lse, tdo,
        causal=True)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, ref)
    assert counts() == before


def test_small_wrappers_refuse_cpu_tensors():
    q, k, v, do, _, _ = _inputs((1, 16, 16, 2, 2, 16, True, False), 1)
    tq, tk, tv, tdo = _bf16(q, k, v, do)
    stat = torch.zeros(1, 2, 16)
    counts = (lambda: (fa.flash_fwd.launches_small,
                       fa.flash_bwd_dq.launches_small,
                       fa.flash_bwd_dkv.launches_small))
    before = counts()
    with pytest.raises(ValueError, match="device cpu"):
        fa.flash_fwd(tq, tk, tv, None, None, True, 0.25, route="small")
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="device cpu"):
            fn(tq, tk, tv, tdo, stat, stat, None, None, True, 0.25,
               route="small")
    assert counts() == before
