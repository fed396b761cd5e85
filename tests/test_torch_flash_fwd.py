"""PyTorch port, the tensor-core flash-attention forward
(``csrc/flash_fwd.cu``) on the CPU, where the kernel cannot run.

- ``_fwd_route``: bf16 at head_dim 64 or 128 takes ``flash_fwd_wgmma``
  (``"wgmma"``); bf16 at head_dim 16 or 32 ``flash_fwd_small`` of
  ``csrc/flash_small.cu`` (``"small"``); float32 ``flash_fwd_tf32x3`` of
  ``csrc/flash_fwd_f32.cu`` (``"tf32x3"``,
  ``tests/test_torch_flash_fwd_f32.py``). ``flash_fwd_kernel`` of
  ``csrc/flash_attn.cu`` (``"mma"``) runs only when named.
- A torch model of the kernel's arithmetic, written here: flattened
  (position, group head) query rows walk 64-key tiles in order; scores
  summed in f32 and taken to the log2 domain (times scale * log2 e),
  NEG_INF where masked; per tile the running max m, alpha = 2^(m_old -
  m), p = 2^(x - m) (0 where masked), l = alpha l + sum(p), O = alpha O +
  bf16(p) . V in f32; at the end O times 1 / max(l, 1e-30) rounded to bf16
  and lse = m ln 2 + log(max(l, 1e-30)), NEG_INF + log(1e-30) for a row
  whose m is still the sentinel. The kernel runs its two 64-row halves
  half a tile apart; each row's arithmetic is the same. It is held against the Pallas forward
  (``pallas_flash._fwd``) in interpret mode on the same bf16 inputs, and
  against the port's plain version, at head_dim 64 and 128, groups 1, 3
  and 4, causal and not, sq < sk, sq > sk, and segment ids with rows that
  see no key. Tolerance: phase D's bf16 limits (``chip_smoke.py``
  ``FLASH_TOL`` and ``LSE_ATOL``): O per element within 2^-5 x max(RMS of
  its row, RMS of the output) + 2^-6 x |Pallas|, lse within 1e-3. Both
  sides round p to bf16 at the running max, so they differ by the order of
  the f32 sums, the last bits of the exponential (a p now and then one
  bf16 step apart) and where the running max moves (per 64-key tile here,
  per Pallas block there), and by the one rounding of O (2^-7 of the value
  at most).
- A row that sees no key: O exactly 0 and lse equal to the plain
  version's -1e30, which the backward reads as masked (its dQ row is 0).
- CPU tensors take the plain version and count no launch; a named route
  on CPU tensors, and the launch itself, refuse them.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k flash_fwd``) and in
``chip_smoke.py`` phase D.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_tpu.ops import pallas_flash as pf

torch.set_num_threads(2)

KT = 64                            # the kernel's key tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
BF16_TOL = (2 ** -5, 2 ** -6)      # chip_smoke.py FLASH_TOL[torch.bfloat16]
LSE_ATOL = 1e-3                    # chip_smoke.py LSE_ATOL


@pytest.mark.parametrize("head_dim", [64, 128])
def test_bf16_at_wgmma_head_dims_takes_the_wgmma_route(head_dim):
    assert fa._fwd_route(torch.bfloat16, head_dim) == "wgmma"


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float32, 64), (torch.float32, 128), (torch.float32, 16),
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.float32, 32)])
def test_other_calls_take_the_mma_route(dtype, head_dim):
    """float32 at every head dim takes ``"tf32x3"``
    (``csrc/flash_fwd_f32.cu``, ``tests/test_torch_flash_fwd_f32.py``);
    bf16 at head_dim 16 and 32 takes ``"small"`` (``csrc/flash_small.cu``,
    ``tests/test_torch_flash_small.py``). No call takes ``"mma"`` unless
    a caller names it."""
    want = "small" if dtype == torch.bfloat16 else "tf32x3"
    assert fa._fwd_route(dtype, head_dim) == want


def kernel_model(q, k, v, *, causal, scale, segq=None, segk=None):
    """The kernel's arithmetic in torch (see the module docstring). q, k, v
    bf16 ``[B, S, H, D]``. Returns o bf16 ``[B, sq, H, D]`` and lse f32
    ``[B, H, sq]``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = sq * g
    # Row i * g + t is position i of head hkv * g + t: [B, Hkv, rows, D].
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, rows, d)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    pos = torch.arange(rows) // g
    allow = torch.ones(b, rows, sk, dtype=torch.bool)
    if causal:
        allow &= (pos[:, None] + (sk - sq) >= torch.arange(sk)[None])[None]
    if segq is not None:
        allow &= segq[:, pos][:, :, None] == segk[:, None, :]
    allow = allow[:, None]                           # [B, 1, rows, sk]
    sl = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((b, hkv, rows, 1), NEG_INF)
    l = torch.zeros(b, hkv, rows, 1)
    acc = torch.zeros(b, hkv, rows, d)
    for c0 in range(0, sk, KT):
        kt, vt = kf[:, :, c0:c0 + KT], vf[:, :, c0:c0 + KT]
        x = torch.where(allow[..., c0:c0 + KT],
                        (qf @ kt.transpose(-1, -2)) * sl,
                        torch.tensor(NEG_INF))
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.where(x <= NEG_INF / 2, 0.0, torch.exp2(x - mn))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p.to(torch.bfloat16).float() @ vt
        m = mn
    norm = l.clamp_min(1e-30)
    o = (acc * (1.0 / norm)).reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4)
    m_nat = torch.where(m <= NEG_INF / 2, torch.tensor(NEG_INF), m * LN2)
    lse = (m_nat + torch.log(norm))[..., 0]          # [B, Hkv, rows]
    lse = lse.reshape(b, hkv, sq, g).permute(0, 1, 3, 2).reshape(b, h, sq)
    return o.reshape(b, sq, h, d).to(torch.bfloat16), lse


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


# (b, sq, sk, h, hkv, head_dim, causal, segments): groups 1, 3 and 4, both
# head dims, causal and not, sq < sk, sq > sk (leading rows see no key),
# segment ids, and lengths of 96 and 160 that cut the 64-key tiles and
# the 64-row halves of a CTA (at group 3 a 64-row tile spans positions).
SHAPES = [
    (2, 128, 128, 4, 4, 64, True, False),
    (1, 128, 128, 12, 4, 64, True, False),
    (1, 128, 128, 8, 2, 128, False, False),
    (1, 64, 192, 8, 2, 128, True, False),
    (1, 192, 64, 8, 2, 64, True, False),
    (1, 160, 160, 6, 2, 64, True, True),
    (2, 96, 96, 4, 1, 128, True, True),
    (1, 96, 96, 3, 3, 128, False, False),
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


def _bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_matches_pallas_forward(shape):
    """The model against the Pallas forward in interpret mode (and the
    port's plain version) on the same bf16 inputs."""
    q, k, v, segq, segk = _inputs(shape, 11 + sum(shape[:6]))
    causal, d = shape[6], shape[5]
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o, lse = pf._fwd(jq, jk, jv, _j(segq), _j(segk), causal=causal,
                     scale=scale, interpret=True)
    want_o = _t(np.asarray(o.astype(jnp.float32)))
    want_lse = _t(np.asarray(lse)).reshape(shape[0], shape[3], shape[1])
    tq, tk, tv = _bf16(q, k, v)
    got_o, got_lse = kernel_model(tq, tk, tv, causal=causal, scale=scale,
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


@pytest.mark.parametrize("shape", [
    (1, 160, 160, 6, 2, 64, True, True),
    (1, 192, 64, 8, 2, 64, True, False)], ids=["segments", "sq_gt_sk"])
def test_rows_that_see_no_key_give_zero_and_the_plain_lse(shape):
    """O exactly 0 and lse the plain version's -1e30 + log(1e-30) (a
    sentinel in natural units, not -1e30 x ln 2); the backward that reads
    this lse gives exactly 0 in those rows of dQ, with no NaN."""
    q, k, v, segq, segk = _inputs(shape, 3)
    causal, d = shape[6], shape[5]
    scale = d ** -0.5
    tq, tk, tv = _bf16(q, k, v)
    o, lse = kernel_model(tq, tk, tv, causal=causal, scale=scale,
                          segq=_t(segq), segk=_t(segk))
    plain_o, plain_lse = fa.flash_attention_reference(
        tq, tk, tv, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    blind = plain_lse <= -1e29                       # [B, H, sq]
    assert blind.any()
    expect = torch.tensor(NEG_INF, dtype=torch.float32) + math.log(1e-30)
    assert torch.all(lse[blind] == expect)
    assert torch.equal(lse[blind], plain_lse[blind])
    rows = blind.transpose(1, 2)                     # [B, sq, H]
    assert torch.all(o[rows] == 0)
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tq.shape).astype(np.float32)).to(torch.bfloat16)
    dq, _, _ = fa.flash_attention_bwd_reference(
        tq, tk, tv, o, lse, do, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    assert torch.isfinite(dq.float()).all()
    assert torch.all(dq[rows] == 0)


def test_cpu_forward_takes_the_plain_version_and_counts_no_launch():
    q, k, v, _, _ = _inputs((1, 64, 64, 4, 2, 64, True, False), 3)
    tq, tk, tv = _bf16(q, k, v)
    before = (fa.flash_fwd.launches, fa.flash_fwd.launches_wgmma)
    o, lse = fa.flash_fwd(tq, tk, tv, None, None, True, 0.125)
    want_o, want_lse = fa.flash_attention_reference(
        tq, tk, tv, causal=True, softmax_scale=0.125)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    out = fa.flash_attention(tq, tk, tv, causal=True, softmax_scale=0.125)
    assert torch.equal(out, want_o)
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_wgmma) == before


@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_cuda_wrappers_refuse_cpu_tensors(route):
    q, k, v, _, _ = _inputs((1, 16, 16, 2, 2, 64, True, False), 1)
    tq, tk, tv = _bf16(q, k, v)
    before = (fa.flash_fwd.launches, fa.flash_fwd.launches_wgmma)
    with pytest.raises(ValueError, match="device cpu"):
        fa.flash_fwd(tq, tk, tv, None, None, True, 0.125, route=route)
    o, lse = torch.empty_like(tq), torch.empty(1, 2, 16)
    with pytest.raises(ValueError, match="device cpu"):
        fa._fwd_launch(tq, tk, tv, None, None, o, lse, True, 0.125, route)
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_wgmma) == before
