"""PyTorch port, the tensor-core flash-attention backward
(``csrc/flash_bwd.cu``) on the CPU, where the kernels cannot run.

- ``_bwd_route``: bf16 at head_dim 64 or 128 takes the ``"wgmma"`` kernels;
  bf16 at head_dim 16 or 32 the dQ and dK/dV kernels of
  ``csrc/flash_small.cu`` (``"small"``); float32 at every head dim the
  three-pass TF32 kernels of ``csrc/flash_bwd_f32.cu`` (``"tf32x3"``).
- A torch model of the two kernels' arithmetic, written here: the dQ kernel
  walks 64-key tiles in order, the dK/dV kernel 64-row tiles of flattened
  (position, group head) query rows; P = 2^(s * scale * log2 e - lse *
  log2 e) in f32, 0 where masked; dS = P (dP - delta) scale rounded to
  bf16 before dS.K and dS^T.Q; P rounded to bf16 before P^T.dO; products
  of bf16 values summed in f32. It is held against the Pallas backward
  (``pallas_flash._bwd``) in interpret mode on the same bf16 inputs and the
  same forward residuals, and against the port's plain version, at head_dim
  64 and 128, groups 1, 3 and 4, causal and not, sq < sk, segment ids with
  rows that see no key, and lengths that cut the 64-row and 64-key tiles.
  Tolerance: phase D's bf16 limit (``chip_smoke.py`` ``FLASH_TOL``), per
  element 2^-5 x max(RMS of its row, RMS of the output) + 2^-6 x |Pallas|:
  both sides round dS and P to bf16 at the same points, so they differ by
  the order of the f32 sums and the last bits of the exponential, which
  move a dS across a bf16 rounding boundary now and then (one bf16 step,
  2^-8 of a dS, in one term of a row's sum), and by the one rounding of
  each output (2^-7 of the value at most).
- CPU tensors take the plain version and count no launch on either route.

The kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k flash_bwd``) and in ``chip_smoke.py``
phase D.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_tpu.ops import pallas_flash as pf

torch.set_num_threads(2)

KT = QT = 64                       # the kernels' key and query-row tiles
LOG2E = 1.4426950408889634
BF16_TOL = (2 ** -5, 2 ** -6)      # chip_smoke.py FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("head_dim", [64, 128])
def test_bf16_at_wgmma_head_dims_takes_the_wgmma_route(head_dim):
    for which in ("dq", "dkv"):
        assert fa._bwd_route(torch.bfloat16, head_dim, which) == "wgmma"


@pytest.mark.parametrize("head_dim", [64, 128, 16, 32])
def test_f32_calls_take_the_tf32x3_route(head_dim):
    """float32 at every head dim: the three-pass TF32 kernels of
    ``csrc/flash_bwd_f32.cu`` (``tests/test_torch_flash_bwd_f32.py``)."""
    for which in ("dq", "dkv"):
        assert fa._bwd_route(torch.float32, head_dim, which) == "tf32x3"


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.bfloat16, 16), (torch.bfloat16, 32)])
def test_other_calls_take_the_mma_route(dtype, head_dim):
    """bf16 at head_dim 16 and 32: dQ on ``flash_dq_small`` and dK/dV on
    ``flash_dkv_small`` of ``csrc/flash_small.cu`` (``"small"``,
    ``tests/test_torch_flash_small.py``). ``"mma"``, the kernels of
    ``csrc/flash_attn.cu``, only when named."""
    assert fa._bwd_route(dtype, head_dim, "dq") == "small"
    assert fa._bwd_route(dtype, head_dim, "dkv") == "small"


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
                 segk=None):
    """The two kernels' arithmetic in torch (see the module docstring).
    q, k, v, do bf16 ``[B, S, H, D]``; lse, delta f32 ``[B, H, sq]``.
    Returns dq, dk, dv in bf16."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = sq * g
    qf, dof = _flat(q.float(), hkv), _flat(do.float(), hkv)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    lse2 = _flat_stat(lse, hkv) * LOG2E
    dl = _flat_stat(delta, hkv)
    pos = torch.arange(rows) // g
    allow = torch.ones(b, rows, sk, dtype=torch.bool)
    if causal:
        allow &= (pos[:, None] + (sk - sq) >= torch.arange(sk)[None])[None]
    if segq is not None:
        allow &= segq[:, pos][:, :, None] == segk[:, None, :]
    allow = allow[:, None]                           # [B, 1, rows, sk]
    sl = torch.tensor(scale * LOG2E, dtype=torch.float32)

    def p_ds(s, ok, lse2_, dl_, dp):
        p = torch.where(ok, torch.exp2(s * sl - lse2_), 0.0)
        return p, (p * (dp - dl_) * scale).to(torch.bfloat16).float()

    dq = torch.zeros(b, hkv, rows, d)
    for c0 in range(0, sk, KT):                      # the dQ kernel
        kt, vt = kf[:, :, c0:c0 + KT], vf[:, :, c0:c0 + KT]
        _, ds = p_ds(qf @ kt.transpose(-1, -2), allow[..., c0:c0 + KT],
                     lse2[..., None], dl[..., None],
                     dof @ vt.transpose(-1, -2))
        dq = dq + ds @ kt
    dk = torch.zeros(b, hkv, sk, d)
    dv = torch.zeros(b, hkv, sk, d)
    for r0 in range(0, rows, QT):                    # the dK/dV kernel
        qt, dot = qf[:, :, r0:r0 + QT], dof[:, :, r0:r0 + QT]
        pt, dst = p_ds(kf @ qt.transpose(-1, -2),
                       allow[:, :, r0:r0 + QT].transpose(-1, -2),
                       lse2[:, :, None, r0:r0 + QT],
                       dl[:, :, None, r0:r0 + QT], vf @ dot.transpose(-1, -2))
        dv = dv + pt.to(torch.bfloat16).float() @ dot
        dk = dk + dst @ qt
    dq = dq.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, d)
    return (dq.to(torch.bfloat16), dk.transpose(1, 2).to(torch.bfloat16),
            dv.transpose(1, 2).to(torch.bfloat16))


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


# (b, sq, sk, h, hkv, head_dim, causal, segments): groups 1, 3 and 4, both
# head dims, causal and not, sq < sk, segment ids, and lengths of 96 and
# 160 that cut the 64-key and 64-row tiles (at group 3 a 64-row tile spans
# positions).
SHAPES = [
    (2, 128, 128, 4, 4, 64, True, False),
    (1, 128, 128, 12, 4, 64, True, False),
    (1, 128, 128, 8, 2, 128, False, False),
    (1, 64, 192, 8, 2, 128, True, False),
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


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_matches_pallas_backward(shape):
    """The model against the Pallas backward in interpret mode (and the
    port's plain version) on the same bf16 inputs and forward residuals."""
    q, k, v, do, segq, segk = _inputs(shape, 7 + sum(shape[:6]))
    causal, d = shape[6], shape[5]
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = pf._fwd(jq, jk, jv, _j(segq), _j(segk), causal=causal,
                     scale=scale, interpret=True)
    want = pf._bwd(causal, scale, True,
                   (jq, jk, jv, _j(segq), _j(segk), o, lse), jdo)[:3]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    to = _t(np.asarray(o.astype(jnp.float32))).to(torch.bfloat16)
    tlse = _t(np.asarray(lse)).reshape(shape[0], shape[3], shape[1])
    # Pallas's delta (rowsum(dO·O)) against Pallas, the port's bf16 delta
    # (the sum of P·dP, flash_bwd_delta's) against the plain version.
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=causal, scale=scale, segq=_t(segq), segk=_t(segk))
    got = kernel_model(tq, tk, tv, tdo, tlse, delta, **kw)
    got_port = kernel_model(
        tq, tk, tv, tdo, tlse, fa.flash_delta_reference(
            tq, tk, tv, tlse, tdo, causal=causal, softmax_scale=scale,
            q_segment_ids=_t(segq), kv_segment_ids=_t(segk)), **kw)
    plain = fa.flash_attention_bwd_reference(
        tq, tk, tv, to, tlse, tdo, causal=causal, softmax_scale=scale,
        q_segment_ids=_t(segq), kv_segment_ids=_t(segk))
    for name, mine, port, ref, ref_plain in zip(("dq", "dk", "dv"), got,
                                                got_port, want, plain):
        ref = _t(np.asarray(ref.astype(jnp.float32)))
        assert mine.shape == ref.shape and mine.dtype == torch.bfloat16
        assert torch.isfinite(mine.float()).all(), name
        _close(mine, ref, BF16_TOL, f"{name} vs Pallas")
        _close(port, ref_plain, BF16_TOL, f"{name} vs the plain version")
    if segq is not None:                 # rows that see no key: exactly 0
        assert torch.all(got[0][0, 5:9] == 0)


def test_cpu_backward_takes_the_plain_version_and_counts_no_launch():
    q, k, v, do, _, _ = _inputs((1, 64, 64, 4, 2, 64, True, False), 3)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_wgmma,
              fa.flash_bwd_dkv.launches, fa.flash_bwd_dkv.launches_wgmma)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=True)
    o.backward(torch.from_numpy(do).to(torch.bfloat16))
    want = fa.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), o.detach(),
        fa.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(),
                                     causal=True)[1],
        torch.from_numpy(do).to(torch.bfloat16), causal=True)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, ref)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_wgmma,
            fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dkv.launches_wgmma) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, do, _, _ = _inputs((1, 16, 16, 2, 2, 64, True, False), 1)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    stat = torch.zeros(1, 2, 16)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="device cpu"):
            fn(tq, tk, tv, tdo, stat, stat, None, None, True, 0.125)
