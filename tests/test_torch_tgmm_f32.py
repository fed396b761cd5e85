"""PyTorch port, the f32 weight gradient of the grouped matmul on the
tensor cores (``csrc/gmm_f32.cu`` ``tgmm_tf32x3``, the ``"tf32x3"`` route
of ``tgmm``) on the CPU, where the kernel cannot run.

- ``_gmm_route(torch.float32, "tgmm")`` is ``"tf32x3"``.
- A torch model of the kernel's arithmetic, written here: per expert, the
  rows of its live blocks (the first ``ceil(group_sizes[e] / block_m)``
  blocks of its span: dead blocks read nothing) in 32-row stages, each
  stage's ``lhs[rows]ᵀ · dout[rows]`` the three-pass TF32 split summed
  from zero (operands rounded to TF32 as the kernel's integer add rounds
  them on the int32 view, ``(bits + 0x1000) & ~0x1FFF``; ``hi = rna(x)``,
  ``lo = rna(x - hi)``; ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` in f32) and
  added to the running sum in f32; an expert with no rows is exactly 0.
  It is held against the JAX Pallas kernel in interpret mode
  (``pallas_gmm._tgmm_call``) and against the port's plain version at
  phase G's f32 limit (``chip_smoke.py`` ``GMM_TOL[torch.float32]``: per
  element 1e-5 x the output's RMS + 1e-5 x |reference|). Layouts:
  balanced, skewed (one expert with most rows, a one-row expert, an empty
  one), a single live expert, and one with two empty experts, at K 136
  and N 200 (neither a multiple of the kernel's 128-wide output tile).
- The same model with one TF32 pass exceeds that limit: the test can tell
  the split from its absence.
- Rows past an expert's live blocks, whatever they hold, change no bit of
  the model; a named tf32x3 route on CPU tensors raises; CPU calls count
  no launch.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k tgmm_tf32x3``) and in
``chip_smoke.py`` phases G and I.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import gmm as t_gmm
from k8s_distributed_deeplearning_tpu.ops import pallas_gmm as j_gmm

torch.set_num_threads(2)

BK = 32                              # the kernel's stage: rows a step
BM = t_gmm.KERNEL_BLOCK_M            # the layouts' row block
F32_TOL = (1e-5, 1e-5)               # chip_smoke.py GMM_TOL[torch.float32]
K, N = 136, 200

# name -> group sizes (4 experts, block 128).
LAYOUTS = {
    "balanced": [96, 96, 96, 96],
    "skewed": [300, 1, 0, 83],
    "one_expert": [0, 0, 257, 0],
    "two_empty": [0, 140, 0, 9],
}


def test_gmm_route_gives_f32_tgmm_the_tf32x3_kernel():
    assert t_gmm._gmm_route(torch.float32, "tgmm") == "tf32x3"
    assert t_gmm._gmm_route(torch.bfloat16, "tgmm") == "wgmma"


def tf32(x):
    """x rounded to TF32 as the kernel's integer add rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes):
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    return tf32(a - ah) @ bh + ah @ tf32(b - bh) + ah @ bh


def kernel_model(lhs, dout, layout, passes=3):
    """tgmm_tf32x3's arithmetic: per expert, its live blocks' rows in
    32-row stages summed from zero and added in order."""
    e_count = layout.row_offset.shape[0]
    out = torch.zeros(e_count, lhs.shape[1], dout.shape[1])
    bm = layout.block_m
    for e in range(e_count):
        start = int(layout.row_offset[e])
        end = start + -(-int(layout.group_sizes[e]) // bm) * bm
        acc = torch.zeros(lhs.shape[1], dout.shape[1])
        for r0 in range(start, end, BK):
            acc = acc + product(lhs[r0:r0 + BK].t(), dout[r0:r0 + BK],
                                passes)
        out[e] = acc
    return out


@functools.lru_cache(maxsize=None)
def _case(name):
    """The layout, lhs and dout (rows that hold no token 0, as in the MoE
    layer), and the Pallas kernel's output in interpret mode."""
    sizes = LAYOUTS[name]
    rng = np.random.default_rng(len(name) + 17)
    lay = t_gmm.grouped_layout(torch.tensor(sizes, dtype=torch.int32),
                               sum(sizes), block_m=BM)
    lhs = np.zeros((lay.m_pad, K), np.float32)
    dout = np.zeros((lay.m_pad, N), np.float32)
    off = lay.row_offset.numpy()
    for i, s in enumerate(sizes):
        lhs[off[i]:off[i] + s] = rng.standard_normal((s, K))
        dout[off[i]:off[i] + s] = rng.standard_normal((s, N))
    jlay = j_gmm.grouped_layout(jnp.asarray(sizes, jnp.int32), sum(sizes),
                                block_m=BM)
    want = np.asarray(j_gmm._tgmm_call(jnp.asarray(lhs), jnp.asarray(dout),
                                       len(sizes), jlay, interpret=True))
    return lay, torch.from_numpy(lhs), torch.from_numpy(dout), want


def _share(got, want):
    """The largest share of phase G's f32 limit that |got - want| uses."""
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    limit = F32_TOL[0] * rms + F32_TOL[1] * np.abs(want)
    return float(np.max(np.abs(got - want) / limit))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_kernel_arithmetic_matches_pallas_and_plain(name):
    lay, lhs, dout, want = _case(name)
    got = kernel_model(lhs, dout, lay).numpy()
    plain = t_gmm.tgmm_reference(lhs, dout, 4, lay).numpy()
    for e, s in enumerate(LAYOUTS[name]):
        if s == 0:
            assert np.all(got[e] == 0) and np.all(plain[e] == 0)
            assert np.all(want[e] == 0)
    assert _share(got, want) <= 1.0
    assert _share(got, plain) <= 1.0
    # CPU tensors take the plain version.
    assert torch.equal(t_gmm.tgmm(lhs, dout, 4, lay),
                       torch.from_numpy(plain))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_one_tf32_pass_exceeds_the_f32_limit(name):
    lay, lhs, dout, want = _case(name)
    three = _share(kernel_model(lhs, dout, lay).numpy(), want)
    one = _share(kernel_model(lhs, dout, lay, passes=1).numpy(), want)
    assert three <= 0.5 < 1.0 < one, (three, one)


@pytest.mark.parametrize("name", ["skewed", "two_empty"])
def test_rows_past_the_live_blocks_change_no_bit(name):
    """Rows of the dead blocks (an empty expert's block, the tail past the
    last span) filled with 1e4 change nothing: the kernel walks only the
    live blocks of each span."""
    lay, lhs, dout, _ = _case(name)
    dead = lay.block_live.repeat_interleave(lay.block_m) == 0
    assert bool(dead.any())
    noisy_l, noisy_d = lhs.clone(), dout.clone()
    noisy_l[dead] = 1e4
    noisy_d[dead] = -1e4
    assert torch.equal(kernel_model(noisy_l, noisy_d, lay),
                       kernel_model(lhs, dout, lay))


def test_tf32x3_route_on_cpu_tensors_raises_and_counts_nothing():
    lay, lhs, dout, _ = _case("skewed")
    before = (t_gmm.tgmm.launches, t_gmm.tgmm.launches_tf32x3)
    with pytest.raises(ValueError, match="no grouped matmul kernel"):
        t_gmm.tgmm(lhs, dout, 4, lay, route="tf32x3")
    t_gmm.tgmm(lhs, dout, 4, lay)
    assert (t_gmm.tgmm.launches, t_gmm.tgmm.launches_tf32x3) == before
