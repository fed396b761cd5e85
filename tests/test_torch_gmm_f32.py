"""PyTorch port, the f32 grouped matmul on the tensor cores
(``csrc/gmm_f32.cu``, the ``"tf32x3"`` route) on the CPU, where the kernel
cannot run.

- ``_gmm_route``: f32 ``gmm_forward`` (the forward and, reading the weight
  transposed, dlhs) takes the tf32x3 kernel, and so does f32 ``tgmm``
  (``tests/test_torch_tgmm_f32.py`` holds that kernel); bf16 takes the
  wgmma kernels.
- A torch model of the kernel's arithmetic, written here: every row
  block of 128 rows times its expert's weight, the contraction in 32-deep
  stages (the last one zero-filled past K), each stage's product the
  three-pass TF32 split summed from zero (operands rounded to TF32 as the
  kernel's integer add rounds them on the int32 view, ``(bits + 0x1000) &
  ~0x1FFF``; ``hi = rna(x)``, ``lo = rna(x - hi)``; ``a_lo.b_hi +
  a_hi.b_lo + a_hi.b_hi`` in f32) and added to the running sum in f32; a
  dead block is exactly 0. It is held against the JAX Pallas kernel in
  interpret mode (``pallas_gmm._gmm_call``; for dlhs on the weight
  transposed) and against the port's plain version at phase G's f32 limit
  (``chip_smoke.py`` ``GMM_TOL[torch.float32]``: per element 1e-5 x the
  output's RMS + 1e-5 x |reference|). Layouts: balanced, skewed (one
  expert with most rows, a one-row expert, an empty one) and one with a
  single live expert, at K 136 and N 200 (neither a multiple of the 32-deep
  stage or the 128-column tile).
- The same model with one TF32 pass exceeds that limit: the test can tell
  the split from its absence.
- A named tf32x3 route on CPU tensors raises; CPU calls count no launch.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k gmm_tf32x3``) and in
``chip_smoke.py`` phase G.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import gmm as t_gmm
from k8s_distributed_deeplearning_tpu.ops import pallas_gmm as j_gmm

torch.set_num_threads(2)

BK = 32                              # the kernel's stage depth
BM = t_gmm.KERNEL_BLOCK_M            # its row tile
F32_TOL = (1e-5, 1e-5)               # chip_smoke.py GMM_TOL[torch.float32]
K, N = 136, 200


def test_gmm_route_gives_f32_gmm_the_tf32x3_kernel():
    assert t_gmm._gmm_route(torch.float32, "gmm") == "tf32x3"
    assert t_gmm._gmm_route(torch.float32) == "tf32x3"
    assert t_gmm._gmm_route(torch.float32, "tgmm") == "tf32x3"
    assert t_gmm._gmm_route(torch.bfloat16, "gmm") == "wgmma"
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


def kernel_model(lhs, rhs, layout, *, transpose_rhs=False, passes=3):
    """gmm_tf32x3's arithmetic: per live row block, 32-deep stages summed
    from zero and added in order; dead blocks 0."""
    m_pad, k = lhs.shape
    out = torch.zeros(m_pad, rhs.shape[1] if transpose_rhs else rhs.shape[2])
    for blk in range(m_pad // BM):
        if not int(layout.block_live[blk * BM // layout.block_m]):
            continue
        e = int(layout.block_expert[blk * BM // layout.block_m])
        w = rhs[e].t() if transpose_rhs else rhs[e]
        rows = slice(blk * BM, (blk + 1) * BM)
        acc = torch.zeros(BM, w.shape[1])
        for k0 in range(0, k, BK):
            acc = acc + product(lhs[rows, k0:k0 + BK], w[k0:k0 + BK],
                                passes)
        out[rows] = acc
    return out


# name -> group sizes (4 experts, block 128).
LAYOUTS = {
    "balanced": [96, 96, 96, 96],
    "skewed": [300, 1, 0, 83],
    "one_expert": [0, 0, 257, 0],
}


@functools.lru_cache(maxsize=None)
def _case(name, transpose):
    """The layout, lhs (rows that hold no token 0) and rhs ([E, K, N], or
    [E, N, K] read transposed), and the Pallas kernel's output in interpret
    mode."""
    sizes = LAYOUTS[name]
    rng = np.random.default_rng(len(name) + 3 * transpose)
    lay = t_gmm.grouped_layout(torch.tensor(sizes, dtype=torch.int32),
                               sum(sizes), block_m=BM)
    k, n = (N, K) if transpose else (K, N)
    lhs = np.zeros((lay.m_pad, k), np.float32)
    off = lay.row_offset.numpy()
    for i, s in enumerate(sizes):
        lhs[off[i]:off[i] + s] = rng.standard_normal((s, k))
    shape = (len(sizes), n, k) if transpose else (len(sizes), k, n)
    rhs = (rng.standard_normal(shape) * k ** -0.5).astype(np.float32)
    jlay = j_gmm.grouped_layout(jnp.asarray(sizes, jnp.int32), sum(sizes),
                                block_m=BM)
    w = jnp.swapaxes(jnp.asarray(rhs), 1, 2) if transpose else \
        jnp.asarray(rhs)
    want = np.asarray(j_gmm._gmm_call(jnp.asarray(lhs), w, jlay,
                                      interpret=True))
    return lay, torch.from_numpy(lhs), torch.from_numpy(rhs), want


def _share(got, want):
    """The largest share of phase G's f32 limit that |got - want| uses."""
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    limit = F32_TOL[0] * rms + F32_TOL[1] * np.abs(want)
    return float(np.max(np.abs(got - want) / limit))


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "dlhs"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_kernel_arithmetic_matches_pallas_and_plain(name, transpose):
    lay, lhs, rhs, want = _case(name, transpose)
    got = kernel_model(lhs, rhs, lay, transpose_rhs=transpose).numpy()
    plain = t_gmm.gmm_reference(lhs, rhs, lay,
                                transpose_rhs=transpose).numpy()
    dead = ~t_gmm.live_rows(lay).numpy()
    assert np.all(got[dead] == 0) and np.all(plain[dead] == 0)
    assert _share(got, want) <= 1.0
    assert _share(got, plain) <= 1.0
    # CPU tensors take the plain version.
    assert torch.equal(t_gmm.gmm_forward(lhs, rhs, lay,
                                         transpose_rhs=transpose),
                       torch.from_numpy(plain))


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "dlhs"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_one_tf32_pass_exceeds_the_f32_limit(name, transpose):
    lay, lhs, rhs, want = _case(name, transpose)
    three = _share(kernel_model(lhs, rhs, lay,
                                transpose_rhs=transpose).numpy(), want)
    one = _share(kernel_model(lhs, rhs, lay, transpose_rhs=transpose,
                              passes=1).numpy(), want)
    assert three <= 0.5 < 1.0 < one, (three, one)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_dead_blocks_are_exactly_zero_and_read_nothing(name):
    """A dead block is 0 whatever its rows hold: the kernel reads nothing
    there."""
    lay, lhs, rhs, _ = _case(name, False)
    noisy = lhs.clone()
    blocks = lay.block_live.repeat_interleave(lay.block_m) == 0
    noisy[blocks] = 1e4
    got = kernel_model(noisy, rhs, lay)
    assert torch.all(got[blocks] == 0)
    assert torch.equal(got[~blocks], kernel_model(lhs, rhs, lay)[~blocks])


def test_tf32x3_route_on_cpu_tensors_raises_and_counts_nothing():
    lay, lhs, rhs, _ = _case("skewed", False)
    before = (t_gmm.gmm_forward.launches, t_gmm.gmm_forward.launches_tf32x3)
    with pytest.raises(ValueError, match="no grouped matmul kernel"):
        t_gmm.gmm_forward(lhs, rhs, lay, route="tf32x3")
    t_gmm.gmm(lhs, rhs, lay)
    assert (t_gmm.gmm_forward.launches,
            t_gmm.gmm_forward.launches_tf32x3) == before
