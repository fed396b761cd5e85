"""PyTorch port, CUDA kernels against their plain versions on the card.

Imports torch and the port only, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX). Every
kernel test needs an sm_90 GPU (H100) and skips elsewhere with that
reason; the build-layout tests run anywhere.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import _build
from k8s_distributed_deeplearning_torch.ops.paged_attn import (
    paged_decode_attention, paged_decode_attention_reference)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _case(rng, b, sq, h, hkv, pages, bt, nb, hd):
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    pool_k = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    pool_v = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, pages))[:b * nb]
    tables = perm.reshape(b, nb).astype(np.int32)
    base = rng.integers(sq - 1, nb * bt, size=b)
    positions = (base[:, None] - (sq - 1) + np.arange(sq)[None, :]).astype(
        np.int32)
    return q, pool_k, pool_v, tables, positions


def _on(dev, dtype, q, pk, pv, tables, pos):
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(pk).to(dev, dtype),
            torch.from_numpy(pv).to(dev, dtype),
            torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev))


# (b, sq, h, hkv, pages, page_tokens, n_blocks, head_dim): the JAX kernel
# tests' shapes, then Llama-3 8B's heads (32 q, 8 kv, hd 128) at decode
# and at prefill chunks (the larger one has enough row tiles to run with
# an unsplit key range, the others split it across blocks), with pages
# smaller and larger than the 32-key tile and a row tile that straddles
# query positions (group 3).
SHAPES = [
    (2, 1, 4, 2, 16, 8, 4, 8),
    (3, 5, 4, 4, 32, 16, 3, 8),
    (2, 3, 8, 2, 64, 4, 6, 8),
    (4, 1, 32, 8, 80, 32, 16, 128),
    (1, 64, 32, 8, 40, 32, 8, 128),
    (2, 128, 32, 8, 80, 32, 16, 128),
    (2, 7, 6, 2, 64, 64, 3, 64),
    (1, 9, 12, 4, 64, 16, 20, 256),
]
# fp32: an online softmax against a plain one, 2e-5. bf16: the kernel
# rounds the unnormalized p to bf16 for P.V (as the Pallas kernel does)
# and the plain version the normalized probabilities; both round O(1)
# outputs to bf16 (eps 2^-8): 2e-2.
DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_paged_attn_matches_reference(hopper, dtype, tol, shape):
    rng = np.random.default_rng(sum(shape))
    args = _on(hopper, dtype, *_case(rng, *shape))
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_paged_attn_stale_kv_and_scratch_are_inert(hopper):
    """Overwriting every token past each row's cursor, and pointing the
    blocks past the live length at a huge-valued page, changes no bit."""
    rng = np.random.default_rng(3)
    q, pk, pv, tables, pos = _case(rng, 3, 2, 8, 2, 64, 8, 6, 64)
    pos[:, :] = np.array([[9, 10], [20, 21], [3, 4]], np.int32)
    base = paged_decode_attention(*_on(hopper, torch.float32, q, pk, pv,
                                       tables, pos))
    pk2, pv2, t2 = pk.copy(), pv.copy(), tables.copy()
    bt = pk.shape[1]
    for bi in range(tables.shape[0]):
        cursor = int(pos[bi].max())
        for blk in range(tables.shape[1]):
            if blk * bt > cursor:
                t2[bi, blk] = 0               # past the live length
            for t in range(bt):
                if blk * bt + t > cursor:
                    pk2[tables[bi, blk], t] = 1e4
                    pv2[tables[bi, blk], t] = -1e4
    pk2[0] = 1e4                               # scratch page garbage
    pv2[0] = -1e4
    out = paged_decode_attention(*_on(hopper, torch.float32, q, pk2, pv2,
                                      t2, pos))
    torch.testing.assert_close(out, base, atol=0, rtol=0)


def test_paged_attn_fully_masked_row_is_zero(hopper):
    rng = np.random.default_rng(5)
    q, pk, pv, tables, pos = _case(rng, 2, 2, 4, 2, 16, 8, 3, 8)
    pos[0, 0] = -1
    out = paged_decode_attention(*_on(hopper, torch.float32, q, pk, pv,
                                      tables, pos))
    assert torch.all(out[0, 0] == 0)
    assert torch.isfinite(out).all()


def test_paged_attn_rejects_what_the_kernel_cannot_take(hopper):
    """A CUDA tensor never reaches the plain version: what the kernel does
    not take raises."""
    rng = np.random.default_rng(7)
    q, pk, pv, tables, pos = _on(hopper, torch.float32,
                                 *_case(rng, 2, 1, 4, 2, 16, 8, 4, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_decode_attention(q.half(), pk.half(), pv.half(), tables, pos)
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q, pk, pv, tables.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(torch.cat([q, q], -1)[..., :q.shape[-1]],
                               pk, pv, tables, pos)


def test_build_directory_is_ignored_by_git():
    """Kernel builds land inside the package, in a directory .gitignore
    lists."""
    lib = _build.library_path("paged_attn")
    assert lib.parent == _build.BUILD_DIR
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    assert rel in (REPO / ".gitignore").read_text().split()


def test_library_name_tracks_the_source():
    """The library name hashes the source and flags, so an edited source
    is rebuilt rather than a stale library loaded."""
    a = _build.library_path("paged_attn")
    assert a == _build.library_path("paged_attn")
    assert a.name.startswith("libpaged_attn-") and a.suffix == ".so"
