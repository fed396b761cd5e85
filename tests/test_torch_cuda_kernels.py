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

from k8s_distributed_deeplearning_torch.models.transformer import quantize_kv
from k8s_distributed_deeplearning_torch.ops import _build
from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
from k8s_distributed_deeplearning_torch.ops import paged_attn
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
# query positions (group 3). Each case also runs on the split kernel
# forced, where its route is another one.
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
    split = paged_attn._launch(*args, route="split")
    torch.testing.assert_close(split.float(), ref.float(), atol=tol,
                               rtol=tol)


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


def _int8_on(dev, dtype, q, pk, pv, tables, pos):
    """The case's pools quantized by the model's quantize-on-write, on the
    card: (q, int8 K, int8 V, tables, positions, K scales, V scales)."""
    hd = q.shape[-1]
    out = [torch.from_numpy(q).to(dev, dtype)]
    scales = []
    for p in (pk, pv):
        x, s = quantize_kv(torch.from_numpy(p).view(*p.shape[:2], -1, hd))
        out.append(x.view(p.shape).to(dev))
        scales.append(s.to(dev))
    return (*out, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev), *scales)


# (b, sq, h, hkv, pages, page_tokens, n_blocks, head_dim): Llama-3 8B's
# heads at decode and at a prefill chunk, 12/4 heads at head_dim 64 with
# pages of 32 and of 16 tokens, and the JAX verify-window case at head_dim
# 16, the smallest the int8 branch takes. Each case also runs on the
# split kernel forced.
INT8_SHAPES = [
    (4, 1, 32, 8, 80, 32, 16, 128),
    (2, 128, 32, 8, 80, 32, 16, 128),
    (4, 1, 12, 4, 80, 32, 16, 64),
    (2, 64, 12, 4, 80, 16, 20, 64),
    (3, 5, 4, 4, 32, 16, 3, 16),
]
# Per element, |kernel - plain| <= atol * RMS of the plain output + rtol *
# |plain|. Both dequantize to the same f32 values and keep p in f32; they
# differ in the order of the f32 sums (f32) and then in the one rounding of
# the output to bf16, one bf16 step at most (2^-7 of the value).
INT8_DTYPES = [(torch.float32, (2e-5, 2e-5)),
               (torch.bfloat16, (2 ** -10, 2 ** -7))]


@pytest.mark.parametrize("dtype,tol", INT8_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", INT8_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_paged_attn_int8_matches_reference(hopper, dtype, tol, shape):
    rng = np.random.default_rng(sum(shape) + 1)
    q, kq, vq, tables, pos, ks, vs = _int8_on(hopper, dtype,
                                              *_case(rng, *shape))
    before = (paged_decode_attention.launches,
              paged_decode_attention.launches_int8)
    out = paged_decode_attention(q, kq, vq, tables, pos, k_scale=ks,
                                 v_scale=vs)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (before[0],
                                                      before[1] + 1)
    ref = paged_decode_attention_reference(q, kq, vq, tables, pos,
                                           k_scale=ks, v_scale=vs).float()
    assert out.dtype == dtype and out.shape == ref.shape
    limit = tol[0] * float(ref.square().mean().sqrt()) + tol[1] * ref.abs()
    split = paged_attn._launch(q, kq, vq, tables, pos, k_scale=ks,
                               v_scale=vs, route="split")
    for got in (out, split):
        err = (got.float() - ref).abs()
        assert bool((err <= limit).all()), float((err / limit).max())


def test_paged_attn_int8_stale_cells_and_scratch_are_inert(hopper):
    """int8 cells past each row's cursor set to 127 with scales 1e4, and
    the same garbage in the scratch page and its scales, change no bit of
    the split kernel (this bf16 shape routes to the decode kernel, whose
    own test is test_paged_decode_stale_cells_and_scratch_are_inert)."""
    rng = np.random.default_rng(13)
    q, kq, vq, tables, pos, ks, vs = _int8_on(
        hopper, torch.bfloat16, *_case(rng, 3, 2, 8, 2, 64, 16, 6, 64))
    base = paged_attn._launch(q, kq, vq, tables, pos, k_scale=ks,
                              v_scale=vs, route="split")
    kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
    bt = kq.shape[1]
    for bi in range(tables.shape[0]):
        cursor = int(pos[bi].max())
        for blk in range(tables.shape[1]):
            for t in range(bt):
                if blk * bt + t > cursor:
                    page = int(tables[bi, blk])
                    kq2[page, t], vq2[page, t] = 127, 127
                    ks2[page, t], vs2[page, t] = 1e4, 1e4
    kq2[0], vq2[0], ks2[0], vs2[0] = 127, 127, 1e4, 1e4
    out = paged_attn._launch(q, kq2, vq2, tables, pos, k_scale=ks2,
                             v_scale=vs2, route="split")
    assert torch.equal(out, base)


def test_paged_attn_int8_rejects_what_the_kernel_cannot_take(hopper):
    """int8 pools on the card never reach the plain version: a head_dim
    that is not a multiple of 16 and f64 scales raise."""
    rng = np.random.default_rng(17)
    q, kq, vq, tables, pos, ks, vs = _int8_on(
        hopper, torch.float32, *_case(rng, 2, 1, 4, 2, 16, 8, 4, 8))
    with pytest.raises(ValueError, match="multiple of 16"):
        paged_decode_attention(q, kq, vq, tables, pos, k_scale=ks,
                               v_scale=vs)
    q, kq, vq, tables, pos, ks, vs = _int8_on(
        hopper, torch.float32, *_case(rng, 2, 1, 4, 2, 16, 8, 4, 16))
    with pytest.raises(TypeError, match="float32"):
        paged_decode_attention(q, kq, vq, tables, pos, k_scale=ks.double(),
                               v_scale=vs.double())


# The prefill route (csrc/paged_prefill.cu): (b, sq, h, hkv, pages,
# page_tokens, n_blocks, head_dim). Llama-3 8B's heads at pages of 8, 16,
# 32 and 64 tokens and of 24 (not a power of two), sq 16 (one 64-row
# tile), 64 and 512, B 1-3 with live lengths drawn across the table (rarely
# a multiple of the 64-key tile); then head_dim 64 with groups of 3 and 8.
PREFILL_SHAPES = [
    (1, 16, 32, 8, 80, 8, 64, 128),
    (2, 64, 32, 8, 100, 16, 40, 128),
    (3, 64, 32, 8, 120, 32, 24, 128),
    (1, 512, 32, 8, 40, 64, 30, 128),
    (2, 512, 32, 8, 100, 32, 48, 128),
    (2, 64, 32, 8, 100, 24, 30, 128),
    (2, 64, 12, 4, 80, 16, 20, 64),
    (3, 16, 16, 2, 100, 8, 30, 64),
]


def _prefill_args(dev, shape, quant, seed):
    rng = np.random.default_rng(seed)
    arrays = _case(rng, *shape)
    if quant:
        q, kq, vq, tables, pos, ks, vs = _int8_on(dev, torch.bfloat16,
                                                  *arrays)
        return (q, kq, vq, tables, pos), dict(k_scale=ks, v_scale=vs)
    return _on(dev, torch.bfloat16, *arrays), {}


def _counts():
    f = paged_decode_attention
    return (f.launches, f.launches_int8, f.launches_prefill,
            f.launches_prefill_int8)


def _assert_prefill_close(out, ref, quant):
    """fp: 2e-2, as the split kernel (p rounded to bf16 at the running max
    against normalized probabilities, O(1) outputs rounded to bf16). int8:
    per element INT8_DTYPES' bf16 limit; the kernel's split of p x v_scale
    into two bf16 halves keeps about 2^-16 of it, far inside one bf16
    step of the output."""
    ref = ref.float()
    if not quant:
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
        return
    atol, rtol = INT8_DTYPES[1][1]
    limit = atol * float(ref.square().mean().sqrt()) + rtol * ref.abs()
    err = (out.float() - ref).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("shape", PREFILL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_paged_prefill_matches_reference(hopper, quant, shape):
    b, sq, h, hkv, _, _, _, hd = shape
    assert paged_attn._route(sq, h // hkv, hd, torch.bfloat16,
                             quant) == "prefill"
    args, kw = _prefill_args(hopper, shape, quant, sum(shape) + quant)
    before = _counts()
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_counts(), before)]
    assert moved == ([0, 1, 0, 1] if quant else [1, 0, 1, 0])
    ref = paged_decode_attention_reference(*args, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    _assert_prefill_close(out, ref, quant)
    # Both row tiles give the same bits: a row's arithmetic does not
    # depend on the rows it shares a CTA with.
    for rows in (64, 128):
        again = paged_attn._launch(*args, **kw, route="prefill",
                                   tile_rows=rows)
        assert torch.equal(again, out), rows


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_prefill_long_table_slides_the_window(hopper, quant):
    """A table of 1,500 two-token blocks is longer than the 1,024 entries
    the kernel caches: cursors near its end make it slide the window."""
    shape = (2, 64, 8, 2, 3100, 2, 1500, 64)
    args, kw = _prefill_args(hopper, shape, quant, 43)
    q, pk, pv, tables, pos = args
    pos.copy_(torch.tensor([2950, 2500], dtype=torch.int32,
                           device=pos.device)[:, None]
              - torch.arange(63, -1, -1, dtype=torch.int32,
                             device=pos.device))
    out = paged_decode_attention(q, pk, pv, tables, pos, **kw)
    _assert_prefill_close(out, paged_decode_attention_reference(
        q, pk, pv, tables, pos, **kw), quant)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_prefill_stale_cells_and_scratch_are_inert(hopper, quant):
    """Every cell past each row's cursor (fp: +-1e4; int8: 127 with scales
    1e4), the blocks past the live length pointed at the scratch page, and
    garbage in the scratch page change no output bit of the prefill
    route."""
    shape = (3, 64, 32, 8, 120, 16, 24, 128)
    args, kw = _prefill_args(hopper, shape, quant, 29)
    q, pk, pv, tables, pos = args
    before = _counts()[2:]
    base = paged_decode_attention(*args, **kw)
    pk2, pv2, t2 = pk.clone(), pv.clone(), tables.clone()
    kw2 = {k: v.clone() for k, v in kw.items()}
    bt = pk.shape[1]
    for bi in range(tables.shape[0]):
        cursor = int(pos[bi].max())
        for blk in range(tables.shape[1]):
            page = int(tables[bi, blk])
            for t in range(bt):
                if blk * bt + t > cursor:
                    pk2[page, t] = 127 if quant else 1e4
                    pv2[page, t] = 127 if quant else -1e4
                    for v in kw2.values():
                        v[page, t] = 1e4
            if blk * bt > cursor:
                t2[bi, blk] = 0
    pk2[0], pv2[0] = (127, 127) if quant else (1e4, -1e4)
    for v in kw2.values():
        v[0] = 1e4
    out = paged_decode_attention(q, pk2, pv2, t2, pos, **kw2)
    assert torch.equal(out, base)
    assert [a - b for a, b in zip(_counts()[2:], before)] == (
        [0, 2] if quant else [2, 0])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_prefill_fully_masked_row_is_zero(hopper, quant):
    args, kw = _prefill_args(hopper, (2, 16, 32, 8, 80, 16, 20, 128),
                             quant, 31)
    q, pk, pv, tables, pos = args
    pos[0, 3] = -1
    pos[1] = -1                       # a whole batch row sees nothing
    out = paged_decode_attention(q, pk, pv, tables, pos, **kw)
    assert torch.all(out[0, 3] == 0) and torch.all(out[1] == 0)
    assert torch.isfinite(out).all()
    _assert_prefill_close(out, paged_decode_attention_reference(
        q, pk, pv, tables, pos, **kw), quant)


def test_paged_prefill_refuses_and_does_not_fall_back(hopper):
    """What the prefill kernel does not take raises, from the public
    function and from the private launcher, and nothing launches: no
    other kernel and no plain version takes over."""
    args, _ = _prefill_args(hopper, (1, 64, 32, 8, 40, 16, 20, 128),
                            False, 37)
    q, pk, pv, tables, pos = args
    before = _counts()
    raw = torch.empty(q.numel() + 4, dtype=q.dtype, device=q.device)
    q_off = raw[4:].view(q.shape)     # contiguous, 8 bytes off alignment
    q_off.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(q_off, pk, pv, tables, pos)
    with pytest.raises(TypeError, match="bfloat16"):
        paged_attn._launch(q.float(), pk.float(), pv.float(), tables, pos,
                           route="prefill")
    with pytest.raises(ValueError, match="head_dim"):
        paged_attn._launch(q[..., :80].contiguous(),
                           pk.view(40, 16, 8, 128)[..., :80].reshape(
                               40, 16, 640).contiguous(),
                           pv.view(40, 16, 8, 128)[..., :80].reshape(
                               40, 16, 640).contiguous(), tables, pos,
                           route="prefill")
    with pytest.raises(ValueError, match="tile_rows"):
        paged_attn._launch(*args, route="prefill", tile_rows=32)
    torch.cuda.synchronize()
    assert _counts() == before


# The decode route (csrc/paged_decode.cu): (b, sq, h, hkv, pages,
# page_tokens, n_blocks, head_dim, live lengths or None for random ones).
# Groups 1, 3, 4 and 8 at head_dim 64 and 128; verify windows of 2 and 4
# (8 and 16 rows a KV head); pages of 2, 16, 24 (not a power of two) and
# 32 tokens; live lengths from 1 to 8,000, a page and a page and one.
DECODE_SHAPES = [
    (4, 1, 32, 8, 300, 32, 64, 128, None),
    (3, 1, 12, 4, 80, 16, 20, 64, None),
    (2, 1, 16, 16, 60, 16, 25, 128, None),
    (2, 2, 64, 8, 80, 32, 16, 128, None),
    (2, 1, 64, 8, 40, 32, 16, 64, None),
    (1, 4, 16, 4, 60, 24, 20, 128, None),
    (2, 1, 32, 8, 3100, 2, 1500, 128, None),
    (3, 1, 32, 8, 80, 32, 16, 128, [1, 32, 33]),
    (4, 1, 32, 8, 1100, 32, 256, 128, [1, 33, 4000, 8000]),
    (1, 1, 12, 4, 20, 32, 16, 64, [1]),
]


def _lens_case(rng, b, sq, h, hkv, pages, bt, nb, hd, lens):
    """_case with the live lengths given: row i queries the last ``sq``
    positions of its ``lens[i]`` tokens, its blocks on distinct pages."""
    q, pk, pv, _, _ = _case(rng, b, sq, h, hkv, pages, bt, nb, hd)
    tables = np.zeros((b, nb), np.int32)
    free = rng.permutation(np.arange(1, pages))
    used = 0
    for i, n in enumerate(lens):
        k = -(-n // bt)
        tables[i, :k] = free[used:used + k]
        used += k
    pos = (np.asarray(lens)[:, None] - sq + np.arange(sq)[None, :]).astype(
        np.int32)
    return q, pk, pv, tables, pos


def _decode_args(dev, shape, quant, seed):
    rng = np.random.default_rng(seed)
    *dims, lens = shape
    arrays = (_case(rng, *dims) if lens is None
              else _lens_case(rng, *dims, lens))
    if quant:
        q, kq, vq, tables, pos, ks, vs = _int8_on(dev, torch.bfloat16,
                                                  *arrays)
        return (q, kq, vq, tables, pos), dict(k_scale=ks, v_scale=vs)
    return _on(dev, torch.bfloat16, *arrays), {}


def _decode_counts():
    f = paged_decode_attention
    return (f.launches, f.launches_int8, f.launches_decode,
            f.launches_decode_int8)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:8])))
def test_paged_decode_matches_reference(hopper, quant, shape):
    """The decode kernel against the plain version (fp: 2e-2, as the split
    kernel; int8: INT8_DTYPES' bf16 limit), one launch counted on its
    route, and a second launch bitwise equal."""
    b, sq, h, hkv, _, _, _, hd, _ = shape
    assert paged_attn._route(sq, h // hkv, hd, torch.bfloat16,
                             quant) == "decode"
    args, kw = _decode_args(hopper, shape, quant, sum(shape[:8]) + quant)
    before = _decode_counts()
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_decode_counts(), before)]
    assert moved == ([0, 1, 0, 1] if quant else [1, 0, 1, 0])
    ref = paged_decode_attention_reference(*args, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    _assert_prefill_close(out, ref, quant)
    again = paged_attn._launch(*args, **kw, route="decode")
    assert torch.equal(again, out)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_decode_stale_cells_and_scratch_are_inert(hopper, quant):
    """Every cell past each row's cursor (fp: +-1e4; int8: 127 with scales
    1e4), the blocks past the live length pointed at the scratch page, and
    garbage in the scratch page change no output bit of the decode route,
    at a verify window of 2 (cursors that differ within a row)."""
    shape = (3, 2, 32, 8, 120, 16, 24, 128, [350, 300, 17])
    args, kw = _decode_args(hopper, shape, quant, 29)
    q, pk, pv, tables, pos = args
    before = _decode_counts()[2:]
    base = paged_decode_attention(*args, **kw)
    pk2, pv2, t2 = pk.clone(), pv.clone(), tables.clone()
    kw2 = {k: v.clone() for k, v in kw.items()}
    bt = pk.shape[1]
    for bi in range(tables.shape[0]):
        cursor = int(pos[bi].max())
        for blk in range(tables.shape[1]):
            page = int(tables[bi, blk])
            for t in range(bt):
                if blk * bt + t > cursor:
                    pk2[page, t] = 127 if quant else 1e4
                    pv2[page, t] = 127 if quant else -1e4
                    for v in kw2.values():
                        v[page, t] = 1e4
            if blk * bt > cursor:
                t2[bi, blk] = 0
    pk2[0], pv2[0] = (127, 127) if quant else (1e4, -1e4)
    for v in kw2.values():
        v[0] = 1e4
    out = paged_decode_attention(q, pk2, pv2, t2, pos, **kw2)
    assert torch.equal(out, base)
    assert [a - b for a, b in zip(_decode_counts()[2:], before)] == (
        [0, 2] if quant else [2, 0])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_decode_fully_masked_row_is_zero(hopper, quant):
    args, kw = _decode_args(hopper, (3, 2, 32, 8, 80, 16, 20, 128, None),
                            quant, 31)
    q, pk, pv, tables, pos = args
    pos[0, 1] = -1
    pos[1] = -1                       # a whole batch row sees nothing
    out = paged_decode_attention(q, pk, pv, tables, pos, **kw)
    assert torch.all(out[0, 1] == 0) and torch.all(out[1] == 0)
    assert torch.isfinite(out).all()
    _assert_prefill_close(out, paged_decode_attention_reference(
        q, pk, pv, tables, pos, **kw), quant)


def test_paged_decode_launches_count_by_route(hopper):
    """A decode-shaped bf16 call counts on the decode route; the same
    inputs through the split kernel forced, and an f32 call, count on the
    branch alone."""
    shape = (2, 1, 32, 8, 80, 32, 16, 128, None)
    for quant in (False, True):
        args, kw = _decode_args(hopper, shape, quant, 41)
        branch = [0, 1] if quant else [1, 0]
        for call, on_decode in (
                (lambda: paged_decode_attention(*args, **kw), True),
                (lambda: paged_attn._launch(*args, **kw, route="split"),
                 False),
                (lambda: paged_decode_attention(
                    args[0].float(), *args[1:], **kw) if quant else
                 paged_decode_attention(args[0].float(), args[1].float(),
                                        args[2].float(), *args[3:]),
                 False)):
            before = _decode_counts()
            call()
            moved = [a - b for a, b in zip(_decode_counts(), before)]
            assert moved == branch + ([x * on_decode for x in branch])


def test_paged_decode_refuses_and_does_not_fall_back(hopper):
    """What the decode kernel does not take raises, from the public
    function and from the private launcher, and nothing launches."""
    args, _ = _decode_args(hopper, (2, 1, 32, 8, 48, 16, 20, 128, None),
                           False, 37)
    q, pk, pv, tables, pos = args
    before = _decode_counts()
    raw = torch.empty(q.numel() + 4, dtype=q.dtype, device=q.device)
    q_off = raw[4:].view(q.shape)     # contiguous, 8 bytes off alignment
    q_off.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(q_off, pk, pv, tables, pos)
    with pytest.raises(TypeError, match="bfloat16"):
        paged_attn._launch(q.float(), pk.float(), pv.float(), tables, pos,
                           route="decode")
    with pytest.raises(ValueError, match="head_dim"):
        paged_attn._launch(q[..., :80].contiguous(),
                           pk.view(48, 16, 8, 128)[..., :80].reshape(
                               48, 16, 640).contiguous(),
                           pv.view(48, 16, 8, 128)[..., :80].reshape(
                               48, 16, 640).contiguous(), tables, pos,
                           route="decode")
    wide = q.expand(2, 5, 32, 128).contiguous()      # 5 x 4 = 20 rows
    with pytest.raises(ValueError, match="sq x group"):
        paged_attn._launch(wide, pk, pv, tables, pos.expand(2, 5).contiguous(),
                           route="decode")
    with pytest.raises(ValueError, match="route"):
        paged_attn._launch(*args, route="flash")
    torch.cuda.synchronize()
    assert _decode_counts() == before


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


@pytest.mark.parametrize("edit", ["source", "header", "new_header"])
def test_library_name_tracks_the_headers(tmp_path, monkeypatch, edit):
    """In a copy of csrc/, editing a source, editing a header or adding
    one changes the library name of a source that includes the shared
    header (and, for a header, of every source), so no stale library is
    loaded after an edit."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {n: _build.library_path(n) for n in ("flash_fwd", "gmm")}
    if edit == "source":
        path = csrc / "flash_fwd.cu"
    elif edit == "header":
        path = csrc / "wgmma.cuh"
    else:
        path = csrc / "extra.cuh"
        path.write_text("")
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["flash_fwd"] != before["flash_fwd"]
    assert (after["gmm"] != before["gmm"]) == (edit != "source")


# Flash attention: (b, sq, sk, h, hkv, head_dim, causal, segments). The JAX
# kernel tests' shapes (GQA 4/2, MQA 4/1, 12/4; sq != sk both ways;
# segments), ragged lengths that cut the 64-row and 64-key tiles, then
# Llama-3 8B's heads at training length.
FLASH_SHAPES = [
    (2, 64, 64, 2, 2, 16, False, False),
    (2, 64, 64, 4, 2, 16, True, False),
    (2, 32, 32, 4, 1, 32, True, False),
    (2, 32, 32, 12, 4, 16, True, True),
    (2, 32, 128, 4, 2, 64, True, False),
    (2, 128, 32, 4, 2, 64, True, False),
    (3, 100, 77, 6, 2, 64, False, True),
    (1, 77, 100, 8, 8, 128, True, True),
    (1, 2048, 2048, 32, 8, 128, True, False),
    (1, 512, 2048, 32, 8, 128, True, False),
]
# (atol, rtol), held per element: |kernel - plain| <= atol * scale +
# rtol * |plain|, the scale being the larger of the RMS of the element's
# row (one position's and head's head_dim vector) and the output's RMS, as
# chip_smoke.py's phase D holds them. rtol covers one bf16 rounding step of
# the output (<= 2^-7 of the value); atol the rounding of p (forward) or dS
# (backward) to bf16 at different points in the kernel and the plain
# version, or in f32 the order of the sums.
FLASH_DTYPES = [(torch.float32, (1e-4, 1e-4)),
                (torch.bfloat16, (2 ** -5, 2 ** -6))]


def _flash_inputs(dev, dtype, shape, seed):
    b, sq, sk, h, hkv, d, causal, seg = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((b, sq, h, d), (b, sk, hkv, d),
                                         (b, sk, hkv, d)))
    do = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(
        np.float32)).to(dev, dtype)
    segq = segk = None
    if seg:
        segk = np.sort(rng.integers(0, 3, (b, sk)), axis=1).astype(np.int32)
        segq = np.sort(rng.integers(0, 3, (b, sq)), axis=1).astype(np.int32)
        segq, segk = (torch.from_numpy(x).to(dev) for x in (segq, segk))
    return q, k, v, do, segq, segk, causal


def _close(got, want, tol, what):
    atol, rtol = tol
    ref = want.float()
    err = (got.float() - ref).abs()
    scale = ref.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(ref.square().mean().sqrt()))
    share = float((err / (atol * scale + rtol * ref.abs())).max())
    assert share <= 1.0, (
        f"{what}: |kernel - plain| reaches {share} of the limit {atol} x "
        f"max(rms(row), rms) + {rtol} x |plain| (max err "
        f"{float(err.max())})")


@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_kernels_match_reference(hopper, dtype, tol, shape):
    """Forward (o and lse) and both backward kernels against the plain
    versions on the same inputs; each wrapper launches once."""
    q, k, v, do, segq, segk, causal = _flash_inputs(hopper, dtype, shape,
                                                    sum(shape[:6]))
    scale = q.shape[-1] ** -0.5
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, segq, segk, causal, scale)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, q_segment_ids=segq, kv_segment_ids=segk)
    _close(o, ref_o, tol, "o")
    seen = ref_lse > -1e29                   # rows that see some key
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3, rtol=0)
    assert torch.equal(lse <= -1e29, ~seen)
    dq, dk, dv = fa.flash_backward(q, k, v, ref_o, ref_lse, do, segq, segk,
                                   causal, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(
        q, k, v, ref_o, ref_lse, do, causal=causal, q_segment_ids=segq,
        kv_segment_ids=segk)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        _close(got, ref, tol, name)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


def test_flash_fully_masked_rows_are_zero(hopper):
    """A query whose segment id no key carries, and causal rows with
    sq > sk that see no column, give exactly 0 in O and in every grad."""
    q, k, v, do, segq, segk, _ = _flash_inputs(
        hopper, torch.float32, (2, 48, 32, 4, 2, 64, True, True), 9)
    segq[0, 20:25] = 7
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    o = fa.flash_attention(q, k, v, causal=True, q_segment_ids=segq,
                           kv_segment_ids=segk)
    o.backward(do)
    for rows in (slice(0, 16), slice(20, 25)):   # 0..15: sq - sk = 16
        assert torch.all(o[0, rows] == 0)
        assert torch.all(q.grad[0, rows] == 0)
    assert torch.isfinite(o).all() and torch.isfinite(k.grad).all()


def test_flash_rejects_what_the_kernels_cannot_take(hopper):
    q, k, v, _, _, _, _ = _flash_inputs(
        hopper, torch.float32, (1, 16, 16, 2, 2, 64, True, False), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)


# The tensor-core backward (csrc/flash_bwd.cu, the "wgmma" route): bf16 at
# head_dim 64 and 128. (b, sq, sk, h, hkv, head_dim, causal, segments):
# groups 1, 3 and 4, causal and not, sq < sk, sq > sk (rows that see no
# key), segment ids, lengths that cut the 64-row and 64-key tiles, then
# MoE H's attention (12/4 heads at 64) and Llama-3 8B's at training length.
FLASH_BWD_SHAPES = [
    (2, 128, 128, 4, 4, 64, True, False),
    (1, 128, 128, 8, 2, 128, False, False),
    (1, 64, 192, 8, 2, 128, True, False),
    (1, 200, 100, 8, 2, 128, True, False),
    (1, 160, 160, 6, 2, 64, True, True),
    (2, 96, 96, 4, 1, 128, True, True),
    (1, 96, 96, 3, 3, 128, False, False),
    (2, 1024, 1024, 12, 4, 64, True, False),
    (1, 2048, 2048, 32, 8, 128, True, False),
    (1, 512, 2048, 32, 8, 128, True, True),
]


def _flash_bwd_case(dev, shape, seed):
    """bf16 inputs, the plain forward's o and lse, delta, and the plain
    backward: (args of the backward wrappers, (dq, dk, dv) wanted)."""
    q, k, v, do, segq, segk, causal = _flash_inputs(
        dev, torch.bfloat16, shape, seed)
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_attention_reference(
        q, k, v, causal=causal, q_segment_ids=segq, kv_segment_ids=segk)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    want = fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=causal, q_segment_ids=segq,
        kv_segment_ids=segk)
    return (q, k, v, do, lse, delta, segq, segk, causal, scale), want


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_bwd_wgmma_matches_reference(hopper, shape):
    """dQ and dK/dV on the wgmma route against the plain backward, held as
    phase D holds them."""
    args, want = _flash_bwd_case(hopper, shape, sum(shape[:6]))
    dq = fa.flash_bwd_dq(*args, route="wgmma")
    dk, dv = fa.flash_bwd_dkv(*args, route="wgmma")
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.isfinite(got.float()).all(), name
        _close(got, ref, FLASH_DTYPES[1][1], name)


def test_flash_bwd_wgmma_launches_give_the_same_bits(hopper):
    """Three launches give the same bits: every sum runs in one fixed
    order, with no atomics."""
    args, _ = _flash_bwd_case(hopper, (2, 1024, 1024, 12, 4, 64, True, True),
                              5)
    outs = [(fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_flash_bwd_wgmma_fully_masked_rows_are_zero(hopper):
    """A query whose segment id no key carries, and causal rows with
    sq > sk that see no key, give exactly 0 in dQ; keys no query sees give
    exactly 0 in dK and dV."""
    q, k, v, do, segq, segk, _ = _flash_inputs(
        hopper, torch.bfloat16, (2, 96, 64, 8, 2, 128, True, True), 9)
    segq[0, 40:45] = 7
    segk[1, 10:20] = 8
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_attention_reference(
        q, k, v, causal=True, q_segment_ids=segq, kv_segment_ids=segk)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, segq, segk, True, scale)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    for rows in (slice(0, 32), slice(40, 45)):    # 0..31: sq - sk = 32
        assert torch.all(dq[0, rows] == 0)
    assert torch.all(dk[1, 10:20] == 0) and torch.all(dv[1, 10:20] == 0)
    assert torch.isfinite(dk.float()).all() and torch.isfinite(dq.float()).all()


def test_flash_bwd_launches_wgmma_counts_by_route(hopper):
    """bf16 at head_dim 64/128 counts on launches and launches_wgmma; f32,
    head_dim 32 and a forced "mma" route count on launches alone; the
    autograd backward takes the wgmma route."""
    def counts():
        return (fa.flash_bwd_dq.launches, fa.flash_bwd_dq.launches_wgmma,
                fa.flash_bwd_dkv.launches, fa.flash_bwd_dkv.launches_wgmma)

    args, _ = _flash_bwd_case(hopper, (1, 64, 64, 4, 2, 64, True, False), 2)
    for kw, step in (({}, (1, 1, 1, 1)), ({"route": "mma"}, (1, 0, 1, 0))):
        before = counts()
        fa.flash_bwd_dq(*args, **kw)
        fa.flash_bwd_dkv(*args, **kw)
        assert counts() == tuple(a + b for a, b in zip(before, step))
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32)):
        q, k, v, do, _, _, _ = _flash_inputs(
            hopper, dtype, (1, 64, 64, 4, 2, d, True, False), 3)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before = counts()
        fa.flash_attention(q, k, v, causal=True).backward(do)
        assert counts() == tuple(a + b for a, b in zip(before, (1, 0, 1, 0)))
    q, k, v, do, _, _, _ = _flash_inputs(
        hopper, torch.bfloat16, (1, 64, 64, 4, 2, 128, True, False), 4)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = counts()
    fa.flash_attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    assert counts() == tuple(a + b for a, b in zip(before, (1, 1, 1, 1)))


def test_flash_bwd_refuses_and_does_not_fall_back(hopper):
    """A non-contiguous input, mixed dtypes and a forced wgmma route in
    f32 raise before any launch: no path gives way to the mma kernels or
    to the plain version."""
    args, _ = _flash_bwd_case(hopper, (1, 64, 64, 4, 2, 128, True, False), 6)
    q, k, v, do, lse, delta, segq, segk, causal, scale = args
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="contiguous"):
            fn(strided, k, v, do, lse, delta, segq, segk, causal, scale)
        with pytest.raises(TypeError, match="must be torch.bfloat16"):
            fn(q, k.float(), v, do, lse, delta, segq, segk, causal, scale)
        with pytest.raises(TypeError, match="wgmma route takes bfloat16"):
            fn(q.float(), k.float(), v.float(), do.float(), lse, delta,
               segq, segk, causal, scale, route="wgmma")
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


# The tensor-core forward (csrc/flash_fwd.cu, the "wgmma" route): bf16 at
# head_dim 64 and 128, over FLASH_SHAPES at those head dims and the
# backward's shapes (groups 1, 3 and 4, sq > sk, MoE H's and Llama-3 8B's
# attention).
FLASH_FWD_SHAPES = [s for s in FLASH_SHAPES if s[5] in fa.WGMMA_HEAD_DIMS] \
    + [s for s in FLASH_BWD_SHAPES if s not in FLASH_SHAPES]


def _fwd_counts():
    return fa.flash_fwd.launches, fa.flash_fwd.launches_wgmma


@pytest.mark.parametrize("shape", FLASH_FWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_fwd_wgmma_matches_reference(hopper, shape):
    """O and lse on the wgmma route against the plain forward, held as
    phase D holds them; rows that see no key match exactly."""
    q, k, v, _, segq, segk, causal = _flash_inputs(
        hopper, torch.bfloat16, shape, sum(shape[:6]))
    scale = q.shape[-1] ** -0.5
    before = _fwd_counts()
    o, lse = fa.flash_fwd(q, k, v, segq, segk, causal, scale, route="wgmma")
    torch.cuda.synchronize()
    assert _fwd_counts() == (before[0] + 1, before[1] + 1)
    ref_o, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, q_segment_ids=segq, kv_segment_ids=segk)
    assert o.dtype == torch.bfloat16 and o.shape == ref_o.shape
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    _close(o, ref_o, FLASH_DTYPES[1][1], "o")
    seen = ref_lse > -1e29
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3, rtol=0)
    assert torch.equal(lse[~seen], ref_lse[~seen])
    blind = ~seen.transpose(1, 2)                  # [B, sq, H]
    assert torch.all(o[blind] == 0)


def test_flash_fwd_wgmma_fully_masked_rows_are_zero(hopper):
    """A query whose segment id no key carries, and causal rows with
    sq > sk that see no key, give exactly 0 in O and lse = -1e30, the
    plain version's; the backward reading that lse gives 0 in dQ."""
    q, k, v, do, segq, segk, _ = _flash_inputs(
        hopper, torch.bfloat16, (2, 96, 64, 8, 2, 128, True, True), 9)
    segq[0, 40:45] = 7
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, segq, segk, True, scale)
    torch.cuda.synchronize()
    _, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=True, q_segment_ids=segq, kv_segment_ids=segk)
    for rows in (slice(0, 32), slice(40, 45)):    # 0..31: sq - sk = 32
        assert torch.all(o[0, rows] == 0)
        assert torch.equal(lse[0, :, rows], ref_lse[0, :, rows])
        assert torch.all(lse[0, :, rows] <= -1e29)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, segq, segk, True, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(dq.float()).all()
    for rows in (slice(0, 32), slice(40, 45)):
        assert torch.all(dq[0, rows] == 0)


def test_flash_fwd_wgmma_launches_give_the_same_bits(hopper):
    """Three launches give the same bits."""
    q, k, v, _, segq, segk, _ = _flash_inputs(
        hopper, torch.bfloat16, (2, 1024, 1024, 12, 4, 64, True, True), 5)
    outs = [fa.flash_fwd(q, k, v, segq, segk, True, 0.125)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_flash_fwd_launches_wgmma_counts_by_route(hopper):
    """bf16 at head_dim 64/128 counts on launches and launches_wgmma; f32,
    head_dim 32 and a forced "mma" route count on launches alone; the
    autograd forward takes the wgmma route."""
    q, k, v, _, _, _, _ = _flash_inputs(
        hopper, torch.bfloat16, (1, 64, 64, 4, 2, 64, True, False), 2)
    for kw, step in (({}, (1, 1)), ({"route": "mma"}, (1, 0))):
        before = _fwd_counts()
        fa.flash_fwd(q, k, v, None, None, True, 0.125, **kw)
        assert _fwd_counts() == (before[0] + step[0], before[1] + step[1])
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32)):
        q, k, v, _, _, _, _ = _flash_inputs(
            hopper, dtype, (1, 64, 64, 4, 2, d, True, False), 3)
        before = _fwd_counts()
        fa.flash_attention(q, k, v, causal=True)
        assert _fwd_counts() == (before[0] + 1, before[1])
    q, k, v, _, _, _, _ = _flash_inputs(
        hopper, torch.bfloat16, (1, 64, 64, 4, 2, 128, True, False), 4)
    before = _fwd_counts()
    fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _fwd_counts() == (before[0] + 1, before[1] + 1)


def test_flash_fwd_refuses_and_does_not_fall_back(hopper):
    """A forced wgmma route in f32 or at head_dim 32, a non-contiguous
    input and mixed dtypes raise before any launch: no path gives way to
    the mma kernel or to the plain version."""
    q, k, v, _, _, _, _ = _flash_inputs(
        hopper, torch.bfloat16, (1, 64, 64, 4, 2, 128, True, False), 6)
    before = _fwd_counts()
    with pytest.raises(TypeError, match="wgmma route takes bfloat16"):
        fa.flash_fwd(q.float(), k.float(), v.float(), None, None, True,
                     0.125, route="wgmma")
    with pytest.raises(TypeError, match="wgmma route takes bfloat16"):
        fa.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                     v[..., :32].contiguous(), None, None, True, 0.125,
                     route="wgmma")
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(strided, k, v, None, None, True, 0.125)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        fa.flash_fwd(q, k.float(), v, None, None, True, 0.125)
    with pytest.raises(ValueError, match="route must be"):
        fa.flash_fwd(q, k, v, None, None, True, 0.125, route="sdpa")
    torch.cuda.synchronize()
    assert _fwd_counts() == before


# Grouped matmul: (group sizes, K, N, block_m). The JAX kernel tests'
# layouts (an empty group, everything in one expert), contraction and
# column sizes that cut the 32-deep and 128-wide tiles, a block_m of two
# row tiles, and the MoE training shapes (8 experts, 16,384 routed rows,
# K 768 -> N 2048).
GMM_SHAPES = [
    ((100, 0, 300, 57), 128, 256, 128),
    ((0, 0, 0, 512), 128, 256, 128),
    ((37, 290, 1, 0, 200), 72, 200, 128),
    ((500, 3, 260, 129), 64, 136, 256),
    ((1800, 2500, 1900, 2200, 2000, 1700, 2300, 1984), 768, 2048, 128),
]
# (atol, rtol), held per element: |kernel - plain| <= atol * rms(plain) +
# rtol * |plain|. Both sum f32 products; f32: the order of the sums over
# up to a few thousand terms. bf16: both round their f32 sums to bf16, one
# bf16 step (2^-8 of the value) apart where the sums straddle a rounding
# boundary.
GMM_DTYPES = [(torch.float32, (1e-5, 1e-5)),
              (torch.bfloat16, (2 ** -10, 2 ** -7))]


def _gmm_inputs(dev, dtype, sizes, k, n, bm, seed):
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    rng = np.random.default_rng(seed)
    lay = g.grouped_layout(torch.tensor(sizes, dtype=torch.int32, device=dev),
                           int(sum(sizes)), block_m=bm)
    lhs = np.zeros((lay.m_pad, k), np.float32)
    off = lay.row_offset.cpu().numpy()
    for i, s in enumerate(sizes):
        lhs[off[i]:off[i] + s] = rng.standard_normal((s, k))
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    cot = np.zeros((lay.m_pad, n), np.float32)
    live = g.live_rows(lay).cpu().numpy()
    cot[live] = rng.standard_normal((int(live.sum()), n))
    return lay, *(torch.from_numpy(x).to(dev, dtype) for x in (lhs, rhs, cot))


def _within(got, want, tol, what):
    atol, rtol = tol
    ref = want.float()
    err = (got.float() - ref).abs()
    scale = float(ref.square().mean().sqrt())
    share = float((err / (atol * scale + rtol * ref.abs())).max())
    assert share <= 1.0, (
        f"{what}: |kernel - plain| reaches {share} of the limit {atol} x "
        f"rms + {rtol} x |plain| (max err {float(err.max())})")


@pytest.mark.parametrize("dtype,tol", GMM_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GMM_SHAPES,
                         ids=lambda s: f"E{len(s[0])}-K{s[1]}-N{s[2]}-"
                         f"bm{s[3]}")
def test_gmm_kernels_match_reference(hopper, dtype, tol, shape):
    """gmm (and its transposed-weight form, the backward's dlhs) and tgmm
    against their plain versions; dead blocks exactly 0; one launch each."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    torch.backends.cuda.matmul.allow_tf32 = False
    sizes, k, n, bm = shape
    lay, lhs, rhs, cot = _gmm_inputs(hopper, dtype, sizes, k, n, bm,
                                     sum(sizes) + k)
    before = (g.gmm_forward.launches, g.tgmm.launches)
    out = g.gmm_forward(lhs, rhs, lay)
    dlhs = g.gmm_forward(cot, rhs, lay, transpose_rhs=True)
    drhs = g.tgmm(lhs, cot, len(sizes), lay)
    torch.cuda.synchronize()
    assert (g.gmm_forward.launches, g.tgmm.launches) == (before[0] + 2,
                                                         before[1] + 1)
    for name, got, want in (
            ("out", out, g.gmm_reference(lhs, rhs, lay)),
            ("dlhs", dlhs, g.gmm_reference(cot, rhs, lay,
                                           transpose_rhs=True)),
            ("drhs", drhs, g.tgmm_reference(lhs, cot, len(sizes), lay))):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
        _within(got, want, tol, name)
    dead = ~g.live_rows(lay)
    assert torch.all(out[dead] == 0) and torch.all(dlhs[dead] == 0)
    for e, s in enumerate(sizes):
        if s == 0:
            assert torch.all(drhs[e] == 0)


def test_gmm_autograd_runs_the_kernels(hopper):
    """Through GroupedMatmul on the card: the forward and dlhs launch
    gmm_kernel, drhs tgmm_kernel; gradients in the primal dtypes."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.bfloat16, (70, 0, 190),
                                     64, 128, 128, 3)
    lhs.requires_grad_(), rhs.requires_grad_()
    before = (g.gmm_forward.launches, g.tgmm.launches)
    (g.gmm(lhs, rhs, lay).float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    assert (g.gmm_forward.launches, g.tgmm.launches) == (before[0] + 2,
                                                         before[1] + 1)
    assert lhs.grad.dtype == rhs.grad.dtype == torch.bfloat16
    _within(rhs.grad, g.tgmm_reference(lhs.detach(), cot, 3, lay),
            GMM_DTYPES[1][1], "drhs")


def test_gmm_rejects_what_the_kernels_cannot_take(hopper):
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.float32, (30, 9), 64, 64,
                                     128, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        g.gmm_forward(lhs.half(), rhs.half(), lay)
    with pytest.raises(TypeError, match="rhs must be"):
        g.gmm_forward(lhs, rhs.bfloat16(), lay)
    with pytest.raises(ValueError, match="contiguous"):
        g.gmm_forward(lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2),
                      lay)
    with pytest.raises(ValueError, match="multiple of 8"):
        g.gmm_forward(lhs[:, :60].contiguous(), rhs[:, :60].contiguous(),
                      lay)
    small = g.grouped_layout(lay.group_sizes, 39, block_m=64)
    with pytest.raises(ValueError, match="row tile"):
        g.tgmm(torch.zeros(small.m_pad, 64, device=hopper),
               torch.zeros(small.m_pad, 64, device=hopper), 2, small)


# The tensor-core grouped GEMMs (csrc/gmm_wgmma.cu, the "wgmma" route):
# bf16 over GMM_SHAPES and the MoE slice's down product (K 2048 -> N 768).
GMM_WGMMA_SHAPES = GMM_SHAPES + [(GMM_SHAPES[-1][0], 2048, 768, 128)]
# A skewed layout at widths that cut the 64-deep stage and the 128-wide
# tile: an empty expert, a one-row expert, one with 40 % of the rows.
GMM_SKEWED = ((240, 0, 1, 200, 159), 136, 200, 128)


def _gmm_counts():
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    return (g.gmm_forward.launches, g.gmm_forward.launches_wgmma,
            g.tgmm.launches, g.tgmm.launches_wgmma)


@pytest.mark.parametrize("shape", GMM_WGMMA_SHAPES,
                         ids=lambda s: f"E{len(s[0])}-K{s[1]}-N{s[2]}-"
                         f"bm{s[3]}")
def test_gmm_wgmma_matches_reference(hopper, shape):
    """Forward, dlhs and tgmm on the wgmma route against their plain
    versions, held as phase G holds them; rows that hold no token and an
    empty expert's gradient exactly 0."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    sizes, k, n, bm = shape
    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.bfloat16, sizes, k, n, bm,
                                     sum(sizes) + k + 1)
    before = _gmm_counts()
    out = g.gmm_forward(lhs, rhs, lay, route="wgmma")
    dlhs = g.gmm_forward(cot, rhs, lay, transpose_rhs=True, route="wgmma")
    drhs = g.tgmm(lhs, cot, len(sizes), lay, route="wgmma")
    torch.cuda.synchronize()
    assert _gmm_counts() == (before[0] + 2, before[1] + 2, before[2] + 1,
                             before[3] + 1)
    for name, got, want in (
            ("out", out, g.gmm_reference(lhs, rhs, lay)),
            ("dlhs", dlhs, g.gmm_reference(cot, rhs, lay,
                                           transpose_rhs=True)),
            ("drhs", drhs, g.tgmm_reference(lhs, cot, len(sizes), lay))):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
        _within(got, want, GMM_DTYPES[1][1], name)
    dead = ~g.live_rows(lay)
    assert torch.all(out[dead] == 0) and torch.all(dlhs[dead] == 0)
    for e, s in enumerate(sizes):
        if s == 0:
            assert torch.all(drhs[e] == 0)


def test_gmm_wgmma_dead_blocks_and_empty_experts_are_zero(hopper):
    """Whatever a dead block holds, gmm writes 0 over it and tgmm leaves it
    out; an empty expert's gradient is 0 and the rows of live blocks count
    as they are (the Pallas kernels' block semantics)."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    sizes, k, n, bm = GMM_SKEWED
    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.bfloat16, sizes, k, n, bm,
                                     11)
    dead_block = ~lay.block_live.bool().repeat_interleave(bm)
    lhs[dead_block] = 5.0
    cot[dead_block] = -3.0
    out = g.gmm_forward(lhs, rhs, lay, route="wgmma")
    dlhs = g.gmm_forward(cot, rhs, lay, transpose_rhs=True, route="wgmma")
    drhs = g.tgmm(lhs, cot, len(sizes), lay, route="wgmma")
    torch.cuda.synchronize()
    assert torch.all(out[dead_block] == 0)
    assert torch.all(dlhs[dead_block] == 0)
    assert torch.all(drhs[1] == 0)
    _within(drhs, g.tgmm_reference(lhs, cot, len(sizes), lay),
            GMM_DTYPES[1][1], "drhs")


def test_gmm_wgmma_launches_give_the_same_bits(hopper):
    """No atomics and no split: two launches of each kernel are bitwise
    equal."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    sizes, k, n, bm = GMM_SKEWED
    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.bfloat16, sizes, k, n, bm,
                                     12)
    for run in (lambda: g.gmm_forward(lhs, rhs, lay),
                lambda: g.gmm_forward(cot, rhs, lay, transpose_rhs=True),
                lambda: g.tgmm(lhs, cot, len(sizes), lay)):
        assert torch.equal(run(), run())


def _moe_prefill_sizes():
    """Rows of each of 8 experts at the MoE prefill's shape (phase M of
    chip_smoke.py: B 4 x S 512 tokens at top-2, 4,096 rows) from a seeded
    top-2 router."""
    logits = np.random.default_rng(5).standard_normal((2048, 8))
    top2 = np.argsort(-logits, axis=1)[:, :2]
    return tuple(np.bincount(top2.ravel(), minlength=8).tolist())


@pytest.mark.parametrize("route", ["wgmma", "mma"])
@pytest.mark.parametrize("k,n", [(768, 2048), (2048, 768)],
                         ids=["gate_up", "down"])
def test_gmm_at_the_moe_prefill_shape(hopper, route, k, n):
    """The forward the MoE prefill runs, 4,096 routed rows at block 512 (the
    layer's min(512, pow2(t·k))), in bf16 on both routes: within phase G's
    limit of the plain version, rows that hold no token 0, one launch
    counted by route, two wgmma launches bitwise equal."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    sizes = _moe_prefill_sizes()
    lay, lhs, rhs, _ = _gmm_inputs(hopper, torch.bfloat16, sizes, k, n, 512,
                                   k + n)
    assert sum(sizes) == 4096 and lay.block_m == 512
    before = _gmm_counts()
    out = g.gmm_forward(lhs, rhs, lay, route=route)
    torch.cuda.synchronize()
    wgmma = int(route == "wgmma")
    assert _gmm_counts() == (before[0] + 1, before[1] + wgmma, before[2],
                             before[3])
    _within(out, g.gmm_reference(lhs, rhs, lay), GMM_DTYPES[1][1], "out")
    assert torch.all(out[~g.live_rows(lay)] == 0)
    if wgmma:
        assert torch.equal(out, g.gmm_forward(lhs, rhs, lay, route=route))


def test_gmm_launches_wgmma_counts_by_route(hopper):
    """bf16 counts on launches and launches_wgmma; f32, or the mma route
    named in bf16, on launches alone; autograd's bf16 forward and backward
    take the wgmma route."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    sizes, k, n, bm = GMM_SKEWED
    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.bfloat16, sizes, k, n, bm,
                                     13)
    before = _gmm_counts()
    g.gmm_forward(lhs, rhs, lay)
    g.tgmm(lhs, cot, len(sizes), lay)
    assert _gmm_counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                             before[3] + 1)
    before = _gmm_counts()
    g.gmm_forward(lhs, rhs, lay, route="mma")
    g.tgmm(lhs, cot, len(sizes), lay, route="mma")
    g.gmm_forward(lhs.float(), rhs.float(), lay)
    g.tgmm(lhs.float(), cot.float(), len(sizes), lay)
    assert _gmm_counts() == (before[0] + 2, before[1], before[2] + 2,
                             before[3])
    before = _gmm_counts()
    lhs.requires_grad_(), rhs.requires_grad_()
    (g.gmm(lhs, rhs, lay).float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    assert _gmm_counts() == (before[0] + 2, before[1] + 2, before[2] + 1,
                             before[3] + 1)


def test_gmm_wgmma_refuses_and_does_not_fall_back(hopper):
    """A forced wgmma route in f32, an unknown route and a layout the
    kernels cannot take raise, and nothing launches."""
    from k8s_distributed_deeplearning_torch.ops import gmm as g

    lay, lhs, rhs, cot = _gmm_inputs(hopper, torch.float32, (30, 9), 64, 64,
                                     128, 14)
    before = _gmm_counts()
    with pytest.raises(TypeError, match="wgmma route takes bfloat16"):
        g.gmm_forward(lhs, rhs, lay, route="wgmma")
    with pytest.raises(TypeError, match="wgmma route takes bfloat16"):
        g.tgmm(lhs, cot, 2, lay, route="wgmma")
    with pytest.raises(ValueError, match="route must be"):
        g.gmm_forward(lhs.bfloat16(), rhs.bfloat16(), lay, route="cublas")
    small = g.grouped_layout(lay.group_sizes, 39, block_m=64)
    with pytest.raises(ValueError, match="row tile"):
        g.tgmm(torch.zeros(small.m_pad, 64, device=hopper).bfloat16(),
               torch.zeros(small.m_pad, 64, device=hopper).bfloat16(), 2,
               small, route="wgmma")
    torch.cuda.synchronize()
    assert _gmm_counts() == before
