"""PyTorch port, the tensor-core decode route of paged attention
(``csrc/paged_decode.cu``) on the CPU, where the kernel cannot run.

- ``_route``: the engine's decode shapes (one query at groups 3, 4 and 8,
  head_dim 64 and 128, fp and int8 pools), speculative verify windows and
  short chunks (``sq x group <= 64``) take the decode kernel, and so does
  bf16 at head_dim 16 and 32 at every row count (the serve CLI's drafts);
  other head dims (8, 24, 80, 256) take the split kernel, in bf16 and in
  f32 (f32 q at head_dim 16-128 takes the tf32x3 kernel:
  ``tests/test_torch_paged_attn_f32.py``).
- A torch model of the kernel's arithmetic, written here: the flattened
  (position, group head) rows of a KV head cut into 16-row tiles, each
  (row, KV head, row tile) split over ``_decode_splits`` CTAs, each CTA an
  equal share of the row's live 16-key tiles (the live length set by the
  largest cursor of the whole row, so every row tile splits it alike; past
  64 queries, at head_dim 16/32, by the largest cursor of the tile's own
  rows),
  its four warps walking every fourth tile of that share with their own
  online softmax (log2 domain), the warps' states merged in warp order
  and the CTAs' states in CTA order. fp rounds p to bf16 at the warp's
  running max; int8 takes ``S = k_scale * (Q . K_int8)`` and splits ``p'
  = p * v_scale`` into bf16 ``hi + lo``. The model is held to the JAX
  Pallas kernel in interpret mode at Llama-3 8B's heads (and the small
  preset's) cut to a few pages: fp within phase A's 1e-2, int8 within the
  card's int8 limit. Live lengths of 1, of exactly one page and of a page
  and one; a row of one key, split over 8 CTAs of which 7 have none; a
  fully masked row (exactly 0); verify windows of 4 to 15 (16 to 60 rows,
  one to four row tiles, the last one partly padding), a group of 8, and
  40 queries of one head each (cursors past the warp's 32 lanes); at
  head_dim 16 the micro draft's 2/1 heads (decode, a verify window of 4,
  a chunk of 80 queries: 160 rows, each tile its own key range) and the
  tiny preset's 4/2 (a chunk of 40 queries, 80 rows, the row's range),
  at head_dim 32 decode and a verify window. Each case runs at the card's
  132 SMs and at 8, where a warp walks several tiles.
- CPU tensors take the plain version and count no launch on any route.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``) and in ``chip_smoke.py`` phase A.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models.transformer import quantize_kv
from k8s_distributed_deeplearning_torch.ops import paged_attn
from k8s_distributed_deeplearning_tpu.ops import pallas_paged_attn

KT = 16                              # the kernel's key tile
RT = 16                              # its row tile
NW = 4                               # warps a CTA
NEG_INF = -1e30
LOG2E = math.log2(math.e)
# bf16 output against the Pallas kernel, per element. int8: |model -
# Pallas| <= 2^-10 x the output's RMS + 2^-7 x |Pallas| (the card's limit:
# the order of the f32 sums, the 2^-16 the hi/lo split leaves of p', and
# one bf16 step of the output). fp: 1e-2 absolute, phase A's limit (p
# rounded to bf16 at a warp's running max against Pallas' page-wise one,
# O(1) outputs in bf16).
INT8_TOL_BF16 = (2 ** -10, 2 ** -7)
FP_TOL = 1e-2


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("sq,group,hd", [
    (1, 4, 128),                     # Llama-3 8B decode
    (1, 3, 64),                      # the small preset's decode
    (1, 8, 128),
    (1, 8, 64),
    (1, 1, 128),
    (1, 16, 64),
    (4, 4, 128),                     # a verify window of 4
    (2, 8, 64),
    (5, 4, 128),                     # verify windows of 5-15: 17-63 rows
    (2, 12, 64),
    (15, 4, 128),
])
def test_engine_decode_shapes_take_the_decode_route(sq, group, hd, quant):
    assert paged_attn._route(sq, group, hd, torch.bfloat16,
                             quant) == "decode"


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("sq,group,hd,dtype", [
    (1, 4, 80, torch.float32),        # f32 q at another head dim
    (1, 4, 80, torch.bfloat16),       # other head dims
    (1, 4, 256, torch.bfloat16),
    (1, 4, 24, torch.bfloat16),
    (8, 4, 8, torch.float32),         # a verify window of 8, f32 q at 8
    (8, 4, 80, torch.bfloat16),       # and at another head dim
])
def test_other_shapes_keep_the_split_route(sq, group, hd, dtype, quant):
    assert paged_attn._route(sq, group, hd, dtype, quant) == "split"


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("sq,group,hd", [
    (1, 2, 16),                       # the micro draft's decode
    (4, 2, 16),                       # its verify window at spec_k 3
    (512, 2, 16),                     # its 512-token prefill chunk
    (1, 2, 32),
    (40, 2, 32),                      # 80 rows: past one 64-row span
    (128, 4, 32),
])
def test_head_dims_16_and_32_take_the_decode_route_at_every_row_count(
        sq, group, hd, quant):
    assert paged_attn._route(sq, group, hd, torch.bfloat16,
                             quant) == "decode"


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("sq,group,hd,want", [
    (21, 3, 64, "decode"),            # 63 rows
    (16, 4, 128, "decode"),           # 64: four 16-row tiles beat one
    (17, 4, 128, "prefill"),          # wgmma tile on the card; 68 rows
])
def test_the_64_row_boundary_takes_the_measured_route(sq, group, hd, want,
                                                      quant):
    assert paged_attn._route(sq, group, hd, torch.bfloat16, quant) == want


@pytest.mark.parametrize("b,kv,sms,rows,want", [
    (4, 8, 132, 4, 8),     # phase A and B's decode: 256 CTAs
    (1, 8, 132, 4, 8),     # capped at one portable cluster
    (16, 8, 132, 4, 3),
    (64, 8, 132, 4, 1),
    (4, 4, 8, 3, 1),
    (1, 1, 8, 16, 8),
    (4, 8, 132, 32, 5),    # a verify window of 8 at 8B heads: two row
    (4, 8, 132, 60, 3),    # tiles, 320 CTAs; of 15: four, 384 CTAs
    (4, 4, 132, 45, 6),    # the small preset's window of 15: three tiles
    (16, 8, 132, 64, 1),
])
def test_decode_splits_fill_the_card_two_ctas_an_sm(b, kv, sms, rows,
                                                    want):
    assert paged_attn._decode_splits(b, kv, sms, rows) == want


def _merge(states):
    """(m, l, o) states merged in order, in the log2 domain; a state with
    l = 0 saw no key and adds nothing to O."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = sum(torch.exp2(s[0] - m) * s[1] for s in states)
    o = sum(torch.where((s[1] > 0)[..., None],
                        torch.exp2(s[0] - m)[..., None] * s[2],
                        torch.zeros_like(s[2])) for s in states)
    return m, l, o


def kernel_model(q, pool_k, pool_v, tables, positions, k_scale=None,
                 v_scale=None, num_sms=132):
    """The decode kernel's arithmetic, in torch (see the module
    docstring). Products of bf16 values are exact in f32 (the tensor
    cores' inputs: bf16 q, bf16 or int8 K/V)."""
    b, sq, h, hd = q.shape
    _, bt, kvhd = pool_k.shape
    hkv = kvhd // hd
    group = h // hkv
    rows = sq * group
    n_rt = -(-rows // RT)
    width = tables.shape[1] * bt
    sl = hd ** -0.5 * LOG2E
    quant = k_scale is not None
    lims = [min(int(positions[i].max()) + 1, width) for i in range(b)]
    tiles = [-(-n // KT) if n > 0 else 0 for n in lims]
    cnt = paged_attn._decode_splits(b, hkv, num_sms, rows)
    out = torch.zeros(b, sq, h, hd)
    for i in range(b):
        tl = tables[i].long()
        pad = (-width) % KT + KT          # columns past the table: zero
        k = torch.cat([pool_k[tl].reshape(width, hkv, hd).float(),
                       torch.zeros(pad, hkv, hd)]).permute(1, 0, 2)
        v = torch.cat([pool_v[tl].reshape(width, hkv, hd).float(),
                       torch.zeros(pad, hkv, hd)]).permute(1, 0, 2)
        if quant:
            ks = torch.cat([k_scale[tl].reshape(width, hkv),
                            torch.zeros(pad, hkv)]).T
            vs = torch.cat([v_scale[tl].reshape(width, hkv),
                            torch.zeros(pad, hkv)]).T
        # Flattened row r: position r // group of q head kvh * group +
        # r % group.
        qa = q[i].float().reshape(sq, hkv, group, hd).permute(1, 0, 2, 3)
        qa = qa.reshape(hkv, rows, hd)
        cura = positions[i].long().repeat_interleave(group)      # [rows]
        res = torch.zeros(hkv, rows, hd)
        # Each 16-row tile of the KV head is a call of its own. Past 64
        # queries each tile reads up to its own rows' largest cursor.
        for r0 in range(0, rows, RT):
            tile = slice(r0, min(r0 + RT, rows))
            lim, n_tiles = lims[i], tiles[i]
            if sq > 64:
                lim = min(int(cura[tile].max()) + 1, width)
                n_tiles = -(-lim // KT) if lim > 0 else 0
            res[:, tile] = _tile_model(
                qa[:, tile], cura[tile], k, v, (ks, vs) if quant else None,
                lim, n_tiles, cnt, sl)
        out[i] = res.reshape(hkv, sq, group, hd).permute(1, 0, 2, 3).reshape(
            sq, h, hd)
    return out.to(q.dtype)


def _tile_model(qr, cur, k, v, scales, lim, n_tiles, cnt, sl):
    """One row tile of one batch row, every KV head: ``qr`` [hkv, rows,
    hd] and ``cur`` [rows] its rows' queries and cursors, K/V [hkv, cols,
    hd] the row's (and ``scales`` its K and V scales [hkv, cols]), ``lim``
    the columns the row reads, in ``n_tiles`` 16-key tiles over ``cnt``
    CTAs. Returns O / l, [hkv, rows, hd]."""
    hkv, rows, hd = qr.shape
    quant = scales is not None
    if quant:
        ks, vs = scales
    parts = []
    for c in range(cnt):
        t_lo, t_hi = c * n_tiles // cnt, (c + 1) * n_tiles // cnt
        warps = []
        for w in range(NW):
            m = torch.full((hkv, rows), NEG_INF)
            l = torch.zeros(hkv, rows)
            o = torch.zeros(hkv, rows, hd)
            for t in range(t_lo + w, t_hi, NW):
                cols = torch.arange(t * KT, (t + 1) * KT)
                s = torch.einsum("krd,kjd->krj", qr, k[:, cols])
                if quant:
                    s = s * ks[:, None, cols]
                s = s * sl
                seen = ((cols[None, :] <= cur[:, None])
                        & (cols[None, :] < lim))
                s = torch.where(seen[None], s, torch.tensor(NEG_INF))
                mn = torch.maximum(m, s.amax(-1))
                p = torch.exp2(s - mn[..., None])
                p = torch.where(s <= NEG_INF / 2, torch.tensor(0.0), p)
                a = torch.exp2(m - mn)
                l = a * l + p.sum(-1)
                if quant:
                    p = p * vs[:, None, cols]
                    hi = p.to(torch.bfloat16).float()
                    lo = (p - hi).to(torch.bfloat16).float()
                    pv = (torch.einsum("krj,kjd->krd", hi, v[:, cols])
                          + torch.einsum("krj,kjd->krd", lo, v[:, cols]))
                else:
                    pv = torch.einsum("krj,kjd->krd",
                                      p.to(torch.bfloat16).float(),
                                      v[:, cols])
                o = o * a[..., None] + pv
                m = mn
            warps.append((m, l, o))
        # The warps in order: every warp's state counts, as in the
        # kernel's shared-memory merge.
        mw = torch.stack([x[0] for x in warps]).amax(0)
        parts.append((mw, sum(torch.exp2(x[0] - mw) * x[1]
                              for x in warps),
                       sum(torch.exp2(x[0] - mw)[..., None] * x[2]
                           for x in warps)))
    _, l, o = parts[0] if cnt == 1 else _merge(parts)
    return o / l.clamp_min(1e-30)[..., None]


def _case(rng, b, sq, h, hkv, pages, bt, nb, hd, lens):
    """Random pools; row b maps its live blocks onto distinct real pages
    (the rest on scratch page 0) and queries the last ``sq`` positions of
    its ``lens[b]`` tokens."""
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    pool_k = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    pool_v = rng.standard_normal((pages, bt, hkv * hd)).astype(np.float32)
    tables = np.zeros((b, nb), np.int32)
    free = rng.permutation(np.arange(1, pages))
    used = 0
    for i, n in enumerate(lens):
        k = -(-max(n, 1) // bt)
        tables[i, :k] = free[used:used + k]
        used += k
    pos = (np.asarray(lens)[:, None] - sq + np.arange(sq)[None, :]).astype(
        np.int32)
    return q, pool_k, pool_v, tables, pos


def _quantized(pool, hd):
    x, s = quantize_kv(torch.from_numpy(pool).view(*pool.shape[:2], -1, hd))
    return x.view(pool.shape).numpy(), s.numpy()


# name -> (b, sq, h, hkv, pages, page_tokens, n_blocks, head_dim, live
# lengths): Llama-3 8B's heads on 32-token pages at live lengths 1, 32 and
# 33; the small preset's 12/4 heads at head_dim 64; one KV head a query
# head on 16-token pages; a verify window of 4 at 8B's heads (16 rows a
# KV head); one row of one key, split over 8 CTAs (2 at 8 SMs); rows
# whose cursors are -1 (masked, set below); verify windows of 5, 8 and 15
# at 8B's heads (20, 32 and 60 rows: two to four row tiles) and of 6 at
# the small preset's (18 rows); a window of 5 at a group of 8 (40 rows);
# 40 queries of one head each (group 1: cursors of queries 32-39 come
# from the lanes' second halves); and a window of 9 (36 rows) whose last
# tile is 4 rows and 12 of padding, one row's window across a page edge.
MODEL_CASES = {
    "llama3_8b": (3, 1, 32, 8, 12, 32, 4, 128, [1, 32, 33]),
    "small": (3, 1, 12, 4, 12, 32, 4, 64, [1, 32, 97]),
    "group1": (2, 1, 8, 8, 12, 16, 6, 128, [17, 80]),
    "verify4": (2, 4, 32, 8, 12, 32, 4, 128, [40, 100]),
    "one_key": (1, 1, 32, 8, 4, 32, 2, 128, [1]),
    "masked": (2, 2, 12, 4, 8, 32, 3, 64, [50, 70]),
    "verify5": (2, 5, 32, 8, 12, 32, 4, 128, [40, 100]),
    "verify8": (2, 8, 32, 8, 12, 32, 4, 128, [60, 120]),
    "verify15": (2, 15, 32, 8, 12, 32, 4, 128, [50, 110]),
    "small_verify6": (2, 6, 12, 4, 12, 32, 4, 64, [30, 90]),
    "group8_verify5": (2, 5, 16, 2, 12, 32, 4, 128, [45, 77]),
    "group1_w40": (2, 40, 8, 8, 14, 16, 6, 128, [60, 90]),
    "pad_tile": (2, 9, 32, 8, 12, 32, 4, 128, [37, 100]),
    "micro_decode": (4, 1, 2, 1, 12, 32, 4, 16, [1, 33, 100, 64]),
    "micro_verify4": (2, 4, 2, 1, 12, 32, 4, 16, [40, 100]),
    "micro_chunk80": (1, 80, 2, 1, 8, 32, 5, 16, [130]),
    "tiny_chunk40": (2, 40, 4, 2, 12, 32, 4, 16, [45, 120]),
    "hd32_decode": (3, 1, 4, 2, 12, 32, 4, 32, [1, 32, 97]),
    "hd32_verify8": (2, 8, 4, 2, 12, 32, 4, 32, [60, 120]),
}


@functools.lru_cache(maxsize=None)
def _inputs(name, quant):
    """The case's inputs (numpy, bf16 values) and the Pallas kernel's
    output in interpret mode."""
    shape = MODEL_CASES[name]
    rng = np.random.default_rng(sum(shape[:-1]) + 7 * quant)
    q, pk, pv, tables, pos = _case(rng, *shape)
    if name == "masked":
        pos[0, 1] = -1               # one masked query row
        pos[1] = -1                  # a batch row that sees nothing
    hd = shape[7]
    q = q.astype(jnp.bfloat16).astype(np.float32)
    if quant:
        (pk, ks), (pv, vs) = _quantized(pk, hd), _quantized(pv, hd)
        scales = (ks, vs)
        kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        pools = (jnp.asarray(pk), jnp.asarray(pv))
    else:
        pk, pv = (a.astype(jnp.bfloat16).astype(np.float32)
                  for a in (pk, pv))
        scales, kw = (), {}
        pools = (jnp.asarray(pk, jnp.bfloat16),
                 jnp.asarray(pv, jnp.bfloat16))
    want = np.asarray(pallas_paged_attn.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), *pools, jnp.asarray(tables),
        jnp.asarray(pos), interpret=True, **kw).astype(jnp.float32))
    return (q, pk, pv, tables, pos, scales), want


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_kernel_arithmetic_matches_pallas(name, quant, sms):
    (q, pk, pv, tables, pos, scales), want = _inputs(name, quant)
    shape = MODEL_CASES[name]
    assert paged_attn._route(shape[1], shape[2] // shape[3], shape[7],
                             torch.bfloat16, quant) == "decode"
    t = torch.from_numpy
    pools = ((t(pk), t(pv)) if quant else
             (t(pk).bfloat16(), t(pv).bfloat16()))
    got = kernel_model(t(q).bfloat16(), *pools, t(tables), t(pos),
                       *(t(s) for s in scales), num_sms=sms).float().numpy()
    if name == "masked":
        assert np.all(got[0, 1] == 0) and np.all(got[1] == 0)
    if quant:
        limit = (INT8_TOL_BF16[0] * np.sqrt(np.mean(want ** 2))
                 + INT8_TOL_BF16[1] * np.abs(want))
        err = np.abs(got - want)
        assert np.all(err <= limit), float(np.max(err / limit))
    else:
        np.testing.assert_allclose(got, want, atol=FP_TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_cpu_tensors_take_the_plain_version_on_every_route(quant):
    """A decode-shaped bf16 call on the CPU is the plain version's, bit
    for bit, and no route counts a launch."""
    (q, pk, pv, tables, pos, scales), _ = _inputs("llama3_8b", quant)
    t = torch.from_numpy
    pools = ((t(pk), t(pv)) if quant else
             (t(pk).bfloat16(), t(pv).bfloat16()))
    kw = dict(k_scale=t(scales[0]), v_scale=t(scales[1])) if quant else {}
    args = (t(q).bfloat16(), *pools, t(tables), t(pos))
    fn = paged_attn.paged_decode_attention
    names = ("launches", "launches_int8", "launches_prefill",
             "launches_prefill_int8", "launches_decode",
             "launches_decode_int8")
    before = [getattr(fn, n) for n in names]
    out = fn(*args, **kw)
    assert torch.equal(out, paged_attn.paged_decode_attention_reference(
        *args, **kw))
    assert [getattr(fn, n) for n in names] == before


def test_private_launcher_refuses_cpu_tensors_on_the_decode_route():
    (q, pk, pv, tables, pos, _), _ = _inputs("llama3_8b", False)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="device cpu"):
        paged_attn._launch(t(q).bfloat16(), t(pk).bfloat16(),
                           t(pv).bfloat16(), t(tables), t(pos),
                           route="decode")
