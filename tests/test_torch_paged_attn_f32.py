"""PyTorch port, paged attention with f32 q on the tensor cores
(``csrc/paged_attn_f32.cu``, the ``"tf32x3"`` route) on the CPU, where the
kernel cannot run.

- ``_route``: f32 q at head_dim 16, 32, 64 and 128 takes the tf32x3
  kernel at every row count (decode, verify windows, chunks), fp and int8
  pools; f32 q at other head dims keeps the split kernel.
  ``_tf32x3_splits``: CTAs a (row, KV head, row tile) from the batch, the
  KV heads, the row tiles and the SM count, never from the table width.
- A torch model of the kernel's arithmetic, written here: the flattened
  (position, group head) rows of a KV head cut into 16-row tiles up to 64
  rows, 64-row tiles above; each (row, KV head, row tile) split over
  ``_tf32x3_splits`` CTAs, each an equal share of the tile's live 32-key
  tiles (the live length set by the tile's largest cursor; columns past it
  are zero, as the kernel's zero-filled copies); in a 16-row tile four
  warps take 8 keys of each tile with a softmax state each, merged in warp
  order at the end, in a 64-row tile each row sees all 32 keys; the CTAs'
  states merged in CTA order. Every product is the three-pass TF32 split:
  operands rounded to TF32 as the kernel's integer add does it on the
  int32 view (``(bits + 0x1000) & ~0x1FFF``, ``cvt.rna.tf32.f32``'s
  rounding), ``hi = rna(x)``, ``lo = rna(x - hi)``, ``a_lo.b_hi +
  a_hi.b_lo + a_hi.b_hi`` in f32; int8 operands are exact, so the int8
  branch takes two passes: ``S = k_scale (q_lo.k + q_hi.k)`` and, with
  ``p' = p v_scale``, ``O += p'_lo.v + p'_hi.v``. Each tile's P.V is summed
  from zero and taken into O as ``alpha O + part``; the softmax runs in
  the log2 domain. The model is held against the JAX Pallas kernel in
  interpret mode (f32 q; f32 pools, or int8 pools with f32 scales) and
  against the port's plain version at phase A's f32 limit
  (``chip_smoke.py`` ``TOL[torch.float32]`` = 1e-4 absolute). Cases:
  head_dim 64 and 128; groups 1, 4 and 8; decode, verify windows of 5 and
  8, chunks of 96 and 512 rows; at head_dim 16 the serve CLI's tiny
  preset (4/2 heads: an 8-slot decode and a 128-query prefill, 256 rows)
  and at 32 decode and a verify window of 8; live lengths that cut a
  32-key tile and a page; a fully masked query row and a batch row that
  sees nothing (exactly 0); at the card's 132 SMs and at 8. Stale K/V
  past each cursor and garbage in the scratch page change no bit of the
  model.
- The same model with one TF32 pass (``a_hi.b_hi`` alone) exceeds that
  limit: the test can tell the split from its absence.
- CPU tensors take the plain version and count no launch on the route.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py -k paged_tf32x3``) and in
``chip_smoke.py`` phase A.
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

torch.set_num_threads(2)

KT = 32                              # the kernel's key tile
NW = 4                               # warps a CTA
NEG_INF = -1e30
LOG2E = math.log2(math.e)
F32_TOL = 1e-4                       # chip_smoke.py TOL[torch.float32]


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("sq,group,hd", [
    (1, 4, 128),                     # Llama-3 8B decode
    (8, 4, 128),                     # a verify window of 8
    (1, 4, 64),
    (8, 4, 64),
    (1, 8, 64),
    (5, 1, 128),
    (16, 4, 128),                    # 64 rows: the last 16-row tiling
    (17, 4, 128),                    # 68 rows: 64-row tiles
    (512, 4, 128),                   # phase A's 512-query chunk
    (15, 4, 128),                    # a short chunk: 60 rows
    (24, 4, 64),
    (1, 2, 16),                      # the tiny preset's decode
    (128, 2, 16),                    # and its 128-query prefill
    (8, 2, 32),
    (512, 4, 32),
])
def test_f32_q_takes_the_tf32x3_route(sq, group, hd, quant):
    assert paged_attn._route(sq, group, hd, torch.float32,
                             quant) == "tf32x3"


@pytest.mark.parametrize("rows,want", [
    (1, 16), (20, 16), (64, 16), (65, 64), (96, 64), (2048, 64)])
def test_tf32x3_row_tile(rows, want):
    assert paged_attn._tf32x3_tile_rows(rows) == want


@pytest.mark.parametrize("b,kv,sms,rows,want", [
    (4, 8, 132, 4, 8),           # phase A and C's decode: 32 tiles, capped
    (4, 8, 132, 32, 5),          # a verify window of 8: two 16-row tiles
    (4, 8, 132, 60, 3),          # of 15: four tiles, 128 triples
    (1, 8, 132, 2048, 1),        # a 512-query chunk: 256 triples
    (1, 8, 132, 96, 8),          # a 24-query chunk: two 64-row tiles
    (64, 8, 132, 4, 1),
    (1, 1, 8, 16, 8),
])
def test_tf32x3_splits_follow_the_grid_not_the_table(b, kv, sms, rows,
                                                     want):
    """The table's width is not an argument: the kernel splits the live
    key tiles it counts on the device."""
    assert paged_attn._tf32x3_splits(b, kv, sms, rows) == want


def tf32(x):
    """x rounded to TF32 as the kernel's integer add rounds it: the low 13
    bits of the f32 pattern rounded off, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes, exact_b=False):
    """a @ b as the kernel computes it: three TF32 passes (the split), or
    one (``a_hi.b_hi``); with ``exact_b`` (int8 values, exact in TF32) two
    passes, ``a_lo.b + a_hi.b``."""
    ah = tf32(a)
    bh = b if exact_b else tf32(b)
    if passes == 1:
        return ah @ bh
    al = tf32(a - ah)
    if exact_b:
        return al @ bh + ah @ bh
    return al @ bh + ah @ tf32(b - bh) + ah @ bh


def _merge(states, skip_empty):
    """(m, l, o) states merged in order, in the log2 domain; the cluster
    merge (``skip_empty``) leaves a state with l = 0 out."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = torch.zeros_like(states[0][1])
    o = torch.zeros_like(states[0][2])
    for sm, sl_, so in states:
        a = torch.exp2(sm - m)
        if skip_empty:
            a = torch.where(sl_ > 0, a, torch.zeros_like(a))
        l = l + a * sl_
        o = o + a[..., None] * so
    return m, l, o


def kernel_model(q, pool_k, pool_v, tables, positions, k_scale=None,
                 v_scale=None, num_sms=132, passes=3):
    """The tf32x3 kernel's arithmetic, in torch (see the module
    docstring). f32 q and pools (or int8 pools with f32 scales); returns
    [B, sq, H, hd] f32."""
    b, sq, h, hd = q.shape
    _, bt, kvhd = pool_k.shape
    hkv = kvhd // hd
    group = h // hkv
    rows = sq * group
    rt = paged_attn._tf32x3_tile_rows(rows)
    kw = NW // (rt // 16)             # warps a 16-row sub-tile, by keys
    kn = KT // kw                     # keys a warp a tile
    cnt = paged_attn._tf32x3_splits(b, hkv, num_sms, rows)
    width = tables.shape[1] * bt
    sl = hd ** -0.5 * LOG2E
    quant = k_scale is not None
    out = torch.zeros(b, sq, h, hd)
    for i in range(b):
        tl = tables[i].long()
        k_all = pool_k[tl].reshape(width, hkv, hd).float().permute(1, 0, 2)
        v_all = pool_v[tl].reshape(width, hkv, hd).float().permute(1, 0, 2)
        if quant:
            ks_all = k_scale[tl].reshape(width, hkv).T
            vs_all = v_scale[tl].reshape(width, hkv).T
        qa = q[i].reshape(sq, hkv, group, hd).permute(1, 0, 2, 3).reshape(
            hkv, rows, hd)
        cura = positions[i].long().repeat_interleave(group)
        res = torch.zeros(hkv, rows, hd)
        for r0 in range(0, rows, rt):
            tile = slice(r0, min(r0 + rt, rows))
            cur = cura[tile]
            c_lim = min(int(cur.max()) + 1, width)
            n_tiles = -(-c_lim // KT) if c_lim > 0 else 0
            cols = n_tiles * KT
            # The kernel's copies: columns past c_lim are zero.
            k = torch.zeros(hkv, cols, hd)
            v = torch.zeros(hkv, cols, hd)
            k[:, :c_lim], v[:, :c_lim] = k_all[:, :c_lim], v_all[:, :c_lim]
            if quant:
                ks = torch.zeros(hkv, cols)
                vs = torch.zeros(hkv, cols)
                ks[:, :c_lim], vs[:, :c_lim] = (ks_all[:, :c_lim],
                                                vs_all[:, :c_lim])
            qt = qa[:, tile]
            nr = qt.shape[1]
            parts = []
            for c in range(cnt):
                t_lo, t_hi = c * n_tiles // cnt, (c + 1) * n_tiles // cnt
                warps = []
                for kq in range(kw):
                    m = torch.full((hkv, nr), NEG_INF)
                    l = torch.zeros(hkv, nr)
                    o = torch.zeros(hkv, nr, hd)
                    for t in range(t_lo, t_hi):
                        keys = torch.arange(t * KT + kq * kn,
                                            t * KT + (kq + 1) * kn)
                        s = product(qt, k[:, keys].transpose(1, 2), passes,
                                    exact_b=quant)
                        if quant:
                            s = s * ks[:, None, keys]
                        s = s * sl
                        seen = ((keys[None, :] <= cur[:, None])
                                & (keys[None, :] < c_lim))
                        s = torch.where(seen[None], s,
                                        torch.tensor(NEG_INF))
                        mn = torch.maximum(m, s.amax(-1))
                        p = torch.exp2(s - mn[..., None])
                        p = torch.where(s <= NEG_INF / 2,
                                        torch.tensor(0.0), p)
                        a = torch.exp2(m - mn)
                        l = a * l + p.sum(-1)
                        if quant:
                            p = p * vs[:, None, keys]
                        part = product(p, v[:, keys], passes, exact_b=quant)
                        o = o * a[..., None] + part
                        m = mn
                    warps.append((m, l, o))
                parts.append(warps[0] if kw == 1 else
                             _merge(warps, skip_empty=False))
            _, l, o = parts[0] if cnt == 1 else _merge(parts,
                                                       skip_empty=True)
            res[:, tile] = o / l.clamp_min(1e-30)[..., None]
        out[i] = res.reshape(hkv, sq, group, hd).permute(1, 0, 2, 3).reshape(
            sq, h, hd)
    return out


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


# name -> (b, sq, h, hkv, pages, page_tokens, n_blocks, head_dim, live
# lengths): decode at groups 4, 1 and 8 (hd 128 and 64; 16-token pages in
# the group-1 case), live lengths of 1, 33 and 100 that cut a 32-key tile
# and a page; verify windows of 5 (20 rows: two 16-row tiles, the second
# padded) and of 8 at a group of 8 (64 rows: four tiles); chunks of 24
# queries at group 4 (96 rows: a 64-row tile and a padded one) and of 64
# at group 8 (512 rows: eight 64-row tiles) at live lengths that cut a
# page; rows that see nothing (set below).
MODEL_CASES = {
    "decode_g4": (3, 1, 8, 2, 14, 32, 4, 128, [1, 33, 100]),
    "decode_g1": (2, 1, 4, 4, 12, 16, 6, 64, [17, 80]),
    "decode_g8": (2, 1, 16, 2, 12, 32, 4, 64, [45, 77]),
    "verify5": (2, 5, 8, 2, 12, 32, 4, 128, [40, 100]),
    "verify8_g8": (2, 8, 16, 2, 12, 32, 4, 64, [60, 120]),
    "chunk96": (1, 24, 8, 2, 8, 32, 6, 128, [150]),
    "chunk512": (1, 64, 16, 2, 8, 32, 6, 64, [170]),
    "masked": (2, 2, 8, 2, 8, 32, 3, 64, [50, 70]),
    "tiny_decode": (8, 1, 4, 2, 40, 32, 4, 16,
                    [41, 77, 100, 128, 33, 64, 90, 120]),
    "tiny_prefill128": (1, 128, 4, 2, 8, 32, 5, 16, [128]),
    "hd32_decode": (3, 1, 4, 2, 12, 32, 4, 32, [1, 33, 100]),
    "hd32_verify8": (2, 8, 4, 2, 12, 32, 4, 32, [60, 120]),
}


def _quantized(pool, hd):
    x, s = quantize_kv(torch.from_numpy(pool).view(*pool.shape[:2], -1, hd))
    return x.view(pool.shape).numpy(), s.numpy()


@functools.lru_cache(maxsize=None)
def _inputs(name, quant):
    """The case's inputs (numpy) and the Pallas kernel's f32 output in
    interpret mode."""
    shape = MODEL_CASES[name]
    rng = np.random.default_rng(sum(shape[:-1]) + 11 * quant)
    q, pk, pv, tables, pos = _case(rng, *shape)
    if name == "masked":
        pos[0, 1] = -1               # one masked query row
        pos[1] = -1                  # a batch row that sees nothing
    hd = shape[7]
    if quant:
        (pk, ks), (pv, vs) = _quantized(pk, hd), _quantized(pv, hd)
        scales = (ks, vs)
        kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    else:
        scales, kw = (), {}
    want = np.asarray(pallas_paged_attn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True, **kw))
    return (q, pk, pv, tables, pos, scales), want


def _torch_args(name, quant):
    (q, pk, pv, tables, pos, scales), want = _inputs(name, quant)
    t = torch.from_numpy
    kw = dict(k_scale=t(scales[0]), v_scale=t(scales[1])) if quant else {}
    return (t(q), t(pk), t(pv), t(tables), t(pos)), kw, want


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_kernel_arithmetic_matches_pallas_and_plain(name, quant, sms):
    args, kw, want = _torch_args(name, quant)
    shape = MODEL_CASES[name]
    assert paged_attn._route(shape[1], shape[2] // shape[3], shape[7],
                             torch.float32, quant) == "tf32x3"
    got = kernel_model(*args, **kw, num_sms=sms).numpy()
    plain = paged_attn.paged_decode_attention_reference(*args, **kw).numpy()
    if name == "masked":
        assert np.all(got[0, 1] == 0) and np.all(got[1] == 0)
        assert np.all(plain[0, 1] == 0) and np.all(plain[1] == 0)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got, plain, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_one_tf32_pass_exceeds_the_f32_limit(name, quant):
    """Without the split the same arithmetic misses phase A's f32 limit:
    the three-pass model's distance from the Pallas kernel is far inside
    it, the one-pass model's outside."""
    args, kw, want = _torch_args(name, quant)
    three = np.abs(kernel_model(*args, **kw).numpy() - want).max()
    one = np.abs(kernel_model(*args, **kw, passes=1).numpy() - want).max()
    assert three <= F32_TOL / 4 < F32_TOL < one, (three, one)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_stale_cells_and_the_scratch_page_change_no_bit(quant):
    """Every cell past each row's live length, and the scratch page,
    overwritten (fp: +-1e4; int8: 127 with scales 1e4) change no bit of
    the model: it reads no column past its tile's largest cursor."""
    (q, pk, pv, tables, pos), kw, _ = _torch_args("decode_g4", quant)
    base = kernel_model(q, pk, pv, tables, pos, **kw)
    pools = [pk.clone(), pv.clone()] + ([kw["k_scale"].clone(),
                                         kw["v_scale"].clone()]
                                        if quant else [])
    bt = pk.shape[1]
    for i, n in enumerate(MODEL_CASES["decode_g4"][-1]):
        last = int(tables[i, (n - 1) // bt])
        for j, x in enumerate(pools):
            x[last, (n - 1) % bt + 1:] = (1e4 if j > 1 else 127) if quant \
                else (1e4 if j == 0 else -1e4)
    for j, x in enumerate(pools):
        x[0] = (1e4 if j > 1 else 127) if quant else (1e4 if j == 0
                                                      else -1e4)
    kw2 = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    assert torch.equal(kernel_model(q, pools[0], pools[1], tables, pos,
                                    **kw2), base)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_cpu_tensors_take_the_plain_version_and_count_nothing(quant):
    """An f32 call on the CPU is the plain version's, bit for bit, and no
    route counts a launch; naming the tf32x3 route on CPU tensors
    raises."""
    args, kw, _ = _torch_args("verify5", quant)
    fn = paged_attn.paged_decode_attention
    names = ("launches", "launches_int8", "launches_tf32x3",
             "launches_tf32x3_int8", "launches_decode", "launches_prefill")
    before = [getattr(fn, n) for n in names]
    out = fn(*args, **kw)
    assert torch.equal(out, paged_attn.paged_decode_attention_reference(
        *args, **kw))
    with pytest.raises(ValueError, match="device cpu"):
        paged_attn._launch(*args, **kw, route="tf32x3")
    assert [getattr(fn, n) for n in names] == before
