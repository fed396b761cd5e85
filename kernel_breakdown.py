#!/usr/bin/env python3
"""Where a tile's time goes in a tensor-core kernel of the port.

    python3 kernel_breakdown.py decode       # csrc/paged_decode.cu
    python3 kernel_breakdown.py prefill      # csrc/paged_prefill.cu
    python3 kernel_breakdown.py flash_bwd    # csrc/flash_bwd.cu
    python3 kernel_breakdown.py flash_fwd    # csrc/flash_fwd.cu
    python3 kernel_breakdown.py gmm          # csrc/gmm_wgmma.cu
    python3 kernel_breakdown.py flash_bwd --against OTHER_CHECKOUT

Needs one NVIDIA Hopper GPU and nvcc. Builds the kernel's source as it is
and in variants that each leave one stage of its tile loop out (the
numbers they produce are wrong on purpose; only their times count), one
nvcc each, all started together, then times every launch of each variant
at the kernel's case in two interleaved rounds with a cold L2. A stage's
cost is the base time less the variant's. Prints the card's name and
power limit, each variant's ptxas register counts (a variant whose count
collapses has lost more than its stage), then one JSON line per (round,
variant, launch).

``--against DIR`` builds, instead of the variants, the same source from
another checkout of the repo (``DIR``, e.g. a parent commit unpacked with
``git archive``; its own ``csrc/`` headers), runs every launch once on
each build, prints whether the outputs are bitwise equal, then times both
builds as above.

``decode``: Llama-3 8B's heads (32 q, 8 KV, head_dim 128, 32-token pages),
one query a row, fp and int8 pools, at phase A's decode case (B 4, live
lengths drawn as phase A draws them, 64-block tables) and at phase B's
decode-profile shape (B 4, live 512-560 of 64 blocks), the CTA count the
wrapper picks. Variants: ``no_loads`` (no copies after the first two
tiles of a warp), ``no_s`` (no S products), ``no_pv`` (no P.V products:
their fragments are folded into one accumulator element by integer
XORs), ``no_exp`` (p = x, no exponentials), ``no_convert`` (int8: no
int8-to-bf16 pass), ``no_merge`` (the cluster's CTA states are not
merged), ``skeleton`` (none of these: the cursors, the Q and table loads,
the waits, the masks, the warps' merge and the cluster barriers), and
``three_slots`` (not a stage: a third ring slot a warp, two tiles ahead,
at two CTAs an SM).

``prefill``: Llama-3 8B's heads (32 q, 8 KV, head_dim 128, 32-token
pages), a 512-query chunk at offset 1024, fp and int8 pools, 128-row
tiles. Variants: ``no_exp`` (p = x, no exponentials), ``no_pv`` (no P.V
products), ``no_s`` (no S products), ``no_loads`` (no copies after the
first tiles), ``no_rescale`` (O is not rescaled), ``no_convert`` (int8: no
int8-to-bf16 pass).

``flash_bwd``: the dQ and the dK/dV kernel at phase D's causal bf16 case
(B 2, S 2048, 32 q heads, 8 KV heads, head_dim 128). Variants: ``no_exp``
(p = s, no exponentials), ``no_first`` (no S and dP products: S = Q.K^T,
dP = dO.V^T, or their transposes), ``no_second`` (no dQ, or dV and dK,
products: their fragments are folded into one accumulator element by
integer XORs instead), ``no_loads`` (no copies after the first tiles),
``no_sync`` (no barrier a tile: the two warpgroups of a CTA run out of
step).

``flash_fwd``: the forward at phase D's causal bf16 case (B 2, S 2048,
32/8 heads, head_dim 128) and at phase H's (B 8, S 1024, 12/4 heads,
head_dim 64, causal). Variants: ``no_exp`` (p = x, no exponentials),
``no_s`` (no S products), ``no_pv`` (no P.V products: P's fragments are
folded into one accumulator element by integer XORs), ``no_loads`` (no
copies after the first tiles), ``no_rescale`` (O is not rescaled),
``no_sync`` (no barrier a tile), ``loads_only`` (no products and no
exponentials: what the tile loop costs without its arithmetic),
``skeleton`` (``loads_only`` without the copies).

``gmm``: the grouped GEMMs' wgmma kernels at the MoE slice's gate/up
product (8 experts, 16,384 rows from phase G's seeded top-2 router, K 768
-> N 2048, bf16): the forward, dlhs (the weight read transposed, K 2048 ->
N 768) and tgmm. Variants: ``no_mma`` (no products: the accumulator gets
a constant added), ``no_loads`` (no copies after the first two
stages), ``no_epilogue`` (the tile is not written), ``skeleton`` (none of
the three: the ring's waits and barriers, the block lookup and the
bookkeeping).
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# variant: [(text, replacement, occurrences)]
PREFILL_VARIANTS = {
    "base": [],
    "no_exp": [("float p = ex2(x - ((i & 2) ? mn1 : mn0));",
                "float p = x;", 1)],
    "no_pv": [("    issue_pv(t ? v_prev : v_addr);\n", "", 1)],
    "no_s": [("for (int kk = 0; kk < HD / 16; ++kk)\n      wgmma_ss_n64(",
              "for (int kk = 0; kk < 0; ++kk)\n      wgmma_ss_n64(", 1)],
    "no_loads": [("if (t + DIST < n_tiles) issue(t + DIST, "
                  "(t + DIST) % STAGES);", "", 1)],
    "no_rescale": [("for (int i = 0; i < HD / 2; ++i) o[i] *= ",
                    "for (int i = 0; i < 0; ++i) o[i] *= ", 1)],
    "no_convert": [("for (int k = 0; k < 2 * KT / JC; ++k)",
                    "for (int k = 0; k < 0; ++k)", 1)],
}

DECODE_VARIANTS = {
    "base": [],
    "no_loads": [("    if (k + RING - 1 < my_n) issue(next, (k + RING - 1) "
                  "% RING);\n", "", 1)],
    "no_s": [("      mma16816(s[0], qa[kk], kf[0], kf[1]);\n"
              "      mma16816(s[1], qa[kk], kf[2], kf[3]);\n",
              "      s[0][kk & 3] += __uint_as_float(qa[kk][0] ^ kf[0] ^ "
              "kf[1]);\n      s[1][kk & 3] += __uint_as_float(qa[kk][1] ^ "
              "kf[2] ^ kf[3]);\n", 1)],
    "no_pv": [("      mma16816(o[2 * np], pa, vf[0], vf[1]);\n"
               "      mma16816(o[2 * np + 1], pa, vf[2], vf[3]);\n"
               "      if constexpr (QUANT) {\n"
               "        mma16816(o[2 * np], pl, vf[0], vf[1]);\n"
               "        mma16816(o[2 * np + 1], pl, vf[2], vf[3]);\n"
               "      }\n",
               "      o[2 * np][0] += __uint_as_float(pa[0] ^ pl[0] ^ vf[0] "
               "^ vf[1]);\n      o[2 * np + 1][0] += __uint_as_float(pa[1] "
               "^ pl[1] ^ vf[2] ^ vf[3]);\n", 1)],
    "no_exp": [("float p = ex2(x - ((e & 2) ? mn1 : mn0));",
                "float p = x;", 1)],
    "no_convert": [("for (int i = 0; i < 2 * KT * UPK / 32; ++i) {",
                    "for (int i = 0; i < 0; ++i) {", 1)],
    "no_merge": [("it < rows * D4; it += n_split * NT) {",
                  "it < 0; it += n_split * NT) {", 1)],
}
# The design point beside this one: three ring slots a warp (two tiles
# ahead), at two CTAs an SM.
DECODE_VARIANTS["three_slots"] = [
    ("constexpr int RING = 2;", "constexpr int RING = 3;", 1),
    ("__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 2)", 1)]
DECODE_VARIANTS["skeleton"] = [
    sub for name in ("no_loads", "no_s", "no_pv", "no_exp", "no_convert",
                     "no_merge") for sub in DECODE_VARIANTS[name]]

FLASH_BWD_VARIANTS = {
    "base": [],
    "no_exp": [
        ("float p = ex2(fmaf(s[i], sl, -lse2[h]));", "float p = s[i];", 1),
        ("float p0 = ex2(fmaf(st[i], sl, -(l.x * LOG2E)));",
         "float p0 = st[i] + l.x;", 1),
        ("float p1 = ex2(fmaf(st[i + 1], sl, -(l.y * LOG2E)));",
         "float p1 = st[i + 1] + l.y;", 1)],
    # The products a variant leaves out are replaced by a few instructions
    # that keep their inputs and outputs alive and varying from tile to
    # tile: ptxas removes a chain of work whose results reach no store, the
    # wgmma products included, and hoists what a tile does not change.
    "no_first": [
        ("    wgmma_ss_rows<HD>(s, q_addr, ROWS, k_addr);\n",
         "    for (int i = 0; i < 32; ++i) s[i] = t + i;\n", 1),
        ("    wgmma_ss_rows<HD>(dp, do_addr, ROWS, v_addr);\n",
         "    for (int i = 0; i < 32; ++i) dp[i] = t + i;\n", 1),
        ("    wgmma_ss_rows<HD>(st, k_addr, ROWS, q_t);\n",
         "    for (int i = 0; i < 32; ++i) st[i] = t + i;\n", 1),
        ("    wgmma_ss_rows<HD>(dpt, v_addr, ROWS, do_t);\n",
         "    for (int i = 0; i < 32; ++i) dpt[i] = t + i;\n", 1)],
    "no_second": [
        ("      wgmma_rs<HD>(acc, dsf[kk], desc(k_addr + kk * 2048, "
         "KT * 128, 1024));",
         "      acc[kk] += __uint_as_float(dsf[kk][0] ^ dsf[kk][1] ^ "
         "dsf[kk][2] ^ dsf[kk][3]);", 1),
        ("      wgmma_rs<HD>(adv, pf[kk], desc(do_t + kk * 2048, "
         "QT * 128, 1024));",
         "      adv[kk] += __uint_as_float(pf[kk][0] ^ pf[kk][1] ^ "
         "pf[kk][2] ^ pf[kk][3]);", 1),
        ("      wgmma_rs<HD>(adk, dsf[kk], desc(q_t + kk * 2048, "
         "QT * 128, 1024));",
         "      adk[kk] += __uint_as_float(dsf[kk][0] ^ dsf[kk][1] ^ "
         "dsf[kk][2] ^ dsf[kk][3]);", 1)],
    "no_loads": [
        ("if (t + DIST < n_tiles) issue(t + DIST, (t + DIST) % STAGES);",
         "", 1),
        ("if (t + DIST < n_tiles) issue(u0 + t + DIST, (t + DIST) % STAGES);",
         "", 1)],
    "no_sync": [
        ("    __syncthreads();                 // ... for every thread; "
         "tile t - 1 done\n", "", 2)],
}

FLASH_FWD_VARIANTS = {
    "base": [],
    "no_exp": [("float p = ex2(x - ((i & 2) ? mn1 : mn0));",
                "float p = x;", 1)],
    # s keeps the previous tile's p, plus one: a full-rate add (an int to
    # float conversion would cost as much as an exponential).
    "no_s": [("    wgmma_ss_rows<HD>(s, q_addr, ROWS, v_addr(t) - P::TILE);\n",
              "    for (int i = 0; i < 32; ++i) s[i] += 1.f;\n", 1)],
    "no_pv": [("      wgmma_rs<HD>(acc, pa[kk], desc(va + kk * 2048, "
               "KT * 128, 1024));",
               "      acc[kk] += __uint_as_float(pa[kk][0] ^ pa[kk][1] ^ "
               "pa[kk][2] ^ pa[kk][3]);", 1)],
    "no_loads": [("if (t + DIST < n_tiles) issue(t + DIST, "
                  "(t + DIST) % STAGES);", "", 1)],
    "no_rescale": [("for (int i = 0; i < HD / 2; ++i) acc[i] *= ",
                    "for (int i = 0; i < 0; ++i) acc[i] *= ", 1)],
    "no_sync": [("    __syncthreads();                 // ... for every thread; "
                 "tile t - 3 done\n", "", 1)],
}
# What is left of a tile with no products and no exponentials: the copies,
# the waits, the barrier, the mask and the bookkeeping; and that less the
# copies.
FLASH_FWD_VARIANTS["loads_only"] = [
    *FLASH_FWD_VARIANTS["no_s"], *FLASH_FWD_VARIANTS["no_pv"],
    *FLASH_FWD_VARIANTS["no_exp"]]
FLASH_FWD_VARIANTS["skeleton"] = [*FLASH_FWD_VARIANTS["loads_only"],
                                  *FLASH_FWD_VARIANTS["no_loads"]]

GMM_VARIANTS = {
    "base": [],
    "no_mma": [("      wgmma_ss_n256<TA, TB>(acc, a_desc(st, kk), "
                "b_desc(st, kk), 1);", "      acc[kk] += 1.f;", 1)],
    "no_loads": [("    if (t + DIST < n_steps) issue(t + DIST, "
                  "(t + DIST) % STAGES);\n", "", 1)],
    # A guard no tile meets, uniform across the CTA (the epilogue has
    # barriers), keeps the accumulators live.
    "no_epilogue": [("  store_tile(acc, smem, ",
                     "  if (__syncthreads_or(acc[0] == 1.2345f)) "
                     "store_tile(acc, smem, ", 2)],
}
GMM_VARIANTS["skeleton"] = [*GMM_VARIANTS["no_mma"],
                            *GMM_VARIANTS["no_loads"],
                            *GMM_VARIANTS["no_epilogue"]]


def bind_decode(lib: ctypes.CDLL) -> None:
    lib.paged_decode_fwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode_fwd.restype = ctypes.c_int


def bind_prefill(lib: ctypes.CDLL) -> None:
    lib.paged_prefill_fwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_prefill_fwd.restype = ctypes.c_int


def bind_flash_bwd(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_bwd_dq_wgmma.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.flash_bwd_dkv_wgmma.argtypes = [ctypes.c_void_p] * 10 + tail
    for fn in (lib.flash_bwd_dq_wgmma, lib.flash_bwd_dkv_wgmma):
        fn.restype = ctypes.c_int


def bind_flash_fwd(lib: ctypes.CDLL) -> None:
    lib.flash_attn_fwd_wgmma.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attn_fwd_wgmma.restype = ctypes.c_int


def bind_gmm(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_wgmma_launch.argtypes = [ptr] * 5 + [i] * 7 + [ptr]
    lib.tgmm_wgmma_launch.argtypes = [ptr] * 5 + [i] * 6 + [ptr]
    lib.gmm_wgmma_launch.restype = lib.tgmm_wgmma_launch.restype = i


# label -> (launch on a library, the tensors that launch writes)
Launches = dict[str, tuple[Callable[[ctypes.CDLL], int],
                           tuple[torch.Tensor, ...]]]


def decode_case(dev: torch.device, stream: int) -> Launches:
    """The fp and int8 launches at phase A's decode case and at phase B's
    decode-profile shape."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    h, kv, hd, page, n_blocks = 32, 8, 128, 32, 64
    cases = {"a": [int(n) for n in
                   np.random.default_rng(0).integers(100, 2001, 4)],
             "b_profile": [512, 528, 544, 560]}
    splits = paged_attn._decode_splits(4, kv, paged_attn._num_sms(dev))

    def launch(q, pk, pv, scales, tables, pos, o):
        return lambda lib: lib.paged_decode_fwd(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            *(s.data_ptr() if s is not None else None for s in scales),
            tables.data_ptr(), pos.data_ptr(), o.data_ptr(), 4, 1, h, kv,
            hd, page, n_blocks, 1, splits, hd ** -0.5, stream)

    out = {}
    for name, lens in cases.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        pages = sum(-(-n // page) for n in lens) + 1
        q = torch.randn(4, 1, h, hd, device=dev, generator=gen).bfloat16()
        pools = [torch.randn(pages, page, kv * hd, device=dev,
                             generator=gen).bfloat16() for _ in range(2)]
        tables = torch.zeros(4, n_blocks, dtype=torch.int32, device=dev)
        perm = torch.randperm(pages - 1, device=dev, generator=gen) + 1
        used = 0
        for i, n in enumerate(lens):
            nb = -(-n // page)
            tables[i, :nb] = perm[used:used + nb]
            used += nb
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)[:, None] - 1
        (kq, ks), (vq, vs) = (quantize_kv(p.float().view(pages, page, kv,
                                                          hd)) for p in pools)
        o = torch.empty_like(q)
        out[f"{name}_fp"] = (launch(q, *pools, (None, None), tables, pos,
                                    o), (o,))
        out[f"{name}_int8"] = (launch(
            q, kq.view(pools[0].shape), vq.view(pools[1].shape), (ks, vs),
            tables, pos, o), (o,))
    return out


def prefill_case(dev: torch.device, stream: int) -> Launches:
    """The fp and int8 launches of a 512-query chunk at offset 1024."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)

    h, kv, hd, page, n_blocks, offset, sq = 32, 8, 128, 32, 64, 1024, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, sq, h, hd, device=dev, generator=gen).bfloat16()
    pools = [torch.randn(64, page, kv * hd, device=dev,
                         generator=gen).bfloat16() for _ in range(2)]
    tables = torch.zeros(1, n_blocks, dtype=torch.int32, device=dev)
    tables[0, :48] = torch.randperm(63, device=dev, generator=gen)[:48] + 1
    pos = (offset + torch.arange(sq, device=dev, dtype=torch.int32))[None]
    quant = [quantize_kv(p.float().view(64, page, kv, hd)) for p in pools]
    out = torch.empty_like(q)

    def launch(pk, pv, ks, vs):
        return lambda lib: lib.paged_prefill_fwd(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), 1, sq, h, kv, hd, page,
            n_blocks, 1, hd ** -0.5, 128, stream)

    return {"fp": (launch(pools[0], pools[1], None, None), (out,)),
            "int8": (launch(quant[0][0].view(pools[0].shape),
                            quant[1][0].view(pools[1].shape), quant[0][1],
                            quant[1][1]), (out,))}


def flash_bwd_case(dev: torch.device, stream: int) -> Launches:
    """The dQ and dK/dV launches at phase D's causal bf16 case."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    b, s, h, kv, hd = 2, 2048, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn(b, s, h, hd, device=dev, generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, s, kv, hd, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    o, lse = fa.flash_attention_reference(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    head = [x.data_ptr() for x in (q, k, v, do, lse, delta)] + [None, None]
    tail = [b, s, s, h, kv, hd, 1, 1, hd ** -0.5, stream]
    keep = (q, k, v, do, lse, delta)     # the launches hold raw pointers
    return {"dq": (lambda lib, keep=keep: lib.flash_bwd_dq_wgmma(
                *head, dq.data_ptr(), *tail), (dq,)),
            "dkv": (lambda lib, keep=keep: lib.flash_bwd_dkv_wgmma(
                *head, dk.data_ptr(), dv.data_ptr(), *tail), (dk, dv))}


def flash_fwd_case(dev: torch.device, stream: int) -> Launches:
    """The forward at phase D's causal bf16 case (head_dim 128) and at
    phase H's attention (head_dim 64)."""
    out = {}
    for label, (b, s, h, kv, hd) in (("d_causal", (2, 2048, 32, 8, 128)),
                                     ("h_causal", (8, 1024, 12, 4, 64))):
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, s, h, hd, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(b, s, kv, hd, device=dev,
                            generator=gen).bfloat16() for _ in range(2))
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, device=dev)
        args = ([x.data_ptr() for x in (q, k, v)] + [None, None]
                + [o.data_ptr(), lse.data_ptr(), b, s, s, h, kv, hd, 1, 1,
                   hd ** -0.5, stream])
        out[label] = (lambda lib, args=args, keep=(q, k, v):    # pointers
                      lib.flash_attn_fwd_wgmma(*args), (o, lse))
    return out


def gmm_case(dev: torch.device, stream: int) -> Launches:
    """The forward, dlhs and tgmm launches at the MoE slice's gate/up
    product, with phase G's router group sizes."""
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops

    e, rows, k, n = 8, 16384, 768, 2048
    logits = np.random.default_rng(5).standard_normal((rows // 2, e))
    sizes = np.bincount(np.argsort(-logits, axis=1)[:, :2].ravel(),
                        minlength=e)
    lay = gmm_ops.grouped_layout(
        torch.tensor(sizes, dtype=torch.int32, device=dev), rows)
    gen = torch.Generator(device=dev).manual_seed(0)
    live = gmm_ops.live_rows(lay)[:, None]
    lhs = (torch.randn(lay.m_pad, k, device=dev, generator=gen)
           * live).bfloat16()
    rhs = (torch.randn(e, k, n, device=dev, generator=gen)
           * k ** -0.5).bfloat16()
    dout = (torch.randn(lay.m_pad, n, device=dev, generator=gen)
            * live).bfloat16()
    out = torch.empty(lay.m_pad, n, device=dev, dtype=torch.bfloat16)
    dlhs = torch.empty_like(lhs)
    drhs = torch.empty_like(rhs)
    be, bl, ro, gs = (t.data_ptr() for t in (
        lay.block_expert, lay.block_live, lay.row_offset, lay.group_sizes))
    keep = (lhs, rhs, dout, lay)         # the launches hold raw pointers
    return {
        "fwd": (lambda lib, keep=keep: lib.gmm_wgmma_launch(
            lhs.data_ptr(), rhs.data_ptr(), be, bl, out.data_ptr(),
            lay.m_pad, k, n, e, lay.block_m, 0, 1, stream), (out,)),
        "dlhs": (lambda lib, keep=keep: lib.gmm_wgmma_launch(
            dout.data_ptr(), rhs.data_ptr(), be, bl, dlhs.data_ptr(),
            lay.m_pad, n, k, e, lay.block_m, 1, 1, stream), (dlhs,)),
        "tgmm": (lambda lib, keep=keep: lib.tgmm_wgmma_launch(
            lhs.data_ptr(), dout.data_ptr(), ro, gs, drhs.data_ptr(),
            lay.m_pad, k, n, e, lay.block_m, 1, stream), (drhs,))}


class Kernel(NamedTuple):
    source: str
    variants: dict[str, list[tuple[str, str, int]]]
    bind: Callable[[ctypes.CDLL], None]
    case: Callable[[torch.device, int], Launches]


KERNELS = {
    "decode": Kernel("paged_decode.cu", DECODE_VARIANTS, bind_decode,
                     decode_case),
    "prefill": Kernel("paged_prefill.cu", PREFILL_VARIANTS, bind_prefill,
                      prefill_case),
    "flash_bwd": Kernel("flash_bwd.cu", FLASH_BWD_VARIANTS, bind_flash_bwd,
                        flash_bwd_case),
    "flash_fwd": Kernel("flash_fwd.cu", FLASH_FWD_VARIANTS, bind_flash_fwd,
                        flash_fwd_case),
    "gmm": Kernel("gmm_wgmma.cu", GMM_VARIANTS, bind_gmm, gmm_case),
}


def build(kernel: Kernel, out_dir: Path,
          against: Path | None = None) -> dict[str, ctypes.CDLL]:
    """Compile every variant (or, with ``against``, the source as it is in
    this checkout and in that one), one nvcc each, all started together.
    Each source sees the headers of its own ``csrc/``."""
    from k8s_distributed_deeplearning_torch.ops import _build

    csrc = _build.CSRC_DIR
    src = (csrc / kernel.source).read_text()
    if against is None:
        sources = {}
        for name, subs in kernel.variants.items():
            text = src
            for old, new, count in subs:
                if text.count(old) != count:
                    raise RuntimeError(f"variant {name}: the source no "
                                       f"longer holds {old!r} {count} "
                                       f"time(s)")
                text = text.replace(old, new)
            sources[name] = (text, csrc)
    else:
        other = against / csrc.relative_to(_build.PKG_DIR.parent)
        sources = {"base": (src, csrc),
                   "against": ((other / kernel.source).read_text(), other)}
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include),
             "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        kernel.bind(lib)
        libs[name] = lib
    return libs


def main(argv: list[str]) -> int:
    against = None
    if len(argv) == 3 and argv[1] == "--against":
        against = Path(argv[2]).resolve()
        argv = argv[:1]
    if len(argv) != 1 or argv[0] not in KERNELS:
        print(f"usage: kernel_breakdown.py {{{','.join(KERNELS)}}} "
              f"[--against DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from k8s_distributed_deeplearning_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    kernel = KERNELS[argv[0]]
    libs = build(kernel, _build.BUILD_DIR / f"breakdown_{argv[0]}", against)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    launches = kernel.case(dev, stream)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def run(fn, lib):
        rc = fn(lib)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    same = True
    if against is not None:
        for label, (fn, outs) in launches.items():
            run(fn, libs["base"])
            base = [x.clone() for x in outs]
            run(fn, libs["against"])
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(base, outs))
            same = same and equal
            print(json.dumps({
                "launch": label, "bitwise_equal": equal,
                "max_abs_diff": max(float((a.float() - b.float()).abs().max())
                                    for a, b in zip(base, outs))}),
                flush=True)

    def time_ms(fn, lib, iters=30):
        for _ in range(3):
            run(fn, lib)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            flush.zero_()
            s.record()
            run(fn, lib)
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e)
                                for s, e in zip(starts, ends)]))

    for rnd in range(2):
        for name, lib in libs.items():
            for label, (fn, _) in launches.items():
                print(json.dumps({
                    "round": rnd, "variant": name, "launch": label,
                    "ms": time_ms(fn, lib)}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
