#!/usr/bin/env python3
"""Where a tile's time goes in a tensor-core kernel of the port.

    python3 kernel_breakdown.py decode       # csrc/paged_decode.cu
    python3 kernel_breakdown.py prefill      # csrc/paged_prefill.cu
    python3 kernel_breakdown.py flash_bwd    # csrc/flash_bwd.cu
    python3 kernel_breakdown.py flash_bwd_f32  # csrc/flash_bwd_f32.cu
    python3 kernel_breakdown.py flash_fwd    # csrc/flash_fwd.cu
    python3 kernel_breakdown.py gmm          # csrc/gmm_wgmma.cu
    python3 kernel_breakdown.py paged_f32    # csrc/paged_attn_f32.cu
    python3 kernel_breakdown.py gmm_f32      # csrc/gmm_f32.cu
    python3 kernel_breakdown.py tgmm_f32     # csrc/gmm_f32.cu, tgmm
    python3 kernel_breakdown.py paged_small  # csrc/paged_decode.cu, hd 16
    python3 kernel_breakdown.py paged_small_f32  # paged_attn_f32.cu, hd 16
    python3 kernel_breakdown.py flash_small  # csrc/flash_small.cu
    python3 kernel_breakdown.py flash_fwd_f32  # csrc/flash_fwd_f32.cu
    python3 kernel_breakdown.py flash_delta  # csrc/flash_delta.cu
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
builds as above. A launch the other build refuses (a shape its kernel
does not take) is printed as refused and timed on this build alone.

``decode``: Llama-3 8B's heads (32 q, 8 KV, head_dim 128, 32-token pages),
fp and int8 pools, one query a row at phase A's decode case (B 4, live
lengths drawn as phase A draws them, 64-block tables) and at phase B's
decode-profile shape (B 4, live 512-560 of 64 blocks), and a speculative
verify window of 8 at that shape (32 rows a KV head: two row tiles), the
CTA count the wrapper picks. Variants: ``no_loads`` (no copies after the
first two tiles of a warp), ``no_s`` (no S products), ``no_pv`` (no P.V
products: their fragments are folded into one accumulator element by
integer XORs), ``no_exp`` (p = x, no exponentials), ``no_convert`` (int8: no
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

``flash_bwd_f32``: the f32 dQ and dK/dV kernels (three-pass TF32) at
phase D's causal f32 case (B 2, S 2048, 32/8 heads, head_dim 128) and at
phase H's attention in f32 (B 8, S 1024, 12/4 heads, head_dim 64,
causal). Variants: ``no_split`` (hi = x, lo = 0: no split instructions;
the three products still run), ``no_products`` (no mma.sync: their
operands are folded into the accumulator by integer XORs), ``no_exp`` (p
= x, no exponentials), ``no_loads`` (no copies after the first tile),
``skeleton`` (none of these: the tile loop's waits, barriers, fragment
loads, masks and bookkeeping). ``--against DIR`` needs the same source in
``DIR``.

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

``paged_f32``: the f32 paged-attention kernel (three-pass TF32) at
Llama-3 8B's heads (32/8, head_dim 128, 32-token pages), fp and int8
pools: phase A's f32 decode case (B 4, live 100-2000 of 64 blocks), its
512-query chunk at offset 1024 (64-row tiles) and its verify window of 8
at phase P's table width (live 512-560 of 65 blocks), the CTA count the
wrapper picks. Variants: ``no_split`` (hi = x, lo = 0: no split
instructions; the products still run), ``no_products`` (no mma.sync:
their operands are folded into the accumulator by integer XORs),
``no_exp`` (p = x, no exponentials), ``no_loads`` (no copies after the
first tile), ``no_merge`` (the cluster's CTA states are not merged),
``skeleton`` (none of these).

``gmm_f32``: the f32 grouped GEMM (three-pass TF32) at the MoE slice's
gate/up product in f32 (phase G's router group sizes, K 768 -> N 2048):
the forward and dlhs (K 2048 -> N 768 on the weight read transposed).
Variants: ``no_split``, ``no_products``, ``no_loads`` (no copies after
the first stage), ``skeleton`` (none of the three), and, not a stage,
``three_stages`` (a third stage in shared memory, two ahead).

``tgmm_f32``: the f32 weight gradient (``tgmm_tf32x3``, three-pass TF32)
at the MoE slice's shapes in f32: phase G's router group sizes at K 768 /
N 2048 and K 2048 / N 768, a skewed layout (one expert 40 %, one empty)
and every row in one expert, at K 768 / N 2048. Variants: ``no_split``,
``no_products``, ``no_loads`` (no copies after the first stage),
``skeleton`` (none of the three).

``paged_small``: the decode kernel at head_dim 16 in bf16, fp and int8
pools: the micro draft's 2/1 heads at an 8-slot decode and at a
512-token prefill chunk at offset 0 (1,024 rows a KV head), and the tiny
preset's 4/2 heads at phase A's 8-slot decode; 32-token pages, the CTA
count the wrapper picks. Variants: ``decode``'s. ``paged_small_f32``: the
tf32x3 kernel at phase A's tiny-preset cases (4/2 heads, head_dim 16: the
8-slot decode and the 128-query prefill), fp and int8. Variants:
``paged_f32``'s.

``flash_small``: the bf16 forward, dQ and dK/dV kernels at head_dim 16
and 32 at phase Q's attention (B 8, S 1024, 4/2 heads, head_dim 16,
causal) and at phase D's head_dim-32 case (the same with head_dim 32 and
documents of 300/400/324 tokens); dK/dV also at cluster sizes 1, 2, 3, 4
and 8 beside the wrapper's choice. Variants: ``no_exp`` (p = the
exponent, no ex2), ``no_s`` (no S = Q.K^T, S^T or dP^T products: their
fragments are folded into one accumulator element by integer XORs),
``no_dp`` (dQ: no dP = dO.V^T products, likewise), ``no_pv`` (no P.V,
dS.K, dV or dK products, likewise), ``no_loads`` (no copies after the
first tile), ``no_merge`` (the cluster's partials are not summed or
written), ``skeleton`` (none of these), ``no_tiles`` (no tile or row
step: the prologue, the epilogue and the merge) and ``empty`` (every CTA
returns at once: the launch), and, not stages, ``kt64`` (64-key forward
tiles), ``dq_kt128`` (128-key dQ tiles, the forward's), ``dkv_4_ctas``
(dK/dV held to 128 registers, four CTAs an SM) and ``three_stages``
(three ring slots, two tiles ahead, in all three kernels).

``flash_fwd_f32``: the f32 forward (three-pass TF32) at phase D's causal
f32 case (B 2, S 2048, 32/8 heads, head_dim 128), at phase H's attention
in f32 (B 8, S 1024, 12/4 heads, head_dim 64, causal) and at phase Q's f32
attention (B 8, S 1024, 4/2 heads, head_dim 16, causal). Variants:
``no_split`` (hi = x, lo = 0: no split instructions; the three products
still run), ``no_products`` (no mma.sync: their operands are folded into
the accumulator by integer XORs), ``no_exp`` (p = the exponent, no ex2),
``no_loads`` (no copies after the first tile), ``skeleton`` (none of
these: the tile loop's waits, barriers, fragment loads, masks and
bookkeeping).

``flash_delta``: the bf16 backward's delta on both routes (the wgmma
kernel ``flash_delta_wgmma`` and the small route's ``flash_delta_kernel``,
forced at these head dims) at phase D's causal bf16 case (B 2, S 2048,
32/8 heads, head_dim 128) and at BERT-base's attention (B 16, S 512,
12/12 heads, head_dim 64, bidirectional). Variants: ``no_exp`` (p = the
exponent, no ex2), ``no_products`` (no S or dP products: wgmma's
accumulators get 1 added, mma.sync's fragments are folded into one
accumulator element by integer XORs), ``no_loads`` (no copies after the
first ring's worth: the wgmma kernel's producer still completes each
slot's barrier), ``loads_only`` (``no_products`` and ``no_exp``: the
loads, waits, barriers, masks and FMAs of the tile loop), ``skeleton``
(``loads_only`` without the copies), ``no_tiles`` (no tile: the launch,
the Q and dO loads and the epilogue), and, not stages, the wgmma
kernel's design points ``ss`` (Q and dO read by wgmma from shared
memory at every head dim), ``rs_one_cta`` (from registers at every head
dim, one CTA an SM), ``five_slots`` (a five-slot ring), ``tiles_first``
(without a causal mask too, the launch order by row tile, heaviest
first, then head), ``heads_first`` (with one too, by head, then row
tile) and ``two_buffers`` (two buffers of S and dP: tile t + 1's products
issued before tile t's exponentials; one CTA an SM).
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
    "no_merge": [("it < tr * D4; it += n_split * NT) {",
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

# tf32x3.cuh reads TF32X3_NO_SPLIT and TF32X3_NO_MMA.
_TF32X3_INCLUDE = '#include "tf32x3.cuh"'
FLASH_BWD_F32_VARIANTS = {
    "base": [],
    "no_split": [(_TF32X3_INCLUDE,
                  "#define TF32X3_NO_SPLIT\n" + _TF32X3_INCLUDE, 1)],
    "no_products": [(_TF32X3_INCLUDE,
                     "#define TF32X3_NO_MMA\n" + _TF32X3_INCLUDE, 1)],
    "no_exp": [
        ("const float p = ok ? expf(x - lse_r[h]) : 0.f;",
         "const float p = ok ? x - lse_r[h] : 0.f;", 1),
        ("const float p = ok ? expf(st[n][e] * g.scale - lse_s[c]) : 0.f;",
         "const float p = ok ? st[n][e] * g.scale - lse_s[c] : 0.f;", 1)],
    "no_loads": [
        ("    if (t + 1 < n_tiles) issue(t + 1, (t + 1) & 1);\n", "", 1),
        ("    if (u + 1 < n_rt) issue(u + 1, stage ^ 1);\n", "", 1)],
}
FLASH_BWD_F32_VARIANTS["skeleton"] = [
    sub for name in ("no_split", "no_products", "no_exp", "no_loads")
    for sub in FLASH_BWD_F32_VARIANTS[name]]

PAGED_F32_VARIANTS = {
    "base": [],
    "no_split": FLASH_BWD_F32_VARIANTS["no_split"],
    "no_products": FLASH_BWD_F32_VARIANTS["no_products"],
    "no_exp": [("float p = ex2(x - ((e & 2) ? mn1 : mn0));",
                "float p = x;", 1)],
    "no_loads": [("    if (t + 1 < t_hi) issue(t + 1, (t + 1 - t_lo) & 1);\n",
                  "", 1)],
    "no_merge": [("it < tr * D4; it += n_split * NT) {",
                  "it < 0; it += n_split * NT) {", 1)],
}
PAGED_F32_VARIANTS["skeleton"] = [
    sub for name in ("no_split", "no_products", "no_exp", "no_loads",
                     "no_merge") for sub in PAGED_F32_VARIANTS[name]]

GMM_F32_VARIANTS = {
    "base": [],
    "no_split": FLASH_BWD_F32_VARIANTS["no_split"],
    "no_products": FLASH_BWD_F32_VARIANTS["no_products"],
    "no_loads": [("      if (ahead < n_k) load(ahead % STAGES, ahead * "
                  "BK);\n", "", 1)],
}
GMM_F32_VARIANTS["skeleton"] = [
    sub for name in ("no_split", "no_products", "no_loads")
    for sub in GMM_F32_VARIANTS[name]]
# The design point beside this one: three stages, two ahead.
GMM_F32_VARIANTS["three_stages"] = [
    ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;", 1)]

TGMM_F32_VARIANTS = {
    "base": [],
    "no_split": FLASH_BWD_F32_VARIANTS["no_split"],
    "no_products": FLASH_BWD_F32_VARIANTS["no_products"],
    "no_loads": [("    if (ahead < n_steps) load(ahead % STAGES, r_begin + "
                  "ahead * BK);\n", "", 1)],
}
TGMM_F32_VARIANTS["skeleton"] = [
    sub for name in ("no_split", "no_products", "no_loads")
    for sub in TGMM_F32_VARIANTS[name]]

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

def _xor_mma(acc, a, b, count, a_words=(0,)):
    """A product ``mma_bf16(acc[2 * np (+ 1)], a, b[i], b[i + 1])`` left
    out: replaced by an XOR of its fragments into one accumulator element,
    so that the fragment loads stay live; ``count`` kernels hold it."""
    words = " ^ ".join(f"{a}[{w}]" for w in a_words)
    return [(f"mma_bf16({acc}[2 * np{plus}], {a}, {b}[{i}], {b}[{i + 1}]);",
             f"{acc}[2 * np{plus}][0] += __uint_as_float({words} ^ "
             f"{b}[{i}] ^ {b}[{i + 1}]);", count)
            for plus, i in (("", 0), (" + 1", 2))]


FLASH_SMALL_VARIANTS = {
    "base": [],
    "no_exp": [
        (f"const float p{i} = ex2(fmaf(s[n][{i}], sl, -mn{i // 2}));",
         f"const float p{i} = fmaf(s[n][{i}], sl, -mn{i // 2});", 1)
        for i in range(4)] + [
        ("float p = ex2(fmaf(st[n][e], sl, -(lse_s[c] * LOG2E)));",
         "float p = fmaf(st[n][e], sl, -(lse_s[c] * LOG2E));", 1),
        ("const float p = ex2(fmaf(s[n][e], sl, -lse2[h]));",
         "const float p = fmaf(s[n][e], sl, -lse2[h]);", 1)],
    # S = Q.K^T in the forward and in dQ; S^T and dP^T in dK/dV.
    "no_s": [*_xor_mma("s", "qa[kk]", "kb", 2),
             *_xor_mma("st", "kf[kk]", "qb", 1),
             *_xor_mma("dpt", "vf[kk]", "ob", 1)],
    "no_dp": _xor_mma("dp", "da[kk]", "vb", 1),
    "no_pv": [*_xor_mma("acc", "pa[kk]", "vb", 1, (0, 3)),
              *_xor_mma("acc", "dsa[kk]", "kt", 1, (0, 3)),
              *_xor_mma("adv", "pa", "ob", 1, (0, 3)),
              *_xor_mma("adk", "da", "qb", 1, (0, 3))],
    "no_loads": [
        ("    if (t + DIST < n_tiles) issue(t + DIST, (t + DIST) % "
         "FWD_STAGES);\n", "", 1),
        ("    if (t + DIST < n_tiles) fetch(t + DIST, (t + DIST) % "
         "FWD_STAGES);\n", "", 1),
        ("    if (u + DIST < n_my) issue(u + DIST, (u + DIST) % "
         "DKV_STAGES);\n", "", 1)],
    "no_merge": [("it < ITEMS; it += n_split * NT) {",
                  "it < 0; it += n_split * NT) {", 1)],
    # What a launch costs with no tile: the prologue's copies, the
    # epilogue's stores and (dK/dV) the merge; and with no work at all.
    "no_tiles": [
        ("  const int n_tiles = (kend + KT - 1) / KT;",
         "  const int n_tiles = 0 * kend;", 1),
        ("  const int n_tiles = kend > 0 ? (kend + DQ_KT - 1) / DQ_KT : 0;",
         "  const int n_tiles = 0 * kend;", 1),
        ("  const int n_my = n_steps * (rank + 1) / n_split - u_lo;",
         "  const int n_my = 0 * (n_steps * (rank + 1) / n_split - u_lo);",
         1)],
    "empty": [("  const int tid = threadIdx.x, lane = tid & 31, "
               "warp = tid >> 5;\n",
               "  if (g.batch > 0) return;\n  const int tid = threadIdx.x, "
               "lane = tid & 31, warp = tid >> 5;\n", 3)],
}
FLASH_SMALL_VARIANTS["skeleton"] = [
    sub for name in ("no_exp", "no_s", "no_dp", "no_pv", "no_loads",
                     "no_merge") for sub in FLASH_SMALL_VARIANTS[name]]
# Design points beside the kernels' own.
FLASH_SMALL_VARIANTS["kt64"] = [("constexpr int KT = 128;",
                                 "constexpr int KT = 64;", 1)]
FLASH_SMALL_VARIANTS["dq_kt128"] = [("constexpr int DQ_KT = 64;",
                                     "constexpr int DQ_KT = 128;", 1)]
FLASH_SMALL_VARIANTS["dkv_4_ctas"] = [
    ("__global__ void __launch_bounds__(NT)\nflash_dkv_small(",
     "__global__ void __launch_bounds__(NT, 4)\nflash_dkv_small(", 1)]
FLASH_SMALL_VARIANTS["three_stages"] = [
    ("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 3;", 1),
    ("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 3;", 1)]

FLASH_FWD_F32_VARIANTS = {
    "base": [],
    "no_split": FLASH_BWD_F32_VARIANTS["no_split"],
    "no_products": FLASH_BWD_F32_VARIANTS["no_products"],
    "no_exp": [("const float p = ex2(fmaf(s[n][e], sl, -((e & 2) ? mn1 : "
                "mn0)));", "const float p = fmaf(s[n][e], sl, -((e & 2) ? "
                "mn1 : mn0));", 1)],
    "no_loads": [("    if (t + 1 < n_tiles) fetch(t + 1, (t + 1) & 1);\n",
                  "", 1)],
}
FLASH_FWD_F32_VARIANTS["skeleton"] = [
    sub for name in ("no_split", "no_products", "no_exp", "no_loads")
    for sub in FLASH_FWD_F32_VARIANTS[name]]

# flash_delta.cu holds both routes' kernels: a variant leaves its stage
# out of both.
FLASH_DELTA_VARIANTS = {
    "base": [],
    "no_exp": [
        ("float p = ex2(fmaf(s[i], sl, -lse2[h]));",
         "float p = fmaf(s[i], sl, -lse2[h]);", 1),
        ("acc[h] = fmaf(ex2(fmaf(s[n][e], sl, -lse2[h])), dp[n][e], acc[h]);",
         "acc[h] = fmaf(fmaf(s[n][e], sl, -lse2[h]), dp[n][e], acc[h]);", 1)],
    "no_products": [
        ("    if constexpr (P::A_IN_REGS) {\n#pragma unroll\n",
         "    for (int i = 0; i < 32; ++i) s[i] += 1.f, dp[i] += 1.f;\n"
         "    if constexpr (false) {\n#pragma unroll\n", 1),
        ("    } else {\n      wgmma_ss_rows<HD>(s, q_addr",
         "    } else if constexpr (false) {\n      wgmma_ss_rows<HD>(s, q_addr",
         1),
        *_xor_mma("s", "qa[kk]", "kb", 1), *_xor_mma("dp", "da[kk]", "vb", 1)],
    # The producer still completes every slot's barrier, with no bytes.
    "no_loads": [
        ("mbar_expect(bar, P::STAGE);",
         "mbar_expect(bar, u < W_STAGES ? P::STAGE : 0);", 1),
        ("for (int c = 0; c < HD / 64; ++c) {\n          tma_load(",
         "for (int c = 0; c < (u < W_STAGES ? HD / 64 : 0); ++c) {\n"
         "          tma_load(", 1),
        ("    if (t + DIST < n_tiles) fetch(t + DIST, (t + DIST) % STAGES);\n",
         "", 1)],
    "no_tiles": [("kend > 0 ? (kend + KT - 1) / KT : 0", "0 * kend", 2)],
    # Design points beside the wgmma kernel's own: Q and dO read by wgmma
    # from shared memory at every head dim; from registers at every head
    # dim (one CTA an SM); a five-slot ring; the causal launch order
    # always; the other launch order always; two buffers of S and dP, tile
    # t + 1's products issued before tile t's exponentials and waited for
    # after them (one CTA an SM, Q and dO from shared memory).
    "ss": [("static constexpr bool A_IN_REGS = CTAS_PER_SM == 1;",
            "static constexpr bool A_IN_REGS = false;", 1)],
    "rs_one_cta": [("static constexpr int CTAS_PER_SM = HD == 128 ? 1 : 2;",
                    "static constexpr int CTAS_PER_SM = 1;", 1)],
    "five_slots": [("constexpr int W_STAGES = 4;",
                    "constexpr int W_STAGES = 5;", 1)],
    "tiles_first": [("  return !g.causal && g.n_kv * g.batch <= 65535;",
                     "  return false;", 1)],
    "heads_first": [("  return !g.causal && g.n_kv * g.batch <= 65535;",
                     "  return g.n_kv * g.batch <= 65535;", 1)],
    "two_buffers": [
        ("static constexpr int CTAS_PER_SM = HD == 128 ? 1 : 2;",
         "static constexpr int CTAS_PER_SM = 1;", 1),
        ("static constexpr bool A_IN_REGS = CTAS_PER_SM == 1;",
         "static constexpr bool A_IN_REGS = false;", 1),
        ("""#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    products(t, s0, d0);
    land(s0, d0);
    accumulate(t, s0, d0);
  }
""", """  float s1[32], d1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s1[i] = d1[i] = 0.f;
  auto step = [&](int t, float (&sc)[32], float (&dc)[32],
                  float (&sn)[32], float (&dn)[32]) {
    products(t + 1, sn, dn);
    fence_regs(sc);
    fence_regs(dc);
    accumulate(t, sc, dc);
    fence_regs(acc);
    land(sn, dn);
  };
  if (n_tiles > 0) {
    products(0, s0, d0);
    land(s0, d0);
    int t = 0;
#pragma unroll 1
    for (; t + 2 < n_tiles; t += 2) {
      step(t, s0, d0, s1, d1);
      step(t + 1, s1, d1, s0, d0);
    }
    if (t + 1 < n_tiles) {
      step(t, s0, d0, s1, d1);
      accumulate(t + 1, s1, d1);
    } else {
      accumulate(t, s0, d0);
    }
  }
""", 1)],
}
FLASH_DELTA_VARIANTS["loads_only"] = [*FLASH_DELTA_VARIANTS["no_products"],
                                      *FLASH_DELTA_VARIANTS["no_exp"]]
FLASH_DELTA_VARIANTS["skeleton"] = [*FLASH_DELTA_VARIANTS["loads_only"],
                                    *FLASH_DELTA_VARIANTS["no_loads"]]

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


def bind_flash_bwd_f32(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_bwd_dq_tf32x3.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.flash_bwd_dkv_tf32x3.argtypes = [ctypes.c_void_p] * 10 + tail
    for fn in (lib.flash_bwd_dq_tf32x3, lib.flash_bwd_dkv_tf32x3):
        fn.restype = ctypes.c_int


def bind_flash_fwd(lib: ctypes.CDLL) -> None:
    lib.flash_attn_fwd_wgmma.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attn_fwd_wgmma.restype = ctypes.c_int


def bind_flash_small(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 8 + [ctypes.c_float]
    lib.flash_attn_fwd_small.argtypes = (
        [ctypes.c_void_p] * 7 + tail + [ctypes.c_void_p])
    lib.flash_attn_bwd_dq_small.argtypes = (
        [ctypes.c_void_p] * 9 + tail + [ctypes.c_void_p])
    lib.flash_attn_bwd_dkv_small.argtypes = (
        [ctypes.c_void_p] * 10 + tail + [ctypes.c_int, ctypes.c_void_p])
    for fn in (lib.flash_attn_fwd_small, lib.flash_attn_bwd_dq_small,
               lib.flash_attn_bwd_dkv_small):
        fn.restype = ctypes.c_int


def bind_flash_fwd_f32(lib: ctypes.CDLL) -> None:
    lib.flash_attn_fwd_tf32x3.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attn_fwd_tf32x3.restype = ctypes.c_int


def bind_flash_delta(lib: ctypes.CDLL) -> None:
    for fn in (lib.flash_bwd_delta, lib.flash_bwd_delta_wgmma):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int


def bind_gmm(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_wgmma_launch.argtypes = [ptr] * 5 + [i] * 7 + [ptr]
    lib.tgmm_wgmma_launch.argtypes = [ptr] * 5 + [i] * 6 + [ptr]
    lib.gmm_wgmma_launch.restype = lib.tgmm_wgmma_launch.restype = i


def bind_paged_f32(lib: ctypes.CDLL) -> None:
    lib.paged_attn_tf32x3_fwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_attn_tf32x3_fwd.restype = ctypes.c_int


def bind_gmm_f32(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_tf32x3_launch.argtypes = [ptr] * 5 + [i] * 7 + [ptr]
    lib.tgmm_tf32x3_launch.argtypes = [ptr] * 5 + [i] * 6 + [ptr]
    lib.gmm_tf32x3_launch.restype = lib.tgmm_tf32x3_launch.restype = i


# label -> (launch on a library, the tensors that launch writes)
Launches = dict[str, tuple[Callable[[ctypes.CDLL], int],
                           tuple[torch.Tensor, ...]]]


# The decode launches, name -> (live lengths of the 4 rows, queries a
# row): phase A's decode case, phase B's decode-profile shape, and a
# verify window of 8 at that shape.
DECODE_LAUNCHES = {
    "a": ([int(n) for n in np.random.default_rng(0).integers(100, 2001, 4)],
          1),
    "b_profile": ([512, 528, 544, 560], 1),
    "b_profile_w8": ([512, 528, 544, 560], 8),
}
DECODE_HEADS = (32, 8, 128)             # q heads, KV heads, head_dim


def decode_case(dev: torch.device, stream: int) -> Launches:
    """The fp and int8 launches of DECODE_LAUNCHES."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    (h, kv, hd), page, n_blocks = DECODE_HEADS, 32, 64

    def launch(q, pk, pv, scales, tables, pos, o):
        sq = q.shape[1]
        splits = paged_attn._decode_splits(4, kv, paged_attn._num_sms(dev),
                                           sq * (h // kv))
        return lambda lib: lib.paged_decode_fwd(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            *(s.data_ptr() if s is not None else None for s in scales),
            tables.data_ptr(), pos.data_ptr(), o.data_ptr(), 4, sq, h, kv,
            hd, page, n_blocks, 1, splits, hd ** -0.5, stream)

    out = {}
    for name, (lens, sq) in DECODE_LAUNCHES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        pages = sum(-(-n // page) for n in lens) + 1
        q = torch.randn(4, sq, h, hd, device=dev, generator=gen).bfloat16()
        pools = [torch.randn(pages, page, kv * hd, device=dev,
                             generator=gen).bfloat16() for _ in range(2)]
        tables = torch.zeros(4, n_blocks, dtype=torch.int32, device=dev)
        perm = torch.randperm(pages - 1, device=dev, generator=gen) + 1
        used = 0
        for i, n in enumerate(lens):
            nb = -(-n // page)
            tables[i, :nb] = perm[used:used + nb]
            used += nb
        pos = (torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]
               - sq + torch.arange(sq, dtype=torch.int32, device=dev))
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


def flash_bwd_f32_case(dev: torch.device, stream: int) -> Launches:
    """The f32 dQ and dK/dV launches at phase D's causal f32 case (head_dim
    128) and at phase H's attention (head_dim 64)."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    out = {}
    for label, (b, s, h, kv, hd) in (("d", (2, 2048, 32, 8, 128)),
                                     ("h", (8, 1024, 12, 4, 64))):
        gen = torch.Generator(device=dev).manual_seed(0)
        q, do = (torch.randn(b, s, h, hd, device=dev, generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(b, s, kv, hd, device=dev, generator=gen)
                for _ in range(2))
        o, lse = fa.flash_attention_reference(q, k, v, causal=True)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        head = [x.data_ptr() for x in (q, k, v, do, lse, delta)] + [None,
                                                                    None]
        tail = [b, s, s, h, kv, hd, 1, 0, hd ** -0.5, stream]
        keep = (q, k, v, do, lse, delta)   # the launches hold raw pointers
        out[f"{label}_dq"] = (
            lambda lib, head=head, tail=tail, dq=dq, keep=keep:
            lib.flash_bwd_dq_tf32x3(*head, dq.data_ptr(), *tail), (dq,))
        out[f"{label}_dkv"] = (
            lambda lib, head=head, tail=tail, dk=dk, dv=dv, keep=keep:
            lib.flash_bwd_dkv_tf32x3(*head, dk.data_ptr(), dv.data_ptr(),
                                     *tail), (dk, dv))
    return out


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


# name -> (B, S, H, KV, head_dim, document lengths or None), causal.
FLASH_SMALL_LAUNCHES = {"q": (8, 1024, 4, 2, 16, None),
                        "hd32_docs": (8, 1024, 4, 2, 32, (300, 400, 324))}


def flash_small_case(dev: torch.device, stream: int) -> Launches:
    """The forward, dQ and dK/dV at phase Q's attention and at phase D's
    head_dim-32 case with documents; dK/dV at the wrapper's cluster size
    and at 1, 2, 3, 4 and 8."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    out = {}
    for label, (b, s, h, kv, hd, docs) in FLASH_SMALL_LAUNCHES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        q, do = (torch.randn(b, s, h, hd, device=dev,
                             generator=gen).bfloat16() for _ in range(2))
        k, v = (torch.randn(b, s, kv, hd, device=dev,
                            generator=gen).bfloat16() for _ in range(2))
        segq = segk = None
        if docs is not None:
            ids = torch.repeat_interleave(
                torch.arange(1, len(docs) + 1, device=dev),
                torch.tensor(docs, device=dev)).to(torch.int32)
            segq = segk = ids[None].expand(b, s).contiguous()
        o, lse = fa.flash_attention_reference(
            q, k, v, causal=True, q_segment_ids=segq, kv_segment_ids=segk)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        o, dq = torch.empty_like(q), torch.empty_like(q)
        lse_out = torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        segs = [None if x is None else x.data_ptr() for x in (segq, segk)]
        shape = [b, s, s, h, kv, hd, 1, 1, hd ** -0.5]
        keep = (q, k, v, do, lse, delta, segq, segk)   # raw pointers
        out[f"{label}_fwd"] = (
            lambda lib, a=[x.data_ptr() for x in (q, k, v)] + segs
            + [o.data_ptr(), lse_out.data_ptr()] + shape + [stream],
            keep=keep: lib.flash_attn_fwd_small(*a), (o, lse_out))
        out[f"{label}_dq"] = (
            lambda lib, a=[x.data_ptr() for x in (q, k, v, do, lse, delta)]
            + segs + [dq.data_ptr()] + shape + [stream],
            keep=keep: lib.flash_attn_bwd_dq_small(*a), (dq,))
        rule = fa._dkv_small_splits(b, kv, s, s, h // kv, True,
                                    torch.cuda.get_device_properties(
                                        dev).multi_processor_count)
        for splits in sorted({rule, 1, 2, 3, 4, 8}):
            name = f"{label}_dkv" + ("" if splits == rule else
                                     f"_{splits}_ctas")
            out[name] = (
                lambda lib, a=[x.data_ptr() for x in (q, k, v, do, lse,
                                                      delta)] + segs
                + [dk.data_ptr(), dv.data_ptr()] + shape + [splits, stream],
                keep=keep: lib.flash_attn_bwd_dkv_small(*a), (dk, dv))
    return out


# name -> (B, S, H, KV, head_dim), causal, f32.
FLASH_FWD_F32_LAUNCHES = {"d_causal": (2, 2048, 32, 8, 128),
                          "h_causal": (8, 1024, 12, 4, 64),
                          "q_causal": (8, 1024, 4, 2, 16)}


def flash_fwd_f32_case(dev: torch.device, stream: int) -> Launches:
    """The f32 forward at phase D's causal case (head_dim 128), at phase
    H's attention (64) and at phase Q's (16)."""
    out = {}
    for label, (b, s, h, kv, hd) in FLASH_FWD_F32_LAUNCHES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, s, h, hd, device=dev, generator=gen)
        k, v = (torch.randn(b, s, kv, hd, device=dev, generator=gen)
                for _ in range(2))
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, device=dev)
        args = ([x.data_ptr() for x in (q, k, v)] + [None, None]
                + [o.data_ptr(), lse.data_ptr(), b, s, s, h, kv, hd, 1, 0,
                   hd ** -0.5, stream])
        out[label] = (lambda lib, args=args, keep=(q, k, v):    # pointers
                      lib.flash_attn_fwd_tf32x3(*args), (o, lse))
    return out


# name -> (B, S, H, KV, head_dim, causal), bf16.
FLASH_DELTA_LAUNCHES = {"d_causal": (2, 2048, 32, 8, 128, True),
                        "bert_base": (16, 512, 12, 12, 64, False)}


def flash_delta_case(dev: torch.device, stream: int) -> Launches:
    """delta on the wgmma and the small route at phase D's causal case
    (head_dim 128) and at BERT-base's attention (64)."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    out = {}
    for label, (b, s, h, kv, hd, causal) in FLASH_DELTA_LAUNCHES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        q, do = (torch.randn(b, s, h, hd, device=dev,
                             generator=gen).bfloat16() for _ in range(2))
        k, v = (torch.randn(b, s, kv, hd, device=dev,
                            generator=gen).bfloat16() for _ in range(2))
        _, lse = fa.flash_attention_reference(q, k, v, causal=causal)
        delta = torch.empty(b, h, s, device=dev)
        args = ([x.data_ptr() for x in (q, k, v, do, lse)] + [None, None]
                + [delta.data_ptr(), b, s, s, h, kv, hd, int(causal), 1,
                   hd ** -0.5, stream])
        keep = (q, k, v, do, lse)            # the launches hold raw pointers
        for route, fn in (("wgmma", "flash_bwd_delta_wgmma"),
                          ("small", "flash_bwd_delta")):
            out[f"{label}_{route}"] = (
                lambda lib, args=args, fn=fn, keep=keep:
                getattr(lib, fn)(*args), (delta,))
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


# The f32 paged launches, name -> (live lengths, queries a row, n_blocks):
# phase A's f32 decode case, its 512-query chunk at offset 1024 and its
# verify window of 8 at phase P's table width.
PAGED_F32_LAUNCHES = {
    "a": (DECODE_LAUNCHES["a"][0], 1, 64),
    "chunk512": ([1024 + 512], 512, 64),
    "w8_p_table": ([512, 528, 544, 560], 8, 65),
}


def paged_f32_case(dev: torch.device, stream: int) -> Launches:
    """The fp and int8 launches of PAGED_F32_LAUNCHES."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    (h, kv, hd), page = DECODE_HEADS, 32
    out = {}
    for name, (lens, sq, n_blocks) in PAGED_F32_LAUNCHES.items():
        b = len(lens)
        splits = paged_attn._tf32x3_splits(b, kv, paged_attn._num_sms(dev),
                                           sq * (h // kv))
        tile_rows = paged_attn._tf32x3_tile_rows(sq * (h // kv))
        gen = torch.Generator(device=dev).manual_seed(0)
        pages = sum(-(-n // page) for n in lens) + 1
        q = torch.randn(b, sq, h, hd, device=dev, generator=gen)
        pools = [torch.randn(pages, page, kv * hd, device=dev,
                             generator=gen) for _ in range(2)]
        tables = torch.zeros(b, n_blocks, dtype=torch.int32, device=dev)
        perm = torch.randperm(pages - 1, device=dev, generator=gen) + 1
        used = 0
        for i, n in enumerate(lens):
            nb = -(-n // page)
            tables[i, :nb] = perm[used:used + nb]
            used += nb
        pos = (torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]
               - sq + torch.arange(sq, dtype=torch.int32, device=dev))
        (kq, ks), (vq, vs) = (quantize_kv(p.view(pages, page, kv, hd))
                              for p in pools)
        o = torch.empty_like(q)

        def launch(pk, pv, scales, q=q, tables=tables, pos=pos, o=o, b=b,
                   sq=sq, n_blocks=n_blocks, splits=splits,
                   tile_rows=tile_rows):
            return lambda lib: lib.paged_attn_tf32x3_fwd(
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                *(s.data_ptr() if s is not None else None for s in scales),
                tables.data_ptr(), pos.data_ptr(), o.data_ptr(), b, sq, h,
                kv, hd, page, n_blocks, splits, hd ** -0.5, tile_rows,
                stream)

        out[f"{name}_fp"] = (launch(*pools, (None, None)), (o,))
        out[f"{name}_int8"] = (launch(kq.view(pools[0].shape),
                                      vq.view(pools[1].shape), (ks, vs)),
                               (o,))
    return out


def gmm_f32_case(dev: torch.device, stream: int) -> Launches:
    """The f32 forward and dlhs launches at the MoE slice's gate/up
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
    lhs = torch.randn(lay.m_pad, k, device=dev, generator=gen) * live
    rhs = torch.randn(e, k, n, device=dev, generator=gen) * k ** -0.5
    dout = torch.randn(lay.m_pad, n, device=dev, generator=gen) * live
    out = torch.empty(lay.m_pad, n, device=dev)
    dlhs = torch.empty_like(lhs)
    be, bl = lay.block_expert.data_ptr(), lay.block_live.data_ptr()
    keep = (lhs, rhs, dout, lay)         # the launches hold raw pointers
    return {
        "fwd": (lambda lib, keep=keep: lib.gmm_tf32x3_launch(
            lhs.data_ptr(), rhs.data_ptr(), be, bl, out.data_ptr(),
            lay.m_pad, k, n, e, lay.block_m, 0, 0, stream), (out,)),
        "dlhs": (lambda lib, keep=keep: lib.gmm_tf32x3_launch(
            dout.data_ptr(), rhs.data_ptr(), be, bl, dlhs.data_ptr(),
            lay.m_pad, n, k, e, lay.block_m, 1, 0, stream), (dlhs,))}


TGMM_F32_LAUNCHES = {"router_gate_up": ("router", 768, 2048),
                     "router_down": ("router", 2048, 768),
                     "skewed_gate_up": ("skewed", 768, 2048),
                     "one_expert_gate_up": ("one_expert", 768, 2048)}


def _gmm_sizes(kind: str, e: int = 8, rows: int = 16384) -> list[int]:
    """Phase G's group sizes: a seeded top-2 router's, skewed (one expert
    40 %, one empty), or every row in one expert."""
    if kind == "router":
        logits = np.random.default_rng(5).standard_normal((rows // 2, e))
        return np.bincount(np.argsort(-logits, axis=1)[:, :2].ravel(),
                           minlength=e).tolist()
    if kind == "one_expert":
        return [rows] + [0] * (e - 1)
    big = int(0.4 * rows)
    sizes = [big, 0] + [(rows - big) // (e - 2)] * (e - 2)
    sizes[2] += rows - sum(sizes)
    return sizes


def tgmm_f32_case(dev: torch.device, stream: int) -> Launches:
    """The f32 weight-gradient launches of TGMM_F32_LAUNCHES."""
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops

    out = {}
    for label, (kind, k, n) in TGMM_F32_LAUNCHES.items():
        sizes = _gmm_sizes(kind)
        lay = gmm_ops.grouped_layout(
            torch.tensor(sizes, dtype=torch.int32, device=dev), sum(sizes))
        gen = torch.Generator(device=dev).manual_seed(0)
        live = gmm_ops.live_rows(lay)[:, None]
        lhs = torch.randn(lay.m_pad, k, device=dev, generator=gen) * live
        dout = torch.randn(lay.m_pad, n, device=dev, generator=gen) * live
        drhs = torch.empty(len(sizes), k, n, device=dev)
        keep = (lhs, dout, lay)          # the launches hold raw pointers
        out[label] = (lambda lib, keep=keep, drhs=drhs, k=k, n=n, e=len(
            sizes): lib.tgmm_tf32x3_launch(
                keep[0].data_ptr(), keep[1].data_ptr(),
                keep[2].row_offset.data_ptr(),
                keep[2].group_sizes.data_ptr(), drhs.data_ptr(),
                keep[2].m_pad, k, n, e, keep[2].block_m, 0, stream),
            (drhs,))
    return out


# The head-dim-16 paged launches, name -> (q heads, KV heads, live
# lengths, queries a row, n_blocks): the micro draft's decode (8 slots at
# phase A's tiny-preset lengths) and its 512-token chunk at offset 0; the
# tiny preset's heads at the same decode. The f32 launches: phase A's
# tiny-preset decode and 128-query prefill.
PAGED_SMALL_LAUNCHES = {
    "micro_decode": (2, 1, [int(n) + 8 for n in np.random.default_rng(
        2).integers(32, 129, 8)], 1, 16),
    "micro_chunk512": (2, 1, [512], 512, 16),
    "tiny_decode": (4, 2, [int(n) + 8 for n in np.random.default_rng(
        2).integers(32, 129, 8)], 1, 16),
}
PAGED_SMALL_F32_LAUNCHES = {
    "tiny_decode": PAGED_SMALL_LAUNCHES["tiny_decode"],
    "tiny_prefill128": (4, 2, [128], 128, 16),
}
SMALL_HEAD_DIM = 16


def _small_paged_case(dev, stream, launches, dtype) -> Launches:
    """fp and int8 launches at head_dim 16 on the decode kernel (bf16) or
    the tf32x3 kernel (f32), with the CTA count (and, f32, the row tile)
    the wrapper picks."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    hd, page, sms = SMALL_HEAD_DIM, 32, paged_attn._num_sms(dev)
    out = {}
    for name, (h, kv, lens, sq, n_blocks) in launches.items():
        b, rows = len(lens), sq * (h // kv)
        gen = torch.Generator(device=dev).manual_seed(0)
        pages = sum(-(-n // page) for n in lens) + 1
        q = torch.randn(b, sq, h, hd, device=dev, generator=gen).to(dtype)
        pools = [torch.randn(pages, page, kv * hd, device=dev,
                             generator=gen).to(dtype) for _ in range(2)]
        tables = torch.zeros(b, n_blocks, dtype=torch.int32, device=dev)
        perm = torch.randperm(pages - 1, device=dev, generator=gen) + 1
        used = 0
        for i, n in enumerate(lens):
            nb = -(-n // page)
            tables[i, :nb] = perm[used:used + nb]
            used += nb
        pos = (torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]
               - sq + torch.arange(sq, dtype=torch.int32, device=dev))
        (kq, ks), (vq, vs) = (quantize_kv(p.float().view(pages, page, kv,
                                                          hd)) for p in pools)
        o = torch.empty_like(q)
        if dtype == torch.bfloat16:
            tail = (1, paged_attn._decode_splits(b, kv, sms, rows))
            entry = "paged_decode_fwd"
        else:
            tail = (paged_attn._tf32x3_splits(b, kv, sms, rows),)
            entry = "paged_attn_tf32x3_fwd"
        rows_tile = (() if dtype == torch.bfloat16
                     else (paged_attn._tf32x3_tile_rows(rows),))

        def launch(pk, pv, scales, q=q, tables=tables, pos=pos, o=o, b=b,
                   sq=sq, h=h, kv=kv, n_blocks=n_blocks, tail=tail,
                   rows_tile=rows_tile, entry=entry):
            return lambda lib: getattr(lib, entry)(
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                *(s.data_ptr() if s is not None else None for s in scales),
                tables.data_ptr(), pos.data_ptr(), o.data_ptr(), b, sq, h,
                kv, hd, page, n_blocks, *tail, hd ** -0.5, *rows_tile,
                stream)

        out[f"{name}_fp"] = (launch(*pools, (None, None)), (o,))
        out[f"{name}_int8"] = (launch(kq.view(pools[0].shape),
                                      vq.view(pools[1].shape), (ks, vs)),
                               (o,))
    return out


def paged_small_case(dev: torch.device, stream: int) -> Launches:
    return _small_paged_case(dev, stream, PAGED_SMALL_LAUNCHES,
                             torch.bfloat16)


def paged_small_f32_case(dev: torch.device, stream: int) -> Launches:
    return _small_paged_case(dev, stream, PAGED_SMALL_F32_LAUNCHES,
                             torch.float32)


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
    "flash_bwd_f32": Kernel("flash_bwd_f32.cu", FLASH_BWD_F32_VARIANTS,
                            bind_flash_bwd_f32, flash_bwd_f32_case),
    "flash_fwd": Kernel("flash_fwd.cu", FLASH_FWD_VARIANTS, bind_flash_fwd,
                        flash_fwd_case),
    "gmm": Kernel("gmm_wgmma.cu", GMM_VARIANTS, bind_gmm, gmm_case),
    "paged_f32": Kernel("paged_attn_f32.cu", PAGED_F32_VARIANTS,
                        bind_paged_f32, paged_f32_case),
    "gmm_f32": Kernel("gmm_f32.cu", GMM_F32_VARIANTS, bind_gmm_f32,
                      gmm_f32_case),
    "tgmm_f32": Kernel("gmm_f32.cu", TGMM_F32_VARIANTS, bind_gmm_f32,
                       tgmm_f32_case),
    "paged_small": Kernel("paged_decode.cu", DECODE_VARIANTS, bind_decode,
                          paged_small_case),
    "paged_small_f32": Kernel("paged_attn_f32.cu", PAGED_F32_VARIANTS,
                              bind_paged_f32, paged_small_f32_case),
    "flash_small": Kernel("flash_small.cu", FLASH_SMALL_VARIANTS,
                          bind_flash_small, flash_small_case),
    "flash_fwd_f32": Kernel("flash_fwd_f32.cu", FLASH_FWD_F32_VARIANTS,
                            bind_flash_fwd_f32, flash_fwd_f32_case),
    "flash_delta": Kernel("flash_delta.cu", FLASH_DELTA_VARIANTS,
                          bind_flash_delta, flash_delta_case),
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
    refused = set()                    # (variant, launch) the build refuses
    if against is not None:
        for label, (fn, outs) in launches.items():
            run(fn, libs["base"])
            base = [x.clone() for x in outs]
            if fn(libs["against"]):
                refused.add(("against", label))
                print(json.dumps({"launch": label, "against": "refused"}),
                      flush=True)
                continue
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
                if (name, label) in refused:
                    continue
                print(json.dumps({
                    "round": rnd, "variant": name, "launch": label,
                    "ms": time_ms(fn, lib)}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
