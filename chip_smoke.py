#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``csrc/`` with nvcc (one nvcc
per source, all started together), then runs its phases; any failure
exits non-zero.

A. The paged-attention kernels against their plain PyTorch version on
   the card, at the Llama-3 8B attention shapes (32 q heads, 8 KV heads,
   head_dim 128, 32-token pages), by the route ``_route`` picks: decode
   (B=4, one query each, live lengths 100-2000) on the tensor-core decode
   kernel in bf16 and on the split kernel in f32; in bf16 also decode at
   phase B's decode-profile shape (live 512-560 of 64 blocks) and at
   Llama-3 8B's own 8,192-token context (live 7,000-8,000 of 256 blocks);
   query chunks (512 queries at offset 1024, 512 at 0, a 32-query final
   bucket at offset 1480) on the tensor-core prefill kernel in bf16, the
   512 @ 1024 chunk on the split kernel in f32; stale K/V past each cursor
   and scratch-page garbage changing no bit on every route. Reports the
   error, the kernel's time, the plain version's, the bound (the larger of
   bytes over 3.35 TB/s and FLOPs over the dtype's peak), and the time of
   ``scaled_dot_product_attention`` on the pre-gathered K/V with the
   boolean mask as a yardstick (the port never calls it); for a case on
   the decode route, also the split kernel's error and time on the same
   inputs, two decode launches bitwise equal, and every time on the
   device alone; for a chunk on the prefill route, the split kernel's
   error and time on the same inputs and the prefill kernel's time at
   64- and 128-row tiles. The same cases again through the int8 branch:
   int8 pools quantized from random ones by the model's quantize-on-write,
   bf16 and f32 q, held to the int8 plain version, stale int8 cells and
   their scales past each cursor and scratch-page garbage changing no
   bit; the yardstick then runs on K/V gathered and dequantized
   beforehand.
B. The port's ``ServeEngine`` at full Llama-3 8B width and depth (bf16,
   random weights from a seed): 4 slots, 512-token prefill chunks, 8
   requests of 100-1500 prompt tokens and 32 new tokens (6 greedy, 2
   sampled). Every request finishes with in-vocabulary tokens, no pool
   page leaks, and the paged kernels launch exactly n_layers x prefill
   chunks times on the prefill route, n_layers x decode iterations on
   the decode route and never on the split route. Reports prefill and
   decode tokens/s, TTFT p50 and peak device memory; then, with every
   slot busy, a decode iteration's host time and its device time by
   kernel (``torch.profiler``, the decode kernel once a layer); then a
   512-token prefill chunk at offset 1024: host time, device time by
   kernel class and the busy share.
C. The same workload in f32 at 8B width and 4 layers, greedy, through the
   kernel path and through the plain path (``attention_impl="xla"``):
   the first 16 tokens of every request agree. Then, in bf16 (which the
   prefill route takes), every prompt prefilled in 512-token chunks
   through both paths: the last position's logits agree within
   ``BF16_LOGIT_RTOL`` and the first greedy token is equal wherever the
   plain path's top-2 margin exceeds twice the largest logit difference.
D. The flash-attention kernels against their plain PyTorch versions on
   the card, in bf16 and f32, at B 2, S 2048, 32 q heads, 8 KV heads,
   head_dim 128: causal, non-causal, 512 queries against 2048 keys
   (causal, offset 1536), and three packed documents by segment ids
   (causal); then at phase H's attention (B 8, S 1024, 12/4 heads,
   head_dim 64, causal). The forward and the backward on both routes:
   in bf16 the tensor-core kernels of ``csrc/flash_fwd.cu`` and
   ``csrc/flash_bwd.cu`` (``"wgmma"``, the route bf16 takes) and the
   mma.sync kernels of ``flash_attn.cu`` forced on the same inputs; f32
   takes the mma route alone. Each output is held element by element to
   a limit of atol x the RMS of its row (never below the output's RMS) +
   rtol x the element, and the log-sum-exp to an absolute limit; rows
   that see no key match the plain version exactly; two wgmma launches on
   the same inputs give the same bits.
   Reports each kernel's error, time, the plain version's, the bound (the
   larger of the bytes it must move over 3.35 TB/s and its matmul FLOPs on
   the visible pairs over the dtype's peak) and, as a yardstick the port
   never calls, ``scaled_dot_product_attention`` (forward alone for the
   forward kernel; for the backward ones forward and backward through
   autograd less the forward), timed on the device alone: autograd's host
   side outlasts the card's work at these sizes.
E. Training at Llama-3 8B width, 4 layers (``config_llama3_8b(n_layers=4,
   max_seq_len=2048)``: bf16 compute, f32 params, remat "dots"), chunked
   CE, AdamW with global-norm clip 1.0, 4 x 2048 tokens per step, through
   ``make_train_step`` over NCCL at world size 1 and ``fit`` over a
   ``TokenBatcher`` of ``synthetic_tokens``. Eight steps on one fixed
   batch bring the loss down by the stated margin; then a timed window of
   steps gives tokens/s, step ms, peak memory and the model-FLOPs share,
   the kernel launches per step are checked exactly (forward 2 x layers
   with the remat recompute, dQ and dK/dV once per layer, all on the
   wgmma route), and one profiled step gives device time by class and the
   busy share.
F. Three AdamW steps in f32 (TF32 off) at 8B width, 2 layers, B 2, S 1024
   from the same weights, through the kernels (``attention_impl="auto"``)
   and through the plain einsum path (``"xla"``): the losses agree, and
   for every parameter tensor on its own the first step's gradient and
   the parameters after the 3 steps agree, within the stated tolerances.
   Logs the element whose parameter differs most, with its gradient and
   Adam moments on both paths. The f32 forward and backward run on the
   mma route alone (checked). Then the same model and first batch in bf16 compute:
   one step's gradients on the wgmma route and on the mma route (forced),
   each against the f32 plain path per parameter tensor; the wgmma
   route's relative L2 distance is at most ``BF16_STEP_RATIO`` x the mma
   route's + ``BF16_STEP_FLOOR``.
G. The grouped-matmul kernels (the forward and, reading the weight
   transposed in place, the input gradient; the weight gradient) against
   their plain versions, 8 experts and 16,384 routed rows: the MoE slice's
   shapes (K 768 -> N 2048 and K 2048 -> N 768, group sizes from a seeded
   top-2 router) in bf16 and f32, and Mixtral-8x7B-class expert shapes
   (K 4096 -> N 14336 and K 14336 -> N 4096) in bf16, balanced and skewed
   (one expert 40 %, one empty); then the slice's shapes at phase M's
   prefill (4,096 rows from a seeded top-2 router, block 512) in bf16.
   bf16 runs both routes on the same inputs
   (``gmm_wgmma``/``tgmm_wgmma`` of ``csrc/gmm_wgmma.cu``, and the
   mma.sync ``gmm_kernel``/``tgmm_kernel`` of ``csrc/gmm.cu`` forced), f32
   the mma route alone. Every
   element within atol x the output's RMS + rtol x |plain|, rows that
   hold no token exactly 0, an empty expert's weight gradient exactly 0;
   two wgmma launches give the same bits. Reports each kernel's time, the
   plain version's, the bound, and ``torch._grouped_mm`` on the same spans
   as a yardstick (the port never calls it; null with the reason where
   this torch refuses the case), the kernels and the yardstick timed on
   the device alone.
H. Dropless MoE training at the slice's configuration: the Llama-small
   backbone (dim 768, 12 layers, 12/4 heads, head_dim 64, MLP 2048, vocab
   32000), 8 experts top-2 ``dispatch="ragged"``, bf16 compute, f32 params,
   remat "dots", AdamW, 8 x 1024 tokens a step, through
   ``make_train_step`` over NCCL at world size 1 and ``fit``: the fixed
   batch's loss falls by phase E's margin in 8 steps; a timed window gives
   tokens/s, step ms, peak memory and the model-FLOPs share
   (``moe.flops_per_token``); the launches a step are checked exactly (gmm
   6 x layers, tgmm 3 x layers, flash forward 2 x layers, dQ and dK/dV
   once a layer, all five on the wgmma route); one profiled step gives
   device time by class.
I. The same model at 2 layers in f32 (TF32 off), B 2, S 1024: 3 AdamW
   steps from the same weights through the kernels (``dispatch="ragged"``,
   flash attention) and through an independent plain path
   (``dispatch="index"`` at a capacity that drops nothing, the einsum
   attention), compared as in phase F. The f32 kernel path runs the mma
   routes alone (the wgmma counts stay 0, checked).
J. Quantized serving: phase B's engine and workload with
   ``kv_quant="int8"`` and ``weight_quant="int8"`` (Llama-3 8B, full width
   and depth, bf16 random weights from seed 0, quantized in place). The
   same checks, every pool int8 with f32 scale siblings, the int8 branch
   launched exactly as phase B's fp branch by route, and the fp branch
   never. Reports phase B's metrics, the peak memory of construction and
   of serving apart, bytes per page fp and int8, the bytes saved, the
   decode and prefill profiles, and, as a reading only, the share of
   greedy tokens equal to phase B's.
K. Phase C with kv and weight int8: f32 at 8B width and 4 layers, the int8
   kernel path against the plain path; the first 16 greedy tokens of all
   8 requests agree; then the bf16 prefill check of phase C.
L. One-shot ``generate`` on the dense KV cache at Llama-3 8B, full width
   and depth, bf16, random weights from seed 0: 4 left-padded prompts of
   100-1,500 real tokens (1,500 columns, a 1,536-column cache window) and
   32 new tokens, greedy, then sampled (T 0.8, top-k 50, top-p 0.9) twice
   from one seed. Tokens in the vocabulary, the cache at the window's
   width, the two sampled runs equal, and no paged, flash or grouped-
   matmul kernel launched (the dense path's attention is the einsum path,
   as JAX's is XLA attention). Reports prefill ms, decode tokens/s, peak
   memory, one decode step's host ms, device ms by kernel class and busy
   share (``torch.profiler``), and, as a reading, the greedy tokens equal
   to each row generated alone. Then in f32 (TF32 off) at 8B width and 4
   layers, one set of weights: each of phase C's 8 requests generated
   alone equals the ``ServeEngine`` greedy stream (split paged kernel)
   for 16 tokens, and each row of a left-padded batch of 4 equals that
   row alone.
M. ``generate`` on the ragged MoE (phase H's backbone, 8 experts top-2,
   block 512, bf16, random weights): 4 left-padded prompts to 512 columns
   (2,048 tokens, so the prefill takes the grouped GEMMs) and 32 new
   tokens, greedy. The wgmma grouped GEMM launches exactly 3 x layers
   times in the prefill and the decode steps (4 tokens, the index path)
   add none; no other kernel runs. Reports prefill ms and its device time
   by class, decode tokens/s, peak memory. The logits of every real
   prefill position, ragged against ``dispatch="index"`` on the same
   weights, within ``MOE_BF16_LOGIT_RTOL`` (one bf16 step, relative L2),
   and a row block planted on the wrong expert above it; the first greedy
   token equal where decided; in f32 at 2 layers the two give the same 16
   greedy tokens and prefill logits within 1e-4 relative, the ragged
   path on the mma route (3 x layers launches).

Prints the card's name and power limit, the build time, one JSON line per
phase, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside tensor cores
# Phase A tolerances, max |kernel - plain|. f32: online vs plain softmax
# over up to 2000 keys. bf16: the kernel rounds unnormalized p to bf16 for
# P.V (as the Pallas kernel does), the plain version the normalized
# probabilities, and both round the output to bf16.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Phase A's decode cases beside the one drawn from its seed, bf16 only
# (live lengths, n_blocks, pages): phase B's decode-profile shape (4 slots
# at 512-560 live tokens of a 2,048-token table) and Llama-3 8B's own
# 8,192-token context (7,000-8,000 live of 256 blocks).
DECODE_CASES = {"decode_b_profile": ([512, 528, 544, 560], 64, 4 * 18 + 1),
                "decode_long": ([7000, 7333, 7667, 8000], 256, 4 * 250 + 1)}
# The query chunks phase A added with the prefill route (512 queries at
# offset 0, 32 at offset 1480), bf16: every element within TOL + 2^-7 x
# |plain|. Rows near position 0 average a few rows of V, so outputs reach
# |x| ~ 4, where the one bf16 step by which two roundings of the output can
# differ is 2^-6 > TOL. The decode and 512 @ 1024 cases keep TOL alone.
CHUNK_RTOL_BF16 = 2 ** -7
# The int8 branch in bf16, per element: |kernel - plain| <= 2^-10 x the
# output's RMS + 2^-7 x |plain|. Both dequantize to the same f32 values and
# keep p in f32, so only the order of the f32 sums and the final bf16
# rounding differ: one bf16 step (at most 2^-7 of the value), plus a
# little near 0. f32 is held to TOL.
INT8_TOL_BF16 = (2 ** -10, 2 ** -7)
# Phases C and K, bf16 prefill: the last position's logits of each request,
# kernel path against plain path, relative L2. The two attentions differ
# in where bf16 rounds (fp: p at the running max or normalized; int8: f32
# K, V and p against K, V and p rounded to bf16), up to one bf16 step
# (2^-8) of an attention output. Each of the 4 layers adds such a
# difference to the residual stream, and the layers after it, with random
# weights, can grow what they are given (attention and MLP gains above 1):
# 4 steps x a growth of 4 = 2^-4. A wrong mask or a lost key tile moves an
# attention output by a large share of its size, far above that.
BF16_LOGIT_RTOL = 2 ** -4
H, KV, HD, PAGE = 32, 8, 128, 32
PAGED_REPLACES = ("k8s_distributed_deeplearning_tpu/ops/"
                  "pallas_paged_attn.py:66")
# Phase D tolerances (atol, rtol), held per element and per output (o, dq,
# dk, dv): |kernel - plain| <= atol x scale + rtol x |plain|. rtol covers
# the output rounding: bf16 keeps 8 significant bits, so two results that
# differ in their last f32 bits can round one bf16 ulp (<= 2^-7 of the
# value) apart. atol covers the rest: in bf16 the rounding of p (forward,
# at the running max in the kernel and at the final max in the plain
# version) or of dS (backward) at different points, in f32 the order of
# the sums. Their effect grows with the size of each row (the head_dim
# vector of one position and head: a row over 2 keys is a mean of 2 values
# of V, one over 2000 keys a far smaller one), so the scale is the row's
# RMS, but never below the whole output's RMS: a dQ row that cancels to
# about 0 (a query that sees one key) still carries its dS rounding. The
# log-sum-exp is f32 in both dtypes and is held to LSE_ATOL absolute.
FLASH_TOL = {torch.float32: (1e-4, 1e-4),
             torch.bfloat16: (2 ** -5, 2 ** -6)}
LSE_ATOL = 1e-3
# Phase E: the loss after 8 steps on one fixed batch is below this share
# of the first step's loss.
FIXED_BATCH_MARGIN = 0.9
# Phase F: relative loss agreement; then, for every parameter tensor on its
# own, the L2 norm of the kernel path's first-step gradient minus the plain
# path's over the plain one's, and the L2 norm of the difference of the
# parameters after the 3 steps over the change the 3 steps made.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-3
# Phase F in bf16: per parameter tensor, the relative L2 distance of one
# step's gradient from the f32 plain path's, on the wgmma route, must be at
# most BF16_STEP_RATIO x the mma route's + BF16_STEP_FLOOR. Both routes
# round P and dS to bf16 at the same points, so their distances from f32
# are set by the bf16 model around them and should agree to a few per
# cent; the ratio leaves room for the two kernels' other sum orders. The
# floor covers a tensor whose distance is near 0 on both routes, where a
# ratio says nothing: 2^-10 is a quarter of one bf16 step (2^-8) of
# relative error, far below what a wrong mask or a lost tile does to the
# attention weights' gradients (a large share of their norm).
BF16_STEP_RATIO = 1.25
BF16_STEP_FLOOR = 2 ** -10
# Phase G tolerances (atol, rtol), held per element: |kernel - plain| <=
# atol x RMS of the plain output + rtol x |plain|. Both versions sum exact
# products in f32, in different orders. f32: the order's effect, about
# 1e-6 of the RMS at these depths. bf16: both round their f32 sums to bf16
# once, and sums on either side of a rounding boundary land one bf16 step
# (at most 2^-7 of the value) apart.
GMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -10, 2 ** -7)}
GMM_E, GMM_ROWS = 8, 16384
GMM_REPLACES = {
    "gmm": "k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py:159",
    "tgmm": "k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py:209",
}
# Kernel-line name -> (source, wrapper): each wrapper launches the kernel
# of either route, the wgmma lines its "wgmma" route (bf16), the others
# the kernels of gmm.cu ("mma": f32 on the training path, forced in bf16
# here).
GMM_KERNELS = {
    "gmm": ("gmm.cu", "gmm"), "tgmm": ("gmm.cu", "tgmm"),
    "gmm_wgmma": ("gmm_wgmma.cu", "gmm"),
    "tgmm_wgmma": ("gmm_wgmma.cu", "tgmm"),
}
# The MoE slice's model: the JAX package's ragged MoE benchmark row
# (Llama-small backbone, 8 experts, top-2, dispatch="ragged").
MOE_BACKBONE = dict(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                    n_kv_heads=4, mlp_dim=2048)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# Cycles of the sleep kernel that ``time_ms(..., host_ahead=True)`` runs
# first: ~0.1 s at the H100's clock, time for the host to enqueue every
# timed launch of a call that issues a few dozen kernels.
HOST_AHEAD_CYCLES = 200_000_000


def time_ms(fn, flush: torch.Tensor, iters: int = 20,
            host_ahead: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each with a
    cold L2 (a 256 MB buffer is rewritten before every launch). With
    ``host_ahead`` the card first runs a sleep kernel while the host
    enqueues every timed launch, so that a call whose host side outlasts
    its device side (autograd's backward) is timed on the device alone."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    if host_ahead:
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ------------------------------------------------------------- phase A


def _attn_case(rng, dev, dtype, lengths, sq, n_blocks, pages):
    """Pools of ``pages`` random pages; row b maps its live blocks onto
    distinct real pages (the rest stay on scratch page 0) and queries the
    last ``sq`` positions of its ``lengths[b]`` tokens."""
    b = len(lengths)
    q = torch.randn(b, sq, H, HD, device=dev).to(dtype)
    pk = torch.randn(pages, PAGE, KV * HD, device=dev).to(dtype)
    pv = torch.randn(pages, PAGE, KV * HD, device=dev).to(dtype)
    tables = np.zeros((b, n_blocks), np.int32)
    free = rng.permutation(np.arange(1, pages))
    used = 0
    for i, n in enumerate(lengths):
        nb = -(-int(n) // PAGE)
        tables[i, :nb] = free[used:used + nb]
        used += nb
    pos = (np.asarray(lengths)[:, None] - sq
           + np.arange(sq)[None, :]).astype(np.int32)
    return (q, pk, pv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def _bound(args, dtype):
    """Bytes: K and V of the live tokens once (int8 pools, ``args`` with
    their scales: one byte an element plus an f32 scale a token and head),
    q in, out, tables and positions; operations: 4 x H x hd per visible
    (query, key) pair. The larger time over the card's rates."""
    q, pk, _, tables, pos = args[:5]
    item = q.element_size()
    live = (pos.max(dim=1).values.long() + 1).clamp_max(
        tables.shape[1] * PAGE)
    per_token = KV * (HD * pk.element_size() + (4 if len(args) > 5 else 0))
    nbytes = (2 * int(live.sum()) * per_token         # K and V, once
              + 2 * q.numel() * item                   # q in, out
              + 4 * (tables.numel() + pos.numel()))
    flops = 4 * H * HD * int((pos.long() + 1).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else \
        "operations"


def _sdpa_fn(args):
    """scaled_dot_product_attention on K/V gathered beforehand."""
    q, pk, pv, tables, pos = args
    b, sq = q.shape[:2]
    s_virt = tables.shape[1] * PAGE
    k = pk[tables.long()].reshape(b, s_virt, KV, HD).transpose(1, 2)
    v = pv[tables.long()].reshape(b, s_virt, KV, HD).transpose(1, 2)
    qt = q.transpose(1, 2)
    mask = (torch.arange(s_virt, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=True)


# Phase A's query chunks (live lengths, sq, n_blocks, pages): 512 queries
# at offset 1024, the first 512-token chunk, and a final 32-query bucket
# at offset 1480. bf16 chunks take the prefill route, f32 the split one.
PREFILL_CASES = {"prefill512": ([1024 + 512], 512, 64, 64),
                 "prefill512_at0": ([512], 512, 64, 64),
                 "prefill32_at1480": ([1480 + 32], 32, 64, 64)}
# The bitwise stale-cell check through the prefill route: two rows of 64
# queries at live lengths 700 and 1000.
STALE_PREFILL = ([700, 1000], 64, 64, 2 * 64 + 1)


def _shapes(dtype, decode_lens):
    """Phase A's cases for ``dtype``: decode, the prefill chunks (f32: the
    512 @ 1024 chunk alone), then bf16's other decode cases."""
    bf16 = dtype == torch.bfloat16
    chunks = (PREFILL_CASES if bf16 else
              {"prefill512": PREFILL_CASES["prefill512"]})
    more = ({name: (lens, 1, nb, pages)
             for name, (lens, nb, pages) in DECODE_CASES.items()}
            if bf16 else {})
    return {"decode": (decode_lens, 1, 64, 4 * 64 + 1), **chunks, **more}


def _route_timings(args, kw, ref, err_of, flush) -> dict:
    """For a case on the prefill route: the split kernel on the same inputs
    (its error and time) and the prefill kernel at each row tile."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    def launch(route, rows=0):
        return lambda: paged_attn._launch(*args, **kw, route=route,
                                          tile_rows=rows)

    split = launch("split")()
    torch.cuda.synchronize()
    return {"split_max_abs_err": err_of(split, ref),
            "split_ms": time_ms(launch("split"), flush),
            "ms_tile64": time_ms(launch("prefill", 64), flush),
            "ms_tile128": time_ms(launch("prefill", 128), flush)}


def _decode_timings(args, kw, out, ref, err_of, flush) -> dict:
    """For a case on the decode route: a second launch bitwise equal to
    the first, and the split kernel on the same inputs (its error, and its
    time on the device alone)."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    def launch(route):
        return lambda: paged_attn._launch(*args, **kw, route=route)

    again = launch("decode")()
    split = launch("split")()
    torch.cuda.synchronize()
    return {"repeat_bitwise": torch.equal(again, out),
            "split_max_abs_err": err_of(split, ref), "split": split,
            "split_ms": time_ms(launch("split"), flush, host_ahead=True)}


def _stale(args, lens, quant):
    """The case's pools with every cell past each row's live length, and
    the scratch page, overwritten (fp: +-1e4; int8: 127 with scales 1e4).
    The blocks past each live length already map to the scratch page."""
    q, pk, pv, tables = args[:4]
    out = [t.clone() for t in (pk, pv) + tuple(args[5:])]
    for i, n in enumerate(lens):
        last = int(tables[i, (int(n) - 1) // PAGE])
        tail = slice((int(n) - 1) % PAGE + 1, None)
        for j, t in enumerate(out):
            t[last, tail] = (1e4 if j > 1 else 127) if quant else (
                1e4 if j == 0 else -1e4)
    for j, t in enumerate(out):
        t[0] = (1e4 if j > 1 else 127) if quant else (1e4 if j == 0
                                                      else -1e4)
    return (q, out[0], out[1], tables, args[4], *out[2:])


def phase_a(dev, flush):
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    kern = paged_attn.paged_decode_attention
    plain = paged_attn.paged_decode_attention_reference
    decode_lens = rng.integers(100, 2001, 4)
    cases = []

    def err_of(out, ref):
        return float((out.float() - ref.float()).abs().max())

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, (lens, sq, nb, pages) in _shapes(dtype,
                                                   decode_lens).items():
            args = _attn_case(rng, dev, dtype, lens, sq, nb, pages)
            route = paged_attn._route(sq, H // KV, HD, dtype, False)
            before = (kern.launches_prefill, kern.launches_decode)
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            check((kern.launches_prefill - before[0],
                   kern.launches_decode - before[1])
                  == (route == "prefill", route == "decode"),
                  f"{name}/{dname}: the {route} route did not launch")
            err = err_of(out, ref)
            rtol = (CHUNK_RTOL_BF16 if dtype == torch.bfloat16
                    and name not in ("decode", "prefill512") else 0.0)

            def share_of(x, ref=ref, rtol=rtol, dtype=dtype):
                return float(((x.float() - ref.float()).abs()
                              / (TOL[dtype] + rtol * ref.float().abs()))
                             .max())

            share = share_of(out)
            check(bool(torch.isfinite(out).all()), f"{name}/{dname}: nan")
            check(share <= 1.0, f"{name}/{dname}: max err {err} uses "
                  f"{share} of its limit (atol {TOL[dtype]}, rtol {rtol})")
            bound, by = _bound(args, dtype)
            alone = route == "decode"      # time on the device alone
            cases.append({
                "case": name, "dtype": dname, "route": route, "shape": {
                    "B": len(lens), "sq": sq, "H": H, "kv": KV, "hd": HD,
                    "page_tokens": PAGE, "n_blocks": nb,
                    "live": [int(n) for n in lens]},
                "max_abs_err": err, "tol_share": share,
                "tol": {"atol": TOL[dtype], "rtol": rtol},
                "ms": time_ms(lambda: kern(*args), flush, host_ahead=alone),
                "plain_ms": time_ms(lambda: plain(*args), flush,
                                    host_ahead=alone),
                "library_ms": time_ms(_sdpa_fn(args), flush,
                                      host_ahead=alone),
                "bound_ms": bound, "bound_by": by})
            if route == "prefill":
                cases[-1].update(_route_timings(args, {}, ref, err_of, flush))
                cases[-1]["split_tol_share"] = share_of(
                    paged_attn._launch(*args, route="split"))
            if route == "decode":
                timed = _decode_timings(args, {}, out, ref, err_of, flush)
                cases[-1]["split_tol_share"] = share_of(timed.pop("split"))
                cases[-1].update(timed)
                check(timed["repeat_bitwise"],
                      f"{name}/{dname}: two decode launches differ")
            log({"phase": "A", **cases[-1]})
        # Stale K/V past each cursor and garbage in the scratch page (the
        # blocks past the live length map to it) change no output bit, on
        # the route decode takes (bf16: the decode route; f32: the split
        # route) and, in bf16, the prefill route.
        stale = [("decode" if dtype == torch.bfloat16 else "split",
                  decode_lens, 1, 64, 4 * 64 + 1)]
        if dtype == torch.bfloat16:
            stale.append(("prefill", *STALE_PREFILL))
        for route, lens, sq, nb, pages in stale:
            args = _attn_case(rng, dev, dtype, lens, sq, nb, pages)
            check(paged_attn._route(sq, H // KV, HD, dtype, False) == route,
                  f"stale case is not on the {route} route")
            base = kern(*args)
            args2 = _stale(args, lens, quant=False)
            same = torch.equal(kern(*args2), base)
            check(same, f"stale/scratch K/V changed the output ({dname}, "
                  f"{route})")
            err = err_of(base, plain(*args2))
            check(err <= TOL[dtype], f"stale/scratch vs plain: {err}")
            log({"phase": "A", "case": "stale_kv+scratch_page",
                 "dtype": dname, "route": route, "bitwise_unchanged": same,
                 "max_abs_err": err})
    return cases


def _quantized(args):
    """The case's pools quantized per token and KV head by the model's
    quantize-on-write: (q, int8 K, int8 V, tables, positions, K scales,
    V scales)."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)

    q, pk, pv, tables, pos = args
    (kq, ks), (vq, vs) = (quantize_kv(p.view(p.shape[0], PAGE, KV, HD))
                          for p in (pk, pv))
    return (q, kq.view(pk.shape), vq.view(pv.shape), tables, pos, ks, vs)


def _int8_err(out, ref, dtype):
    """max |kernel - plain| and the largest share of the limit any element
    uses (f32: TOL; bf16: INT8_TOL_BF16)."""
    d = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        limit = torch.full_like(d, TOL[dtype])
    else:
        r = ref.float()
        limit = (INT8_TOL_BF16[0] * float(r.square().mean().sqrt())
                 + INT8_TOL_BF16[1] * r.abs())
    return float(d.max()), float((d / limit).max())


def phase_a_int8(dev, flush):
    """Phase A's cases through the kernels' int8 branch."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    rng = np.random.default_rng(10)
    torch.manual_seed(10)
    attn = paged_attn.paged_decode_attention
    plain = paged_attn.paged_decode_attention_reference
    decode_lens = rng.integers(100, 2001, 4)
    cases = []

    def scales(args):
        return dict(k_scale=args[5], v_scale=args[6])

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]

        def err_of(out, ref):
            return _int8_err(out, ref, dtype)[0]

        for name, (lens, sq, nb, pages) in _shapes(dtype,
                                                   decode_lens).items():
            args = _quantized(_attn_case(rng, dev, torch.float32, lens, sq,
                                         nb, pages))
            args = (args[0].to(dtype),) + args[1:]
            base5, kw = args[:5], scales(args)
            route = paged_attn._route(sq, H // KV, HD, dtype, True)
            before = (attn.launches_int8, attn.launches_prefill_int8,
                      attn.launches_decode_int8)
            out = attn(*base5, **kw)
            want = plain(*base5, **kw)
            torch.cuda.synchronize()
            check((attn.launches_int8 - before[0],
                   attn.launches_prefill_int8 - before[1],
                   attn.launches_decode_int8 - before[2])
                  == (1, int(route == "prefill"), int(route == "decode")),
                  f"int8 {name}/{dname}: the {route} route did not launch")
            check(out.dtype == dtype and bool(torch.isfinite(out).all()),
                  f"int8 {name}/{dname}: {out.dtype} or non-finite")
            err, share = _int8_err(out, want, dtype)
            check(share <= 1.0, f"int8 {name}/{dname}: max err {err} uses "
                  f"{share} of its limit")
            q, kq, vq, tables, pos, ks, vs = args

            def deq(x, s):
                return (x.view(-1, PAGE, KV, HD).float() * s[..., None]).to(
                    dtype).view(x.shape)

            bound, by = _bound(args, dtype)
            alone = route == "decode"      # time on the device alone
            cases.append({
                "case": name, "dtype": dname, "branch": "int8",
                "route": route, "shape": {
                    "B": len(lens), "sq": sq, "H": H, "kv": KV, "hd": HD,
                    "page_tokens": PAGE, "n_blocks": nb,
                    "live": [int(n) for n in lens]},
                "max_abs_err": err, "tol_share": share,
                "tol": (TOL[dtype] if dtype == torch.float32 else
                        {"atol_rms": INT8_TOL_BF16[0],
                         "rtol": INT8_TOL_BF16[1]}),
                "ms": time_ms(lambda: attn(*base5, **kw), flush,
                              host_ahead=alone),
                "plain_ms": time_ms(lambda: plain(*base5, **kw), flush,
                                    host_ahead=alone),
                "library_ms": time_ms(_sdpa_fn(
                    (q, deq(kq, ks), deq(vq, vs), tables, pos)), flush,
                    host_ahead=alone),
                "bound_ms": bound, "bound_by": by})
            if route == "prefill":
                cases[-1].update(_route_timings(base5, kw, want, err_of,
                                                flush))
                cases[-1]["split_tol_share"] = _int8_err(
                    paged_attn._launch(*base5, **kw, route="split"), want,
                    dtype)[1]
            if route == "decode":
                timed = _decode_timings(base5, kw, out, want, err_of, flush)
                cases[-1]["split_tol_share"] = _int8_err(
                    timed.pop("split"), want, dtype)[1]
                cases[-1].update(timed)
                check(timed["repeat_bitwise"],
                      f"int8 {name}/{dname}: two decode launches differ")
            log({"phase": "A", **cases[-1]})
        # Stale int8 cells past each cursor (127, scale 1e4) and garbage in
        # the scratch page and its scale page change no output bit, on the
        # route decode takes and, in bf16, the prefill route.
        stale = [("decode" if dtype == torch.bfloat16 else "split",
                  decode_lens, 1, 64, 4 * 64 + 1)]
        if dtype == torch.bfloat16:
            stale.append(("prefill", *STALE_PREFILL))
        for route, lens, sq, nb, pages in stale:
            args = _quantized(_attn_case(rng, dev, torch.float32, lens, sq,
                                         nb, pages))
            args = (args[0].to(dtype),) + args[1:]
            check(paged_attn._route(sq, H // KV, HD, dtype, True) == route,
                  f"int8 stale case is not on the {route} route")
            base = attn(*args[:5], **scales(args))
            args2 = _stale(args, lens, quant=True)
            same = torch.equal(attn(*args2[:5], **scales(args2)), base)
            check(same, f"int8 stale/scratch cells changed the output "
                  f"({dname}, {route})")
            err, share = _int8_err(base, plain(*args2[:5], **scales(args2)),
                                   dtype)
            check(share <= 1.0, f"int8 stale/scratch vs plain: {err}")
            log({"phase": "A", "case": "stale_kv+scratch_page",
                 "dtype": dname, "branch": "int8", "route": route,
                 "bitwise_unchanged": same, "max_abs_err": err,
                 "tol_share": share})
    return cases


# ------------------------------------------------------------- phase B/C


def _requests(vocab, n_new, sampled):
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          SamplingParams)

    rng = np.random.default_rng(1)
    lens = rng.integers(100, 1501, 8)
    reqs = []
    for i, n in enumerate(lens):
        sp = SamplingParams()
        if sampled and i == 2:
            sp = SamplingParams(temperature=0.8, top_k=50)
        elif sampled and i == 5:
            sp = SamplingParams(temperature=1.0, top_p=0.9)
        reqs.append(Request(prompt=rng.integers(0, vocab, int(n)).astype(
            np.int32), max_new_tokens=n_new, sampling=sp,
            request_id=f"r{i}", seed=100 + i))
    return reqs


def _timed(engine, name, acc):
    """Wrap ``engine.<name>`` so its device time (synchronized on both
    sides) accumulates in ``acc[name]``; final-chunk logits are checked
    finite on the way."""
    fn = getattr(engine, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite")
        return out

    setattr(engine, name, wrapper)


def _serve_phase(phase, dev, quant: bool):
    """Phases B and J: ``ServeEngine`` at full Llama-3 8B width and depth,
    bf16 random weights from seed 0, serving ``_requests``; J with int8 KV
    pages and int8 weights. Checks the outputs, the pool, and the paged
    kernel's launches by branch; returns the result and the streams."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve import quant as quant_lib

    cfg = llama.config_llama3_8b(max_seq_len=2048)
    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    resident = torch.cuda.memory_allocated() / 2 ** 30
    per_layer = ((torch.int8, torch.int8, torch.float32, torch.float32)
                 if quant else (cfg.dtype, cfg.dtype))
    check(all(tuple(t.dtype for t in layer) == per_layer
              for layer in eng._cache), f"pool dtypes are not {per_layer}")
    check(quant_lib.is_quantized(model) == quant,
          f"weights quantized: {quant_lib.is_quantized(model)}")
    torch.cuda.reset_peak_memory_stats()
    acc = {"_prefill": 0.0, "_decode_step": 0.0}
    for name in acc:
        _timed(eng, name, acc)
    reqs = _requests(cfg.vocab_size, 32, sampled=True)
    free0 = eng.pool.available()
    attn = paged_attn.paged_decode_attention
    _zero_counts(attn)
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fp": attn.launches, "int8": attn.launches_int8}
    prefill_route = {"fp": attn.launches_prefill,
                     "int8": attn.launches_prefill_int8}
    decode_route = {"fp": attn.launches_decode,
                    "int8": attn.launches_decode_int8}
    check(len(outs) == 8, f"{len(outs)} of 8 requests finished")
    for o in outs:
        check(o.finish_reason == "length" and len(o.tokens) == 32,
              f"{o.request_id}: {o.finish_reason}, {len(o.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o.tokens),
              f"{o.request_id}: token outside the vocabulary")
    check(eng.pool.available() == free0 and eng.pool.reserved == 0,
          "KV pool pages leaked")
    summ = eng.stats.summary()
    chunks = sum(o.prefill_chunks for o in outs)
    want = cfg.n_layers * (summ["decode_steps"] + chunks)
    branch = "int8" if quant else "fp"
    check(launches == {"fp": 0, "int8": 0, branch: want},
          f"kernel launches {launches}: want {want} = n_layers x (decode "
          f"iterations {summ['decode_steps']} + prefill chunks {chunks}) "
          f"of the {branch} branch and none of the other")
    routes = {"decode": decode_route[branch],
              "prefill": prefill_route[branch],
              "split": (launches[branch] - prefill_route[branch]
                        - decode_route[branch])}
    check(routes == {"decode": cfg.n_layers * summ["decode_steps"],
                     "prefill": cfg.n_layers * chunks, "split": 0}
          and sum(prefill_route.values()) == routes["prefill"]
          and sum(decode_route.values()) == routes["decode"],
          f"launches by route {routes}: want n_layers x decode iterations "
          f"{summ['decode_steps']} on the decode route, n_layers x prefill "
          f"chunks {chunks} on the prefill route and none on the split "
          f"route")
    result = {
        "phase": phase, "model": "llama3-8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", **kw, "slots": 4, "prefill_chunk_tokens": 512,
        "requests": 8, "prompt_tokens": summ["prompt_tokens"],
        "new_tokens": sum(len(o.tokens) for o in outs),
        "decode_iterations": summ["decode_steps"], "prefill_chunks": chunks,
        "kernel_launches": launches[branch], "route_launches": routes,
        "prefill_tokens_per_s": summ["prompt_tokens"] / acc["_prefill"],
        "decode_tokens_per_s": eng.stats.decode_tokens / acc["_decode_step"],
        "prefill_s": acc["_prefill"], "decode_s": acc["_decode_step"],
        "decode_iteration_ms": acc["_decode_step"] / summ["decode_steps"] * 1e3,
        "prefill_chunk_ms": acc["_prefill"] / chunks * 1e3,
        "wall_s": wall, "setup_s": setup_s,
        "ttft_p50_ms": summ["ttft_p50_ms"],
        "latency_p50_ms": summ["latency_p50_ms"],
        "mean_slot_occupancy": summ["mean_slot_occupancy"],
        "setup_peak_memory_gb": setup_peak,
        "resident_after_setup_gb": resident,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "bytes_per_page": {m or "fp": eng._block_nbytes(PAGE, kv_quant=m)
                           for m in (None, "int8")},
        **{k: summ[k] for k in ("kv_quant_bytes_saved",
                                "weight_quant_bytes_saved")}}
    streams = {o.request_id: o.tokens for o in outs}
    return result, streams, eng


def _zero_counts(attn) -> None:
    attn.launches = attn.launches_int8 = 0
    attn.launches_prefill = attn.launches_prefill_int8 = 0
    attn.launches_decode = attn.launches_decode_int8 = 0


def phase_b(dev):
    result, streams, eng = _serve_phase("B", dev, quant=False)
    log(result)
    decode_profile("B", eng, result["layers"])
    result["prefill_profile"] = prefill_profile("B", eng, result["layers"])
    return result, streams


def phase_j(dev, b_streams):
    result, streams, eng = _serve_phase("J", dev, quant=True)
    # A reading, not a gate: with random weights, near-ties of the greedy
    # argmax flip under int8 noise, and a flip changes the rest of that
    # stream.
    greedy = [rid for rid in sorted(streams) if rid not in ("r2", "r5")]
    same = sum(a == b for rid in greedy
               for a, b in zip(streams[rid], b_streams[rid]))
    total = sum(len(b_streams[rid]) for rid in greedy)
    first_diff = {rid: next((i for i, (a, b) in enumerate(
        zip(streams[rid], b_streams[rid])) if a != b), None)
        for rid in greedy}
    result.update({"greedy_tokens_equal_to_phase_b": same,
                   "greedy_tokens_compared": total,
                   "greedy_agreement_share": same / total,
                   "first_differing_token": first_diff})
    log(result)
    decode_profile("J", eng, result["layers"])
    result["prefill_profile"] = prefill_profile("J", eng, result["layers"])
    return result


def _kernel_class(name: str) -> str:
    for key, cls in (("paged_prefill", "paged_prefill"),
                     ("paged_decode", "paged_decode"),
                     ("paged_attn", "paged_attn"),
                     ("flash_fwd_kernel", "flash_fwd"),
                     ("flash_fwd_wgmma", "flash_fwd_wgmma"),
                     ("flash_dq_kernel", "flash_dq"),
                     ("flash_dkv_kernel", "flash_dkv"),
                     ("flash_dq_wgmma", "flash_dq_wgmma"),
                     ("flash_dkv_wgmma", "flash_dkv_wgmma"),
                     ("gmm_kernel", "gmm"),         # gmm_ and tgmm_kernel
                     ("gmm_wgmma", "gmm_wgmma")):   # gmm_ and tgmm_wgmma
        if key in name:
            return cls
    if any(s in name for s in ("gemm", "gemv", "cutlass", "nvjet", "sm90")):
        return "matmul"
    return "other"


def _device_ms_by_kernel(prof, steps: int):
    """(name, launches, device ms per step) for every CUDA kernel in a
    ``torch.profiler`` run of ``steps`` steps, longest first. The
    ``ProfilerStep#n`` ranges that a schedule marks on the device span a
    step's kernels and are not counted."""
    from torch.autograd import DeviceType

    kernels = []
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append((e.key, e.count, us / 1e3 / steps))
    kernels.sort(key=lambda k: -k[2])
    return kernels


def _by_class(kernels) -> dict:
    out: dict[str, float] = {}
    for name, _, ms in kernels:
        out[_kernel_class(name)] = out.get(_kernel_class(name), 0.0) + ms
    return out


def _profile_reps(fn, reps: int):
    """``torch.profiler`` over ``reps`` calls of ``fn``, after one warm-up
    call with the profiler already tracing: kernels launched as tracing
    starts can be missing from its record, and the launch counts read from
    it are checked exactly."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        for i in range(reps + 1):
            fn()
            if i == reps:
                torch.cuda.synchronize()
            prof.step()
    return prof


def _profile(fn, reps: int) -> dict:
    """Where one call of ``fn`` goes, per call: the host clock over
    ``reps`` calls, then device time by kernel over ``reps`` more under
    ``torch.profiler``; the busy share divides the profiled device time by
    the unprofiled host time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    kernels = _device_ms_by_kernel(_profile_reps(fn, reps), reps)
    device_ms = sum(k[2] for k in kernels)
    launches: dict[str, float] = {}
    for name, count, _ in kernels:
        cls = _kernel_class(name)
        launches[cls] = launches.get(cls, 0) + count / reps
    return {"reps": reps, "host_ms": host_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / host_ms,
            "device_ms_by_class": _by_class(kernels),
            "launches": sum(launches.values()),
            "launches_by_class": launches,
            "top_kernels": [{"name": n[:90], "launches": c / reps,
                             "ms": ms} for n, c, ms in kernels[:10]]}


def decode_profile(phase, eng, n_layers, steps: int = 16):
    """Where a decode iteration's time goes, with every slot busy
    (:func:`_profile` over ``steps`` iterations)."""
    from k8s_distributed_deeplearning_torch.serve import Request

    vocab = eng.model.cfg.vocab_size
    rng = np.random.default_rng(2)
    for i in range(eng.num_slots):
        eng.submit(Request(prompt=rng.integers(0, vocab, 512).astype(np.int32),
                           max_new_tokens=3 * steps,
                           request_id=f"p{i}"))
    while eng.occupied_slots() < eng.num_slots:
        eng.step()
    prof = _profile(eng.step, steps)
    check(eng.occupied_slots() == eng.num_slots,
          "a slot emptied inside the profiled decode window")
    eng.run()
    paged = {cls: prof["launches_by_class"].get(cls, 0)
             for cls in ("paged_decode", "paged_attn")}
    check(paged == {"paged_decode": n_layers, "paged_attn": 0},
          f"decode profile launches a step by class {paged}: want "
          f"{n_layers} of the decode kernel and none of the split kernel")
    log({"phase": phase, "case": "decode_profile", "slots": eng.num_slots,
         **prof, "launches_per_layer": prof["launches"] / n_layers})


def _table(eng, n_tokens: int):
    """Fresh pool pages for ``n_tokens`` and a one-row block table over
    them (the rest on the scratch page)."""
    pages = eng.pool.alloc(-(-n_tokens // eng.page_tokens))
    table = np.zeros((1, eng.max_blocks), np.int32)
    table[0, :len(pages)] = pages
    return pages, table


def prefill_profile(phase, eng, n_layers, offset: int = 1024,
                    chunk: int = 512, reps: int = 4):
    """Where a prefill chunk's time goes (:func:`_profile`): a 512-token
    chunk at offset 1024 of a random prompt (the chunks before it written
    first). Then the same again with the split kernel forced in place of
    the prefill route, on the same card in the same run: the before and
    after of the route."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    vocab = eng.model.cfg.vocab_size
    prompt = np.random.default_rng(3).integers(
        0, vocab, offset + chunk).astype(np.int32)
    pages, table = _table(eng, offset + chunk)

    def run(start):
        eng._prefill(prompt[None, start:start + chunk], table, start, None)

    for start in range(0, offset + 1, chunk):
        run(start)
    result = {"phase": phase, "case": "prefill_profile", "offset": offset,
              "chunk_tokens": chunk, "reps": reps}
    routed = paged_attn._route
    try:
        for route in ("prefill", "split"):
            paged_attn._route = lambda *a, route=route: route
            run(offset)
            result[route] = _profile(lambda: run(offset), reps)
    finally:
        paged_attn._route = routed
        for page in pages:
            eng.pool.deref(page)
    got = {route: result[route]["launches_by_class"]
           for route in ("prefill", "split")}
    check(got["prefill"].get("paged_prefill") == n_layers
          and "paged_attn" not in got["prefill"]
          and got["split"].get("paged_attn", 0) >= n_layers
          and "paged_prefill" not in got["split"],
          f"prefill chunk launches by class {got}: want {n_layers} of the "
          "prefill kernel on its route and none of the split kernel, and "
          "the reverse with the split kernel forced")
    result["device_ms_saved_per_chunk"] = (
        result["split"]["device_ms"]
        - result["prefill"]["device_ms"])
    log(result)
    return result


def _paths_phase(phase, dev, quant: bool):
    """Phases C and K: f32 at 8B width and 4 layers, greedy, the kernel
    path (``attention_impl="auto"``) against the plain path (``"xla"``); K
    with int8 KV pages and int8 weights. The first 16 tokens of every
    request agree, and only the kernel path launches the kernel."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    attn = paged_attn.paged_decode_attention
    streams, launches = {}, {}
    for impl in ("auto", "xla"):
        cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                     dtype=torch.float32,
                                     attention_impl=impl)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                          device=dev, **kw)
        _zero_counts(attn)
        outs = eng.run(_requests(cfg.vocab_size, 16, sampled=False))
        launches[impl] = {"fp": attn.launches, "int8": attn.launches_int8}
        streams[impl] = {o.request_id: o.tokens for o in outs}
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    agree = {rid: streams["auto"][rid] == streams["xla"][rid]
             for rid in sorted(streams["auto"])}
    result = {"phase": phase, "model": "llama3-8b width, 4 layers",
              "dtype": "float32", **kw, "requests": len(agree),
              "tokens_compared": 16, "launches": launches,
              "streams_agree": agree}
    log(result)
    check(len(agree) == 8 and all(agree.values()),
          "kernel-path and plain-path greedy streams differ")
    branch = "int8" if quant else "fp"
    check(launches["auto"][branch] > 0 and not any(
        launches["xla"].values()) and not launches["auto"][
            "fp" if quant else "int8"],
          f"launches by path {launches}: the {branch} branch on the kernel "
          "path only")
    return result


def _bf16_prefill_logits(phase, dev, quant: bool):
    """The prefill route on the model path, in bf16 (phases C and K run in
    f32, which never reaches it): at 8B width and 4 layers, every
    request's prompt prefilled in 512-token chunks (the final one bucketed
    as the engine does) through the kernel path and the plain path
    (``"xla"``), with the same weights. The last position's logits agree
    within BF16_LOGIT_RTOL (relative L2 per request), and the first greedy
    token is equal wherever the plain path's top-2 margin exceeds twice
    that request's largest logit difference."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    attn = paged_attn.paged_decode_attention
    logits, launches, chunks = {}, {}, 0
    for impl in ("auto", "xla"):
        cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                     dtype=torch.bfloat16,
                                     attention_impl=impl)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        eng = ServeEngine(model, num_slots=2, prefill_chunk_tokens=512,
                          device=dev, **kw)
        _zero_counts(attn)
        rows, chunks = [], 0
        for req in _requests(cfg.vocab_size, 16, sampled=False):
            n = len(req.prompt)
            pages, table = _table(eng, n)
            start = 0
            while n - start > 512:
                eng._prefill(req.prompt[None, start:start + 512], table,
                             start, None)
                start += 512
                chunks += 1
            rem = n - start
            last = np.full((1, eng._bucket(rem)), eng.pad_id, np.int32)
            last[0, :rem] = req.prompt[start:]
            rows.append(eng._prefill(last, table, start, rem - 1).float())
            chunks += 1
            for page in pages:
                eng.pool.deref(page)
        logits[impl] = torch.cat(rows)
        launches[impl] = {"fp": attn.launches, "int8": attn.launches_int8,
                          "prefill_fp": attn.launches_prefill,
                          "prefill_int8": attn.launches_prefill_int8}
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    branch = "int8" if quant else "fp"
    want = {k: 0 for k in launches["auto"]}
    want.update({branch: cfg.n_layers * chunks,
                 f"prefill_{branch}": cfg.n_layers * chunks})
    check(launches["auto"] == want and not any(launches["xla"].values()),
          f"bf16 prefill launches by path {launches}: want {want} on the "
          "kernel path, none on the plain path")
    kern, ref = logits["auto"], logits["xla"]
    diff = (kern - ref).abs()
    rel = ((kern - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
    largest = diff.max(dim=-1).values
    top2 = ref.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * largest
    same = kern.argmax(-1) == ref.argmax(-1)
    result = {"phase": phase, "case": "bf16_prefill_logits",
              "model": "llama3-8b width, 4 layers", "dtype": "bfloat16",
              **kw, "requests": len(rel), "prefill_chunks": chunks,
              "launches": launches, "logit_rel_l2": rel,
              "rtol": BF16_LOGIT_RTOL,
              "max_abs_diff_over_rms": float(diff.max()
                                             / ref.square().mean().sqrt()),
              "first_token_decided": decided.tolist(),
              "first_token_equal": same.tolist()}
    log(result)
    check(all(np.isfinite(rel)) and max(rel) <= BF16_LOGIT_RTOL,
          f"bf16 prefill logits: relative L2 {max(rel)} > {BF16_LOGIT_RTOL}")
    check(bool(same[decided].all()),
          "bf16 prefill: a first greedy token differs where the plain "
          "path's top-2 margin exceeds twice the largest logit difference")
    return result


def phase_c(dev):
    result = _paths_phase("C", dev, quant=False)
    result["bf16_prefill"] = _bf16_prefill_logits("C", dev, quant=False)
    return result


def phase_k(dev):
    result = _paths_phase("K", dev, quant=True)
    result["bf16_prefill"] = _bf16_prefill_logits("K", dev, quant=True)
    return result


# ------------------------------------------------------------- phase L/M

GEN_NEW = 32


def _all_launches() -> dict:
    """Every wrapper's launches by kernel-line name (:func:`_launch_counts`)
    and the paged wrapper's by branch and route."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    attn = paged_attn.paged_decode_attention
    out = _launch_counts()
    out.update({f"paged_{k}": getattr(attn, k) for k in (
        "launches_int8", "launches_prefill", "launches_prefill_int8",
        "launches_decode", "launches_decode_int8")})
    return out


def _zero_all() -> None:
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    _zero_launches()
    _zero_counts(paged_attn.paged_decode_attention)


def _pad_left(rows) -> tuple[np.ndarray, np.ndarray]:
    """Token rows left-padded (with 0) to the longest, and their mask."""
    s = max(len(r) for r in rows)
    prompt = np.zeros((len(rows), s), np.int32)
    mask = np.zeros((len(rows), s), np.int32)
    for i, r in enumerate(rows):
        prompt[i, s - len(r):] = r
        mask[i, s - len(r):] = 1
    return prompt, mask


def _left_padded(vocab, lens, seed):
    """Random prompts of ``lens`` real tokens each, left-padded."""
    rng = np.random.default_rng(seed)
    return _pad_left([rng.integers(0, vocab, n) for n in lens])


class _PrefillSpy:
    """While in use, ``models.generate.prefill`` is wrapped: synchronized
    on both sides, each call records its seconds, the cache it made and
    every wrapper's launches just after it."""

    def __enter__(self):
        from k8s_distributed_deeplearning_torch.models import generate

        self.lib, self.orig = generate, generate.prefill

        def spied(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            self.cache = cache
            self.launches = _all_launches()
            return logits, cache

        generate.prefill = spied
        return self

    def __exit__(self, *exc):
        self.lib.prefill = self.orig


def _generate(model, prompt, **kw):
    """One ``generate`` call on a host prompt, synchronized: tokens on the
    host and its wall seconds. The tokens come back on the model's
    device."""
    from k8s_distributed_deeplearning_torch.models import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate.generate(model, prompt, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    where = next(model.parameters()).device
    check(out.device == where, f"generate ran on {out.device}, the model "
          f"lives on {where}")
    return out.cpu().numpy(), wall


def _in_vocab(tokens, vocab, what):
    check(bool(((tokens >= 0) & (tokens < vocab)).all()),
          f"{what}: token outside the vocabulary")


def phase_l(dev):
    """Phase L: one-shot ``generate`` at Llama-3 8B, full width and depth,
    bf16, random weights from seed 0, on the dense cache; then the f32
    cross-checks at 4 layers."""
    from k8s_distributed_deeplearning_torch.models import generate, llama

    cfg = llama.config_llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    lens = [1500] + np.random.default_rng(6).integers(100, 1500, 3).tolist()
    prompt, mask = _left_padded(cfg.vocab_size, lens, seed=7)
    window = generate.cache_window(cfg.max_seq_len, prompt.shape[1],
                                   GEN_NEW)
    sampling = dict(temperature=0.8, top_k=50, top_p=0.9)
    runs = {}
    with _PrefillSpy() as spy:
        _zero_all()
        # The first call pays the allocator's growth and cuBLAS's first
        # plans; the rates come from the second greedy run.
        for name in ("greedy_first", "greedy", "sampled", "sampled_again"):
            kw = {}
            if name.startswith("sampled"):
                gen = torch.Generator(device=dev)
                gen.manual_seed(11)
                kw = dict(sampling, generator=gen)
            out, wall = _generate(model, prompt, max_new_tokens=GEN_NEW,
                                  prompt_mask=mask, **kw)
            check(out.shape == (4, GEN_NEW), f"{name}: shape {out.shape}")
            _in_vocab(out, cfg.vocab_size, name)
            check(spy.cache.length == window,
                  f"{name}: cache of {spy.cache.length} columns, want the "
                  f"window {window}")
            runs[name] = {"tokens": out, "prefill_s": spy.seconds,
                          "wall_s": wall}
        launches = _all_launches()
        cache = spy.cache
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not any(launches.values()),
          f"launches during generate {launches}: the dense path runs no "
          "paged, flash or grouped-matmul kernel")
    check(np.array_equal(runs["sampled"]["tokens"],
                         runs["sampled_again"]["tokens"]),
          "two sampled runs from one seed differ")
    greedy = runs["greedy"]["tokens"]
    check(np.array_equal(greedy, runs["greedy_first"]["tokens"]),
          "two greedy runs differ")
    # A reading, not a gate: a row alone multiplies [1, S] matrices, the
    # batch [4, S], and cuBLAS may sum those in another order in bf16.
    alone = []
    for i, n in enumerate(lens):
        row, _ = _generate(model, prompt[i:i + 1, -n:],
                           max_new_tokens=GEN_NEW)
        same = row[0] == greedy[i]
        alone.append({"len": n, "equal": int(same.sum()),
                      "first_diff": (None if same.all()
                                     else int(np.argmin(same)))})
    pm = torch.from_numpy(mask).to(dev)
    step_kw = dict(positions=pm.sum(-1, dtype=torch.int32)[:, None],
                   segment_ids=torch.ones(4, 1, dtype=torch.int32,
                                          device=dev))
    token = torch.from_numpy(greedy[:, 0]).to(dev)

    def step():
        cache.index = prompt.shape[1]
        generate.decode_step(model, cache, token, **step_kw).argmax(-1)

    step()
    profile = _profile(step, 16)
    del cache
    p_t, p_kw = torch.from_numpy(prompt).to(dev), \
        generate.left_padded_inputs(pm)
    prefill_prof = _profile(
        lambda: generate.prefill(model, p_t, cache_len=window,
                                 logits_index=-1, **p_kw), 2)
    g = runs["greedy"]
    result = {
        "phase": "L", "model": "llama3-8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", "batch": 4, "prompt_lens": lens,
        "prompt_columns": prompt.shape[1], "cache_window": window,
        "new_tokens": GEN_NEW, "sampling": sampling,
        "prefill_ms": g["prefill_s"] * 1e3,
        "prefill_tokens_per_s": int(mask.sum()) / g["prefill_s"],
        "decode_tokens_per_s": 4 * (GEN_NEW - 1)
        / (g["wall_s"] - g["prefill_s"]),
        "generate_s": {k: v["wall_s"] for k, v in runs.items()},
        "prefill_s": {k: v["prefill_s"] for k, v in runs.items()},
        "peak_memory_gb": peak_gb,
        "launches": launches, "sampled_runs_equal": True,
        "greedy_alone_tokens_equal": sum(a["equal"] for a in alone),
        "greedy_alone_tokens_compared": 4 * GEN_NEW,
        "greedy_alone_rows": alone, "decode_step": profile,
        "prefill_profile": prefill_prof}
    log(result)
    del model, spy, step
    gc.collect()
    torch.cuda.empty_cache()
    result["f32"] = _generate_f32(dev)
    return result


def _generate_f32(dev):
    """Phase L in f32 (TF32 off) at 8B width and 4 layers, one set of
    weights: each of phase C's 8 requests generated alone equals the
    port's ``ServeEngine`` greedy stream (the split paged kernel) for 16
    tokens, and each row of a left-padded batch of the first 4 equals that
    row alone. ``generate`` launches no kernel."""
    from k8s_distributed_deeplearning_torch.models import generate, llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                 dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    reqs = _requests(cfg.vocab_size, 16, sampled=False)
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev)
    attn = paged_attn.paged_decode_attention
    _zero_all()
    engine = {o.request_id: o.tokens for o in eng.run(reqs)}
    routes = {"split": attn.launches - attn.launches_prefill
              - attn.launches_decode, "prefill": attn.launches_prefill,
              "decode": attn.launches_decode}
    check(routes["split"] > 0 and not routes["prefill"]
          and not routes["decode"],
          f"f32 engine launches by route {routes}: want the split route")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _zero_all()
    alone = {r.request_id: _generate(model, r.prompt[None],
                                     max_new_tokens=16)[0][0].tolist()
             for r in reqs}
    lens = [len(r.prompt) for r in reqs[:4]]
    prompt, mask = _pad_left([r.prompt for r in reqs[:4]])
    padded, _ = _generate(model, prompt, max_new_tokens=16, prompt_mask=mask)
    launches = _all_launches()
    engine_equal = {rid: alone[rid] == engine[rid] for rid in sorted(alone)}
    padded_equal = {r.request_id: padded[i].tolist() == alone[r.request_id]
                    for i, r in enumerate(reqs[:4])}
    result = {"phase": "L", "case": "f32_cross_checks",
              "model": "llama3-8b width, 4 layers", "dtype": "float32",
              "requests": len(reqs), "tokens_compared": 16,
              "engine_launches_by_route": routes,
              "generate_launches": {k: v for k, v in launches.items() if v},
              "generate_equals_engine": engine_equal,
              "padded_prompt_lens": lens,
              "padded_row_equals_alone": padded_equal}
    log(result)
    check(not any(launches.values()),
          f"f32 generate launches {launches}: want none")
    check(all(engine_equal.values()),
          "f32 generate and ServeEngine greedy streams differ")
    check(all(padded_equal.values()),
          "f32 left-padded rows differ from the rows generated alone")
    del model
    return result


# Phase M, bf16: the logits of every real prefill position, ragged against
# index dispatch on the same weights, relative L2 per row. The wgmma
# grouped GEMM and cuBLAS's batched matmul sum each product in the same
# order on the H100, and the two paths read bitwise-equal logits there
# (relative L2 0.0, PERF.md section 6). The limit is one bf16 step: a
# change of either summation order reads near it or above it, and a row
# block sent to the wrong expert, which the phase plants in the first
# layer to show that the check sees it, reads far above it.
MOE_BF16_LOGIT_RTOL = 2 ** -8


def _real_rel_l2(got, want, mask) -> list:
    """Relative L2 of ``got`` against ``want`` [B, S, V] per row, over the
    row's real positions (``mask`` [B, S], numpy, nonzero where real)."""
    real = torch.from_numpy(mask).to(got.device).bool()
    return [float((got[b, m] - want[b, m]).norm() / want[b, m].norm())
            for b, m in enumerate(real)]


class _MisroutedBlock:
    """Within the ``with`` block, the first grouped layout that the MoE
    layer builds sends its first live row block to the next expert (a
    routing fault planted to show that phase M's comparison sees one)."""

    def __enter__(self):
        from k8s_distributed_deeplearning_torch.models import moe

        self.gmm_ops = moe.gmm_ops
        self.build = build = self.gmm_ops.grouped_layout
        self.planted = 0

        def faulty(group_sizes, total_rows, block_m):
            lay = build(group_sizes, total_rows, block_m=block_m)
            if self.planted:
                return lay
            self.planted += 1
            experts = lay.block_expert.clone()
            blk = int(lay.block_live.argmax())
            experts[blk] = (experts[blk] + 1) % group_sizes.shape[0]
            return lay._replace(block_expert=experts)

        self.gmm_ops.grouped_layout = faulty
        return self

    def __exit__(self, *exc):
        self.gmm_ops.grouped_layout = self.build


def _rel_l2(got, want, dims) -> list:
    return ((got - want).norm(dim=dims) / want.norm(dim=dims)).tolist()


def phase_m(dev):
    """Phase M: ``generate`` on the ragged MoE (phase H's backbone, 8
    experts top-2, block 512), bf16; launches exact; ragged against index
    dispatch in bf16 and, at 2 layers, in f32."""
    import dataclasses

    from k8s_distributed_deeplearning_torch.models import generate, llama, moe

    cfg = llama.config_tiny(**MOE_BACKBONE, max_seq_len=1024,
                            dtype=torch.bfloat16)
    mcfg = moe.MoEConfig(num_experts=8, top_k=2, dispatch="ragged",
                         ragged_block_m=512)
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = moe.MoELM(cfg, mcfg, device=dev, seed=0)
    lens = [512] + np.random.default_rng(8).integers(100, 512, 3).tolist()
    prompt, mask = _left_padded(cfg.vocab_size, lens, seed=9)
    # A first call pays the allocator's growth and cuBLAS's first plans.
    first, _ = _generate(model, prompt, max_new_tokens=GEN_NEW,
                         prompt_mask=mask)
    with _PrefillSpy() as spy:
        _zero_all()
        out, wall = _generate(model, prompt, max_new_tokens=GEN_NEW,
                              prompt_mask=mask)
        at_prefill, prefill_s = spy.launches, spy.seconds
        window = spy.cache.length
        launches = _all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _in_vocab(out, cfg.vocab_size, "MoE generate")
    check(np.array_equal(out, first), "two MoE greedy runs differ")
    want = {k: 0 for k in launches}
    want.update(gmm=3 * n, gmm_wgmma=3 * n)
    check(at_prefill == want,
          f"MoE prefill launches {at_prefill}: want {want} (3 grouped "
          "GEMMs a layer on the wgmma route)")
    check(launches == want,
          f"MoE generate launches {launches}: the decode steps (t = 4, the "
          f"index path) must add none to the prefill's {want}")
    p_t = torch.from_numpy(prompt).to(dev)
    kw = generate.left_padded_inputs(torch.from_numpy(mask).to(dev))

    def prefill(m, **extra):
        return generate.prefill(m, p_t, cache_len=window, **kw, **extra)[0]

    profile = _profile(lambda: prefill(model, logits_index=-1), 4)
    index = moe.MoELM(cfg, dataclasses.replace(mcfg, dispatch="index"),
                      device=dev, seed=0)
    index.load_state_dict(model.state_dict())
    logits, compare_launches = {}, {}
    for name, m in (("ragged", model), ("index", index)):
        _zero_all()
        logits[name] = prefill(m)
        compare_launches[name] = {k: v for k, v in _all_launches().items()
                                  if v}
    check(compare_launches == {"ragged": {"gmm": 3 * n,
                                          "gmm_wgmma": 3 * n},
                               "index": {}},
          f"bf16 comparison prefills launched {compare_launches}: want the "
          "grouped GEMMs on the ragged path only")
    ragged_all, index_all = logits["ragged"].float(), logits["index"].float()
    rel = _real_rel_l2(ragged_all, index_all, mask)
    with _MisroutedBlock() as fault:
        faulty = prefill(model).float()
    check(fault.planted == 1, "the misrouted block was not planted")
    fault_rel = _real_rel_l2(faulty, index_all, mask)
    ragged_last, index_last = ragged_all[:, -1], index_all[:, -1]
    largest = (ragged_last - index_last).abs().max(-1).values
    top2 = index_last.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * largest
    same = ragged_last.argmax(-1) == index_last.argmax(-1)
    bitwise = torch.equal(logits["ragged"], logits["index"])
    del logits, ragged_all, index_all, faulty
    del model, index, spy
    gc.collect()
    torch.cuda.empty_cache()
    result = {
        "phase": "M", "model": "llama-small MoE 8e top-2 ragged",
        "layers": n, "dtype": "bfloat16", "experts": mcfg.num_experts,
        "top_k": mcfg.top_k, "ragged_block_m": mcfg.ragged_block_m,
        "batch": 4, "prompt_lens": lens, "cache_window": window,
        "new_tokens": GEN_NEW, "prefill_ms": prefill_s * 1e3,
        "decode_tokens_per_s": 4 * (GEN_NEW - 1) / (wall - prefill_s),
        "generate_s": wall, "peak_memory_gb": peak_gb,
        "prefill_launches": {k: v for k, v in at_prefill.items() if v},
        "generate_launches": {k: v for k, v in launches.items() if v},
        "prefill_profile": profile,
        "bf16_ragged_vs_index": {
            "launches": compare_launches,
            "logit_rel_l2": rel, "rtol": MOE_BF16_LOGIT_RTOL,
            "bitwise_equal": bitwise,
            "misrouted_block_rel_l2": fault_rel,
            "first_token_decided": decided.tolist(),
            "first_token_equal": same.tolist()}}
    log(result)
    check(all(np.isfinite(rel)) and max(rel) <= MOE_BF16_LOGIT_RTOL,
          f"bf16 MoE prefill logits, ragged vs index: relative L2 "
          f"{max(rel)} > {MOE_BF16_LOGIT_RTOL}")
    check(max(fault_rel) > MOE_BF16_LOGIT_RTOL,
          f"a row block sent to the wrong expert reads relative L2 "
          f"{max(fault_rel)}, within the limit {MOE_BF16_LOGIT_RTOL}")
    check(bool(same[decided].all()),
          "bf16 MoE prefill: a first greedy token differs where the index "
          "path's top-2 margin exceeds twice the largest logit difference")
    result["f32"] = _moe_f32(dev, mcfg, prompt, mask)
    return result


def _moe_f32(dev, mcfg, prompt, mask):
    """Phase M in f32 (TF32 off) at 2 layers, one set of weights: the
    ragged path (the grouped GEMMs on the mma route, 3 a layer in the
    prefill) and ``dispatch="index"`` give the same first 16 greedy tokens,
    and their prefill logits agree within 1e-4 relative L2 per row."""
    import dataclasses

    from k8s_distributed_deeplearning_torch.models import generate, llama, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.config_tiny(**dict(MOE_BACKBONE, n_layers=2),
                            max_seq_len=1024, dtype=torch.float32)
    ragged = moe.MoELM(cfg, mcfg, device=dev, seed=0)
    index = moe.MoELM(cfg, dataclasses.replace(mcfg, dispatch="index"),
                      device=dev, seed=0)
    index.load_state_dict(ragged.state_dict())
    streams, launches = {}, {}
    for name, m in (("ragged", ragged), ("index", index)):
        _zero_all()
        streams[name], _ = _generate(m, prompt, max_new_tokens=16,
                                     prompt_mask=mask)
        launches[name] = {k: v for k, v in _all_launches().items() if v}
    p_t = torch.from_numpy(prompt).to(dev)
    kw = generate.left_padded_inputs(torch.from_numpy(mask).to(dev))
    window = generate.cache_window(cfg.max_seq_len, prompt.shape[1], 16)
    logits = {name: generate.prefill(m, p_t, cache_len=window, **kw)[0]
              for name, m in (("ragged", ragged), ("index", index))}
    rel = _rel_l2(logits["ragged"], logits["index"], (-2, -1))
    equal = np.array_equal(streams["ragged"], streams["index"])
    result = {"phase": "M", "case": "f32_ragged_vs_index", "layers": 2,
              "dtype": "float32", "tokens_compared": 16,
              "launches": launches, "streams_equal": equal,
              "prefill_logit_rel_l2": rel}
    log(result)
    n = cfg.n_layers
    check(launches == {"ragged": {"gmm": 3 * n}, "index": {}},
          f"f32 MoE generate launches {launches}: want {3 * n} gmm on the "
          "mma route for ragged, none for index")
    check(equal, "f32 MoE greedy streams differ, ragged vs index")
    check(max(rel) <= 1e-4,
          f"f32 MoE prefill logits, ragged vs index: relative L2 "
          f"{max(rel)} > 1e-4")
    del ragged, index, logits
    return result


# ------------------------------------------------------------- phase D

# name: (B, sq, sk, H, KV, head_dim, causal, segment lengths). Llama-3
# 8B's attention at training length, then MoE H's (the Llama-small
# backbone's 12/4 heads at head_dim 64, 8 x 1024 tokens).
FLASH_CASES = {
    "causal": (2, 2048, 2048, H, KV, HD, True, None),
    "noncausal": (2, 2048, 2048, H, KV, HD, False, None),
    "sq512_sk2048_causal": (2, 512, 2048, H, KV, HD, True, None),
    "three_docs_causal": (2, 2048, 2048, H, KV, HD, True, (700, 800, 548)),
    "moe_h_causal": (8, 1024, 1024, 12, 4, 64, True, None),
}
FLASH_REPLACES = {
    "flash_fwd": "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:148",
    "flash_bwd_dq": "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:396",
    "flash_bwd_dkv":
        "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:520",
}
# Kernel-line name -> (source, wrapper); FLASH_REPLACES names the TPU
# kernel by wrapper. Each wrapper launches the kernel of either route: the
# wgmma lines are its "wgmma" route (bf16, head_dim 64/128), the others the
# mma.sync kernels of flash_attn.cu ("mma": f32 on the training path,
# forced in bf16 here).
FLASH_KERNELS = {
    "flash_fwd": ("flash_attn.cu", "flash_fwd"),
    "flash_fwd_wgmma": ("flash_fwd.cu", "flash_fwd"),
    "flash_bwd_dq": ("flash_attn.cu", "flash_bwd_dq"),
    "flash_bwd_dkv": ("flash_attn.cu", "flash_bwd_dkv"),
    "flash_bwd_dq_wgmma": ("flash_bwd.cu", "flash_bwd_dq"),
    "flash_bwd_dkv_wgmma": ("flash_bwd.cu", "flash_bwd_dkv"),
}


def _flash_case(dev, dtype, shape, seed):
    b, sq, sk, h, kv, hd, _, seg_lens = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(dtype)

    q = rnd(b, sq, h, hd)
    k, v = rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)
    do = rnd(b, sq, h, hd)
    segq = segk = None
    if seg_lens is not None:
        ids = torch.repeat_interleave(
            torch.arange(1, len(seg_lens) + 1, device=dev),
            torch.tensor(seg_lens, device=dev)).to(torch.int32)
        segk = ids[None].expand(b, sk).contiguous()
        segq = segk[:, sk - sq:].contiguous()
    return q, k, v, do, segq, segk


def _visible_pairs(dev, shape, segq, segk):
    """(query, key) pairs the mask lets through, summed over the batch."""
    b, sq, sk, _, _, _, causal, _ = shape
    row = torch.arange(sq, device=dev)[:, None]
    col = torch.arange(sk, device=dev)[None, :]
    allow = torch.ones(1, sq, sk, dtype=torch.bool, device=dev)
    if causal:
        allow = allow & (row + (sk - sq) >= col)[None]
    if segq is not None:
        allow = allow & (segq[:, :, None] == segk[:, None, :])
    return int(allow.sum()) * (b if allow.shape[0] == 1 else 1)


def _flash_bound(kind, dtype, shape, pairs):
    """Least time on an H100 SXM: the larger of each input read once and
    each output written once over 3.35 TB/s, and the kernel's matmul FLOPs
    on the visible pairs over the dtype's peak (forward 2 products, dQ 3,
    dK/dV 4, each 2 * head_dim FLOPs per pair and query head)."""
    b, sq, sk, h, kv, hd, _, _ = shape
    item = torch.finfo(dtype).bits // 8
    qo = b * sq * h * hd * item                    # q, o, do or dq
    kvb = b * sk * kv * hd * item                  # k or v (dk or dv)
    stat = b * h * sq * 4                          # lse or delta, f32
    kind = kind.removesuffix("_wgmma")
    nbytes, mm = {"flash_fwd": (2 * qo + 2 * kvb + stat, 2),
                  "flash_bwd_dq": (3 * qo + 2 * kvb + 2 * stat, 3),
                  "flash_bwd_dkv": (2 * qo + 4 * kvb + 2 * stat, 4)}[kind]
    flops = mm * 2 * hd * h * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def _flash_err(outputs: dict, tol) -> dict:
    """Kernel outputs against the plain ones, ``{name: (got, ref)}``. Each
    element's scale is the larger of its row's RMS (the head_dim vector of
    one position and head) and the whole output's RMS. Returns the largest
    |got - ref|, the largest |got - ref| over its scale, and the largest
    share of the limit atol x scale + rtol x |ref| used (the check: <= 1),
    each the worst over the outputs."""
    atol, rtol = tol
    worst = {"max_abs_err": 0.0, "err_over_scale": 0.0, "tol_share": 0.0}
    for got, ref in outputs.values():
        r = ref.float()
        d = (got.float() - r).abs()
        scale = r.square().mean(-1, keepdim=True).sqrt().clamp_min(
            float(r.square().mean().sqrt()))
        reading = {
            "max_abs_err": float(d.max()),
            "err_over_scale": float((d / scale).max()),
            "tol_share": float((d / (atol * scale + rtol * r.abs())).max())}
        worst = {k: max(worst[k], reading[k]) for k in worst}
    return worst


def _sdpa_fns(q, k, v, do, causal, segq, segk):
    """scaled_dot_product_attention on the same inputs (heads-first views,
    GQA), forward alone and forward + backward: a yardstick only."""
    import torch.nn.functional as F

    sq, sk = q.shape[1], k.shape[1]
    mask, is_causal = None, causal and sq == sk and segq is None
    if (causal and not is_causal) or segq is not None:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones(1, 1, sq, sk, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (row + (sk - sq) >= col)
        if segq is not None:
            mask = mask & (segq[:, None, :, None] == segk[:, None, None, :])
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return fwd, fwd_bwd


def phase_d(dev, flush):
    """The flash kernels against their plain versions, case by case; in
    bf16 the forward and the backward on both routes (the wgmma kernels,
    and the mma.sync kernels forced) on the same inputs, and the wgmma
    kernels launched twice for bitwise equality."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    rows = {name: [] for name in FLASH_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tol = FLASH_TOL[dtype]
        for ci, (case, shape) in enumerate(FLASH_CASES.items()):
            causal, hd = shape[6], shape[5]
            q, k, v, do, segq, segk = _flash_case(dev, dtype, shape, ci)
            scale = hd ** -0.5
            fwd_routes = {"mma": "flash_fwd"}
            if fa._fwd_route(dtype, hd) == "wgmma":
                fwd_routes["wgmma"] = "flash_fwd_wgmma"
            fwd = {route: fa.flash_fwd(q, k, v, segq, segk, causal, scale,
                                       route=route) for route in fwd_routes}
            ref_o, ref_lse = fa.flash_attention_reference(
                q, k, v, causal=causal, q_segment_ids=segq,
                kv_segment_ids=segk)
            delta = (do.float() * ref_o.float()).sum(-1).transpose(
                1, 2).contiguous()
            bwd_args = (q, k, v, do, ref_lse, delta, segq, segk, causal,
                        scale)
            want = fa.flash_attention_bwd_reference(
                q, k, v, ref_o, ref_lse, do, causal=causal,
                q_segment_ids=segq, kv_segment_ids=segk)
            routes = {"mma": ("flash_bwd_dq", "flash_bwd_dkv")}
            if fa._bwd_route(dtype, hd) == "wgmma":
                routes["wgmma"] = ("flash_bwd_dq_wgmma",
                                   "flash_bwd_dkv_wgmma")
            got = {route: (fa.flash_bwd_dq(*bwd_args, route=route),
                           fa.flash_bwd_dkv(*bwd_args, route=route))
                   for route in routes}
            torch.cuda.synchronize()
            for out in [x for o_lse in fwd.values() for x in o_lse] + [
                    x for dq, (dk, dv) in got.values() for x in (dq, dk, dv)]:
                check(bool(torch.isfinite(out).all()),
                      f"{case}/{dname}: non-finite kernel output")
            seen = ref_lse > -1e29
            blind = ~seen.transpose(1, 2)            # [B, sq, H]
            errs = {}
            for route, name in fwd_routes.items():
                o, lse = fwd[route]
                check(torch.equal(lse <= -1e29, ~seen)
                      and torch.equal(lse[~seen], ref_lse[~seen])
                      and torch.equal(o[blind], ref_o[blind]),
                      f"{name} {case}/{dname}: rows that see no key differ")
                lse_err = float((lse[seen] - ref_lse[seen]).abs().max())
                check(lse_err <= LSE_ATOL,
                      f"{name} {case}/{dname}: lse error {lse_err} > "
                      f"{LSE_ATOL}")
                errs[name] = _flash_err({"o": (o, ref_o)}, tol)
                errs[name]["lse_max_abs_err"] = lse_err
            for route, (dq_name, dkv_name) in routes.items():
                dq, (dk, dv) = got[route]
                errs[dq_name] = _flash_err({"dq": (dq, want[0])}, tol)
                errs[dkv_name] = _flash_err({"dk": (dk, want[1]),
                                             "dv": (dv, want[2])}, tol)
            for name, e in errs.items():
                check(e["tol_share"] <= 1.0,
                      f"{name} {case}/{dname}: {e} exceeds |kernel - plain| "
                      f"<= {tol[0]} x rms + {tol[1]} x |plain|")
            if "wgmma" in got:            # two launches, the same bits
                dq, (dk, dv) = got["wgmma"]
                dq2 = fa.flash_bwd_dq(*bwd_args)
                dk2, dv2 = fa.flash_bwd_dkv(*bwd_args)
                o2, lse2 = fa.flash_fwd(q, k, v, segq, segk, causal, scale)
                check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                      and torch.equal(dv, dv2)
                      and torch.equal(fwd["wgmma"][0], o2)
                      and torch.equal(fwd["wgmma"][1], lse2),
                      f"{case}/{dname}: two wgmma launches differ")
                del dq2, dk2, dv2, o2, lse2
            del got, fwd, o, lse
            pairs = _visible_pairs(dev, shape, segq, segk)
            sdpa_fwd, sdpa_fwd_bwd = _sdpa_fns(q, k, v, do, causal, segq,
                                               segk)
            plain_bwd_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, ref_o, ref_lse, do, causal=causal,
                q_segment_ids=segq, kv_segment_ids=segk), flush, 10)
            lib_fwd = time_ms(sdpa_fwd, flush, 10, host_ahead=True)
            lib_fwd_bwd = time_ms(sdpa_fwd_bwd, flush, 10, host_ahead=True)
            plain_fwd_ms = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal=causal, q_segment_ids=segq,
                kv_segment_ids=segk), flush, 10)
            times = {name: (time_ms(lambda: fa.flash_fwd(
                q, k, v, segq, segk, causal, scale, route=route), flush, 10),
                plain_fwd_ms, lib_fwd) for route, name in fwd_routes.items()}
            for route, (dq_name, dkv_name) in routes.items():
                times[dq_name] = (time_ms(lambda: fa.flash_bwd_dq(
                    *bwd_args, route=route), flush, 10), plain_bwd_ms,
                    lib_fwd_bwd - lib_fwd)
                times[dkv_name] = (time_ms(lambda: fa.flash_bwd_dkv(
                    *bwd_args, route=route), flush, 10), plain_bwd_ms,
                    lib_fwd_bwd - lib_fwd)
            b, sq, sk, h, kv, _, _, seg_lens = shape
            for name, (ms, plain_ms, lib_ms) in times.items():
                bound, by = _flash_bound(name, dtype, shape, pairs)
                rows[name].append({
                    "case": case, "dtype": dname, "shape": {
                        "B": b, "sq": sq, "sk": sk, "H": h, "kv": kv,
                        "hd": hd, "causal": causal, "segments": seg_lens},
                    "visible_pairs": pairs, **errs[name],
                    "tol": {"atol_rms": tol[0], "rtol": tol[1]},
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_fwd_bwd_ms": lib_fwd_bwd,
                    "bound_ms": bound, "bound_by": by})
                log({"phase": "D", "kernel": name, **rows[name][-1]})
            del q, k, v, do, ref_o, ref_lse, want, delta, bwd_args
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- phase G

# (case, group sizes, routed rows, row block, K, N, dtypes), 8 experts: the
# MoE slice's expert products (gate and up: d 768 -> mlp 2048; down: 2048
# -> 768) at training's 16,384 rows and block 128; Mixtral-8x7B-class ones
# (4096 -> 14336, 14336 -> 4096) at 16,384 rows; the slice's products at
# phase M's prefill (B 4 x S 512 tokens at top-2: 4,096 rows, the layer's
# block 512). The case's index seeds its inputs.
GMM_CASES = [
    ("slice_gate_up", "router", GMM_ROWS, 128, 768, 2048,
     (torch.bfloat16, torch.float32)),
    ("slice_down", "router", GMM_ROWS, 128, 2048, 768,
     (torch.bfloat16, torch.float32)),
    ("mixtral_gate_up_balanced", "balanced", GMM_ROWS, 128, 4096, 14336,
     (torch.bfloat16,)),
    ("mixtral_down_balanced", "balanced", GMM_ROWS, 128, 14336, 4096,
     (torch.bfloat16,)),
    ("mixtral_gate_up_skewed", "skewed", GMM_ROWS, 128, 4096, 14336,
     (torch.bfloat16,)),
    ("mixtral_down_skewed", "skewed", GMM_ROWS, 128, 14336, 4096,
     (torch.bfloat16,)),
    ("prefill_gate_up", "router", 4096, 512, 768, 2048, (torch.bfloat16,)),
    ("prefill_down", "router", 4096, 512, 2048, 768, (torch.bfloat16,)),
]


def _gmm_sizes(kind: str, rows: int) -> list[int]:
    """Rows of each expert, ``rows`` in all: from a seeded top-2 router
    over rows / 2 tokens, even, or skewed (one expert 40 %, one empty)."""
    if kind == "router":
        logits = np.random.default_rng(5).standard_normal((rows // 2, GMM_E))
        top2 = np.argsort(-logits, axis=1)[:, :2]
        return np.bincount(top2.ravel(), minlength=GMM_E).tolist()
    if kind == "balanced":
        return [rows // GMM_E] * GMM_E
    big = int(0.4 * rows)
    rest = rows - big
    sizes = [big, 0] + [rest // 6] * 6
    sizes[2] += rest - sum(sizes[2:])
    return sizes


def _gmm_inputs(dev, dtype, sizes, block_m, k, n, seed):
    """The layout, lhs [M_pad, K], rhs [E, K, N] and an output gradient
    [M_pad, N]; rows that hold no token are 0 in lhs and in the gradient,
    as in the MoE layer."""
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops

    lay = gmm_ops.grouped_layout(
        torch.tensor(sizes, dtype=torch.int32, device=dev), sum(sizes),
        block_m=block_m)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    live = gmm_ops.live_rows(lay)[:, None]
    lhs = (torch.randn(lay.m_pad, k, generator=gen, device=dev)
           * live).to(dtype)
    rhs = (torch.randn(GMM_E, k, n, generator=gen, device=dev)
           * k ** -0.5).to(dtype)
    dout = (torch.randn(lay.m_pad, n, generator=gen, device=dev)
            * live).to(dtype)
    return lay, lhs, rhs, dout


def _grouped_mm_fns(lay, lhs, rhs, dout) -> dict:
    """``torch._grouped_mm`` over the layout's spans for each function, a
    yardstick the port never calls: name -> (fn, None), or (None, reason)
    where this torch refuses every operand layout tried."""
    gm = getattr(torch, "_grouped_mm", None)
    names = ("gmm", "gmm_dlhs", "tgmm")
    if gm is None:
        return {k: (None, "this torch has no torch._grouped_mm")
                for k in names}
    spans = ((lay.group_sizes + lay.block_m - 1) // lay.block_m).clamp_min(
        1) * lay.block_m
    offs = (lay.row_offset + spans).to(torch.int32)
    col = rhs.transpose(1, 2)                  # [E, N, K] view of rhs
    options = {
        "gmm": [(lhs, rhs), (lhs, col.contiguous().transpose(1, 2))],
        "gmm_dlhs": [(dout, col), (dout, col.contiguous())],
        "tgmm": [(lhs.t(), dout), (lhs.t().contiguous(), dout),
                 (lhs.t().contiguous(), dout.t().contiguous().t())]}
    out = {}
    for name in names:
        reasons = []
        for a, b in options[name]:
            try:
                gm(a, b, offs=offs)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError) as exc:
                reasons.append(f"{type(exc).__name__}: {str(exc)[:200]}")
                continue
            out[name] = ((lambda a=a, b=b: gm(a, b, offs=offs)), None)
            break
        else:
            out[name] = (None, " | ".join(reasons))
    return out


def _gmm_bound(flops, nbytes, dtype):
    """Least time on an H100 SXM: the larger of the FLOPs over the dtype's
    peak and the bytes (each input read once, each output written once)
    over 3.35 TB/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def phase_g(dev, flush):
    """The grouped-matmul kernels against their plain versions, case by
    case; bf16 on both routes on the same inputs, the wgmma kernels
    launched twice for bitwise equality; every kernel and the yardstick
    timed on the device alone."""
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {name: [] for name in GMM_KERNELS}
    for ci, (case, kind, n_rows, block_m, k, n, dtypes) in enumerate(
            GMM_CASES):
        sizes = _gmm_sizes(kind, n_rows)
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            tol = GMM_TOL[dtype]
            lay, lhs, rhs, dout = _gmm_inputs(dev, dtype, sizes, block_m, k,
                                              n, ci)
            # Elements each function must read: the rows that hold a token
            # (not the padding of their blocks, nor the dead blocks that
            # m_pad reserves) and the weights of the experts that have one.
            weights = sum(s > 0 for s in sizes) * k * n
            fns = {
                "gmm": (lambda route: gmm_ops.gmm_forward(
                            lhs, rhs, lay, route=route),
                        lambda: gmm_ops.gmm_reference(lhs, rhs, lay),
                        n_rows * k + weights, (lay.m_pad, n)),
                "gmm_dlhs": (
                    lambda route: gmm_ops.gmm_forward(
                        dout, rhs, lay, transpose_rhs=True, route=route),
                    lambda: gmm_ops.gmm_reference(dout, rhs, lay,
                                                  transpose_rhs=True),
                    n_rows * n + weights, (lay.m_pad, k)),
                "tgmm": (lambda route: gmm_ops.tgmm(lhs, dout, GMM_E, lay,
                                                    route=route),
                         lambda: gmm_ops.tgmm_reference(lhs, dout, GMM_E,
                                                        lay),
                         n_rows * (k + n), (GMM_E, k, n))}
            routes = ["mma"] + (["wgmma"] if gmm_ops._gmm_route(dtype)
                                == "wgmma" else [])
            library = _grouped_mm_fns(lay, lhs, rhs, dout)
            dead = ~gmm_ops.live_rows(lay)
            for fn_name, (kern, plain, reads, out_shape) in fns.items():
                want = plain()
                ref = want.float()
                rms = float(ref.square().mean().sqrt())
                lib_fn, lib_reason = library[fn_name]
                lib_err = None
                if lib_fn is not None:
                    lib_out = lib_fn().float()
                    lib_err = float(((lib_out - ref).abs() if fn_name == "tgmm"
                                     else (lib_out - ref)[~dead].abs()).max())
                    del lib_out
                nbytes = (reads + math.prod(out_shape)) * lhs.element_size()
                bound, by = _gmm_bound(2 * n_rows * k * n, nbytes, dtype)
                plain_ms = time_ms(plain, flush, 5)
                library_ms = (time_ms(lib_fn, flush, host_ahead=True)
                              if lib_fn is not None else None)
                for route in routes:
                    what = f"{fn_name} {case}/{dname} ({route} route)"
                    got = kern(route)
                    torch.cuda.synchronize()
                    check(tuple(got.shape) == out_shape
                          and got.dtype == dtype,
                          f"{what}: {got.dtype} {tuple(got.shape)}")
                    check(bool(torch.isfinite(got).all()),
                          f"{what}: non-finite output")
                    err = (got.float() - ref).abs()
                    share = float((err / (tol[0] * rms + tol[1]
                                          * ref.abs())).max())
                    check(share <= 1.0,
                          f"{what}: |kernel - plain| uses {share} of the "
                          f"limit {tol[0]} x rms + {tol[1]} x |plain|")
                    if fn_name == "tgmm":
                        empty = [e for e, s in enumerate(sizes) if s == 0]
                        zeros = all(bool((got[e] == 0).all())
                                    for e in empty)
                        check(zeros, f"{what}: an empty expert's gradient "
                              "is not 0")
                    else:
                        zeros = bool((got[dead] == 0).all())
                        check(zeros, f"{what}: rows that hold no token are "
                              "not 0")
                    same = None
                    if route == "wgmma":     # two launches, the same bits
                        same = torch.equal(got, kern(route))
                        check(same, f"{what}: two launches differ")
                    row = {"fn": fn_name, "case": case, "dtype": dname,
                           "route": route,
                           "shape": {"E": GMM_E, "rows": n_rows,
                                     "m_pad": lay.m_pad, "K": k, "N": n,
                                     "block_m": lay.block_m,
                                     "sizes": sizes},
                           "max_abs_err": float(err.max()),
                           "err_over_rms": float(err.max()) / rms,
                           "tol_share": share,
                           "tol": {"atol_rms": tol[0], "rtol": tol[1]},
                           "zeros_exact": zeros, "bitwise_repeat": same,
                           "ms": time_ms(lambda: kern(route), flush,
                                         host_ahead=True),
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           "library_max_abs_err": lib_err,
                           "bound_ms": bound, "bound_by": by}
                    if lib_reason is not None:
                        row["library_null_reason"] = lib_reason
                    del got, err
                    kernel = ("tgmm" if fn_name == "tgmm" else "gmm") + (
                        "_wgmma" if route == "wgmma" else "")
                    rows[kernel].append(row)
                    log({"phase": "G", "kernel": kernel, **row})
                del want, ref
            del lay, lhs, rhs, dout, fns, library, dead
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def _gmm_entries(rows, h_result, i_result, m_result):
    """Kernel-line entries of the grouped-matmul kernels: the
    representative case is the MoE slice's gate/up product in bf16. The
    launches are phase H's (the bf16 step: the wgmma kernels) and phase
    M's bf16 generate (its prefill), and for the kernels of gmm.cu phase
    I's kernel path and phase M's ragged generate, both f32, the paths
    that run them."""
    out = []
    for name, cases in rows.items():
        rep = next(c for c in cases if c["case"] == "slice_gate_up"
                   and c["dtype"] == "bfloat16"
                   and c["fn"] in ("gmm", "tgmm"))
        source, wrapper = GMM_KERNELS[name]
        mma = not name.endswith("_wgmma")
        by_phase = (
            {"I (f32)": i_result["kernel_path_launches"].get(name, 0),
             "M (f32)": m_result["f32"]["launches"]["ragged"].get(name, 0)}
            if mma else
            {"H": h_result["launches"].get(name, 0),
             "M": m_result["generate_launches"].get(name, 0)})
        out.append({
            "name": name, "route": "cuda",
            "source": "k8s_distributed_deeplearning_torch/csrc/" + source,
            "replaces": GMM_REPLACES[wrapper],
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            **{k: rep[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "cases": [{k: c.get(k) for k in (
                "case", "fn", "dtype", "max_abs_err", "tol_share", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for c in cases]})
    return out


# ------------------------------------------------------------- phase E/F


def _train_setup(cfg, dev, lr, chunked=True, moe_cfg=None):
    """A seeded ``LlamaLM`` (or ``MoELM`` with ``moe_cfg``), AdamW with
    global-norm clip 1.0, its state and the data-parallel train step."""
    from k8s_distributed_deeplearning_torch.models import llama, moe
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import optim

    if moe_cfg is None:
        model = llama.LlamaLM(cfg, device=dev, seed=0)

        def loss(batch, gen):
            return llama.loss_fn(model, batch, gen, chunked=chunked)
    else:
        model = moe.MoELM(cfg, moe_cfg, device=dev, seed=0)

        def loss(batch, gen):
            return moe.loss_fn(model, moe_cfg, batch, gen, chunked=chunked)

    params = dict(model.named_parameters())
    optimizer = optim.make_optimizer("adamw", lr, grad_clip=1.0)
    return model, optimizer, dp.init_state(params, optimizer), \
        dp.make_train_step(loss, optimizer)


def _kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its kernel-line name."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    return {"paged_decode_attention": paged_attn.paged_decode_attention,
            "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "gmm": gmm_ops.gmm_forward, "tgmm": gmm_ops.tgmm}


def _zero_launches() -> None:
    for w in _kernel_wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_wgmma"):
            w.launches_wgmma = 0


def _launch_counts() -> dict:
    """Every wrapper's launches by its kernel-line name; the flash and
    grouped-matmul wrappers' wgmma-route launches under their own lines."""
    wrappers = _kernel_wrappers()
    out = {n: w.launches for n, w in wrappers.items()}
    for n, w in wrappers.items():
        if hasattr(w, "launches_wgmma"):
            out[n + "_wgmma"] = w.launches_wgmma
    return out


def _train_phase(phase, dev, info, cfg, *, batch_size, seq, lr, chunked,
                 flops_tok, per_step, moe_cfg=None):
    """Phases E and H: train ``cfg`` (an ``MoELM`` with ``moe_cfg``) through
    ``make_train_step`` and ``fit``. Eight steps on one fixed batch must
    bring the loss below the margin; then a timed window of steps, with
    every kernel's launch count set to 0 before it and held exactly to
    ``per_step`` (launches a step by kernel-line name, the flash
    wrappers' wgmma-route launches under their own) after it; then one
    profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_distributed_deeplearning_torch.train import data as data_lib
    from k8s_distributed_deeplearning_torch.train import loop

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, optimizer, state, step_fn = _train_setup(
        cfg, dev, lr=lr, chunked=chunked, moe_cfg=moe_cfg)
    tokens = data_lib.synthetic_tokens(1 << 17, vocab_size=cfg.vocab_size,
                                       seed=0)
    batcher = data_lib.TokenBatcher(tokens, batch_size, seq, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.values())

    fixed = batcher.batch_at(0)
    losses = []
    for i in range(8):
        state, loss, _ = step_fn(state, fixed, i)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"non-finite loss on the fixed batch: "
          f"{losses}")
    check(losses[-1] < FIXED_BATCH_MARGIN * losses[0],
          f"8 steps on one fixed batch: loss {losses[0]} -> {losses[-1]}, "
          f"not below {FIXED_BATCH_MARGIN} x the first")
    log({"phase": phase, "case": "fixed_batch", "steps": 8, "lr": lr,
         "losses": losses, "margin": FIXED_BATCH_MARGIN})

    warm, timed = 2, 6
    state = loop.fit(step_fn, state, batcher.iter_from, state.step + warm,
                     rng=1, log_every=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    state = loop.fit(step_fn, state, batcher.iter_from, state.step + timed,
                     rng=1, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    want = {n: per_step.get(n, 0) * timed for n in launches}
    check(launches == want, f"kernel launches {launches} != {want} over "
          f"{timed} steps")
    step_ms = wall / timed * 1e3
    tok_s = timed * batch_size * seq / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # One more step: the host's time to enqueue it against its time to
    # finish; near equal means the host, not the card, sets the pace.
    t0 = time.perf_counter()
    state, loss, _ = step_fn(state, batcher.batch_at(state.step), state.step)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    host_step_ms = (time.perf_counter() - t0) * 1e3
    # The optimizer's share of the profiled step, between CUDA events.
    opt_events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    apply = optimizer.apply

    def timed_apply(*args):
        opt_events[0].record()
        out = apply(*args)
        opt_events[1].record()
        return out

    optimizer.apply = timed_apply
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, loss, _ = step_fn(state, batcher.batch_at(state.step),
                                 state.step)
        torch.cuda.synchronize()
    optimizer.apply = apply
    check(bool(torch.isfinite(loss)), "non-finite loss in the profiled step")
    kernels = _device_ms_by_kernel(prof, 1)
    device_ms = sum(k[2] for k in kernels)
    result = {
        "phase": phase, **info, "layers": cfg.n_layers,
        "params": n_params, "dtype": str(cfg.dtype).split(".")[-1],
        "param_dtype": "float32", "remat_policy": cfg.remat_policy,
        "chunked_ce": chunked, "batch": batch_size, "seq_len": seq,
        "world_size": 1, "backend": "nccl", "lr": lr, "setup_s": setup_s,
        "timed_steps": timed, "step_ms": step_ms, "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "model_flops_share": flops_tok * tok_s / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gb": peak_gb,
        "host_enqueue_ms": enqueue_ms, "host_step_ms": host_step_ms,
        "launches": {n: v for n, v in launches.items() if v},
        "launches_per_step": {n: v / timed for n, v in launches.items()
                              if v},
        "profiled_step": {
            "device_ms": device_ms,
            "device_busy_share": device_ms / step_ms,
            "kernel_launches": sum(k[1] for k in kernels),
            "device_ms_by_class": _by_class(kernels),
            "optimizer_ms": opt_events[0].elapsed_time(opt_events[1]),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": ms}
                            for n, c, ms in kernels[:10]]}}
    log(result)
    del model, optimizer, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_e(dev):
    from k8s_distributed_deeplearning_torch.models import llama

    cfg = llama.config_llama3_8b(n_layers=4, max_seq_len=2048,
                                 param_dtype=torch.float32)
    n = cfg.n_layers
    return _train_phase(
        "E", dev, {"model": "llama3-8b width"}, cfg, batch_size=4, seq=2048,
        lr=3e-4, chunked=True,
        flops_tok=llama.flops_per_token(cfg, seq_len=2048),
        # Forward 2 x layers: remat "dots" recomputes the flash forward.
        # bf16 at head_dim 128 takes the wgmma route throughout.
        per_step={"flash_fwd": 2 * n, "flash_fwd_wgmma": 2 * n,
                  "flash_bwd_dq": n, "flash_bwd_dkv": n,
                  "flash_bwd_dq_wgmma": n, "flash_bwd_dkv_wgmma": n})


def phase_h(dev):
    from k8s_distributed_deeplearning_torch.models import llama, moe

    seq = 1024
    cfg = llama.config_tiny(**MOE_BACKBONE, max_seq_len=seq,
                            dtype=torch.bfloat16, param_dtype=torch.float32,
                            remat=True, remat_policy="dots")
    mcfg = moe.MoEConfig(num_experts=8, top_k=2, dispatch="ragged")
    n = cfg.n_layers
    return _train_phase(
        "H", dev, {"model": "llama-small MoE 8e top-2 ragged",
                   "experts": mcfg.num_experts, "top_k": mcfg.top_k,
                   "dispatch": mcfg.dispatch,
                   "ragged_block_m": mcfg.ragged_block_m},
        cfg, batch_size=8, seq=seq, lr=1e-3, chunked=False,
        flops_tok=moe.flops_per_token(cfg, mcfg, seq_len=seq),
        # Under remat "dots" the gmm outputs are saved, not recomputed:
        # 3 forward products and 3 input gradients a layer, 3 weight
        # gradients, all bf16 on the wgmma route; the flash forward runs
        # again in the recompute.
        per_step={"gmm": 6 * n, "tgmm": 3 * n, "gmm_wgmma": 6 * n,
                  "tgmm_wgmma": 3 * n, "flash_fwd": 2 * n,
                  "flash_fwd_wgmma": 2 * n,
                  "flash_bwd_dq": n, "flash_bwd_dkv": n,
                  "flash_bwd_dq_wgmma": n, "flash_bwd_dkv_wgmma": n},
        moe_cfg=mcfg)


def _agreement_run(cfg, dev, lr, batcher, steps, keep_on, moe_cfg=None):
    """One path of phases F and I: ``steps`` AdamW steps in f32 from the
    seeded weights. Returns the losses, and on ``keep_on`` the initial
    weights, the first step's gradients, and the parameters and Adam
    moments after the steps."""
    _, optimizer, state, step_fn = _train_setup(cfg, dev, lr=lr,
                                                moe_cfg=moe_cfg)
    init = {n: p.detach().to(keep_on, copy=True)
            for n, p in state.params.items()}
    first_grads, apply = {}, optimizer.apply

    def keep_first(params, grads, opt_state):
        if not first_grads:
            first_grads.update({n: g.to(keep_on, copy=True)
                                for n, g in grads.items()})
        return apply(params, grads, opt_state)

    optimizer.apply = keep_first
    losses = []
    for i in range(steps):
        state, loss, _ = step_fn(state, batcher.batch_at(i), i)
        losses.append(float(loss))
    return {"losses": losses, "init": init, "grads": first_grads,
            "params": {n: p.detach().to(keep_on)
                       for n, p in state.params.items()},
            **{k: {n: t.to(keep_on) for n, t in state.opt_state[k].items()}
               for k in ("mu", "nu")}}


def phase_f(dev):
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, batch_size, seq = 1e-4, 3, 2, 1024
    tokens = data_lib.synthetic_tokens(1 << 15, vocab_size=128256, seed=3)
    batcher = data_lib.TokenBatcher(tokens, batch_size, seq, seed=3)

    def run(impl, keep_on):
        cfg = llama.config_llama3_8b(n_layers=2, max_seq_len=seq,
                                     dtype=torch.float32,
                                     param_dtype=torch.float32,
                                     attention_impl=impl)
        return _agreement_run(cfg, dev, lr, batcher, steps, keep_on)

    # The kernel path's record waits in host memory while the plain path
    # runs: two runs' weights, gradients and moments do not fit the card.
    _zero_launches()
    ka = run("auto", torch.device("cpu"))
    launches = _launch_counts()
    # f32 keeps the forward and the backward on the mma.sync kernels,
    # never wgmma.
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 2 * steps
          and launches["flash_fwd"] >= 2 * steps
          and launches["flash_bwd_dq_wgmma"] == 0
          and launches["flash_bwd_dkv_wgmma"] == 0
          and launches["flash_fwd_wgmma"] == 0,
          f"phase F (f32) flash launches {launches}: want 2 backward a "
          f"step and at least as many forward on the mma route, none on "
          f"the wgmma route")
    gc.collect()
    torch.cuda.empty_cache()
    kx = run("xla", dev)
    return _agreement("F", {"model": "llama3-8b width, 2 layers",
                            "batch": batch_size, "seq_len": seq,
                            "steps": steps, "lr": lr,
                            "kernel_path_launches": {
                                n: c for n, c in launches.items() if c}},
                      ka, kx, dev)


def phase_f_bf16(dev):
    """Phase F's model and first batch in bf16 compute (f32 params): one
    step's gradients through the flash kernels on the wgmma route and on
    the mma route (forced), each held per parameter tensor to the f32
    plain path's (``attention_impl="xla"``), from the same weights."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch_size, seq = 2, 1024
    tokens = data_lib.synthetic_tokens(1 << 15, vocab_size=128256, seed=3)
    batch = data_lib.TokenBatcher(tokens, batch_size, seq, seed=3).batch_at(0)

    def model_of(dtype, impl):
        cfg = llama.config_llama3_8b(n_layers=2, max_seq_len=seq,
                                     dtype=dtype, param_dtype=torch.float32,
                                     attention_impl=impl)
        return llama.LlamaLM(cfg, device=dev, seed=0)

    def grads(model):
        params = dict(model.named_parameters())
        loss, _ = llama.loss_fn(model, dp.to_device(batch, dev), chunked=True)
        return float(loss.detach()), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    plain = model_of(torch.float32, "xla")
    loss_ref, ref = grads(plain)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    model = model_of(torch.bfloat16, "auto")
    errs, losses, launches = {}, {}, {}
    route_of = fa._bwd_route
    try:
        for route in ("wgmma", "mma"):
            fa._bwd_route = lambda dtype, head_dim, r=route: r
            _zero_launches()
            losses[route], g = grads(model)
            launches[route] = {n: c for n, c in _launch_counts().items() if c}
            errs[route] = {n: float((g[n] - ref[n]).double().norm()
                                    / ref[n].double().norm()) for n in ref}
            del g
    finally:
        fa._bwd_route = route_of
    worst = {n: errs["wgmma"][n] / (BF16_STEP_RATIO * errs["mma"][n]
                                    + BF16_STEP_FLOOR) for n in ref}
    result = {"phase": "F", "case": "bf16_step_routes",
              "model": "llama3-8b width, 2 layers", "batch": batch_size,
              "seq_len": seq, "loss_f32_plain": loss_ref,
              "loss_bf16": losses, "launches": launches,
              "grad_rel_l2_vs_f32_plain": errs,
              "ratio": BF16_STEP_RATIO, "floor": BF16_STEP_FLOOR,
              "worst_share": max(worst.values()),
              "worst_param": max(worst, key=worst.get)}
    log(result)
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    check(launches["wgmma"].get("flash_bwd_dq_wgmma") == 2
          and launches["wgmma"].get("flash_bwd_dkv_wgmma") == 2
          and "flash_bwd_dq_wgmma" not in launches["mma"]
          and launches["mma"].get("flash_bwd_dq") == 2,
          f"bf16 step launches by route: {launches}")
    name = result["worst_param"]
    check(max(worst.values()) <= 1.0,
          f"bf16 step: {name}'s gradient on the wgmma route is further from "
          f"the f32 plain path than {BF16_STEP_RATIO} x the mma route's + "
          f"{BF16_STEP_FLOOR}: {errs['wgmma'][name]} against "
          f"{errs['mma'][name]}")
    return result


def phase_i(dev):
    from k8s_distributed_deeplearning_torch.models import llama, moe
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, batch_size, seq = 1e-4, 3, 2, 1024
    tokens = data_lib.synthetic_tokens(
        1 << 15, vocab_size=MOE_BACKBONE["vocab_size"], seed=4)
    batcher = data_lib.TokenBatcher(tokens, batch_size, seq, seed=4)
    ragged = moe.MoEConfig(num_experts=8, top_k=2, dispatch="ragged")
    # capacity_factor E / k makes the capacity every token (clamped to T):
    # the index path then drops nothing and routes as the ragged one.
    index = moe.MoEConfig(num_experts=8, top_k=2, dispatch="index",
                          capacity_factor=8 / 2)

    def run(impl, mcfg, keep_on):
        cfg = llama.config_tiny(**{**MOE_BACKBONE, "n_layers": 2},
                                max_seq_len=seq, dtype=torch.float32,
                                param_dtype=torch.float32, remat=True,
                                attention_impl=impl)
        _zero_launches()
        out = _agreement_run(cfg, dev, lr, batcher, steps, keep_on,
                             moe_cfg=mcfg)
        return out, _launch_counts()

    ka, kernel_launches = run("auto", ragged, torch.device("cpu"))
    gc.collect()
    torch.cuda.empty_cache()
    kx, plain_launches = run("xla", index, dev)
    check(kernel_launches["gmm"] > 0 and kernel_launches["tgmm"] > 0
          and kernel_launches["flash_fwd"] > 0
          and kernel_launches["gmm_wgmma"] == 0
          and kernel_launches["tgmm_wgmma"] == 0,
          f"phase I kernel path (f32: the gmm.cu kernels) launched "
          f"{kernel_launches}")
    check(not any(plain_launches.values()),
          f"phase I plain path launched kernels: {plain_launches}")
    return _agreement("I", {"model": "llama-small MoE width, 2 layers",
                            "kernel_path": "ragged + flash",
                            "plain_path": "index at capacity T + einsum",
                            "kernel_path_launches": kernel_launches,
                            "batch": batch_size, "seq_len": seq,
                            "steps": steps, "lr": lr}, ka, kx, dev)


def _agreement(phase, info, ka, kx, dev):
    """Phases F and I: the kernel path's run ``ka`` (held on the host)
    against the plain path's ``kx``: losses, then per parameter tensor the
    first step's gradient and the parameters after the steps."""
    steps = info["steps"]
    la, lx = ka["losses"], kx["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(la, lx))

    def l2(x):
        return float(x.double().square().sum().sqrt())

    # Per parameter tensor, so that a fault confined to the attention
    # projections cannot hide behind the 1.05 B embedding and head values.
    grad_rel, param_rel, name, idx, worst_diff = {}, {}, None, 0, -1.0
    for n, px in kx["params"].items():
        gx = kx["grads"][n]
        grad_rel[n] = l2(ka["grads"][n].to(dev) - gx) / l2(gx)
        diff = ka["params"][n].to(dev) - px
        param_rel[n] = l2(diff) / l2(px - kx["init"][n])
        if float(diff.abs().max()) > worst_diff:
            worst_diff = float(diff.abs().max())
            name, idx = n, int(diff.abs().argmax())
        del diff

    # The element whose parameter differs most, with what Adam saw there.
    def at(t):
        return float(t.reshape(-1)[idx])

    fields = ("params", "grads", "mu", "nu")
    worst = {"param": name, "index": idx, "abs_diff": worst_diff,
             "init": at(kx["init"][name]),
             "kernel": {k: at(ka[k][name]) for k in fields},
             "plain": {k: at(kx[k][name]) for k in fields},
             "leaf_grad_rms": l2(kx["grads"][name])
             / math.sqrt(kx["grads"][name].numel()), "adam_eps": 1e-8}
    result = {"phase": phase, **info, "dtype": "float32", "tf32": False,
              "losses_kernel": la, "losses_plain": lx,
              "loss_max_rel_diff": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
              "grad_rel_diff_worst": max(grad_rel.values()),
              "grad_rel_diff_worst_param": max(grad_rel, key=grad_rel.get),
              "grad_rtol": TRAIN_GRAD_TOL,
              "param_rel_diff_worst": max(param_rel.values()),
              "param_rel_diff_worst_param": max(param_rel,
                                                key=param_rel.get),
              "param_rtol": TRAIN_PARAM_TOL,
              "grad_rel_diff": grad_rel, "param_rel_diff": param_rel,
              "max_abs_diff_element": worst}
    log(result)
    del ka, kx
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(la + lx)), f"non-finite loss in phase {phase}")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"kernel-path and plain-path losses differ by {loss_rel}")
    check(max(grad_rel.values()) <= TRAIN_GRAD_TOL,
          f"first-step gradients: worst parameter "
          f"{result['grad_rel_diff_worst_param']} differs by "
          f"{max(grad_rel.values())} > {TRAIN_GRAD_TOL} of its L2 norm")
    check(max(param_rel.values()) <= TRAIN_PARAM_TOL,
          f"params after {steps} steps: worst parameter "
          f"{result['param_rel_diff_worst_param']} differs by "
          f"{max(param_rel.values())} > {TRAIN_PARAM_TOL} x its change")
    return result


def _paged_entries(fp_cases, b_result, c_result, int8_cases, j_result,
                   k_result):
    """Kernel-line entries of the paged kernels, by route and branch. The
    decode kernel's representative case is decode in bf16, the prefill
    kernel's 512 queries at offset 1024 in bf16, with the launches of
    phases B (fp) and J (int8) on each route; the split kernel's is decode
    in f32, with the launches of the f32 kernel paths of phases C (fp) and
    K (int8), the paths that run it."""
    out = []
    keys = ("case", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("split_ms", "split_max_abs_err", "split_tol_share",
             "repeat_bitwise", "ms_tile64", "ms_tile128")
    for name, route, source, rep_case, rep_dtype in (
            ("paged_decode", "decode", "paged_decode.cu", "decode",
             "bfloat16"),
            ("paged_prefill_attention", "prefill", "paged_prefill.cu",
             "prefill512", "bfloat16"),
            ("paged_attn_split", "split", "paged_attn.cu", "decode",
             "float32")):
        for branch, cases, served, f32_path in (
                ("fp", fp_cases, b_result, c_result),
                ("quant=True", int8_cases, j_result, k_result)):
            mine = [c for c in cases if c["route"] == route]
            rep = next(c for c in mine
                       if c["case"] == rep_case and c["dtype"] == rep_dtype)
            if route == "split":
                launched = f32_path["launches"]["auto"][
                    "fp" if branch == "fp" else "int8"]
                where = f"{f32_path['phase']} (f32 kernel path)"
            else:
                launched = served["route_launches"][route]
                where = served["phase"]
            out.append({
                "name": name + ("_int8" if branch != "fp" else ""),
                "route": "cuda",
                "source": "k8s_distributed_deeplearning_torch/csrc/" + source,
                "replaces": PAGED_REPLACES, "branch": branch,
                "launches": launched, "launches_in": where,
                **{k: rep[k] for k in keys[2:]},
                "cases": [{k: c[k] for k in keys + extra + ("tol_share",)
                           if k in c} for c in mine]})
    return out


def _flash_entries(rows, e_result, f_result):
    """Kernel-line entries of the flash kernels: the representative case
    is the training path's (causal, bf16). The launches are phase E's (the
    bf16 step: the wgmma kernels), and for the mma kernels phase F's
    kernel path (f32), the path that runs them."""
    out = []
    for name, cases in rows.items():
        rep = next(c for c in cases
                   if c["case"] == "causal" and c["dtype"] == "bfloat16")
        source, wrapper = FLASH_KERNELS[name]
        mma = not name.endswith("_wgmma")
        launched = (f_result["kernel_path_launches"] if mma
                    else e_result["launches"])
        out.append({
            "name": name, "route": "cuda",
            "source": "k8s_distributed_deeplearning_torch/csrc/" + source,
            "replaces": FLASH_REPLACES[wrapper],
            "launches": launched.get(name, 0),
            "launches_in": "F (f32)" if mma else "E",
            **{k: rep[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "cases": [{k: c[k] for k in ("case", "dtype", "max_abs_err",
                                          "tol_share", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")} for c in cases]})
    return out


def _entry_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol: the
    length-prefixed name ending in ``kernel`` or ``wgmma`` (a length may
    follow hex digits of the namespace's hash, so every suffix of a digit
    run is tried)."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            end = run.end() + int(mangled[i:run.end()])
            name = mangled[run.end():end]
            if re.fullmatch(r"[a-z_]+(?:kernel|wgmma)", name) and \
                    mangled[end:end + 1] in ("I", "E"):
                args = re.match(r"(I\w*?)EvP", mangled[end:])
                return name + (args.group(1) if args else "")
    return mangled


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from k8s_distributed_deeplearning_torch.ops import _build
    from k8s_distributed_deeplearning_torch.parallel import distributed

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log({"build_s": time.perf_counter() - t0,
         "kernels": sorted(libs)})
    for lib in libs.values():
        entry = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = _entry_name(found.group(1))
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib.stem} {entry}: {line.strip()}")
    started = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        log({"phase_done": name, "s": time.perf_counter() - t,
             "since_start_s": time.perf_counter() - started})
        return out

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    cases = timed("A", phase_a, dev, flush)
    int8_cases = timed("A_int8", phase_a_int8, dev, flush)
    b, b_streams = timed("B", phase_b, dev)
    j = timed("J", phase_j, dev, b_streams)
    c = timed("C", phase_c, dev)
    k = timed("K", phase_k, dev)
    timed("L", phase_l, dev)
    flash_rows = timed("D", phase_d, dev, flush)
    gmm_rows = timed("G", phase_g, dev, flush)
    m = timed("M", phase_m, dev)
    del flush
    distributed.initialize_single("cuda")
    try:
        e = timed("E", phase_e, dev)
        f = timed("F", phase_f, dev)
        timed("F_bf16", phase_f_bf16, dev)
        h = timed("H", phase_h, dev)
        i = timed("I", phase_i, dev)
    finally:
        distributed.shutdown()
    log({"kernels": _paged_entries(cases, b, c, int8_cases, j, k)
         + _flash_entries(flash_rows, e, f)
         + _gmm_entries(gmm_rows, h, i, m)})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
