#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from ``csrc/`` with nvcc,
then runs three phases; any failure exits non-zero.

A. Each kernel against its plain PyTorch version on the card, at the
   Llama-3 8B attention shapes (32 q heads, 8 KV heads, head_dim 128,
   32-token pages), in bf16 and f32: decode (B=4, one query each, live
   lengths 100-2000), a 512-query prefill chunk at an offset, stale K/V
   past the cursor, and scratch-page garbage. Reports the error, the
   kernel's time, the plain version's, the bound (the larger of bytes over
   3.35 TB/s and FLOPs over the dtype's peak), and the time of
   ``scaled_dot_product_attention`` on the pre-gathered K/V with the
   boolean mask as a yardstick (the port never calls it).
B. The port's ``ServeEngine`` at full Llama-3 8B width and depth (bf16,
   random weights from a seed): 4 slots, 512-token prefill chunks, 8
   requests of 100-1500 prompt tokens and 32 new tokens (6 greedy, 2
   sampled). Every request finishes with in-vocabulary tokens, no pool
   page leaks, and the kernel launches exactly n_layers x (decode
   iterations + prefill chunks) times. Reports prefill and decode tokens/s,
   TTFT p50 and peak device memory; then, with every slot busy, a decode
   iteration's host time and its device time by kernel (``torch.profiler``).
C. The same workload in f32 at 8B width and 4 layers, greedy, through the
   kernel path and through the plain path (``attention_impl="xla"``):
   the first 16 tokens of every request agree.

Prints the card's name and power limit, the build time, one JSON line per
phase, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
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
H, KV, HD, PAGE = 32, 8, 128, 32


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each with a
    cold L2 (a 256 MB buffer is rewritten before every launch)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
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
    q, pk, _, tables, pos = args
    item = q.element_size()
    live = (pos.max(dim=1).values.long() + 1).clamp_max(
        tables.shape[1] * PAGE)
    nbytes = (2 * int(live.sum()) * KV * HD * item      # K and V, once
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


def phase_a(dev, flush):
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    kern = paged_attn.paged_decode_attention
    plain = paged_attn.paged_decode_attention_reference
    decode_lens = rng.integers(100, 2001, 4)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        shapes = {"decode": (decode_lens, 1, 64, 4 * 64 + 1),
                  "prefill512": ([1024 + 512], 512, 64, 64)}
        for name, (lens, sq, nb, pages) in shapes.items():
            args = _attn_case(rng, dev, dtype, lens, sq, nb, pages)
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(out).all()), f"{name}/{dname}: nan")
            check(err <= TOL[dtype],
                  f"{name}/{dname}: max err {err} > {TOL[dtype]}")
            bound, by = _bound(args, dtype)
            cases.append({
                "case": name, "dtype": dname, "shape": {
                    "B": len(lens), "sq": sq, "H": H, "kv": KV, "hd": HD,
                    "page_tokens": PAGE, "n_blocks": nb,
                    "live": [int(n) for n in lens]},
                "max_abs_err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: kern(*args), flush),
                "plain_ms": time_ms(lambda: plain(*args), flush),
                "library_ms": time_ms(_sdpa_fn(args), flush),
                "bound_ms": bound, "bound_by": by})
            log({"phase": "A", **cases[-1]})
        # Stale K/V past each cursor and garbage in the scratch page (the
        # blocks past the live length map to it) change no output bit.
        q, pk, pv, tables, pos = _attn_case(rng, dev, dtype, decode_lens, 1,
                                            64, 4 * 64 + 1)
        base = kern(q, pk, pv, tables, pos)
        pk2, pv2 = pk.clone(), pv.clone()
        for i, n in enumerate(decode_lens):
            last = int(tables[i, (int(n) - 1) // PAGE])
            pk2[last, (int(n) - 1) % PAGE + 1:] = 1e4
            pv2[last, (int(n) - 1) % PAGE + 1:] = -1e4
        pk2[0], pv2[0] = 1e4, -1e4
        same = torch.equal(kern(q, pk2, pv2, tables, pos), base)
        check(same, f"stale/scratch K/V changed the output ({dname})")
        err = float((base.float() - plain(q, pk2, pv2, tables, pos)
                     .float()).abs().max())
        check(err <= TOL[dtype], f"stale/scratch vs plain: {err}")
        log({"phase": "A", "case": "stale_kv+scratch_page", "dtype": dname,
             "bitwise_unchanged": same, "max_abs_err": err})
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


def phase_b(dev):
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    cfg = llama.config_llama3_8b(max_seq_len=2048)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    acc = {"_prefill": 0.0, "_decode_step": 0.0}
    for name in acc:
        _timed(eng, name, acc)
    reqs = _requests(cfg.vocab_size, 32, sampled=True)
    free0 = eng.pool.available()
    paged_attn.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attn.paged_decode_attention.launches
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
    check(launches == want,
          f"kernel launches {launches} != n_layers x (decode iterations "
          f"{summ['decode_steps']} + prefill chunks {chunks}) = {want}")
    result = {
        "phase": "B", "model": "llama3-8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", "slots": 4, "prefill_chunk_tokens": 512,
        "requests": 8, "prompt_tokens": summ["prompt_tokens"],
        "new_tokens": sum(len(o.tokens) for o in outs),
        "decode_iterations": summ["decode_steps"], "prefill_chunks": chunks,
        "kernel_launches": launches,
        "prefill_tokens_per_s": summ["prompt_tokens"] / acc["_prefill"],
        "decode_tokens_per_s": eng.stats.decode_tokens / acc["_decode_step"],
        "prefill_s": acc["_prefill"], "decode_s": acc["_decode_step"],
        "decode_iteration_ms": acc["_decode_step"] / summ["decode_steps"] * 1e3,
        "prefill_chunk_ms": acc["_prefill"] / chunks * 1e3,
        "wall_s": wall, "setup_s": setup_s,
        "ttft_p50_ms": summ["ttft_p50_ms"],
        "latency_p50_ms": summ["latency_p50_ms"],
        "mean_slot_occupancy": summ["mean_slot_occupancy"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(result)
    decode_profile(eng, cfg.vocab_size)
    return result


def _kernel_class(name: str) -> str:
    if "paged_attn" in name:
        return "paged_attn"
    if any(s in name for s in ("gemm", "gemv", "cutlass", "nvjet", "sm90")):
        return "matmul"
    return "other"


def decode_profile(eng, vocab, steps: int = 16):
    """Where a decode iteration's time goes, with every slot busy: the host
    clock over ``steps`` iterations, then device time by kernel over
    ``steps`` more under ``torch.profiler``. The busy share divides the
    profiled device time by the unprofiled host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_distributed_deeplearning_torch.serve import Request

    rng = np.random.default_rng(2)
    for i in range(eng.num_slots):
        eng.submit(Request(prompt=rng.integers(0, vocab, 512).astype(np.int32),
                           max_new_tokens=3 * steps,
                           request_id=f"p{i}"))
    while eng.occupied_slots() < eng.num_slots:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    check(eng.occupied_slots() == eng.num_slots,
          "a slot emptied inside the profiled decode window")
    eng.run()
    kernels = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append((e.key, e.count, us / 1e3 / steps))
    kernels.sort(key=lambda k: -k[2])
    device_ms = sum(k[2] for k in kernels)
    by_class: dict[str, float] = {}
    for name, _, ms in kernels:
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name),
                                                     0.0) + ms
    log({"phase": "B", "case": "decode_profile", "slots": eng.num_slots,
         "steps": steps, "step_ms": step_ms,
         "device_ms_per_step": device_ms,
         "device_busy_share": device_ms / step_ms,
         "device_ms_per_step_by_class": by_class,
         "launches_per_step": sum(k[1] for k in kernels) / steps,
         "top_kernels": [{"name": n[:90], "launches_per_step": c / steps,
                          "ms_per_step": ms} for n, c, ms in kernels[:8]]})


def phase_c(dev):
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    streams = {}
    for impl in ("auto", "xla"):
        cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                     dtype=torch.float32,
                                     attention_impl=impl)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                          device=dev)
        outs = eng.run(_requests(cfg.vocab_size, 16, sampled=False))
        streams[impl] = {o.request_id: o.tokens for o in outs}
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    agree = {rid: streams["auto"][rid] == streams["xla"][rid]
             for rid in sorted(streams["auto"])}
    result = {"phase": "C", "model": "llama3-8b width, 4 layers",
              "dtype": "float32", "requests": len(agree),
              "tokens_compared": 16, "streams_agree": agree}
    log(result)
    check(len(agree) == 8 and all(agree.values()),
          "kernel-path and plain-path greedy streams differ")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from k8s_distributed_deeplearning_torch.ops import _build

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
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib.stem}: {line.strip()}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    cases = phase_a(dev, flush)
    del flush
    b = phase_b(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_c(dev)
    rep = next(c for c in cases
               if c["case"] == "decode" and c["dtype"] == "bfloat16")
    log({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "k8s_distributed_deeplearning_torch/csrc/paged_attn.cu",
        "replaces": "k8s_distributed_deeplearning_tpu/ops/"
                    "pallas_paged_attn.py:66",
        "launches": b["kernel_launches"],
        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
        "cases": [{k: c[k] for k in ("case", "dtype", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")} for c in cases]}]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
