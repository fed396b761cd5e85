#!/usr/bin/env python3
"""Where a tile's time goes in a tensor-core kernel of the port.

    python3 kernel_breakdown.py prefill      # csrc/paged_prefill.cu
    python3 kernel_breakdown.py flash_bwd    # csrc/flash_bwd.cu

Needs one NVIDIA Hopper GPU and nvcc. Builds the kernel's source as it is
and in variants that each leave one stage of its tile loop out (the
numbers they produce are wrong on purpose; only their times count), one
nvcc each, all started together, then times every launch of each variant
at the kernel's case in two interleaved rounds with a cold L2. A stage's
cost is the base time less the variant's. Prints the card's name and
power limit, each variant's ptxas register counts (a variant whose count
collapses has lost more than its stage), then one JSON line per (round,
variant, launch).

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


Launches = dict[str, Callable[[ctypes.CDLL], int]]


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

    return {"fp": launch(pools[0], pools[1], None, None),
            "int8": launch(quant[0][0].view(pools[0].shape),
                           quant[1][0].view(pools[1].shape), quant[0][1],
                           quant[1][1])}


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
    return {"dq": lambda lib: lib.flash_bwd_dq_wgmma(
                *head, dq.data_ptr(), *tail),
            "dkv": lambda lib: lib.flash_bwd_dkv_wgmma(
                *head, dk.data_ptr(), dv.data_ptr(), *tail)}


class Kernel(NamedTuple):
    source: str
    variants: dict[str, list[tuple[str, str, int]]]
    bind: Callable[[ctypes.CDLL], None]
    case: Callable[[torch.device, int], Launches]


KERNELS = {
    "prefill": Kernel("paged_prefill.cu", PREFILL_VARIANTS, bind_prefill,
                      prefill_case),
    "flash_bwd": Kernel("flash_bwd.cu", FLASH_BWD_VARIANTS, bind_flash_bwd,
                        flash_bwd_case),
}


def build(kernel: Kernel, out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every variant, one nvcc each, all started together."""
    from k8s_distributed_deeplearning_torch.ops import _build

    src = (_build.CSRC_DIR / kernel.source).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in kernel.variants.items():
        text = src
        for old, new, count in subs:
            if text.count(old) != count:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old!r} {count} time(s)")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
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
    if len(argv) != 1 or argv[0] not in KERNELS:
        print(f"usage: kernel_breakdown.py {{{','.join(KERNELS)}}}",
              file=sys.stderr)
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
    libs = build(kernel, _build.BUILD_DIR / f"breakdown_{argv[0]}")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    launches = kernel.case(dev, stream)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def run(fn, lib):
        rc = fn(lib)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

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
            for label, fn in launches.items():
                print(json.dumps({
                    "round": rnd, "variant": name, "launch": label,
                    "ms": time_ms(fn, lib)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
