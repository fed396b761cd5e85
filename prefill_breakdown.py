#!/usr/bin/env python3
"""Where a tile's time goes in the tensor-core paged prefill kernel.

    python3 prefill_breakdown.py

Needs one NVIDIA Hopper GPU and nvcc. Builds ``csrc/paged_prefill.cu`` as
it is and in variants that each leave one stage of the key-tile loop out
(the numbers they produce are wrong on purpose; only their times count),
then times each on Llama-3 8B's heads (32 q, 8 KV, head_dim 128, 32-token
pages) for a 512-query chunk at offset 1024, fp and int8 pools, 128-row
tiles, in two interleaved rounds with a cold L2. A stage's cost is the
base time less the variant's. Prints the card's name and power limit,
then one JSON line per (round, variant, branch).

Variants: ``no_exp`` (p = x, no exponentials), ``no_pv`` (no P.V
products), ``no_s`` (no S products), ``no_loads`` (no copies after the
first tiles), ``no_rescale`` (O is not rescaled), ``no_convert`` (int8: no
int8-to-bf16 pass).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
VARIANTS = {
    "base": [],
    "no_exp": [("float p = ex2(x - ((i & 2) ? mn1 : mn0));",
                "float p = x;")],
    "no_pv": [("    issue_pv(t ? v_prev : v_addr);\n", "")],
    "no_s": [("for (int kk = 0; kk < HD / 16; ++kk)\n      wgmma_ss_n64(",
              "for (int kk = 0; kk < 0; ++kk)\n      wgmma_ss_n64(")],
    "no_loads": [("if (t + DIST < n_tiles) issue(t + DIST, "
                  "(t + DIST) % STAGES);", "")],
    "no_rescale": [("for (int i = 0; i < HD / 2; ++i) o[i] *= ",
                    "for (int i = 0; i < 0; ++i) o[i] *= ")],
    "no_convert": [("for (int k = 0; k < 2 * KT / JC; ++k)",
                    "for (int k = 0; k < 0; ++k)")],
}
H, KV, HD, PAGE, N_BLOCKS, OFFSET, SQ = 32, 8, 128, 32, 64, 1024, 512


def build(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every variant, one nvcc each, all started together."""
    from k8s_distributed_deeplearning_torch.ops import _build

    src = (_build.CSRC_DIR / "paged_prefill.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old!r} once")
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
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.paged_prefill_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.paged_prefill_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_breakdown: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)
    from k8s_distributed_deeplearning_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    libs = build(_build.BUILD_DIR / "prefill_breakdown")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, SQ, H, HD, device=dev, generator=gen).bfloat16()
    pools = [torch.randn(64, PAGE, KV * HD, device=dev,
                         generator=gen).bfloat16() for _ in range(2)]
    tables = torch.zeros(1, N_BLOCKS, dtype=torch.int32, device=dev)
    tables[0, :48] = torch.randperm(63, device=dev, generator=gen)[:48] + 1
    pos = (OFFSET + torch.arange(SQ, device=dev, dtype=torch.int32))[None]
    quant = [quantize_kv(p.float().view(64, PAGE, KV, HD)) for p in pools]
    args = {"fp": (pools[0], pools[1], None, None),
            "int8": (quant[0][0].view(pools[0].shape),
                     quant[1][0].view(pools[1].shape), quant[0][1],
                     quant[1][1])}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)

    def launch(lib, branch):
        pk, pv, ks, vs = args[branch]
        rc = lib.paged_prefill_fwd(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), 1, SQ, H, KV, HD, PAGE,
            N_BLOCKS, 1, HD ** -0.5, 128, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def time_ms(fn, iters=30):
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
        return float(np.median([s.elapsed_time(e)
                                for s, e in zip(starts, ends)]))

    for rnd in range(2):
        for name, lib in libs.items():
            for branch in ("fp", "int8"):
                print(json.dumps({
                    "round": rnd, "variant": name, "branch": branch,
                    "ms": time_ms(lambda: launch(lib, branch))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
