"""Serving CLI: a synthetic workload through :class:`serve.engine.ServeEngine`.

Port of the single-engine path of ``k8s_distributed_deeplearning_tpu/
serve/cli.py``::

    python -m k8s_distributed_deeplearning_torch.serve --preset tiny \\
        --slots 4 --requests 16 --device cuda

Emits one ``serve_request`` JSON line per finished request and a final
``serve_summary`` line with the JAX CLI's serving fields (and, with
``--kv-quant``/``--weight-quant``, a ``quant_summary`` line before it).
Weights are random, drawn from ``--seed``, as in the JAX CLI's presets.
Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m k8s_distributed_deeplearning_torch.serve",
        description="Continuous-batching serving demo on the PyTorch port")
    ap.add_argument("--preset", choices=["tiny", "small"], default="tiny",
                    help="tiny: the test topology in f32; small: 12 layers "
                         "of width 768 in bf16")
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission queue bound (default: --requests)")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(32, 128),
                    metavar=("LO", "HI"))
    ap.add_argument("--out-len", type=int, nargs=2, default=(16, 64),
                    metavar=("LO", "HI"))
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="usable KV pages (0 = num_slots * max_blocks)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="per-iteration prefill token budget (0 = off)")
    ap.add_argument("--kv-quant", choices=["int8"],
                    default=os.environ.get("TPUJOB_KV_QUANT") or None,
                    help="int8 KV pool pages with per-token-per-head f32 "
                         "scales, dequantized inside the paged-attention "
                         "kernel. Defaults from $TPUJOB_KV_QUANT")
    ap.add_argument("--weight-quant", choices=["int8"],
                    default=os.environ.get("TPUJOB_WEIGHT_QUANT") or None,
                    help="per-output-channel int8 matmul weights, "
                         "dequantized at use (embeddings, norms and the LM "
                         "head stay fp). Defaults from $TPUJOB_WEIGHT_QUANT")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-path", default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    p_lo, p_hi = args.prompt_len
    o_lo, o_hi = args.out_len
    if p_hi + o_hi > args.max_seq_len:
        ap.error(f"prompt-len hi ({p_hi}) + out-len hi ({o_hi}) exceeds "
                 f"--max-seq-len ({args.max_seq_len})")

    import numpy as np
    import torch

    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          SamplingParams,
                                                          ServeEngine)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger, ServingStats)

    if args.preset == "small":
        cfg = llama.config_tiny(
            vocab_size=32000, dim=768, n_layers=12, n_heads=12, n_kv_heads=4,
            mlp_dim=2048, max_seq_len=args.max_seq_len, dtype=torch.bfloat16)
    else:
        cfg = llama.config_tiny(max_seq_len=args.max_seq_len,
                                dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=args.device, seed=args.seed)
    stats = ServingStats()
    engine = ServeEngine(
        model, num_slots=args.slots,
        max_queue=args.max_queue or args.requests, eos_id=args.eos_id,
        prefill_chunk_tokens=args.prefill_chunk_tokens or None,
        kv_pool_pages=args.kv_pool_pages or None, stats=stats,
        device=args.device, kv_quant=args.kv_quant,
        weight_quant=args.weight_quant)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(p_lo, p_hi + 1)))
        reqs.append(Request(prompt=prompt.astype(np.int32),
                            max_new_tokens=int(rng.integers(o_lo, o_hi + 1)),
                            sampling=sampling, seed=args.seed + i))
    logger = MetricsLogger(job="serve", path=args.metrics_path)
    for out in engine.run(reqs):
        logger.emit("serve_request", request_id=out.request_id,
                    prompt_len=out.prompt_len, new_tokens=len(out.tokens),
                    finish_reason=out.finish_reason,
                    cached_prompt_tokens=out.cached_prompt_tokens,
                    queue_ms=round(out.queue_s * 1e3, 3),
                    ttft_ms=(round(out.ttft_s * 1e3, 3)
                             if out.ttft_s is not None else None),
                    latency_ms=round(out.latency_s * 1e3, 3))
    summ = stats.summary()
    if args.kv_quant or args.weight_quant:
        logger.emit("quant_summary", kv_quant=args.kv_quant,
                    weight_quant=args.weight_quant,
                    kv_quant_bytes_saved=summ["kv_quant_bytes_saved"],
                    weight_quant_bytes_saved=summ["weight_quant_bytes_saved"])
    logger.emit("serve_summary", num_slots=args.slots, preset=args.preset,
                replicas=1, device=str(engine.device), **summ)
    logger.close()
    return 0
