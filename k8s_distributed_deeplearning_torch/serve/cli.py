"""Serving CLI: a synthetic workload through :class:`serve.engine.ServeEngine`.

Port of the single-engine path of ``k8s_distributed_deeplearning_tpu/
serve/cli.py``::

    python -m k8s_distributed_deeplearning_torch.serve --preset tiny \\
        --slots 4 --requests 16 --device cuda

Emits one ``serve_request`` JSON line per finished request and a final
``serve_summary`` line with the JAX CLI's serving fields; before it, with
``--spec-k`` a ``spec_summary`` line, with ``--kv-quant``/
``--weight-quant`` a ``quant_summary`` line, and with ``--tenants`` one
``sched_tenant_summary`` line a tenant. ``--shared-prefix-len`` puts one
random prefix before every prompt (the prefix cache's workload,
``--prefix-cache-mb``); ``--tenants`` assigns the requests to the
configured tenants in turn. Weights are random, drawn from ``--seed`` (the
draft's from ``--seed + 1``), as in the JAX CLI's presets. Runs on the GPU
unless ``--device cpu`` is given. Of the JAX CLI's flags this has the
single engine's: no replicas, gateway, transport, tensor parallelism,
tracing or autoscaling.
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
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend this many shared tokens to every prompt "
                         "(fleet traffic with a common system prompt: the "
                         "prefix cache's workload)")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="prefix-reuse trie budget in MiB (0 = off): "
                         "prompts sharing a prefix map its cached pages "
                         "into their block tables instead of recomputing; "
                         "the bytes come out of the shared KV pool")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="multi-tenant scheduler config: inline JSON or "
                         "@/path to a JSON file. Requests are assigned to "
                         "the configured tenants in turn; omitted = one "
                         "unlimited default tenant (FCFS)")
    ap.add_argument("--draft-model", choices=["micro", "tiny"], default=None,
                    help="speculative decoding with this draft preset "
                         "(micro: 1 layer of width 32; tiny: the test "
                         "config), built with the target's vocab, "
                         "max-seq-len and dtype; requires --spec-k")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft tokens proposed per slot per iteration "
                         "(>= 1; requires --draft-model); each iteration "
                         "emits 1 to k+1 tokens a slot, the tokens of "
                         "non-speculative decoding")
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
    if args.prefix_cache_mb < 0:
        ap.error(f"--prefix-cache-mb must be >= 0, got "
                 f"{args.prefix_cache_mb}")
    if args.shared_prefix_len < 0:
        ap.error(f"--shared-prefix-len must be >= 0, got "
                 f"{args.shared_prefix_len}")
    if (args.draft_model is None) != (args.spec_k == 0):
        ap.error("speculative decoding needs BOTH --draft-model and "
                 f"--spec-k >= 1 (got --draft-model {args.draft_model}, "
                 f"--spec-k {args.spec_k})")
    if args.spec_k < 0:
        ap.error(f"--spec-k must be >= 1 (0 = off), got {args.spec_k}")
    if args.shared_prefix_len + p_hi + o_hi > args.max_seq_len:
        ap.error(f"shared-prefix-len ({args.shared_prefix_len}) + "
                 f"prompt-len hi ({p_hi}) + out-len hi ({o_hi}) exceeds "
                 f"--max-seq-len ({args.max_seq_len})")
    tenant_cfgs = None
    if args.tenants:
        from k8s_distributed_deeplearning_torch.serve.sched import (
            load_tenants)
        try:
            tenant_cfgs = load_tenants(args.tenants)
        except (OSError, ValueError) as e:
            ap.error(f"--tenants: {e}")

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
    draft = None
    if args.draft_model is not None:
        # Draft presets take the target's vocab, max_seq_len and dtype:
        # both models must speak the same token ids over the same
        # positions.
        if args.draft_model == "micro":
            dcfg = llama.config_tiny(
                vocab_size=cfg.vocab_size, dim=32, n_layers=1, n_heads=2,
                n_kv_heads=1, mlp_dim=64, max_seq_len=cfg.max_seq_len,
                dtype=cfg.dtype)
        else:
            dcfg = llama.config_tiny(
                vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
                dtype=cfg.dtype)
        draft = llama.LlamaLM(dcfg, device=args.device, seed=args.seed + 1)
    stats = ServingStats()
    engine = ServeEngine(
        model, num_slots=args.slots,
        max_queue=args.max_queue or args.requests, eos_id=args.eos_id,
        prefill_chunk_tokens=args.prefill_chunk_tokens or None,
        prefix_cache_mb=args.prefix_cache_mb or None,
        kv_pool_pages=args.kv_pool_pages or None, tenants=tenant_cfgs,
        stats=stats, device=args.device, draft_model=draft,
        spec_k=args.spec_k, kv_quant=args.kv_quant,
        weight_quant=args.weight_quant)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, size=args.shared_prefix_len)
    tenant_ids = engine.queue.tenant_ids()
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(p_lo, p_hi + 1)))
        reqs.append(Request(prompt=np.concatenate([shared, prompt]).astype(
                                np.int32),
                            max_new_tokens=int(rng.integers(o_lo, o_hi + 1)),
                            sampling=sampling, seed=args.seed + i,
                            tenant=tenant_ids[i % len(tenant_ids)]))
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
    if args.spec_k:
        logger.emit("spec_summary", draft=args.draft_model,
                    spec_k=args.spec_k, spec_steps=summ["spec_steps"],
                    spec_proposed_tokens=summ["spec_proposed_tokens"],
                    spec_accepted_tokens=summ["spec_accepted_tokens"],
                    spec_acceptance_rate=summ["spec_acceptance_rate"],
                    spec_accept_hist=summ["spec_accept_hist"])
    if tenant_cfgs is not None:
        for tid, t in engine.queue.snapshot()["tenants"].items():
            logger.emit("sched_tenant_summary", tenant=tid, **t)
    if args.kv_quant or args.weight_quant:
        logger.emit("quant_summary", kv_quant=args.kv_quant,
                    weight_quant=args.weight_quant,
                    kv_quant_bytes_saved=summ["kv_quant_bytes_saved"],
                    weight_quant_bytes_saved=summ["weight_quant_bytes_saved"])
    logger.emit("serve_summary", num_slots=args.slots, preset=args.preset,
                replicas=1, device=str(engine.device), **summ)
    logger.close()
    return 0
