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
unless ``--device cpu`` is given.

The in-process fleet: ``--replicas N`` runs N engines on one shared model
behind the failover gateway (``serve/gateway.py``, ``--hedge-after-s``);
``--disagg-prefill N`` puts N prefill-only engines in front of them
through the ``DisaggCoordinator`` (``serve/disagg.py``). ``--flight-ring``
keeps a flight recorder over every engine and the gateway
(``--flight-dir`` for its dumps). SIGTERM drains every replica: the
unsubmitted tail is shed, what the fleet holds finishes, one
``replica_drained`` line a replica, exit 0. Not ported yet, and raising:
tensor parallelism (``--tp``), the wire transport (``--replica-server``,
``--replica-endpoints``, ``--replica-discovery-dir``,
``--prefill-endpoints``, ``--role``) and the autoscaler
(``--autoscale*``); nor tracing.
"""
from __future__ import annotations

import argparse
import os

_UNPORTED = (
    ("tp", "--tp", "tensor-parallel serving"),
    ("replica_server", "--replica-server", "the wire transport "
     "(serve/transport.py)"),
    ("replica_endpoints", "--replica-endpoints", "the wire transport "
     "(serve/transport.py)"),
    ("replica_discovery_dir", "--replica-discovery-dir", "the wire "
     "transport (serve/transport.py)"),
    ("prefill_endpoints", "--prefill-endpoints", "the wire transport "
     "(serve/transport.py)"),
    ("role", "--role", "the replica server (serve/transport.py)"),
    ("autoscale", "--autoscale", "the autoscaler (serve/autoscale.py)"),
    ("autoscale_min", "--autoscale-min", "the autoscaler "
     "(serve/autoscale.py)"),
    ("autoscale_max", "--autoscale-max", "the autoscaler "
     "(serve/autoscale.py)"),
    ("autoscale_interval_s", "--autoscale-interval-s", "the autoscaler "
     "(serve/autoscale.py)"),
    ("autoscale_up_cooldown_s", "--autoscale-up-cooldown-s", "the "
     "autoscaler (serve/autoscale.py)"),
    ("autoscale_down_cooldown_s", "--autoscale-down-cooldown-s", "the "
     "autoscaler (serve/autoscale.py)"),
    ("autoscale_brownout", "--autoscale-brownout", "the autoscaler "
     "(serve/autoscale.py)"),
    ("autoscale_k8s_job", "--autoscale-k8s-job", "the autoscaler "
     "(serve/autoscale.py)"),
    ("autoscale_k8s_namespace", "--autoscale-k8s-namespace", "the "
     "autoscaler (serve/autoscale.py)"),
    ("autoscale_endpoint_template", "--autoscale-endpoint-template", "the "
     "autoscaler (serve/autoscale.py)"),
)


def _unported(args) -> None:
    """Raise for a JAX CLI flag whose subsystem the port lacks yet."""
    for attr, flag, what in _UNPORTED:
        if getattr(args, attr) not in (None, False, 0):
            raise NotImplementedError(
                f"{flag}: {what} is not ported to PyTorch yet "
                "(ROADMAP.md)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m k8s_distributed_deeplearning_torch.serve",
        description="Continuous-batching serving demo on the PyTorch port")
    ap.add_argument("--preset", choices=["tiny", "small"], default="tiny",
                    help="tiny: the test topology in f32; small: 12 layers "
                         "of width 768 in bf16")
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=1,
                    help="run this many in-process engine replicas on one "
                         "shared model behind the failover gateway "
                         "(serve/gateway.py): health-routed dispatch, "
                         "per-replica circuit breakers, and in-flight "
                         "migration off sick/draining replicas. 1 = a bare "
                         "engine (no gateway)")
    ap.add_argument("--hedge-after-s", type=float, default=None,
                    metavar="S",
                    help="gateway only: duplicate a request's dispatch on "
                         "a second replica when its first token is still "
                         "missing after S seconds (first stream wins, "
                         "loser is cancelled); omitted = no hedging")
    ap.add_argument("--disagg-prefill", type=int, default=0, metavar="N",
                    help="in-process disagg: run N prefill-only engines "
                         "in front of the --replicas decode engines and "
                         "route through the DisaggCoordinator (0 = off)")
    ap.add_argument("--flight-ring", type=int, default=0, metavar="N",
                    help="black-box flight recorder: keep the last N "
                         "per-step engine/gateway snapshots in memory and "
                         "dump them as JSONL on breaker trip, drain "
                         "completion, SIGTERM or injected fault (0 = off)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="directory for flight-recorder dump files "
                         "(requires --flight-ring; omitted = dumps stay "
                         "in memory)")
    for flag, kind in (("--tp", int), ("--replica-endpoints", str),
                       ("--replica-discovery-dir", str),
                       ("--prefill-endpoints", str), ("--role", str),
                       ("--autoscale-min", int), ("--autoscale-max", int),
                       ("--autoscale-interval-s", float),
                       ("--autoscale-up-cooldown-s", float),
                       ("--autoscale-down-cooldown-s", float),
                       ("--autoscale-brownout", str),
                       ("--autoscale-k8s-job", str),
                       ("--autoscale-k8s-namespace", str),
                       ("--autoscale-endpoint-template", str)):
        ap.add_argument(flag, type=kind, default=None,
                        help="not ported yet: raises when given")
    for flag in ("--replica-server", "--autoscale"):
        ap.add_argument(flag, action="store_true",
                        help="not ported yet: raises when given")
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
    _unported(args)
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
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.disagg_prefill < 0:
        ap.error(f"--disagg-prefill must be >= 0, got "
                 f"{args.disagg_prefill}")
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

    import signal
    from collections import deque

    import numpy as np
    import torch

    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import (QueueFull, Request,
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
    # One model, its weights held once, for every engine of the fleet.
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
    logger = MetricsLogger(job="serve", path=args.metrics_path)
    flight = None
    if args.flight_ring:
        from k8s_distributed_deeplearning_torch.telemetry.flight import (
            FlightRecorder)
        # ONE recorder shared by every replica and the gateway: a dump is
        # the whole process's flight path, sources interleaved.
        flight = FlightRecorder(args.flight_ring, dump_dir=args.flight_dir,
                                logger=logger, job="serve")
    # ONE ServingStats shared by every engine and the front, so the
    # summary is the fleet's.
    stats = ServingStats()

    def make_engine(**kw):
        return ServeEngine(
            model, num_slots=args.slots,
            max_queue=args.max_queue or args.requests, eos_id=args.eos_id,
            prefill_chunk_tokens=args.prefill_chunk_tokens or None,
            prefix_cache_mb=args.prefix_cache_mb or None,
            kv_pool_pages=args.kv_pool_pages or None, tenants=tenant_cfgs,
            stats=stats, device=args.device, kv_quant=args.kv_quant,
            weight_quant=args.weight_quant, flight=flight,
            request_log=logger, **kw)

    engines = [make_engine(draft_model=draft, spec_k=args.spec_k,
                           replica_id=(f"r{i}" if args.replicas > 1
                                       else None))
               for i in range(args.replicas)]
    engine = engines[0]
    front = engine
    if args.disagg_prefill:
        from k8s_distributed_deeplearning_torch.serve.disagg import (
            DisaggCoordinator, PrefillWorker)
        front = DisaggCoordinator(
            engines, [PrefillWorker(make_engine(prefill_only=True,
                                                replica_id=f"p{i}"))
                      for i in range(args.disagg_prefill)],
            stats=stats, logger=logger)
    elif args.replicas > 1:
        from k8s_distributed_deeplearning_torch.serve.gateway import (
            ServeGateway)
        front = ServeGateway(engines, stats=stats, logger=logger,
                             hedge_after_s=args.hedge_after_s,
                             flight=flight)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, size=args.shared_prefix_len)
    tenant_ids = engine.queue.tenant_ids()
    feed = deque()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(p_lo, p_hi + 1)))
        feed.append(Request(prompt=np.concatenate([shared, prompt]).astype(
                                np.int32),
                            max_new_tokens=int(rng.integers(o_lo, o_hi + 1)),
                            sampling=sampling, seed=args.seed + i,
                            tenant=tenant_ids[i % len(tenant_ids)]))

    # SIGTERM -> cooperative drain -> exit 0. The handler only flips drain
    # mode; the loop below sheds the unsubmitted tail and steps until
    # everything held has finished.
    drain_requested = False

    def _on_sigterm(signum, frame):
        nonlocal drain_requested
        drain_requested = True
        if flight is not None:
            flight.dump("sigterm")
        if not args.disagg_prefill:
            # Coordinator mode only stops feeding: draining the decode
            # engines would strand pages the prefill workers export.
            for e in engines:
                e.drain()

    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        previous = None          # not the main thread: no handler
    try:
        while feed or front.busy():
            if drain_requested and feed:
                feed.clear()     # draining: the unsubmitted tail is shed
            while feed:
                try:
                    front.submit(feed[0])
                except QueueFull:
                    logger.emit("sched_shed", tenant=feed[0].tenant,
                                request_id=feed[0].request_id,
                                retried=True)
                    break
                feed.popleft()
            for out in front.step():
                logger.emit(
                    "serve_request", request_id=out.request_id,
                    prompt_len=out.prompt_len, new_tokens=len(out.tokens),
                    finish_reason=out.finish_reason,
                    cached_prompt_tokens=out.cached_prompt_tokens,
                    queue_ms=round(out.queue_s * 1e3, 3),
                    ttft_ms=(round(out.ttft_s * 1e3, 3)
                             if out.ttft_s is not None else None),
                    latency_ms=round(out.latency_s * 1e3, 3))
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if drain_requested:
        for e in engines:
            logger.emit("replica_drained",
                        replica=e.replica_id if e.replica_id is not None
                        else "r0")
    summ = stats.summary()
    if args.spec_k:
        logger.emit("spec_summary", draft=args.draft_model,
                    spec_k=args.spec_k, spec_steps=summ["spec_steps"],
                    spec_proposed_tokens=summ["spec_proposed_tokens"],
                    spec_accepted_tokens=summ["spec_accepted_tokens"],
                    spec_acceptance_rate=summ["spec_acceptance_rate"],
                    spec_accept_hist=summ["spec_accept_hist"])
    if tenant_cfgs is not None:
        for e in engines:
            for tid, t in e.queue.snapshot()["tenants"].items():
                logger.emit("sched_tenant_summary", tenant=tid,
                            replica=e.replica_id, **t)
    if args.kv_quant or args.weight_quant:
        logger.emit("quant_summary", kv_quant=args.kv_quant,
                    weight_quant=args.weight_quant,
                    kv_quant_bytes_saved=summ["kv_quant_bytes_saved"],
                    weight_quant_bytes_saved=summ["weight_quant_bytes_saved"])
    logger.emit("serve_summary", num_slots=args.slots, preset=args.preset,
                replicas=args.replicas, device=str(engine.device), **summ)
    logger.close()
    return 0
