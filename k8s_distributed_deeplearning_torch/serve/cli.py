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
``replica_drained`` line a replica, exit 0.

The wire fleet (``serve/transport.py``): ``--replica-server`` runs ONE
engine as a replica-server process whose transport routes share the
metrics exporter on ``--metrics-port`` (0 = ephemeral, written to
``--port-file``); ``--heartbeat-dir`` advertises its address and
``--role`` (decode or prefill) in heartbeat files, ``--replica-rank``
names it and ``--advertise-host`` is the host peers dial. SIGTERM drains
it, prints ``replica_drained`` and ``serve_summary`` and exits 0.
``--replica-endpoints`` or ``--replica-discovery-dir`` run the gateway
over such processes instead of local engines (no model is built here);
with ``--disagg`` a coordinator routes prompts through prefill-role
servers (``--prefill-endpoints``, or discovered by role) and ships their
KV pages to the decode fleet over ``/pages``.

Telemetry: ``--metrics-port`` serves ``/metrics``, ``/healthz`` and
``/readyz`` (``telemetry/exporter.py``); ``--trace`` puts the engines'
spans on the JSONL stream; ``--request-trace-sample`` emits one
``request_trace`` event for that share of finished requests;
``--debug-dir`` turns on ``/debug/spans`` and ``/debug/profile``
(``torch.profiler`` traces into the directory).

The elastic fleet (``serve/autoscale.py``): ``--autoscale`` runs the
fleet controller over the gateway (forced even at one replica), scaling
between ``--autoscale-min`` and ``--autoscale-max`` on fast-window SLO
burn or queue pressure, with drain-backed scale-down and the brownout
ladder (``--autoscale-brownout``) at the ceiling. Its backend is local
engines on the shared model, or with ``--replica-discovery-dir``
replica-server processes it spawns (``launch serve --replica-server``),
or with ``--autoscale-k8s-job`` a patch of the replica Job's parallelism
through kubectl (``--autoscale-endpoint-template`` names a new pod's
endpoint). An ``autoscale_summary`` line follows ``serve_summary``.

Tensor parallelism: ``--tp k`` shards every local engine over k
processes (``serve/tp.py``). This process is rank 0 and spawns the k-1
followers itself, one a card (on fewer cards ranks share one), so a pod
with ``nvidia.com/gpu: k`` runs the command unchanged; a ``start`` line
(``role="tp_world"``) names the backend, and ``serve_summary`` gains
``tp``, ``tp_backend`` and ``tp_ranks`` (each rank's paged-attention
launches and peak device memory).
"""
from __future__ import annotations

import argparse
import contextlib
import os


def _drain_status(engines) -> dict:
    """/healthz body for the serving process: ``status`` is the preStop
    hook's one-word answer — "ok" until drain() is called, "draining"
    while any replica still holds work, "drained" once everything
    finished (safe to kill)."""
    draining = any(e.draining for e in engines)
    drained = all(e.drained for e in engines)
    return {"status": ("drained" if draining and drained
                       else "draining" if draining else "ok"),
            "draining": draining, "drained": drained}


def main(argv: list[str] | None = None) -> int:
    # The cleanup stack stops a tp world's followers however the run ends.
    with contextlib.ExitStack() as cleanup:
        return _main(argv, cleanup)


def _main(argv: list[str] | None, cleanup: contextlib.ExitStack) -> int:
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
    ap.add_argument("--replica-server", action="store_true",
                    help="run ONE engine as a standalone replica-server "
                         "process (serve/transport.py): the transport "
                         "endpoints (/submit /poll /cancel /drain /pages "
                         "/exports /shutdown) share the /metrics exporter "
                         "on --metrics-port, a remote gateway drives the "
                         "workload, and SIGTERM drains then exits 0")
    ap.add_argument("--port-file", default=None, metavar="PATH",
                    help="replica-server only: write the bound port here "
                         "once listening (use with --metrics-port 0 for "
                         "an ephemeral port)")
    ap.add_argument("--heartbeat-dir", default=None, metavar="DIR",
                    help="replica-server only: advertise this replica's "
                         "metrics_addr and role through heartbeat files "
                         "in DIR (the gateway's --replica-discovery-dir "
                         "reads the same directory)")
    ap.add_argument("--replica-rank", type=int, default=0,
                    help="replica-server only: heartbeat rank / identity "
                         "of this replica process")
    ap.add_argument("--advertise-host", default="127.0.0.1",
                    help="replica-server only: host written into the "
                         "advertised metrics_addr (the address peers "
                         "dial, not the bind address)")
    ap.add_argument("--role", choices=["decode", "prefill"],
                    default="decode",
                    help="replica-server only: disagg serving role. "
                         "decode = the normal engine; prefill = admission "
                         "+ prefill only, finished prompt KV pages are "
                         "exported over /exports for a coordinator to "
                         "ship to a decode replica")
    ap.add_argument("--disagg", action="store_true",
                    help="remote coordinator mode (needs "
                         "--replica-endpoints or --replica-discovery-dir): "
                         "route prompts through prefill-role replica "
                         "servers and ship their finished KV pages to the "
                         "least-loaded decode replica over /pages; with no "
                         "healthy prefill worker requests take unified "
                         "decode-local prefill")
    ap.add_argument("--prefill-endpoints", default=None, metavar="LIST",
                    help="with --disagg: static comma-separated host:port "
                         "list of prefill-role replica servers (with "
                         "--replica-discovery-dir they are discovered by "
                         "their role beacon instead)")
    ap.add_argument("--replica-endpoints", default=None, metavar="LIST",
                    help="run the gateway over REMOTE replica-server "
                         "processes at these comma-separated host:port "
                         "endpoints instead of local engines (no model is "
                         "built)")
    ap.add_argument("--replica-discovery-dir", default=None, metavar="DIR",
                    help="like --replica-endpoints, but discover the fleet "
                         "from heartbeat files carrying metrics_addr "
                         "(written by replica servers started with "
                         "--heartbeat-dir DIR)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel width: shard each local engine's "
                         "attention/MLP weights and paged KV pool along the "
                         "head dimension over N processes, this one rank 0 "
                         "and N-1 followers it spawns, one a card "
                         "(serve/tp.py; 0 = single-device, 1 = a world of "
                         "one through the same seam)")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO-driven fleet controller "
                         "(serve/autoscale.py) over the gateway: scale "
                         "the replica set between --autoscale-min and "
                         "--autoscale-max on fast-window SLO burn / "
                         "queue pressure (drain-safe scale-down, zero "
                         "lost requests) and walk the reversible "
                         "brownout ladder at max scale")
    ap.add_argument("--autoscale-min", type=int, default=1,
                    help="elastic floor: never drain below this many "
                         "replicas")
    ap.add_argument("--autoscale-max", type=int, default=4,
                    help="elastic ceiling: at this many replicas, "
                         "sustained overload escalates the brownout "
                         "ladder instead of adding capacity")
    ap.add_argument("--autoscale-interval-s", type=float, default=0.5,
                    metavar="S",
                    help="minimum seconds between control rounds")
    ap.add_argument("--autoscale-up-cooldown-s", type=float, default=2.0,
                    metavar="S",
                    help="minimum seconds between scale-up (or brownout "
                         "escalation) actuations")
    ap.add_argument("--autoscale-down-cooldown-s", type=float,
                    default=5.0, metavar="S",
                    help="minimum seconds between scale-down (or "
                         "brownout de-escalation) actuations")
    ap.add_argument("--autoscale-brownout", default=None, metavar="LIST",
                    help="comma-separated brownout ladder stages in "
                         "escalation order (default: shed_batch,"
                         "no_hedge,tight_admission)")
    ap.add_argument("--autoscale-k8s-job", default=None, metavar="NAME",
                    help="actuate by patching this Indexed replica "
                         "Job's parallelism through kubectl instead of "
                         "spawning local processes (the rendered "
                         "gateway role passes this)")
    ap.add_argument("--autoscale-k8s-namespace", default="default",
                    help="namespace of --autoscale-k8s-job")
    ap.add_argument("--autoscale-endpoint-template", default=None,
                    metavar="FMT",
                    help="host:port format string with an {i} "
                         "completion-index placeholder — how the k8s "
                         "backend names the endpoint of a freshly "
                         "scaled-up replica pod (Indexed-Job DNS is "
                         "deterministic)")
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
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (+ /healthz, /readyz) "
                         "on this port; serving gauges update per scrape")
    ap.add_argument("--trace", action="store_true",
                    help="emit span events (admission/prefill/decode) "
                         "through the JSONL stream")
    ap.add_argument("--request-trace-sample", type=float, default=0.0,
                    metavar="FRAC",
                    help="emit one request_trace lifecycle event for this "
                         "fraction of finished requests, chosen by a hash "
                         "of the request id (0 = off, 1 = every request)")
    ap.add_argument("--debug-dir", default=None, metavar="DIR",
                    help="enable the exporter's debug surface (requires "
                         "--metrics-port): /debug/spans serves a ring of "
                         "recent spans, /debug/profile?ms=N captures a "
                         "torch.profiler trace into DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.tp < 0:
        ap.error(f"--tp must be >= 0 (0 = single-device), got {args.tp}")
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
    if args.kv_pool_pages < 0:
        ap.error(f"--kv-pool-pages must be >= 0, got {args.kv_pool_pages}")
    if not 0.0 <= args.request_trace_sample <= 1.0:
        ap.error(f"--request-trace-sample must be in [0, 1], got "
                 f"{args.request_trace_sample}")
    if args.debug_dir is not None and args.metrics_port is None:
        ap.error("--debug-dir requires --metrics-port (the debug surface "
                 "rides the metrics exporter)")
    remote = (args.replica_endpoints is not None
              or args.replica_discovery_dir is not None)
    if args.replica_endpoints is not None and args.replica_discovery_dir:
        ap.error("--replica-endpoints and --replica-discovery-dir are "
                 "mutually exclusive (static list vs heartbeat discovery)")
    if args.replica_server and remote:
        ap.error("--replica-server runs the engine side; "
                 "--replica-endpoints/--replica-discovery-dir run the "
                 "gateway side — pick one per process")
    if args.replica_server and args.replicas != 1:
        ap.error("--replica-server wraps exactly one engine per process "
                 f"(got --replicas {args.replicas}); scale out by "
                 "starting more replica-server processes")
    if args.replica_server and args.metrics_port is None:
        ap.error("--replica-server requires --metrics-port (the transport "
                 "endpoints ride the metrics exporter; 0 = ephemeral "
                 "with --port-file)")
    if args.port_file is not None and not args.replica_server:
        ap.error("--port-file only makes sense with --replica-server")
    if args.heartbeat_dir is not None and not args.replica_server:
        ap.error("--heartbeat-dir only makes sense with --replica-server "
                 "(gateways discover via --replica-discovery-dir)")
    if args.role != "decode" and not args.replica_server:
        ap.error("--role only makes sense with --replica-server (the "
                 "coordinator side learns roles from heartbeat beacons)")
    if args.role == "prefill" and args.spec_k:
        ap.error("--role prefill runs admission + prefill only; "
                 "speculative decoding is a decode-side knob")
    if args.disagg and not remote:
        ap.error("--disagg needs a remote decode fleet "
                 "(--replica-endpoints or --replica-discovery-dir); "
                 "use --disagg-prefill N for in-process disagg")
    if args.prefill_endpoints is not None and not args.disagg:
        ap.error("--prefill-endpoints only makes sense with --disagg")
    if (args.prefill_endpoints is not None
            and args.replica_discovery_dir is not None):
        ap.error("--prefill-endpoints is the static alternative to "
                 "role-heartbeat discovery; with --replica-discovery-dir "
                 "the prefill fleet is discovered from the same directory")
    if args.disagg_prefill and (remote or args.replica_server):
        ap.error("--disagg-prefill runs in-process prefill engines; use "
                 "--disagg for a remote fleet, or start prefill replica "
                 "servers with --role prefill")
    if (args.disagg or args.disagg_prefill) and args.autoscale:
        ap.error("--disagg and --autoscale are not yet composable in "
                 "one process: the controller actuates through the "
                 "gateway, which the disagg coordinator replaces (run "
                 "per-role controllers instead)")
    if (args.disagg or args.disagg_prefill) \
            and args.hedge_after_s is not None:
        ap.error("--hedge-after-s is a gateway knob; the disagg "
                 "coordinator does not hedge")
    if remote and args.draft_model is not None:
        ap.error("speculative decoding is an engine-side knob: pass "
                 "--draft-model to the replica-server processes, not the "
                 "remote gateway")
    if args.autoscale:
        if args.replica_server:
            ap.error("--autoscale runs gateway-side; a replica-server "
                     "is the thing being scaled")
        if args.autoscale_min < 1:
            ap.error(f"--autoscale-min must be >= 1, got "
                     f"{args.autoscale_min}")
        if args.autoscale_max < args.autoscale_min:
            ap.error(f"--autoscale-min ({args.autoscale_min}) must be "
                     f"<= --autoscale-max ({args.autoscale_max})")
        if args.autoscale_up_cooldown_s <= 0 \
                or args.autoscale_down_cooldown_s <= 0:
            ap.error("autoscale cooldowns must be > 0")
        if args.autoscale_brownout is not None:
            # Literal copy of serve.autoscale.BROWNOUT_STAGE_NAMES so a
            # typo dies with usage text before the heavy imports; a
            # test keeps the two tuples identical.
            known = ("shed_batch", "no_hedge", "tight_admission")
            for stage in args.autoscale_brownout.split(","):
                if stage.strip() not in known:
                    ap.error(f"--autoscale-brownout stage "
                             f"{stage.strip()!r} is not one of {known}")
        if args.autoscale_k8s_job is not None and not remote:
            ap.error("--autoscale-k8s-job needs the remote gateway "
                     "(--replica-endpoints/--replica-discovery-dir): "
                     "the k8s backend scales replica-server pods")
        if args.replica_endpoints is not None \
                and args.autoscale_k8s_job is None:
            ap.error("--autoscale over a static --replica-endpoints "
                     "list has nothing to start/stop replicas with; "
                     "pass --autoscale-k8s-job, or use "
                     "--replica-discovery-dir for the local process "
                     "backend")
    elif args.autoscale_k8s_job is not None \
            or args.autoscale_endpoint_template is not None:
        ap.error("--autoscale-k8s-job/--autoscale-endpoint-template "
                 "only make sense with --autoscale")
    # A replica server generates no workload of its own (the gateway
    # shapes every request it serves), so the workload bounds apply to
    # the driving modes only.
    if (not args.replica_server and args.shared_prefix_len + p_hi + o_hi
            > args.max_seq_len):
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
    import time
    from collections import deque

    import numpy as np
    import torch

    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import (QueueFull, Request,
                                                          SamplingParams,
                                                          ServeEngine)
    from k8s_distributed_deeplearning_torch.utils.device import (
        resolve_device)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger, ServingStats)

    # Every mode runs on the card unless --device cpu asks otherwise, the
    # remote gateway (which builds no model) included.
    resolve_device(args.device)

    if args.preset == "small":
        cfg = llama.config_tiny(
            vocab_size=32000, dim=768, n_layers=12, n_heads=12, n_kv_heads=4,
            mlp_dim=2048, max_seq_len=args.max_seq_len, dtype=torch.bfloat16)
    else:
        cfg = llama.config_tiny(max_seq_len=args.max_seq_len,
                                dtype=torch.float32)
    # One model, its weights held once, for every engine of the fleet (a
    # remote gateway builds none). Under --tp it lives on the host: each
    # engine reads it into the ranks' shards, so the card holds only
    # rank 0's shard.
    build_on = "cpu" if args.tp else args.device
    model = (None if remote
             else llama.LlamaLM(cfg, device=build_on, seed=args.seed))
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
        draft = llama.LlamaLM(dcfg, device=build_on, seed=args.seed + 1)
    logger = MetricsLogger(job="serve", path=args.metrics_path)
    world = None
    if args.tp and not remote:
        from k8s_distributed_deeplearning_torch.serve import tp as tp_lib
        from k8s_distributed_deeplearning_torch.serve.engine import (
            _validate_tp_cfg)
        # Refuse an indivisible preset before any follower starts.
        try:
            _validate_tp_cfg(cfg, args.tp, "target model")
            if draft is not None:
                _validate_tp_cfg(dcfg, args.tp, "draft model")
        except ValueError as e:
            ap.error(f"--tp {args.tp}: {e}")
        world = tp_lib.launch(args.tp, args.device)
        cleanup.callback(tp_lib.shutdown)
        logger.emit("start", role="tp_world", tp=args.tp,
                    backend=world.backend, device=str(world.device))
    flight = None
    if args.flight_ring:
        from k8s_distributed_deeplearning_torch.telemetry.flight import (
            FlightRecorder)
        # ONE recorder shared by every replica and the gateway: a dump is
        # the whole process's flight path, sources interleaved.
        flight = FlightRecorder(args.flight_ring, dump_dir=args.flight_dir,
                                logger=logger, job="serve")
    tracer = None
    if args.trace or args.debug_dir is not None:
        from k8s_distributed_deeplearning_torch.telemetry.trace import Tracer
        # --debug-dir without --trace: a record-only tracer (no logger)
        # still fills the ring behind /debug/spans without putting span
        # events on the JSONL stream.
        tracer = Tracer(logger if args.trace else None,
                        ring_size=512 if args.debug_dir is not None else 0)
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
            request_log=logger, tracer=tracer,
            tp=0 if world is None else args.tp, **kw)

    engines = [] if remote else [
        make_engine(draft_model=draft, spec_k=args.spec_k,
                    request_trace_sample=args.request_trace_sample,
                    prefill_only=args.role == "prefill",
                    replica_id=(f"r{i}" if args.replicas > 1 or args.autoscale
                                else None))
        for i in range(args.replicas)]
    engine = engines[0] if engines else None
    front = engine
    clients = gateway = coordinator = None
    if remote:
        from k8s_distributed_deeplearning_torch.serve.gateway import (
            ServeGateway)
        from k8s_distributed_deeplearning_torch.serve.transport import (
            ReplicaClient, discover_replica_clients)
        kw = dict(stats=stats, logger=logger, flight=flight)
        if args.replica_discovery_dir is not None:
            clients = discover_replica_clients(args.replica_discovery_dir,
                                               **kw)
            if not clients:
                ap.error(f"--replica-discovery-dir "
                         f"{args.replica_discovery_dir}: no heartbeat "
                         f"advertises a metrics_addr (are the replica "
                         f"servers up, with --heartbeat-dir?)")
        else:
            clients = [ReplicaClient(ep.strip(), **kw)
                       for ep in args.replica_endpoints.split(",")
                       if ep.strip()]
            if not clients:
                ap.error("--replica-endpoints: empty endpoint list")
        if args.hedge_after_s is not None and len(clients) < 2:
            ap.error("--hedge-after-s needs >= 2 remote replicas")
        if args.disagg:
            # Coordinator mode replaces the gateway: decode clients take
            # dispatches, prefill-role clients (possibly none: then every
            # request takes the unified fallback) feed them pages.
            from k8s_distributed_deeplearning_torch.serve.disagg import (
                DisaggCoordinator, RemotePrefillWorker)
            if args.prefill_endpoints is not None:
                prefill_clients = [
                    ReplicaClient(ep.strip(), **kw)
                    for ep in args.prefill_endpoints.split(",")
                    if ep.strip()]
            elif args.replica_discovery_dir is not None:
                prefill_clients = discover_replica_clients(
                    args.replica_discovery_dir, role="prefill", **kw)
            else:
                prefill_clients = []
            front = coordinator = DisaggCoordinator(
                clients, [RemotePrefillWorker(c) for c in prefill_clients],
                stats=stats, logger=logger)
        else:
            front = gateway = ServeGateway(
                clients, stats=stats, logger=logger,
                hedge_after_s=args.hedge_after_s, flight=flight)
    elif args.disagg_prefill:
        from k8s_distributed_deeplearning_torch.serve.disagg import (
            DisaggCoordinator, PrefillWorker)
        front = coordinator = DisaggCoordinator(
            engines, [PrefillWorker(make_engine(prefill_only=True,
                                                replica_id=f"p{i}"))
                      for i in range(args.disagg_prefill)],
            stats=stats, logger=logger)
    elif args.replicas > 1 or args.autoscale:
        # --autoscale forces the gateway even at one replica: the
        # controller actuates through its dynamic membership.
        from k8s_distributed_deeplearning_torch.serve.gateway import (
            ServeGateway)
        front = gateway = ServeGateway(engines, stats=stats, logger=logger,
                                       hedge_after_s=args.hedge_after_s,
                                       flight=flight)
    # What the probes report on: the clients' cached replica states in
    # remote mode, the engines themselves otherwise.
    status_objs = clients if clients is not None else engines

    controller = autoscale_backend = slo = None
    if args.autoscale:
        from k8s_distributed_deeplearning_torch.serve.autoscale import (
            EngineFactoryBackend, FleetController, K8sParallelismBackend,
            LocalProcessBackend, default_brownout_stages,
            heartbeat_discoverer)
        from k8s_distributed_deeplearning_torch.telemetry.slo import (
            SLOEngine, SLOTarget, objectives_from_tenants)
        objectives = (objectives_from_tenants(tenant_cfgs)
                      if tenant_cfgs is not None else {})
        if not objectives:
            # No tenant slo blocks: a 99%-over-60s objective a tenant
            # (fast window 5 s), so the burn signal is live at demo
            # timescales instead of the 1 h production default.
            ids = ([c.tenant_id for c in tenant_cfgs]
                   if tenant_cfgs is not None else ["default"])
            objectives = {tid: SLOTarget(availability=0.99, window_s=60.0)
                          for tid in ids}
        # The controller's clock: observe() stamps and evaluate()
        # windows live on one timeline.
        slo = SLOEngine(objectives, emit=logger.emit, clock=time.monotonic)
        client_kwargs = dict(stats=stats, logger=logger, flight=flight)
        if args.autoscale_k8s_job is not None:
            from k8s_distributed_deeplearning_torch.launch.watch import (
                Kubectl)
            autoscale_backend = K8sParallelismBackend(
                Kubectl(), args.autoscale_k8s_job,
                args.autoscale_k8s_namespace,
                initial_replicas=len(clients),
                endpoint_template=args.autoscale_endpoint_template,
                client_kwargs=client_kwargs)
        elif remote:
            # Spawned servers run on this process's device (--device).
            autoscale_backend = LocalProcessBackend(
                args.replica_discovery_dir, preset=args.preset,
                slots=args.slots, client_kwargs=client_kwargs,
                extra_args=("--device", args.device))
        else:
            autoscale_backend = EngineFactoryBackend(
                lambda: make_engine(
                    draft_model=draft, spec_k=args.spec_k,
                    request_trace_sample=args.request_trace_sample))
        discover = None
        if (args.autoscale_k8s_job is not None
                and args.replica_discovery_dir is not None):
            # Async membership: pods scaled up by the Job patch join
            # when their heartbeat beacon lands in the shared dir.
            discover = heartbeat_discoverer(args.replica_discovery_dir,
                                            client_kwargs=client_kwargs)
        stages = None
        if args.autoscale_brownout is not None:
            stages = default_brownout_stages(tuple(
                st.strip() for st in args.autoscale_brownout.split(",")))
        controller = FleetController(
            gateway, autoscale_backend, slo=slo,
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max,
            interval_s=args.autoscale_interval_s,
            up_cooldown_s=args.autoscale_up_cooldown_s,
            down_cooldown_s=args.autoscale_down_cooldown_s,
            brownout_stages=stages, discover=discover, logger=logger)

    def _fleet_engines():
        # Membership is dynamic under --autoscale: the probe targets are
        # resolved a call, not frozen at startup.
        if controller is not None:
            return [gateway.replica_engine(rid)
                    for rid in gateway.replica_ids()]
        return status_objs
    # SIGTERM -> cooperative drain -> exit 0. The handler only flips drain
    # mode; the loops below dump the flight ring, start the drain, shed
    # the unsubmitted tail and step until everything held has finished.
    # Nothing else runs in the handler: it interrupts the main thread
    # anywhere, an event's write included.
    drain_requested = False

    def _on_sigterm(signum, frame):
        nonlocal drain_requested
        drain_requested = True

    def _begin_drain() -> None:
        if flight is not None:
            flight.dump("sigterm")
        if coordinator is not None:
            # Coordinator mode only stops feeding: draining the decode
            # side would strand pages the prefill workers export.
            return
        if gateway is not None and (clients is not None
                                    or controller is not None):
            # Remote or elastic fleet: drain THROUGH the gateway so
            # queued work migrates between replicas instead of dying with
            # this process's view of them (under --autoscale the startup
            # `engines` list is stale anyway).
            for rid in gateway.replica_ids():
                gateway.drain_replica(rid)
        else:
            for e in engines:
                e.drain()

    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        previous = None          # not the main thread: no handler

    if args.replica_server:
        # Engine side of the wire: no local workload, a remote gateway
        # submits over the transport routes. Blocks until /shutdown, or
        # until a SIGTERM-started drain has finished.
        from k8s_distributed_deeplearning_torch.serve.transport import (
            ReplicaServer)
        engine.replica_id = engine.replica_id or f"r{args.replica_rank}"
        server = ReplicaServer(
            engine, host="0.0.0.0", port=args.metrics_port,
            advertise_host=args.advertise_host, logger=logger,
            heartbeat_dir=args.heartbeat_dir, rank=args.replica_rank,
            role=args.role, flight=flight).start()
        try:
            if args.port_file:
                with open(args.port_file, "w") as f:
                    f.write(f"{server.port}\n")
            logger.emit("start", role="replica_server", port=server.port,
                        replica=engine.replica_id, preset=args.preset,
                        serve_role=args.role, num_slots=args.slots,
                        device=str(engine.device))
            draining = False
            while not server.shutting_down:
                if drain_requested and not draining:
                    if flight is not None:
                        flight.dump("sigterm")
                    server.begin_drain()
                    draining = True
                if draining and server.drained:
                    break
                time.sleep(0.02)
            logger.emit("replica_drained", replica=engine.replica_id)
            logger.emit("serve_summary", num_slots=args.slots,
                        preset=args.preset, replicas=1,
                        device=str(engine.device), **stats.summary())
        finally:
            server.close()
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            logger.close()
        return 0

    exporter = None
    if args.metrics_port is not None:
        from k8s_distributed_deeplearning_torch.telemetry import bridge
        from k8s_distributed_deeplearning_torch.telemetry.exporter import (
            MetricsExporter)
        from k8s_distributed_deeplearning_torch.telemetry.registry import (
            MetricsRegistry)
        registry = MetricsRegistry()
        bridge.serving_collector(registry, stats)
        if engines:
            # Remote mode has no local engines; replica servers export
            # their own serve_tp.
            bridge.tp_collector(registry, engines)
        if gateway is not None:
            bridge.gateway_collector(registry, gateway)
            if controller is not None:
                bridge.autoscale_collector(registry, controller)
        elif engine is not None and coordinator is None:
            # Per-tenant labeled gauges are per scheduler: one engine
            # only (with replicas the labels would collide).
            bridge.sched_collector(registry, engine.queue)
        exporter = MetricsExporter(
            registry, port=args.metrics_port,
            tracer=tracer if args.debug_dir is not None else None,
            profile_dir=args.debug_dir, flight=flight,
            healthz=lambda: _drain_status(_fleet_engines()),
            # Readiness splits from liveness: 503 the moment a drain
            # starts (stop routing here), /healthz stays 200.
            readyz=lambda: {
                "ready": not any(e.draining for e in _fleet_engines()),
                **_drain_status(_fleet_engines())}).start()
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, size=args.shared_prefix_len)
    if engine is not None:
        tenant_ids = engine.queue.tenant_ids()
    elif tenant_cfgs is not None:
        # Remote mode: admission control lives replica-side; the feed
        # only tags requests with the ids.
        tenant_ids = [c.tenant_id for c in tenant_cfgs]
    else:
        tenant_ids = ["default"]
    feed = deque()
    tenant_of = {}          # request_id -> tenant, for the SLO feed
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(p_lo, p_hi + 1)))
        req = Request(prompt=np.concatenate([shared, prompt]).astype(
                          np.int32),
                      max_new_tokens=int(rng.integers(o_lo, o_hi + 1)),
                      sampling=sampling, seed=args.seed + i,
                      tenant=tenant_ids[i % len(tenant_ids)])
        tenant_of[req.request_id] = req.tenant
        feed.append(req)
    slo_finished = {}       # tenant -> cumulative {reason: count}

    draining = False
    finished_loop = False
    try:
        while feed or front.busy():
            if drain_requested and not draining:
                _begin_drain()
                draining = True
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
                if controller is not None:
                    by = slo_finished.setdefault(
                        tenant_of.get(out.request_id, "default"), {})
                    by[out.finish_reason] = by.get(out.finish_reason, 0) + 1
            if controller is not None and not drain_requested:
                # The serving loop is the scrape cadence: cumulative
                # finish counts feed the burn windows, then the control
                # loop takes its (self-rate-limited) round.
                slo.observe(finished=slo_finished)
                controller.maybe_round()
            if clients is not None:
                # The replicas step on their own: poll, not spin.
                time.sleep(0.002)
        finished_loop = True
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        if not finished_loop and controller is not None:
            # A failed run reaps the replica servers it spawned too.
            reap = getattr(autoscale_backend, "reap_all", None)
            if reap is not None:
                reap()
    if drain_requested and not draining:
        _begin_drain()           # the signal came with the last step
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
    tp_fields = {}
    if world is not None:
        # Each rank's paged-attention launches and peak device bytes.
        tp_fields = {"tp": args.tp, "tp_backend": world.backend,
                     "tp_ranks": {k: [int(v) for v in vals] for k, vals
                                  in world.stats().items() if any(vals)}}
    logger.emit("serve_summary", num_slots=args.slots, preset=args.preset,
                replicas=len(clients) if clients is not None
                else args.replicas,
                device=str(engine.device) if engine is not None
                else "remote", **summ, **tp_fields)
    if controller is not None:
        logger.emit("autoscale_summary", **controller.snapshot())
        reap = getattr(autoscale_backend, "reap_all", None)
        if reap is not None:
            reap()               # LocalProcessBackend child teardown
    logger.close()
    if exporter is not None:
        exporter.stop()
    return 0
