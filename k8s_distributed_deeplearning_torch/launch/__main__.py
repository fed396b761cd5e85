"""CLI: render, validate, locally execute, or apply the port's job manifests.

The port's own copy of ``k8s_distributed_deeplearning_tpu/launch/
__main__.py``, with the GPU flags ``--gpus-per-worker`` and
``--gpu-accelerator`` in place of ``--tpu-topology`` and
``--tpu-accelerator``. Usage::

  python -m k8s_distributed_deeplearning_torch.launch render --workers 4 \
      --name tpu-mnist --script examples/train_mnist_torch.py -- --num-steps 20000
  python -m k8s_distributed_deeplearning_torch.launch render ... --apply
  python -m k8s_distributed_deeplearning_torch.launch validate --workers 4
  python -m k8s_distributed_deeplearning_torch.launch run-local --workers 2 \
      -- --device cpu --num-steps 40 --no-eval
  python -m k8s_distributed_deeplearning_torch.launch serve \
      --preset tiny --requests 32 --slots 4
  python -m k8s_distributed_deeplearning_torch.launch storm \
      --seed 0 --steps 200 --replicas 2 --autoscale

``validate`` runs the offline structural checks and, when kubectl can reach
a cluster, a server-side dry-run. ``run-local`` executes the rendered pod
template as local processes (the mpirun-local-mode analog; see
``launch/local_executor.py``), with ``--max-restarts`` through the elastic
reconcile loop (``launch/elastic.py``). ``watch`` applies the job and
reconciles it on a cluster (``launch/watch.py``). The ``--apply`` path
shells to kubectl like ``deploy_stack.sh:46`` does, but validates first.
``serve`` and ``storm`` pass through to ``serve/cli.py`` and
``serve/storm.py``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

from k8s_distributed_deeplearning_torch.config import JobConfig
from k8s_distributed_deeplearning_torch.launch import render, validate


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        # The serving CLI has its own argument surface (model preset,
        # workload shape) rather than the JobConfig manifest knobs — and
        # importing torch eagerly here would slow every render/validate
        # call.
        from k8s_distributed_deeplearning_torch.serve import cli as serve_cli
        return serve_cli.main(argv[1:])
    if argv and argv[0] == "storm":
        # Same deal for the chaos soak: its own flag surface, and the
        # heavy model imports stay behind its argument validation.
        from k8s_distributed_deeplearning_torch.serve import storm as storm_cli
        return storm_cli.main(argv[1:])
    script_args: list[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, script_args = argv[:i], argv[i + 1:]

    ap = argparse.ArgumentParser(prog="launch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = JobConfig()
    parsers = {}
    for name, help_ in (("render", "render job manifests to stdout"),
                        ("validate", "validate rendered manifests"),
                        ("run-local", "execute the rendered job locally"),
                        ("watch", "apply + reconcile the gang on-cluster "
                                  "(the MPI Operator's live loop)")):
        p = parsers[name] = sub.add_parser(name, help=help_)
        p.add_argument("--name", default=d.name)
        p.add_argument("--namespace", default=d.namespace)
        p.add_argument("--workers", type=int, default=d.num_workers)
        p.add_argument("--image", default=d.image)
        p.add_argument("--script", default=d.script)
        p.add_argument("--gpus-per-worker", type=int,
                       default=d.gpus_per_worker,
                       help="nvidia.com/gpu cards each worker pod requests")
        p.add_argument("--gpu-accelerator", default=d.gpu_accelerator,
                       help="cloud.google.com/gke-accelerator node label "
                            "the engine-carrying pods select")
        p.add_argument("--cpu", default=d.cpu)
        p.add_argument("--memory", default=d.memory)
        p.add_argument(
            "--fleet-endpoints", default=d.fleet_endpoints,
            help="comma-separated serving-replica /metrics targets "
                 "(host:port); rendered as TPUJOB_FLEET_ENDPOINTS and "
                 "scraped each watch poll — replicas whose composite "
                 "health score drops below threshold are reported "
                 "(telemetry.fleet)")
        p.add_argument(
            "--termination-grace-s", type=int, default=d.termination_grace_s,
            help="pod terminationGracePeriodSeconds: the SIGTERM→SIGKILL "
                 "window the serving drain / preemption checkpoint runs "
                 "inside (default: omit the field, i.e. the k8s 30s)")
        p.add_argument(
            "--pre-stop-sleep-s", type=int, default=d.pre_stop_sleep_s,
            help="render a preStop exec hook sleeping this many seconds "
                 "before SIGTERM, letting the routing layer stop sending "
                 "new requests first; must be < the termination grace "
                 "period (validate enforces)")
        p.add_argument(
            "--serve-replicas", type=int, default=d.serve_replicas,
            help="also render the remote-serving tier: a headless Service "
                 "+ Indexed Job of N replica-server pods and a single-pod "
                 "gateway Job dispatching to them over HTTP "
                 "(serve/transport.py), probes split /readyz vs /healthz")
        p.add_argument(
            "--serve-prefill-replicas", type=int,
            default=d.serve_prefill_replicas,
            help="with --serve-replicas: also render the disaggregated "
                 "prefill tier (serve/disagg.py) — a headless Service + "
                 "Indexed Job of N prefill-role replica-server pods "
                 "(--role prefill), with the gateway pod running the "
                 "disagg coordinator (--disagg --prefill-endpoints) "
                 "that ships finished KV pages to the decode tier")
        p.add_argument(
            "--serve-preset", default=d.serve_preset,
            choices=["tiny", "small"],
            help="model preset the replica-server pods load")
        p.add_argument(
            "--serve-slots", type=int, default=d.serve_slots,
            help="decode slots per serving replica (default: the serve "
                 "CLI's own default)")
        p.add_argument(
            "--storm-steps", type=int, default=d.storm_steps,
            help="also render the graftstorm chaos-soak Job "
                 "(serve/storm.py): one pod running `launch storm` for "
                 "this many harness steps — seeded traffic + seeded "
                 "faults + the invariant monitor, exit 1 on violation")
        p.add_argument(
            "--storm-seed", type=int, default=d.storm_seed,
            help="the soak's replay key (printed in every violation's "
                 "repro line); default 0")
        p.add_argument(
            "--storm-fault-rate", type=float, default=d.storm_fault_rate,
            help="upper per-visit firing probability for the soak's "
                 "scheduled faults (0 < rate <= 1)")
        p.add_argument(
            "--serve-tp", type=int, default=d.serve_tp,
            help="tensor-parallel width per serving replica: each replica "
                 "pod requests this many cards and its serve CLI runs "
                 "--tp, one process a card (serve/tp.py)")
        p.add_argument(
            "--kv-quant", default=d.kv_quant, choices=["int8"],
            help="quantize the serving replicas' paged KV pool "
                 "(graftquant): rendered as TPUJOB_KV_QUANT + --kv-quant "
                 "on every serve-tier pod; validate sizes the pool with "
                 "int8 pages + f32 scales instead of the fp estimate")
        p.add_argument(
            "--weight-quant", default=d.weight_quant, choices=["int8"],
            help="per-channel int8 serving weights on the replica pods "
                 "(rendered as TPUJOB_WEIGHT_QUANT + --weight-quant)")
    parsers["render"].add_argument(
        "--apply", action="store_true",
        help="pipe the manifests into kubectl apply -f -")
    parsers["watch"].add_argument(
        "--max-restarts", type=int, default=3,
        help="reconcile attempts before giving up")
    parsers["watch"].add_argument(
        "--attempt-timeout", type=float, default=1800.0,
        help="seconds without completion before the gang counts as broken")
    parsers["watch"].add_argument(
        "--poll-interval", type=float, default=5.0)
    parsers["watch"].add_argument(
        "--resize-to", type=int, default=None,
        help="world size to restart failed gangs at (default: same size)")
    parsers["watch"].add_argument(
        "--no-apply", dest="apply_first", action="store_false",
        help="reconcile an already-applied job instead of applying first")
    parsers["watch"].add_argument(
        "--heartbeat-dir", default=None,
        help="directory of per-rank heartbeat files (telemetry.heartbeat);"
             " stale ranks are reported with their last-completed span")
    parsers["watch"].add_argument(
        "--heartbeat-stale-after", type=float, default=120.0,
        help="seconds without a heartbeat before a rank counts as stalled")
    parsers["watch"].add_argument(
        "--straggler-lag-steps", type=int, default=None,
        help="report a live rank whose heartbeat step trails the gang's "
             "max by more than this many steps (requires --heartbeat-dir; "
             "default: off)")
    parsers["run-local"].add_argument("--timeout", type=int, default=600)
    parsers["run-local"].add_argument(
        "--max-restarts", type=int, default=0,
        help="elastic reconcile: restart a failed gang up to N times "
             "(workers resume from their checkpoint dir)")
    parsers["run-local"].add_argument(
        "--resize-to", type=int, default=None,
        help="with --max-restarts: world size to restart a failed gang at "
             "(default: same size)")
    args = ap.parse_args(argv)

    cfg = JobConfig(name=args.name, namespace=args.namespace,
                    num_workers=args.workers, image=args.image,
                    script=args.script, script_args=script_args,
                    gpus_per_worker=args.gpus_per_worker,
                    gpu_accelerator=args.gpu_accelerator,
                    cpu=args.cpu, memory=args.memory,
                    fleet_endpoints=args.fleet_endpoints,
                    termination_grace_s=args.termination_grace_s,
                    pre_stop_sleep_s=args.pre_stop_sleep_s,
                    serve_replicas=args.serve_replicas,
                    serve_prefill_replicas=args.serve_prefill_replicas,
                    serve_preset=args.serve_preset,
                    serve_slots=args.serve_slots,
                    serve_tp=args.serve_tp,
                    kv_quant=args.kv_quant,
                    weight_quant=args.weight_quant,
                    storm_steps=args.storm_steps,
                    storm_seed=args.storm_seed,
                    storm_fault_rate=args.storm_fault_rate)
    docs = render.render_all(cfg)
    text = render.to_yaml(docs)

    if args.cmd == "validate":
        errors = validate.validate(docs)
        for e in errors:
            print(f"ERROR: {e}", file=sys.stderr)
        if not errors:
            print(f"offline validation: OK ({len(docs)} objects)")
            if validate.kubectl_available():
                ok, out = validate.kubectl_validate(text)
                print(f"kubectl server dry-run: {'OK' if ok else 'FAILED'}")
                if not ok:
                    print(out, file=sys.stderr)
                    return 1
        return 1 if errors else 0

    if args.cmd == "watch":
        from k8s_distributed_deeplearning_torch.launch import watch as watch_mod
        try:
            result = watch_mod.watch(
                cfg,
                resize=(watch_mod.resize_to(args.resize_to)
                        if args.resize_to else None),
                max_restarts=args.max_restarts,
                attempt_timeout=args.attempt_timeout,
                poll_interval=args.poll_interval,
                apply_first=args.apply_first,
                heartbeat_dir=args.heartbeat_dir,
                heartbeat_stale_after=args.heartbeat_stale_after,
                straggler_lag_steps=args.straggler_lag_steps,
                fleet_endpoints=(args.fleet_endpoints.split(",")
                                 if args.fleet_endpoints else None),
                on_event=lambda m: print(f"watch: {m}", file=sys.stderr))
        except (RuntimeError, ValueError) as e:
            print(f"watch failed: {e}", file=sys.stderr)
            return 1
        print(f"job {result.cfg.name} complete at world size "
              f"{result.cfg.num_workers} ({result.restarts} restart(s))")
        return 0

    if args.cmd == "run-local":
        from k8s_distributed_deeplearning_torch.launch import local_executor
        if args.max_restarts:
            from k8s_distributed_deeplearning_torch.launch import elastic
            try:
                results, n = elastic.run_elastic(
                    cfg, max_restarts=args.max_restarts, timeout=args.timeout,
                    resize=(elastic.resize_to(args.resize_to)
                            if args.resize_to else None))
            except RuntimeError as e:
                print(f"elastic run failed: {e}", file=sys.stderr)
                return 1
            if n:
                print(f"gang restarted {n} time(s)", file=sys.stderr)
        else:
            results = local_executor.run_local(cfg, timeout=args.timeout)
        for r in results:
            sys.stdout.write(r.stdout)
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-4000:])
                print(f"worker {r.index} exited {r.returncode}",
                      file=sys.stderr)
        # max() would mask signal deaths (negative returncodes) behind a
        # clean worker's 0 — any non-zero worker fails the gang.
        return 0 if all(r.returncode == 0 for r in results) else 1

    if not args.apply:
        print(text)
        return 0
    validate.validate_or_raise(docs)
    proc = subprocess.run(["kubectl", "apply", "-f", "-"], input=text,
                          text=True)
    return proc.returncode


if __name__ == "__main__":
    raise SystemExit(main())
