"""graftscope CLI: analyze per-rank span/event JSONL offline.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
graftscope.py``: the same commands, flags, text and JSON, over the port's
``timeline``, ``flight``, ``fleet`` and ``slo``. Run it as
``python -m k8s_distributed_deeplearning_torch.telemetry.graftscope``.

The workflow the README documents::

    # capture: run with --trace --metrics-path (or scrape /debug/spans),
    # one JSONL file per rank
    graftscope steps rank0.jsonl rank1.jsonl ...   # straggler attribution
    graftscope requests 'logs/replica-*.jsonl'     # stitched lifecycles
    graftscope export-perfetto *.jsonl -o trace.json   # → ui.perfetto.dev
    graftscope fleet host1:9090 host2:9090         # live fleet health/SLO
    graftscope postmortem flight-*.jsonl           # who held what at death

Log arguments are shell-style globs as well as literal paths (quote them
to stop your shell expanding first; useful over ssh). Feeding
``requests`` every replica's log at once is the point: a request that
migrated across a breaker trip appears once per replica under one
``trace_id``, and the stitched view reassembles the journey.

Stdlib-only (no torch): runs on a laptop against scp'd logs (``fleet``
scrapes live ``/metrics`` endpoints instead). All the offline analysis
lives in :mod:`telemetry.timeline`; this module is formatting.
"""
from __future__ import annotations

import argparse
import glob as _glob
import json
import sys

from k8s_distributed_deeplearning_torch.telemetry import flight as flight_mod
from k8s_distributed_deeplearning_torch.telemetry import timeline


def _expand_logs(patterns: list[str]) -> list[str]:
    """Expand each argument as a glob (recursive ``**`` allowed), keeping
    first-seen order and deduping. A pattern matching nothing passes
    through literally so ``open()`` raises the honest FileNotFoundError
    instead of the tool silently analyzing fewer logs than asked."""
    out: list[str] = []
    seen: set[str] = set()
    for pat in patterns:
        matches = sorted(_glob.glob(pat, recursive=True)) or [pat]
        for m in matches:
            if m not in seen:
                seen.add(m)
                out.append(m)
    return out


def _fmt_ms(v: float | None) -> str:
    return "-" if v is None else f"{v:9.2f}"


def _cmd_steps(args: argparse.Namespace) -> int:
    parsed = timeline.parse_files(_expand_logs(args.logs))
    if parsed.skipped:
        print(f"note: skipped {parsed.skipped} unparseable line(s) "
              f"of {parsed.total_lines} (torn writes from killed ranks?)",
              file=sys.stderr)
    timelines = timeline.build_step_timelines(parsed)
    attrs = timeline.attribute_stragglers(timelines)
    summary = timeline.straggler_summary(
        attrs, threshold_ms=args.threshold_ms, ratio=args.ratio)
    path = timeline.critical_path(timelines)
    if args.json:
        json.dump({"steps": len(timelines), "ranks": parsed.ranks(),
                   "skipped_lines": parsed.skipped,
                   "critical_path_ms": path, "stragglers": summary,
                   "attributions": [vars(a) for a in attrs]},
                  sys.stdout, indent=2, default=str)
        print()
        return 0
    if not timelines:
        print("no step-stamped spans found — was tracing enabled "
              "(--trace), and do spans carry step= fields?")
        return 1
    print(f"{len(timelines)} steps across ranks {parsed.ranks()}")
    print("\ncritical path (slowest rank per step, summed):")
    total = sum(path.values()) or 1.0
    for name, ms in path.items():
        print(f"  {name:<12} {ms:10.1f} ms  {100 * ms / total:5.1f}%")
    print(f"\nstraggler steps (wall > {args.ratio}x median "
          f"+ {args.threshold_ms} ms): "
          f"{summary['straggler_steps']}/{summary['steps_analyzed']}")
    for culprit, n in summary["culprits"].items():
        print(f"  {culprit:<24} {n} step(s)")
    if summary["worst"]:
        w = summary["worst"]
        print(f"  worst: step {w['step']} — rank {w['rank']} "
              f"+{w['lag_ms']:.1f} ms in {w['span']}")
    if args.verbose:
        print("\nper-step attribution (slowest rank vs median):")
        print(f"  {'step':>6} {'rank':>4} {'wall_ms':>9} {'median':>9} "
              f"{'lag':>9}  span")
        for a in attrs:
            print(f"  {a.step:>6} {a.slowest_rank:>4} "
                  f"{_fmt_ms(a.wall_ms)} {_fmt_ms(a.median_wall_ms)} "
                  f"{_fmt_ms(a.lag_ms)}  {a.span} "
                  f"(+{a.span_excess_ms:.1f} ms)")
    return 0


def _stitched_json(sr: "timeline.StitchedRequest") -> dict:
    return {"trace_id": sr.trace_id, "tenant": sr.tenant,
            "migrations": sr.migrations, "replicas": sr.replicas,
            "request_ids": sr.request_ids,
            "finish_reason": sr.finish_reason,
            "total_latency_ms": sr.total_latency_ms,
            "total_new_tokens": sr.total_new_tokens,
            "hops": sr.hops}


def _cmd_requests(args: argparse.Namespace) -> int:
    parsed = timeline.parse_files(_expand_logs(args.logs))
    if parsed.skipped:
        print(f"note: skipped {parsed.skipped} unparseable line(s)",
              file=sys.stderr)
    summary = timeline.requests_summary(parsed)
    stitched = timeline.stitch_requests(parsed)
    migrated = [sr for sr in stitched if sr.migrations]
    if args.json:
        json.dump({**summary,
                   "journeys": len(stitched),
                   "migrated": [_stitched_json(sr) for sr in migrated]},
                  sys.stdout, indent=2)
        print()
        return 0
    if not summary["requests"]:
        print("no request_trace events found — was the engine run with "
              "request_trace_sample > 0?")
        return 1
    print(f"{summary['requests']} sampled request trace(s), "
          f"{len(stitched)} journey(s), {len(migrated)} migrated")
    for tenant, t in summary["tenants"].items():
        print(f"\ntenant {tenant} ({t['requests']} requests):")
        print(f"  queue   p50 {_fmt_ms(t['queue_p50_ms'])} ms   "
              f"p95 {_fmt_ms(t['queue_p95_ms'])} ms")
        print(f"  ttft    p50 {_fmt_ms(t['ttft_p50_ms'])} ms   "
              f"p95 {_fmt_ms(t['ttft_p95_ms'])} ms")
        print(f"  latency p95 {_fmt_ms(t['latency_p95_ms'])} ms   "
              f"tokens/s p50 {t['tokens_per_s_p50']}")
        print(f"  prefill chunks (mean): {t['mean_prefill_chunks']}   "
              f"finish: {t['finish_reasons']}")
    if migrated:
        print("\nmigrated requests (hops stitched on trace_id):")
        for sr in migrated:
            print(f"\n  {sr.trace_id}  tenant {sr.tenant}  "
                  f"{sr.migrations} migration(s)  "
                  f"{sr.total_latency_ms:.1f} ms total  "
                  f"finish: {sr.finish_reason}")
            for j, hop in enumerate(sr.hops):
                phase = ("queue" if not (j and hop.get("migrated_from"))
                         else "migration")
                arrow = ("  " if not j
                         else f"  -> (from {hop.get('migrated_from')}) ")
                print(f"  {arrow}hop {j}: {hop.get('replica')}  "
                      f"req {hop.get('request_id')}  "
                      f"{phase} {_fmt_ms(hop.get('queue_ms')).strip()} ms  "
                      f"ttft {_fmt_ms(hop.get('ttft_ms')).strip()} ms  "
                      f"total {_fmt_ms(hop.get('latency_ms')).strip()} ms  "
                      f"+{hop.get('new_tokens', 0)} tok")
    return 0


def _cmd_export_perfetto(args: argparse.Namespace) -> int:
    parsed = timeline.parse_files(_expand_logs(args.logs))
    if parsed.skipped:
        print(f"note: skipped {parsed.skipped} unparseable line(s)",
              file=sys.stderr)
    if not parsed.spans and not parsed.requests:
        print("nothing to export: no span or request_trace events found",
              file=sys.stderr)
        return 1
    trace = timeline.to_perfetto(parsed)
    with open(args.out, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace['traceEvents'])} trace events to {args.out} "
          f"(open at https://ui.perfetto.dev)")
    return 0


def _cmd_fleet(args: argparse.Namespace) -> int:
    from k8s_distributed_deeplearning_torch.telemetry import fleet as fl
    from k8s_distributed_deeplearning_torch.telemetry import slo as slo_mod

    endpoints = list(args.endpoints)
    if args.heartbeat_dir:
        endpoints += fl.discover_endpoints(args.heartbeat_dir)
    if not endpoints:
        print("no endpoints: pass host:port arguments or --heartbeat-dir "
              "with metrics_addr-carrying heartbeats", file=sys.stderr)
        return 1
    scraper = fl.FleetScraper(endpoints, timeout_s=args.timeout,
                              stale_after_s=args.stale_after)
    agg = fl.FleetAggregator(scraper)
    engine = None
    if args.tenants:
        from k8s_distributed_deeplearning_torch.serve.sched.tenant import (
            load_tenants)
        try:
            objectives = slo_mod.objectives_from_tenants(load_tenants(
                args.tenants))
        except (ValueError, OSError) as e:
            print(f"bad --tenants: {e}", file=sys.stderr)
            return 1
        if objectives:
            engine = slo_mod.SLOEngine(objectives)
    import time as _time
    for round_no in range(args.rounds):
        if round_no:
            _time.sleep(args.interval)
        scraper.poll()
        if engine is not None:
            fl.feed_slo(engine, agg)
            engine.evaluate()
    if args.json:
        print(agg.to_json(slo_engine=engine))
        return 0
    snap = agg.snapshot(slo_engine=engine)
    print(f"{'replica':<24} {'up':<4} {'health':>7}  components")
    for replica, rec in snap["replicas"].items():
        comps = " ".join(f"{k}={v}" for k, v in sorted(
            rec["components"].items()))
        flag = "" if rec["healthy"] else "  <-- UNHEALTHY"
        print(f"{replica:<24} {'yes' if rec['up'] else 'NO':<4} "
              f"{rec['health']:>7.3f}  {comps}{flag}")
    if snap["aggregates"]:
        print("\nfleet aggregates (unlabeled scalar families):")
        for name, agg_rec in snap["aggregates"].items():
            spread = (f"  min {agg_rec['min']} max {agg_rec['max']}"
                      if "min" in agg_rec else "")
            print(f"  {name:<40} sum {agg_rec['sum']}{spread}")
    if engine is not None:
        slo_snap = snap["slo"]
        print("\nSLO burn rates (threshold: "
              f"fast {slo_snap['thresholds']['fast']}, "
              f"slow {slo_snap['thresholds']['slow']}):")
        for tenant, rec in slo_snap["tenants"].items():
            burns = " ".join(f"{k}={v}" for k, v in sorted(
                rec["burn_rates"].items()))
            print(f"  {tenant:<16} {burns}")
        for alert in slo_snap["active_alerts"]:
            print(f"  ALERT {alert['tenant']}/{alert['sli']}"
                  f"/{alert['window']}: burn {alert['burn_rate']} > "
                  f"{alert['threshold']}")
    return 0


def _render_postmortem(path: str, header: dict, records: list[dict],
                       tail: int) -> None:
    print(f"flight dump {path}")
    print(f"  reason: {header.get('reason')}   job: {header.get('job')}   "
          f"records: {header.get('records')}   "
          f"dumped at t+{header.get('dumped_at_s')}s")
    if header.get("replica") is not None:
        print(f"  replica: {header['replica']}")
    if header.get("trip_error") is not None:
        print(f"  trip error: {header['trip_error']}")
    if header.get("site") is not None:
        print(f"  injected fault: site {header['site']!r} "
              f"action {header.get('action')!r}")
    breakers = header.get("breakers")
    if breakers:
        opens = [r for r, s in breakers.items() if s != "closed"]
        print(f"  breakers: " + "  ".join(
            f"{r}={s}" for r, s in sorted(breakers.items())))
        if opens:
            print(f"  NOT CLOSED at death: {', '.join(sorted(opens))}")
    pool = header.get("pool")
    if pool:
        print(f"  kv pool: {pool.get('pages_used')}/"
              f"{pool.get('pages_total')} pages used, "
              f"{pool.get('pages_shared')} shared, "
              f"{pool.get('pages_reserved', pool.get('reserved'))} reserved")
    by_owner = header.get("pages_by_owner")
    if by_owner:
        print("  pages held at death, by owner:")
        for owner, n in sorted(by_owner.items(), key=lambda kv: -kv[1]):
            print(f"    {owner:<10} {n}")
    held = header.get("pages_held")
    if held:
        for owner, pages in sorted(held.items()):
            if not pages:
                continue
            shown = ", ".join(str(p) for p in pages[:16])
            more = f" ... +{len(pages) - 16} more" if len(pages) > 16 else ""
            print(f"    {owner}: [{shown}{more}]")
    leak = header.get("leak")
    if leak:
        print(f"  LEAK ({leak.get('origin')}): "
              f"{leak.get('pages_leaked')} page(s) never returned, "
              f"by owner {leak.get('by_owner')}")
    if records and tail:
        print(f"\n  last {min(tail, len(records))} of {len(records)} "
              f"ring record(s):")
        for rec in records[-tail:]:
            src = rec.get("source", "?")
            rest = {k: v for k, v in rec.items()
                    if k not in ("source", "t_s")}
            print(f"    t+{rec.get('t_s')}s [{src}] "
                  + json.dumps(rest, default=str))


def _cmd_postmortem(args: argparse.Namespace) -> int:
    paths = _expand_logs(args.dumps)
    rc = 0
    out_json = []
    for i, path in enumerate(paths):
        try:
            header, records = flight_mod.load_dump(path)
        except (OSError, ValueError) as e:
            print(f"{path}: not a flight dump: {e}", file=sys.stderr)
            rc = 1
            continue
        if args.json:
            out_json.append({"path": path, "header": header,
                             "records": records})
            continue
        if i:
            print()
        _render_postmortem(path, header, records, args.tail)
    if args.json:
        json.dump(out_json, sys.stdout, indent=2, default=str)
        print()
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftscope",
        description="analyze per-rank span/event JSONL: cross-rank step "
                    "timelines, straggler attribution, request lifecycle "
                    "traces, Perfetto export")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "steps", help="per-step cross-rank timelines, critical-path "
                      "breakdown and straggler attribution")
    p.add_argument("logs", nargs="+", help="JSONL files (one per rank, or "
                                           "interleaved multi-rank)")
    p.add_argument("--threshold-ms", type=float, default=1.0,
                   help="minimum absolute lag over the median wall to "
                        "count a step as straggling (default 1 ms)")
    p.add_argument("--ratio", type=float, default=1.2,
                   help="minimum wall/median ratio to count a step as "
                        "straggling (default 1.2)")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="print every step's attribution, not just the "
                        "summary")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.set_defaults(fn=_cmd_steps)

    p = sub.add_parser(
        "requests", help="group sampled request_trace lifecycle events "
                         "by tenant, and stitch migrated requests' "
                         "per-replica hops into one journey via trace_id")
    p.add_argument("logs", nargs="+",
                   help="JSONL files or globs — pass every replica's log "
                        "to stitch cross-replica migrations")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_requests)

    p = sub.add_parser(
        "export-perfetto",
        help="export spans + request traces as Chrome/Perfetto "
             "trace_event JSON")
    p.add_argument("logs", nargs="+")
    p.add_argument("-o", "--out", default="trace.json",
                   help="output path (default trace.json)")
    p.set_defaults(fn=_cmd_export_perfetto)

    p = sub.add_parser(
        "fleet", help="scrape N replica /metrics endpoints and print "
                      "per-replica health scores, fleet aggregates and "
                      "per-tenant SLO burn rates")
    p.add_argument("endpoints", nargs="*",
                   help="replica scrape targets (host:port or URL)")
    p.add_argument("--heartbeat-dir",
                   help="discover endpoints from heartbeat records "
                        "carrying a metrics_addr field")
    p.add_argument("--tenants",
                   help="tenant config (inline JSON or @/path, the "
                        "TPUJOB_TENANTS schema) — tenants with an slo "
                        "block get burn-rate evaluation")
    p.add_argument("--rounds", type=int, default=2,
                   help="scrape rounds before printing (>= 2 gives the "
                        "SLO engine a delta to burn; default 2)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between scrape rounds (default 1)")
    p.add_argument("--timeout", type=float, default=2.0,
                   help="per-endpoint scrape timeout in seconds")
    p.add_argument("--stale-after", type=float, default=10.0,
                   help="seconds without a successful scrape before a "
                        "replica is marked down (health 0)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_fleet)

    p = sub.add_parser(
        "postmortem",
        help="render a flight-recorder dump: why it dumped, breaker "
             "states, KV pages held at death by owner, and the last ring "
             "snapshots")
    p.add_argument("dumps", nargs="+",
                   help="flight-*.jsonl dump files or globs")
    p.add_argument("--tail", type=int, default=5,
                   help="how many trailing ring records to print "
                        "(default 5; 0 for none)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_postmortem)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
