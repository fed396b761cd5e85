"""graftscope's analysis plane: turn raw per-rank span JSONL into
answers.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
timeline.py``, unchanged in behaviour: the same JSONL gives the same
timelines, attributions, summaries and Perfetto trace from either
package, whichever package wrote the logs.

The emission plane (`telemetry/trace.py` + `utils/metrics.py`) writes one
JSON object per line per event; Loki stores them; nothing *consumes* them.
This module is the consumer. It reconstructs per-step cross-rank
timelines from span events, attributes stragglers (which rank made step N
slow, and which span on that rank), computes the critical-path breakdown
(data_wait vs compute vs checkpoint vs untraced gap), groups sampled
``request_trace`` lifecycle events, and exports Perfetto/Chrome
``trace_event`` JSON for the trace viewer.

Two realities of the input shape everything here:

- **Clock skew.** Span events carry no wall timestamps — only
  ``elapsed_s``, monotonic seconds since that rank's *logger* was
  constructed. Two ranks' ``elapsed_s`` axes are unrelated (pods start
  minutes apart). So all cross-rank alignment happens on ``step`` field
  values: step 812 on rank 0 and step 812 on rank 3 are the same logical
  step regardless of what their clocks say. ``elapsed_s`` deltas are only
  ever compared *within* a rank.
- **Torn lines.** A rank killed mid-write (preemption, OOM) leaves a
  truncated final line; a restarted rank appends after it. The parser
  must skip what it cannot parse and keep going — a crashed rank's log is
  exactly the one you want to analyze.

Stdlib-only on purpose: graftscope must run on a laptop against scp'd
logs with no torch installed.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Any, Iterable

__all__ = [
    "Span", "ParsedLog", "StepRecord", "StepAttribution",
    "StitchedRequest",
    "parse_lines", "parse_files", "build_step_timelines",
    "attribute_stragglers", "critical_path", "straggler_summary",
    "requests_summary", "stitch_requests", "to_perfetto",
]

# The span that anchors a training step: one per step per rank, so its
# end-to-end spacing measures wall time per step within a rank.
ANCHOR_SPAN = "step"
# The pseudo-component for wall time no span accounts for (host Python,
# logging, untraced hooks).
UNTRACED = "untraced"


@dataclasses.dataclass
class Span:
    """One completed span, with the rank-local time axis reconstructed:
    ``end_s`` is the emit-time ``elapsed_s``; ``start_s`` backs off by the
    duration (spans log on close, so close time is the ground truth)."""
    name: str
    rank: int
    start_s: float
    end_s: float
    dur_ms: float
    depth: int = 0
    parent: str | None = None
    thread: str = "MainThread"
    step: int | None = None
    fields: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ParsedLog:
    """Everything extracted from one or more JSONL streams."""
    spans: list[Span] = dataclasses.field(default_factory=list)
    requests: list[dict] = dataclasses.field(default_factory=list)
    skipped: int = 0          # torn/unparseable lines
    total_lines: int = 0

    def ranks(self) -> list[int]:
        return sorted({s.rank for s in self.spans})

    def merge(self, other: "ParsedLog") -> "ParsedLog":
        self.spans.extend(other.spans)
        self.requests.extend(other.requests)
        self.skipped += other.skipped
        self.total_lines += other.total_lines
        return self


def parse_lines(lines: Iterable[str], *, default_rank: int = 0) -> ParsedLog:
    """Parse JSONL lines into spans and request traces.

    Tolerant by construction: a line that is not valid JSON, not an
    object, or a span missing its required numeric fields is *counted*
    (``skipped``) and dropped — never raised. Valid non-span events
    (train_step, checkpoint, ...) pass through silently; they are another
    consumer's business.
    """
    out = ParsedLog()
    for raw in lines:
        raw = raw.strip()
        if not raw:
            continue
        out.total_lines += 1
        try:
            rec = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            out.skipped += 1            # the torn final line of a killed rank
            continue
        if not isinstance(rec, dict):
            out.skipped += 1
            continue
        event = rec.get("event")
        if event == "span":
            span = _span_from(rec, default_rank)
            if span is None:
                out.skipped += 1
            else:
                out.spans.append(span)
        elif event == "request_trace":
            out.requests.append(rec)
    return out


def _span_from(rec: dict, default_rank: int) -> Span | None:
    try:
        name = rec["name"]
        dur_ms = float(rec["dur_ms"])
        end_s = float(rec["elapsed_s"])
    except (KeyError, TypeError, ValueError):
        return None
    step = rec.get("step")
    if step is not None:
        try:
            step = int(step)
        except (TypeError, ValueError):
            step = None
    known = {"event", "job", "elapsed_s", "name", "dur_ms", "depth",
             "parent", "rank", "thread", "step"}
    return Span(
        name=str(name),
        rank=int(rec.get("rank", default_rank)),
        start_s=end_s - dur_ms / 1e3,
        end_s=end_s,
        dur_ms=dur_ms,
        depth=int(rec.get("depth", 0) or 0),
        parent=rec.get("parent"),
        thread=str(rec.get("thread", "MainThread")),
        step=step,
        fields={k: v for k, v in rec.items() if k not in known})


def parse_files(paths: Iterable[str]) -> ParsedLog:
    """Parse and merge several JSONL files (typically one per rank, but
    interleaved multi-rank files work too — ``rank`` is read per event).
    The file's position in *paths* is the fallback rank for events that
    never stamped one."""
    merged = ParsedLog()
    for i, path in enumerate(paths):
        with open(path, "r", errors="replace") as f:
            merged.merge(parse_lines(f, default_rank=i))
    return merged


# ---------------------------------------------------------------------------
# Step timelines


@dataclasses.dataclass
class StepRecord:
    """One rank's view of one training step: summed span milliseconds per
    component plus the wall envelope.

    ``wall_ms`` is the spacing between this step's anchor-span close and
    the previous step's — within-rank ``elapsed_s`` deltas, so clock skew
    cancels. The first step seen per rank has no predecessor; its wall is
    its traced total (gap 0) rather than a fabricated number.
    ``gap_ms`` is the untraced remainder: wall minus every traced
    top-level millisecond."""
    step: int
    rank: int
    components: dict[str, float]
    wall_ms: float
    gap_ms: float

    @property
    def traced_ms(self) -> float:
        return sum(self.components.values())

    def breakdown(self) -> dict[str, float]:
        """Components plus the untraced pseudo-component."""
        return {**self.components, UNTRACED: self.gap_ms}


def build_step_timelines(parsed: ParsedLog,
                         anchor: str = ANCHOR_SPAN
                         ) -> dict[int, dict[int, StepRecord]]:
    """``{step: {rank: StepRecord}}`` from step-stamped spans.

    Only top-level spans (depth 0) are summed into components — a nested
    span's time is already inside its parent's, and double-counting would
    push ``gap_ms`` negative.
    """
    by_rank_step: dict[tuple[int, int], dict[str, float]] = {}
    anchor_end: dict[tuple[int, int], float] = {}
    for s in parsed.spans:
        if s.step is None:
            continue
        key = (s.rank, s.step)
        if s.depth == 0:
            comps = by_rank_step.setdefault(key, {})
            comps[s.name] = comps.get(s.name, 0.0) + s.dur_ms
        if s.name == anchor:
            anchor_end[key] = max(anchor_end.get(key, 0.0), s.end_s)

    timelines: dict[int, dict[int, StepRecord]] = {}
    prev_end: dict[int, tuple[int, float]] = {}   # rank -> (step, end_s)
    for (rank, step) in sorted(by_rank_step, key=lambda k: (k[0], k[1])):
        comps = by_rank_step[(rank, step)]
        traced = sum(comps.values())
        end = anchor_end.get((rank, step))
        wall = traced
        if end is not None and rank in prev_end:
            p_step, p_end = prev_end[rank]
            if step > p_step:
                # Normalize to per-step wall so a gap in the log (missing
                # steps under min_dur filtering) doesn't masquerade as one
                # enormous step.
                wall = (end - p_end) * 1e3 / (step - p_step)
        if end is not None:
            prev_end[rank] = (step, end)
        timelines.setdefault(step, {})[rank] = StepRecord(
            step=step, rank=rank, components=comps, wall_ms=wall,
            gap_ms=max(0.0, wall - traced))
    return timelines


# ---------------------------------------------------------------------------
# Straggler attribution


@dataclasses.dataclass
class StepAttribution:
    """Who made this step slow, and why.

    ``span`` is the component (span name, or ``"untraced"``) on the
    slowest rank with the largest excess over that component's cross-rank
    median — the "span that made it slow". ``lag_ms`` is the slowest
    rank's wall over the cross-rank median wall."""
    step: int
    slowest_rank: int
    wall_ms: float
    median_wall_ms: float
    lag_ms: float
    span: str
    span_excess_ms: float
    ranks: int

    def is_straggler(self, threshold_ms: float = 0.0,
                     ratio: float = 1.0) -> bool:
        return (self.lag_ms > threshold_ms
                and self.wall_ms > self.median_wall_ms * ratio)


def attribute_stragglers(timelines: dict[int, dict[int, StepRecord]]
                         ) -> list[StepAttribution]:
    """Per-step straggler attribution across ranks.

    Steps seen by fewer than two ranks are skipped — "straggler" is a
    relative claim and needs a peer to compare against.
    """
    out: list[StepAttribution] = []
    for step in sorted(timelines):
        per_rank = timelines[step]
        if len(per_rank) < 2:
            continue
        walls = {r: rec.wall_ms for r, rec in per_rank.items()}
        slowest = max(walls, key=lambda r: walls[r])
        median_wall = statistics.median(walls.values())
        slow_rec = per_rank[slowest]
        # For each component the slow rank spent time in, how far over
        # the cross-rank median is it? The biggest excess is the culprit.
        names = set(slow_rec.breakdown())
        for rec in per_rank.values():
            names.update(rec.breakdown())
        best_name, best_excess = UNTRACED, 0.0
        for name in sorted(names):
            vals = [per_rank[r].breakdown().get(name, 0.0) for r in per_rank]
            excess = (slow_rec.breakdown().get(name, 0.0)
                      - statistics.median(vals))
            if excess > best_excess:
                best_name, best_excess = name, excess
        out.append(StepAttribution(
            step=step, slowest_rank=slowest, wall_ms=walls[slowest],
            median_wall_ms=median_wall,
            lag_ms=walls[slowest] - median_wall,
            span=best_name, span_excess_ms=best_excess,
            ranks=len(per_rank)))
    return out


def straggler_summary(attributions: list[StepAttribution],
                      threshold_ms: float = 0.0,
                      ratio: float = 1.2) -> dict:
    """Aggregate attribution over a run: how many steps strayed, which
    (rank, span) pairs keep showing up, and the single worst step.
    *ratio* filters noise — a step only counts when the slowest rank's
    wall exceeds ``ratio`` × the median (and ``threshold_ms`` absolute)."""
    straggler_steps = [a for a in attributions
                       if a.is_straggler(threshold_ms, ratio)]
    culprits: dict[str, int] = {}
    for a in straggler_steps:
        key = f"rank{a.slowest_rank}:{a.span}"
        culprits[key] = culprits.get(key, 0) + 1
    worst = max(straggler_steps, key=lambda a: a.lag_ms, default=None)
    return {
        "steps_analyzed": len(attributions),
        "straggler_steps": len(straggler_steps),
        "culprits": dict(sorted(culprits.items(),
                                key=lambda kv: -kv[1])),
        "worst": (None if worst is None else {
            "step": worst.step, "rank": worst.slowest_rank,
            "span": worst.span, "lag_ms": round(worst.lag_ms, 3)}),
    }


def critical_path(timelines: dict[int, dict[int, StepRecord]]
                  ) -> dict[str, float]:
    """Where the run's wall time went, as the synchronous-SPMD critical
    path: each step costs what its *slowest* rank spent (the collective
    waits for everyone), broken down by that rank's components."""
    totals: dict[str, float] = {}
    for step in sorted(timelines):
        per_rank = timelines[step]
        slowest = max(per_rank.values(), key=lambda rec: rec.wall_ms)
        for name, ms in slowest.breakdown().items():
            totals[name] = totals.get(name, 0.0) + ms
    return {k: round(v, 3) for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])}


# ---------------------------------------------------------------------------
# Request traces


def requests_summary(parsed: ParsedLog) -> dict:
    """Group sampled ``request_trace`` events by tenant: volume, queue /
    TTFT percentiles, throughput, finish reasons."""
    by_tenant: dict[str, list[dict]] = {}
    for r in parsed.requests:
        by_tenant.setdefault(str(r.get("tenant", "default")), []).append(r)

    def pct(xs: list[float], q: float) -> float | None:
        xs = sorted(x for x in xs if x is not None)
        if not xs:
            return None
        return round(xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))], 3)

    tenants = {}
    for tenant, recs in sorted(by_tenant.items()):
        reasons: dict[str, int] = {}
        for r in recs:
            reason = str(r.get("finish_reason"))
            reasons[reason] = reasons.get(reason, 0) + 1
        tenants[tenant] = {
            "requests": len(recs),
            "queue_p50_ms": pct([r.get("queue_ms") for r in recs], 0.5),
            "queue_p95_ms": pct([r.get("queue_ms") for r in recs], 0.95),
            "ttft_p50_ms": pct([r.get("ttft_ms") for r in recs], 0.5),
            "ttft_p95_ms": pct([r.get("ttft_ms") for r in recs], 0.95),
            "latency_p95_ms": pct([r.get("latency_ms") for r in recs], 0.95),
            "mean_prefill_chunks": (round(statistics.fmean(
                [r.get("prefill_chunks", 0) or 0 for r in recs]), 2)),
            "tokens_per_s_p50": pct(
                [r.get("tokens_per_s") for r in recs], 0.5),
            "finish_reasons": reasons,
        }
    return {"requests": len(parsed.requests), "tenants": tenants}


# ---------------------------------------------------------------------------
# Cross-replica request stitching


@dataclasses.dataclass
class StitchedRequest:
    """One logical request's journey across however many replicas served
    it, stitched on ``trace_id`` (which ``Request.resume_from_tokens``
    preserves across a migration while ``request_id`` changes).

    ``hops`` holds the raw ``request_trace`` dicts in journey order: hop
    0 is where the request first ran; each later hop is the survivor a
    breaker-trip migration landed it on. Replica clocks are unrelated
    (per-logger monotonic), so the stitched view is *logical* — hop
    durations are each replica's own measurement, never cross-replica
    wall deltas."""
    trace_id: str
    hops: list[dict]

    @property
    def tenant(self) -> str:
        return str(self.hops[-1].get("tenant", "default"))

    @property
    def migrations(self) -> int:
        return len(self.hops) - 1

    @property
    def replicas(self) -> list[str]:
        return [str(h.get("replica")) for h in self.hops]

    @property
    def request_ids(self) -> list[str]:
        return [str(h.get("request_id")) for h in self.hops]

    @property
    def finish_reason(self) -> str:
        return str(self.hops[-1].get("finish_reason"))

    @property
    def total_latency_ms(self) -> float:
        return round(sum(float(h.get("latency_ms") or 0.0)
                         for h in self.hops), 3)

    @property
    def total_new_tokens(self) -> int:
        return sum(int(h.get("new_tokens") or 0) for h in self.hops)


def _chain_hops(recs: list[dict]) -> list[dict]:
    """Order one trace's records into the migration chain: the root is
    the record with no ``migrated_from``; each successor is the record
    whose ``migrated_from`` names the previous hop's replica. Records the
    chain cannot place (lost dump, torn log) append in input order —
    better a complete-but-loosely-ordered journey than a dropped hop."""
    if len(recs) <= 1:
        return list(recs)
    remaining = list(recs)
    roots = [r for r in remaining if not r.get("migrated_from")]
    cur = roots[0] if roots else remaining[0]
    ordered = [cur]
    remaining.remove(cur)
    while remaining:
        nxt = next((r for r in remaining
                    if r.get("migrated_from") is not None
                    and r.get("migrated_from") == ordered[-1].get("replica")),
                   None)
        if nxt is None:
            ordered.extend(remaining)
            break
        ordered.append(nxt)
        remaining.remove(nxt)
    return ordered


def stitch_requests(parsed: ParsedLog) -> list[StitchedRequest]:
    """Group ``request_trace`` events into per-journey
    :class:`StitchedRequest` records, keyed on ``trace_id``.

    Events from logs predating the trace-id stamp fall back to
    ``request_id`` as the group key — they still render, they just can't
    stitch across a migration (the survivor mints a new request_id).
    First-seen order is preserved so output is stable across runs."""
    groups: dict[str, list[dict]] = {}
    order: list[str] = []
    for r in parsed.requests:
        key = str(r.get("trace_id") or r.get("request_id") or "?")
        if key not in groups:
            order.append(key)
        groups.setdefault(key, []).append(r)
    return [StitchedRequest(trace_id=key, hops=_chain_hops(groups[key]))
            for key in order]


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace_event export


def _rank_offsets(parsed: ParsedLog, anchor: str) -> dict[int, float]:
    """Per-rank additive offsets (seconds) aligning rank clocks on the
    earliest step every rank traced: after shifting, the anchor span of
    that step *ends* at the same instant on every track. Falls back to
    zero offsets when the logs share no step (e.g. serve-only logs)."""
    anchor_end: dict[int, dict[int, float]] = {}
    for s in parsed.spans:
        if s.name == anchor and s.step is not None:
            anchor_end.setdefault(s.rank, {})[s.step] = s.end_s
    ranks = parsed.ranks()
    if not anchor_end or any(r not in anchor_end for r in ranks):
        return {r: 0.0 for r in ranks}
    common = set.intersection(*(set(v) for v in anchor_end.values()))
    if not common:
        return {r: 0.0 for r in ranks}
    pivot = min(common)
    ref = max(anchor_end[r][pivot] for r in anchor_end)
    return {r: ref - anchor_end[r][pivot] for r in anchor_end}


def to_perfetto(parsed: ParsedLog, anchor: str = ANCHOR_SPAN) -> dict:
    """Export as Chrome/Perfetto ``trace_event`` JSON (the "JSON Array
    Format" with object envelope): one process per rank, one thread per
    traced thread, spans as complete ("ph": "X") slices with ``ts``/
    ``dur`` in microseconds, and request traces as their own process with
    queue/prefill/decode child slices.

    Load with https://ui.perfetto.dev or chrome://tracing.
    """
    events: list[dict] = []
    offsets = _rank_offsets(parsed, anchor)
    tids: dict[tuple[int, str], int] = {}
    for rank in parsed.ranks():
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
    for s in parsed.spans:
        tid_key = (s.rank, s.thread)
        if tid_key not in tids:
            tids[tid_key] = len([k for k in tids if k[0] == s.rank]) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": s.rank,
                           "tid": tids[tid_key],
                           "args": {"name": s.thread}})
        args: dict[str, Any] = dict(s.fields)
        if s.step is not None:
            args["step"] = s.step
        events.append({
            "ph": "X", "name": s.name, "cat": "span",
            "pid": s.rank, "tid": tids[tid_key],
            "ts": round((s.start_s + offsets.get(s.rank, 0.0)) * 1e6, 3),
            "dur": round(s.dur_ms * 1e3, 3),
            "args": args})

    if parsed.requests:
        req_pid = (max(parsed.ranks()) + 1) if parsed.spans else 0
        events.append({"ph": "M", "name": "process_name", "pid": req_pid,
                       "tid": 0, "args": {"name": "requests"}})
        # One thread per stitched journey: a migrated request's hops lay
        # back-to-back on one track instead of scattering across tracks
        # with unrelated replica clocks. Hop 0 anchors the track at its
        # own reconstructed start; each later hop starts where the
        # previous ended — its queue phase renders as "migration" (the
        # window between the gateway's resubmit and the survivor's
        # admission, which is exactly what the survivor's queue_ms
        # measures for a resumed request).
        for i, sr in enumerate(stitch_requests(parsed)):
            tid = i + 1
            label = (sr.trace_id if sr.migrations
                     else str(sr.hops[0].get("request_id", sr.trace_id)))
            events.append({"ph": "M", "name": "thread_name", "pid": req_pid,
                           "tid": tid, "args": {"name": label}})
            cursor: float | None = None     # track-local cursor, us
            for j, r in enumerate(sr.hops):
                try:
                    end_s = float(r["elapsed_s"])
                    latency_ms = float(r.get("latency_ms") or 0.0)
                except (KeyError, TypeError, ValueError):
                    continue
                dur_us = latency_ms * 1e3
                t0 = ((end_s - latency_ms / 1e3) * 1e6 if cursor is None
                      else cursor)
                cursor = t0 + dur_us
                rid = str(r.get("request_id", f"req-{i}"))
                name = (f"{rid} @ {r.get('replica')}" if sr.migrations
                        else rid)
                events.append({"ph": "X", "name": name, "cat": "request",
                               "pid": req_pid, "tid": tid,
                               "ts": round(t0, 3),
                               "dur": round(dur_us, 3),
                               "args": {k: v for k, v in r.items()
                                        if k not in ("event", "job")}})
                # Child slices: queue/migration → prefill → decode.
                queue_us = float(r.get("queue_ms") or 0.0) * 1e3
                ttft_us = float(r.get("ttft_ms") or 0.0) * 1e3
                first = ("queue" if not (j and r.get("migrated_from"))
                         else "migration")
                phases = [(first, 0.0, queue_us),
                          ("prefill", queue_us, max(ttft_us, queue_us)),
                          ("decode", max(ttft_us, queue_us), dur_us)]
                for pname, lo, hi in phases:
                    if hi > lo:
                        events.append({"ph": "X", "name": pname,
                                       "cat": "request_phase",
                                       "pid": req_pid, "tid": tid,
                                       "ts": round(t0 + lo, 3),
                                       "dur": round(hi - lo, 3), "args": {}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
