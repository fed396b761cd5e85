"""PyTorch port, graftscope: the offline readers of the JSONL stream
(``telemetry/timeline.py`` and the ``graftscope`` CLI) against the JAX
package's.

The JAX package's own reader cases (``tests/test_graftscope.py``: torn
lines, skew-proof step alignment, straggler attribution, the Perfetto
schema, the CLI, the tracer's thread-scoped ``last_span`` and ring) run
against the port's modules; then both packages' readers take the same
streams, one written by the JAX package's ``fit`` and ``MetricsLogger``
and one by the port's ``fit`` and serving engine, and every summary,
every CLI command's ``--json`` and its text must be equal. ``fleet`` runs
against a live port exporter, ``postmortem`` over a port flight dump, and
a fresh interpreter shows the offline commands never import torch.
"""
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from k8s_distributed_deeplearning_torch.telemetry import graftscope
from k8s_distributed_deeplearning_torch.telemetry import timeline
from k8s_distributed_deeplearning_torch.telemetry.exporter import (
    MetricsExporter)
from k8s_distributed_deeplearning_torch.telemetry.flight import (
    FlightRecorder)
from k8s_distributed_deeplearning_torch.telemetry.registry import (
    MetricsRegistry)
from k8s_distributed_deeplearning_torch.telemetry.trace import Tracer
from k8s_distributed_deeplearning_torch.utils.metrics import MetricsLogger
from k8s_distributed_deeplearning_tpu.telemetry import graftscope as j_scope
from k8s_distributed_deeplearning_tpu.telemetry import timeline as j_tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _span_line(name, dur_ms, elapsed_s, *, rank=0, step=None, depth=0,
               parent=None, thread="MainThread", **fields):
    rec = {"ts": "2026-01-01T00:00:00", "job": "train", "event": "span",
           "name": name, "dur_ms": dur_ms, "depth": depth, "parent": parent,
           "rank": rank, "thread": thread, "elapsed_s": elapsed_s}
    if step is not None:
        rec["step"] = step
    rec.update(fields)
    return json.dumps(rec)


def _rank_log(rank, *, t0, steps, data_wait_ms, step_ms, slow=()):
    """Synthetic per-rank JSONL: each step is data_wait then the anchor
    "step" span, on a clock starting at *t0* (per-rank skew). *slow*
    maps step -> extra data_wait ms for that step on this rank."""
    slow = dict(slow)
    lines, t = [], t0
    for s in range(steps):
        dw = data_wait_ms + slow.get(s, 0.0)
        t += dw / 1e3
        lines.append(_span_line("data_wait", dw, round(t, 6),
                                rank=rank, step=s))
        t += step_ms / 1e3
        lines.append(_span_line("step", step_ms, round(t, 6),
                                rank=rank, step=s))
    return lines


# ------------------------------------------- JAX's reader cases, on the port

def test_parse_lines_skips_torn_and_garbage_lines():
    good = _span_line("step", 80.0, 1.0, step=0)
    torn = _span_line("step", 80.0, 2.0, step=1)[:25]
    lines = [good, torn, "not json at all", "[1, 2, 3]",
             json.dumps({"event": "span", "name": "step"}),
             json.dumps({"event": "train_step", "step": 5, "loss": 0.1}),
             "", "   "]
    parsed = timeline.parse_lines(lines)
    assert [s.name for s in parsed.spans] == ["step"]
    assert parsed.skipped == 4
    assert parsed.total_lines == 6
    assert parsed.requests == []


def test_parse_files_torn_final_line_from_killed_rank(tmp_path):
    lines = _rank_log(0, t0=0.0, steps=4, data_wait_ms=5.0, step_ms=20.0)
    path = tmp_path / "rank0.jsonl"
    path.write_text("\n".join(lines[:-1]) + "\n" + lines[-1][:30])
    parsed = timeline.parse_files([str(path)])
    assert parsed.skipped == 1
    assert len(parsed.spans) == len(lines) - 1
    assert set(timeline.build_step_timelines(parsed)) == {0, 1, 2, 3}


def test_parse_files_interleaved_ranks_and_default_rank(tmp_path):
    r0 = _rank_log(0, t0=0.0, steps=2, data_wait_ms=5.0, step_ms=20.0)
    r1 = _rank_log(1, t0=500.0, steps=2, data_wait_ms=5.0, step_ms=20.0)
    mixed = tmp_path / "mixed.jsonl"
    mixed.write_text("\n".join(x for pair in zip(r0, r1) for x in pair))
    bare = tmp_path / "bare.jsonl"
    rec = json.loads(_span_line("step", 20.0, 1.0, step=0))
    del rec["rank"]
    bare.write_text(json.dumps(rec))
    parsed = timeline.parse_files([str(mixed), str(bare)])
    assert parsed.ranks() == [0, 1]
    assert sum(1 for s in parsed.spans if s.rank == 1) == 5


def test_step_timeline_wall_gap_and_nesting():
    lines = [
        _span_line("data_wait", 20.0, 0.92, step=0),
        _span_line("step", 80.0, 1.0, step=0),
        _span_line("data_wait", 20.0, 1.12, step=1),
        _span_line("allreduce", 30.0, 1.19, step=1, depth=1, parent="step"),
        _span_line("step", 80.0, 1.2, step=1),
    ]
    tl = timeline.build_step_timelines(timeline.parse_lines(lines))
    s0, s1 = tl[0][0], tl[1][0]
    assert s0.components == {"data_wait": 20.0, "step": 80.0}
    assert s0.wall_ms == pytest.approx(100.0) and s0.gap_ms == 0.0
    assert s1.components == {"data_wait": 20.0, "step": 80.0}
    assert s1.wall_ms == pytest.approx(200.0)
    assert s1.gap_ms == pytest.approx(100.0)
    assert s1.breakdown()[timeline.UNTRACED] == pytest.approx(100.0)


def test_step_alignment_survives_clock_skew():
    parsed = timeline.parse_lines(
        _rank_log(0, t0=0.0, steps=4, data_wait_ms=5.0, step_ms=20.0)
        + _rank_log(1, t0=7200.0, steps=4, data_wait_ms=5.0, step_ms=20.0))
    tl = timeline.build_step_timelines(parsed)
    assert set(tl) == {0, 1, 2, 3}
    for step in tl:
        assert set(tl[step]) == {0, 1}
        for rec in tl[step].values():
            assert rec.wall_ms == pytest.approx(25.0, abs=1e-6)
    attrs = timeline.attribute_stragglers(tl)
    assert not any(a.is_straggler(threshold_ms=1.0, ratio=1.2)
                   for a in attrs)


def test_straggler_attribution_names_rank_and_span():
    parsed = timeline.parse_lines(
        _rank_log(0, t0=0.0, steps=5, data_wait_ms=5.0, step_ms=20.0)
        + _rank_log(1, t0=50.0, steps=5, data_wait_ms=5.0, step_ms=20.0)
        + _rank_log(2, t0=90.0, steps=5, data_wait_ms=5.0, step_ms=20.0,
                    slow={2: 100.0, 3: 100.0}))
    tl = timeline.build_step_timelines(parsed)
    attrs = {a.step: a for a in timeline.attribute_stragglers(tl)}
    for step in (2, 3):
        a = attrs[step]
        assert a.slowest_rank == 2 and a.span == "data_wait"
        assert a.is_straggler(threshold_ms=10.0, ratio=1.2)
        assert a.lag_ms == pytest.approx(100.0, rel=0.05)
    summary = timeline.straggler_summary(list(attrs.values()),
                                         threshold_ms=10.0, ratio=1.2)
    assert summary["straggler_steps"] == 2
    assert summary["culprits"] == {"rank2:data_wait": 2}
    assert summary["worst"]["rank"] == 2
    assert summary["worst"]["span"] == "data_wait"
    path = timeline.critical_path(tl)
    assert path["data_wait"] == pytest.approx(5 * 5.0 + 2 * 100.0, rel=0.05)
    assert path["step"] == pytest.approx(5 * 20.0, rel=0.05)


def test_attribution_needs_two_ranks():
    parsed = timeline.parse_lines(
        _rank_log(0, t0=0.0, steps=3, data_wait_ms=5.0, step_ms=20.0))
    assert timeline.attribute_stragglers(
        timeline.build_step_timelines(parsed)) == []


def _assert_valid_trace_events(trace):
    assert isinstance(trace, dict)
    assert trace["displayTimeUnit"] in ("ms", "ns")
    events = trace["traceEvents"]
    assert isinstance(events, list) and events
    for ev in events:
        assert isinstance(ev, dict)
        assert ev["ph"] in ("X", "M")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str)
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
            assert isinstance(ev.get("args", {}), dict)
        else:
            assert ev["name"] in ("process_name", "thread_name")
            assert isinstance(ev["args"]["name"], str)


def test_perfetto_export_schema_and_rank_alignment():
    parsed = timeline.parse_lines(
        _rank_log(0, t0=0.0, steps=3, data_wait_ms=5.0, step_ms=20.0)
        + _rank_log(1, t0=3600.0, steps=3, data_wait_ms=5.0, step_ms=20.0))
    trace = timeline.to_perfetto(parsed)
    _assert_valid_trace_events(trace)
    json.loads(json.dumps(trace))
    ends = {}
    for ev in trace["traceEvents"]:
        if (ev["ph"] == "X" and ev["name"] == "step"
                and ev["args"].get("step") == 0):
            ends[ev["pid"]] = ev["ts"] + ev["dur"]
    assert set(ends) == {0, 1}
    assert ends[0] == pytest.approx(ends[1], abs=1.0)


def test_perfetto_request_track_with_phase_slices():
    req = {"ts": "t", "job": "serve", "event": "request_trace",
           "request_id": "req-7", "tenant": "default", "queue_ms": 10.0,
           "ttft_ms": 40.0, "latency_ms": 100.0, "new_tokens": 5,
           "finish_reason": "length", "elapsed_s": 2.0}
    parsed = timeline.parse_lines(
        _rank_log(0, t0=0.0, steps=2, data_wait_ms=5.0, step_ms=20.0)
        + [json.dumps(req)])
    trace = timeline.to_perfetto(parsed)
    _assert_valid_trace_events(trace)
    req_pid = max(e["pid"] for e in trace["traceEvents"])
    assert req_pid == 1
    names = [e["name"] for e in trace["traceEvents"]
             if e["pid"] == req_pid and e["ph"] == "X"]
    assert "req-7" in names
    phases = {e["name"]: e for e in trace["traceEvents"]
              if e["pid"] == req_pid and e.get("cat") == "request_phase"}
    assert set(phases) == {"queue", "prefill", "decode"}
    assert phases["queue"]["dur"] == pytest.approx(10e3)
    assert phases["prefill"]["dur"] == pytest.approx(30e3)
    assert phases["decode"]["dur"] == pytest.approx(60e3)


def test_graftscope_steps_cli(tmp_path, capsys):
    f0, f1 = tmp_path / "rank0.jsonl", tmp_path / "rank1.jsonl"
    f0.write_text("\n".join(
        _rank_log(0, t0=0.0, steps=5, data_wait_ms=5.0, step_ms=20.0)))
    lines1 = _rank_log(1, t0=99.0, steps=5, data_wait_ms=5.0, step_ms=20.0,
                       slow={3: 200.0})
    f1.write_text("\n".join(lines1) + "\n"
                  + _span_line("step", 1.0, 999.0, rank=1, step=9)[:20])
    rc = graftscope.main(["steps", str(f0), str(f1), "--threshold-ms", "10"])
    cap = capsys.readouterr()
    assert rc == 0
    assert "skipped 1 unparseable line" in cap.err
    assert "rank1:data_wait" in cap.out
    assert "critical path" in cap.out
    rc = graftscope.main(["steps", str(f0), str(f1), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["ranks"] == [0, 1] and out["skipped_lines"] == 1
    assert out["stragglers"]["worst"]["rank"] == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"event": "train_step", "step": 1}) + "\n")
    assert graftscope.main(["steps", str(empty)]) == 1
    capsys.readouterr()


def test_graftscope_requests_and_export_cli(tmp_path, capsys):
    f = tmp_path / "serve.jsonl"
    recs = [{"event": "request_trace", "request_id": f"req-{i}",
             "tenant": "acme" if i % 2 else "default", "queue_ms": 5.0 * i,
             "ttft_ms": 20.0 + i, "latency_ms": 80.0 + i, "new_tokens": 4,
             "prefill_chunks": 1, "tokens_per_s": 50.0,
             "finish_reason": "length", "elapsed_s": 1.0 + i}
            for i in range(6)]
    f.write_text("\n".join(json.dumps(r) for r in recs))
    rc = graftscope.main(["requests", str(f)])
    cap = capsys.readouterr()
    assert rc == 0
    assert "6 sampled request trace(s)" in cap.out
    assert "tenant acme" in cap.out and "tenant default" in cap.out
    rc = graftscope.main(["requests", str(f), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["requests"] == 6
    assert out["tenants"]["acme"]["requests"] == 3
    assert out["tenants"]["acme"]["finish_reasons"] == {"length": 3}
    dest = tmp_path / "trace.json"
    rc = graftscope.main(["export-perfetto", str(f), "-o", str(dest)])
    capsys.readouterr()
    assert rc == 0
    _assert_valid_trace_events(json.loads(dest.read_text()))
    nothing = tmp_path / "nothing.jsonl"
    nothing.write_text("")
    assert graftscope.main(["requests", str(nothing)]) == 1
    assert graftscope.main(
        ["export-perfetto", str(nothing), "-o", str(dest)]) == 1
    capsys.readouterr()


def test_last_span_is_thread_scoped():
    buf = io.StringIO()
    tr = Tracer(MetricsLogger(stream=buf, job="t"))
    seen = {}

    def worker():
        with tr.span("decode"):
            pass
        seen["worker"] = tr.last_span

    with tr.span("step", step=3):
        pass
    t = threading.Thread(target=worker, name="serve-thread")
    t.start()
    t.join(5)
    assert seen["worker"] == "decode"
    assert tr.last_span == "step"
    by_name = {json.loads(line)["name"]: json.loads(line)
               for line in buf.getvalue().splitlines()}
    assert by_name["step"]["thread"] == "MainThread"
    assert by_name["decode"]["thread"] == "serve-thread"


def test_ring_buffer_records_without_logger():
    tr = Tracer(None, ring_size=3, rank=4)
    for i in range(5):
        with tr.span("step", step=i):
            pass
    recent = tr.recent_spans()
    assert [r["step"] for r in recent] == [2, 3, 4]
    assert all(r["rank"] == 4 and r["name"] == "step" for r in recent)
    assert all("ts" in r and "thread" in r for r in recent)
    assert Tracer(None).recent_spans() == []


# --------------------------------------------- both readers, the same logs


def _jax_fit_stream(tmp_path) -> list[str]:
    """Two ranks' span logs written by the JAX package's ``fit`` and
    ``Tracer`` (a no-op step; a checkpoint-free run)."""
    import jax

    from k8s_distributed_deeplearning_tpu.telemetry.trace import (
        Tracer as JTracer)
    from k8s_distributed_deeplearning_tpu.train import loop as j_loop
    from k8s_distributed_deeplearning_tpu.utils.metrics import (
        MetricsLogger as JLogger)
    paths = []
    for rank in (0, 1):
        path = tmp_path / f"jax-rank{rank}.jsonl"
        with open(path, "w") as f:
            tracer = JTracer(JLogger(stream=f, job="train"), rank=rank)
            j_loop.fit(lambda state, batch, rng: (state, 0.0, {}),
                       state=None, batches=iter(range(6)), num_steps=6,
                       rng=jax.random.key(0), tracer=tracer)
        paths.append(str(path))
    return paths


def _port_fit_stream(tmp_path) -> list[str]:
    """The same from the port's ``fit`` and ``Tracer``."""
    from k8s_distributed_deeplearning_torch.train import loop as t_loop
    paths = []
    for rank in (0, 1):
        path = tmp_path / f"torch-rank{rank}.jsonl"
        with open(path, "w") as f:
            tracer = Tracer(MetricsLogger(stream=f, job="train"), rank=rank)
            t_loop.fit(lambda state, batch, seed: (state, 0.0, {}),
                       state=None, batches=iter(range(6)), num_steps=6,
                       rng=0, tracer=tracer)
        paths.append(str(path))
    return paths


def _request_stream(tmp_path) -> list[str]:
    """Request traces as the JAX package's ``MetricsLogger`` writes them:
    two replicas' logs, three journeys, one of them migrated twice, plus
    a torn line."""
    from k8s_distributed_deeplearning_tpu.utils.metrics import (
        MetricsLogger as JLogger)
    hops = [
        dict(request_id="a-0", trace_id="t-a", replica="r0",
             migrated_from=None, queue_ms=3.0, ttft_ms=20.0,
             latency_ms=60.0, new_tokens=3, elapsed_s=1.0),
        dict(request_id="b-0", trace_id="t-b", replica="r0",
             migrated_from=None, queue_ms=1.0, ttft_ms=9.0,
             latency_ms=30.0, new_tokens=8, elapsed_s=1.5,
             finish_reason="length"),
        dict(request_id="a-1", trace_id="t-a", replica="r1",
             migrated_from="r0", queue_ms=4.0, ttft_ms=12.0,
             latency_ms=40.0, new_tokens=2, elapsed_s=2.0),
        dict(request_id="a-2", trace_id="t-a", replica="r0",
             migrated_from="r1", queue_ms=2.0, ttft_ms=5.0,
             latency_ms=25.0, new_tokens=3, elapsed_s=3.0,
             finish_reason="length"),
        dict(request_id="c-0", trace_id="t-c", replica="r1",
             migrated_from=None, tenant="acme", queue_ms=7.0,
             ttft_ms=30.0, latency_ms=90.0, new_tokens=8,
             prefill_chunks=2, tokens_per_s=88.0, elapsed_s=2.5,
             finish_reason="eos"),
    ]
    paths = []
    for replica in ("r0", "r1"):
        path = tmp_path / f"replica-{replica}.jsonl"
        with open(path, "w") as f:
            log = JLogger(stream=f, job=replica)
            for h in hops:
                if h["replica"] == replica:
                    log.emit("request_trace", **h)
            if replica == "r1":
                f.write('{"event": "request_trace", "request_id": "x')
        paths.append(str(path))
    return paths


def _port_engine_stream(tmp_path) -> list[str]:
    """Request traces and spans written by the port's ``ServeEngine``
    (tiny model, every request sampled)."""
    import torch

    from k8s_distributed_deeplearning_torch.models import llama as t_llama
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          ServeEngine)
    model = t_llama.LlamaLM(t_llama.config_tiny(dtype=torch.float32,
                                                max_seq_len=64),
                            device="cpu", seed=3)
    path = tmp_path / "engine.jsonl"
    rng = np.random.default_rng(2)
    with open(path, "w") as f:
        eng = ServeEngine(model, num_slots=2, eos_id=None, device="cpu",
                          prefill_chunk_tokens=32,
                          tracer=Tracer(MetricsLogger(stream=f, job="e")),
                          request_trace_sample=1.0, replica_id="r0")
        eng.run([Request(prompt=[int(t) for t in rng.integers(0, 256, n)],
                         max_new_tokens=3, request_id=f"q{i}")
                 for i, n in enumerate((5, 40, 9))])
    return [str(path)]


STREAMS = {"jax_fit": _jax_fit_stream, "port_fit": _port_fit_stream,
           "jax_requests": _request_stream,
           "port_engine": _port_engine_stream}


def _cli(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_readers_equal_jax_on_the_same_logs(stream, tmp_path, capsys):
    """The analysis functions and every offline command give the JAX
    package's answer on the same files: summaries as values, ``--json``
    and text output byte for byte, the exported trace as JSON."""
    paths = STREAMS[stream](tmp_path)
    got, want = timeline.parse_files(paths), j_tl.parse_files(paths)
    assert [vars(s) for s in got.spans] == [vars(s) for s in want.spans]
    assert got.requests == want.requests
    assert (got.skipped, got.total_lines) == (want.skipped, want.total_lines)
    tl, jtl = (timeline.build_step_timelines(got),
               j_tl.build_step_timelines(want))
    attrs = timeline.attribute_stragglers(tl)
    assert [vars(a) for a in attrs] == [
        vars(a) for a in j_tl.attribute_stragglers(jtl)]
    for thr, ratio in ((0.0, 1.0), (1.0, 1.2)):
        assert timeline.straggler_summary(attrs, thr, ratio) == \
            j_tl.straggler_summary(j_tl.attribute_stragglers(jtl), thr,
                                   ratio)
    assert timeline.critical_path(tl) == j_tl.critical_path(jtl)
    assert timeline.requests_summary(got) == j_tl.requests_summary(want)
    assert [(s.trace_id, s.hops, s.migrations, s.replicas,
             s.total_latency_ms) for s in timeline.stitch_requests(got)] == \
        [(s.trace_id, s.hops, s.migrations, s.replicas, s.total_latency_ms)
         for s in j_tl.stitch_requests(want)]
    assert timeline.to_perfetto(got) == j_tl.to_perfetto(want)
    for argv in (["steps", *paths], ["steps", *paths, "--json"],
                 ["steps", *paths, "-v", "--threshold-ms", "0",
                  "--ratio", "1.0"],
                 ["requests", *paths], ["requests", *paths, "--json"]):
        assert _cli(graftscope.main, argv, capsys) == \
            _cli(j_scope.main, argv, capsys), argv
    mine, theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    rc = graftscope.main(["export-perfetto", *paths, "-o", str(mine)])
    rc_j = j_scope.main(["export-perfetto", *paths, "-o", str(theirs)])
    capsys.readouterr()
    assert rc == rc_j == 0
    assert json.loads(mine.read_text()) == json.loads(theirs.read_text())
    if stream.endswith("fit"):
        assert sorted(tl) == list(range(6)) and got.ranks() == [0, 1]
    if stream == "port_engine":
        assert len(got.requests) == 3 and got.spans
    if stream == "jax_requests":
        [journey] = [s for s in timeline.stitch_requests(got)
                     if s.migrations]
        assert journey.replicas == ["r0", "r1", "r0"]
        assert journey.request_ids == ["a-0", "a-1", "a-2"]


def _flight_dump(tmp_path) -> str:
    fr = FlightRecorder(4, dump_dir=str(tmp_path), job="r3")
    for i in range(6):
        fr.record("engine:r3", step=i, pool={"used": i})
        fr.record("gateway", breakers={"r3": "open"}, t=i)
    return fr.dump("breaker_trip", extra={
        "replica": "r3", "trip_error": "OSError('injected')",
        "site": "serve_decode", "action": "ioerror",
        "breakers": {"r3": "open", "r4": "closed"},
        "pool": {"pages_used": 7, "pages_total": 63, "pages_shared": 1,
                 "pages_reserved": 2},
        "pages_by_owner": {"slot0": 4, "trie": 3},
        "pages_held": {"slot0": list(range(20)), "trie": [21, 22, 23],
                       "idle": []},
        "leak": {"origin": "drain", "pages_leaked": 2,
                 "by_owner": {"slot0": 2}}})


def test_postmortem_equals_jax_on_a_port_flight_dump(tmp_path, capsys):
    """``postmortem`` renders a port flight dump exactly as the JAX
    command does, in text and JSON; a file that is not a dump is
    refused by both with the same message."""
    path = _flight_dump(tmp_path)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not a dump\n")
    for argv in (["postmortem", path], ["postmortem", path, "--tail", "2"],
                 ["postmortem", path, "--json"],
                 ["postmortem", path, str(bad)]):
        got = _cli(graftscope.main, argv, capsys)
        assert got == _cli(j_scope.main, argv, capsys), argv
    rc, out, _ = _cli(graftscope.main, ["postmortem", path], capsys)
    assert rc == 0 and "NOT CLOSED at death: r3" in out
    assert "LEAK (drain): 2 page(s)" in out and "+4 more" in out


def test_graftscope_fleet_against_a_live_port_exporter(tmp_path, capsys):
    """JAX's ``fleet`` case against the port's exporter: the JSON view
    with a tenant SLO, then the table; no endpoint is an error."""
    reg = MetricsRegistry()
    reg.gauge("depth", "d").set(3.0)
    exp = MetricsExporter(reg, host="127.0.0.1", port=0).start()
    tenants = tmp_path / "tenants.json"
    tenants.write_text(json.dumps({"tenants": [
        {"id": "chat", "slo": {"availability": 0.99}}]}))
    try:
        rc = graftscope.main(["fleet", f"127.0.0.1:{exp.port}",
                              "--rounds", "1", "--tenants", f"@{tenants}",
                              "--json"])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        rep = doc["replicas"][f"127.0.0.1:{exp.port}"]
        assert rep["up"] is True and rep["health"] > 0.9
        assert doc["slo"]["tenants"]["chat"]["burn_rates"][
            "availability_fast"] == 0.0
        rc = graftscope.main(["fleet", f"127.0.0.1:{exp.port}",
                              "--rounds", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "replica" in out and f"127.0.0.1:{exp.port}" in out
        assert "fleet aggregates" in out
    finally:
        exp.stop()
    assert graftscope.main(["fleet"]) == 1
    capsys.readouterr()


_NO_TORCH = """
import json, sys
from k8s_distributed_deeplearning_torch.telemetry import graftscope
logs, dump, out = sys.argv[1:4]
for argv in (["steps", logs], ["steps", logs, "--json"],
             ["requests", logs, "--json"],
             ["export-perfetto", logs, "-o", out], ["postmortem", dump]):
    assert graftscope.main(argv) == 0, argv
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] == "torch")))
"""


def test_offline_commands_import_no_torch(tmp_path):
    """In a fresh interpreter the port's ``timeline`` and the ``steps``,
    ``requests``, ``export-perfetto`` and ``postmortem`` commands run
    without importing torch: graftscope reads copied logs on a machine
    that has no torch."""
    logs = tmp_path / "mixed.jsonl"
    logs.write_text("\n".join(
        _rank_log(0, t0=0.0, steps=3, data_wait_ms=5.0, step_ms=20.0)
        + _rank_log(1, t0=9.0, steps=3, data_wait_ms=5.0, step_ms=20.0)
        + [json.dumps({"event": "request_trace", "request_id": "r",
                       "latency_ms": 5.0, "elapsed_s": 1.0})]))
    dump = _flight_dump(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, str(logs), dump,
         str(tmp_path / "t.json")], capture_output=True, text=True,
        timeout=120, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []
