"""PyTorch port, the telemetry the wire fleet stands on, each module held to
its JAX namesake on the same inputs:

- ``utils/retry.py``: the same full-jitter schedule for the same rng;
- ``telemetry/registry.py``: ``render()`` byte-equal after the same
  operations (labels with escapes, NaN and the infinities, histograms);
- ``telemetry/bridge.py``: the serving, scheduler, gateway, storm and
  heartbeat collectors render JAX's families over the same state;
- ``telemetry/fleet.py``: ``parse_exposition``, the scraper, the
  aggregator's ``snapshot()`` and federated ``render()`` and ``feed_slo``
  give JAX's results on the same exposition texts;
- ``telemetry/heartbeat.py``: each package reads the other's beacons, and
  ``detect_stalls`` agrees;
- ``telemetry/events.py``: JAX's registry, and every event the port emits
  is in it;
- ``telemetry/trace.py``: JAX's span events; ``telemetry/exporter.py``:
  JAX's bodies on every route; ``utils/profiling.py`` writes a trace;
- the engine's spans and ``request_trace`` events (the same sampled
  request ids and fields as the JAX engine's on the same weights), and the
  storm CLI's ``--metrics-port``.
"""
import ast
import io
import json
import math
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from k8s_distributed_deeplearning_torch.telemetry import bridge as t_bridge
from k8s_distributed_deeplearning_torch.telemetry import events as t_events
from k8s_distributed_deeplearning_torch.telemetry import exporter as t_exp
from k8s_distributed_deeplearning_torch.telemetry import fleet as t_fleet
from k8s_distributed_deeplearning_torch.telemetry import heartbeat as t_hb
from k8s_distributed_deeplearning_torch.telemetry import registry as t_reg
from k8s_distributed_deeplearning_torch.telemetry import slo as t_slo
from k8s_distributed_deeplearning_torch.telemetry import trace as t_trace
from k8s_distributed_deeplearning_torch.utils import metrics as t_metrics
from k8s_distributed_deeplearning_torch.utils import retry as t_retry
from k8s_distributed_deeplearning_tpu.telemetry import bridge as j_bridge
from k8s_distributed_deeplearning_tpu.telemetry import events as j_events
from k8s_distributed_deeplearning_tpu.telemetry import exporter as j_exp
from k8s_distributed_deeplearning_tpu.telemetry import fleet as j_fleet
from k8s_distributed_deeplearning_tpu.telemetry import heartbeat as j_hb
from k8s_distributed_deeplearning_tpu.telemetry import registry as j_reg
from k8s_distributed_deeplearning_tpu.telemetry import slo as j_slo
from k8s_distributed_deeplearning_tpu.telemetry import trace as j_trace
from k8s_distributed_deeplearning_tpu.utils import metrics as j_metrics
from k8s_distributed_deeplearning_tpu.utils import retry as j_retry

REPO = Path(__file__).resolve().parents[1]
PKGS = {"torch": (t_retry, t_reg, t_bridge, t_fleet, t_slo, t_metrics),
        "jax": (j_retry, j_reg, j_bridge, j_fleet, j_slo, j_metrics)}


# ------------------------------------------------------------------ retry


def _schedule(retry_mod, *, fails, retries, jitter, error=OSError):
    sleeps, seen, calls = [], [], [0]
    draws = iter([0.5, 0.25, 0.125, 0.9, 0.1, 0.7])

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise error("blip")
        return calls[0]

    try:
        out = retry_mod.retry_transient(
            fn, retries=retries, backoff_s=0.3, sleep=sleeps.append,
            jitter=jitter, rng=lambda: next(draws),
            on_retry=lambda n, e, d: seen.append((n, d)))
    except Exception as e:   # noqa: BLE001 — the outcome is compared
        out = type(e).__name__
    return out, sleeps, seen


@pytest.mark.parametrize("fails,retries,jitter,error", [
    (3, 3, True, OSError), (2, 2, False, OSError), (5, 3, True, OSError),
    (1, 4, True, ValueError), (0, 2, True, OSError)],
    ids=["jitter", "doubling", "exhausted", "permanent", "first-try"])
def test_retry_schedule_equals_jax(fails, retries, jitter, error):
    """The same attempts, sleeps and ``on_retry`` delays (post-jitter)
    for the same rng draws."""
    got = _schedule(t_retry, fails=fails, retries=retries, jitter=jitter,
                    error=error)
    want = _schedule(j_retry, fails=fails, retries=retries, jitter=jitter,
                     error=error)
    assert got == want


# --------------------------------------------------------------- registry


def _fill(reg_mod):
    r = reg_mod.MetricsRegistry()
    c = r.counter("a_total", "a counter")
    c.inc()
    c.inc(2.5)
    g = r.gauge("b_gauge", "a gauge", labelnames=("rank", "kind"))
    g.labels(rank="0", kind='q"uo\\te\nline').set(3)
    g.labels(rank="1", kind="x").set(float("nan"))
    r.gauge("c_inf", "infinities").set(float("inf"))
    r.gauge("c_neg_inf", "minus infinity").set(float("-inf"))
    h = r.histogram("d_seconds", "a histogram", buckets=(0.1, 1.0, 5.0))
    for v in (0.05, 0.5, 3.0, 9.0):
        h.observe(v)
    hl = r.histogram("e_ms", "labeled", labelnames=("span",),
                     buckets=(1.0, 10.0))
    hl.labels(span="decode").observe(4.0)
    hl.labels(span="prefill").observe(40.0)
    r.gauge("f_plain", "int-valued gauge").set(7.0)
    r.register_collector(lambda: 1 / 0)       # a broken collector
    return r


def test_registry_render_is_byte_equal_to_jax():
    assert _fill(t_reg).render() == _fill(j_reg).render()


def test_registry_refuses_what_jax_refuses():
    for mod in (t_reg, j_reg):
        r = mod.MetricsRegistry()
        r.counter("x", "c")
        with pytest.raises(ValueError, match="already registered"):
            r.gauge("x", "g")
        with pytest.raises(ValueError, match="only go up"):
            r.counter("y", "c").inc(-1)
        with pytest.raises(ValueError, match="expected labels"):
            r.gauge("z", "g", labelnames=("a",)).labels(b="1")


# ----------------------------------------------------------------- bridge


def _stats(metrics_mod):
    s = metrics_mod.ServingStats()
    s.record_admission(queue_s=0.002, prompt_len=12)
    s.record_admission(queue_s=0.004, prompt_len=30)
    s.record_first_token(ttft_s=0.05)
    s.record_first_token(ttft_s=0.07)
    for _ in range(3):
        s.record_step(active_slots=2, num_slots=4)
    s.record_prefix_lookup(hit_tokens=16, prompt_tokens=30)
    s.record_prefix_lookup(hit_tokens=0, prompt_tokens=12)
    s.record_kv_pool(64, 9, 2, by_owner={"slot": 7, "trie": 2})
    s.record_gateway_dispatch()
    s.record_gateway_migration()
    s.record_transport_retry()
    s.record_transport_dedup()
    s.record_transport_reconnect()
    s.record_request_trace()
    s.record_disagg_export(pages=3, nbytes=3000)
    s.record_disagg_import(pages=3, nbytes=3000)
    s.record_disagg_depth(prefill=1, decode=2)
    s.record_spec_step(proposed=6, accepted_counts=[1, 3])
    s.record_quant("int8", None, kv_bytes_saved=100, weight_bytes_saved=0)
    s.record_completion(latency_s=0.3, n_tokens=8, reason="length")
    s.record_completion(latency_s=0.2, n_tokens=1, reason="eos")
    s.t_start, s.t_last = 10.0, 12.5      # the clock, pinned
    return s


def test_serving_collector_renders_jax_families():
    """The same stats operations render the same exposition: every
    family, label and value of JAX's serving collector."""
    texts = []
    for reg_mod, bridge_mod, metrics_mod in ((t_reg, t_bridge, t_metrics),
                                             (j_reg, j_bridge, j_metrics)):
        r = reg_mod.MetricsRegistry()
        bridge_mod.serving_collector(r, _stats(metrics_mod))
        texts.append(r.render())
    assert texts[0] == texts[1]
    fams = t_fleet.parse_exposition(texts[0])
    assert fams["serve_transport_retries_total"].samples[0].value == 1
    assert fams["serve_request_traces_sampled"].samples[0].value == 1


def test_transport_counters_count():
    """The ``transport_*`` counters now count, as JAX's do."""
    s = t_metrics.ServingStats()
    for _ in range(2):
        s.record_transport_retry()
    s.record_transport_dedup()
    s.record_transport_reconnect()
    summ = s.summary()
    assert (summ["transport_retries"], summ["transport_dedup_hits"],
            summ["transport_reconnects"]) == (2, 1, 1)


class _Sched:
    def snapshot(self):
        return {"tenants": {"a": {"queue_depth": 2, "shed_total": 1,
                                  "expired_total": 0, "in_flight": 3,
                                  "queue_wait_p95_ms": 4.5},
                            "b": {"queue_depth": 0, "shed_total": 0,
                                  "expired_total": 2, "in_flight": 0,
                                  "queue_wait_p95_ms": None}},
                "classes": {"interactive": {"queue_depth": 2,
                                            "queue_wait_p95_ms": 4.5},
                            "batch": {"queue_depth": 0,
                                      "queue_wait_p95_ms": None}}}


class _Gateway:
    def snapshot(self):
        return {"replicas": {"r0": {"state": "open", "health": 0.25,
                                    "load": 3, "draining": False},
                             "r1": {"state": "closed", "health": 0.9,
                                    "load": 1, "draining": True}},
                "live_requests": 4}


class _Monitor:
    violations = [{"kind": "x"}]

    def in_flight(self):
        return 5

    def submitted_total(self):
        return 11


class _Injector:
    fired = [("serve_decode", "stall")] * 3


@pytest.mark.parametrize("which", ["sched", "gateway", "storm", "heartbeat"])
def test_collectors_render_jax_families(which, tmp_path):
    texts = []
    for reg_mod, bridge_mod, hb_mod in ((t_reg, t_bridge, t_hb),
                                        (j_reg, j_bridge, j_hb)):
        r = reg_mod.MetricsRegistry()
        if which == "sched":
            bridge_mod.sched_collector(r, _Sched())
        elif which == "gateway":
            bridge_mod.gateway_collector(r, _Gateway())
        elif which == "storm":
            bridge_mod.storm_collector(r, _Monitor(), injector=_Injector())
        else:
            d = tmp_path / "hb"
            hb_mod.HeartbeatWriter(str(d), 3, clock=lambda: 0.0).beat(
                step=7)
            bridge_mod.heartbeat_collector(r, str(d))
        texts.append(r.render())
    if which == "heartbeat":
        # The age is now minus a beat at t=0: equal to the second.
        for text in texts:
            fams = t_fleet.parse_exposition(text)
            assert fams["tpujob_heartbeat_step"].samples[0].value == 7
        texts = [t.split("tpujob_heartbeat_age_seconds{")[0] for t in texts]
    assert texts[0] == texts[1]


def test_host_and_device_probes_on_the_cpu():
    assert t_bridge.host_rss_bytes() > 0
    assert t_bridge.device_memory_stats() == {}   # no CUDA device here


# ------------------------------------------------------------------ fleet


def _exposition(reg_mod, bridge_mod, metrics_mod, queue: int) -> str:
    r = reg_mod.MetricsRegistry()
    bridge_mod.serving_collector(r, _stats(metrics_mod))
    sched = _Sched()
    bridge_mod.sched_collector(r, sched)
    r.gauge("sched_queue_depth", "", labelnames=("tenant",)).labels(
        tenant="c").set(queue)
    r.gauge("tpujob_heartbeat_age_seconds", "hb",
            labelnames=("rank",)).labels(rank="0").set(12.0)
    return r.render()


def _fleet_views(side: str, texts: dict) -> dict:
    _, reg_mod, bridge_mod, fleet_mod, slo_mod, metrics_mod = PKGS[side]
    now = [1000.0]
    fetch_log = []

    def fetch(url, timeout_s):
        fetch_log.append(url)
        text = texts[url]
        if isinstance(text, Exception):
            raise text
        return text

    events = []

    class _Log:
        def emit(self, event, **f):
            events.append((event, sorted(f)))

    scraper = fleet_mod.FleetScraper(
        list(texts), fetch=fetch, clock=lambda: now[0], sleep=lambda s: None,
        rng=lambda: 0.5, retries=1, stale_after_s=5.0, logger=_Log())
    scraper.poll()
    now[0] += 2.0
    agg = fleet_mod.FleetAggregator(scraper, policy=fleet_mod.HealthPolicy(
        queue_full_depth=8.0, heartbeat_stale_s=30.0))
    slo = slo_mod.SLOEngine({"a": slo_mod.SLOTarget(
        availability=0.99, latency_p95_ms=2.0, window_s=60.0)},
        clock=lambda: now[0])
    fleet_mod.feed_slo(slo, agg)
    return {"snapshot": agg.snapshot(slo_engine=slo), "render": agg.render(),
            "json": agg.to_json(), "fetched": fetch_log, "events": events,
            "finished": agg.finished_totals(),
            "p95": agg.queue_wait_p95_by_tenant()}


def test_fleet_aggregator_and_feed_slo_equal_jax():
    """Two replicas (one JAX's exposition, one the port's) and a dead
    one: the scrape with retries, the health scores, aggregates,
    federated render, JSON snapshot with the SLO engine fed by
    ``feed_slo``, all equal to the JAX module's on the same texts."""
    texts = {"http://h1:1/metrics": _exposition(t_reg, t_bridge, t_metrics,
                                                 queue=3),
             "http://h2:2/metrics": _exposition(j_reg, j_bridge, j_metrics,
                                                 queue=9),
             "http://h3:3/metrics": ConnectionRefusedError("down")}
    got, want = _fleet_views("torch", texts), _fleet_views("jax", texts)
    assert got == want
    reps = got["snapshot"]["replicas"]
    assert reps["h3:3"]["up"] is False and reps["h3:3"]["health"] == 0.0
    assert 0.0 < reps["h1:1"]["health"] < 1.0
    assert got["events"] == [("fleet_scrape_failed",
                              ["error", "replica", "url"])]


@pytest.mark.parametrize("text", [
    '# HELP x a\n# TYPE x gauge\nx{a="q\\"u\\\\o\\nte",b=""} NaN\n'
    'x{a="2"} +Inf\nx -Inf 1700000000\n',
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 3\n"
    "h_sum 4.5\nh_count 3\nstray_total 1e3\n# a comment\n\n",
    'bad{a="1" 2\n', "x{a=1} 2\n"], ids=["escapes", "histogram",
                                           "unterminated", "unquoted"])
def test_parse_exposition_equals_jax(text):
    def parse(mod):
        try:
            fams = mod.parse_exposition(text)
        except ValueError as e:
            return ("error", str(e))
        return {n: (f.kind, f.help, [(s.name, s.labels,
                                      "nan" if math.isnan(s.value)
                                      else s.value) for s in f.samples])
                for n, f in fams.items()}
    assert parse(t_fleet) == parse(j_fleet)


# -------------------------------------------------------------- heartbeat


def test_heartbeats_cross_packages_and_stalls_agree(tmp_path):
    """A port writer's beacon is read by JAX's reader and the other way
    round; discovery by role and ``detect_stalls`` agree."""
    d = str(tmp_path)
    t_hb.HeartbeatWriter(d, 0, clock=lambda: 100.0).beat(
        step=5, last_span="decode", metrics_addr="127.0.0.1:1",
        role="decode")
    j_hb.HeartbeatWriter(d, 1, clock=lambda: 40.0).beat(
        step=9, metrics_addr="127.0.0.1:2", role="prefill")
    t_hb.HeartbeatWriter(d, 2, clock=lambda: 99.0).beat(
        step=1, metrics_addr="127.0.0.1:3")       # no role: decode
    strip = [{k: v for k, v in r.items() if k != "pid"}
             for r in t_hb.read_heartbeats(d)]
    assert strip == [{k: v for k, v in r.items() if k != "pid"}
                     for r in j_hb.read_heartbeats(d)]
    assert [r["rank"] for r in strip] == [0, 1, 2]
    for stale in (10.0, 59.0, 61.0, 1000.0):
        got = t_hb.detect_stalls(d, stale, now=101.0)
        want = j_hb.detect_stalls(d, stale, now=101.0)
        assert [s.__dict__ for s in got] == [s.__dict__ for s in want]
        assert [s.describe() for s in got] == [s.describe() for s in want]
    for role in (None, "decode", "prefill"):
        for stale in (None, 30.0):
            assert t_fleet.discover_endpoints(
                d, role=role, stale_after_s=stale, now=101.0) == \
                j_fleet.discover_endpoints(d, role=role, stale_after_s=stale,
                                           now=101.0)
    t_hb.HeartbeatWriter(d, 0).remove()
    assert [r["rank"] for r in j_hb.read_heartbeats(d)] == [1, 2]


# ----------------------------------------------------------------- events


def _port_emits() -> set[str]:
    names = set()
    for path in list((REPO / "k8s_distributed_deeplearning_torch").rglob(
            "*.py")) + [REPO / "examples" / "generate_llama_torch.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "emit" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_port_emits_only_registered_events():
    """Every literal event name the port emits is in its registry, which
    is JAX's: one Loki schema for both packages."""
    emitted = _port_emits()
    assert {"request_trace", "transport_retry", "transport_reconnect",
            "transport_submit_deduped", "span", "fleet_scrape_failed"} \
        <= emitted
    assert emitted <= t_events.known_events(), sorted(
        emitted - t_events.known_events())
    assert t_events.EVENTS == j_events.EVENTS
    assert all(t_events.is_snake_case(n) for n in t_events.known_events())
    assert not t_events.is_snake_case("Bad-Name")


# ------------------------------------------------------------------ trace


def _span_events(trace_mod, metrics_mod, reg_mod):
    buf = io.StringIO()
    reg = reg_mod.MetricsRegistry()
    tr = trace_mod.Tracer(metrics_mod.MetricsLogger(stream=buf, job="t"),
                          rank=2, registry=reg, ring_size=2)
    with tr.span("step", step=7):
        with tr.span("data_wait"):
            pass
        with tr.span("checkpoint", bytes=9):
            pass
    keep = ("event", "name", "depth", "parent", "rank", "step", "bytes")
    recs = [{k: r[k] for k in keep if k in r}
            for r in map(json.loads, buf.getvalue().splitlines())]
    ring = [{k: r[k] for k in keep if k in r} for r in tr.recent_spans()]
    hist = t_fleet.parse_exposition(reg.render())["span_duration_ms"]
    counts = sorted((s.labels["span"], s.value) for s in hist.samples
                    if s.name.endswith("_count"))
    off = trace_mod.Tracer(enabled=False)
    with off.span("x"):
        pass
    return recs, ring, counts, tr.last_span, tr.spans_emitted, off.last_span


def test_tracer_emits_jax_span_events():
    assert _span_events(t_trace, t_metrics, t_reg) == _span_events(
        j_trace, j_metrics, j_reg)


# --------------------------------------------------------------- exporter


class _FakeFlight:
    enabled = True

    def snapshot(self):
        return [{"src": "engine", "step": 1}]

    def dump(self, reason):
        return f"/dumps/{reason}.jsonl"


def _serve(exp_mod, reg_mod, tracer_mod, metrics_mod, tmp_path, fleet=None):
    reg = _fill(reg_mod)
    tr = tracer_mod.Tracer(None, ring_size=4)
    with tr.span("decode", active=2):
        pass
    profiled = []

    class _Prof:
        def __init__(self, out):
            profiled.append(Path(out).name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return None

    def boom(method, query, body):
        raise RuntimeError("handler bug")

    exp = exp_mod.MetricsExporter(
        reg, host="127.0.0.1", port=0,
        healthz=lambda: {"draining": False},
        readyz=lambda: {"ready": False, "draining": True},
        routes={"/echo": lambda m, q, b: (200, "application/json",
                                          json.dumps({"m": m, "q": q,
                                                      "b": b.decode()}
                                                     ).encode()),
                "/lost": lambda m, q, b: None, "/boom": boom},
        tracer=tr, profile_dir=str(tmp_path), profiler=_Prof,
        flight=_FakeFlight(), fleet=fleet).start()
    out = {}

    def get(path, data=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{exp.port}{path}", data=data,
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()
        except OSError as e:
            return "severed", type(e).__name__

    try:
        for path in ("/metrics", "/healthz", "/readyz", "/nope",
                     "/debug/flight", "/debug/flight?dump=1",
                     "/debug/profile?ms=1", "/debug/profile?ms=x", "/fleet",
                     "/echo?k=1"):
            out[path] = get(path)
        out["POST /echo"] = get("/echo?a=b", data=b"hi")
        out["POST /lost"] = get("/lost", data=b"x")
        out["POST /boom"] = get("/boom", data=b"x")
        out["POST /metrics"] = get("/metrics", data=b"x")
        code, body = get("/debug/spans")
        spans = json.loads(body)["spans"]
        out["/debug/spans"] = (code, [(s["name"], s["active"])
                                      for s in spans])
    finally:
        exp.stop()
    out["profiled"] = profiled
    return out


def test_exporter_routes_answer_as_jax(tmp_path):
    """Every route of the port's exporter gives the JAX exporter's status
    and body: the scrape, both probes, a 404, the flight view and dump,
    a profile capture through the injected profiler, a bad ``ms``, the
    missing fleet, mounted GET/POST routes, a dropped response (the
    ``transport_recv`` shape) and a handler exception (500)."""
    got = _serve(t_exp, t_reg, t_trace, t_metrics, tmp_path / "t")
    want = _serve(j_exp, j_reg, j_trace, j_metrics, tmp_path / "j")
    for key in ("/debug/profile?ms=1",):
        # The body names this exporter's own directory.
        got[key] = (got[key][0], json.loads(got[key][1])["ms"])
        want[key] = (want[key][0], json.loads(want[key][1])["ms"])
    assert got == want
    assert got["/metrics"] == (200, _fill(t_reg).render())
    assert got["/readyz"][0] == 503 and got["/healthz"][0] == 200
    assert got["POST /lost"][0] == "severed"
    assert got["POST /boom"][0] == 500
    assert got["profiled"] == ["ondemand-0001"]


def test_exporter_serves_the_fleet_federation(tmp_path):
    """``/fleet`` and the federated ``/metrics`` re-export of the port's
    aggregator, as JAX's exporter serves them."""
    outs = []
    for side, exp_mod, trace_mod in (("torch", t_exp, t_trace),
                                     ("jax", j_exp, j_trace)):
        _, reg_mod, _, fleet_mod, _, metrics_mod = PKGS[side]
        scraper = fleet_mod.FleetScraper(
            ["h1:1"], fetch=lambda url, t: "# TYPE up gauge\nup 1\n",
            clock=lambda: 50.0)
        scraper.poll()
        agg = fleet_mod.FleetAggregator(scraper)
        out = _serve(exp_mod, reg_mod, trace_mod, metrics_mod,
                     tmp_path / side, fleet=agg)
        outs.append((out["/fleet"], out["/metrics"]))
    assert outs[0] == outs[1]
    assert json.loads(outs[0][0][1])["replicas"]["h1:1"]["up"] is True
    assert 'up{replica="h1:1"} 1' in outs[0][1][1]


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from k8s_distributed_deeplearning_torch.utils import profiling
    with profiling.trace(str(tmp_path / "p")):
        torch.ones(8).sum()
    doc = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert doc.get("traceEvents")
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# ---------------------------------------------------- the engine's traces


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp
    import torch

    from k8s_distributed_deeplearning_torch.models import convert as t_conv
    from k8s_distributed_deeplearning_torch.models import llama as t_llama
    from k8s_distributed_deeplearning_tpu.models import llama as j_llama
    jcfg = j_llama.config_tiny(dtype=jnp.float32, max_seq_len=64)
    jmodel = j_llama.LlamaLM(jcfg)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32, max_seq_len=64)
    tmodel = t_llama.LlamaLM(tcfg, device="cpu")
    tmodel.load_state_dict(t_conv.from_flax_params(tcfg, params))
    return jmodel, params, tmodel


_TRACE_FIELDS = ("request_id", "trace_id", "replica", "migrated_from",
                 "tenant", "priority", "prompt_len", "cached_prompt_tokens",
                 "prefill_chunks", "new_tokens", "decode_steps",
                 "spec_proposed", "spec_accepted", "kv_quant",
                 "weight_quant", "finish_reason")


def _engine_traces(side, tiny, sample):
    jmodel, params, tmodel = tiny
    buf = io.StringIO()
    if side == "torch":
        from k8s_distributed_deeplearning_torch.serve import (
            Request, ServeEngine)
        log = t_metrics.MetricsLogger(stream=buf, job="t")
        tracer = t_trace.Tracer(log)
        eng = ServeEngine(tmodel, num_slots=2, eos_id=None, device="cpu",
                          prefill_chunk_tokens=32, tracer=tracer,
                          request_trace_sample=sample, replica_id="r0",
                          max_queue=3)
    else:
        from k8s_distributed_deeplearning_tpu.serve import (
            Request, ServeEngine)
        log = j_metrics.MetricsLogger(stream=buf, job="t")
        tracer = j_trace.Tracer(log)
        eng = ServeEngine(jmodel, params, num_slots=2, eos_id=None,
                          prefill_chunk_tokens=32, tracer=tracer,
                          request_trace_sample=sample, replica_id="r0",
                          max_queue=3)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, 256, n)],
                    max_new_tokens=4, request_id=f"tr{i}",
                    trace_id=f"trace-{i}")
            for i, n in enumerate((9, 40, 12, 50, 7, 20))]
    outs = eng.run(reqs[:5])
    eng.submit(reqs[5])
    eng.cancel("tr5", "aborted")                 # a queued terminal
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    traces = sorted(({k: e[k] for k in _TRACE_FIELDS}
                     for e in events if e["event"] == "request_trace"),
                    key=lambda e: e["request_id"])
    spans = sorted({(e["name"], e["depth"], e["parent"])
                    for e in events if e["event"] == "span"})
    counts = {n: sum(1 for e in events if e["event"] == "span"
                     and e["name"] == n) for n in ("admission", "prefill",
                                                   "decode")}
    return (traces, spans, counts, eng.stats.summary()[
        "request_traces_sampled"], {o.request_id: o.tokens for o in outs})


@pytest.mark.parametrize("sample", [1.0, 0.5, 0.0])
def test_engine_request_traces_and_spans_equal_jax(tiny, sample):
    """The same requests on the same weights: the port's engine samples
    the same request ids (crc32 of the id) and emits the same
    ``request_trace`` fields (timings aside) and the same spans, one
    ``admission`` a request, one ``prefill`` a chunk and one ``decode``
    an iteration."""
    got = _engine_traces("torch", tiny, sample)
    want = _engine_traces("jax", tiny, sample)
    assert got == want
    traces, spans, counts, sampled, _ = got
    assert sampled == len(traces)
    if sample == 1.0:
        assert len(traces) == 6 and traces[-1]["finish_reason"] == "aborted"
    if sample == 0.0:
        assert traces == []
    assert counts["admission"] == 5 and counts["decode"] > 0


def test_engine_refuses_a_sample_outside_unit_interval(tiny):
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    with pytest.raises(ValueError, match="request_trace_sample"):
        ServeEngine(tiny[2], num_slots=2, device="cpu",
                    request_trace_sample=1.5)


# ------------------------------------------------------ the storm exporter


def test_storm_cli_serves_metrics_while_it_runs(tmp_path, monkeypatch):
    """``--metrics-port`` (which raised before) mounts the storm gauges on
    an exporter for the soak's duration: scraped as the soak ends, they
    show the live monitor; the report equals a run without it."""
    from contextlib import redirect_stdout

    from k8s_distributed_deeplearning_torch.serve import storm as t_storm
    from k8s_distributed_deeplearning_torch.telemetry import exporter
    started, scraped = [], []
    real = exporter.MetricsExporter

    class _Probe(real):
        def start(self):
            started.append(self)
            return super().start()

    monkeypatch.setattr(exporter, "MetricsExporter", _Probe)
    orig_run = t_storm.run_storm

    def run_and_scrape(*a, **kw):
        rep = orig_run(*a, **kw)
        if len(started) > len(scraped):     # this run mounted an exporter
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{started[0].port}/metrics",
                    timeout=30) as resp:
                scraped.append(resp.read().decode())
        return rep

    monkeypatch.setattr(t_storm, "run_storm", run_and_scrape)
    reports = []
    for extra in (["--metrics-port", "0"], []):
        out = tmp_path / f"report{len(reports)}.json"
        with redirect_stdout(io.StringIO()):
            assert t_storm.main(["--device", "cpu", "--steps", "12",
                                 "--max-seq-len", "64", "--report-json",
                                 str(out)] + extra) == 0
        reports.append(json.loads(out.read_text()))
    assert len(started) == 1 and len(scraped) == 1
    fams = t_fleet.parse_exposition(scraped[0])
    assert fams["serve_storm_requests_submitted_total"].samples[0].value \
        == reports[0]["submitted"] > 0
    assert fams["serve_storm_invariant_violations_total"].samples[0].value \
        == 0
    assert reports[0] == reports[1]
    with pytest.raises(OSError):           # the exporter was stopped
        urllib.request.urlopen(
            f"http://127.0.0.1:{started[0].port}/metrics", timeout=5)


def test_stats_are_safe_to_read_while_written():
    """Exporter threads read ``summary()`` while engine threads write: the
    lock keeps every summary whole (JAX's ``_locked``). Four writers and
    a reader, with the interpreter switching threads every microsecond."""
    import sys

    s = t_metrics.ServingStats()
    stop = threading.Event()
    errors = []

    def write():
        i = 0
        while not stop.is_set():
            s.record_completion(0.1, 1, f"r{i % 50}")
            s.record_spec_step(2, [i % 3])
            i += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    writers = [threading.Thread(target=write) for _ in range(4)]
    try:
        for th in writers:
            th.start()
        for _ in range(300):
            try:
                summ = s.summary()
                assert sum(summ["finish_reasons"].values()) == \
                    summ["requests_completed"]
                hist = summ["spec_accept_hist"]
                assert sum(hist.values()) == summ["spec_steps"]
                assert sum(int(k) * v for k, v in hist.items()) == \
                    summ["spec_accepted_tokens"]
            except Exception as e:   # noqa: BLE001 — collected below
                errors.append(repr(e))
    finally:
        stop.set()
        for th in writers:
            th.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in writers)
    assert errors == []
    summ = s.summary()
    assert sum(summ["finish_reasons"].values()) == summ["requests_completed"]


def test_logger_writes_each_event_whole():
    """Each event reaches the stream as ONE write of the line and its
    newline (``print`` writes them apart, and a signal handler or another
    thread emitting in between joins two events on one line); six threads
    emitting at once leave every line whole."""
    import sys

    class _Writes(io.StringIO):
        def __init__(self):
            super().__init__()
            self.calls = []

        def write(self, text):
            self.calls.append(text)
            return super().write(text)

    stream = _Writes()
    log = t_metrics.MetricsLogger(stream=stream, job="t")
    log.emit("transport_retry", replica="r0", attempt=1)
    log.emit("transport_reconnect", replica="r0", streams=2)
    assert len(stream.calls) == 2
    assert all(c.endswith("\n") and c.count("\n") == 1
               for c in stream.calls)

    def emit(i):
        for n in range(300):
            log.emit("transport_retry", replica=f"r{i}", attempt=n)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=emit, args=(i,)) for i in range(6)]
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            th.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    lines = stream.getvalue().splitlines()
    assert len(lines) == 2 + 6 * 300
    assert all(json.loads(line)["job"] == "t" for line in lines)
