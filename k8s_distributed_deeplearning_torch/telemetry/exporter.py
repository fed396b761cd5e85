"""Stdlib-threaded HTTP endpoint serving ``/metrics`` and ``/healthz``.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
exporter.py``: the same routes and bodies. The default ``/debug/profile``
capture is the port's ``utils/profiling.trace`` (``torch.profiler``), and
every connection is set ``TCP_NODELAY``, so a reply does not wait out the
client's delayed ACK between its header and body writes.

The scrape surface behind the ``prometheus.io/*`` pod annotations that
``launch/render.py`` stamps on every worker: Prometheus (or a curl) GETs
``/metrics`` for text-format 0.0.4 exposition of a
:class:`telemetry.registry.MetricsRegistry`, and K8s probes GET
``/healthz`` for a JSON liveness answer and ``/readyz`` for readiness
(503 once a drain starts — alive but not routable; see the ``readyz``
ctor arg). ``ThreadingHTTPServer`` on a daemon thread: scrapes never
block a train step, and the process never waits on the exporter to exit.

``port=0`` binds an ephemeral port (tests; ``.port`` reports the choice).

Opt-in debug surface (graftscope's capture hooks — both 404 unless the
owning process wired them in):

- ``/debug/spans`` — JSON dump of the tracer's in-memory span ring
  buffer. Readable with a bare curl when the Loki pipeline itself is the
  thing that's down.
- ``/debug/profile?ms=N`` — capture a windowed ``torch.profiler`` trace of
  whatever the process is doing for the next N ms and report the output
  directory. One capture at a time (concurrent requests get a 409); the
  window runs on the scrape's handler thread so the train/serve loop
  never blocks on it.
- ``/debug/flight`` — JSON view of the flight recorder's snapshot ring
  (``?dump=1`` additionally writes a JSONL dump file, reason
  ``on_demand``, and reports its path) — the live black box, readable
  before anything has died.
"""
from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from k8s_distributed_deeplearning_torch.telemetry.registry import (
    MetricsRegistry)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Serve *registry* on ``http://host:port/metrics``.

    *healthz* is an optional zero-arg callable returning extra fields for
    the ``/healthz`` JSON body (e.g. heartbeat ages); a raising callable
    turns the probe into a 503 — wire real liveness conditions there.

    *tracer* (a :class:`telemetry.trace.Tracer` built with ``ring_size``)
    enables ``/debug/spans``; *profile_dir* enables ``/debug/profile``.
    *profiler* overrides the capture context manager (default:
    ``utils.profiling.trace``, imported lazily so a metrics-only process
    never pays the torch import) — tests inject a fake here.

    *fleet* (a :class:`telemetry.fleet.FleetAggregator`) enables the
    federation surface: ``/fleet`` answers the JSON health/SLO snapshot
    and ``/metrics`` re-exports the aggregated fleet series (every
    sample ``replica=``-labeled) after this process's own registry —
    one scrape target for the whole fleet. *slo* (a
    :class:`telemetry.slo.SLOEngine`) rides into the ``/fleet`` body.

    *readyz* splits READINESS from the liveness above: ``/readyz``
    answers 200 while the callable returns a truthy ``"ready"`` field and
    503 once it stops (or raises) — a draining server is alive (don't
    restart it) but not ready (stop routing to it), which is exactly the
    distinction k8s readiness vs liveness probes encode. With no *readyz*
    configured, ``/readyz`` mirrors ``/healthz`` (a process with no drain
    concept is ready iff alive).

    *routes* mounts extra endpoints on this same server — the serving
    transport (``serve/transport.py``) shares the exporter's hardened
    machinery instead of growing a second HTTP stack. Each entry maps a
    path to ``handler(method, query, body) -> (code, ctype, bytes)``;
    returning None drops the connection without a response (the injected
    "response lost" fault shape). Handler exceptions answer 500.

    *handler_timeout* is the per-connection socket timeout: a scraper
    that connects and then goes silent would otherwise pin one
    ``ThreadingHTTPServer`` handler thread per hung connection forever
    (only mid-response hangups were handled before). ``BaseHTTPRequest-
    Handler.timeout`` is applied by stdlib ``setup()`` via
    ``connection.settimeout``; on expiry the handler closes the
    connection instead of waiting out the peer.
    """

    def __init__(self, registry: MetricsRegistry, *, host: str = "0.0.0.0",
                 port: int = 9090,
                 healthz: Callable[[], dict] | None = None,
                 readyz: Callable[[], dict] | None = None,
                 routes: dict[str, Callable] | None = None,
                 tracer=None, profile_dir: str | None = None,
                 profiler: Callable | None = None,
                 fleet=None, slo=None, flight=None,
                 handler_timeout: float = 30.0):
        self.registry = registry
        self.healthz = healthz
        self.readyz = readyz
        self.routes = dict(routes) if routes else {}
        self.tracer = tracer
        self.profile_dir = profile_dir
        self._profiler = profiler
        self.fleet = fleet
        self.slo = slo
        # telemetry.flight.FlightRecorder — enables /debug/flight.
        self.flight = flight
        self.handler_timeout = handler_timeout
        self._profile_lock = threading.Lock()
        self._profile_seq = 0
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def _capture_profile(self, ms: int) -> str:
        """Run one windowed profiler capture; returns the trace dir.
        Caller must hold ``_profile_lock``."""
        self._profile_seq += 1
        out = os.path.join(self.profile_dir,
                           f"ondemand-{self._profile_seq:04d}")
        profiler = self._profiler
        if profiler is None:
            from k8s_distributed_deeplearning_torch.utils.profiling import (
                trace)
            profiler = trace
        with profiler(out):
            time.sleep(ms / 1e3)
        return out

    def _handler(self):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            # Per-connection socket timeout (stdlib setup() applies it to
            # the connection; handle_one_request treats expiry as EOF) —
            # a silent scraper can't pin this handler thread forever.
            timeout = exporter.handler_timeout
            # TCP_NODELAY on every accepted connection: a reply leaves in
            # two writes (headers, then body), and with Nagle on, the body
            # waits for the client's delayed ACK of the headers (~40 ms on
            # Linux) — a stall on every transport call, not only scrapes.
            disable_nagle_algorithm = True

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    text = exporter.registry.render()
                    if exporter.fleet is not None:
                        # Federated re-export: the fleet's replica=-labeled
                        # series after this process's own, one scrape for
                        # the whole fleet.
                        text += exporter.fleet.render()
                    self._reply(200, CONTENT_TYPE, text.encode())
                elif path == "/fleet":
                    self._fleet()
                elif path == "/healthz":
                    try:
                        extra = exporter.healthz() if exporter.healthz else {}
                        body = json.dumps({"ok": True, **extra}).encode()
                        self._reply(200, "application/json", body)
                    except Exception as e:
                        body = json.dumps({"ok": False,
                                           "error": repr(e)}).encode()
                        self._reply(503, "application/json", body)
                elif path == "/readyz":
                    self._readyz()
                elif path in exporter.routes:
                    self._route(path, "GET", query)
                elif path == "/debug/spans":
                    self._debug_spans()
                elif path == "/debug/profile":
                    self._debug_profile(query)
                elif path == "/debug/flight":
                    self._debug_flight(query)
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path not in exporter.routes:
                    self._reply(404, "text/plain", b"not found\n")
                    return
                self._route(path, "POST", query)

            def _route(self, path: str, method: str, query: str) -> None:
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(n) if n else b""
                except (OSError, ValueError):
                    self.close_connection = True
                    return
                try:
                    result = exporter.routes[path](method, query, body)
                except Exception as e:   # handler bug/injected fault that
                    # escaped: answer 500 instead of a silent hangup, so
                    # the client can tell "broken handler" from "severed
                    # link" (the latter is the None contract below).
                    self._reply(500, "application/json", json.dumps(
                        {"error": repr(e)}).encode())
                    return
                if result is None:
                    # The handler asked for a DROPPED response (the
                    # transport_recv fault shape): the request was
                    # processed but the reply vanishes on the wire.
                    self.close_connection = True
                    return
                code, ctype, payload = result
                self._reply(code, ctype, payload)

            def _readyz(self) -> None:
                probe = exporter.readyz or exporter.healthz or (lambda: {})
                try:
                    extra = probe()
                    ready = bool(extra.get("ready", True)) if isinstance(
                        extra, dict) else bool(extra)
                    body = json.dumps({"ready": ready,
                                       **(extra if isinstance(extra, dict)
                                          else {})}).encode()
                    self._reply(200 if ready else 503, "application/json",
                                body)
                except Exception as e:
                    self._reply(503, "application/json", json.dumps(
                        {"ready": False, "error": repr(e)}).encode())

            def _fleet(self) -> None:
                if exporter.fleet is None:
                    self._reply(404, "application/json", json.dumps(
                        {"error": "no fleet aggregator configured "
                                  "(pass fleet= to MetricsExporter)"}
                        ).encode())
                    return
                body = exporter.fleet.to_json(
                    slo_engine=exporter.slo).encode()
                self._reply(200, "application/json", body)

            def _debug_spans(self) -> None:
                if exporter.tracer is None:
                    self._reply(404, "application/json", json.dumps(
                        {"error": "no span ring buffer configured "
                                  "(pass tracer= to MetricsExporter)"}
                        ).encode())
                    return
                spans = exporter.tracer.recent_spans()
                body = json.dumps({"spans": spans,
                                   "count": len(spans)}).encode()
                self._reply(200, "application/json", body)

            def _debug_flight(self, query: str) -> None:
                if exporter.flight is None:
                    self._reply(404, "application/json", json.dumps(
                        {"error": "no flight recorder configured "
                                  "(pass flight= to MetricsExporter)"}
                        ).encode())
                    return
                fr = exporter.flight
                records = fr.snapshot()
                out = {"enabled": fr.enabled, "count": len(records),
                       "records": records}
                params = urllib.parse.parse_qs(query)
                if params.get("dump", ["0"])[0] not in ("0", ""):
                    out["dump_path"] = fr.dump("on_demand")
                self._reply(200, "application/json",
                            json.dumps(out, default=repr).encode())

            def _debug_profile(self, query: str) -> None:
                if exporter.profile_dir is None:
                    self._reply(404, "application/json", json.dumps(
                        {"error": "profiling not configured (pass "
                                  "profile_dir= to MetricsExporter)"}
                        ).encode())
                    return
                try:
                    params = urllib.parse.parse_qs(query)
                    ms = int(params.get("ms", ["500"])[0])
                except ValueError:
                    self._reply(400, "application/json", json.dumps(
                        {"error": "ms must be an integer"}).encode())
                    return
                # Clamp: a zero/negative window is a no-op request, a huge
                # one would pin the handler thread (and the profiler's
                # buffers) for minutes.
                ms = max(1, min(ms, 60_000))
                if not exporter._profile_lock.acquire(blocking=False):
                    self._reply(409, "application/json", json.dumps(
                        {"error": "a profile capture is already running"}
                        ).encode())
                    return
                try:
                    out = exporter._capture_profile(ms)
                except Exception as e:   # profiler failure → 500, not a
                    self._reply(500, "application/json", json.dumps(  # crash
                        {"ok": False, "error": repr(e)}).encode())
                    return
                finally:
                    exporter._profile_lock.release()
                self._reply(200, "application/json", json.dumps(
                    {"ok": True, "trace_dir": out, "ms": ms}).encode())

            def _reply(self, code: int, ctype: str, body: bytes) -> None:
                # A scraper that hangs up mid-response (timeout, pod kill)
                # half-closes the socket; without the catch every such
                # scrape stack-traces in the handler thread and spams
                # stderr — which on a worker pod is the JSONL log stream.
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError):
                    # TimeoutError: the per-connection socket timeout
                    # fired mid-write — same treatment as a hangup.
                    self.close_connection = True

            def log_message(self, *args) -> None:
                pass    # scrapes must not spam the JSONL stdout stream

        return Handler

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
