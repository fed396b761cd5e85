"""graftwire: cross-process replica transport with network fault
tolerance.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
transport.py``. Its control-plane JSON, routes, metric families, heartbeat
beacons and event names are the JAX module's, so a JAX
:class:`ReplicaClient` drives a port :class:`ReplicaServer` over
``/submit`` and ``/poll``. The KV blob that ``/pages`` and ``/exports``
carry is the port's own (``serve/disagg.py``): it does not cross
packages. Four things differ from the JAX module, none of them on the
wire: the exporter sets ``TCP_NODELAY`` on each connection, the step loop
lets waiting route handlers take the engine lock first between
iterations, ``/pages`` stages chunks and decodes blobs (and ``/exports``
encodes them) outside the engine lock, and ``ship_pages`` cuts 16 MiB
chunks (:data:`PAGES_CHUNK_CHARS`) where JAX cuts 262,144 characters.

The gateway (serve/gateway.py) was built against in-process
:class:`ServeEngine` replicas — one process, shared memory, failure =
an exception out of ``step()``. This module puts a process (and a
network) between them without changing the gateway at all:

- :class:`ReplicaServer` wraps one engine in its own process and mounts
  a small JSON-over-HTTP control surface (``/submit`` ``/poll``
  ``/cancel`` ``/drain`` ``/load`` ``/shutdown``) on the SAME
  :class:`telemetry.exporter.MetricsExporter` that already serves
  ``/metrics`` and the probes — one hardened stdlib HTTP stack, one
  port, so the transport address IS the scrape address the fleet plane
  discovers from heartbeats.
- :class:`ReplicaClient` implements the exact engine surface the
  gateway drives (``submit``/``step``/``busy``/``drain``/``cancel``/
  ``shutdown``/``load``/``occupied_slots``/``num_slots``/``queue``/
  ``pool``/``draining``/``drained``/``replica_id``), so
  ``ServeGateway([ReplicaClient(...), ...])`` gives remote replicas
  health routing, circuit breakers, drain and in-flight migration
  for free — a client call that fails after bounded retries raises out
  of the gateway's ``step()`` and is scored like any other dispatch
  failure.

Robustness contract:

- **Idempotent submit.** Every dispatch gets a client-minted key
  ``request_id@seq``. A retry after an AMBIGUOUS failure (the request
  landed, the response was lost) hits the server's dispatch ledger and
  answers ``duplicate: true`` instead of admitting twice; a NEW
  dispatch of the same request_id (migrated away and back) gets a new
  key and is a legitimate fresh admission.
- **Exactly-once streaming.** The client owns the emitted-token cursor
  per dispatch and sends it with every ``/poll``; the server answers
  ``tokens[cursor:]``. A lost poll response re-delivers nothing the
  client already consumed and loses nothing it hasn't — reconnects
  splice bit-identically.
- **Deadline-aware calls, bounded retries.** Every call carries a
  socket timeout (capped by the request's remaining deadline on
  submit) and retries transiently with the shared full-jitter backoff
  (``utils.retry``); submit exhaustion maps to
  :class:`EngineDraining` so the gateway routes elsewhere, poll
  exhaustion raises so the breaker counts it.
- **Fault sites.** ``transport_send`` fires client-side before every
  HTTP attempt (unambiguous: the request never left); ``transport_recv``
  fires server-side AFTER the handler ran and BEFORE the response is
  written — ``ioerror``/``drop``/``partition`` there make the exporter
  sever the connection with the work already done, the precise shape of
  an ambiguous network failure.

Health signals for routing come from the same ``/metrics`` exposition
the fleet plane scrapes (queue depth, KV pressure, slot occupancy —
the server registers instantaneous ``serve_slots_*`` gauges for this),
cached client-side and refreshed on an interval; every ``/poll``
response piggybacks the same fields so an actively-stepped replica is
always fresh. An unreachable replica keeps its stale (pessimistic-
enough) snapshot — liveness is the breaker's job, not the router's.

The server's dispatch ledger retains terminal records for the life of
the process (bounded by requests served): a record must outlive its
request so a retried submit whose first attempt both landed AND
finished still deduplicates.

Disaggregated serving (graftsplit, ``serve/disagg.py``) rides the same
surface with three additions:

- **Role beacons.** A server advertises its *role* ("decode" or
  "prefill") as a heartbeat extra; :func:`discover_replica_clients`
  filters on it (default ``role="decode"``) so a gateway or autoscale
  backend discovering a shared heartbeat directory never adopts a
  prefill worker as a decode replica.
- **``/pages``** — chunked, idempotent KV page shipping. Chunks carry a
  deterministic transfer key; the server stages raw chunk text (never
  pool pages — an abandoned transfer cannot leak), adopts the blob via
  ``engine.import_request_kv`` when the last chunk lands, and retains
  the adoption result in a transfer ledger so re-sent chunks after an
  ambiguous failure answer ``duplicate: true`` instead of adopting
  twice. The adopted request is registered under the transfer key as a
  dispatch record, so the shipping client streams its tokens through
  the ordinary ``/poll`` path. The ``transport_pages`` fault site fires
  client-side before each chunk leaves.
- **``/exports``** — the prefill worker's pickup point: finished
  prefills (``engine.take_exports()``) are held server-side, encoded,
  until the polling client acknowledges them; a lost response re-
  delivers (the client's seen-set dedups), an acknowledged blob is
  dropped. Matching dispatch records finish with reason ``exported`` —
  a handoff marker, not a client-visible terminal.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable

from k8s_distributed_deeplearning_torch import faults as _faults
from k8s_distributed_deeplearning_torch.serve.disagg import (
    decode_blob, encode_blob, request_from_blob)
from k8s_distributed_deeplearning_torch.serve.disagg import (
    transfer_key as _blob_transfer_key)
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, SamplingParams)
from k8s_distributed_deeplearning_torch.telemetry import heartbeat as hb
from k8s_distributed_deeplearning_torch.telemetry.bridge import (
    sched_collector, serving_collector)
from k8s_distributed_deeplearning_torch.telemetry.exporter import (
    MetricsExporter)
from k8s_distributed_deeplearning_torch.telemetry.fleet import (
    discover_endpoints, parse_exposition)
from k8s_distributed_deeplearning_torch.telemetry.registry import (
    MetricsRegistry)
from k8s_distributed_deeplearning_torch.utils.metrics import (
    MetricsLogger, ServingStats)
from k8s_distributed_deeplearning_torch.utils.retry import retry_transient

_JSON = "application/json"
# The longest the step loop waits between two engine iterations for the
# route handlers in progress to take the lock first.
_HANDLER_YIELD_S = 0.02
# /pages chunk size, in characters of a blob's JSON text. JAX's default is
# 262,144; a chunk costs a round trip and a JSON parse on either side, and
# at Llama-3 8B's page sizes 16 MiB chunks moved pages 1.7x faster on an
# H100 host (PERF.md, phase S1). Any size gives the same transfer.
PAGES_CHUNK_CHARS = 16 * 2 ** 20


def _reply(code: int, obj: dict) -> tuple[int, str, bytes]:
    return code, _JSON, json.dumps(obj).encode()


def request_to_wire(req: Request, *, deadline_s: float | None) -> dict:
    """The bit-parity-critical serialization: everything the engine's
    decode depends on (prompt, budget, sampling, seed) plus identity and
    accounting fields. *deadline_s* is the REMAINING budget at send time
    — wall clocks don't travel between processes, so the server re-
    anchors it at its own admission instant."""
    return {
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": req.sampling.temperature,
        "top_k": req.sampling.top_k,
        "top_p": req.sampling.top_p,
        "request_id": req.request_id,
        "seed": int(req.seed),
        "tenant": req.tenant,
        "deadline_s": deadline_s,
        "migrated_from": req.migrated_from,
        "trace_id": req.trace_id,
    }


def request_from_wire(msg: dict) -> Request:
    """Inverse of :func:`request_to_wire`. Raises ValueError on anything
    the engine's own static checks would reject (mapped to a 400)."""
    sampling = SamplingParams(
        temperature=float(msg.get("temperature", 0.0)),
        top_k=int(msg.get("top_k", 0)),
        top_p=float(msg.get("top_p", 1.0)))
    deadline = msg.get("deadline_s")
    kwargs: dict = dict(
        prompt=[int(t) for t in msg["prompt"]],
        max_new_tokens=int(msg["max_new_tokens"]),
        sampling=sampling,
        request_id=str(msg["request_id"]),
        seed=int(msg.get("seed", 0)),
        tenant=str(msg.get("tenant", "default")),
        deadline_s=float(deadline) if deadline is not None else None,
        migrated_from=msg.get("migrated_from"))
    if msg.get("trace_id"):
        # Carried verbatim so graftscope stitches the gateway-side and
        # replica-side halves of one request into one timeline; absent,
        # the Request default factory mints a local one.
        kwargs["trace_id"] = str(msg["trace_id"])
    return Request(**kwargs)


class _Record:
    """Server-side ledger entry for one dispatch: the local Request, its
    token stream (the poll source of truth) and its terminal reason."""

    __slots__ = ("req", "tokens", "finished")

    def __init__(self, req: Request):
        self.req = req
        self.tokens: list[int] = []
        self.finished: str | None = None


class ReplicaServer:
    """One :class:`ServeEngine` behind a wire, sharing the exporter (any
    object with the engine surface the handlers call serves: the tests
    put a deterministic fake engine here).

    The engine is single-threaded by design; ALL access — the internal
    step loop and every HTTP handler — is serialized under one lock.
    Handlers are short (submit/poll/cancel bookkeeping); the step loop
    holds the lock for one engine iteration at a time and waits on the
    condition while idle, so an idle replica burns no CPU and a submit
    wakes it immediately. Between iterations the loop lets every handler
    that is waiting for the lock go first: Python's lock is not fair, and
    a loop that re-takes it at once would hold a handler for many engine
    steps.

    *registry* defaults to a fresh :class:`MetricsRegistry` wired with
    the serving + scheduler collectors over this engine, plus
    instantaneous ``serve_slots_occupied`` / ``serve_slots_total`` /
    ``serve_engine_load`` gauges — the exposition the client's health
    cache (and the fleet plane) reads. *heartbeat_dir* additionally
    advertises ``metrics_addr=host:port`` through the heartbeat plane
    (:func:`discover_replica_clients` is the consuming end).

    ``/healthz`` stays 200 while the step loop lives (draining or not —
    don't restart a draining pod); ``/readyz`` turns 503 the moment
    ``drain()`` is called (stop routing to it). A step-loop crash fails
    BOTH probes and turns every ``/submit``/``/poll`` into a 500, which
    the client surfaces as a dispatch failure for the breaker.
    """

    def __init__(self, engine, *, host: str = "127.0.0.1",
                 port: int = 0, advertise_host: str | None = None,
                 registry: MetricsRegistry | None = None,
                 logger: MetricsLogger | None = None,
                 heartbeat_dir: str | None = None, rank: int = 0,
                 heartbeat_interval_s: float = 2.0,
                 idle_wait_s: float = 0.005,
                 flight=None, handler_timeout: float = 30.0,
                 role: str = "decode"):
        self.engine = engine
        self.logger = logger
        self.flight = flight
        self.stats = engine.stats
        # Advertised through the heartbeat plane so role-filtered
        # discovery can tell prefill workers from decode replicas.
        self.role = str(role)
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._records: dict[str, _Record] = {}
        self._flushed_ids: list[str] = []
        # /pages transfer state: in-flight chunk text per transfer key
        # (strings only — an abandoned transfer holds no pool pages) and
        # the retained adoption results (the exactly-once ledger).
        self._page_parts: dict[str, dict[int, str]] = {}
        self._page_results: dict[str, dict] = {}
        # /exports hold: encoded blobs awaiting client acknowledgement.
        self._export_hold: dict[str, dict] = {}
        # Locks of the transfer state and the export hold, each taken
        # before the engine's lock and never inside it.
        self._pages_lock = threading.Lock()
        self._exports_lock = threading.Lock()
        self._step_error: str | None = None
        self._steps = 0
        # Route handlers in progress (waiting for or holding the lock);
        # the step loop yields to them between iterations.
        self._handlers = 0
        self._handlers_lock = threading.Lock()
        self.idle_wait_s = idle_wait_s
        if registry is None:
            registry = MetricsRegistry()
            serving_collector(registry, engine.stats)
            sched_collector(registry, engine.queue)
            self._register_engine_gauges(registry)
        self.registry = registry
        routes = {
            "/submit": self._guard(self._h_submit),
            "/poll": self._guard(self._h_poll),
            "/cancel": self._guard(self._h_cancel),
            "/drain": self._guard(self._h_drain),
            "/load": self._guard(self._h_load),
            "/shutdown": self._guard(self._h_shutdown),
            "/pages": self._guard(self._h_pages),
            "/exports": self._guard(self._h_exports),
        }
        self.exporter = MetricsExporter(
            registry, host=host, port=port,
            healthz=self._healthz, readyz=self._readyz,
            routes=routes, flight=flight,
            handler_timeout=handler_timeout)
        self.port = self.exporter.port
        self.address = f"{advertise_host or host}:{self.port}"
        self._hb = (hb.HeartbeatWriter(heartbeat_dir, rank)
                    if heartbeat_dir else None)
        self._hb_interval = heartbeat_interval_s
        self._hb_last = 0.0
        self._thread: threading.Thread | None = None

    def _register_engine_gauges(self, registry: MetricsRegistry) -> None:
        occ = registry.gauge(
            "serve_slots_occupied",
            "decode slots currently holding a request (instantaneous)")
        tot = registry.gauge(
            "serve_slots_total", "decode slots this replica runs")
        load = registry.gauge(
            "serve_engine_load",
            "queued + mid-prefill + decoding requests (instantaneous)")

        def collect() -> None:
            occ.set(float(self.engine.occupied_slots()))
            tot.set(float(self.engine.num_slots))
            load.set(float(self.engine.load()))

        registry.register_collector(collect)

    # ------------------------------------------------------------- probes

    def _healthz(self) -> dict:
        with self._cond:
            if self._step_error is not None:
                raise RuntimeError(f"step loop died: {self._step_error}")
            return {"draining": self.engine.draining,
                    "drained": self.engine.drained,
                    "steps": self._steps}

    def _readyz(self) -> dict:
        with self._cond:
            return {"ready": self._step_error is None
                    and not self.engine.draining,
                    "draining": self.engine.draining}

    # ----------------------------------------------------------- handlers

    def _guard(self, inner: Callable) -> Callable:
        """Wrap a route handler with the server-side fault site. The site
        fires AFTER the handler ran and BEFORE the response is written:
        an OSError here (ioerror / drop / partition) returns None, which
        the exporter translates into a severed connection — the request
        took effect, the caller will never know. The exact anatomy of an
        ambiguous network failure, and what the dispatch ledger exists
        to absorb."""

        def handler(method: str, query: str, body: bytes):
            with self._handlers_lock:
                self._handlers += 1
            try:
                result = inner(method, query, body)
            finally:
                with self._handlers_lock:
                    self._handlers -= 1
            inj = _faults.active()
            if inj is not None:
                try:
                    inj.fire("transport_recv")
                except OSError:
                    return None
            return result

        return handler

    def _h_submit(self, method: str, query: str, body: bytes):
        msg = json.loads(body.decode() or "{}")
        key = str(msg["dispatch"])
        with self._cond:
            if key in self._records:
                self.stats.record_transport_dedup()
                if self.logger is not None:
                    self.logger.emit(
                        "transport_submit_deduped", dispatch=key,
                        request_id=self._records[key].req.request_id)
                if self.flight is not None:
                    self.flight.record("transport", dedup=key)
                return _reply(200, {"ok": True, "duplicate": True})
            if self._step_error is not None:
                return _reply(500, {"error": self._step_error})
            try:
                req = request_from_wire(msg["request"])
            except (KeyError, TypeError, ValueError) as e:
                return _reply(400, {"error": repr(e)})
            rec = _Record(req)
            req.on_token = rec.tokens.append
            req.on_finish = (
                lambda reason, rec=rec: setattr(rec, "finished", reason))
            try:
                self.engine.submit(req, requeue=bool(msg.get("requeue")))
            except QueueFull as e:
                return _reply(429, {"error": str(e)})
            except EngineDraining as e:
                return _reply(503, {"error": str(e)})
            except ValueError as e:
                return _reply(400, {"error": str(e)})
            self._records[key] = rec
            self._cond.notify_all()
        return _reply(200, {"ok": True, "duplicate": False})

    def _h_poll(self, method: str, query: str, body: bytes):
        msg = json.loads(body.decode() or "{}")
        cursors = msg.get("streams", {})
        with self._cond:
            if self._step_error is not None:
                return _reply(500, {"error": self._step_error})
            streams: dict[str, dict] = {}
            for key, cur in cursors.items():
                rec = self._records.get(key)
                if rec is None:
                    streams[key] = {"unknown": True}
                    continue
                cur = max(0, int(cur))
                streams[key] = {"tokens": rec.tokens[cur:],
                                "finished": rec.finished}
            return _reply(200, {"streams": streams,
                                **self._health_fields()})

    def _h_cancel(self, method: str, query: str, body: bytes):
        msg = json.loads(body.decode() or "{}")
        with self._cond:
            out = self.engine.cancel(str(msg["request_id"]),
                                     str(msg.get("reason", "aborted")))
            return _reply(200, {"cancelled": out is not None})

    def _h_drain(self, method: str, query: str, body: bytes):
        msg = json.loads(body.decode() or "{}")
        with self._cond:
            flushed = self.engine.drain(flush=bool(msg.get("flush")))
            for req in flushed:
                self._flushed_ids.append(req.request_id)
                for rec in self._records.values():
                    if (rec.req.request_id == req.request_id
                            and rec.finished is None):
                        rec.finished = "migrated"
            if self.flight is not None:
                self.flight.record("transport", drain=True,
                                   flushed=len(self._flushed_ids))
            self._cond.notify_all()
            # The FULL accumulated flush list, not this call's delta: a
            # drain whose response was lost must be retryable without
            # the flushed requests falling through the crack (the
            # second call's delta would be empty).
            return _reply(200, {"flushed": list(self._flushed_ids),
                                **self._health_fields()})

    def _h_load(self, method: str, query: str, body: bytes):
        with self._cond:
            return _reply(200, self._health_fields())

    def _h_shutdown(self, method: str, query: str, body: bytes):
        with self._cond:
            outs = self.engine.shutdown()
            self._stop.set()
            self._cond.notify_all()
            return _reply(200, {"ok": True,
                                "aborted": [o.request_id for o in outs]})

    def _h_pages(self, method: str, query: str, body: bytes):
        """One chunk of a KV page transfer. Chunks accumulate as raw
        text under the client-minted transfer key; the final chunk
        decodes the blob and adopts it. Adoption results are retained so
        a re-sent chunk after an ambiguous failure gets the ORIGINAL
        result back (``duplicate: true``) — adoption is exactly-once per
        transfer key for the life of the process.

        The transfer state has a lock of its own, taken before the
        engine's and never inside it: staging a chunk and decoding the
        blob do not wait for, or hold up, the step loop; only the
        adoption itself runs under the engine lock."""
        msg = json.loads(body.decode() or "{}")
        key = str(msg["transfer"])
        part = int(msg["part"])
        total = int(msg["parts"])
        with self._pages_lock:
            done = self._page_results.get(key)
            if done is not None:
                self.stats.record_transport_dedup()
                if self.flight is not None:
                    self.flight.record("transport", pages_dedup=key)
                return _reply(200, {**done, "duplicate": True})
            parts = self._page_parts.setdefault(key, {})
            parts[part] = str(msg["data"])
            if len(parts) < total:
                return _reply(200, {"ok": True, "adopted": False,
                                    "received": len(parts)})
            try:
                blob = decode_blob(json.loads(
                    "".join(parts[i] for i in range(total))))
                req = request_from_blob(blob)
            except (KeyError, TypeError, ValueError) as e:
                self._page_parts.pop(key, None)
                return _reply(400, {"error": repr(e)})
            rec = _Record(req)
            req.on_token = rec.tokens.append
            req.on_finish = (
                lambda reason, rec=rec: setattr(rec, "finished", reason))
            with self._cond:
                if self._step_error is not None:
                    return _reply(500, {"error": self._step_error})
                if not self.engine.can_import(blob):
                    # Definitive no (slots/pages right now) — chunks are
                    # kept, so a later retry of the same key is cheap.
                    return _reply(429, {
                        "error": "cannot adopt: no free slot or "
                                 "insufficient KV pages"})
                try:
                    slot = self.engine.import_request_kv(blob, request=req)
                except EngineDraining as e:
                    return _reply(503, {"error": str(e)})
                except ValueError as e:
                    self._page_parts.pop(key, None)
                    return _reply(400, {"error": str(e)})
                except RuntimeError as e:
                    return _reply(429, {"error": str(e)})
                result = {"ok": True, "adopted": True, "slot": int(slot),
                          "request_id": req.request_id}
                self._page_results[key] = result
                # Pollable under the transfer key: the shipping client
                # streams the adopted request's NEW tokens from cursor 0
                # (emitted-so-far traveled in the blob, not the record).
                self._records[key] = rec
                self._cond.notify_all()
            self._page_parts.pop(key, None)
            if self.flight is not None:
                self.flight.record("transport", pages_adopted=key,
                                   pages=int(blob["n_pages"]))
            return _reply(200, result)

    def _h_exports(self, method: str, query: str, body: bytes):
        """Prefill-side pickup: acknowledge-then-hand-over. Acked blobs
        are dropped; everything the engine exported since last call
        joins the hold (marking its dispatch record ``exported`` so the
        submitting client's poll sees a handoff terminal); the FULL hold
        is returned — a lost response re-delivers and the client's
        seen-set dedups, so no export is ever lost or double-shipped.
        The blobs are encoded outside the engine lock, under the hold's
        own."""
        msg = json.loads(body.decode() or "{}")
        with self._cond:
            if self._step_error is not None:
                return _reply(500, {"error": self._step_error})
            fresh = self.engine.take_exports()
            for blob in fresh:
                for rec in self._records.values():
                    if (rec.req.request_id == blob["request_id"]
                            and rec.finished is None):
                        rec.finished = "exported"
            health = self._health_fields()
        with self._exports_lock:
            for k in msg.get("ack", ()):
                self._export_hold.pop(str(k), None)
            for blob in fresh:
                self._export_hold[_blob_transfer_key(blob)] = (
                    encode_blob(blob))
            exports = dict(self._export_hold)
        return _reply(200, {"exports": exports, **health})

    def _health_fields(self) -> dict:
        """Piggybacked on every poll/drain/load response: the same
        signals the /metrics health scrape carries, at zero extra
        round-trips for an actively-polled replica. Caller holds the
        lock."""
        c = self.engine.pool.counters()
        return {"busy": self.engine.busy(),
                "load": self.engine.load(),
                "draining": self.engine.draining,
                "drained": self.engine.drained,
                "occupied_slots": self.engine.occupied_slots(),
                "num_slots": self.engine.num_slots,
                "queue_depth": len(self.engine.queue),
                "kv_pages_used": c["pages_used"],
                "kv_pages_total": c["pages_total"]}

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ReplicaServer":
        self.exporter.start()
        self._thread = threading.Thread(
            target=self._step_loop, name="replica-step", daemon=True)
        self._thread.start()
        self._beat(force=True)
        return self

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if self.engine.busy():
                    try:
                        # Stepping while holding _cond is the single-lock
                        # design: the engine is not thread-safe, so ALL
                        # access — handlers included — serializes on this
                        # one lock, and the loop yields it via the
                        # condition wait whenever the engine goes idle.
                        # graftlint: disable=lock-discipline
                        self.engine.step()
                        self._steps += 1
                    except Exception as e:   # noqa: BLE001 — the loop is
                        # this process's dispatch plane; record the cause
                        # (handlers answer 500, probes go red) instead of
                        # dying silently in a daemon thread.
                        self._step_error = repr(e)
                        return
                else:
                    self._cond.wait(self.idle_wait_s)
            # A handler is waiting: it goes first (for at most
            # _HANDLER_YIELD_S, so back-to-back calls cannot starve the
            # engine).
            until = time.monotonic() + _HANDLER_YIELD_S
            while (self._handlers and not self._stop.is_set()
                   and time.monotonic() < until):
                time.sleep(0.0002)
            self._beat()

    def _beat(self, force: bool = False) -> None:
        if self._hb is None:
            return
        now = time.monotonic()
        if force or now - self._hb_last >= self._hb_interval:
            self._hb_last = now
            with self._cond:
                steps = self._steps
            self._hb.beat(step=steps, metrics_addr=self.address,
                          role=self.role)

    def begin_drain(self) -> None:
        """Local drain, under the server's lock (the CLI's SIGTERM path):
        the same as a ``/drain`` without flush. ``/readyz`` turns 503, new
        submits answer 503, and :attr:`drained` turns True once the held
        work has finished."""
        with self._cond:
            self.engine.drain()
            self._cond.notify_all()

    def serve_forever(self, poll_s: float = 0.05) -> None:
        """Block until :meth:`close` (or /shutdown) — the CLI's replica
        process main loop."""
        while not self._stop.wait(poll_s):
            pass

    @property
    def drained(self) -> bool:
        with self._cond:
            return self.engine.drained

    @property
    def shutting_down(self) -> bool:
        """True once /shutdown was served (or :meth:`close` began) —
        the CLI's replica main loop exits on it."""
        return self._stop.is_set()

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.exporter.stop()
        if self._hb is not None:
            # Clean shutdown removes the beacon: a deliberately-gone
            # replica must never be rediscovered as a live endpoint.
            self._hb.remove()


# --------------------------------------------------------------- client


class _QueueProxy:
    """``len(client.queue)`` for the gateway's health score, backed by
    the cached health snapshot."""

    __slots__ = ("_client",)

    def __init__(self, client: "ReplicaClient"):
        self._client = client

    def __len__(self) -> int:
        return int(self._client._health["queue_depth"])


class _PoolProxy:
    """``client.pool.counters()`` for the gateway's KV-pressure signal."""

    __slots__ = ("_client",)

    def __init__(self, client: "ReplicaClient"):
        self._client = client

    def counters(self) -> dict:
        h = self._client._health
        return {"pages_used": int(h["kv_pages_used"]),
                "pages_total": int(h["kv_pages_total"])}


class _Stream:
    """Client-side cursor for one dispatch: tokens delivered so far."""

    __slots__ = ("req", "sent")

    def __init__(self, req: Request):
        self.req = req
        self.sent = 0


class ReplicaClient:
    """The gateway-facing half: an engine-shaped proxy for one remote
    :class:`ReplicaServer`.

    One ``step()`` is ONE ``/poll`` round-trip carrying every live
    stream's cursor; the response delivers each stream's new tokens into
    the gateway's shadow callbacks and piggybacks the health snapshot.
    Transport failures behave exactly like the engine failures the
    gateway already handles: a poll that exhausts its retries raises
    (breaker scores it), a submit that exhausts retries raises
    :class:`EngineDraining` (router goes elsewhere), cancel/shutdown
    swallow transport errors (both are advisory against a replica that
    may already be gone).

    *rng*/*sleep*/*clock* are injectable for deterministic tests; the
    retry schedule is the shared full-jitter policy of
    :func:`utils.retry.retry_transient`.
    """

    def __init__(self, endpoint: str, *, replica_id: str | None = None,
                 timeout_s: float = 5.0, retries: int = 2,
                 backoff_s: float = 0.1,
                 health_refresh_s: float = 1.0,
                 stats: ServingStats | None = None,
                 logger: MetricsLogger | None = None,
                 rng: Callable[[], float] | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.perf_counter,
                 flight=None):
        self.endpoint = endpoint if "://" in endpoint else f"http://{endpoint}"
        self.replica_id = replica_id
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.health_refresh_s = health_refresh_s
        self.stats = stats if stats is not None else ServingStats()
        self.logger = logger
        self.flight = flight
        self._rng = rng
        self._sleep = sleep
        self._clock = clock
        self._seq = 0
        self._streams: dict[str, _Stream] = {}
        self._poll_failures = 0
        # /exports bookkeeping: keys to acknowledge on the next pickup
        # and keys already handed to the caller (re-delivery dedup).
        self._export_acks: list[str] = []
        self._seen_exports: set[str] = set()
        self._health: dict = {
            "busy": False, "load": 0, "draining": False, "drained": False,
            "occupied_slots": 0, "num_slots": 1, "queue_depth": 0,
            "kv_pages_used": 0, "kv_pages_total": 0}
        self._health_t: float | None = None
        self.queue = _QueueProxy(self)
        self.pool = _PoolProxy(self)

    # ------------------------------------------------------------- wire

    def _call(self, path: str, payload: dict, *,
              timeout: float | None = None,
              site: str = "transport_send") -> dict:
        """POST *payload* with bounded full-jitter retries. Fires the
        *site* fault site before every attempt (inside the retry loop,
        so count-scoped faults expire across retries) — the control
        surface fires ``transport_send``, page shipping fires
        ``transport_pages``. Server-mapped statuses surface as their
        typed exceptions and are never retried; only OSError (connection
        refused/reset, timeouts, injected network faults) is
        transient."""
        data = json.dumps(payload).encode()

        def attempt() -> dict:
            inj = _faults.active()
            if inj is not None:
                # Literal site names: the fault-site lint pass resolves
                # live hooks from string constants at .fire() calls.
                if site == "transport_pages":
                    inj.fire("transport_pages")
                else:
                    inj.fire("transport_send")
            httpreq = urllib.request.Request(
                self.endpoint + path, data=data,
                headers={"Content-Type": _JSON}, method="POST")
            try:
                with urllib.request.urlopen(
                        httpreq, timeout=timeout or self.timeout_s) as resp:
                    return json.loads(resp.read().decode() or "{}")
            except urllib.error.HTTPError as e:
                raise self._map_status(e) from e

        def on_retry(n: int, e: Exception, delay: float) -> None:
            self.stats.record_transport_retry()
            if self.logger is not None:
                self.logger.emit("transport_retry",
                                 replica=self.replica_id, call=path,
                                 attempt=n, delay_s=round(delay, 4),
                                 error=repr(e))

        return retry_transient(
            attempt, retries=self.retries, backoff_s=self.backoff_s,
            sleep=self._sleep, jitter=True, rng=self._rng,
            is_transient=lambda e: isinstance(e, OSError),
            on_retry=on_retry)

    @staticmethod
    def _map_status(e: urllib.error.HTTPError) -> Exception:
        """HTTPError is an OSError subclass — convert the server's typed
        rejections BEFORE the transient predicate can retry them."""
        try:
            msg = json.loads(e.read().decode() or "{}").get("error", "")
        except Exception:   # noqa: BLE001 — diagnostic body only
            msg = ""
        detail = f"replica answered {e.code}: {msg or e.reason}"
        if e.code == 429:
            return QueueFull(detail)
        if e.code == 503:
            return EngineDraining(detail)
        if e.code == 400:
            return ValueError(detail)
        return RuntimeError(detail)

    def _apply_health(self, body: dict) -> None:
        for k in self._health:
            if k in body:
                self._health[k] = body[k]
        self._health_t = self._clock()

    def _refresh_health(self) -> None:
        """Scrape ``/metrics`` — the SAME exposition the fleet plane
        reads — when the cached snapshot is older than
        ``health_refresh_s``. A failed scrape keeps the stale snapshot:
        routing decisions degrade gracefully while the breaker (fed by
        poll failures) owns liveness."""
        now = self._clock()
        if (self._health_t is not None
                and now - self._health_t < self.health_refresh_s):
            return
        try:
            with urllib.request.urlopen(self.endpoint + "/metrics",
                                        timeout=self.timeout_s) as resp:
                fams = parse_exposition(
                    resp.read().decode("utf-8", errors="replace"))
        except (OSError, ValueError):
            # Stamp the attempt anyway: a dead replica must not turn
            # every routing-score read into a fresh blocking scrape.
            self._health_t = now
            return
        scalars = {"occupied_slots": "serve_slots_occupied",
                   "num_slots": "serve_slots_total",
                   "load": "serve_engine_load",
                   "kv_pages_used": "serve_kv_pages_used",
                   "kv_pages_total": "serve_kv_pages_total"}
        for key, name in scalars.items():
            fam = fams.get(name)
            if fam is not None and fam.samples:
                self._health[key] = int(fam.samples[0].value)
        fam = fams.get("sched_queue_depth")
        if fam is not None and fam.samples:
            self._health["queue_depth"] = int(
                sum(s.value for s in fam.samples))
        self._health_t = now

    # --------------------------------------------------- engine surface

    def submit(self, req: Request, *, requeue: bool = False) -> str:
        """Idempotent remote admission. Mints a fresh dispatch key — a
        retry of THIS call dedupes on the server, a later re-dispatch
        of the same request_id (migration) is a new admission with its
        own stream cursor."""
        self._seq += 1
        key = f"{req.request_id}@{self._seq}"
        deadline = None
        if req.deadline_s is not None:
            if req._t_submit is not None:
                deadline = max(
                    0.0, req.deadline_s - (self._clock() - req._t_submit))
            else:
                deadline = req.deadline_s
        payload = {"dispatch": key, "requeue": bool(requeue),
                   "request": request_to_wire(req, deadline_s=deadline)}
        timeout = (self.timeout_s if deadline is None
                   else min(self.timeout_s, max(deadline, 0.05)))
        try:
            self._call("/submit", payload, timeout=timeout)
        except OSError as e:
            # Exhausted retries with the outcome UNKNOWN (the dispatch
            # may have landed; its key is abandoned, so a duplicate
            # admission can never stream to the client). EngineDraining
            # makes the gateway route elsewhere instead of failing the
            # client request.
            raise EngineDraining(
                f"replica {self.replica_id or self.endpoint} unreachable "
                f"for submit of {req.request_id}: {e!r}") from e
        self._streams[key] = _Stream(req)
        if req._t_submit is None:
            req._t_submit = self._clock()
        return req.request_id

    def step(self) -> list:
        """One poll round-trip: ship every live cursor, deliver new
        tokens and terminals into the shadow callbacks, refresh the
        health snapshot from the piggyback. Raises on transport
        exhaustion or a replica that lost our streams (restarted) —
        the gateway's breaker handles both."""
        cursors = {key: st.sent for key, st in self._streams.items()}
        try:
            body = self._call("/poll", {"streams": cursors})
        except Exception:
            self._poll_failures += 1
            raise
        if self._poll_failures and cursors:
            self.stats.record_transport_reconnect()
            if self.logger is not None:
                self.logger.emit("transport_reconnect",
                                 replica=self.replica_id,
                                 streams=len(cursors),
                                 failed_polls=self._poll_failures)
            if self.flight is not None:
                self.flight.record("transport",
                                   reconnect=self.replica_id,
                                   failed_polls=self._poll_failures)
        self._poll_failures = 0
        self._apply_health(body)
        unknown: list[str] = []
        for key, entry in list(body.get("streams", {}).items()):
            st = self._streams.get(key)
            if st is None:
                continue
            if entry.get("unknown"):
                unknown.append(key)
                continue
            for tok in entry.get("tokens", ()):
                st.sent += 1
                if st.req.on_token is not None:
                    st.req.on_token(int(tok))
            reason = entry.get("finished")
            if reason is not None:
                self._streams.pop(key, None)
                if st.req.on_finish is not None:
                    st.req.on_finish(reason)
        if unknown:
            # The server has no record of streams we dispatched: the
            # replica process died and came back empty. Raise so the
            # breaker trips and the gateway migrates from ITS cursor.
            raise RuntimeError(
                f"replica {self.replica_id or self.endpoint} lost "
                f"{len(unknown)} dispatched stream(s) "
                f"(restarted?): {sorted(unknown)[:4]}")
        return []

    # ------------------------------------------------ KV page shipping

    def ship_pages(self, blob: dict, *, req: Request | None = None,
                   transfer_key: str | None = None,
                   chunk_chars: int = PAGES_CHUNK_CHARS) -> dict:
        """Ship one exported KV blob to this replica over ``/pages``,
        chunked. The transfer key defaults to the blob's deterministic
        ``request_id:kv_len`` key — callers retrying an ambiguous
        failure MUST reuse the same key (the server's ledger makes the
        retry exactly-once). Raises the server's typed rejections
        (QueueFull = cannot adopt, EngineDraining, ValueError) or
        OSError after exhausted retries on a chunk. *req*, when given,
        is registered as a poll stream on success so the adopted
        request's tokens keep streaming to its callbacks."""
        key = transfer_key or _blob_transfer_key(blob)
        text = json.dumps(encode_blob(blob))
        parts = ([text[i:i + chunk_chars]
                  for i in range(0, len(text), chunk_chars)] or [""])
        body: dict = {}
        for i, part in enumerate(parts):
            body = self._call(
                "/pages",
                {"transfer": key, "part": i, "parts": len(parts),
                 "data": part},
                site="transport_pages")
            if body.get("duplicate") or body.get("adopted"):
                break      # ledger answered early: transfer already done
        if not body.get("adopted"):
            raise RuntimeError(
                f"page transfer {key} not adopted by "
                f"{self.replica_id or self.endpoint}: {body}")
        if req is not None:
            self._streams[key] = _Stream(req)
        return body

    def take_remote_exports(self) -> list[dict]:
        """Drain the replica's export hold (prefill role): acknowledge
        everything received last call, decode and return only blobs not
        seen before. A lost response costs nothing — the hold re-
        delivers until acked, and the seen-set drops repeats."""
        body = self._call("/exports", {"ack": list(self._export_acks)})
        self._apply_health(body)
        held = body.get("exports", {})
        self._export_acks = list(held.keys())
        fresh: list[dict] = []
        for key, doc in held.items():
            if key in self._seen_exports:
                continue
            self._seen_exports.add(key)
            fresh.append(decode_blob(doc))
        return fresh

    def busy(self) -> bool:
        return bool(self._streams) or bool(self._health["busy"])

    def load(self) -> int:
        self._refresh_health()
        return int(self._health["load"])

    def occupied_slots(self) -> int:
        self._refresh_health()
        return int(self._health["occupied_slots"])

    @property
    def num_slots(self) -> int:
        self._refresh_health()
        return max(1, int(self._health["num_slots"]))

    @property
    def draining(self) -> bool:
        return bool(self._health["draining"])

    @property
    def drained(self) -> bool:
        return bool(self._health["drained"]) and not self._streams

    def drain(self, *, flush: bool = False) -> list[Request]:
        """Remote drain; returns the flushed queued Requests (client-side
        objects) for the gateway to migrate. The server accumulates the
        flush list, so a retried drain still reports everything."""
        body = self._call("/drain", {"flush": bool(flush)})
        self._apply_health(body)
        flushed: list[Request] = []
        for rid in body.get("flushed", []):
            for key, st in list(self._streams.items()):
                if st.req.request_id == rid:
                    del self._streams[key]
                    flushed.append(st.req)
        return flushed

    def cancel(self, request_id: str, reason: str = "aborted") -> None:
        """Advisory: a cancel lost to the network means the request runs
        to completion against a muted shadow — wasted work, not a
        correctness problem. Never raises on transport failure."""
        for key, st in list(self._streams.items()):
            if st.req.request_id == request_id:
                del self._streams[key]
        try:
            self._call("/cancel", {"request_id": request_id,
                                   "reason": reason})
        except (OSError, RuntimeError):
            pass

    def shutdown(self) -> list:
        """Best-effort remote abort (the replica may already be dead —
        that's usually WHY the gateway is shutting it down)."""
        self._streams.clear()
        # Reset the cached snapshot: nothing of ours runs there anymore,
        # and a stale piggybacked busy=True from the replica's last
        # breath would otherwise pin gateway.busy() high forever.
        self._health.update({"busy": False, "load": 0,
                             "occupied_slots": 0, "queue_depth": 0})
        try:
            self._call("/shutdown", {})
        except (OSError, RuntimeError):
            pass
        return []


def discover_replica_clients(heartbeat_dir: str, *,
                             stale_after_s: float | None = None,
                             role: str | None = "decode",
                             **kwargs) -> list[ReplicaClient]:
    """One :class:`ReplicaClient` per ``metrics_addr`` advertised in
    *heartbeat_dir* (the :class:`ReplicaServer` heartbeat extra) — the
    no-static-config path to a remote gateway fleet. *stale_after_s*
    drops beacons older than that age (a crashed replica's leftover file
    is not an endpoint); *kwargs* forward to every client (shared
    stats/logger, timeouts).

    *role* keeps the fleet honest under disaggregation: the default
    ``"decode"`` returns only decode replicas (beacons with no role
    extra count as decode — every pre-disagg server), so a gateway or
    autoscale backend sharing a heartbeat directory with prefill
    workers never adopts one as a decode replica. Pass ``"prefill"``
    for the prefill fleet, or None for everything."""
    return [ReplicaClient(ep, **kwargs)
            for ep in discover_endpoints(heartbeat_dir,
                                         stale_after_s=stale_after_s,
                                         role=role)]
