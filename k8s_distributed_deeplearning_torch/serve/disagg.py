"""graftsplit: disaggregated prefill/decode serving with KV page shipping.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
disagg.py``. Prefill is compute-bound and wants big chunks; decode is
latency-bound and wants nothing else on the card. This module splits the
two phases across engines (and, over ``serve/transport.py``, across
processes) and ships a finished prompt's KV pages between them:

- **Prefill role.** A :class:`ServeEngine` built with
  ``prefill_only=True`` admits and prefills, then exports the request's
  written pages BY VALUE instead of entering decode; :class:`PrefillWorker`
  (in-process) and :class:`RemotePrefillWorker` (a ``ReplicaClient`` to a
  ``role="prefill"`` replica server) wrap the two transports behind one
  surface (``submit`` / ``step`` / ``take_exports`` / ``load``).
- **Decode role.** Any ordinary engine (or a ``ReplicaClient`` to one)
  adopts the blob with ``import_request_kv``: pages land under the pool's
  ``imported`` owner tag, and decode resumes from the shipped cursor
  (next token, sampling registers and the generator state travel in the
  blob).
- **Coordinator.** :class:`DisaggCoordinator` routes prompts to the
  least-loaded live prefill worker, hands each export to the least-loaded
  decode engine that can adopt it, and **falls back to the unified
  decode-local prefill path whenever no prefill worker is live or no
  decode engine can adopt**: disaggregation is a performance mode, never
  an availability dependency.

Exactly-once across the wire: transfers carry a deterministic key
(``request_id:kv_len``); the server's transfer ledger answers duplicates
with the original adoption result, so a retry after an ambiguous failure
can never double-adopt, and an abandoned partial transfer holds only
bytes, never pool pages.

The wire codec lives here (:func:`encode_blob` / :func:`decode_blob`); the
blob's layout is the engine's (``serve/engine.py``, "Blob layout"), the
port's own, so a blob does not cross packages. This module does not
import the transport: workers and decode targets are duck-typed. The
``transport_pages`` fault site fires on the in-process shipping path here
and, for wire targets, inside ``ReplicaClient`` before each ``/pages``
chunk.
"""
from __future__ import annotations

__all__ = ["DisaggCoordinator", "PrefillWorker", "RemotePrefillWorker",
           "encode_blob", "decode_blob", "request_from_blob",
           "transfer_key", "blob_nbytes"]

import base64
import time
from typing import Callable

import numpy as np

from k8s_distributed_deeplearning_torch.faults import inject as _faults
from k8s_distributed_deeplearning_torch.serve.engine import (
    _request_from_blob)
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, RequestOutput)
from k8s_distributed_deeplearning_torch.utils.metrics import (
    MetricsLogger, ServingStats)

# ------------------------------------------------------------- wire codec
#
# The export blob holds numpy arrays (staged pages, generator state); the
# wire form is pure JSON. Host perf_counter timestamps are STRIPPED: a
# process's clock does not travel, so the importer re-anchors timing at
# its own adoption instant.

_STRIP_FOR_WIRE = ("t_submit", "t_admit", "t_first")
_ARRAYS = ("pages", "generator_state")


def _enc_arr(a: np.ndarray) -> dict:
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(
                np.ascontiguousarray(a).tobytes()).decode("ascii")}


def _dec_arr(doc: dict) -> np.ndarray:
    flat = np.frombuffer(base64.b64decode(doc["b64"]),
                         dtype=np.dtype(str(doc["dtype"])))
    return flat.reshape([int(d) for d in doc["shape"]]).copy()


def encode_blob(blob: dict) -> dict:
    """Engine export blob -> JSON-safe document (arrays as base64, each
    with its numpy dtype and shape: bf16 pages are already their int16
    view, so every array round-trips bit for bit)."""
    doc = {k: v for k, v in blob.items()
           if k not in _ARRAYS and k not in _STRIP_FOR_WIRE}
    gs = blob.get("generator_state")
    doc["generator_state"] = (None if gs is None
                              else _enc_arr(np.asarray(gs, np.uint8)))
    doc["pages"] = [_enc_arr(np.asarray(p)) for p in blob["pages"]]
    return doc


def decode_blob(doc: dict) -> dict:
    """Inverse of :func:`encode_blob`; raises KeyError/ValueError on a
    malformed document."""
    blob = {k: v for k, v in doc.items() if k not in _ARRAYS}
    gs = doc["generator_state"]
    blob["generator_state"] = None if gs is None else _dec_arr(gs)
    blob["pages"] = [_dec_arr(p) for p in doc["pages"]]
    return blob


def request_from_blob(blob: dict) -> Request:
    """The live Request a wire-side importer attaches callbacks to: field
    for field what ``import_request_kv`` rebuilds itself."""
    return _request_from_blob(blob)


def transfer_key(blob: dict) -> str:
    """Deterministic idempotency key for one shipped KV state, keyed on
    the cursor too: re-exporting the same request after more decode
    progress is a different transfer."""
    return f"{blob['request_id']}:{int(blob['kv_len'])}"


def blob_nbytes(blob: dict) -> int:
    return int(sum(np.asarray(p).nbytes for p in blob["pages"]))


# ----------------------------------------------------------------- roles


class PrefillWorker:
    """In-process prefill role: one ``prefill_only=True`` engine behind the
    worker surface the coordinator drives. The engine is driven by
    :meth:`step` (never ``run()``); finished prefills surface through
    :meth:`take_exports` the step they complete."""

    def __init__(self, engine, *, worker_id: str | None = None):
        if not getattr(engine, "prefill_only", False):
            raise ValueError(
                "PrefillWorker needs a ServeEngine built with "
                "prefill_only=True (a decode-capable engine would eat "
                "the request instead of exporting it)")
        self.engine = engine
        self.worker_id = worker_id or (
            getattr(engine, "replica_id", None) or f"prefill-{id(engine):x}")
        self.alive = True

    def submit(self, req: Request, *, requeue: bool = False) -> None:
        self.engine.submit(req, requeue=requeue)

    def step(self) -> None:
        self.engine.step()

    def take_exports(self) -> list[dict]:
        return self.engine.take_exports()

    def load(self) -> int:
        return self.engine.load()


class RemotePrefillWorker:
    """Prefill role over the wire: a ``ReplicaClient`` against a
    ``role="prefill"`` replica server. ``step()`` polls the token stream
    (the first token comes from the prefill side) and ``take_exports``
    drains the server's ack-retained export hold exactly once per blob.

    One poll follows every pickup that returned blobs. The server's step
    loop runs on its own, so a prefill can finish (its first token
    appended, its blob staged) between this worker's poll and its
    ``/exports`` call; shipping that blob before the first token is
    polled would let the decode side's tokens reach the client ahead of
    it. The server marks a record ``exported`` only after its tokens are
    in, so the poll after the pickup delivers every exported request's
    first token (and its handoff terminal) before the coordinator ships
    the blob."""

    def __init__(self, client, *, worker_id: str | None = None):
        self.client = client
        self.worker_id = worker_id or (
            client.replica_id or client.endpoint)
        self.alive = True

    def submit(self, req: Request, *, requeue: bool = False) -> None:
        self.client.submit(req, requeue=requeue)

    def step(self) -> None:
        self.client.step()

    def take_exports(self) -> list[dict]:
        blobs = self.client.take_remote_exports()
        if blobs:
            self.client.step()
        return blobs

    def load(self) -> int:
        return self.client.load()


# ------------------------------------------------------------ coordinator


class _Entry:
    """Coordinator-side state for one client request: the original
    Request (its callbacks wrapped so the coordinator owns the emitted
    cursor), which prefill worker currently holds it (None once shipped
    or fallen back), and the terminal record."""

    __slots__ = ("req", "user_on_token", "user_on_finish", "tokens",
                 "t_submit", "t_dispatch", "t_first", "finish_reason",
                 "worker", "shipped")

    def __init__(self, req: Request, now: float):
        self.req = req
        self.user_on_token = req.on_token
        self.user_on_finish = req.on_finish
        self.tokens: list[int] = []
        self.t_submit = now
        self.t_dispatch = now
        self.t_first: float | None = None
        self.finish_reason: str | None = None
        self.worker = None
        self.shipped = False


class DisaggCoordinator:
    """Routes prompts to prefill workers, ships finished pages to the
    least-loaded decode worker, and falls back to unified decode-local
    prefill whenever disaggregation cannot make progress.

    *decode_workers*: in-process :class:`ServeEngine` instances (adopt
    via ``import_request_kv``) and/or ``ReplicaClient`` proxies (adopt
    via ``ship_pages`` over the ``/pages`` route), mixed freely.
    *prefill_workers*: :class:`PrefillWorker` / :class:`RemotePrefillWorker`.
    An empty prefill fleet is legal and IS the unified path — the
    coordinator then behaves like a tiny load-balancing front end.

    One :meth:`step` = step every live prefill worker, ship every export
    it surfaced, step every busy decode worker, refresh the per-role
    depth gauges. A prefill worker whose step raises is marked dead
    (``disagg_prefill_down``) and every request it held is re-routed
    through normal decode-side admission — zero lost requests, bit-
    identical tokens (greedy), at unified-path cost.
    """

    def __init__(self, decode_workers, prefill_workers=(), *,
                 stats: ServingStats | None = None,
                 logger: MetricsLogger | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.decode = list(decode_workers)
        if not self.decode:
            raise ValueError("DisaggCoordinator needs >= 1 decode worker "
                             "(prefill workers cannot finish a request)")
        self.prefill = list(prefill_workers)
        self.stats = stats if stats is not None else ServingStats()
        self.logger = logger
        self._clock = clock
        self._entries: dict[str, _Entry] = {}
        self._completed: list[RequestOutput] = []

    # ------------------------------------------------------------ intake

    def submit(self, req: Request) -> str:
        """Admit one client request: wrap its callbacks (the coordinator
        owns the emitted-token cursor across the prefill->decode hop and
        any fallback), then route to the least-loaded healthy prefill
        worker — or straight to decode when none exists."""
        if req.request_id in self._entries:
            raise ValueError(f"request {req.request_id!r} already live")
        entry = _Entry(req, self._clock())

        def _tok(tok: int, e=entry) -> None:
            if e.t_first is None:
                e.t_first = self._clock()
            e.tokens.append(int(tok))
            if e.user_on_token is not None:
                e.user_on_token(int(tok))

        def _fin(reason: str, e=entry) -> None:
            if reason == "exported":
                return          # prefill->decode handoff, not a terminal
            e.finish_reason = reason

        req.on_token = _tok
        req.on_finish = _fin
        self._entries[req.request_id] = entry
        for w in self._rank_prefill():
            try:
                w.submit(req)
            except (QueueFull, EngineDraining):
                continue
            entry.worker = w
            entry.t_dispatch = self._clock()
            return req.request_id
        self._fallback(entry, why="no_prefill_worker")
        return req.request_id

    def _rank_prefill(self) -> list:
        ranked = []
        for w in self.prefill:
            if not w.alive:
                continue
            try:
                ranked.append((w.load(), w))
            except Exception:   # noqa: BLE001 — a worker whose health
                # probe fails is routed around, not crashed into
                continue
        ranked.sort(key=lambda t: t[0])
        return [w for _, w in ranked]

    def _rank_decode(self) -> list:
        ranked = []
        for i, d in enumerate(self.decode):
            if getattr(d, "draining", False):
                continue
            try:
                ranked.append((d.load(), i, d))
            except Exception:   # noqa: BLE001 — same routing rule
                continue
        ranked.sort(key=lambda t: t[:2])
        return [d for _, _, d in ranked]

    # ---------------------------------------------------------- stepping

    def step(self) -> list[RequestOutput]:
        """One coordinator iteration; returns requests that reached a
        terminal state during it."""
        for w in self.prefill:
            if not w.alive:
                continue
            try:
                w.step()
                blobs = w.take_exports()
            except Exception as e:   # noqa: BLE001 — the worker process/
                # engine died mid-step; disaggregation must degrade, not
                # propagate
                self._mark_prefill_down(w, repr(e))
                continue
            for blob in blobs:
                self._ship(blob)
        for d in self.decode:
            if d.busy():
                d.step()
        self.stats.record_disagg_depth(
            prefill=sum(self._safe_load(w) for w in self.prefill
                        if w.alive),
            decode=sum(self._safe_load(d) for d in self.decode))
        return self._harvest()

    @staticmethod
    def _safe_load(w) -> int:
        try:
            return int(w.load())
        except Exception:   # noqa: BLE001 — gauge refresh never raises
            return 0

    def busy(self) -> bool:
        return bool(self._entries)

    def run(self, requests, max_steps: int = 100_000
            ) -> list[RequestOutput]:
        """Convenience batch driver (bench/tests): submit everything,
        step to quiescence, return outputs in completion order."""
        for req in requests:
            self.submit(req)
        steps = 0
        while self.busy():
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"coordinator did not quiesce in {max_steps} steps "
                    f"({len(self._entries)} requests still live)")
            self.step()
        out, self._completed = self._completed, []
        return out

    def take_outputs(self) -> list[RequestOutput]:
        out, self._completed = self._completed, []
        return out

    def _harvest(self) -> list[RequestOutput]:
        done: list[RequestOutput] = []
        now = self._clock()
        for rid, e in list(self._entries.items()):
            if e.finish_reason is None:
                continue
            del self._entries[rid]
            out = RequestOutput(
                request_id=rid, prompt_len=len(e.req.prompt),
                tokens=list(e.tokens), finish_reason=e.finish_reason,
                queue_s=e.t_dispatch - e.t_submit,
                ttft_s=(e.t_first - e.t_submit
                        if e.t_first is not None else None),
                latency_s=now - e.t_submit)
            done.append(out)
            if e.user_on_finish is not None:
                e.user_on_finish(e.finish_reason)
        self._completed.extend(done)
        return done

    # ---------------------------------------------------------- shipping

    def _ship(self, blob: dict) -> None:
        """Hand one export to the least-loaded decode worker that can
        adopt it. In-process adoption is direct (live Request attached,
        streaming callbacks survive the hop); wire adoption goes through
        ``ship_pages`` with the deterministic transfer key — an
        ambiguous failure retries the SAME target and key once (the
        server's ledger dedups), never a second target, so adoption stays
        exactly-once. Nobody adopting -> unified fallback."""
        rid = str(blob["request_id"])
        e = self._entries.get(rid)
        req = e.req if e is not None else None
        inj = _faults.active()
        for d in self._rank_decode():
            if hasattr(d, "import_request_kv"):
                if not d.can_import(blob):
                    continue
                if inj is not None:
                    # The in-process analog of the wire path's /pages hop
                    # (ReplicaClient fires this site per chunk): the chaos
                    # soak severs KV shipping here too. A lost transfer
                    # costs only the shipping win: the blob is host
                    # memory, so the unified fallback re-prefills and the
                    # client stream splices on (the availability
                    # contract).
                    try:
                        inj.fire("transport_pages")
                    except OSError:
                        self._fallback(e, why="pages_transport_fault")
                        return
                try:
                    d.import_request_kv(blob, request=req)
                except (EngineDraining, ValueError, RuntimeError):
                    continue
            else:
                key = transfer_key(blob)
                try:
                    d.ship_pages(blob, req=req, transfer_key=key)
                except (QueueFull, EngineDraining, ValueError):
                    continue          # definitive no: try the next peer
                except OSError:
                    # Ambiguous: the transfer may have landed. Retry the
                    # SAME target with the SAME key (the ledger answers a
                    # duplicate with the original result); a different
                    # target here could decode the request twice.
                    try:
                        d.ship_pages(blob, req=req, transfer_key=key)
                    except Exception:   # noqa: BLE001 — still down
                        break           # fallback, never a second target
            if e is not None:
                e.worker = None
                e.shipped = True
            if self.logger is not None:
                self.logger.emit(
                    "disagg_shipped", request_id=rid,
                    pages=int(blob["n_pages"]),
                    nbytes=blob_nbytes(blob),
                    kv_len=int(blob["kv_len"]))
            return
        self._fallback(e, why="no_decode_adopter")

    # ---------------------------------------------------------- fallback

    def kill_prefill(self, worker_id: str) -> None:
        """Chaos hook (tests/bench): treat one prefill worker as dead
        RIGHT NOW — exactly what :meth:`step` does when a worker's step
        raises, without waiting for it to. Its in-flight requests
        (including un-shipped exports, which die with the worker's
        process) re-route through normal decode admission."""
        for w in self.prefill:
            if w.worker_id == worker_id and w.alive:
                self._mark_prefill_down(w, "killed (chaos hook)")
                return
        raise ValueError(f"no live prefill worker {worker_id!r}")

    def _mark_prefill_down(self, w, error: str) -> None:
        w.alive = False
        if self.logger is not None:
            self.logger.emit("disagg_prefill_down",
                             worker=w.worker_id, error=error)
        for e in list(self._entries.values()):
            if e.worker is w:
                self._fallback(e, why="prefill_worker_died")

    def _fallback(self, e: _Entry | None, *, why: str) -> None:
        """The availability contract: route one request through normal
        decode-side admission. Tokens already streamed fold into the
        prompt (:meth:`Request.resume_from_tokens` — a trie hit on a
        prefix-cache-enabled target), so the client cursor splices
        bit-identically."""
        if e is None or e.finish_reason is not None:
            return
        e.worker = None
        self.stats.record_disagg_fallback()
        if self.logger is not None:
            self.logger.emit("disagg_fallback",
                             request_id=e.req.request_id, reason=why,
                             tokens_emitted=len(e.tokens))
        if e.tokens:
            if len(e.tokens) >= e.req.max_new_tokens:
                e.finish_reason = "length"     # already budget-complete
                return
            sreq = e.req.resume_from_tokens(e.tokens)
        else:
            sreq = e.req
        sreq._finished = False
        for d in self._rank_decode():
            try:
                d.submit(sreq, requeue=False)
            except (QueueFull, EngineDraining):
                continue
            e.t_dispatch = self._clock()
            return
        e.finish_reason = "aborted"   # no decode capacity anywhere
