"""Low-overhead span tracer emitting the existing JSONL event contract.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
trace.py``, over the port's ``utils/metrics.py`` ``MetricsLogger``.

A span is a named timed region entered as a context manager::

    tracer = Tracer(logger=MetricsLogger(job="train"), rank=0)
    with tracer.span("step", step=12):
        with tracer.span("data_wait"):
            batch = next(it)
        ...

On exit each span emits one ``span`` JSONL event (name, dur_ms, depth,
parent, rank, plus any caller fields) through the same
stdout→Promtail→Loki pipeline as every other metric — Grafana selects
``event="span"`` and unwraps ``dur_ms`` with zero ingest changes.

Design constraints, in order:

- **Cheap on the hot path.** A closed span costs two ``perf_counter``
  calls, one dict build, one ``json.dumps`` and one stream write —
  ``bench.py --suite telemetry`` holds the total under 2% of a CPU train
  step. A disabled tracer (``enabled=False``) costs one attribute check:
  ``span()`` hands back a shared no-op singleton.
- **Thread-safe.** The span stack is ``threading.local`` (the serving
  engine and prefetch threads trace concurrently with the main loop);
  emission goes through ``MetricsLogger`` whose line-buffered writes are
  atomic enough for JSONL.
- **Per-rank.** ``rank`` stamps every event so multi-host traces interleave
  in Loki without ambiguity, and ``last_span`` feeds the heartbeat plane:
  a stalled rank's heartbeat file names the last span that *completed*,
  which is the best available answer to "where is it stuck?" (the hung
  region is the one that never closed). ``last_span`` is PER-THREAD (like
  the span stack): the train loop's heartbeat must name the train loop's
  own last span, not whatever a concurrent serve/prefetch thread closed
  most recently. Every event also carries a ``thread`` field so graftscope
  (:mod:`telemetry.timeline`) can separate tracks.

Spans can optionally mirror into a Prometheus histogram
(``span_duration_ms{span=...}``) when constructed with a *registry* —
the bridge between the log plane and the pull plane — and into an
in-memory ring buffer (*ring_size*) that the exporter's ``/debug/spans``
endpoint serves when the Loki pipeline itself is the thing that's down.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, TYPE_CHECKING

if TYPE_CHECKING:
    from k8s_distributed_deeplearning_torch.telemetry.registry import (
        MetricsRegistry)
    from k8s_distributed_deeplearning_torch.utils.metrics import MetricsLogger

# Span-duration buckets in ms: sub-ms host work up through multi-minute
# checkpoint writes.
_SPAN_BUCKETS_MS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0,
                    30000.0, 120000.0)


class _NullSpan:
    """Shared no-op span: the disabled tracer's entire hot-path cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "fields", "_t0", "parent", "depth")

    def __init__(self, tracer: "Tracer", name: str, fields: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.fields = fields
        self._t0 = 0.0
        self.parent: str | None = None
        self.depth = 0

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._closed(self, dur_ms)


class Tracer:
    """Per-rank span tracer. *logger* is a
    :class:`~utils.metrics.MetricsLogger` (or None for a record-only tracer
    whose spans still update ``last_span`` and the registry histogram);
    spans shorter than *min_dur_ms* are timed but not emitted (hot inner
    loops can trace without flooding Loki). *ring_size* > 0 additionally
    keeps the newest N span records in memory for
    :meth:`recent_spans` / the exporter's ``/debug/spans`` endpoint."""

    def __init__(self, logger: "MetricsLogger | None" = None, *,
                 rank: int = 0, enabled: bool = True,
                 min_dur_ms: float = 0.0,
                 registry: "MetricsRegistry | None" = None,
                 ring_size: int = 0):
        self.logger = logger
        self.rank = rank
        self.enabled = enabled
        self.min_dur_ms = min_dur_ms
        self.spans_emitted = 0
        self._emit_warned = False
        self._local = threading.local()
        self._ring: collections.deque | None = (
            collections.deque(maxlen=ring_size) if ring_size > 0 else None)
        self._hist = (registry.histogram(
            "span_duration_ms", "traced span duration in milliseconds",
            buckets=_SPAN_BUCKETS_MS, labelnames=("span",))
            if registry is not None else None)

    @property
    def last_span(self) -> str | None:
        """The CALLING thread's most recently completed span (None before
        the first close on this thread). Thread-scoped on purpose: the
        heartbeat asks from the train loop's thread and must not be
        answered with a serve-thread span (cross-thread misattribution
        would name the wrong subsystem in a stall report)."""
        return getattr(self._local, "last_span", None)

    def span(self, name: str, **fields: Any):
        """Open a span; use as a context manager. Nested spans record their
        parent and depth from this thread's span stack."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, fields)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def recent_spans(self) -> list[dict]:
        """Newest-last snapshot of the ring buffer (empty when
        ``ring_size`` was 0) — the ``/debug/spans`` payload."""
        return list(self._ring) if self._ring is not None else []

    def _closed(self, span: _Span, dur_ms: float) -> None:
        self._local.last_span = span.name
        thread = threading.current_thread().name
        if self._hist is not None:
            self._hist.labels(span=span.name).observe(dur_ms)
        if dur_ms < self.min_dur_ms:
            return
        if self._ring is not None:
            self._ring.append({"name": span.name,
                               "dur_ms": round(dur_ms, 3),
                               "depth": span.depth, "parent": span.parent,
                               "rank": self.rank, "thread": thread,
                               "ts": time.time(), **span.fields})
        if self.logger is None:
            return
        self.spans_emitted += 1
        try:
            self.logger.emit("span", name=span.name, dur_ms=round(dur_ms, 3),
                             depth=span.depth, parent=span.parent,
                             rank=self.rank, thread=thread, **span.fields)
        except Exception as e:   # noqa: BLE001 — tracing must never kill
            # the traced work (a full disk under the logger's file is an
            # observability outage, not a training outage).
            if not self._emit_warned:
                self._emit_warned = True
                import sys
                try:
                    print(f"span emit failed (suppressing further "
                          f"warnings): {e!r}", file=sys.stderr)
                except Exception:
                    pass
