"""graftflight — black-box flight recorder for the serving plane.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
flight.py``. The dump format is the JAX package's, line for line, so the
JAX package's ``graftscope postmortem`` (``load_dump``) reads a port dump.

An aircraft flight recorder for the engine/gateway: a bounded in-memory
ring of per-step snapshots (queue and tenant depths, slot occupancy, pool
counters by owner class, spec acceptance, last decode/prefill timings,
breaker states) that costs near-nothing while everything is healthy and
is dumped as JSONL the moment something dies — breaker trip, drain,
SIGTERM, injected fault, or on demand via the exporter's ``/debug/flight``
endpoint.

Why a ring and not the JSONL log: the push plane (``MetricsLogger``) is
*sampled* and *event-shaped* — by the time a replica is killed mid-decode,
the interesting per-step state (who held which KV pages, how deep each
tenant queue was, which breaker was half-open) was never emitted anywhere.
The ring holds the last ``ring_size`` snapshots verbatim, so the dump is
the exact flight path into the failure, not a reconstruction.

Dump format (one JSON object per line, parseable by
``graftscope postmortem``):

  line 1   header — ``{"flight": 1, "reason": ..., "job": ...,
           "dumped_at_s": ..., **extra}`` where *extra* carries the
           terminal context (open breaker, ``pages_by_owner``,
           ``pages_held``, ...)
  line 2+  ring records oldest-first, each stamped with ``source``
           (which component recorded it) and ``t_s`` (monotonic
           seconds since recorder start).

The recorder is deliberately forgiving: ``record()`` is a no-op when
disabled, ``dump()`` never raises (a broken disk must not take down the
serving loop it is trying to document), and multiple components (engine +
gateway) may share one recorder — records interleave in arrival order.
"""
from __future__ import annotations

__all__ = ["FlightRecorder", "load_dump"]

import itertools
import json
import os
import time
from collections import deque


class FlightRecorder:
    """Bounded ring of per-step snapshots + terminal-state JSONL dumps.

    Parameters:
      ring_size: snapshots retained (0 disables recording entirely —
        ``record`` no-ops and ``dump`` writes a header-only file).
      dump_dir: directory for dump files; None keeps dumps in memory
        only (``last_dump`` still updates, nothing touches disk).
      logger: optional ``MetricsLogger`` — each dump emits a
        registry-checked ``flight_dump`` event so Loki sees the pointer.
      job: label stamped into dump headers (usually the replica id).
    """

    def __init__(self, ring_size: int = 256, *, dump_dir: str | None = None,
                 logger=None, job: str = "serve"):
        self.enabled = ring_size > 0
        self.ring: deque = deque(maxlen=max(1, int(ring_size)))
        self.dump_dir = dump_dir
        self.logger = logger
        self.job = job
        self.dumps: list[str] = []      # paths written, oldest first
        self.last_dump: dict | None = None   # header+records of newest dump
        self._t0 = time.monotonic()
        self._seq = itertools.count()

    # ---- recording (hot path: one dict build + deque append) -------------

    def record(self, source: str, **snapshot) -> None:
        """Append one snapshot. Callers gate on ``self.enabled`` before
        assembling expensive fields; this re-checks so a bare call is
        still safe."""
        if not self.enabled:
            return
        snapshot["source"] = source
        snapshot["t_s"] = round(time.monotonic() - self._t0, 6)
        self.ring.append(snapshot)

    def snapshot(self) -> list[dict]:
        """Current ring contents, oldest first."""
        return list(self.ring)

    # ---- dumping ---------------------------------------------------------

    def dump(self, reason: str, extra: dict | None = None) -> str | None:
        """Write the ring as JSONL; returns the path (None when no
        ``dump_dir`` or the write failed). Never raises — the recorder
        must not be the thing that kills the process it is documenting."""
        # Extra merges FIRST: the envelope keys (flight/reason/job/...)
        # are the parse contract and must win over a caller's extra dict
        # that happens to reuse one of the names.
        header = dict(extra) if extra else {}
        header.update({"flight": 1, "reason": reason, "job": self.job,
                       "dumped_at_s": round(time.monotonic() - self._t0, 6),
                       "records": len(self.ring)})
        records = list(self.ring)
        self.last_dump = {"header": header, "records": records}
        path = None
        if self.dump_dir is not None:
            fname = (f"flight-{self.job}-{reason}-"
                     f"{os.getpid()}-{next(self._seq)}.jsonl")
            path = os.path.join(self.dump_dir, fname)
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                with open(path, "w") as fh:
                    fh.write(json.dumps(header, default=repr) + "\n")
                    for rec in records:
                        fh.write(json.dumps(rec, default=repr) + "\n")
                self.dumps.append(path)
            except OSError:
                path = None
        if self.logger is not None:
            self.logger.emit("flight_dump", reason=reason,
                             records=len(records),
                             path=path if path is not None else "")
        return path


def load_dump(path: str) -> tuple[dict, list[dict]]:
    """Parse a flight dump back into (header, records). Raises ValueError
    on a file that is not a flight dump — ``graftscope postmortem``'s
    input check."""
    header: dict | None = None
    records: list[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if header is None:
                if not isinstance(obj, dict) or obj.get("flight") != 1:
                    raise ValueError(
                        f"{path}: first line is not a flight-dump header")
                header = obj
            else:
                records.append(obj)
    if header is None:
        raise ValueError(f"{path}: empty file, not a flight dump")
    return header, records
