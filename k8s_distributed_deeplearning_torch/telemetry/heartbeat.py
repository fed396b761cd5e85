"""Per-rank heartbeat files: the stall detector's ground truth.

The port's own copy of ``k8s_distributed_deeplearning_tpu/telemetry/
heartbeat.py``. The file format is the JAX package's, so either package's
readers take the other's beacons.

The canonical broken-gang failure mode is a *wedge*, not a crash: one rank
dies or hangs in a collective and every peer parks forever at the next
allreduce — the Job neither fails nor finishes, so phase-polling
(``kubectl get job``) cannot tell a healthy slow step from a hung one.
Heartbeats disambiguate: every rank writes a tiny JSON file
(``rank-<n>.json`` under a shared directory — the checkpoint volume in a
real deployment, any tmpdir locally) once per step, carrying its step and
the last span that *completed* (from :class:`telemetry.trace.Tracer`).
``launch watch`` reads the directory each poll: a file older than the
stall threshold names the stuck rank and its last-completed span — the
hung region is the span that never closed after it.

Writes are atomic (tmp file + ``os.replace``) so a reader never sees a
torn record, and write failures are swallowed after the first warning —
liveness reporting must never kill the training step it reports on.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable


def _rank_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank-{rank}.json")


class HeartbeatWriter:
    """Write this rank's liveness record. *clock* is wall time (files are
    compared across processes; monotonic clocks don't travel)."""

    def __init__(self, directory: str, rank: int, *,
                 clock: Callable[[], float] = time.time):
        self.directory = directory
        self.rank = rank
        self.clock = clock
        self._warned = False
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int, last_span: str | None = None,
             **extra) -> None:
        rec = {"rank": self.rank, "step": step, "ts": self.clock(),
               "pid": os.getpid(), "last_span": last_span, **extra}
        path = _rank_path(self.directory, self.rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, path)
        except Exception as e:   # noqa: BLE001 — never kill the step
            if not self._warned:
                self._warned = True
                import sys
                try:
                    print(f"heartbeat write failed (suppressing further "
                          f"warnings): {e!r}", file=sys.stderr)
                except Exception:
                    pass

    def remove(self) -> None:
        """Delete this rank's beacon — the clean-shutdown half of the
        liveness contract, so discovery never hands a deliberately-gone
        rank back as an endpoint. Unclean exits leave the file behind;
        readers age it out via their ``stale_after_s`` filters."""
        try:
            os.unlink(_rank_path(self.directory, self.rank))
        except OSError:
            pass


@dataclasses.dataclass(frozen=True)
class StallReport:
    rank: int
    age_s: float            # seconds since the last heartbeat
    step: int               # last step the rank reported
    last_span: str | None   # last COMPLETED span; the hung one follows it

    def describe(self) -> str:
        return (f"rank {self.rank} stalled: no heartbeat for "
                f"{self.age_s:.0f}s (step {self.step}, last completed "
                f"span: {self.last_span or 'unknown'})")


def read_heartbeats(directory: str) -> list[dict]:
    """All parseable rank records in *directory* (unreadable/torn files are
    skipped — a reader races writers by design)."""
    records = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return records
    for name in names:
        if not (name.startswith("rank-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(rec, dict) and "rank" in rec and "ts" in rec:
            records.append(rec)
    return records


def detect_stalls(directory: str, stale_after_s: float, *,
                  now: float | None = None) -> list[StallReport]:
    """Ranks whose newest heartbeat is older than *stale_after_s*.

    Healthy ranks (fresh files) and ranks that never wrote (no file — the
    pod may still be scheduling; phase polling owns that case) are not
    reported."""
    now = time.time() if now is None else now
    stalls = []
    for rec in read_heartbeats(directory):
        age = now - float(rec["ts"])
        if age > stale_after_s:
            stalls.append(StallReport(
                rank=int(rec["rank"]), age_s=age,
                step=int(rec.get("step", -1)),
                last_span=rec.get("last_span")))
    return sorted(stalls, key=lambda s: s.rank)
