"""Per-tenant SLO targets.

The port's own copy of :class:`SLOTarget` from
``k8s_distributed_deeplearning_tpu/telemetry/slo.py``: the promise block a
tenant config carries (``TenantConfig.slo``). The scheduler does not read
it; the burn-rate engine that does (``SLOEngine``) is not ported yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One tenant's promise: what share of requests succeed
    (``availability``), how fast the queue must move (``latency_p95_ms``,
    optional), judged over ``window_s`` seconds."""

    availability: float = 0.99
    latency_p95_ms: float | None = None
    window_s: float = 3600.0

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(f"slo availability must be in (0, 1) "
                             f"exclusive, got {self.availability}")
        if self.latency_p95_ms is not None and not self.latency_p95_ms > 0:
            raise ValueError(f"slo latency_p95_ms must be > 0, got "
                             f"{self.latency_p95_ms}")
        if not self.window_s > 0:
            raise ValueError(f"slo window_s must be > 0, got "
                             f"{self.window_s}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    @classmethod
    def from_dict(cls, doc: dict) -> "SLOTarget":
        if not isinstance(doc, dict):
            raise ValueError(f'slo must be an object like {{"availability": '
                             f"0.99}}, got {type(doc).__name__}")
        known = {"availability", "latency_p95_ms", "window_s"}
        unknown = set(doc) - known
        if unknown:
            raise ValueError(f"slo has unknown fields {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**doc)

    def to_dict(self) -> dict:
        d = {"availability": self.availability, "window_s": self.window_s}
        if self.latency_p95_ms is not None:
            d["latency_p95_ms"] = self.latency_p95_ms
        return d
