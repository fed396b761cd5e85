"""Tenant registry: the declarative half of the multi-tenant scheduler.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/sched/
tenant.py``. A :class:`TenantConfig` names what the policy core
(:mod:`serve.sched.policy`) needs to isolate one traffic class from
another:

- ``priority``        strict-priority class ("interactive" > "normal" >
                      "batch"): a lower class is served only when every
                      higher class is empty or blocked by its own limits.
- ``weight``          deficit-weighted round-robin share within the class,
                      in service tokens (prompt + max_new_tokens).
- ``rate_tokens_per_s`` / ``burst_tokens``
                      token-bucket rate limit in service tokens. The
                      bucket starts full (``burst_tokens``, default one
                      second of refill), refills while idle up to the
                      burst, and admits a request when it holds
                      ``min(cost, burst)`` (an oversized request runs on a
                      full bucket and drives it into debt). None =
                      unlimited.
- ``max_slots``       concurrent prefill/decode slots the tenant may hold.
- ``max_queue``       the tenant's own admission-queue bound (QueueFull
                      for it alone).
- ``slo``             optional :class:`telemetry.slo.SLOTarget`; the
                      scheduler ignores it.

Inline JSON or an ``@/path`` reference::

    {"tenants": [
        {"id": "chat", "priority": "interactive", "weight": 4,
         "rate_tokens_per_s": 2000, "burst_tokens": 8000,
         "max_slots": 6, "max_queue": 64,
         "slo": {"availability": 0.999, "latency_p95_ms": 250}},
        {"id": "backfill", "priority": "batch", "weight": 1}
    ]}

Unknown keys, duplicate ids and nonpositive weights or rates are refused
with the exact reason, word for word as the JAX package.
"""
from __future__ import annotations

import dataclasses
import json

from k8s_distributed_deeplearning_torch.telemetry.slo import SLOTarget

# Strict-priority ranks, best first. Index = scheduling rank.
PRIORITY_CLASSES = ("interactive", "normal", "batch")

#: Tenant every :class:`serve.request.Request` belongs to unless it says
#: otherwise — a single-tenant engine is just this tenant alone.
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission contract (see module docstring)."""

    tenant_id: str
    priority: str = "normal"
    weight: float = 1.0
    rate_tokens_per_s: float | None = None
    burst_tokens: float | None = None
    max_slots: int | None = None
    max_queue: int | None = None
    slo: SLOTarget | None = None

    def __post_init__(self):
        if isinstance(self.slo, dict):
            # The wire shape is a nested JSON object: normalized here, so
            # parse_tenants reports SLOTarget's own errors with the
            # tenant's index.
            object.__setattr__(self, "slo", SLOTarget.from_dict(self.slo))
        if self.slo is not None and not isinstance(self.slo, SLOTarget):
            raise ValueError(f"tenant {self.tenant_id!r}: slo must be an "
                             f"object or SLOTarget, got {self.slo!r}")
        if not self.tenant_id or not isinstance(self.tenant_id, str):
            raise ValueError(f"tenant_id must be a non-empty string, got "
                             f"{self.tenant_id!r}")
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"tenant {self.tenant_id!r}: priority {self.priority!r} is "
                f"not one of {PRIORITY_CLASSES}")
        if not self.weight > 0:
            raise ValueError(f"tenant {self.tenant_id!r}: weight must be "
                             f"> 0, got {self.weight}")
        if self.rate_tokens_per_s is not None and not self.rate_tokens_per_s > 0:
            raise ValueError(
                f"tenant {self.tenant_id!r}: rate_tokens_per_s must be > 0 "
                f"(None = unlimited), got {self.rate_tokens_per_s}")
        if self.burst_tokens is not None:
            if not self.burst_tokens > 0:
                raise ValueError(
                    f"tenant {self.tenant_id!r}: burst_tokens must be > 0, "
                    f"got {self.burst_tokens}")
            if self.rate_tokens_per_s is None:
                raise ValueError(
                    f"tenant {self.tenant_id!r}: burst_tokens without "
                    "rate_tokens_per_s is meaningless (no bucket to cap)")
        if self.max_slots is not None and self.max_slots < 1:
            raise ValueError(f"tenant {self.tenant_id!r}: max_slots must be "
                             f">= 1, got {self.max_slots}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"tenant {self.tenant_id!r}: max_queue must be "
                             f">= 1, got {self.max_queue}")

    @property
    def burst(self) -> float | None:
        """Effective bucket capacity: ``burst_tokens``, defaulting to one
        second of refill when only the rate is set."""
        if self.rate_tokens_per_s is None:
            return None
        return (self.burst_tokens if self.burst_tokens is not None
                else self.rate_tokens_per_s)


# JSON key -> TenantConfig field ("id" is the wire spelling of tenant_id).
_JSON_KEYS = {"id": "tenant_id", "priority": "priority", "weight": "weight",
              "rate_tokens_per_s": "rate_tokens_per_s",
              "burst_tokens": "burst_tokens", "max_slots": "max_slots",
              "max_queue": "max_queue", "slo": "slo"}


def parse_tenants(text: str) -> tuple[TenantConfig, ...]:
    """Parse and validate an inline-JSON tenant config. Raises ValueError
    with the exact defect: bad JSON, wrong shape, unknown keys, duplicate
    ids, out-of-range values."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"tenant config is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("tenants"), list):
        raise ValueError('tenant config must be {"tenants": [...]}, got '
                         f"{type(doc).__name__}")
    out: list[TenantConfig] = []
    seen: set[str] = set()
    for i, rec in enumerate(doc["tenants"]):
        if not isinstance(rec, dict):
            raise ValueError(f"tenants[{i}] is not an object")
        unknown = set(rec) - set(_JSON_KEYS)
        if unknown:
            raise ValueError(
                f"tenants[{i}] has unknown fields {sorted(unknown)} "
                f"(known: {sorted(_JSON_KEYS)})")
        if "id" not in rec:
            raise ValueError(f"tenants[{i}] is missing 'id'")
        try:
            cfg = TenantConfig(**{_JSON_KEYS[k]: v for k, v in rec.items()})
        except (ValueError, TypeError) as e:
            raise ValueError(f"tenants[{i}]: {e}") from e
        if cfg.tenant_id in seen:
            raise ValueError(f"tenants[{i}]: duplicate tenant id "
                             f"{cfg.tenant_id!r}")
        seen.add(cfg.tenant_id)
        out.append(cfg)
    if not out:
        raise ValueError("tenant config lists no tenants")
    return tuple(out)


def load_tenants(spec: str) -> tuple[TenantConfig, ...]:
    """Resolve a tenant-config spec: inline JSON, or ``@/path`` to a JSON
    file."""
    spec = spec.strip()
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    return parse_tenants(spec)
