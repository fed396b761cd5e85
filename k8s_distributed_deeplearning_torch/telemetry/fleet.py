"""The health policy the failover gateway routes by.

The port's own copy of :class:`HealthPolicy` from
``k8s_distributed_deeplearning_tpu/telemetry/fleet.py``: the weights of
the composite health score. The JAX module also scrapes remote replicas'
``/metrics`` and federates them; that half waits for the wire transport
(ROADMAP.md). In-process, the gateway reads the same signals off its
engines (``serve/gateway.py`` ``_health_score``)::

    score = 1 - (w_queue    * min(1, queue_depth / queue_full_depth)
               + w_occupancy * slot_occupancy
               + w_kv       * kv_pages_used / kv_pages_total)

The liveness weights (heartbeat and scrape staleness) stay in the policy
for the remote fleet; in-process the breaker owns liveness.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HealthPolicy"]


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Knobs of the composite health score (module docstring formula)."""

    queue_full_depth: float = 64.0      # queue depth scoring as "full"
    heartbeat_stale_s: float = 60.0     # hb age scoring as "wedged"
    scrape_stale_s: float = 10.0        # scrape age scoring as "gone"
    unhealthy_below: float = 0.5        # router/watch alarm threshold
    w_queue: float = 0.25
    w_occupancy: float = 0.15
    w_kv: float = 0.20
    w_heartbeat: float = 0.25
    w_scrape: float = 0.15
