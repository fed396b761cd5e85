"""Multi-tenant admission scheduling for the serving engine.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/sched``:
:mod:`tenant` is the declarative registry (priority class, DRR weight,
token-bucket rate limit, slot quota, queue bound; JSON-loadable),
:mod:`policy` the runtime (per-tenant EDF heaps drained by
deficit-weighted round robin under strict priority). The engine drives
:class:`TenantScheduler` through the ``submit()/pop()`` surface of the
FCFS queue.
"""
from k8s_distributed_deeplearning_torch.serve.sched.policy import (
    TenantScheduler)
from k8s_distributed_deeplearning_torch.serve.sched.tenant import (
    DEFAULT_TENANT, PRIORITY_CLASSES, TenantConfig, load_tenants,
    parse_tenants)

__all__ = ["DEFAULT_TENANT", "PRIORITY_CLASSES", "TenantConfig",
           "TenantScheduler", "load_tenants", "parse_tenants"]
