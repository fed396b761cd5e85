"""Deterministic fault injection: the port's own copy of
``k8s_distributed_deeplearning_tpu/faults/``.

A plan's JSON and its validation equal the JAX package's, so one plan file
drives both packages. The training sites have callers in the port
(``step``, ``data_wait``, ``checkpoint_saved`` and ``heartbeat`` in
``train/loop.py``, ``shard_read`` in ``train/data.py``), and so do the
serving sites (``serve_decode`` in ``serve/engine.py``,
``gateway_dispatch`` in ``serve/gateway.py``, ``transport_send`` and
``transport_recv`` in ``serve/transport.py``, ``transport_pages`` there
and on the in-process KV shipping path of ``serve/disagg.py``), and so do
``executor`` (``launch/local_executor.py``, a killer outside the worker)
and ``autoscale_actuate`` (``serve/autoscale.py``, before every backend
call).
"""

from k8s_distributed_deeplearning_torch.faults.inject import (  # noqa: F401
    ATTEMPT_ENV,
    FAULT_PLAN_ENV,
    FaultInjector,
    activate,
    active,
    add_fire_hook,
    deactivate,
)
from k8s_distributed_deeplearning_torch.faults.plan import (  # noqa: F401
    ACTIONS,
    SITES,
    Fault,
    FaultPlan,
)
