"""Bounded FCFS admission queue.

The port's own copy of ``RequestQueue`` from
``k8s_distributed_deeplearning_tpu/serve/scheduler.py``: the scheduler
surface the engine drives (``submit``/``pop(fits=)``/``release``/
``sweep_expired``/``drain``/``__len__``). The multi-tenant scheduler is
not ported yet.
"""
from __future__ import annotations

from collections import deque

from k8s_distributed_deeplearning_torch.serve.request import (QueueFull,
                                                              Request)


class RequestQueue:
    """FIFO of pending :class:`Request`\\ s with a hard capacity."""

    def __init__(self, max_size: int = 256):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        self.max_size = max_size
        self._q: deque[Request] = deque()

    def submit(self, req: Request) -> None:
        if len(self._q) >= self.max_size:
            raise QueueFull(
                f"admission queue is full ({self.max_size} pending) — retry "
                f"after completions free capacity (request {req.request_id})")
        self._q.append(req)

    def pop(self, fits=None) -> Request | None:
        """FCFS head, or None when empty — or when the engine's ``fits``
        probe (KV page availability) rejects the head, which defers it in
        place."""
        if not self._q or (fits is not None and not fits(self._q[0])):
            return None
        return self._q.popleft()

    def sweep_expired(self, now: float | None = None) -> list[Request]:
        """FCFS keeps no deadline index: expired requests are caught when
        they are popped."""
        return []

    def release(self, req: Request) -> None:
        """FCFS tracks no per-tenant slot quota: nothing to return."""

    def drain(self) -> list[Request]:
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self) -> int:
        return len(self._q)
