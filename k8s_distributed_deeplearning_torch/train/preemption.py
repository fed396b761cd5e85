"""Failure detection: graceful preemption -> checkpoint -> resume.

Port of ``k8s_distributed_deeplearning_tpu/train/preemption.py``. The
reference's failure story is "MonitoredTrainingSession closes when an
error occurs" plus the operator's ``cleanPodPolicy: Running``
(``tensorflow_mnist.py:162-164``, ``tensorflow-mnist.yaml:8``): a dying
rank kills the MPI job and loses everything since the last save. On K8s,
pods get SIGTERM and a grace period before eviction (node drain, spot
reclaim); catching it and checkpointing turns preemption into a clean
resume through the loop's restore-on-start (``train/loop.py``).

Usage::

    handler = PreemptionHandler.install()
    state = fit(..., preemption=handler)   # loop saves + exits when triggered

The handler only *requests* a stop; the training loop saves at the next
agreement boundary. A node drain may signal only *some* pods, and a
process that branches on its local flag while the others run the next
train step deadlocks the job (the step's allreduce is a collective).
:meth:`agreed` is the consensus point: every process calls it at the same
step, the flags are reduced with MAX over the process group, and all
processes take the same branch; the loop only ever branches on
``agreed()`` when more than one process is present.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable

import torch
import torch.distributed as dist

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Latches termination signals into a thread-safe "stop requested" flag."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._signals: list[int] = []
        self._prev: dict[int, object] = {}

    @classmethod
    def install(cls, signals_to_catch: Iterable[int] = (signal.SIGTERM,)
                ) -> "PreemptionHandler":
        """Install handlers (main thread only, per the signal module)."""
        h = cls()
        for sig in signals_to_catch:
            h._prev[sig] = signal.signal(sig, h._on_signal)
            h._signals.append(sig)
        return h

    def _on_signal(self, signum, frame) -> None:
        self._event.set()

    def request(self) -> None:
        """Programmatic trigger (tests; in-process health checks)."""
        self._event.set()

    @property
    def triggered(self) -> bool:
        """This process's local flag. In a multi-process job, do NOT branch
        collective work on this — use :meth:`agreed`."""
        return self._event.is_set()

    def agreed(self, group=None) -> bool:
        """Cross-process consensus: True iff ANY process was signalled.

        Collective: every process of *group* calls it at the same point
        (the training loop calls it at a fixed step cadence). The flag is
        all-reduced with MAX, on the card under NCCL. Latches the local
        flag when any peer triggered, so later local reads agree too.
        """
        if not dist.is_initialized() or dist.get_world_size(group) == 1:
            return self.triggered
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else "cpu")
        flag = torch.tensor([int(self.triggered)], dtype=torch.int32,
                            device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        if int(flag.item()):
            self._event.set()
            return True
        return False

    def uninstall(self) -> None:
        for sig in self._signals:
            signal.signal(sig, self._prev[sig])
        self._signals.clear()
