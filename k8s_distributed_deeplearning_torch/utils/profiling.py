"""Windowed profiler capture for the exporter's ``/debug/profile``.

The port's counterpart of :func:`trace` in
``k8s_distributed_deeplearning_tpu/utils/profiling.py``, over
``torch.profiler`` where the JAX one wraps ``jax.profiler``: the enclosed
block's host activity, and the card's kernels when CUDA is present, land
in ``<log_dir>/trace.json`` (Chrome trace format; open it in Perfetto or
``chrome://tracing``). ``StepProfiler`` and ``StepTimer`` are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Profile the enclosed block into ``<log_dir>/trace.json``."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
