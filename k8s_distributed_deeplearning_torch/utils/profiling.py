"""Tracing and profiling over ``torch.profiler``.

The port's counterpart of ``k8s_distributed_deeplearning_tpu/utils/
profiling.py``, which wraps ``jax.profiler``:

- :func:`trace` profiles the enclosed block (the exporter's
  ``/debug/profile``) and :class:`StepProfiler` a window of training
  steps; each writes ``<log_dir>/trace.json``, a Chrome trace with the
  host's ops and, when CUDA is present, the card's kernels (open it in
  Perfetto or ``chrome://tracing``);
- :class:`StepTimer` measures honest step wall-times: it synchronizes the
  card before reading the clock (CUDA launches are async; timing the
  launch alone flatters the number) and reports p50/p95/mean;
- :func:`annotate` marks host-side spans (``record_function``) so data
  loading and dispatch separate in the trace viewer.

A profiler that cannot start raises, as ``jax.profiler.start_trace``
does: a run asked to trace the card never goes on without the trace.
Only the primary process should write traces: pass
``enabled=is_primary()``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Any, Iterator

import torch

__all__ = ["trace", "annotate", "StepProfiler", "StepTimer"]

TRACE_FILE = "trace.json"


def _activities() -> list:
    """Host ops always; the card's kernels when CUDA is present, which
    needs a torch built with Kineto (``StepProfiler`` raises without)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if not torch.autograd.kineto_available():
            raise RuntimeError("CUDA is present but this torch has no "
                               "Kineto: the card's kernels cannot be traced")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


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
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> contextlib.AbstractContextManager:
    """Named host-side span, visible in the trace viewer's host timeline."""
    return torch.profiler.record_function(name)


class StepProfiler:
    """Trace a step window inside a training loop.

    ``step_hook(step)`` starts the trace at the first step >= ``start_step``
    and stops it after ``num_steps`` — the standard "skip warmup/compile,
    profile steady state" recipe. The >= (with a run-once latch) matters for
    resumed runs: a restore past start_step still captures a window instead
    of silently skipping the user's profile request. Safe when the window
    never arrives (stop() is idempotent). On stop the window is written to
    ``<log_dir>/trace.json``; a trace that was to hold the card's kernels
    and holds none raises there (CUPTI saw nothing).
    """

    def __init__(self, log_dir: str, start_step: int, num_steps: int = 5,
                 enabled: bool = True):
        self.log_dir = log_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.enabled = enabled
        self._active = False
        self._done = False
        self._stop_step = start_step + num_steps
        self._prof: torch.profiler.profile | None = None
        self._cuda = False

    def step_hook(self, step: int) -> None:
        if not self.enabled or self._done:
            return
        if not self._active and step >= self.start_step:
            activities = _activities()
            self._cuda = torch.profiler.ProfilerActivity.CUDA in activities
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._active = True
            self._stop_step = step + self.num_steps
        elif self._active and step >= self._stop_step:
            self.stop()

    def stop(self) -> None:
        if not self._active:
            return
        prof, self._prof = self._prof, None
        self._active = False
        self._done = True
        if self._cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        if self._cuda:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            if not any(e.get("cat") == "kernel" for e in events):
                raise RuntimeError(
                    f"{path}: the profiler traced no kernel of the card "
                    "(CUPTI recorded no device activity)")


class StepTimer:
    """Wall-clock step statistics with a true device sync per sample.

    ``observe(value)`` synchronizes *value*'s card (a CUDA tensor, e.g.
    the loss) before reading the clock, so async launches can't hide
    device time. Warmup steps are excluded from the summary.
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._samples: list[float] = []
        self._seen = 0
        self._last = time.perf_counter()

    def observe(self, value: Any = None) -> float:
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._seen += 1
        if self._seen > self.warmup:
            self._samples.append(dt)
        return dt

    def summary(self) -> dict[str, float]:
        if not self._samples:
            return {"steps": 0}
        s = sorted(self._samples)
        return {
            "steps": len(s),
            "mean_ms": 1e3 * statistics.fmean(s),
            "p50_ms": 1e3 * s[len(s) // 2],
            "p95_ms": 1e3 * s[min(len(s) - 1, int(len(s) * 0.95))],
            "min_ms": 1e3 * s[0],
            "max_ms": 1e3 * s[-1],
        }
