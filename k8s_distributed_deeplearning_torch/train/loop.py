"""The training loop of the reference's TF1 script (stop at a step, log
the loss periodically), around one data-parallel step.

Port of ``k8s_distributed_deeplearning_tpu/train/loop.py`` (``fit`` and
``evaluate``). The host loop pulls a batch, runs the step, and syncs with
the device only at the log cadence (``float(loss)``): between logs the
card runs ahead of the host, as JAX's async dispatch lets it. The
checkpointer, preemption handler, profiler, tracer, heartbeat, telemetry
and quantization-calibration hooks of the JAX loop are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

from k8s_distributed_deeplearning_torch.parallel import distributed
from k8s_distributed_deeplearning_torch.parallel.data_parallel import fold_in
from k8s_distributed_deeplearning_torch.utils.metrics import (MetricsLogger,
                                                              mfu)


def fit(step_fn: Callable,       # (state, batch, seed) -> (state, loss, aux)
        state: Any,              # TrainState (step counter at .step)
        batches: Iterator[dict] | Callable[[int], Iterator[dict]],
        num_steps: int,
        rng: int,
        metrics: MetricsLogger | None = None,
        log_every: int = 10,
        global_batch_size: int | None = None,
        flops_per_example: float | None = None,
        peak_flops: float | None = None,
        eval_every: int = 0,
        eval_fn: Callable[[Any], dict] | None = None) -> Any:
    """Run synchronous training from ``state.step`` to ``num_steps``;
    returns the final state. ``batches`` is an iterator or a callable
    ``start_step -> iterator`` (``TokenBatcher.iter_from``). The step's
    seed is ``fold_in(rng, step)``, a pure function of the step. Every
    ``log_every`` steps the primary emits a ``train_step`` event (loss,
    step ms, examples/s, MFU when ``flops_per_example`` and ``peak_flops``
    are given, and the step's aux metrics); every ``eval_every`` steps
    ``eval_fn(state)`` runs and its metrics are emitted as ``eval``."""
    start_step = int(state.step)
    batch_iter = batches(start_step) if callable(batches) else batches
    n_dev = distributed.process_count()
    t_last = time.monotonic()
    step_last = start_step
    for step in range(start_step, num_steps):
        batch = next(batch_iter)
        state, loss, aux = step_fn(state, batch, fold_in(rng, step))
        if metrics and log_every and (step + 1) % log_every == 0:
            loss_f = float(loss)           # the host sync point
            now = time.monotonic()
            window = step + 1 - step_last
            dt_ms = (now - t_last) * 1e3 / window
            t_last, step_last = now, step + 1
            eps = (global_batch_size / (dt_ms / 1e3)
                   if global_batch_size else 0.0)
            extra = {k: float(v) for k, v in (aux or {}).items()}
            m = None
            if flops_per_example and peak_flops:
                m = mfu(flops_per_example, eps, n_dev, peak_flops)
            metrics.train_step(step + 1, loss_f, dt_ms, eps,
                               eps / n_dev if n_dev else 0.0, mfu=m, **extra)
        if eval_fn is not None and eval_every and (step + 1) % eval_every == 0:
            ev = {k: float(v) for k, v in eval_fn(state).items()}
            if metrics:
                metrics.emit("eval", step=step + 1, **ev)
    return state


def evaluate(eval_step: Callable, params: Any, batches: Iterator[dict],
             num_batches: int) -> dict[str, float]:
    """Average ``eval_step(params, batch) -> dict`` over ``num_batches``
    batches (call it on the primary, as the reference evaluates on rank
    0 only)."""
    totals: dict[str, float] = {}
    for _ in range(num_batches):
        out = eval_step(params, next(batches))
        for k, v in out.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return {k: v / num_batches for k, v in totals.items()}
