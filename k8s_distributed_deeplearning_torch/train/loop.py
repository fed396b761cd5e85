"""The training loop of the reference's TF1 script around one
data-parallel step: stop at a step, log the loss periodically, checkpoint
on rank 0 and restore on start (``tensorflow_mnist.py:146-167``), and
checkpoint then stop on preemption.

Port of ``k8s_distributed_deeplearning_tpu/train/loop.py`` (``fit`` and
``evaluate``). The host loop pulls a batch, runs the step, and syncs with
the device only at the log cadence (``float(loss)``) and at saves:
between them the card runs ahead of the host, as JAX's async dispatch
lets it. The JAX loop's profiler, tracer, heartbeat, telemetry and
quantization-calibration hooks are left out (ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

from k8s_distributed_deeplearning_torch.parallel import distributed
from k8s_distributed_deeplearning_torch.parallel.data_parallel import fold_in
from k8s_distributed_deeplearning_torch.train.checkpoint import Checkpointer
from k8s_distributed_deeplearning_torch.train.preemption import (
    PreemptionHandler)
from k8s_distributed_deeplearning_torch.utils.metrics import (MetricsLogger,
                                                              mfu)


def fit(step_fn: Callable,       # (state, batch, seed) -> (state, loss, aux)
        state: Any,              # TrainState (step counter at .step)
        batches: Iterator[dict] | Callable[[int], Iterator[dict]],
        num_steps: int,
        rng: int,
        metrics: MetricsLogger | None = None,
        checkpointer: Checkpointer | None = None,
        checkpoint_every: int = 0,
        log_every: int = 10,
        global_batch_size: int | None = None,
        flops_per_example: float | None = None,
        peak_flops: float | None = None,
        preemption: PreemptionHandler | None = None,
        preemption_sync_every: int = 10,
        eval_every: int = 0,
        eval_fn: Callable[[Any], dict] | None = None) -> Any:
    """Run synchronous training from ``state.step`` to ``num_steps``;
    returns the final state.

    Restore-on-start: if *checkpointer* holds a checkpoint, it is restored
    into ``state`` (its tensors, in place) and training resumes from its
    step (``MonitoredTrainingSession`` parity,
    ``tensorflow_mnist.py:162-167``), with a ``restore`` event. Resume is
    replay-free: pass *batches* as a callable ``start_step -> iterator``
    (``ShardedBatcher.iter_from``) so the data schedule continues where it
    left off; the step's seed is ``fold_in(rng, step)``, a pure function
    of the step, so dropout masks do not repeat either. Saves come every
    ``checkpoint_every`` steps and at the end (``checkpoint`` events with
    the save's ms and bytes); only the primary writes and logs
    (``:148-149,:159``).

    *preemption*: a :class:`PreemptionHandler`; when it triggers (SIGTERM
    from a K8s eviction), the loop checkpoints at the step boundary, emits
    ``preempted`` and returns; the next run resumes from that step. A
    multi-process job branches only on ``preemption.agreed()``, a MAX
    all-reduce every *preemption_sync_every* steps, so every process
    takes the same branch even when only some pods were signalled; a
    single process reacts after the step it was signalled in.

    Every ``log_every`` steps the primary emits a ``train_step`` event
    (loss, step ms, examples/s, MFU when ``flops_per_example`` and
    ``peak_flops`` are given, and the step's aux metrics). Every
    ``eval_every`` steps ``eval_fn(state)`` runs and its metrics are
    emitted as ``eval``; when *checkpointer* tracks a best metric
    (``keep_best_metric``) each eval also saves a metric-carrying
    checkpoint (``ModelCheckpoint save_best_only`` parity,
    ``tensorflow_mnist_gpu.py:160-163``)."""
    start_step = int(state.step)
    if checkpointer is not None:
        restored = checkpointer.restore_latest(state)
        if restored is not None:
            state, start_step = restored
            if metrics:
                metrics.emit("restore", step=start_step,
                             **_cost(checkpointer.last_restore))
    batch_iter = batches(start_step) if callable(batches) else batches
    n_dev = distributed.process_count()
    t_last = time.monotonic()
    step_last = start_step

    def save(step, **kw):
        if checkpointer.save(step, state, **kw):
            return _cost(checkpointer.last_save)
        return {}

    for step in range(start_step, num_steps):
        batch = next(batch_iter)
        state, loss, aux = step_fn(state, batch, fold_in(rng, step))
        if preemption is not None:
            # One process reacts on its own flag; several branch only on
            # the collective agreement, at the same step on every process.
            if n_dev == 1:
                stop = preemption.triggered
            else:
                stop = ((step + 1) % preemption_sync_every == 0
                        and preemption.agreed())
            if stop:
                cost = {}
                if checkpointer is not None:
                    cost = save(step + 1, force=True)
                    checkpointer.wait()
                if metrics:
                    metrics.emit("preempted", step=step + 1,
                                 checkpointed=checkpointer is not None,
                                 **cost)
                return state
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
            if (checkpointer is not None
                    and checkpointer.keep_best_metric is not None):
                cost = save(step + 1, metrics=ev)
                if metrics:
                    metrics.emit("checkpoint", step=step + 1,
                                 best_tracked=True, **cost)
        if (checkpointer is not None and checkpoint_every
                and (step + 1) % checkpoint_every == 0):
            cost = save(step + 1)
            if metrics:
                metrics.emit("checkpoint", step=step + 1, **cost)
    if (checkpointer is not None and num_steps > start_step
            and checkpointer.latest_step() != num_steps):
        cost = save(num_steps, force=True)
        if metrics:
            metrics.emit("checkpoint", step=num_steps, final=True, **cost)
    return state


def _cost(info: dict) -> dict:
    """A save's or restore's ms and bytes, for its event."""
    return {k: v for k, v in info.items() if k != "step"}


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
