"""The training loop of the reference's TF1 script around one
data-parallel step: stop at a step, log the loss periodically, checkpoint
on rank 0 and restore on start (``tensorflow_mnist.py:146-167``), and
checkpoint then stop on preemption.

Port of ``k8s_distributed_deeplearning_tpu/train/loop.py`` (``fit``,
``evaluate``, ``should_log`` and ``dump_quant_calibration``). The host
loop pulls a batch, runs the step, and syncs with the device only at the
log cadence (``float(loss)``) and at saves: between them the card runs
ahead of the host, as JAX's async dispatch lets it. Its hooks are the JAX
loop's, with the same formats: the tracer's ``data_wait``, ``step`` and
``checkpoint`` spans (what graftscope's ``telemetry/timeline.py`` reads),
the heartbeat file, the ``TrainTelemetry`` gauges, the step profiler's
window, the fault sites ``step``, ``data_wait``, ``checkpoint_saved`` and
``heartbeat`` at the JAX loop's points, and the graftquant calibration
dump.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Iterator

from k8s_distributed_deeplearning_torch import faults as _faults
from k8s_distributed_deeplearning_torch.parallel import distributed
from k8s_distributed_deeplearning_torch.parallel.data_parallel import fold_in
from k8s_distributed_deeplearning_torch.telemetry.heartbeat import (
    HeartbeatWriter)
from k8s_distributed_deeplearning_torch.telemetry.trace import Tracer
from k8s_distributed_deeplearning_torch.train.checkpoint import Checkpointer
from k8s_distributed_deeplearning_torch.train.preemption import (
    PreemptionHandler)
from k8s_distributed_deeplearning_torch.utils.metrics import (MetricsLogger,
                                                              mfu)
from k8s_distributed_deeplearning_torch.utils.profiling import StepProfiler

_NULL_TRACER = Tracer(enabled=False)


def dump_quant_calibration(model: Any, path: str) -> int:
    """Write per-channel absmax stats for every quantizable matmul weight
    of ``model`` as the JSON envelope ``serve.quant.load_calibration``
    reads — ``{"weights": {param_path: [per-output-channel absmax]}}``
    with keys in the JAX package's path naming (``serve/quant.py``
    ``jax_path_name``), so a dump clips the serving scales of either
    package. The port's weights are ``[out, in]`` matrices by module name,
    so the dump reads the module (q/k/v's channels are its head_dim), not
    a parameter dict. Returns the number of entries written."""
    from k8s_distributed_deeplearning_torch.serve import quant as quant_lib

    weights = quant_lib.calibration_absmax(model)
    with open(path, "w") as f:
        json.dump({"weights": weights}, f)
    return len(weights)


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
        profiler: StepProfiler | None = None,
        eval_every: int = 0,
        eval_fn: Callable[[Any], dict] | None = None,
        tracer: Tracer | None = None,
        heartbeat: HeartbeatWriter | None = None,
        telemetry: Any = None,   # telemetry.bridge.TrainTelemetry
        quant_calib: str | None = None,   # JSON path for graftquant stats
        model: Any = None) -> Any:
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
    *profiler*: a :class:`~utils.profiling.StepProfiler` tracing a
    steady-state step window; it is stopped on every return.

    Every ``log_every`` steps the primary emits a ``train_step`` event
    (loss, step ms, examples/s, MFU when ``flops_per_example`` and
    ``peak_flops`` are given, and the step's aux metrics). Every
    ``eval_every`` steps ``eval_fn(state)`` runs and its metrics are
    emitted as ``eval``; when *checkpointer* tracks a best metric
    (``keep_best_metric``) each eval also saves a metric-carrying
    checkpoint (``ModelCheckpoint save_best_only`` parity,
    ``tensorflow_mnist_gpu.py:160-163``).

    *tracer*: a :class:`telemetry.trace.Tracer` adding the loop's built-in
    spans — ``data_wait`` (host blocked on the batch source), ``step``
    (the host's launch of the step; the card runs on asynchronously, so
    this measures host-side cost unless the step syncs) and
    ``checkpoint`` (save calls). The log cadence's ``float(loss)`` sync
    lies outside every span. *heartbeat*: a
    :class:`telemetry.heartbeat.HeartbeatWriter` beaten every step with
    the current step and the tracer's last-completed span. *telemetry*: a
    :class:`telemetry.bridge.TrainTelemetry` whose gauges update at the
    ``log_every`` cadence for the ``/metrics`` scrape.

    *quant_calib*: path for a graftquant calibration dump — on normal
    completion the primary writes *model*'s per-channel absmax stats as
    JSON (:func:`dump_quant_calibration`; *model* is the module whose
    parameters ``state`` trains), which
    ``serve.quant.quantize_model(calibration=...)`` uses to clip its int8
    scales, and emits ``quant_calib``. Preempted runs skip the dump:
    half-trained stats would silently mis-calibrate the serving weights.
    """
    if quant_calib is not None and model is None:
        raise ValueError("quant_calib needs the model whose weights it dumps")
    inj = _faults.active()
    # A state without a step counter (a test's stand-in) starts at 0, as
    # the JAX loop always does before a restore.
    start_step = int(getattr(state, "step", 0))
    if checkpointer is not None:
        restored = checkpointer.restore_latest(state)
        if restored is not None:
            state, start_step = restored
            if metrics:
                metrics.emit("restore", step=start_step,
                             **_cost(checkpointer.last_restore))
    batch_iter = batches(start_step) if callable(batches) else batches
    tr = tracer if tracer is not None else _NULL_TRACER
    n_dev = distributed.process_count()
    t_last = time.monotonic()
    step_last = start_step

    def save(step, **kw):
        with tr.span("checkpoint", step=step):
            saved = checkpointer.save(step, state, **kw)
        return _cost(checkpointer.last_save) if saved else {}

    def saved(step):
        if telemetry is not None:
            telemetry.on_checkpoint()
        if inj is not None:
            checkpointer.wait()
            inj.fire("checkpoint_saved", step=step,
                     path=checkpointer.directory)

    for step in range(start_step, num_steps):
        if inj is not None:
            inj.fire("step", step=step)
        if profiler is not None:
            profiler.step_hook(step)
        # Both hot-loop spans carry step= so graftscope can align ranks on
        # step number instead of wall clock.
        with tr.span("data_wait", step=step):
            if inj is not None:
                inj.fire("data_wait", step=step)
            batch = next(batch_iter)
        with tr.span("step", step=step):
            state, loss, aux = step_fn(state, batch, fold_in(rng, step))
        if heartbeat is not None and (
                inj is None or not inj.suppressed("heartbeat", step=step + 1)):
            heartbeat.beat(step + 1, last_span=tr.last_span)
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
                if profiler is not None:
                    profiler.stop()
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
            if telemetry is not None:
                telemetry.on_log(steps_in_window=window, loss=loss_f,
                                 step_time_ms=dt_ms, examples_per_sec=eps,
                                 mfu=m)
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
                if telemetry is not None:
                    telemetry.on_checkpoint()
        if (checkpointer is not None and checkpoint_every
                and (step + 1) % checkpoint_every == 0):
            cost = save(step + 1)
            if metrics:
                metrics.emit("checkpoint", step=step + 1, **cost)
            saved(step + 1)
    if profiler is not None:
        profiler.stop()
    if (checkpointer is not None and num_steps > start_step
            and checkpointer.latest_step() != num_steps):
        cost = save(num_steps, force=True)
        if metrics:
            metrics.emit("checkpoint", step=num_steps, final=True, **cost)
        saved(num_steps)
    if quant_calib is not None and distributed.is_primary():
        n = dump_quant_calibration(model, quant_calib)
        if metrics:
            metrics.emit("quant_calib", step=num_steps, path=quant_calib,
                         entries=n)
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


def should_log() -> bool:
    return distributed.is_primary()
