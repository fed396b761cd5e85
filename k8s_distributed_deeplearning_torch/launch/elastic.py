"""Elastic data parallelism through the control plane.

The port's own copy of ``k8s_distributed_deeplearning_tpu/launch/
elastic.py``. The reference ships elasticity only as a doc link to
Horovod's elastic example (``horovod/README.md:20-22``). A
``torch.distributed`` process group, like MPI's world, has its membership
fixed at ``init_process_group``, so elasticity lives in the **control
plane**, where K8s already does it:

- the world size lives in ONE rendered object (the Indexed Job's
  ``completions``/``parallelism`` + ``TPUJOB_NUM_PROCESSES`` env);
- when the worker set must change (scale-up, spot eviction, crash), the
  job is re-rendered at the new size and every worker restarts;
- state survives through the checkpoint stream, not through live process
  membership: restore-on-start (``train/loop.py``) is replay-free, so the
  restarted gang continues from the newest step on disk.

:func:`run_elastic` implements that reconcile loop over the local gang
executor (the no-cluster analog of the controller; on a real cluster the
same loop is "re-render + ``kubectl apply`` + let the Job restart pods",
``launch/watch.py``).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable

from k8s_distributed_deeplearning_torch.config import JobConfig
from k8s_distributed_deeplearning_torch.launch.local_executor import (
    WorkerResult,
    run_local,
)
from k8s_distributed_deeplearning_torch.utils.ckpt import latest_step_on_disk

# A resize policy maps (current config, observed failure state) -> next
# config. The observation type depends on the loop: run_elastic passes the
# local gang's list[WorkerResult]; launch.watch passes its GangStatus.
# ONE policy type serves both (the built-in ignores the observation).
ResizeFn = Callable[[JobConfig, object], JobConfig]


def resize_to(num_workers: int) -> ResizeFn:
    """Resize policy: restart at a fixed new world size (works with both
    the local run_elastic loop and the on-cluster launch.watch loop)."""
    def fn(cfg: JobConfig, _observed: object) -> JobConfig:
        return dataclasses.replace(cfg, num_workers=num_workers)
    return fn


class CrashLoopError(RuntimeError):
    """Restarting is no longer converging: N consecutive failed attempts
    each advanced the checkpoint stream by fewer than the required steps.
    Carries the per-attempt exit codes for the post-mortem."""

    def __init__(self, msg: str, exit_codes: list[list[int]]):
        super().__init__(msg)
        self.exit_codes = exit_codes


def run_elastic(cfg: JobConfig, *, max_restarts: int = 3,
                resize: ResizeFn | None = None,
                extra_env: dict[str, str] | None = None,
                timeout: int = 600, cwd: str | None = None,
                on_restart: Callable[[int, JobConfig], None] | None = None,
                checkpoint_dir: str | None = None,
                min_progress_steps: int = 1,
                crash_loop_after: int = 3,
                metrics=None,
                ) -> tuple[list[WorkerResult], int]:
    """Run the rendered gang to completion, restarting (optionally resized)
    on failure.

    Each attempt executes the job exactly as rendered (see
    ``local_executor``), stamped with its attempt number
    (``$TPUJOB_ATTEMPT``). A clean gang (all workers exit 0) returns
    ``(results, restarts_used)``. On any worker failure the *resize* policy
    picks the next world size (default: same size — crash recovery), the
    job is re-rendered, and the new gang resumes from the checkpoint
    directory the training script was configured with. More than
    *max_restarts* failed attempts raises, carrying the last gang's stderr.

    **Crash-loop detection** (*checkpoint_dir* set): every failed attempt
    is classified by whether the newest step under *checkpoint_dir*
    advanced by at least *min_progress_steps* since the previous attempt.
    *crash_loop_after* consecutive NO-PROGRESS failures mean restarting is
    burning quota without converging — a poison batch, a corrupt-data
    crash before the first save, an OOM at a fixed step — so the loop
    stops early with :class:`CrashLoopError` naming each dead attempt's
    exit codes (and emits a ``crash_loop`` event through *metrics* when
    given), instead of replaying the same death ``max_restarts`` times.
    """
    import subprocess

    restarts = 0
    no_progress = 0
    loop_exit_codes: list[list[int]] = []
    last_step = (latest_step_on_disk(checkpoint_dir)
                 if checkpoint_dir else None)
    while True:
        try:
            results = run_local(cfg, extra_env=extra_env, timeout=timeout,
                                cwd=cwd, attempt=restarts)
        except subprocess.TimeoutExpired:
            # A partially-hung gang (e.g. one worker killed, peers stuck at
            # a collective) is the canonical eviction mode — it consumes a
            # restart attempt like any other failure.
            results = []
        if results and all(r.returncode == 0 for r in results):
            return results, restarts
        restarts += 1
        if checkpoint_dir is not None:
            step = latest_step_on_disk(checkpoint_dir)
            advanced = (step or 0) - (last_step or 0)
            last_step = step
            codes = [r.returncode for r in results] if results else []
            if advanced < min_progress_steps:
                no_progress += 1
                loop_exit_codes.append(codes)
            else:
                no_progress = 0
                loop_exit_codes = []
            if no_progress >= crash_loop_after:
                msg = (f"crash loop: {no_progress} consecutive attempts "
                       f"died with <{min_progress_steps} checkpointed "
                       f"step(s) of progress (latest step: {step}); "
                       f"exit codes per attempt: {loop_exit_codes}")
                print(msg, file=sys.stderr, flush=True)
                if metrics is not None:
                    metrics.emit("crash_loop", attempts=no_progress,
                                 latest_step=step,
                                 exit_codes=loop_exit_codes)
                raise CrashLoopError(msg, loop_exit_codes)
        if restarts > max_restarts:
            if not results:
                raise RuntimeError(
                    f"gang failed {restarts} times (last attempt timed out "
                    f"after {timeout}s — workers killed)")
            failed = [r for r in results if r.returncode != 0]
            raise RuntimeError(
                f"gang failed {restarts} times (last: worker "
                f"{failed[0].index} exited {failed[0].returncode}):\n"
                + failed[0].stderr[-2000:])
        if resize is not None:
            cfg = resize(cfg, results)
        if on_restart is not None:
            on_restart(restarts, cfg)
