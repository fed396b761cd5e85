"""Checkpoint save and restore: the ``MonitoredTrainingSession`` semantics.

Port of ``k8s_distributed_deeplearning_tpu/train/checkpoint.py``
(``Checkpointer``) with a torch format in place of orbax. The reference
checkpoints on rank 0 only, into ``./checkpoints``, with periodic saves
and restore-on-start (``tensorflow_mnist.py:157-167``); the Keras variant
keeps the best checkpoint by a validation metric
(``tensorflow_mnist_gpu.py:160-163``).

On disk, beside the JAX package's layout (``utils/ckpt.py``: digit-named
step dirs, ``manifest-<step>.json``, ``quarantined-<step>-<k>``):

- a step is written to ``<dir>/<step>.tmp-<pid>/`` and renamed to
  ``<dir>/<step>/``; the rename is the commit point, then the manifest
  (size and MD5 of every file) is written beside it;
- a step dir holds ``state.pt``, one ``torch.save`` of the state with
  every tensor on the CPU (a ``TrainState`` is stored as its dict:
  params by name, the optimizer state with ``count`` and ``mu``/``nu`` or
  ``trace``, ``step``), and ``metrics.json`` when the save carried a
  metric. It is read with ``torch.load(weights_only=True)``.

Only the primary process (rank 0) writes. On restore rank 0 reads,
verifies and quarantines, then broadcasts the step and the state to the
other ranks, so no shared filesystem is needed
(``BroadcastGlobalVariablesHook(0)`` parity). Restore writes into the
caller's live tensors (``copy_``): the train step updates the model's own
parameters in place, so a restore that returned new tensors would leave
the model and the state apart.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from typing import Any

import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.utils import ckpt as ckpt_paths

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor on the CPU (a new tensor even
    for a CPU one, so a later in-place step cannot reach the snapshot) and
    every named tuple as its dict: what ``torch.load(weights_only=True)``
    reads back."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if _is_namedtuple(tree):
        return {k: _to_host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree


def _skeleton(tree: Any) -> Any:
    """``tree`` with its tensors replaced by None: the part of a loaded
    state that rank 0 sends as an object (steps, counts)."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return tree


@torch.no_grad()
def _restore_into(template: Any, loaded: Any, path: str = "") -> Any:
    """``template``'s structure with ``loaded``'s values: tensors are
    copied into the template's own tensors (None in ``loaded`` leaves a
    tensor as it is, for the broadcast to fill), everything else is taken
    from ``loaded``. Raises ValueError when the two do not match."""
    if isinstance(template, torch.Tensor):
        if loaded is None:
            return template
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != template.shape or \
                loaded.dtype != template.dtype:
            got = (f"{tuple(loaded.shape)} {loaded.dtype}"
                   if isinstance(loaded, torch.Tensor) else repr(loaded))
            raise ValueError(
                f"checkpoint leaf {path or '<root>'} is {got}, the state "
                f"holds {tuple(template.shape)} {template.dtype}")
        template.copy_(loaded)
        return template
    if _is_namedtuple(template) or isinstance(template, dict):
        fields = (template._fields if _is_namedtuple(template)
                  else list(template))
        if not isinstance(loaded, dict) or set(loaded) != set(fields):
            raise ValueError(
                f"checkpoint node {path or '<root>'} has keys "
                f"{sorted(loaded) if isinstance(loaded, dict) else loaded!r}"
                f", the state {sorted(fields)}")
        src = template._asdict() if _is_namedtuple(template) else template
        out = {k: _restore_into(src[k], loaded[k], f"{path}/{k}")
               for k in fields}
        return type(template)(**out) if _is_namedtuple(template) else out
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, list) or len(loaded) != len(template):
            raise ValueError(f"checkpoint node {path or '<root>'} does not "
                             f"match the state's {len(template)} entries")
        return type(template)(_restore_into(t, v, f"{path}/{i}")
                              for i, (t, v) in enumerate(zip(template,
                                                             loaded)))
    return loaded


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of ``tree`` in a fixed order (the state's own
    order, the same on every rank)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if _is_namedtuple(tree):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (a no-op outside a group of two or
    more)."""
    if _world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class Checkpointer:
    """Rank-0 checkpoints of a training state, with retention, an async
    mode and the manifest-verified restore chain.

    ``max_to_keep`` newest steps are kept. ``keep_best_metric`` switches
    retention to best-by-metric (``ModelCheckpoint(save_best_only=True)``
    parity): saves carry an eval metric through ``save(...,
    metrics={...})`` and the ``max_to_keep`` best by that metric
    (``best_mode`` "max" or "min") are kept, plus the newest step always,
    so metric-less periodic saves keep crash-resume recent; a metric-less
    step that is not the newest is deleted. ``async_save`` snapshots the
    state to host memory in ``save`` and writes it on a background thread
    (one write at a time) while training goes on.

    *metrics* is an optional ``MetricsLogger``: each quarantine found by
    the restore chain is emitted as ``ckpt_quarantined`` (and always
    printed to stderr: a quarantine must never be silent)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_best_metric: str | None = None,
                 best_mode: str = "max", async_save: bool = False,
                 metrics=None):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got "
                             f"{best_mode!r}")
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_best_metric = keep_best_metric
        self.best_mode = best_mode
        self.async_save = async_save
        self.metrics = metrics
        self.quarantined: list[tuple[int, str]] = []   # (step, reason)
        # The last save's and restore's cost: ms and bytes ("save_ms" is
        # what the caller waited, the host snapshot alone when async).
        self.last_save: dict = {}
        self.last_restore: dict = {}
        self._lock = threading.Lock()
        self._writer: threading.Thread | None = None
        self._writing: int | None = None         # step of the write
        self._error: Exception | None = None

    # ------------------------------------------------------------- saving

    def save(self, step: int, state: Any, force: bool = False,
             metrics: dict | None = None) -> bool:
        """Save *state* at *step* on the primary process; returns whether
        a save was made (other ranks write nothing and return False). A
        step that is already committed, or older than the newest one
        (unless *force*), is not saved again. Synchronous mode returns
        once the step and its manifest are on disk; ``async_save`` returns
        after the host snapshot."""
        if _world()[0] != 0:
            return False
        latest = self.latest_step()
        if latest is not None and (step == latest or
                                   (step < latest and not force)):
            return False
        if os.path.isdir(os.path.join(self.directory, str(step))):
            return False
        t0 = time.perf_counter()
        host = _to_host(state)
        metric = None
        if metrics is not None and self.keep_best_metric is not None:
            metric = {k: float(v) for k, v in metrics.items()}
        self.wait()
        self.last_save = {"step": step,
                          "snapshot_ms": (time.perf_counter() - t0) * 1e3}
        if self.async_save:
            with self._lock:
                self._writing = step
            self.last_save["save_ms"] = self.last_save["snapshot_ms"]
            self._writer = threading.Thread(
                target=self._write_guarded, args=(step, host, metric),
                daemon=True)
            self._writer.start()
        else:
            self._write(step, host, metric)
            self.last_save = {**self.last_save,
                              "save_ms": (time.perf_counter() - t0) * 1e3}
        return True

    def _write_guarded(self, step, host, metric) -> None:
        try:
            self._write(step, host, metric)
        except Exception as e:   # noqa: BLE001 — re-raised by wait()
            self._error = e
        finally:
            with self._lock:
                self._writing = None

    def _write(self, step: int, host: Any, metric: dict | None) -> None:
        """Write, commit (rename), manifest, then apply retention."""
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f"{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_FILE))
        if metric is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metric, f)
        os.replace(tmp, os.path.join(self.directory, str(step)))
        t_commit = time.perf_counter()
        man = ckpt_paths.write_manifest(self.directory, step)
        # A new dict, not an update: an async write must not change the
        # dict a reader is iterating.
        self.last_save = {
            **self.last_save,
            "bytes": sum(f["size"] for f in man["files"].values()),
            "write_ms": (t_commit - t0) * 1e3,
            "manifest_ms": (time.perf_counter() - t_commit) * 1e3}
        self._retain()
        ckpt_paths.gc_manifests(self.directory)

    def _metric_of(self, step: int) -> float | None:
        if self.keep_best_metric is None:
            return None
        try:
            with open(os.path.join(self.directory, str(step),
                                   METRICS_FILE)) as f:
                return float(json.load(f)[self.keep_best_metric])
        except (OSError, ValueError, KeyError):
            return None

    def _best(self, steps: list[int]) -> list[int]:
        """Steps carrying the tracked metric, best first (ties: newest)."""
        scored = [(m, s) for s in steps
                  if (m := self._metric_of(s)) is not None]
        scored.sort(reverse=self.best_mode == "max",
                    key=lambda ms: (ms[0], ms[1] if self.best_mode == "max"
                                    else -ms[1]))
        return [s for _, s in scored]

    def _retain(self) -> None:
        """LatestN(1) + BestN(max_to_keep) with a tracked metric, else the
        ``max_to_keep`` newest steps; every other step dir is deleted."""
        steps = ckpt_paths.steps_on_disk(self.directory)
        if self.keep_best_metric is None:
            keep = set(steps[-self.max_to_keep:])
        else:
            keep = set(self._best(steps)[:self.max_to_keep])
            keep.update(steps[-1:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)),
                              ignore_errors=True)

    def wait(self) -> None:
        """Block until an outstanding async save is on disk (a no-op when
        synchronous); re-raises the error of a failed background write."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -------------------------------------------------------------- steps

    def latest_step(self) -> int | None:
        """Newest committed step, or the step an async save is writing."""
        with self._lock:
            writing = self._writing
        steps = ckpt_paths.steps_on_disk(self.directory)
        if writing is not None:
            steps.append(writing)
        return max(steps) if steps else None

    def best_step(self) -> int | None:
        """Step of the best checkpoint by the tracked metric (None when
        not tracking one, or nothing metric-carrying is kept)."""
        if self.keep_best_metric is None:
            return None
        self.wait()
        best = self._best(ckpt_paths.steps_on_disk(self.directory))
        return best[0] if best else None

    # ---------------------------------------------------------- restoring

    def _load(self, step: int) -> Any:
        path = os.path.join(self.directory, str(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)

    def _quarantine(self, step: int, reason: str) -> None:
        dst = ckpt_paths.quarantine_step(self.directory, step, reason)
        self.quarantined.append((step, reason))
        print(f"checkpoint step {step} quarantined -> {dst}: {reason}",
              file=sys.stderr, flush=True)
        if self.metrics is not None:
            self.metrics.emit("ckpt_quarantined", step=step, reason=reason,
                              moved_to=dst)

    def _latest_good(self) -> tuple[Any, int] | None:
        """Rank 0's restore chain: the newest step that verifies against
        its manifest and loads; each one that does not is quarantined."""
        while True:
            steps = ckpt_paths.steps_on_disk(self.directory)
            if not steps:
                return None
            step = steps[-1]
            problem = ckpt_paths.verify_manifest(self.directory, step)
            if problem is None:
                try:
                    return self._load(step), step
                except Exception as e:   # noqa: BLE001 — any torn read
                    problem = f"restore raised {type(e).__name__}: {e}"
            self._quarantine(step, problem)

    def _restore(self, state: Any, chosen) -> tuple[Any, int] | None:
        """Rank 0 picks and loads a step with ``chosen()`` (-> (loaded,
        step) or None), copies it into ``state``'s tensors and broadcasts
        the step, the non-tensor values and every tensor to the group."""
        self.wait()
        rank, world = _world()
        t0 = time.perf_counter()
        got = chosen() if rank == 0 else None
        step = _broadcast_object(None if got is None else got[1])
        if step is None:
            return None
        loaded = got[0] if rank == 0 else _broadcast_object(None)
        if rank == 0 and world > 1:
            _broadcast_object(_skeleton(loaded))
        restored = _restore_into(state, loaded)
        if world > 1:
            for t in _tensors(restored):
                dist.broadcast(t, src=0)
        tensors = _tensors(restored)
        if tensors and tensors[0].is_cuda:
            torch.cuda.synchronize(tensors[0].device)
        self.last_restore = {
            "step": step, "restore_ms": (time.perf_counter() - t0) * 1e3,
            "bytes": sum(t.numel() * t.element_size() for t in tensors)}
        return restored, step

    def restore_latest(self, state: Any) -> tuple[Any, int] | None:
        """Restore the newest GOOD checkpoint into *state* (the live
        training state: its tensors are written in place and returned in
        the same structure), or None when none loads: the restore-on-start
        path (``tensorflow_mnist.py:162-167``) as a fallback chain. Each
        candidate step is verified against its manifest (size and MD5 of
        every file) first; a step that fails, or whose load raises, is
        quarantined (``quarantined-<step>-<k>``, ``ckpt_quarantined``
        emitted) and the chain falls back to the next older step. A
        checkpoint whose structure does not match *state* raises
        ValueError: the state is wrong, not the checkpoint.

        Collective: every rank calls it; rank 0 reads and the others take
        its values."""
        return self._restore(state, self._latest_good)

    def restore_best(self, state: Any) -> tuple[Any, int] | None:
        """Restore the best checkpoint by the tracked metric (the
        best-model export path), distinct from :meth:`restore_latest`,
        which serves crash-resume and may be newer than the best."""
        def best():
            step = self.best_step()
            return None if step is None else (self._load(step), step)
        return self._restore(state, best)

    def restore_params(self, key: str = "params",
                       device: str | torch.device = "cpu"
                       ) -> tuple[dict, int] | None:
        """Only the *key* subtree of the newest checkpoint, as new tensors
        on *device* (the inference path): the file is memory-mapped, so
        the optimizer moments are never read, and the caller needs no
        model or optimizer to restore into. Reads this process's
        directory; no collective."""
        self.wait()
        step = ckpt_paths.latest_step_on_disk(self.directory)
        if step is None:
            return None
        sub = self._load(step)[key]
        return {k: v.to(device, copy=True) for k, v in sub.items()}, step

    def close(self) -> None:
        """Drain an outstanding async save."""
        self.wait()
