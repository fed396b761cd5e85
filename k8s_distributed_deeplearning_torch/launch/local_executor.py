"""Local gang executor — run the rendered job manifest without a cluster.

The port's own copy of ``k8s_distributed_deeplearning_tpu/launch/
local_executor.py``. Emulates what the Kubernetes Indexed-Job controller
+ kubelet would do with ``render_tpujob``'s output (the ``mpirun``
local-mode analog, and the strongest no-cluster test of the launch
layer):

- one OS process per completion index, all started together (gang);
- each process gets exactly the env the manifest declares, with
  ``fieldRef`` values resolved the way the kubelet resolves them (the
  ``job-completion-index`` annotation becomes this pod's index);
- the container ``command`` is executed as-is (the image's ``python`` maps
  to this interpreter).

The single documented cluster-vs-local substitution: the coordinator's
headless-service DNS name (``<job>-0.<job>.<ns>``) cannot resolve outside
cluster DNS, so it is rewritten to loopback with a fresh port. Everything
else — rank identity, world size, command line, script args — is consumed
from the manifest, so a rendering bug (wrong fieldRef, wrong
NUM_PROCESSES, broken script path) fails this execution the same way it
would fail the real Job. Each run is stamped ``$TPUJOB_ATTEMPT``, and the
``executor`` fault site (a killer outside the worker) fires here.

On the CPU the workers form a gloo process group; on a GPU host each
rank takes card ``rank % device_count`` under NCCL, which refuses two
ranks on one card.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
from dataclasses import dataclass

from k8s_distributed_deeplearning_torch import faults as _faults
from k8s_distributed_deeplearning_torch.config import JobConfig
from k8s_distributed_deeplearning_torch.launch import render, validate


@dataclass
class WorkerResult:
    index: int
    returncode: int
    stdout: str
    stderr: str


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve_env(container_env: list[dict], index: int) -> dict[str, str]:
    """Resolve the manifest's env list for pod *index* (kubelet semantics)."""
    out: dict[str, str] = {}
    for e in container_env:
        if "value" in e:
            out[e["name"]] = e["value"]
            continue
        ref = e.get("valueFrom", {}).get("fieldRef", {}).get("fieldPath", "")
        if "job-completion-index" in ref:
            out[e["name"]] = str(index)
        else:
            raise NotImplementedError(
                f"local executor cannot resolve fieldRef {ref!r}")
    return out


def _executor_fault_threads(container_env: list[dict],
                            extra_env: dict[str, str] | None,
                            attempt: int, procs: list) -> list:
    """Parent-side ``executor`` faults: the manifest (or overlay) names a
    fault plan, and faults with ``site: executor`` model the KILLER BEING
    OUTSIDE the worker — the kubelet OOM-killing a pod, a node reclaim —
    so they run here in the launcher, as timers that signal the victim
    rank. Worker-internal sites (step, data_wait, ...) ride the env into
    the children instead. Returns the started timer threads (daemon)."""
    import threading

    raw = (extra_env or {}).get(_faults.FAULT_PLAN_ENV)
    if raw is None:
        for e in container_env:
            if e.get("name") == _faults.FAULT_PLAN_ENV:
                raw = e.get("value")
    raw = (raw or "").strip()
    if not raw:
        return []
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    plan = _faults.FaultPlan.from_json(raw)
    threads = []
    for f in plan.faults:
        if f.site != "executor":
            continue
        if f.attempt is not None and f.attempt != attempt:
            continue
        sig = signal.SIGKILL if f.action == "exit" else signal.SIGTERM
        victim = procs[f.rank]

        def kill(victim=victim, sig=sig, delay=f.seconds, rank=f.rank):
            import time as _time
            _time.sleep(delay)
            if victim.poll() is None:
                print(f"fault-injection: executor sends signal {sig} to "
                      f"rank {rank} (pid {victim.pid})",
                      file=sys.stderr, flush=True)
                try:
                    victim.send_signal(sig)
                except OSError:
                    pass
        t = threading.Thread(target=kill, daemon=True)
        t.start()
        threads.append(t)
    return threads


def run_local(cfg: JobConfig, *, extra_env: dict[str, str] | None = None,
              timeout: int = 600, cwd: str | None = None,
              attempt: int = 0) -> list[WorkerResult]:
    """Execute the job's pod template locally, one process per index.

    *extra_env* overlays the manifest env (e.g. forcing the CPU backend for
    CI). Returns per-worker results; raises on validation errors before
    anything is spawned — the same fail-fast a server-side dry-run gives.

    *attempt* is the restart incarnation (0 on the first run); it is
    stamped into each worker as ``$TPUJOB_ATTEMPT`` so attempt-scoped
    faults don't re-fire after the restart they caused — the mechanism
    that lets one plan express "kill once at step 3, then run clean".
    """
    docs = render.render_all(cfg)
    validate.validate_or_raise(docs)
    job = docs[-1]
    spec = job["spec"]
    container = spec["template"]["spec"]["containers"][0]
    n = spec["parallelism"]
    port = _free_port()

    cmd = list(container["command"]) + list(container.get("args", []))
    # The container image's `python` is this interpreter locally.
    if cmd and cmd[0] in ("python", "python3"):
        cmd[0] = sys.executable

    import threading

    procs = []
    try:
        for idx in range(n):
            env = dict(os.environ)
            env.update(_resolve_env(container["env"], idx))
            # The one cluster-vs-local substitution (see module docstring).
            env["TPUJOB_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            env.update(extra_env or {})
            env[_faults.ATTEMPT_ENV] = str(attempt)
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=cwd, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))

        _executor_fault_threads(container["env"], extra_env, attempt, procs)

        # Drain every worker's pipes CONCURRENTLY: sequential communicate()
        # would deadlock the gang when a later worker fills its 64KiB pipe
        # while an earlier one waits for it at a collective.
        outputs: list = [None] * n

        def drain(idx, p):
            outputs[idx] = p.communicate()

        import time as _time

        threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        for t in threads:
            t.start()
        deadline = _time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - _time.monotonic()))
        if any(t.is_alive() for t in threads):
            for q in procs:
                q.kill()
            for t in threads:
                t.join(timeout=10)
            raise subprocess.TimeoutExpired(cmd, timeout)
    finally:
        # Reap every worker on every path (a failed spawn, an interrupt):
        # a worker that outlives its launcher keeps its card's memory.
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    return [WorkerResult(i, p.returncode, *outputs[i])
            for i, p in enumerate(procs)]
