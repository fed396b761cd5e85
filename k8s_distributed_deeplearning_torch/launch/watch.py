"""``launch watch`` — the on-cluster reconcile loop.

The port's own copy of ``k8s_distributed_deeplearning_tpu/launch/
watch.py``. The reference's MPI Operator (installed at
``deploy_stack.sh:38``) is a LIVE controller: it watches MPIJob objects
and their pods and re-creates the gang when it breaks. This module is the
same reconcile against the K8s API:

- the desired state is exactly the rendered objects (``launch/render.py``
  — world size lives in ONE Indexed Job's completions/parallelism + env);
- :func:`watch` observes the gang through the Job status (``kubectl get
  job -o json``): completion ends the loop; a terminal ``Failed``
  condition (worker exits beyond backoffLimit) or an attempt TIMEOUT (the
  canonical broken-gang mode — a killed/evicted pod leaves peers parked
  at a collective, so the job neither fails nor finishes) triggers
  reconcile;
- reconcile = delete the Job (foreground), pick the next world size via
  the resize policy, re-render, re-apply. Workers resume from their
  checkpoint directory — state survives through the checkpoint stream,
  not live process membership (``launch/elastic.py``).

kubectl access is behind the injectable :class:`Kubectl` (retried through
``utils/retry.py``), so the reconcile logic runs against a scripted fake;
a live run needs a cluster. :meth:`Kubectl.patch_job` is also the
autoscaler's actuation (``serve/autoscale.py`` ``K8sParallelismBackend``).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from typing import Callable

from k8s_distributed_deeplearning_torch.config import JobConfig
from k8s_distributed_deeplearning_torch.launch import render, validate
from k8s_distributed_deeplearning_torch.launch.elastic import (  # noqa: F401
    ResizeFn,
    resize_to,
)
from k8s_distributed_deeplearning_torch.telemetry import fleet as fleet_mod
from k8s_distributed_deeplearning_torch.telemetry import heartbeat as hb
from k8s_distributed_deeplearning_torch.utils.ckpt import latest_step_on_disk
from k8s_distributed_deeplearning_torch.utils.retry import retry_transient

# Stderr substrings marking a kubectl failure as transient — an apiserver
# blip worth retrying, not a config error worth surfacing.
_TRANSIENT_MARKERS = ("timed out", "timeout", "connection refused",
                      "connection reset", "tls handshake",
                      "temporarily unavailable", "i/o timeout",
                      "unexpected eof", "service unavailable")


def _is_transient(text: str) -> bool:
    low = text.lower()
    return any(m in low for m in _TRANSIENT_MARKERS)


class _TransientRC(Exception):
    """Internal: a non-zero kubectl exit whose stderr looks transient,
    wrapped as an exception so ``utils.retry.retry_transient`` drives the
    backoff; the final attempt's payload is unwrapped back to (rc, out,
    err) — callers keep seeing return codes, never this type."""

    def __init__(self, rc: int, out: str, err: str):
        super().__init__(err)
        self.result = (rc, out, err)


@dataclasses.dataclass(frozen=True)
class GangStatus:
    """Observed state of the gang's Job object."""
    exists: bool = False
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    job_failed: bool = False    # terminal Failed condition (backoff exceeded)

    def complete(self, cfg: JobConfig) -> bool:
        return self.succeeded >= cfg.num_workers


class Kubectl:
    """Thin shell client for the few verbs the watcher needs. *runner* is
    injectable (tests script it); the default shells to ``kubectl``.

    Transient failures (apiserver timeout, connection refused — the
    blips a live reconcile loop WILL meet over hours) are retried up to
    *retries* times with full-jitter exponential backoff under the
    *backoff_s* ceiling;
    anything else (NotFound, Forbidden, bad manifest) surfaces
    immediately. A watch must not die on the first network hiccup, and
    must also not retry forever against a genuinely broken config."""

    def __init__(self, context: str | None = None,
                 runner: Callable | None = None, *,
                 retries: int = 2, backoff_s: float = 1.0,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] | None = None):
        self.context = context
        self.retries = retries
        self.backoff_s = backoff_s
        self._sleep = sleep
        self._rng = rng
        self._runner = runner or self._subprocess_runner

    def _subprocess_runner(self, args: list[str], input_text: str | None,
                           timeout: float = 120.0) -> tuple[int, str, str]:
        base = ["kubectl"] + (["--context", self.context]
                              if self.context else [])
        try:
            proc = subprocess.run(base + args, input=input_text,
                                  capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as e:
            # Surface as the loop's error type — a reconcile must never
            # die on a raw TimeoutExpired traceback mid-recovery.
            raise RuntimeError(f"kubectl {' '.join(args[:2])} timed out "
                              f"after {timeout}s") from e
        except FileNotFoundError as e:
            raise RuntimeError(
                "kubectl not found on PATH — launch watch needs cluster "
                "access (use run-local --max-restarts for the no-cluster "
                "reconcile loop)") from e
        return proc.returncode, proc.stdout, proc.stderr

    def _call_runner(self, args, input_text, timeout):
        try:
            return self._runner(args, input_text, timeout)
        except TypeError:   # injected test runners take (args, input) only
            return self._runner(args, input_text)

    def _run_kubectl(self, args, input_text=None, timeout=120.0):
        """Run one kubectl verb with bounded transient-failure retry
        (the shared ``utils.retry`` policy; kubectl-not-found and other
        permanent errors surface on the first attempt)."""
        def attempt():
            rc, out, err = self._call_runner(args, input_text, timeout)
            if rc != 0 and _is_transient(err):
                raise _TransientRC(rc, out, err)
            return rc, out, err

        try:
            # jitter=True: every watcher replica backing off an apiserver
            # blip in lockstep is exactly the thundering herd that keeps
            # the apiserver down.
            return retry_transient(
                attempt, retries=self.retries, backoff_s=self.backoff_s,
                sleep=self._sleep, jitter=True, rng=self._rng,
                # Surfaced kubectl timeouts (RuntimeError) retry too.
                is_transient=lambda e: isinstance(e, _TransientRC) or (
                    isinstance(e, RuntimeError) and _is_transient(str(e))))
        except _TransientRC as e:
            # Still failing transiently after the last retry: hand the
            # final (rc, out, err) back for the caller's own error path.
            return e.result

    def apply(self, text: str) -> None:
        rc, _, err = self._run_kubectl(["apply", "-f", "-"], text)
        if rc:
            raise RuntimeError(f"kubectl apply failed: {err[-2000:]}")

    def patch_job(self, name: str, namespace: str, patch: str) -> None:
        """Merge-patch one Job by name — the autoscaler's parallelism
        actuation (serve/autoscale.py). Raises :class:`OSError` on a
        non-zero exit so the controller's actuation-failure accounting
        (retry next round) catches it like any other I/O fault."""
        rc, _, err = self._run_kubectl(
            ["patch", "job", name, "-n", namespace, "--type", "merge",
             "-p", patch])
        if rc:
            raise OSError(f"kubectl patch job {name} failed rc={rc}: "
                          f"{err[-2000:]}")

    def delete_job(self, cfg: JobConfig) -> None:
        """Foreground-delete the gang's Job (pods gone before return);
        absent Job is fine (first reconcile after an external delete).
        Long timeout: foreground cascade waits out pod termination grace
        periods."""
        rc, _, err = self._run_kubectl(
            ["delete", "job", cfg.name, "-n", cfg.namespace,
             "--cascade=foreground", "--wait=true", "--ignore-not-found"],
            None, timeout=600.0)
        if rc:
            raise RuntimeError(f"kubectl delete job failed: {err[-2000:]}")

    def job_status(self, cfg: JobConfig) -> GangStatus:
        rc, out, err = self._run_kubectl(
            ["get", "job", cfg.name, "-n", cfg.namespace, "-o", "json"])
        if rc:
            if "NotFound" in err or "not found" in err:
                return GangStatus(exists=False)
            raise RuntimeError(f"kubectl get job failed: {err[-2000:]}")
        status = json.loads(out).get("status", {})
        failed_cond = any(
            c.get("type") == "Failed" and c.get("status") == "True"
            for c in status.get("conditions") or [])
        return GangStatus(exists=True,
                          active=int(status.get("active") or 0),
                          succeeded=int(status.get("succeeded") or 0),
                          failed=int(status.get("failed") or 0),
                          job_failed=failed_cond)


@dataclasses.dataclass
class WatchResult:
    cfg: JobConfig          # final (possibly resized) job config
    restarts: int
    status: GangStatus


def watch(cfg: JobConfig, *,
          kubectl: Kubectl | None = None,
          resize: ResizeFn | None = None,
          max_restarts: int = 3,
          attempt_timeout: float = 1800.0,
          poll_interval: float = 5.0,
          apply_first: bool = True,
          on_event: Callable[[str], None] | None = None,
          clock: Callable[[], float] = time.monotonic,
          sleep: Callable[[float], None] = time.sleep,
          heartbeat_dir: str | None = None,
          heartbeat_stale_after: float = 120.0,
          heartbeat_clock: Callable[[], float] = time.time,
          straggler_lag_steps: int | None = None,
          checkpoint_dir: str | None = None,
          min_progress_steps: int = 1,
          crash_loop_after: int = 3,
          fleet_endpoints: list[str] | None = None,
          fleet_scraper: "fleet_mod.FleetScraper | None" = None,
          fleet_policy: "fleet_mod.HealthPolicy | None" = None
          ) -> WatchResult:
    """Reconcile the gang against the cluster until it completes.

    Each ATTEMPT applies the rendered objects (validated first — the
    reference's apply-and-hope at ``deploy_stack.sh:46`` inverted) and
    polls the Job. Completion returns. A terminal Failed condition OR
    *attempt_timeout* without completion consumes a restart: the Job is
    foreground-deleted, *resize* picks the next world size (default: same
    size — crash recovery), and the re-rendered gang resumes from its
    checkpoint directory. More than *max_restarts* failed attempts raises
    with the last observed status.

    *clock*/*sleep* are injectable for deterministic unit tests.

    *heartbeat_dir*: a directory of per-rank heartbeat files (workers write
    them via :class:`telemetry.heartbeat.HeartbeatWriter`, typically on the
    shared checkpoint volume). Each poll, a rank whose newest heartbeat is
    older than *heartbeat_stale_after* seconds is reported through
    *on_event* with its rank id, last step, and last-completed span — the
    hung-collective mode becomes a NAMED diagnosis minutes in, rather than
    an anonymous attempt timeout half an hour later. Ranks are re-reported
    only after recovering (fresh heartbeat) and stalling again.

    *straggler_lag_steps* (requires *heartbeat_dir*): additionally compare
    LIVE ranks' heartbeat steps each poll — a rank whose reported step
    trails the gang's maximum by more than this many steps is reported as
    a straggler with its lag and last-completed span (graftscope's
    attribution, online and approximate: the span names WHERE the slow
    rank spends time; run ``graftscope steps`` on the rank logs for the
    per-step breakdown). Episodic like stall reports: a rank is
    re-reported only after catching back up and lagging again. Note the
    difference from stall detection: a straggler still beats (it is slow,
    not wedged), so the stale-file check never sees it.

    *checkpoint_dir*: enables crash-loop detection over the shared
    checkpoint volume (same contract as ``run_elastic``): a reconcile
    whose attempt advanced the newest on-disk step by fewer than
    *min_progress_steps* counts as no-progress; *crash_loop_after*
    consecutive no-progress reconciles abort the watch with a
    ``crash_loop`` event naming the dead attempts' Job statuses, instead
    of burning the restart budget replaying a deterministic death.

    *fleet_endpoints*: serving-replica ``/metrics`` targets to scrape
    each poll (``telemetry.fleet``). A replica whose composite health
    score drops below the policy's ``unhealthy_below`` — or that stops
    answering scrapes — is reported through *on_event* with its score
    and the dominant penalty components; episodic like stall reports
    (one report per unhealthy episode, one on recovery).
    *fleet_scraper* overrides the scraper construction (tests inject a
    scripted fetcher); *fleet_policy* tunes the health score.
    """
    kubectl = kubectl or Kubectl()
    emit = on_event or (lambda _msg: None)
    restarts = 0
    stalled_ranks: set[int] = set()     # currently-reported stalls
    lagging_ranks: set[int] = set()     # currently-reported stragglers
    no_progress = 0
    loop_statuses: list[str] = []
    last_ckpt_step = (latest_step_on_disk(checkpoint_dir)
                      if checkpoint_dir else None)
    if fleet_scraper is None and fleet_endpoints:
        fleet_scraper = fleet_mod.FleetScraper(list(fleet_endpoints))
    fleet_agg = (fleet_mod.FleetAggregator(fleet_scraper,
                                           policy=fleet_policy)
                 if fleet_scraper is not None else None)
    unhealthy_replicas: set[str] = set()   # currently-reported replicas

    def check_heartbeats() -> None:
        if heartbeat_dir is None:
            return
        stalls = hb.detect_stalls(heartbeat_dir, heartbeat_stale_after,
                                  now=heartbeat_clock())
        current = {s.rank for s in stalls}
        for s in stalls:
            if s.rank not in stalled_ranks:
                emit(s.describe())
        recovered = stalled_ranks - current
        for r in sorted(recovered):
            emit(f"rank {r} heartbeat recovered")
        stalled_ranks.clear()
        stalled_ranks.update(current)

    def check_stragglers() -> None:
        if heartbeat_dir is None or straggler_lag_steps is None:
            return
        recs = {int(r["rank"]): r for r in hb.read_heartbeats(heartbeat_dir)
                if "step" in r}
        if len(recs) < 2:
            return          # "behind" needs a peer to be behind OF
        lead = max(int(r["step"]) for r in recs.values())
        current = set()
        for rank, rec in sorted(recs.items()):
            lag = lead - int(rec["step"])
            if lag > straggler_lag_steps:
                current.add(rank)
                if rank not in lagging_ranks:
                    emit(f"rank {rank} straggling: {lag} steps behind the "
                         f"gang (step {rec['step']} vs {lead}, last "
                         f"completed span: "
                         f"{rec.get('last_span') or 'unknown'})")
        for rank in sorted(lagging_ranks - current):
            emit(f"rank {rank} caught up")
        lagging_ranks.clear()
        lagging_ranks.update(current)

    def check_fleet() -> None:
        if fleet_agg is None:
            return
        fleet_agg.scraper.poll()
        reports = fleet_agg.health_reports()
        current: set[str] = set()
        for replica, rep in reports.items():
            if rep.healthy:
                continue
            current.add(replica)
            if replica not in unhealthy_replicas:
                worst = sorted(rep.components.items(),
                               key=lambda kv: -kv[1])[:2]
                detail = ", ".join(f"{k}={v}" for k, v in worst)
                emit(f"replica {replica} unhealthy: health {rep.score} < "
                     f"{fleet_agg.policy.unhealthy_below} ({detail})")
        for replica in sorted(unhealthy_replicas - current):
            rep = reports.get(replica)
            score = rep.score if rep is not None else "?"
            emit(f"replica {replica} recovered: health {score}")
        unhealthy_replicas.clear()
        unhealthy_replicas.update(current)

    def apply_current(c: JobConfig) -> None:
        docs = render.render_all(c)
        validate.validate_or_raise(docs)
        kubectl.apply(render.to_yaml(docs))
        emit(f"applied {c.name} at world size {c.num_workers}")

    if apply_first:
        apply_current(cfg)

    while True:
        deadline = clock() + attempt_timeout
        status = GangStatus()
        failed = False
        while clock() < deadline:
            status = kubectl.job_status(cfg)
            check_heartbeats()
            check_stragglers()
            check_fleet()
            if status.complete(cfg):
                emit(f"complete: {status.succeeded}/{cfg.num_workers} "
                     "succeeded")
                return WatchResult(cfg, restarts, status)
            if status.job_failed:
                emit(f"job Failed condition (failed pods: {status.failed})")
                failed = True
                break
            sleep(poll_interval)
        if not failed:
            emit(f"attempt timed out after {attempt_timeout}s "
                 f"(active={status.active}, succeeded={status.succeeded})"
                 " — treating the gang as broken")
        restarts += 1
        if checkpoint_dir is not None:
            step = latest_step_on_disk(checkpoint_dir)
            advanced = (step or 0) - (last_ckpt_step or 0)
            last_ckpt_step = step
            desc = (f"failed={status.failed} job_failed={status.job_failed}"
                    f" active={status.active}")
            if advanced < min_progress_steps:
                no_progress += 1
                loop_statuses.append(desc)
            else:
                no_progress = 0
                loop_statuses = []
            if no_progress >= crash_loop_after:
                msg = (f"crash_loop: {no_progress} consecutive attempts "
                       f"died with <{min_progress_steps} checkpointed "
                       f"step(s) of progress (latest step: {step}); "
                       f"attempts: {loop_statuses}")
                emit(msg)
                raise RuntimeError(msg)
        if restarts > max_restarts:
            raise RuntimeError(
                f"gang failed {restarts} attempts (last status: "
                f"active={status.active} succeeded={status.succeeded} "
                f"failed={status.failed} job_failed={status.job_failed})")
        # Delete under the OLD identity first — a resize policy may change
        # name/namespace, and the broken gang must not leak on-cluster.
        kubectl.delete_job(cfg)
        if resize is not None:
            new_cfg = resize(cfg, status)
            if new_cfg.num_workers != cfg.num_workers:
                emit(f"resizing {cfg.num_workers} -> {new_cfg.num_workers} "
                     "workers")
            cfg = new_cfg
        emit(f"restart {restarts}/{max_restarts}: re-applying")
        apply_current(cfg)
