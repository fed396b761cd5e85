"""Bounded exponential-backoff retry for transient failures.

The port's own copy of ``k8s_distributed_deeplearning_tpu/utils/retry.py``,
unchanged: the same schedule for the same ``rng``.

In the port its consumers are the serving transport
(``serve/transport.py``'s remote-replica HTTP calls), the fleet scraper
(``telemetry/fleet.py``) and the token-shard reads
(``train/data.py`` ``TokenShardBatcher``). The shape is
deliberately strict:

- bounded — ``retries`` extra attempts, never a forever-loop against a
  genuinely broken target;
- selective — ``is_transient`` decides per exception; permanent errors
  (NotFound, bad config, corrupt file) surface on the FIRST attempt, since
  retrying them only delays the diagnosis;
- exponential — waits start at ``backoff_s`` and double, so a flapping
  dependency isn't hammered at a fixed period;
- optionally jittered — with ``jitter=True`` each wait is drawn uniformly
  from ``[0, ceiling)`` where the ceiling follows the doubling schedule
  (AWS "full jitter"). N replicas retrying against one recovering endpoint
  otherwise thunder in lockstep: every client sleeps the SAME doubling
  schedule, so the retry bursts arrive synchronized at exactly the moments
  the endpoint is trying to come back.

Stdlib only (imported from control-plane code).
"""
from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

T = TypeVar("T")


def retry_transient(fn: Callable[[], T], *, retries: int = 2,
                    backoff_s: float = 1.0,
                    sleep: Callable[[float], None] = time.sleep,
                    is_transient: Callable[[BaseException], bool]
                    = lambda e: isinstance(e, OSError),
                    on_retry: Callable[[int, BaseException, float], None]
                    | None = None,
                    jitter: bool = False,
                    rng: Callable[[], float] | None = None) -> T:
    """Call ``fn()`` with up to *retries* retried attempts.

    An exception for which ``is_transient`` is False — or one raised on the
    final attempt — propagates. ``on_retry(attempt_number, exc, delay)``
    observes each retry before its backoff sleep (loggers, test probes),
    where *delay* is the ACTUAL wait (post-jitter when enabled).
    *sleep* is injectable so tests assert the exact backoff schedule
    without waiting it out.

    ``jitter=True`` switches to full-jitter backoff: each wait is
    ``rng() * ceiling`` with the ceiling doubling from *backoff_s* (and
    ``rng()`` uniform in [0, 1)). *rng* is injectable so tests assert the
    jittered schedule deterministically; the default is the module-level
    ``random.random`` (per-process seeding — exactly the decorrelation
    wanted across replicas).
    """
    if jitter and rng is None:
        rng = random.random
    ceiling = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt == retries or not is_transient(e):
                raise
            delay = rng() * ceiling if jitter else ceiling
            if on_retry is not None:
                on_retry(attempt + 1, e, delay)
        sleep(delay)
        ceiling *= 2
    raise AssertionError("unreachable")
