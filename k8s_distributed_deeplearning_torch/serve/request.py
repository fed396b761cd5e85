"""Request/response types for the serving engine.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
request.py``. ``temperature <= 0`` selects greedy, ``top_k == 0`` and
``top_p == 1.0`` mean "off". A request carries its migration origin
(``migrated_from``) and a ``trace_id`` minted once per logical request,
and :meth:`Request.resume_from_tokens` is the gateway's and the disagg
coordinator's resubmission.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Sequence

_req_counter = itertools.count()
_trace_counter = itertools.count()
_PID_TAG = f"{os.getpid():x}"


class QueueFull(RuntimeError):
    """The engine's bounded admission queue rejected a submit."""


class EngineDraining(RuntimeError):
    """The engine is draining: it finishes what it holds and admits
    nothing new."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. Defaults are greedy decoding."""

    temperature: float = 0.0   # <= 0 => greedy argmax
    top_k: int = 0             # 0 => no top-k filter
    top_p: float = 1.0         # 1.0 => no nucleus filter

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature <= 0.0 and (self.top_k > 0 or self.top_p < 1.0):
            raise ValueError(
                "top_k/top_p require temperature > 0 (greedy ignores them — "
                "silently dropping the request would mislead)")


@dataclasses.dataclass
class Request:
    """One generation request.

    ``on_token`` streams each emitted token id in order, including the
    first (prefill-sampled) token. ``seed`` seeds the request's own random
    generator, so a sampled stream depends only on the request, not on its
    slot or admission order. ``tenant`` names the scheduler tenant the
    request bills against (:mod:`serve.sched`; the default tenant always
    exists). ``deadline_s`` (from submit) cancels the request at the next
    decode boundary once exceeded; ``on_finish`` is called exactly once
    with the finish reason.
    """

    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    request_id: str = dataclasses.field(
        default_factory=lambda: f"req-{next(_req_counter)}")
    seed: int = 0
    on_token: Callable[[int], None] | None = None
    tenant: str = "default"
    deadline_s: float | None = None
    on_finish: Callable[[str], None] | None = None
    # The replica this request was migrated away from (set on a
    # resume_from_tokens resubmission); None on a first dispatch.
    migrated_from: str | None = None
    # Minted once per logical request and kept across resubmissions
    # (dataclasses.replace copies it), so a migrated request's hops share
    # one id. Unique in the process by the counter, across processes by
    # the pid suffix.
    trace_id: str = dataclasses.field(
        default_factory=lambda: f"tr-{next(_trace_counter)}-{_PID_TAG}")
    # Stamped by ServeEngine.submit (perf_counter clock).
    _t_submit: float | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # Exactly-once latch for on_finish, re-armed on resubmit.
    _finished: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    # Set by TenantScheduler.requeue: the request was billed at its first
    # pop, so the next pop takes it from the queue head without charging
    # its tenant's token bucket or DRR deficit again.
    _requeued: bool = dataclasses.field(
        default=False, repr=False, compare=False)

    def resume_from_tokens(self, emitted: Sequence[int], *,
                           migrated_from: str | None = None) -> "Request":
        """The migration resubmission: a request that already streamed
        *emitted* continues elsewhere as ``prompt + emitted`` with the
        decode budget reduced by what was streamed (under greedy sampling
        the tokens of the uninterrupted run). Identity (``request_id``,
        ``trace_id``, ``seed``, tenant, deadline, submit time) is kept;
        the callbacks carry over and the ``on_finish`` latch re-arms at
        the next submit."""
        emitted = list(emitted)
        if len(emitted) >= self.max_new_tokens:
            raise ValueError(
                f"request {self.request_id} already emitted {len(emitted)} "
                f"of {self.max_new_tokens} tokens — nothing left to resume")
        return dataclasses.replace(
            self,
            prompt=list(self.prompt) + emitted,
            max_new_tokens=self.max_new_tokens - len(emitted),
            migrated_from=migrated_from,
            _finished=False, _requeued=False)


@dataclasses.dataclass
class RequestOutput:
    """Terminal result for one request. ``finish_reason`` is "eos",
    "length", "aborted" or "timeout" (or the reason given to
    ``ServeEngine.cancel``); ``ttft_s`` is None for requests that ended
    before their first token; ``cached_prompt_tokens`` counts prompt
    tokens served from the prefix cache; ``prefill_chunks`` counts prefill
    program runs (intermediate chunks + the final sampling chunk);
    ``spec_proposed``/``spec_accepted`` count draft tokens proposed and
    accepted-and-emitted under speculative decoding (0 otherwise)."""

    request_id: str
    prompt_len: int
    tokens: list[int]
    finish_reason: str
    queue_s: float
    ttft_s: float | None
    latency_s: float
    cached_prompt_tokens: int = 0
    prefill_chunks: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
