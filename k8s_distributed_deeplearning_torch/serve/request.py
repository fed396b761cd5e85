"""Request/response types for the serving engine.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
request.py``, cut to what this engine serves: no tenants, migration or
trace ids yet. ``temperature <= 0`` selects greedy, ``top_k == 0`` and
``top_p == 1.0`` mean "off".
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

_req_counter = itertools.count()


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
    slot or admission order. ``deadline_s`` (from submit) cancels the
    request at the next decode boundary once exceeded; ``on_finish`` is
    called exactly once with the finish reason.
    """

    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    request_id: str = dataclasses.field(
        default_factory=lambda: f"req-{next(_req_counter)}")
    seed: int = 0
    on_token: Callable[[int], None] | None = None
    deadline_s: float | None = None
    on_finish: Callable[[str], None] | None = None
    # Stamped by ServeEngine.submit (perf_counter clock).
    _t_submit: float | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # Exactly-once latch for on_finish, re-armed on resubmit.
    _finished: bool = dataclasses.field(
        default=False, repr=False, compare=False)


@dataclasses.dataclass
class RequestOutput:
    """Terminal result for one request. ``finish_reason`` is "eos",
    "length", "aborted" or "timeout"; ``ttft_s`` is None for requests that
    ended before their first token; ``prefill_chunks`` counts prefill
    program runs (intermediate chunks + the final sampling chunk)."""

    request_id: str
    prompt_len: int
    tokens: list[int]
    finish_reason: str
    queue_s: float
    ttft_s: float | None
    latency_s: float
    cached_prompt_tokens: int = 0
    prefill_chunks: int = 0
