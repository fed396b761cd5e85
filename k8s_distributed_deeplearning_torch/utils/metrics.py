"""Structured serving and training metrics.

Port of the parts of ``k8s_distributed_deeplearning_tpu/utils/metrics.py``
the serving engine, the training loop and the CLIs use:
:class:`ServingStats` (the methods the engine calls, and a ``summary()``
with the JAX package's serving fields), a JSON-lines :class:`MetricsLogger`
with its ``train_step`` event, and :func:`mfu`.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Any


class MetricsLogger:
    """Emit one JSON object per event to stdout and optionally a file."""

    def __init__(self, stream: IO[str] | None = None,
                 path: str | None = None, job: str = "serve",
                 enabled: bool = True):
        self.enabled = enabled             # False on non-primary processes
        self.stream = stream if stream is not None else sys.stdout
        self.job = job
        self._file = open(path, "a") if (path and enabled) else None
        self._t0 = time.monotonic()

    def emit(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        rec = {"event": event, "job": self.job,
               "elapsed_s": round(time.monotonic() - self._t0, 3), **fields}
        line = json.dumps(rec, default=repr)
        print(line, file=self.stream, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def train_step(self, step: int, loss: float, step_time_ms: float,
                   examples_per_sec: float, per_device: float,
                   mfu: float | None = None, **extra: Any) -> None:
        self.emit("train_step", step=step, loss=loss,
                  step_time_ms=step_time_ms,
                  examples_per_sec=examples_per_sec,
                  examples_per_sec_per_device=per_device,
                  **({"mfu": mfu} if mfu is not None else {}), **extra)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


def mfu(flops_per_example: float, examples_per_sec: float, num_devices: int,
        peak_flops_per_device: float) -> float:
    """Model FLOPs utilization: achieved model FLOP/s over peak FLOP/s."""
    if peak_flops_per_device <= 0 or num_devices <= 0:
        return 0.0
    return (flops_per_example * examples_per_sec
            / (peak_flops_per_device * num_devices))


# Published dense peaks of one H100 SXM (NVIDIA's data sheet), by compute
# dtype: bf16 on the tensor cores, f32 outside them.
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


class ServingStats:
    """Aggregates the engine's observations into tokens/sec, TTFT and
    latency percentiles, and mean slot occupancy. The clock runs from the
    first recorded event to the last. One emitted token per admission (the
    prefill-sampled first token) plus one per active slot per decode step.
    """

    def __init__(self):
        self.t_start: float | None = None
        self.t_last: float | None = None
        self.steps = 0
        self.decode_tokens = 0
        self.occupancy_sum = 0.0
        self.admitted = 0
        self.completed = 0
        self.prompt_tokens = 0
        self.queue_s: list[float] = []
        self.ttft_s: list[float] = []
        self.latency_s: list[float] = []
        self.finish_reasons: dict[str, int] = {}
        self.kv_pages_total = 0
        self.kv_pages_used = 0
        self.kv_pages_shared = 0
        # Quantized serving: the modes (None = fp) and the device bytes the
        # int8 pools and weights save against fp. Gauges, set once when
        # the engine is built.
        self.kv_quant: str | None = None
        self.weight_quant: str | None = None
        self.kv_quant_bytes_saved = 0
        self.weight_quant_bytes_saved = 0

    def _tick(self) -> None:
        now = time.perf_counter()
        if self.t_start is None:
            self.t_start = now
        self.t_last = now

    def record_admission(self, queue_s: float, prompt_len: int) -> None:
        self._tick()
        self.admitted += 1
        self.prompt_tokens += prompt_len
        self.queue_s.append(queue_s)

    def record_first_token(self, ttft_s: float) -> None:
        self._tick()
        self.ttft_s.append(ttft_s)

    def record_step(self, active_slots: int, num_slots: int) -> None:
        """One decode iteration."""
        self._tick()
        self.steps += 1
        self.decode_tokens += active_slots
        self.occupancy_sum += active_slots / max(num_slots, 1)

    def record_kv_pool(self, pages_total: int, pages_used: int,
                       pages_shared: int) -> None:
        """Latest pool snapshot; a gauge, so it does not tick the clock."""
        self.kv_pages_total = int(pages_total)
        self.kv_pages_used = int(pages_used)
        self.kv_pages_shared = int(pages_shared)

    def record_quant(self, kv_quant: str | None, weight_quant: str | None,
                     kv_bytes_saved: int, weight_bytes_saved: int) -> None:
        """The engine's quantization modes and bytes saved; set at
        construction, which is not serving activity: no tick."""
        self.kv_quant = kv_quant
        self.weight_quant = weight_quant
        self.kv_quant_bytes_saved = int(kv_bytes_saved)
        self.weight_quant_bytes_saved = int(weight_bytes_saved)

    def record_completion(self, latency_s: float, n_tokens: int,
                          reason: str) -> None:
        self._tick()
        self.completed += 1
        self.latency_s.append(latency_s)
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1

    @property
    def total_tokens(self) -> int:
        """Emitted tokens: one per admission + one per active slot-step."""
        return self.decode_tokens + len(self.ttft_s)

    @staticmethod
    def _pct(xs: list[float], q: float) -> float | None:
        if not xs:
            return None
        s = sorted(xs)
        return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]

    def summary(self) -> dict:
        elapsed = ((self.t_last - self.t_start)
                   if self.t_start is not None and self.t_last is not None
                   else 0.0)
        return {
            "elapsed_s": round(elapsed, 4),
            "requests_admitted": self.admitted,
            "requests_completed": self.completed,
            "finish_reasons": dict(self.finish_reasons),
            "total_tokens": self.total_tokens,
            "prompt_tokens": self.prompt_tokens,
            "tokens_per_sec": (round(self.total_tokens / elapsed, 1)
                               if elapsed > 0 else None),
            "decode_steps": self.steps,
            "mean_slot_occupancy": (round(self.occupancy_sum / self.steps, 4)
                                    if self.steps else None),
            "ttft_p50_ms": _ms(self._pct(self.ttft_s, 0.5)),
            "ttft_p95_ms": _ms(self._pct(self.ttft_s, 0.95)),
            "queue_p50_ms": _ms(self._pct(self.queue_s, 0.5)),
            "queue_p95_ms": _ms(self._pct(self.queue_s, 0.95)),
            "latency_p50_ms": _ms(self._pct(self.latency_s, 0.5)),
            "latency_p95_ms": _ms(self._pct(self.latency_s, 0.95)),
            "kv_pages_total": self.kv_pages_total,
            "kv_pages_used": self.kv_pages_used,
            "kv_pages_shared": self.kv_pages_shared,
            "kv_quant": self.kv_quant,
            "weight_quant": self.weight_quant,
            "kv_quant_bytes_saved": self.kv_quant_bytes_saved,
            "weight_quant_bytes_saved": self.weight_quant_bytes_saved,
        }


def _ms(s: float | None) -> float | None:
    return round(s * 1e3, 3) if s is not None else None
