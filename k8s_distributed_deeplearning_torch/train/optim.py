"""Optimizer and learning-rate schedule factory.

Port of ``k8s_distributed_deeplearning_tpu/train/optim.py``, with optax's
arithmetic written out so a step matches optax's: global-norm clipping
(``clip_by_global_norm``: ``g / norm * max_norm`` when the norm reaches
``max_norm``), Adam with bias correction (b1 0.9, b2 0.999, eps 1e-8),
AdamW's decoupled decay added to the Adam direction before the learning
rate (on every leaf, norm scales included, as optax's unmasked ``adamw``),
and Nesterov SGD (``optax.trace``). The first moment may be stored in
bf16 (``moment_dtype``): as in optax, the decay multiplies the stored
moment in bf16 (the Python scalar taken in the moment's dtype, as JAX's
weak typing takes it), the new moment is formed and used in f32, and it is
stored rounded.

Parameters are updated in place, one leaf at a time, so the update's
temporaries never exceed one leaf (the JAX step returns new arrays).
``adafactor`` and ``lion`` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

SCHEDULES = ("constant", "cosine", "linear")
OPTIMIZERS = ("adam", "adamw", "sgd", "adafactor", "lion")

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init

    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return fn


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule``."""
    if decay_steps <= 0:
        return lambda count: init

    def fn(count: int) -> float:
        c = min(count, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return fn


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax ``join_schedules`` with one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_schedule(name: str, lr: float, total_steps: int,
                  warmup_steps: int = 0) -> Schedule | float:
    """LR schedule: linear warmup to *lr*, then constant / cosine (to
    0.1 lr) / linear (to 0) decay over the remaining budget. A callable of
    the optimizer's update count, or a float when constant."""
    if name not in SCHEDULES:
        raise ValueError(f"schedule {name!r} not in {SCHEDULES}")
    if name == "constant" and not warmup_steps:
        return lr
    decay = max(total_steps - warmup_steps, 1)
    if name == "cosine":
        decay_steps = max(total_steps, warmup_steps + 1)
        return _join(_linear(0.0, lr, warmup_steps),
                     _cosine(lr, decay_steps - warmup_steps, 0.1),
                     warmup_steps)
    if name == "linear":
        return _join(_linear(0.0, lr, max(warmup_steps, 1)),
                     _linear(lr, 0.0, decay), warmup_steps)
    return _join(_linear(0.0, lr, max(warmup_steps, 1)), lambda count: lr,
                 warmup_steps)


def _decayed(decay: float, t: torch.Tensor) -> torch.Tensor:
    """``decay * t`` with the scalar taken in t's dtype (JAX weak typing:
    0.9 becomes 0.8984375 against a bf16 moment)."""
    return t * torch.tensor(decay, dtype=t.dtype, device=t.device)


_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


class Optimizer:
    """One of adam / adamw / sgd with optional global-norm clipping.

    ``init(params)`` returns the state for a ``{name: tensor}`` dict;
    ``apply(params, grads, state)`` updates ``params`` in place from
    ``grads`` (same keys) and returns the new state."""

    def __init__(self, name: str, lr: Schedule | float, *,
                 weight_decay: float, grad_clip: float | None,
                 momentum: float, moment_dtype: str | None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.name = name
        self.lr = lr
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.momentum = momentum
        self.moment_dtype = _MOMENT_DTYPES[moment_dtype]
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype or p.dtype)

        if self.name == "sgd":
            return {"count": 0, "trace": {
                n: zeros(p, self.moment_dtype) for n, p in params.items()}}
        return {"count": 0,
                "mu": {n: zeros(p, self.moment_dtype)
                       for n, p in params.items()},
                "nu": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """optax ``global_norm``: sqrt of the sum of squares, in f32."""
        return torch.sqrt(sum((g.float() * g.float()).sum()
                              for g in grads.values()))

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: dict) -> dict:
        count = state["count"]
        step_size = -self.learning_rate(count)
        norm = self.global_norm(grads) if self.grad_clip else None
        new = {"count": count + 1}
        for key in ("mu", "nu", "trace"):
            if key in state:
                new[key] = {}
        for name, p in params.items():
            g = grads[name]
            if norm is not None:
                g = torch.where(norm < self.grad_clip, g,
                                g / norm.to(g.dtype) * self.grad_clip)
            if self.name == "sgd":
                trace = state["trace"][name]
                tr = g + _decayed(self.momentum, trace)
                u = g + self.momentum * tr
                new["trace"][name] = tr.to(trace.dtype)
            else:
                mu_s = state["mu"][name]
                mu = (1 - self.b1) * g + _decayed(self.b1, mu_s)
                nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][name]
                # In place where it changes no rounding: u = mu_hat /
                # (sqrt(nu_hat) + eps), one leaf's temporaries at a time.
                u = (mu / (1 - self.b1 ** (count + 1))).div_(
                    torch.sqrt(nu / (1 - self.b2 ** (count + 1))).add_(
                        self.eps))
                if self.name == "adamw":
                    u.add_(self.weight_decay * p)
                new["mu"][name] = mu.to(mu_s.dtype)
                new["nu"][name] = nu
            p.add_(u.mul_(step_size).to(p.dtype))
        return new


def make_optimizer(name: str, lr: Schedule | float, *,
                   weight_decay: float = 0.1,
                   grad_clip: float | None = 1.0, momentum: float = 0.9,
                   moment_dtype: str | None = None) -> Optimizer:
    """Optimizer with optional global-norm clipping; *lr* may be a float or
    a schedule. ``moment_dtype="bfloat16"`` stores the first moment (adam's
    mu, sgd's momentum trace) in bf16; adam's second moment stays f32."""
    if name in ("adafactor", "lion"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to PyTorch yet (ROADMAP.md, "
            "queue 1): use adam, adamw or sgd")
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r} not in {OPTIMIZERS}")
    if moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be float32 or bfloat16, got "
                         f"{moment_dtype!r}")
    return Optimizer(name, lr, weight_decay=weight_decay,
                     grad_clip=grad_clip or None, momentum=momentum,
                     moment_dtype=moment_dtype)
