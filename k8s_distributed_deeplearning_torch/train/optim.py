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

Adafactor is ``optax.adafactor(lr)`` as the JAX factory calls it: the
second-moment decay ``1 - (count + 1)^-0.8``, factored row and column
statistics (``v_row``, ``v_col``) for a tensor whose two largest dims are
both >= 128 and the full ``v`` otherwise (the unused ones a one-element
placeholder, as in optax's state), ``eps1`` 1e-30 added to the squared
gradient, each tensor's update clipped to RMS 1, scaled by the learning
rate and by the parameter's RMS (at least 1e-3), no momentum and no weight
decay. Its statistics are formed in f32 and stored in the parameter's
dtype. Those RMS and factoring rules act per optax leaf, so given a
``layout`` (``models/convert.py`` ``flax_layout``) the port forms each
JAX leaf from its tensors, in the flax kernel's layout and stacked over
the layers when the JAX model scans them (its default), and keys the
statistics by the leaf's path; without one each tensor is a leaf.
Lion is ``optax.lion(lr, weight_decay=...)`` (b1 0.9, b2 0.99): the update
``sign((1 - b1) g + b1 mu)`` plus the decoupled decay, the moment ``mu``
in ``moment_dtype`` when given.

Parameters are updated in place, one leaf at a time, so the update's
temporaries never exceed one leaf (the JAX step returns new arrays).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
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

# optax.adafactor's defaults.
_FACTOR_MIN_DIM = 128
_AF_DECAY_RATE = 0.8
_AF_EPS1 = 1e-30
_AF_CLIP = 1.0
_AF_EPS2 = 1e-3
# optax.lion's betas.
_LION_B1, _LION_B2 = 0.9, 0.99


def _factored_dims(shape: tuple) -> tuple[int, int] | None:
    """optax ``_factored_dims``: the axes of the two largest dims
    (second-largest first), or None when a tensor has fewer than two dims
    or its second-largest is under 128. ``np.argsort`` breaks ties as
    optax's does."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t.float() * t.float()))


class Optimizer:
    """One of adam / adamw / sgd / adafactor / lion with optional
    global-norm clipping.

    ``init(params)`` returns the state for a ``{name: tensor}`` dict;
    ``apply(params, grads, state)`` updates ``params`` in place from
    ``grads`` (same keys) and returns the new state."""

    def __init__(self, name: str, lr: Schedule | float, *,
                 weight_decay: float, grad_clip: float | None,
                 momentum: float, moment_dtype: str | None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 layout: Callable[[str], tuple] | None = None):
        self.name = name
        self.layout = layout
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
        if self.name == "lion":
            return {"count": 0, "mu": {n: zeros(p, self.moment_dtype)
                                       for n, p in params.items()}}
        if self.name == "adafactor":
            state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
            for leaf, (stacked, members) in self._leaves(params).items():
                p = params[members[0][0]]
                shape = members[0][1](p).shape
                shape = (len(members), *shape) if stacked else tuple(shape)
                dims = _factored_dims(shape)
                one = p.new_zeros((1,))
                if dims is None:
                    row, col, full = one, one.clone(), p.new_zeros(shape)
                else:
                    d1, d0 = dims
                    row = p.new_zeros([s for i, s in enumerate(shape)
                                       if i != d0])
                    col = p.new_zeros([s for i, s in enumerate(shape)
                                       if i != d1])
                    full = one
                state["v_row"][leaf], state["v_col"][leaf] = row, col
                state["v"][leaf] = full
            return state
        return {"count": 0,
                "mu": {n: zeros(p, self.moment_dtype)
                       for n, p in params.items()},
                "nu": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """optax ``global_norm``: sqrt of the sum of squares, in f32."""
        return torch.sqrt(sum((g.float() * g.float()).sum()
                              for g in grads.values()))

    def _leaves(self, params: dict) -> dict[str, tuple[bool, list]]:
        """Adafactor's blocks: ``{leaf: (stacked, [(name, to_flax,
        from_flax), ...])}`` from ``layout``; without one, every tensor is
        a block of its own, as it stands."""
        leaves: dict[str, tuple[bool, list]] = {}
        for name in params:
            leaf, stacked, to, frm = (
                self.layout(name) if self.layout is not None
                else (name, False, _identity, _identity))
            leaves.setdefault(leaf, (stacked, []))[1].append((name, to, frm))
        return leaves

    def _clipped(self, g: torch.Tensor, norm) -> torch.Tensor:
        if norm is None:
            return g
        return torch.where(norm < self.grad_clip, g,
                           g / norm.to(g.dtype) * self.grad_clip)

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: dict) -> dict:
        count = state["count"]
        step_size = -self.learning_rate(count)
        norm = self.global_norm(grads) if self.grad_clip else None
        new = {"count": count + 1}
        for key in ("mu", "nu", "trace", "v_row", "v_col", "v"):
            if key in state:
                new[key] = {}
        if self.name == "adafactor":
            self._apply_adafactor(params, grads, state, new, norm,
                                  -step_size)
            return new
        for name, p in params.items():
            g = self._clipped(grads[name], norm)
            if self.name == "lion":
                mu_s = state["mu"][name]
                u = torch.sign((1 - _LION_B1) * g + _decayed(_LION_B1, mu_s))
                mu = (1 - _LION_B2) * g + _decayed(_LION_B2, mu_s)
                new["mu"][name] = mu.to(mu_s.dtype)
                u.add_(self.weight_decay * p)
            elif self.name == "sgd":
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

    def _apply_adafactor(self, params, grads, state, new, norm,
                         lr: float) -> None:
        """optax ``adafactor`` one block at a time: a block (a flax leaf,
        the layers' tensors stacked when scanned) is formed in f32 in the
        flax layout, updated, and taken back to each parameter."""
        # optax takes the decay rate in f32.
        decay = float(np.float32(1.0) - np.float32(state["count"] + 1)
                      ** np.float32(-_AF_DECAY_RATE))
        for leaf, (stacked, members) in self._leaves(params).items():
            def block(tensors):
                parts = [to(t.float()) for (_, to, _), t in
                         zip(members, tensors)]
                return torch.stack(parts) if stacked else parts[0]

            g = block([self._clipped(grads[n], norm) for n, _, _ in members])
            p = block([params[n] for n, _, _ in members])
            u = self._adafactor(leaf, g, state, new, decay)
            # scale_by_learning_rate, scale_by_param_block_rms, scale(-1).
            rms = _rms(p)
            u.mul_(lr).mul_(torch.where(rms <= _AF_EPS2, _AF_EPS2,
                                        rms)).neg_()
            for i, (n, _, frm) in enumerate(members):
                params[n].add_(frm(u[i] if stacked else u).to(
                    params[n].dtype))

    @staticmethod
    def _adafactor(leaf: str, g: torch.Tensor, state: dict, new: dict,
                   decay: float) -> torch.Tensor:
        """optax ``scale_by_factored_rms`` then ``clip_by_block_rms(1)``
        for one block ``g`` (f32); the new statistics go into ``new``.
        Returns the update in f32."""
        grad_sqr = g * g + _AF_EPS1
        row, col, full = (state[k][leaf] for k in ("v_row", "v_col", "v"))
        dims = _factored_dims(tuple(g.shape))
        if dims is None:
            v = (decay * full.float() + (1.0 - decay) * grad_sqr).to(
                full.dtype)
            new["v_row"][leaf], new["v_col"][leaf] = row, col
            new["v"][leaf] = v
            u = g * v.float() ** -0.5
        else:
            d1, d0 = dims
            v_row = (decay * row.float() + (1.0 - decay)
                     * grad_sqr.mean(dim=d0)).to(row.dtype)
            v_col = (decay * col.float() + (1.0 - decay)
                     * grad_sqr.mean(dim=d1)).to(col.dtype)
            new["v_row"][leaf], new["v_col"][leaf] = v_row, v_col
            new["v"][leaf] = full
            r = v_row.float()
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (r / r.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            col_factor = v_col.float() ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return u.div_(torch.clamp(_rms(u) / _AF_CLIP, min=1.0))


def make_optimizer(name: str, lr: Schedule | float, *,
                   weight_decay: float = 0.1,
                   grad_clip: float | None = 1.0, momentum: float = 0.9,
                   moment_dtype: str | None = None,
                   layout: Callable[[str], tuple] | None = None
                   ) -> Optimizer:
    """Optimizer with optional global-norm clipping; *lr* may be a float or
    a schedule. ``moment_dtype="bfloat16"`` stores the first moment (adam's
    mu, lion's moment, sgd's momentum trace) in bf16; adam's second moment
    stays f32, and adafactor ignores it. Adafactor takes no weight decay
    (as the JAX factory: optax applies its decay after the learning rate,
    and an adamw-style 0.1 would collapse the parameters). *layout*
    (``models/convert.py`` ``flax_layout``) names the flax leaf behind each
    parameter, so adafactor's per-block arithmetic runs on the JAX model's
    blocks; the elementwise optimizers ignore it."""
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r} not in {OPTIMIZERS}")
    if moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be float32 or bfloat16, got "
                         f"{moment_dtype!r}")
    return Optimizer(name, lr, weight_decay=weight_decay,
                     grad_clip=grad_clip or None, momentum=momentum,
                     moment_dtype=moment_dtype, layout=layout)
