"""The data-parallel engine, the ``hvd.DistributedOptimizer`` replacement.

Port of ``k8s_distributed_deeplearning_tpu/parallel/data_parallel.py``
onto ``torch.distributed``, one process per replica. Reference semantics
(``horovod/tensorflow_mnist.py``): gradients computed per replica on its
shard of the global batch, then allreduced with Average or Adasum (or
SUM) before the optimizer applies them; identical initial state on every
replica through a root broadcast.

Where the JAX step is one jitted ``shard_map`` program that returns new
arrays, here the step runs eagerly on the model's own parameters: the
gradients are reduced in place and the optimizer updates the parameters in
place, so no second copy of the model or its gradients is held.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.ops import collectives

# loss_fn(batch, generator) -> (loss, aux): the replica's loss on its batch
# shard, computed by the model whose parameters the TrainState holds.
LossFn = Callable[[dict, torch.Generator], tuple[torch.Tensor, dict]]


class Reduction(enum.Enum):
    """Gradient reduction op: ``hvd.Average`` / ``hvd.Adasum`` plus SUM."""

    AVERAGE = "average"
    ADASUM = "adasum"
    SUM = "sum"


def reduce_gradients(grads: dict, group=None,
                     reduction: Reduction = Reduction.AVERAGE,
                     bucket_bytes: int | str | None = None) -> dict:
    """Allreduce a ``{name: grad}`` dict across the group, in place.
    ``bucket_bytes`` (AVERAGE only): reduce the gradients as fused flat
    buckets of at most that many bytes (Horovod's tensor fusion,
    ``collectives.bucketed_pmean``), or ``"auto"`` to let the fusion
    planner's alpha-beta model pick the threshold from the gradients'
    sizes and a probe of this group's allreduce."""
    _check_bucketing(bucket_bytes, reduction)
    if reduction is Reduction.AVERAGE:
        if bucket_bytes:
            return collectives.bucketed_pmean(
                grads, group, plan_buckets(grads, group, bucket_bytes))
        return collectives.tree_pmean(grads, group)
    if reduction is Reduction.SUM:
        return collectives.tree_psum(grads, group)
    if reduction is Reduction.ADASUM:
        return collectives.adasum_reduce(grads, group)
    raise ValueError(f"unknown reduction {reduction}")


def _check_bucketing(bucket_bytes, reduction: Reduction) -> None:
    if bucket_bytes and reduction is not Reduction.AVERAGE:
        raise ValueError(
            f"bucket_bytes is only supported with Reduction.AVERAGE, "
            f"got {reduction}")


def plan_buckets(grads: dict, group, bucket_bytes: int | str) -> list[int]:
    """Bucket id of each gradient, in ``collectives.bucket_order``, for a
    threshold in bytes or ``"auto"``."""
    from k8s_distributed_deeplearning_torch.runtime import fusion

    sizes = [grads[k].numel() * grads[k].element_size()
             for k in collectives.bucket_order(grads)]
    if bucket_bytes == "auto":
        alpha, beta = fusion.probe_allreduce(group)
        bucket_bytes = fusion.FusionPlanner(
            world=dist.get_world_size(group), alpha_s=alpha,
            beta_s_per_byte=beta).autotune(sizes)
    return fusion.plan_buckets(sizes, int(bucket_bytes)).tolist()


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and ``data`` (the analog of
    ``jax.random.fold_in``: per-step and per-replica streams)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(
        1, np.uint64)[0] >> 1)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device``, so a dropout mask is drawn where its
    tensor lives."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def accumulate_gradients(loss_fn: LossFn, params: dict, batch: dict,
                         seed: int, microbatches: int):
    """Value and gradient of ``loss_fn`` on ``batch``, split into
    ``microbatches`` equal parts along the leading axis, run one after the
    other, gradients summed and then scaled by ``1/microbatches`` (as the
    JAX scan averages them). Returns ``((loss, aux), grads)`` with loss and
    aux averaged over the microbatches and grads a ``{name: tensor}``
    dict (the parameters' ``.grad``)."""
    for p in params.values():
        p.grad = None
    if microbatches <= 1:
        parts = [batch]
    else:
        for k, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(
                    f"batch axis {x.shape[0]} not divisible by "
                    f"microbatches={microbatches}")
        parts = [{k: x.chunk(microbatches)[i] for k, x in batch.items()}
                 for i in range(microbatches)]
    loss_sum, aux_sum = None, None
    device = next(iter(params.values())).device
    for i, part in enumerate(parts):
        loss, aux = loss_fn(part, _generator(fold_in(seed, i), device))
        loss.backward()
        loss = loss.detach()
        aux = {k: v.detach() for k, v in (aux or {}).items()}
        loss_sum = loss if loss_sum is None else loss_sum + loss
        aux_sum = aux if aux_sum is None else {
            k: aux_sum[k] + aux[k] for k in aux}
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    if microbatches > 1:
        inv = 1.0 / microbatches
        for g in grads.values():
            g.mul_(inv)
        loss_sum = loss_sum * inv
        aux_sum = {k: v * inv for k, v in aux_sum.items()}
    return (loss_sum, aux_sum), grads


class TrainState(NamedTuple):
    """Params (the model's own parameters, by name), optimizer state and
    step counter."""

    params: dict
    opt_state: Any
    step: int


def init_state(params: dict, optimizer) -> TrainState:
    """The initial state over ``params`` (``dict(model.named_parameters())``;
    the step updates these tensors in place)."""
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _pmean_scalars(loss: torch.Tensor, aux: dict, group) -> tuple:
    keys = sorted(aux)
    flat = torch.stack([loss.float()] + [aux[k].float() for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return flat[0], {k: flat[i + 1] for i, k in enumerate(keys)}


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(loss_fn: LossFn, optimizer, group=None,
                    reduction: Reduction = Reduction.AVERAGE,
                    bucket_bytes: int | str | None = None,
                    microbatches: int = 1):
    """The synchronous data-parallel step, ``step(state, batch, seed) ->
    (state, loss, aux)``. ``batch`` is this replica's shard of the global
    batch (numpy or tensors); ``seed`` an int, folded with the replica's
    rank for its generator (JAX ``fold_in(rng, axis_index)``). Loss and
    aux come back averaged across replicas (``MetricAverageCallback``
    parity). Runs in a process group, a world of one included, so the
    gradient allreduce is a real collective. With ``bucket_bytes`` the
    bucket plan is made once, at the first step: the gradients' sizes do
    not change."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_train_step needs a torch.distributed process group: call "
            "parallel.distributed.initialize_from_env() or "
            "initialize_single() first")
    _check_bucketing(bucket_bytes, reduction)
    plan: list[int] = []        # bucket ids, planned at the first step

    def step(state: TrainState, batch: dict, seed: int):
        device = next(iter(state.params.values())).device
        batch = to_device(batch, device)
        rank_seed = fold_in(seed, dist.get_rank(group))
        (loss, aux), grads = accumulate_gradients(
            loss_fn, state.params, batch, rank_seed, microbatches)
        if bucket_bytes:
            if not plan:
                plan.extend(plan_buckets(grads, group, bucket_bytes))
            grads = collectives.bucketed_pmean(grads, group, plan)
        else:
            grads = reduce_gradients(grads, group, reduction)
        loss, aux = _pmean_scalars(loss, aux, group)
        opt_state = optimizer.apply(state.params, grads, state.opt_state)
        for p in state.params.values():
            p.grad = None
        return TrainState(state.params, opt_state, state.step + 1), loss, aux

    return step


class StatsTrainState(NamedTuple):
    """A :class:`TrainState` that also carries a model's running
    statistics (BatchNorm's ``mean`` and ``var`` buffers, by buffer name):
    JAX ``examples/train_zoo.py`` ``ResNetState``. The step writes the
    buffers in place, so a checkpoint restore (``copy_``) reaches them."""

    params: dict
    batch_stats: dict
    opt_state: Any
    step: int


def init_stats_state(params: dict, batch_stats: dict,
                     optimizer) -> StatsTrainState:
    """The initial state over ``params`` and the model's running-statistic
    buffers ``batch_stats`` (both updated in place by the step)."""
    return StatsTrainState(params=params, batch_stats=batch_stats,
                           opt_state=optimizer.init(params), step=0)


def make_stats_train_step(loss_fn: LossFn, optimizer, group=None):
    """The data-parallel step of a model with running statistics, ``step(
    state, batch, seed) -> (state, loss, aux)`` over a
    :class:`StatsTrainState` (JAX ``make_resnet_step``). ``loss_fn``
    returns ``aux["batch_stats"]``, the new running statistics by buffer
    name ({} for a model without them); the step averages the gradients,
    those statistics, the loss and the scalar aux across replicas (pmean,
    as JAX's step does every step, so every replica keeps the same
    statistics), applies the optimizer, and writes the statistics into
    ``state.batch_stats``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_stats_train_step needs a torch.distributed process group: "
            "call parallel.distributed.initialize_from_env() or "
            "initialize_single() first")

    def step(state: StatsTrainState, batch: dict, seed: int):
        params = state.params
        device = next(iter(params.values())).device
        batch = to_device(batch, device)
        for p in params.values():
            p.grad = None
        gen = _generator(fold_in(seed, dist.get_rank(group)), device)
        loss, aux = loss_fn(batch, gen)
        loss.backward()
        stats = {k: v.detach() for k, v in aux.pop("batch_stats").items()}
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        collectives.tree_pmean(grads, group)
        collectives.tree_pmean(stats, group)
        loss, aux = _pmean_scalars(loss.detach(),
                                   {k: v.detach() for k, v in aux.items()},
                                   group)
        opt_state = optimizer.apply(params, grads, state.opt_state)
        for p in params.values():
            p.grad = None
        with torch.no_grad():
            for name, value in stats.items():
                state.batch_stats[name].copy_(value)
        return state._replace(opt_state=opt_state,
                              step=state.step + 1), loss, aux

    return step


@torch.no_grad()
def broadcast_params(params: dict, group=None, root: int = 0) -> dict:
    """One-time root broadcast of the initial parameters, in place (parity
    with ``BroadcastGlobalVariablesHook(0)``); returns ``params``."""
    return collectives.broadcast_from(params, group, root)
