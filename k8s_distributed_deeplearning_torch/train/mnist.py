"""Distributed MNIST training, the reference's own job, on the port.

    python -m k8s_distributed_deeplearning_torch.train.mnist --num-steps 600
    python -m k8s_distributed_deeplearning_torch.train.mnist --device cpu \\
        --num-steps 60 --checkpoint-dir /tmp/ck --checkpoint-every 20

The PyTorch counterpart of ``examples/train_mnist.py`` (the TPU-native
``tensorflow_mnist.py``), with the reference's flags and config: batch
100 per replica, Adam at lr 1e-3 x world (or the Adasum rule), the step
budget divided by the world, dropout 0.5, the initial weights broadcast
from rank 0, rank-0 checkpoints with restore-on-start, and eval on rank 0.
SIGTERM (a K8s eviction) checkpoints at the step boundary and exits 0;
the same command run again restores there and finishes.

One process per data-parallel replica: a multi-process world is formed
from the ``TPUJOB_*`` env contract (``parallel/distributed.py``), a single
process forms a world of one. The job runs on the card unless ``--device
cpu`` is asked for. Without ``--data-dir`` it trains on the seeded
synthetic set at MNIST's own split sizes (60,000 train, 10,000 test).
"""
from __future__ import annotations

import argparse
import sys

import torch

from k8s_distributed_deeplearning_torch import config as cfg_lib
from k8s_distributed_deeplearning_torch.models import mnist
from k8s_distributed_deeplearning_torch.parallel import distributed
from k8s_distributed_deeplearning_torch.parallel import data_parallel as dp
from k8s_distributed_deeplearning_torch.train import data as data_lib
from k8s_distributed_deeplearning_torch.train import loop, optim, prefetch
from k8s_distributed_deeplearning_torch.train.checkpoint import Checkpointer
from k8s_distributed_deeplearning_torch.train.preemption import (
    PreemptionHandler)
from k8s_distributed_deeplearning_torch.utils.device import resolve_device
from k8s_distributed_deeplearning_torch.utils.metrics import (
    H100_PEAK_FLOPS, MetricsLogger)

MNIST_TRAIN_SIZE = 60_000
MNIST_TEST_SIZE = 10_000
EVAL_BATCH = 200


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    cfg_lib.add_train_flags(parser)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser.parse_args(argv)


def build(conf: cfg_lib.TrainConfig, device: torch.device, world: int,
          grad_clip: float | None = None):
    """The job's model (seeded, broadcast from rank 0), its Adam optimizer
    at the Horovod-scaled LR (bare Adam, as the reference's, unless
    ``grad_clip``), the initial state and the train step. Returns
    ``(model, lr, state, step_fn)``."""
    dtype = torch.bfloat16 if conf.dtype == "bfloat16" else torch.float32
    model = mnist.MNISTConvNet(dropout_rate=conf.dropout, dtype=dtype,
                               device=device, seed=conf.seed)
    params = dp.broadcast_params(dict(model.named_parameters()))
    # lr x world (or the Adasum rule): tensorflow_mnist.py:123-130. Local
    # replicas are this host's cards, joined by NVLink under NCCL.
    local = (min(world, torch.cuda.device_count())
             if device.type == "cuda" else 1)
    lr = conf.scaled_lr(world, local, fast_interconnect=device.type == "cuda")
    optimizer = optim.make_optimizer("adam", lr, grad_clip=grad_clip)
    step_fn = dp.make_train_step(
        lambda batch, gen: mnist.loss_fn(model, batch, gen), optimizer,
        reduction=(dp.Reduction.ADASUM if conf.use_adasum
                   else dp.Reduction.AVERAGE),
        microbatches=conf.grad_accum)
    return model, lr, dp.init_state(params, optimizer), step_fn


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    conf = cfg_lib.train_config_from_args(args)
    if conf.keep_best and not conf.eval_every:
        raise ValueError("--keep-best needs --eval-every to produce the "
                         "metric it ranks checkpoints by")
    device = resolve_device(args.device)
    owns_group = not distributed.initialize_from_env(device.type)
    if owns_group:
        distributed.initialize_single(device.type)
    try:
        return _train(args, conf, device)
    finally:
        if owns_group:
            distributed.shutdown()


def _evaluate(model, x, y, seed: int, device) -> dict:
    """Loss and accuracy over the first ``MNIST_TEST_SIZE`` held-out
    examples (the whole real test split) in batches of ``EVAL_BATCH``."""
    n = min(len(x), MNIST_TEST_SIZE)
    batches = data_lib.ShardedBatcher(x[:n], y[:n], EVAL_BATCH, seed=seed)
    ev = loop.evaluate(
        lambda m, b: mnist.eval_fn(m, dp.to_device(b, device)), model,
        iter(batches), num_batches=max(1, n // EVAL_BATCH))
    ev["eval_examples"] = (n // EVAL_BATCH) * EVAL_BATCH
    return ev


def _train(args, conf, device) -> dict:
    rank, world = distributed.process_index(), distributed.process_count()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    model, lr, state, step_fn = build(conf, device, world,
                                      grad_clip=args.grad_clip or None)
    num_steps = conf.steps_for_world(world)
    images, labels = data_lib.load_or_synthesize(
        conf.data_dir, "train", synth_size=MNIST_TRAIN_SIZE, seed=conf.seed)
    batcher = data_lib.ShardedBatcher(images, labels, conf.batch_size,
                                      seed=conf.seed, process_index=rank,
                                      num_processes=world)
    test = None
    if conf.eval_every or conf.eval_final:
        test = data_lib.load_or_synthesize(
            conf.data_dir, "test", synth_size=MNIST_TRAIN_SIZE,
            seed=conf.seed)

    metrics = MetricsLogger(job="mnist", enabled=distributed.is_primary())
    ckpt = Checkpointer(conf.checkpoint_dir,
                        max_to_keep=conf.max_checkpoints_to_keep,
                        keep_best_metric=("accuracy" if conf.keep_best
                                          else None),
                        best_mode="max", async_save=conf.async_checkpoint,
                        metrics=metrics)
    preemption = PreemptionHandler.install()
    prefetchers: list = []

    def batches(start_step: int):
        return prefetch.maybe(batcher.iter_from(start_step),
                              lambda b: dp.to_device(b, device),
                              args.prefetch, prefetchers)

    metrics.emit("start", world_size=world, num_steps=num_steps, lr=lr,
                 reduction="adasum" if conf.use_adasum else "average",
                 batch_size=conf.batch_size, dropout=conf.dropout,
                 train_examples=len(images), device=str(device),
                 device_kind=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                 dtype=conf.dtype)
    try:
        state = loop.fit(
            step_fn, state, batches, num_steps, conf.seed, metrics=metrics,
            checkpointer=ckpt, checkpoint_every=conf.checkpoint_every,
            log_every=conf.log_every,
            global_batch_size=conf.batch_size * world,
            flops_per_example=mnist.flops_per_example(),
            peak_flops=(H100_PEAK_FLOPS[conf.dtype]
                        if device.type == "cuda" else None),
            preemption=preemption, eval_every=conf.eval_every,
            eval_fn=(lambda s: _evaluate(model, *test, conf.seed, device))
            if conf.eval_every else None)
        result = {"num_steps": state.step, "world_size": world,
                  "preempted": preemption.triggered}
        # Rank 0 evaluates (tensorflow_mnist_gpu.py:184-188); a preempted
        # run does not: its grace period is for the save.
        if conf.eval_final and not preemption.triggered \
                and distributed.is_primary():
            ev = _evaluate(model, *test, conf.seed, device)
            metrics.emit("eval", **ev)
            result.update(ev)
    finally:
        preemption.uninstall()
        prefetch.close_all(prefetchers)
        ckpt.close()
        metrics.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
