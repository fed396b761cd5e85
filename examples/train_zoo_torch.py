"""Train any model-zoo member on the PyTorch port, the counterpart of
``examples/train_zoo.py``.

  python examples/train_zoo_torch.py --model resnet18 --num-steps 100
  python examples/train_zoo_torch.py --model bert --device cpu --num-steps 2
  python -m k8s_distributed_deeplearning_torch.launch run-local --workers 2 \\
      --script examples/train_zoo_torch.py -- --model vit --device cpu

One process per data-parallel replica: a multi-process world is formed
from the ``TPUJOB_*`` env contract (``parallel/distributed.py``), a single
process forms a world of one. ``--batch-size`` is PER REPLICA, as in the
JAX script. The transformer members (vit, vit-l, bert, bert-base) and moe
train through the port's data-parallel ``make_train_step``; the ResNets
through ``make_stats_train_step``, which averages the BatchNorm running
statistics across the replicas every step as JAX's ``make_resnet_step``
does (the reference's Horovod BN statistics stay rank-local). Rank 0
checkpoints into ``zoo-<model>`` under the default checkpoint directory,
and a run restores the newest good step there, BN statistics included.
The model runs on the card unless ``--device cpu`` is asked for.

JAX runs the transformer members on ``ShardedTrainer``; sharded meshes
(``--fsdp``, ``--tp``, ``--expert`` above 1, a ``--dp`` other than the world
size) are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from k8s_distributed_deeplearning_torch import config as cfg  # noqa: E402
from k8s_distributed_deeplearning_torch.models import (  # noqa: E402
    bert, convert, llama, moe, resnet, transformer, vit)
from k8s_distributed_deeplearning_torch.parallel import (  # noqa: E402
    data_parallel as dp, distributed)
from k8s_distributed_deeplearning_torch.train import (  # noqa: E402
    data as data_lib, loop, optim, prefetch)
from k8s_distributed_deeplearning_torch.train.checkpoint import (  # noqa: E402
    Checkpointer)
from k8s_distributed_deeplearning_torch.utils.device import (  # noqa: E402
    resolve_device)
from k8s_distributed_deeplearning_torch.utils.metrics import (  # noqa: E402
    H100_PEAK_FLOPS, MetricsLogger)

MODELS = ("resnet18", "resnet50", "vit", "vit-l", "bert", "bert-base", "moe")
# The synthetic image set the JAX script trains on.
NUM_IMAGES = 4096


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    cfg.add_train_flags(ap)
    ap.add_argument("--model", choices=MODELS, required=True)
    ap.add_argument("--dp", type=int, default=-1)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--expert", type=int, default=1)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--optimizer", choices=optim.OPTIMIZERS, default="adamw")
    ap.add_argument("--moment-dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="first-moment storage dtype (adam/adamw mu, "
                    "lion's moment, sgd's momentum trace)")
    ap.add_argument("--schedule", choices=optim.SCHEDULES, default="constant")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.set_defaults(grad_clip=1.0)       # transformer-training default
    return ap.parse_args(argv)


def _unported(args) -> None:
    for flag, value in (("--fsdp", args.fsdp), ("--tp", args.tp),
                        ("--expert", args.expert)):
        if value > 1:
            raise NotImplementedError(
                f"{flag} {value}: the zoo's sharded meshes (JAX's "
                "ShardedTrainer: FSDP, tensor and expert parallelism) are "
                "not ported to PyTorch yet (ROADMAP.md)")


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    conf = cfg.train_config_from_args(args)
    _unported(args)
    device = resolve_device(args.device)
    owns_group = not distributed.initialize_from_env(device.type)
    if owns_group:
        distributed.initialize_single(device.type)
    try:
        return _train(args, conf, device)
    finally:
        if owns_group:
            distributed.shutdown()


def _model(args, conf, device, per_host: int, rank: int, world: int):
    """The member's model, loss, batcher, step kind, MFU terms and flax
    layout: ``(model, loss(batch, gen), batcher, stats,
    flops_per_example, compute dtype, layout)``; ``stats`` is True for
    the ResNets, ``layout`` names each parameter's flax leaf for a
    per-leaf optimizer (adafactor)."""
    kw = dict(device=device, seed=conf.seed)
    shard = dict(seed=conf.seed, process_index=rank, num_processes=world)
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    if args.model.startswith("resnet"):
        big = args.model == "resnet50"
        size = args.image_size or (224 if big else 32)
        classes = 1000 if big else 10
        model = resnet.resnet50(**kw) if big else resnet.resnet18_cifar(**kw)
        x, y = data_lib.synthetic_images(NUM_IMAGES, size=size,
                                         num_classes=classes, seed=conf.seed)
        return (model, lambda b, g: resnet.loss_fn(model, b, g),
                data_lib.ShardedBatcher(x, y, per_host, **shard), True,
                resnet.flops_per_example(size), model.dtype,
                convert.resnet_layout())
    if args.model in ("vit", "vit-l"):
        big = args.model == "vit-l"
        mcfg = (vit.config_vit_l16(param_dtype=torch.float32) if big
                else vit.config_tiny(**f32))
        size = args.image_size or (224 if big else 32)
        patch, classes = (16, 1000) if big else (8, 10)
        model = vit.ViT(mcfg, patch_size=patch, num_classes=classes,
                        image_size=size, **kw)
        x, y = data_lib.synthetic_images(NUM_IMAGES, size=size,
                                         num_classes=classes, seed=conf.seed)
        return (model, lambda b, g: vit.loss_fn(model, b, g),
                data_lib.ShardedBatcher(x, y, per_host, **shard), False,
                vit.flops_per_image(model, image_size=size), mcfg.dtype,
                convert.flax_layout(mcfg, root="encoder"))
    if args.model in ("bert", "bert-base"):
        mcfg = (bert.config_bert_base(param_dtype=torch.float32)
                if args.model == "bert-base" else bert.config_tiny(**f32))
        model = bert.BertMLM(mcfg, **kw)
        mask_id = mcfg.vocab_size - 1

        def loss(b, gen):
            inputs, targets, weights = bert.mask_tokens(
                b["tokens"][:, :-1], gen, vocab_size=mcfg.vocab_size,
                mask_id=mask_id)
            return bert.loss_fn(model, {"inputs": inputs, "targets": targets,
                                        "weights": weights})
        seq = min(args.seq_len, mcfg.max_seq_len - 1)
        flops = transformer.flops_per_token(mcfg, seq_len=seq) * seq
        layout = convert.flax_layout(mcfg, root="encoder")
    else:  # moe
        mcfg = llama.config_tiny(**f32)
        moecfg = moe.MoEConfig(num_experts=max(args.expert, 2) * 2, top_k=2,
                               capacity_factor=2.0)
        model = moe.MoELM(mcfg, moecfg, **kw)

        def loss(b, gen):
            return moe.loss_fn(model, moecfg, b, gen)
        seq = min(args.seq_len, mcfg.max_seq_len - 1)
        flops = moe.flops_per_token(mcfg, moecfg, seq_len=seq) * seq
        layout = convert.flax_layout(mcfg)
    toks = data_lib.synthetic_tokens(vocab_size=mcfg.vocab_size,
                                     seed=conf.seed)
    return (model, loss, data_lib.TokenBatcher(toks, per_host, seq, **shard),
            False, flops, mcfg.dtype, layout)


def _train(args, conf, device) -> dict:
    rank, world = distributed.process_index(), distributed.process_count()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if args.dp not in (-1, world):
        raise NotImplementedError(
            f"--dp {args.dp} with {world} processes: the port runs one "
            "process per data-parallel replica; other meshes are not ported "
            "yet (ROADMAP.md)")
    # Each model family gets its own checkpoint namespace: a foreign
    # checkpoint in a shared default dir would fail restore-on-start.
    if conf.checkpoint_dir == cfg.TrainConfig().checkpoint_dir:
        conf = dataclasses.replace(
            conf, checkpoint_dir=os.path.join(conf.checkpoint_dir,
                                              f"zoo-{args.model}"))
    num_steps = conf.num_steps
    # batch_size is PER-REPLICA (the JAX script's contract); every process
    # is one replica. Validated before any resource is built.
    global_batch = conf.batch_size * world
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} (= batch_size {conf.batch_size} x "
            f"{world} data/fsdp shards) must divide evenly across "
            f"{world} processes — adjust --batch-size")
    per_host = global_batch // world
    if conf.eval_every or conf.keep_best:
        raise ValueError(
            "--eval-every/--keep-best are not wired into the zoo driver "
            "(its model families train on synthetic batches with no "
            "held-out split); use train_llama.py or train_mnist.py for "
            "eval-gated best-checkpoint retention")

    model, loss, batcher, stats, flops, dtype, layout = _model(
        args, conf, device, per_host, rank, world)
    optimizer = optim.make_optimizer(
        args.optimizer,
        optim.make_schedule(args.schedule, conf.lr, num_steps,
                            args.warmup_steps),
        grad_clip=args.grad_clip or None, moment_dtype=args.moment_dtype,
        layout=layout)
    params = dp.broadcast_params(dict(model.named_parameters()))
    if stats:
        buffers = dp.broadcast_params(dict(model.named_buffers()))
        state = dp.init_stats_state(params, buffers, optimizer)
        step_fn = dp.make_stats_train_step(loss, optimizer)
    else:
        state = dp.init_state(params, optimizer)
        step_fn = dp.make_train_step(loss, optimizer,
                                     microbatches=conf.grad_accum)

    metrics = MetricsLogger(enabled=distributed.is_primary(),
                            job=f"zoo-{args.model}")
    ckpt = Checkpointer(conf.checkpoint_dir,
                        max_to_keep=conf.max_checkpoints_to_keep,
                        async_save=conf.async_checkpoint)
    prefetchers: list = []

    def batches(start: int):
        return prefetch.maybe(batcher.iter_from(start),
                              lambda b: dp.to_device(b, device),
                              args.prefetch, prefetchers)

    dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
    metrics.emit("start", model=args.model, world_size=world,
                 num_steps=num_steps, optimizer=args.optimizer,
                 schedule=args.schedule, global_batch_size=global_batch,
                 mesh={"data": world}, device=str(device), dtype=dname,
                 params=sum(p.numel() for p in params.values()))
    try:
        state = loop.fit(step_fn, state, batches, num_steps, conf.seed,
                         metrics=metrics, checkpointer=ckpt,
                         checkpoint_every=conf.checkpoint_every,
                         log_every=conf.log_every,
                         global_batch_size=global_batch,
                         flops_per_example=flops,
                         peak_flops=(H100_PEAK_FLOPS[dname]
                                     if device.type == "cuda" else None))
        final = {"num_steps": state.step, "world_size": world,
                 "model": args.model}
    finally:
        prefetch.close_all(prefetchers)
        ckpt.close()
        metrics.close()
    return final


if __name__ == "__main__":
    main(sys.argv[1:])
