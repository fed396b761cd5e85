"""Typed training configuration and its CLI flags.

Own copy of the part of ``k8s_distributed_deeplearning_tpu/config.py``
that the training CLIs use: :class:`TrainConfig` (the reference's
defaults: lr 0.001, 20000 steps, batch size 100, Adasum off, dropout 0.5,
rank-0 checkpoints in ``./checkpoints`` every 1000 steps) with the
Horovod LR and step rules, and :func:`add_train_flags`.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass
class TrainConfig:
    """Training hyper-parameters (reference defaults preserved)."""

    lr: float = 0.001
    num_steps: int = 20000
    batch_size: int = 100            # global (LM CLI) / per replica (MNIST)
    use_adasum: bool = False
    seed: int = 0
    log_every: int = 10
    eval_final: bool = True
    dropout: float = 0.5
    dtype: str = "float32"           # compute dtype; "bfloat16" on the card

    # Checkpointing (reference: rank-0-only ./checkpoints, :157-159)
    checkpoint_dir: str = "./checkpoints"
    checkpoint_every: int = 1000
    max_checkpoints_to_keep: int = 3
    # Mid-training eval and best-checkpoint retention (Keras variant:
    # ModelCheckpoint(save_best_only=True)); eval_every=0 disables.
    eval_every: int = 0
    keep_best: bool = False
    # The host snapshot stays synchronous; the write overlaps training.
    async_checkpoint: bool = False

    data_dir: str | None = None      # MNIST idx files; None -> synthetic
    grad_accum: int = 1              # microbatches per optimizer step

    def scaled_lr(self, world_size: int, local_size: int = 1,
                  fast_interconnect: bool = False) -> float:
        """Horovod LR scaling rule (``tensorflow_mnist.py:123-130``).

        Average reduction: lr x world_size. Adasum: lr x local_size when a
        fast device interconnect handles the intra-node reduction (the
        ``hvd.nccl_built()`` probe, ``:126-127``), else lr x 1.
        """
        if self.use_adasum:
            return self.lr * (local_size if fast_interconnect else 1)
        return self.lr * world_size

    def steps_for_world(self, world_size: int) -> int:
        """Total optimizer steps for this world size
        (``tensorflow_mnist.py:146``)."""
        return self.num_steps // world_size


def add_train_flags(parser: argparse.ArgumentParser) -> None:
    """Attach the reference's CLI surface (plus framework extras)."""
    d = TrainConfig()
    parser.add_argument("--use-adasum", action="store_true",
                        default=d.use_adasum,
                        help="use Adasum gradient reduction instead of "
                        "averaging")
    parser.add_argument("--lr", type=float, default=d.lr,
                        help="base learning rate")
    parser.add_argument("--num-steps", type=int, default=d.num_steps,
                        help="optimizer-step budget")
    parser.add_argument("--batch-size", type=int, default=d.batch_size,
                        help="batch size: global for the LM CLI, per "
                        "replica for MNIST (the reference's)")
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--log-every", type=int, default=d.log_every)
    parser.add_argument("--dtype", type=str, default=d.dtype,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--no-eval", dest="eval_final", action="store_false",
                        default=d.eval_final)
    parser.add_argument("--eval-every", type=int, default=d.eval_every,
                        help="mid-training eval cadence in steps (0 = off)")
    parser.add_argument("--grad-clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 disables)")
    parser.add_argument("--grad-accum", type=int, default=d.grad_accum,
                        help="microbatches accumulated per optimizer step")
    parser.add_argument("--checkpoint-dir", type=str,
                        default=d.checkpoint_dir,
                        help="rank 0 writes here; a run restores from the "
                        "newest good step it finds")
    parser.add_argument("--checkpoint-every", type=int,
                        default=d.checkpoint_every)
    parser.add_argument("--async-checkpoint", dest="async_checkpoint",
                        action="store_true", default=d.async_checkpoint,
                        help="overlap checkpoint writes with training (the "
                        "host snapshot itself stays synchronous)")
    parser.add_argument("--keep-best", action="store_true",
                        default=d.keep_best,
                        help="retain the best checkpoints by eval metric "
                        "instead of the newest (save_best_only parity); "
                        "requires --eval-every")
    parser.add_argument("--data-dir", type=str, default=d.data_dir,
                        help="MNIST idx files (default: synthetic images)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches staged ahead by a host thread "
                        "(0 = off)")


def train_config_from_args(args: argparse.Namespace) -> TrainConfig:
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs: dict[str, Any] = {k: v for k, v in vars(args).items()
                              if k in known}
    return TrainConfig(**kwargs)
