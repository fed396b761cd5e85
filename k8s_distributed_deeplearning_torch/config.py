"""Typed training configuration and its CLI flags.

Own copy of the part of ``k8s_distributed_deeplearning_tpu/config.py``
that the training CLI uses: :class:`TrainConfig` (the reference's
defaults: lr 0.001, 20000 steps, batch size 100, Adasum off) and
:func:`add_train_flags`. The checkpoint flags are accepted so that a
command line written for the JAX script parses, and raise until the
checkpointer is ported.
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
    batch_size: int = 100            # global batch (LM scripts)
    use_adasum: bool = False
    seed: int = 0
    log_every: int = 10
    eval_final: bool = True
    dtype: str = "float32"           # compute dtype; "bfloat16" on the card
    eval_every: int = 0
    grad_accum: int = 1              # microbatches per optimizer step


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
                        help="global batch size")
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
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="not ported yet: raises when given")
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="not ported yet: raises when given")


def train_config_from_args(args: argparse.Namespace) -> TrainConfig:
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs: dict[str, Any] = {k: v for k, v in vars(args).items()
                              if k in known}
    return TrainConfig(**kwargs)
