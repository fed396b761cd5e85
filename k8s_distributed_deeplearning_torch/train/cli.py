"""Distributed Llama-family LM pretraining, the PyTorch counterpart of
``examples/train_llama.py``.

    python -m k8s_distributed_deeplearning_torch.train --preset tiny \\
        --device cpu --num-steps 20
    python -m k8s_distributed_deeplearning_torch.train --preset small \\
        --moe-experts 8 --moe-dispatch ragged

One process per data-parallel replica: a multi-process world is formed
from the ``TPUJOB_*`` env contract (``parallel/distributed.py``), a
single process forms a world of one, and the step always allreduces its
gradients through ``torch.distributed`` (NCCL on the card, gloo on the
CPU). The model runs on the card unless ``--device cpu`` is asked for;
there the kernels' plain versions run. ``--moe-experts N`` swaps every MLP
for a mixture-of-experts layer (``models/moe.py`` ``MoELM``, the loss
``moe.loss_fn``, MFU from ``moe.flops_per_token``); ``--moe-dispatch
ragged`` runs the experts as grouped matmuls on the CUDA kernels. Sharded,
expert-parallel and pipelined training (``--fsdp``, ``--tp``, ``--sp``,
``--ep``, ``--pp``), checkpoints and the profiler are not ported yet and
raise.
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

from k8s_distributed_deeplearning_torch import config as cfg_lib
from k8s_distributed_deeplearning_torch.models import llama
from k8s_distributed_deeplearning_torch.models import moe as moe_lib
from k8s_distributed_deeplearning_torch.parallel import distributed
from k8s_distributed_deeplearning_torch.parallel import data_parallel as dp
from k8s_distributed_deeplearning_torch.train import data as data_lib
from k8s_distributed_deeplearning_torch.train import loop, optim
from k8s_distributed_deeplearning_torch.utils.device import resolve_device
from k8s_distributed_deeplearning_torch.utils.metrics import (
    H100_PEAK_FLOPS, MetricsLogger)

PRESETS = {
    # name: overrides on llama.config_tiny / config_llama3_8b
    "tiny": dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 mlp_dim=128, max_seq_len=512),
    "small": dict(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                  n_kv_heads=4, mlp_dim=2048, max_seq_len=2048, remat=True),
    "1b": dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=32,
               n_kv_heads=8, mlp_dim=8192, max_seq_len=4096, remat=True),
    "8b": dict(),          # the true Llama-3 8B architecture numbers
}


def build_config(args) -> llama.TransformerConfig:
    """The preset with the CLI's overrides. Parameters are kept in f32 and
    cast to ``--dtype`` at each use, as the JAX model keeps them."""
    overrides = dict(PRESETS[args.preset])
    base = llama.config_llama3_8b if args.preset == "8b" else llama.config_tiny
    if args.seq_len:
        overrides["max_seq_len"] = max(args.seq_len,
                                       overrides.get("max_seq_len", 0))
    overrides["dtype"] = (torch.bfloat16 if args.dtype == "bfloat16"
                          else torch.float32)
    overrides["param_dtype"] = torch.float32
    overrides["remat"] = args.remat or overrides.get("remat", False)
    if args.attention in ("flash", "xla"):
        overrides["attention_impl"] = args.attention
    return base(**overrides)


def _unported(args) -> None:
    for flag, value in (("--fsdp", args.fsdp), ("--tp", args.tp),
                        ("--sp", args.sp), ("--pp", args.pp),
                        ("--ep", args.ep)):
        if value > 1:
            raise NotImplementedError(
                f"{flag} {value}: sharded, context-parallel, "
                "expert-parallel and pipelined training are not ported to "
                "PyTorch yet (ROADMAP.md)")
    if args.checkpoint_dir is not None or args.checkpoint_every is not None:
        raise NotImplementedError("checkpoints are not ported to PyTorch "
                                  "yet (ROADMAP.md)")
    if args.profile_dir is not None:
        raise NotImplementedError("--profile-dir: the step profiler is not "
                                  "ported to PyTorch yet (ROADMAP.md)")


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    cfg_lib.add_train_flags(parser)
    parser.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    parser.add_argument("--seq-len", type=int, default=None,
                        help="training sequence length (default: preset's, "
                        "at most 512)")
    parser.add_argument("--dp", type=int, default=-1,
                        help="data-parallel replicas (-1: the world size)")
    parser.add_argument("--fsdp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--pp", type=int, default=1)
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="swap every MLP for a mixture-of-experts layer "
                        "with N experts (models/moe.py MoELM; 0 = dense)")
    parser.add_argument("--moe-top-k", type=int, default=2)
    parser.add_argument("--moe-capacity-factor", type=float, default=1.25)
    parser.add_argument("--moe-dispatch", default="index",
                        choices=["index", "einsum", "ragged"],
                        help="expert dispatch: capacity index scatter "
                        "(default), dense one-hot einsums, or the dropless "
                        "grouped-GEMM path (the CUDA gmm/tgmm kernels on the "
                        "card; no capacity, no overflow drops)")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert parallelism: not ported yet, raises "
                        "above 1")
    parser.add_argument("--attention", choices=["auto", "xla", "flash"],
                        default="auto",
                        help="auto = the flash kernels on the card at "
                        "S >= 1024, the einsum path otherwise")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each block")
    parser.add_argument("--data-path", type=str, default=None,
                        help="byte-level corpus file; default synthetic "
                        "tokens")
    parser.add_argument("--pack", action="store_true",
                        help="pack documents into rows with segment ids")
    parser.add_argument("--pack-sep-id", type=int, default=None)
    parser.add_argument("--chunked-ce", dest="chunked_ce",
                        action="store_true", default=None,
                        help="chunked LM-head loss (never holds [B,S,V] "
                        "logits); default: on for --preset 8b")
    parser.add_argument("--no-chunked-ce", dest="chunked_ce",
                        action="store_false")
    parser.add_argument("--optimizer", choices=optim.OPTIMIZERS,
                        default="adamw")
    parser.add_argument("--moment-dtype", choices=["float32", "bfloat16"],
                        default=None)
    parser.add_argument("--schedule", choices=optim.SCHEDULES,
                        default="constant")
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="not ported yet: raises when given")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.set_defaults(grad_clip=1.0)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    conf = cfg_lib.train_config_from_args(args)
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


def _train(args, conf, device) -> dict:
    rank, world = distributed.process_index(), distributed.process_count()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if args.dp > 0 and args.dp != world:
        raise ValueError(f"--dp {args.dp} != {world} processes: the port "
                         "runs one process per data-parallel replica")
    if conf.batch_size % world:
        raise ValueError(f"--batch-size {conf.batch_size} (global) must "
                         f"divide evenly across {world} processes")
    per_host = conf.batch_size // world
    model_cfg = build_config(args)
    seq_len = args.seq_len or min(model_cfg.max_seq_len, 512)
    moe_cfg = None
    if args.moe_experts:
        moe_cfg = moe_lib.MoEConfig(
            num_experts=args.moe_experts, top_k=args.moe_top_k,
            capacity_factor=args.moe_capacity_factor,
            dispatch=args.moe_dispatch)
        model = moe_lib.MoELM(model_cfg, moe_cfg, device=device,
                              seed=conf.seed)
    else:
        model = llama.LlamaLM(model_cfg, device=device, seed=conf.seed)
    params = dp.broadcast_params(dict(model.named_parameters()))
    chunked = (args.chunked_ce if args.chunked_ce is not None
               else args.preset == "8b")
    optimizer = optim.make_optimizer(
        args.optimizer,
        optim.make_schedule(args.schedule, conf.lr, conf.num_steps,
                            args.warmup_steps),
        grad_clip=args.grad_clip or None, moment_dtype=args.moment_dtype)

    def loss(batch, gen):
        if moe_cfg is not None:
            return moe_lib.loss_fn(model, moe_cfg, batch, gen,
                                   chunked=chunked)
        return llama.loss_fn(model, batch, gen, chunked=chunked)

    state = dp.init_state(params, optimizer)
    step_fn = dp.make_train_step(
        loss, optimizer,
        reduction=(dp.Reduction.ADASUM if conf.use_adasum
                   else dp.Reduction.AVERAGE),
        microbatches=conf.grad_accum)

    tokens = data_lib.load_tokens(args.data_path,
                                  vocab_size=model_cfg.vocab_size,
                                  seed=conf.seed)
    # The corpus tail is held out for eval, disjoint from every epoch.
    n_eval = max(2 * (seq_len + 1), int(0.05 * len(tokens)))
    eval_tokens, tokens = tokens[-n_eval:], tokens[:-n_eval]
    extra = {}
    if args.pack:
        docs = data_lib.split_documents(tokens, args.pack_sep_id,
                                        seed=conf.seed)
        batcher = data_lib.PackedTokenBatcher(
            docs, per_host, seq_len, seed=conf.seed, process_index=rank,
            num_processes=world)
        extra["packing_efficiency"] = round(batcher.packing_efficiency, 4)
    else:
        batcher = data_lib.TokenBatcher(tokens, per_host, seq_len,
                                        seed=conf.seed, process_index=rank,
                                        num_processes=world)

    eval_batcher = None
    eval_b = min(per_host, ((len(eval_tokens) - 1) // seq_len) // world)
    if eval_b >= 1:
        eval_batcher = data_lib.TokenBatcher(
            eval_tokens, eval_b, seq_len, seed=conf.seed,
            process_index=rank, num_processes=world)

    def eval_loss(state) -> float:
        n = min(4, eval_batcher.batches_per_epoch)
        vals = []
        with torch.no_grad():
            for s in range(n):
                batch = dp.to_device(eval_batcher.batch_at(s), device)
                vals.append(float(loss(batch, None)[0]))
        return sum(vals) / len(vals)

    if args.eval_every and eval_batcher is None:
        raise ValueError("--eval-every: held-out set smaller than one eval "
                         "batch per process")
    metrics = MetricsLogger(job="llama", enabled=distributed.is_primary())
    n_params = sum(p.numel() for p in params.values())
    if moe_cfg is not None:
        extra["moe"] = {"experts": moe_cfg.num_experts,
                        "top_k": moe_cfg.top_k,
                        "capacity_factor": moe_cfg.capacity_factor,
                        "dispatch": moe_cfg.dispatch}
        flops = moe_lib.flops_per_token(model_cfg, moe_cfg,
                                        seq_len=seq_len) * seq_len
    else:
        flops = llama.flops_per_token(model_cfg, seq_len=seq_len) * seq_len
    metrics.emit("start", world_size=world, num_steps=conf.num_steps,
                 preset=args.preset, params=n_params, seq_len=seq_len,
                 attention=args.attention, chunked_ce=chunked,
                 device=str(device), dtype=args.dtype, **extra)
    try:
        state = loop.fit(
            step_fn, state, batcher.iter_from, conf.num_steps, conf.seed,
            metrics=metrics, log_every=conf.log_every,
            global_batch_size=conf.batch_size, flops_per_example=flops,
            peak_flops=(H100_PEAK_FLOPS[args.dtype]
                        if device.type == "cuda" else None),
            eval_every=conf.eval_every,
            eval_fn=(lambda s: {"loss": eval_loss(s)})
            if conf.eval_every else None)
        result = {"num_steps": state.step, "world_size": world,
                  "params": n_params}
        if conf.eval_final:
            if eval_batcher is None:
                metrics.emit("eval_skipped", reason="held-out set smaller "
                             "than one window per process")
            else:
                ev = eval_loss(state)
                metrics.emit("eval", loss=ev, perplexity=math.exp(ev))
                result["eval_loss"] = ev
    finally:
        metrics.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
