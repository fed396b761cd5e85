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
ragged`` runs the experts as grouped matmuls on the CUDA kernels. Rank 0
checkpoints to ``--checkpoint-dir`` (default ``./checkpoints``, every
``--checkpoint-every`` steps and at the end), a run restores from the
newest good step there, and SIGTERM checkpoints and stops
(``train/checkpoint.py``, ``train/preemption.py``). ``--data-path DIR``
streams a directory of token shards (``train/data.py``
``write_token_shards`` / ``TokenShardBatcher``, memory-mapped; the final
shard's tail is the held-out eval set); ``--profile-dir DIR`` traces steps
10-14 on the primary into ``DIR/trace.json`` (``utils/profiling.py``
``StepProfiler``). Sharded, expert-parallel and pipelined training
(``--fsdp``, ``--tp``, ``--sp``, ``--ep``, ``--pp`` and its
``--pp-microbatches``/``--pp-schedule``/``--pp-virtual``, ``--attention
ring|ulysses``) are not ported yet and raise. ``--scan-layers`` /
``--no-scan-layers`` pick the flax layout the optimizer's per-leaf
arithmetic sees (``models/convert.py`` ``flax_layout``: one leaf a block
parameter stacked over the layers, or one a layer), as the JAX script's
layer scan does; the ``small`` preset is unrolled, the others scanned.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from k8s_distributed_deeplearning_torch import config as cfg_lib
from k8s_distributed_deeplearning_torch.models import convert, llama
from k8s_distributed_deeplearning_torch.models import moe as moe_lib
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
from k8s_distributed_deeplearning_torch.utils.profiling import StepProfiler

PRESETS = {
    # name: overrides on llama.config_tiny / config_llama3_8b
    "tiny": dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 mlp_dim=128, max_seq_len=512),
    # small is unrolled, as the JAX preset (its measured-fastest layout):
    # adafactor factors each layer's leaf on its own.
    "small": dict(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                  n_kv_heads=4, mlp_dim=2048, max_seq_len=2048, remat=True,
                  scan_layers=False),
    "1b": dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=32,
               n_kv_heads=8, mlp_dim=8192, max_seq_len=4096, remat=True),
    "8b": dict(),          # the true Llama-3 8B architecture numbers
}


def build_config(args) -> llama.TransformerConfig:
    """The preset with the CLI's overrides. Parameters are kept in f32 and
    cast to ``--dtype`` at each use, as the JAX model keeps them."""
    overrides = dict(PRESETS[args.preset])
    overrides.pop("scan_layers", None)      # a layout, not an architecture
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


def scan_layers(args) -> bool:
    """The flax layout the optimizer sees: ``--scan-layers`` /
    ``--no-scan-layers`` when given, else the preset's (``small``
    unrolled, the others scanned), as the JAX script decides."""
    if getattr(args, "scan_layers", None) is not None:
        return args.scan_layers
    return PRESETS[args.preset].get("scan_layers", True)


def _unported(args) -> None:
    for flag, value in (("--fsdp", args.fsdp), ("--tp", args.tp),
                        ("--sp", args.sp), ("--pp", args.pp),
                        ("--ep", args.ep)):
        if value > 1:
            raise NotImplementedError(
                f"{flag} {value}: sharded, context-parallel, "
                "expert-parallel and pipelined training are not ported to "
                "PyTorch yet (ROADMAP.md)")
    for flag, value in (("--pp-microbatches", args.pp_microbatches),
                        ("--pp-schedule", args.pp_schedule),
                        ("--pp-virtual", args.pp_virtual)):
        if value is not None:
            raise NotImplementedError(
                f"{flag} {value}: pipelined training is not ported to "
                "PyTorch yet (ROADMAP.md)")
    if args.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"--attention {args.attention}: context-parallel attention is "
            "not ported to PyTorch yet (ROADMAP.md)")


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
    parser.add_argument("--pp-microbatches", type=int, default=None,
                        help="pipeline microbatches: not ported yet, raises")
    parser.add_argument("--pp-schedule", default=None,
                        choices=["gpipe", "1f1b", "interleaved"],
                        help="pipeline schedule: not ported yet, raises")
    parser.add_argument("--pp-virtual", type=int, default=None,
                        help="virtual pipeline stages: not ported yet, "
                        "raises")
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
    parser.add_argument("--attention",
                        choices=["auto", "xla", "flash", "ring", "ulysses"],
                        default="auto",
                        help="auto = the flash kernels on the card at "
                        "S >= 1024, the einsum path otherwise; ring and "
                        "ulysses (context parallelism) raise")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each block")
    parser.add_argument("--scan-layers", dest="scan_layers",
                        action="store_true", default=None,
                        help="the optimizer sees the scanned flax layout "
                        "(one leaf a block parameter, stacked over the "
                        "layers); default: the preset's choice")
    parser.add_argument("--no-scan-layers", dest="scan_layers",
                        action="store_false",
                        help="the unrolled layout (one leaf a layer)")
    parser.add_argument("--data-path", type=str, default=None,
                        help="byte-level corpus file, or a directory of "
                        "token shards to stream; default synthetic tokens")
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
                        help="trace steps 10-14 (host ops and the card's "
                        "kernels) into DIR/trace.json on the primary")
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
        grad_clip=args.grad_clip or None, moment_dtype=args.moment_dtype,
        layout=convert.flax_layout(model_cfg,
                                   scan_layers=scan_layers(args)))

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

    extra = {}
    if args.data_path and os.path.isdir(args.data_path):
        # A directory of token shards: the streaming path (memory-mapped,
        # resident = touched pages). The final shard's tail is the eval set.
        if args.pack:
            raise ValueError(
                "--pack needs an in-memory corpus (document packing is a "
                "whole-corpus host pass): pass --data-path FILE, not a "
                "shard directory")
        probe = data_lib.TokenShardBatcher(
            args.data_path, per_host, seq_len, seed=conf.seed,
            vocab_size=model_cfg.vocab_size)
        n_eval = max(2 * (seq_len + 1),
                     min(probe.final_shard_tokens // 10, 64 * seq_len))
        batcher = data_lib.TokenShardBatcher(
            args.data_path, per_host, seq_len, seed=conf.seed,
            process_index=rank, num_processes=world, hold_out_tail=n_eval,
            vocab_size=model_cfg.vocab_size)
        eval_tokens = batcher.tail_tokens()
        extra = {"data": "sharded-streaming",
                 "num_windows": batcher.num_windows}
    else:
        tokens = data_lib.load_tokens(args.data_path,
                                      vocab_size=model_cfg.vocab_size,
                                      seed=conf.seed)
        # The corpus tail is held out for eval, disjoint from every epoch.
        n_eval = max(2 * (seq_len + 1), int(0.05 * len(tokens)))
        eval_tokens, tokens = tokens[-n_eval:], tokens[:-n_eval]
        if args.pack:
            docs = data_lib.split_documents(tokens, args.pack_sep_id,
                                            seed=conf.seed)
            batcher = data_lib.PackedTokenBatcher(
                docs, per_host, seq_len, seed=conf.seed, process_index=rank,
                num_processes=world)
            extra["packing_efficiency"] = round(
                batcher.packing_efficiency, 4)
        else:
            batcher = data_lib.TokenBatcher(
                tokens, per_host, seq_len, seed=conf.seed,
                process_index=rank, num_processes=world)

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
    if conf.keep_best and not conf.eval_every:
        raise ValueError("--keep-best needs --eval-every to produce the "
                         "metric it ranks checkpoints by")
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
                 scan_layers=scan_layers(args), device=str(device),
                 dtype=args.dtype, **extra)
    ckpt = Checkpointer(conf.checkpoint_dir,
                        max_to_keep=conf.max_checkpoints_to_keep,
                        keep_best_metric="loss" if conf.keep_best else None,
                        best_mode="min", async_save=conf.async_checkpoint,
                        metrics=metrics)
    preemption = PreemptionHandler.install()
    profiler = (StepProfiler(args.profile_dir, start_step=10, num_steps=5,
                             enabled=distributed.is_primary())
                if args.profile_dir else None)
    prefetchers: list = []

    def batches(start_step: int):
        return prefetch.maybe(batcher.iter_from(start_step),
                              lambda b: dp.to_device(b, device),
                              args.prefetch, prefetchers)

    try:
        state = loop.fit(
            step_fn, state, batches, conf.num_steps, conf.seed,
            metrics=metrics, checkpointer=ckpt,
            checkpoint_every=conf.checkpoint_every, log_every=conf.log_every,
            global_batch_size=conf.batch_size, flops_per_example=flops,
            peak_flops=(H100_PEAK_FLOPS[args.dtype]
                        if device.type == "cuda" else None),
            preemption=preemption, profiler=profiler,
            eval_every=conf.eval_every,
            eval_fn=(lambda s: {"loss": eval_loss(s)})
            if conf.eval_every else None)
        result = {"num_steps": state.step, "world_size": world,
                  "params": n_params}
        # A preempted run skips eval: the grace period is for the save,
        # and an "eval" event would make an evicted run look completed.
        if conf.eval_final and not preemption.triggered:
            if eval_batcher is None:
                metrics.emit("eval_skipped", reason="held-out set smaller "
                             "than one window per process")
            else:
                ev = eval_loss(state)
                metrics.emit("eval", loss=ev, perplexity=math.exp(ev))
                result["eval_loss"] = ev
    finally:
        preemption.uninstall()
        prefetch.close_all(prefetchers)
        ckpt.close()
        metrics.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
