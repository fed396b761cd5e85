"""Typed training and job configuration, and the training CLI flags.

Own copy of the part of ``k8s_distributed_deeplearning_tpu/config.py``
that the training CLIs and the launch layer use: :class:`TrainConfig`
(the reference's defaults: lr 0.001, 20000 steps, batch size 100, Adasum
off, dropout 0.5, rank-0 checkpoints in ``./checkpoints`` every 1000
steps) with the Horovod LR and step rules, :func:`add_train_flags`, and
:class:`JobConfig`, the cluster job's shape that ``launch/render.py``
turns into manifests. ``JobConfig`` keeps the JAX package's fields and
defaults but for the accelerator: each worker pod claims
``gpus_per_worker`` NVIDIA cards (``nvidia.com/gpu``) on nodes labelled
``cloud.google.com/gke-accelerator: <gpu_accelerator>`` in place of a TPU
slice's topology, and the image and script are the port's.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
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


@dataclass
class JobConfig:
    """Cluster job shape: the MPIJob-manifest knobs
    (``tensorflow-mnist.yaml:6,44``, ``deploy_stack.sh:8-10,57,90``) for
    GPU nodes. Every field but the accelerator's is the JAX package's,
    with its default; the comments say which rendered env var or flag
    each one becomes and what ``launch/validate.py`` checks offline."""

    name: str = "tpu-mnist"
    namespace: str = "ml-ops"
    num_workers: int = 2
    gpus_per_worker: int = 1         # nvidia.com/gpu limit of each pod
    gpu_accelerator: str = "nvidia-h100-80gb"  # gke-accelerator node label
    image: str = "k8s-distributed-deeplearning-torch:latest"
    script: str = "examples/train_mnist_torch.py"
    script_args: list[str] = field(default_factory=list)
    cpu: str = "2"                   # worker resources (tensorflow-mnist.yaml:49-53)
    memory: str = "4Gi"
    coordinator_port: int = 8476
    metrics_port: int = 9090         # Prometheus /metrics (+ /healthz) scrape
    clean_pod_policy: str = "Running"  # tensorflow-mnist.yaml:8
    # Fault-injection plan carried into every worker as $TPUJOB_FAULT_PLAN
    # (inline JSON, or "@/path" to a mounted file; faults/plan.py). None
    # renders no env.
    fault_plan: str | None = None
    # Multi-tenant scheduler config for serving workers as
    # $TPUJOB_TENANTS (inline JSON or "@/path"; serve/sched/tenant.py).
    tenants: str | None = None
    # Fleet scrape targets as $TPUJOB_FLEET_ENDPOINTS (comma-separated
    # host:port /metrics targets; telemetry/fleet.py).
    fleet_endpoints: str | None = None
    # Pod terminationGracePeriodSeconds: the SIGTERM -> SIGKILL window the
    # serving drain and the training preemption checkpoint run inside.
    # None renders no field (the k8s default, 30 s).
    termination_grace_s: int | None = None
    # Speculative decoding for serving workers: $TPUJOB_DRAFT_MODEL and
    # $TPUJOB_SPEC_K, both or neither (validate.py checks the pair).
    draft_model: str | None = None
    spec_k: int | None = None
    # Flight recorder for serving workers: $TPUJOB_FLIGHT_RING and
    # $TPUJOB_FLIGHT_DIR (a dir without a ring records nothing).
    flight_ring: int | None = None
    flight_dir: str | None = None
    # Remote serving (serve/transport.py): an Indexed Job of replica-server
    # pods behind a headless Service and a one-pod gateway Job that
    # dispatches to them over HTTP, probes split /readyz vs /healthz.
    serve_replicas: int | None = None
    # Disaggregated serving (serve/disagg.py): a prefill tier of
    # replica-server pods (--role prefill) and the gateway pod as the
    # disagg coordinator. Requires serve_replicas.
    serve_prefill_replicas: int | None = None
    serve_preset: str = "tiny"       # model preset for both serving roles
    serve_slots: int | None = None   # per-replica decode slots (None = CLI default)
    # Tensor-parallel width per serving replica: the replica Job requests
    # this many cards and the CLI gets --tp. The port's serve CLI refuses
    # --tp at every value (ROADMAP.md), so validate.py reports any
    # serve_tp, 1 included.
    serve_tp: int | None = None
    # preStop sleep (seconds) before SIGTERM, so the routing layer stops
    # sending new requests first; must be < termination_grace_s.
    pre_stop_sleep_s: int | None = None
    # Elastic serving (serve/autoscale.py): with autoscale_max set the
    # gateway runs the fleet controller (serve/cli.py --autoscale),
    # rendered as $TPUJOB_AUTOSCALE_{MIN,MAX,UP_COOLDOWN_S,
    # DOWN_COOLDOWN_S,BROWNOUT}; validate.py checks min <= max, positive
    # cooldowns and known brownout stage names.
    autoscale_min: int | None = None
    autoscale_max: int | None = None
    autoscale_up_cooldown_s: float | None = None
    autoscale_down_cooldown_s: float | None = None
    autoscale_brownout: str | None = None  # comma-separated stage names
    # Chaos soak (serve/storm.py): a one-pod "serve-storm" Job running
    # ``launch storm`` for storm_steps steps; storm_seed is the replay
    # key, storm_fault_rate the upper per-visit firing probability.
    storm_steps: int | None = None
    storm_seed: int | None = None
    storm_fault_rate: float | None = None
    # Quantized serving: $TPUJOB_KV_QUANT / $TPUJOB_WEIGHT_QUANT ("int8")
    # on every serving role; validate.py sizes the int8 pool.
    kv_quant: str | None = None
    weight_quant: str | None = None

    def chips_per_worker(self) -> int:
        """Cards each worker pod requests (``nvidia.com/gpu``)."""
        return self.gpus_per_worker


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
