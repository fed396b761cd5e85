"""Process-group bootstrap, the mpirun/OpenMPI replacement.

Port of ``k8s_distributed_deeplearning_tpu/parallel/distributed.py`` onto
``torch.distributed``: one process per replica, NCCL on the card and gloo
on the CPU. The env contract is the JAX package's (what the rendered job
manifest injects, plus the standard names):

- ``TPUJOB_COORDINATOR_ADDRESS`` (or ``JAX_COORDINATOR_ADDRESS``,
  ``COORDINATOR_ADDRESS``): host:port of process 0
- ``TPUJOB_NUM_PROCESSES`` (``JAX_NUM_PROCESSES``, ``NUM_PROCESSES``)
- ``TPUJOB_PROCESS_ID`` (``JAX_PROCESS_ID``, ``PROCESS_ID``)

Nothing on a single machine names a cluster, so a single-process run forms
its world of one with :func:`initialize_single` (a free localhost port):
the train step always runs in a process group.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch.distributed as dist


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def backend_for(device_type: str) -> str:
    """NCCL for CUDA replicas, gloo for CPU ones."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_from_env(device_type: str = "cuda") -> bool:
    """Form the multi-process world from env vars; a no-op (False) when
    the env names no world or a world of one, or when already initialized
    (True). A partial env (some of the three variables) raises, naming all
    three."""
    if dist.is_initialized():
        return True
    coord = _env("TPUJOB_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS")
    nproc = _env("TPUJOB_NUM_PROCESSES", "JAX_NUM_PROCESSES", "NUM_PROCESSES")
    pid = _env("TPUJOB_PROCESS_ID", "JAX_PROCESS_ID", "PROCESS_ID")
    if coord is None and nproc is None:
        return False
    if coord is None or nproc is None or pid is None:
        raise RuntimeError(
            "Partial multi-host env: need TPUJOB_COORDINATOR_ADDRESS, "
            "TPUJOB_NUM_PROCESSES and TPUJOB_PROCESS_ID (got "
            f"coord={coord!r}, nproc={nproc!r}, pid={pid!r}). The job "
            "manifest renderer injects all three; see launch/render.py.")
    if int(nproc) <= 1:
        return False
    dist.init_process_group(backend_for(device_type),
                            init_method=f"tcp://{coord}",
                            world_size=int(nproc), rank=int(pid),
                            timeout=timedelta(minutes=10))
    return True


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_single(device_type: str = "cuda") -> None:
    """A world of one on a free localhost port, unless one exists."""
    if not dist.is_initialized():
        dist.init_process_group(
            backend_for(device_type),
            init_method=f"tcp://localhost:{free_port()}", world_size=1,
            rank=0)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on process 0: the ``hvd.rank() == 0`` gate for logging."""
    return process_index() == 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
