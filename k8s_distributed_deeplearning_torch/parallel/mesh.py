"""Named process meshes and topology introspection.

Port of ``k8s_distributed_deeplearning_tpu/parallel/mesh.py`` onto
``torch.distributed``. Where the JAX package lays a
:class:`jax.sharding.Mesh` over ``jax.devices()`` and names its axes, here
the unit of parallelism is a process (one a device), and a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with the same axis names. A model names an axis
(``TransformerConfig.tp_axis``) and :func:`axis_group` resolves the name
to that axis's process group, the way JAX resolves an axis name inside
``shard_map``.

The topology answers (``hvd.rank()/size()/local_rank()`` and
``hvd.nccl_built()`` in the reference) come from the process group and the
CUDA runtime; the interconnect figure is a probe on the device at hand,
never a table.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.utils.metrics import H100_PEAK_FLOPS

# Canonical mesh axis names, outermost to innermost, as in the JAX package.
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "sequence"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipeline"

_MESHES: dict[str, object] = {}     # axis name -> the mesh that holds it


def make_mesh(axis_sizes=None, device_type: str | None = None):
    """Build a named mesh over every rank of the default process group
    (which must exist) and register its axis names for
    :func:`axis_group`.

    ``axis_sizes`` maps axis name -> size (a ``config.MeshConfig``-style
    object with ``to_axis_sizes`` is accepted too); at most one axis may
    be -1 ("fill with the remaining ranks"). Default: a 1-D ``data`` mesh
    over every rank. ``device_type`` (default: ``"cuda"`` when the
    process has a card, else ``"cpu"``) is the mesh's device type; ranks
    that share one card are allowed (their collectives then ride the
    host, see ``serve/tp.py``)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "torch.distributed.init_process_group (or serve.tp.launch / "
            "parallel.distributed.initialize_single) first")
    if axis_sizes is not None and hasattr(axis_sizes, "to_axis_sizes"):
        axis_sizes = axis_sizes.to_axis_sizes()
    n = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {AXIS_DATA: n}
    names = tuple(axis_sizes)
    sizes = dict(axis_sizes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wild}")
    if wild:
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if n % fixed:
            raise ValueError(f"{n} ranks not divisible by fixed axes {sizes}")
        sizes[wild[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} ranks, have {n}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.arange(n).reshape(tuple(sizes[k] for k in names))
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    for name in names:
        _MESHES[name] = mesh
    return mesh


def axis_group(name: str):
    """The process group of mesh axis ``name`` (the last mesh built with
    it), as ``shard_map`` resolves an axis name."""
    mesh = _MESHES.get(name)
    if mesh is None:
        raise ValueError(
            f"no mesh has an axis named {name!r}: build one with "
            f"make_mesh({{{name!r}: size}})")
    return mesh.get_group(name)


def forget_meshes() -> None:
    """Drop every registered axis (the process group is going away)."""
    _MESHES.clear()


@dataclass(frozen=True)
class Topology:
    """What the world looks like: the ``hvd.rank()/size()/local_rank()``
    surface plus device identity."""

    num_devices: int
    num_local_devices: int
    num_processes: int
    process_index: int
    platform: str
    device_kind: str

    @property
    def world_size(self) -> int:  # hvd.size()
        return self.num_devices

    @property
    def local_size(self) -> int:  # hvd.local_size()
        return self.num_local_devices


def topology() -> Topology:
    """One device a process: the world's size is its device count. A
    process without a process group is a world of one."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if torch.cuda.is_available():
        local = torch.cuda.device_count()
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        local, platform, kind = 1, "cpu", "cpu"
    return Topology(num_devices=world, num_local_devices=local,
                    num_processes=world, process_index=rank,
                    platform=platform, device_kind=kind)


def fast_interconnect_available() -> bool:
    """``hvd.nccl_built()`` analog: True when two cards of this host reach
    each other directly (peer access, NVLink or PCIe P2P), so collectives
    skip the host. One card, or none, is False."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return False
    return torch.cuda.can_device_access_peer(0, 1)


def _time_copy(src: torch.Tensor, dst: torch.Tensor, iters: int) -> float:
    dst.copy_(src, non_blocking=True)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    return src.numel() * src.element_size() * iters / (
        time.perf_counter() - t0)


def interconnect_bandwidth_estimate(nbytes: int = 64 << 20,
                                    iters: int = 8) -> float:
    """Bytes/sec that one collective hop moves here, measured now (the
    beta term of a collective cost model): a copy between cards 0 and 1
    where there are two; with one card, a device-to-host copy into
    pinned memory (ranks sharing a card exchange through the host); on
    the CPU, the host memcpy probe (``runtime/fusion.py``)."""
    if not torch.cuda.is_available():
        from k8s_distributed_deeplearning_torch.runtime.fusion import (
            probe_memcpy_bandwidth)
        return probe_memcpy_bandwidth(nbytes, iters)
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda:0")
    if torch.cuda.device_count() >= 2:
        dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda:1")
    else:
        dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return _time_copy(src, dst, iters)


def peak_flops_per_device(dtype: str = "bfloat16") -> float | None:
    """Peak matmul FLOP/s of this process's device, for MFU accounting:
    the H100's published dense peaks (``utils/metrics.py``) on an H100;
    None on any other device, whose peak this module does not know."""
    if (torch.cuda.is_available()
            and "H100" in torch.cuda.get_device_name(0)):
        return H100_PEAK_FLOPS.get(dtype, H100_PEAK_FLOPS["float32"])
    return None
