"""ctypes binding to the port's fusion planner (``csrc/fusion.cc``).

Port of ``k8s_distributed_deeplearning_tpu/runtime/fusion.py``, Horovod
core parity (the reference compiles Horovod's C++ tensor-fusion engine at
``horovod/Dockerfile:64-65``): the planner groups gradient tensors into
fused buckets under a byte threshold so a step issues few large
allreduces instead of many small ones, and an alpha-beta autotuner picks
the threshold. ``csrc/fusion.cc`` is a copy of the JAX package's
``native/fusion.cc``, built by ``ops/_build.py`` with ``c++`` at first
use; a failed build raises. :func:`_plan_buckets_py` is the plain
version the tests hold the native planner to.

The cost model's latency and bandwidth have no default: they belong to
the link the allreduce rides, so the caller measures them
(:func:`probe_allreduce`) or passes them.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.ops import _build

DEFAULT_THRESHOLD = 64 << 20  # Horovod's 64MB fusion-buffer default

_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    """The planner library, built and bound on first use."""
    lib = _build.load("fusion")
    if not getattr(lib, "_bound", False):
        lib.plan_buckets.restype = ctypes.c_int64
        lib.plan_buckets.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64,
                                     _I64P]
        lib.model_comm_seconds.restype = ctypes.c_double
        lib.model_comm_seconds.argtypes = [
            _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double]
        lib.autotune_threshold.restype = ctypes.c_int64
        lib.autotune_threshold.argtypes = [
            _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int64]
        lib.probe_memcpy_bw.restype = ctypes.c_double
        lib.probe_memcpy_bw.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib._bound = True
    return lib


def native_available() -> bool:
    """Whether ``csrc/fusion.cc`` builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _sizes(sizes_bytes) -> np.ndarray:
    sizes = np.ascontiguousarray(sizes_bytes, np.int64)
    if sizes.ndim != 1 or (sizes < 0).any():
        raise ValueError("sizes must be a list of non-negative byte counts")
    return sizes


def _plan_buckets_py(sizes: np.ndarray, threshold: int) -> np.ndarray:
    """The plain version of ``plan_buckets``."""
    out = np.zeros(len(sizes), np.int64)
    bucket, filled = 0, 0
    for i, s in enumerate(sizes):
        if filled > 0 and filled + s > threshold:
            bucket, filled = bucket + 1, 0
        out[i] = bucket
        filled += int(s)
        if filled >= threshold:
            bucket, filled = bucket + 1, 0
    return out


def plan_buckets(sizes_bytes, threshold: int = DEFAULT_THRESHOLD
                 ) -> np.ndarray:
    """Bucket id per tensor (arrival order, Horovod fusion semantics): a
    bucket closes before a tensor that would overflow it and once it
    reaches the threshold, so a tensor above the threshold gets its own."""
    sizes = _sizes(sizes_bytes)
    out = np.zeros(len(sizes), np.int64)
    if len(sizes):
        _lib().plan_buckets(sizes.ctypes.data_as(_I64P), len(sizes),
                            threshold, out.ctypes.data_as(_I64P))
    return out


@dataclass
class FusionPlanner:
    """Plan gradient-bucket fusion for ``world`` ranks under the
    alpha-beta ring-allreduce model: ``alpha_s`` seconds a hop,
    ``beta_s_per_byte`` seconds a byte (measured, see
    :func:`probe_allreduce`)."""

    world: int
    alpha_s: float
    beta_s_per_byte: float

    def plan(self, sizes_bytes, threshold: int = DEFAULT_THRESHOLD
             ) -> np.ndarray:
        return plan_buckets(sizes_bytes, threshold)

    def modeled_comm_seconds(self, sizes_bytes,
                             threshold: int = DEFAULT_THRESHOLD) -> float:
        """Modeled communication time of one step: one ring allreduce a
        bucket."""
        sizes = _sizes(sizes_bytes)
        if len(sizes) == 0:
            return 0.0
        return _lib().model_comm_seconds(
            sizes.ctypes.data_as(_I64P), len(sizes), threshold, self.world,
            self.alpha_s, self.beta_s_per_byte)

    def autotune(self, sizes_bytes, min_threshold: int = 1 << 20,
                 max_threshold: int = 256 << 20) -> int:
        """Best power-of-two fusion threshold under the alpha-beta model."""
        if min_threshold < 1:
            raise ValueError(f"min_threshold must be >= 1, got {min_threshold}")
        sizes = _sizes(sizes_bytes)
        if len(sizes) == 0:
            return min_threshold
        return int(_lib().autotune_threshold(
            sizes.ctypes.data_as(_I64P), len(sizes), self.world,
            self.alpha_s, self.beta_s_per_byte, min_threshold,
            max_threshold))


def probe_memcpy_bandwidth(nbytes: int = 16 << 20, iters: int = 8) -> float:
    """Host memory bandwidth in bytes/sec (the native probe)."""
    return float(_lib().probe_memcpy_bw(nbytes, iters))


def probe_allreduce(group=None, nbytes: int = 16 << 20,
                    iters: int = 10) -> tuple[float, float]:
    """Measure the group's allreduce for the alpha-beta model: ``(alpha_s,
    beta_s_per_byte)`` from the mean time of a 4-byte allreduce (all
    latency, ``2(w-1)`` hops) and of an ``nbytes`` one, on the card under
    NCCL. Every rank gets the largest of the ranks' readings, so every
    rank plans the same buckets. A group of one has no hops and returns
    ``(0.0, 0.0)``."""
    world = dist.get_world_size(group)
    if world == 1:
        return 0.0, 0.0
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))

    def mean_s(numel: int) -> float:
        x = torch.zeros(numel, dtype=torch.float32, device=device)
        dist.all_reduce(x, group=group)            # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x, group=group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / iters

    small, big = mean_s(1), mean_s(nbytes // 4)
    hops = 2 * (world - 1)
    got = torch.tensor([small / hops,
                        max(big - small, 0.0) / (hops / world * nbytes)],
                       dtype=torch.float64, device=device)
    dist.all_reduce(got, op=dist.ReduceOp.MAX, group=group)
    return float(got[0]), float(got[1])
