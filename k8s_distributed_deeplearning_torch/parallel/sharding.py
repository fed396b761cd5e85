"""Serving tensor parallelism's rule table and the shards it gives.

The serving half of ``k8s_distributed_deeplearning_tpu/parallel/
sharding.py`` (``SERVE_TP_AXIS``, ``SERVE_TP_RULES``,
``serve_tp_param_specs``, ``serve_tp_cache_specs``). The JAX package maps
each parameter's logical axes through the rule table into
``PartitionSpec``s and lets ``shard_map`` cut the arrays; here a rank
takes its slice of each tensor itself:

- Megatron column/row sharding on attention and the MLP: q/k/v and
  gate/up split their OUTPUT rows (whole heads each: the ``[H·hd, D]``
  weights are head-major), o_proj and down split their INPUT columns;
- everything else (embeddings, norms, the LM head) whole on every rank,
  so each rank computes the full ``[B, vocab]`` logits after the last
  row-parallel all-reduce and the decode path needs no gather;
- the paged pool ``[num_pages, page_tokens, kv·hd]`` (and its int8 scales
  ``[.., kv]``) split on its last dim: kv is outermost, so a contiguous
  1/tp of the lanes is ``kv/tp`` whole heads.

The training half (``DEFAULT_RULES``, ``ShardedTrainer``) is not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

SERVE_TP_AXIS = "tp"
# Each projection weight (torch ``[out, in]``): its logical axis (JAX's
# name) and the dim of the weight that axis is.
_PARAM_AXES = {
    "q_proj": ("heads", 0), "k_proj": ("kv", 0), "v_proj": ("kv", 0),
    "o_proj": ("heads", 1),
    "gate_proj": ("mlp", 0), "up_proj": ("mlp", 0), "down_proj": ("mlp", 1),
}
# JAX's table: each of those logical axes goes to the tp axis
# (heads: q and o_proj; kv: GQA head groups; mlp: gate/up and down).
SERVE_TP_RULES = tuple((axis, SERVE_TP_AXIS) for axis in dict.fromkeys(
    axis for axis, _ in _PARAM_AXES.values()))


def _split_dim(name: str) -> int | None:
    """The dim of parameter ``name`` split over the tp axis, or None."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] != "weight":
        return None
    return _PARAM_AXES.get(parts[-2], (None, None))[1]


def serve_tp_param_specs(model) -> dict[str, int | None]:
    """Per parameter (and persistent buffer) name of ``model``'s state
    dict: the dim split over the tp axis, None where it stays whole: the
    counterpart of JAX's PartitionSpec tree."""
    return {name: _split_dim(name) for name in model.state_dict()}


def serve_tp_shard(name: str, full: torch.Tensor, rank: int,
                   tp: int) -> torch.Tensor:
    """Rank ``rank``'s slice of parameter ``name`` (``full``, the whole
    tensor) under ``tp`` shards, contiguous; a whole tensor as it is."""
    dim = _split_dim(name)
    if dim is None:
        return full
    n = full.shape[dim]
    if n % tp:
        raise ValueError(f"{name}: dim {dim} ({n}) is not divisible by "
                         f"tp ({tp})")
    return full.narrow(dim, rank * (n // tp), n // tp).contiguous()


def serve_tp_full_shape(name: str, local_shape, tp: int) -> tuple:
    """The whole tensor's shape of parameter ``name`` from one rank's
    slice shape."""
    shape = list(local_shape)
    dim = _split_dim(name)
    if dim is not None:
        shape[dim] *= tp
    return tuple(shape)


def serve_tp_cache_shard(t: torch.Tensor, rank: int,
                         tp: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a pool tensor: its last dim (lanes, or
    the int8 scales' kv heads) cut in ``tp`` contiguous parts."""
    n = t.shape[-1]
    if n % tp:
        raise ValueError(f"pool tensor's last dim ({n}) is not divisible "
                         f"by tp ({tp})")
    return t.narrow(-1, rank * (n // tp), n // tp)
