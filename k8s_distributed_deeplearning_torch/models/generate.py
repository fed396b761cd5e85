"""Generation steps over the paged KV pool.

Port of the paged forms of ``k8s_distributed_deeplearning_tpu/models/
generate.py``: :func:`prefill_chunk` (a prompt slice written at explicit
absolute positions) and :func:`slot_decode_step` (one token per slot, each
at its own cursor), plus :func:`filter_logits`. The pool is a list of
``(pool_k, pool_v)`` tensors per layer, updated in place — the JAX
functions return a new cache pytree instead. One-shot ``generate`` and the
dense cache are not ported yet.
"""
from __future__ import annotations

import torch

ALL = "all"


@torch.no_grad()
def prefill_chunk(model, cache: list, chunk: torch.Tensor, *,
                  positions: torch.Tensor, block_tables: torch.Tensor,
                  logits_index: int | str | None = ALL):
    """Run ``chunk`` ([B, C] tokens) through the paged decode branch,
    writing its K/V at ``positions`` ([B, C] absolute) through
    ``block_tables`` ([B, n_blocks]). Every chunk token attends the
    already-written prefix and the chunk's own earlier tokens.

    ``logits_index`` picks what the LM head runs on: ``"all"`` returns
    [B, C, V] logits; an int ``i`` returns [B, V] logits of column ``i``
    only (the head is per-position, so this equals slicing the full
    logits); None skips the head and returns None (an intermediate chunk
    needs only its K/V)."""
    hidden = model(chunk, positions=positions, decode=True, cache=cache,
                   block_tables=block_tables, return_hidden=True)
    if logits_index is None:
        return None
    if logits_index == ALL:
        return model.logits(hidden)
    return model.logits(hidden[:, logits_index])


@torch.no_grad()
def slot_decode_step(model, cache: list, tokens: torch.Tensor,
                     slot_positions: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """One slot decode step: row i's ``tokens[i]`` is written at its own
    cursor ``slot_positions[i]`` through its block table and attends its
    prefix ``0..slot_positions[i]``. Returns [B, V] f32 logits."""
    logits = model(tokens[:, None], decode=True, cache=cache,
                   cache_positions=slot_positions,
                   block_tables=block_tables)
    return logits[:, -1, :]


def filter_logits(logits: torch.Tensor, top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """Top-k / nucleus filtering on a [..., V] logits slice, k first, then
    p: tokens outside the k most likely, and outside the smallest set whose
    probability mass reaches ``top_p``, get -inf. The most likely token
    always survives."""
    if (top_k is None or top_k <= 0) and (top_p is None or top_p >= 1.0):
        return logits
    neg = torch.tensor(float("-inf"), dtype=logits.dtype,
                       device=logits.device)
    v = logits.shape[-1]
    if top_p is None or top_p >= 1.0:
        kth = torch.topk(logits, min(top_k, v), dim=-1).values[..., -1:]
        return torch.where(logits < kth, neg, logits)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None and top_k > 0:
        kth = sorted_desc[..., min(top_k, v) - 1:min(top_k, v)]
        logits = torch.where(logits < kth, neg, logits)
        keep = torch.arange(v, device=logits.device) < top_k
        sorted_desc = torch.where(keep, sorted_desc, neg)
    probs = torch.softmax(sorted_desc, dim=-1)
    # Keep a sorted token while the mass BEFORE it is < top_p: the first
    # token is always kept, and the kept set is the smallest reaching top_p.
    exclusive = torch.cumsum(probs, dim=-1) - probs
    n_keep = (exclusive < top_p).sum(-1, keepdim=True).clamp_min(1)
    thresh = torch.gather(sorted_desc, -1, n_keep - 1)
    return torch.where(logits < thresh, neg, logits)
