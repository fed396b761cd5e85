"""Generation: one-shot :func:`generate` over a dense KV cache, and the
step functions over a dense cache or the paged pool.

Port of ``k8s_distributed_deeplearning_tpu/models/generate.py``. The steps
write their cache in place (the JAX functions return a new cache pytree)
and take no ``params``: the module holds its weights. Two cache layouts:

- dense, a :class:`models.transformer.DenseCache` (``[B, S_cache, kv·hd]``
  K/V a layer, per-column document ids, one shared cursor):
  :func:`prefill` creates and fills one; :func:`prefill_chunk` (from the
  cursor, or from ``start``) and :func:`decode_step` continue it at the
  shared cursor, :func:`slot_decode_step` and :func:`slot_verify_step` at
  per-row cursors. :func:`generate` runs a prefill, then one decode step a
  token in an eager loop (JAX: one jitted ``lax.scan``);
- paged, one ``(pool_k, pool_v)`` pair a layer with ``block_tables`` (the
  serving engine's pool): :func:`prefill_chunk`, :func:`slot_decode_step`
  and :func:`slot_verify_step`.

Attention on the dense cache is the einsum path, as JAX's is XLA
attention; the paged steps run the paged-attention kernels on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from k8s_distributed_deeplearning_torch.models.transformer import DenseCache

ALL = "all"


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _logits(model, hidden: torch.Tensor, logits_index):
    """``"all"``: [B, C, V] logits; an int ``i``: [B, V] of column ``i``
    only (the head is per-position, so this equals slicing the full
    logits); None: no head, None."""
    if logits_index is None:
        return None
    if logits_index == ALL:
        return model.logits(hidden)
    return model.logits(hidden[:, logits_index])


def _paged(block_tables) -> dict:
    return {} if block_tables is None else {"block_tables": block_tables}


@torch.no_grad()
def prefill(model, prompt: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            segment_ids: torch.Tensor | None = None,
            cache_len: int | None = None,
            logits_index: int | str | None = ALL):
    """Run ``prompt`` ([B, S] tokens) through decode mode into a fresh
    dense cache of ``cache_len`` columns (default: the model's
    ``max_seq_len``). Returns ``(logits, cache)``: logits as
    ``logits_index`` picks (default [B, S, V] f32; the next token samples
    from column S-1), the cache ready for :func:`decode_step` and
    :func:`slot_decode_step`. ``segment_ids`` ([B, S], 0 = left padding)
    enter the cache's per-column ids."""
    cache = DenseCache.create(model.cfg, prompt.shape[0],
                              cache_len or model.cfg.max_seq_len,
                              device=_device(model))
    hidden = model(prompt, positions=positions, segment_ids=segment_ids,
                   decode=True, cache=cache, return_hidden=True)
    return _logits(model, hidden, logits_index), cache


@torch.no_grad()
def prefill_chunk(model, cache, chunk: torch.Tensor, *,
                  start: int | None = None,
                  positions: torch.Tensor | None = None,
                  segment_ids: torch.Tensor | None = None,
                  block_tables: torch.Tensor | None = None,
                  logits_index: int | str | None = ALL):
    """Resume prefill on an existing cache: ``chunk`` ([B, C] tokens)
    attends the already-written prefix and its own earlier tokens.

    Dense cache: the chunk is appended at the shared cursor, which
    ``start`` first resets (to resume after a spliced prefix, or to re-run
    an overlapping chunk, which rewrites identical K/V in place); the
    cursor then advances by C. Paged pool (``block_tables`` [B, n_blocks]):
    each token is written at its ``positions`` ([B, C] absolute, required)
    through the table, and ``start`` has no meaning.

    Returns logits as ``logits_index`` picks: ``"all"`` [B, C, V]; an int
    ``i`` [B, V] of column ``i``; None skips the head (an intermediate
    chunk needs only its K/V)."""
    if block_tables is None and start is not None:
        cache.index = int(start)
    hidden = model(chunk, positions=positions, segment_ids=segment_ids,
                   decode=True, cache=cache, return_hidden=True,
                   **_paged(block_tables))
    return _logits(model, hidden, logits_index)


@torch.no_grad()
def decode_step(model, cache: DenseCache, token: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """One shared-cursor decode step: ``token`` [B] enters at the cache's
    cursor for every row, all rows in lockstep (the body of
    :func:`generate`'s loop). Returns [B, V] f32 logits for the next
    position."""
    return model(token[:, None], positions=positions,
                 segment_ids=segment_ids, decode=True, cache=cache)[:, -1]


@torch.no_grad()
def slot_decode_step(model, cache, tokens: torch.Tensor,
                     slot_positions: torch.Tensor,
                     block_tables: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """One slot decode step: row i's ``tokens[i]`` is written at its own
    cursor ``slot_positions[i]`` (through its block table on a paged pool)
    and attends its prefix ``0..slot_positions[i]``. The caller keeps the
    cursors inside the cache. Returns [B, V] f32 logits."""
    return slot_verify_step(model, cache, tokens[:, None], slot_positions,
                            block_tables)[:, -1]


@torch.no_grad()
def slot_verify_step(model, cache, tokens: torch.Tensor,
                     slot_positions: torch.Tensor,
                     block_tables: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """One speculative verify window: row i's ``tokens[i]`` ([B, W]) is
    written at ``slot_positions[i] + [0, W)`` and each window token attends
    its own causal prefix (the writes land first, so window tokens see each
    other). Returns [B, W, V] f32 logits: position j scores the
    continuation after ``tokens[:, :j+1]``. Rejected tokens stay past the
    caller's truncated cursor and are never attended. On a paged pool the
    window takes the route ``ops.paged_attn._route`` picks for its
    shape."""
    return model(tokens, decode=True, cache=cache,
                 cache_positions=slot_positions, **_paged(block_tables))


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


def cache_window(max_seq_len: int, prompt_len: int,
                 max_new_tokens: int) -> int:
    """The dense cache's width for one :func:`generate` call: what the call
    can fill, rounded up to a multiple of 128 (at least 128), at most
    ``max_seq_len``. Every decode step attends this many columns, not the
    model's whole context."""
    need = prompt_len + max_new_tokens
    return min(max_seq_len, max(128, -(-need // 128) * 128))


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, eos_id: int | None = None,
             pad_id: int = 0, prompt_mask=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` ([B, S]
    tokens, moved to the model's device). Returns [B, max_new_tokens]
    int32 on the model's device.

    ``temperature=0`` is greedy argmax; otherwise a categorical draw from
    ``filter_logits(logits / temperature, top_k, top_p)`` with
    ``generator`` (a ``torch.Generator`` on the model's device, required).
    Rows that emitted ``eos_id`` emit ``pad_id`` from the next token on.
    Prompt + new tokens must fit the model's ``max_seq_len``; the cache
    holds :func:`cache_window` columns, or all ``max_seq_len`` for a
    learned-position model (JAX keeps its full window).

    ``prompt_mask`` ([B, S], 0 = padding) batches prompts of unequal
    lengths: pad each at the FRONT, so every row's last real token sits at
    column S-1, where the first token samples. Pads stay out of attention
    and RoPE positions count real tokens only, so each row decodes as it
    would alone. A learned-position model gets explicit positions (the
    prefill ``0..S-1``, decode step t at ``S + t``; left-padded: real
    tokens counted per row), as the dense decode requires them."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling requires rng (pass "
                         "generator=, a torch.Generator on the model's "
                         "device)")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if temperature <= 0.0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature > 0 (greedy decoding ignores "
            "them — silently dropping the request would mislead)")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    prompt = torch.as_tensor(prompt)
    max_seq = model.cfg.max_seq_len
    if prompt.shape[1] + max_new_tokens > max_seq:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the model's max_seq_len ({max_seq}) — the KV cache "
            "would overflow")
    dev = _device(model)
    if prompt_mask is not None:
        prompt_mask = torch.as_tensor(prompt_mask)
        if prompt_mask.shape != prompt.shape:
            raise ValueError(f"prompt_mask {tuple(prompt_mask.shape)} must "
                             f"match prompt {tuple(prompt.shape)}")
        pm = prompt_mask.cpu().numpy().astype(bool)
        if not (pm[:, -1].all()
                and (np.diff(pm.astype(np.int8), axis=1) >= 0).all()):
            raise ValueError(
                "prompt_mask must be LEFT-padded: zeros before ones, "
                "last column all-real (each row's final token is where "
                "decoding starts)")
        prompt_mask = prompt_mask.to(dev)
    learned = model.cfg.position == "learned"
    return _generate(
        model, prompt.to(dev), temperature, generator, prompt_mask,
        greedy=temperature <= 0.0, max_new_tokens=max_new_tokens,
        eos_id=eos_id, pad_id=pad_id, top_k=top_k, top_p=top_p,
        window=(max_seq if learned else
                cache_window(max_seq, prompt.shape[1], max_new_tokens)),
        learned=learned)


def left_padded_inputs(prompt_mask: torch.Tensor) -> dict:
    """The prefill's ``positions`` and ``segment_ids`` for a LEFT-padded
    batch: positions count each row's real tokens (pads at 0), and the mask
    rides into the cache as per-column document ids (0 = pad)."""
    ok = (prompt_mask != 0).to(torch.int32)
    start = prompt_mask.shape[1] - ok.sum(-1, dtype=torch.int32)
    cols = torch.arange(prompt_mask.shape[1], device=prompt_mask.device)
    return dict(positions=(cols[None] - start[:, None]).clamp_min(0),
                segment_ids=ok)


def _generate(model, prompt: torch.Tensor, temperature: float,
              generator: torch.Generator | None,
              prompt_mask: torch.Tensor | None, *, greedy: bool,
              max_new_tokens: int, eos_id: int | None, pad_id: int,
              top_k: int | None, top_p: float | None,
              window: int, learned: bool = False) -> torch.Tensor:
    b, s = prompt.shape
    dev = prompt.device
    kw: dict = {}
    lens = None
    if learned:
        kw = dict(positions=torch.arange(s, device=dev)[None])
    if prompt_mask is not None:
        kw = left_padded_inputs(prompt_mask)
        lens = kw["segment_ids"].sum(-1, dtype=torch.int32)     # [B]
    logits, cache = prefill(model, prompt, cache_len=window,
                            logits_index=-1, **kw)

    def sample(logits_last: torch.Tensor) -> torch.Tensor:
        if greedy:
            return logits_last.argmax(-1).to(torch.int32)
        filtered = filter_logits(logits_last / temperature, top_k=top_k,
                                 top_p=top_p)
        # A categorical draw as jax.random.categorical makes it: the
        # argmax of the logits plus Gumbel noise.
        u = torch.rand(filtered.shape, generator=generator, device=dev,
                       dtype=filtered.dtype)
        u = u.clamp_min(torch.finfo(u.dtype).tiny)
        return (filtered - torch.log(-torch.log(u))).argmax(-1).to(
            torch.int32)

    token = sample(logits)
    out = [token]
    # The first token is emitted as-is; a row that emitted EOS is no longer
    # alive and pads from the next token on.
    alive = None if eos_id is None else token != eos_id
    # Decode steps keep passing segment ids (all real), so the cache's pad
    # columns stay masked.
    step_seg = torch.ones(b, 1, dtype=torch.int32, device=dev)
    for t in range(max_new_tokens - 1):
        step_kw = {}
        if lens is not None:
            step_kw = dict(positions=(lens + t)[:, None],
                           segment_ids=step_seg)
        elif learned:
            step_kw = dict(positions=torch.full((b, 1), s + t,
                                                dtype=torch.int32,
                                                device=dev))
        token = sample(decode_step(model, cache, token, **step_kw))
        if alive is not None:
            token = torch.where(alive, token, pad_id)
            alive = alive & (token != eos_id)
        out.append(token)
    return torch.stack(out, dim=1)
