"""Decoder transformer core, the Llama-family path.

Port of ``k8s_distributed_deeplearning_tpu/models/transformer.py``: the
same architecture and the same rounding points, as ``nn.Module``s. Weight
names follow the flax modules (``q_proj``, ``attn_norm``, ``tok_embed``
…) so :mod:`models.convert` maps one tree onto the other leaf for leaf.
Weights are stored at ``param_dtype`` and cast to the compute dtype
``dtype`` at every use, as flax does; norm scales stay f32, as flax
multiplies by them in f32. Training keeps f32 params (``param_dtype=
torch.float32``); serving's default stores weights in the compute dtype,
which rounds identically and halves the weight memory.

Three attention paths exist:

- the plain forward (``decode=False``): :func:`ops.attention
  .multi_head_attention` with ``cfg.attention_impl``, optional packed
  ``segment_ids``. ``"auto"`` runs the flash-attention kernels on the card
  at S >= 1024 and the einsum path elsewhere;
- the PAGED decode branch (``decode=True`` with ``block_tables``): the
  serving engine's path. K/V live in one pool of pages per layer,
  ``[num_pages, page_tokens, kv·hd]``; each token of the chunk is written
  at ``(table[pos // page_tokens], pos % page_tokens)`` and the chunk's
  queries attend the row's pages through
  :func:`ops.paged_attn.paged_decode_attention`. Under ``kv_quant="int8"``
  the pools are int8 with f32 scale siblings ``[num_pages, page_tokens,
  kv]``, written by :func:`quantize_kv` (quantize on write);
- the DENSE decode branch (``decode=True`` without ``block_tables``): the
  one-shot ``generate`` path of :mod:`models.generate`. A
  :class:`DenseCache` holds ``[B, S_cache, kv·hd]`` K/V per layer,
  per-column document ids and one shared cursor. Without
  ``cache_positions`` the chunk is appended at the cursor and query
  ``cur + i`` sees columns ``<= cur + i`` of its own document; with them
  (slot mode) row ``b``'s token ``i`` lands at column ``cache_positions[b]
  + i`` and sees the columns up to it. Attention is the einsum path
  whatever ``cfg.attention_impl`` says, as JAX runs XLA attention there.

A :class:`Dense` may hold an int8 weight and its f32 scales instead of its
weight (``serve/quant.py``); it then dequantizes at every use.

``remat`` checkpoints each block in the plain forward
(``torch.utils.checkpoint``), with the JAX package's policies: ``"dots"``
saves the outputs of the projection matmuls and of the MoE grouped matmul
(``k8s_ddl_torch::gmm``) and recomputes everything else (the flash forward
included), ``"dots_attn"`` also saves the attention output, ``"nothing"``
saves nothing.

``Block`` and ``Transformer`` take an ``mlp_factory`` that swaps the dense
MLP (the MoE layer of ``models/moe.py``); the factory's module is called
with ``decode`` and with the ``aux`` collector the caller passes down.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as torch_checkpoint

from k8s_distributed_deeplearning_torch.ops import attention as attention_ops
from k8s_distributed_deeplearning_torch.ops import flash_attn  # noqa: F401
from k8s_distributed_deeplearning_torch.ops import gmm  # noqa: F401
from k8s_distributed_deeplearning_torch.ops import paged_attn


@torch.library.custom_op("k8s_ddl_torch::attn_out", mutates_args=())
def attn_out(x: torch.Tensor) -> torch.Tensor:
    """The attention output, tagged for the ``"dots_attn"`` remat policy
    (JAX ``checkpoint_name(out, "attn_out")``): an operator of its own so
    the checkpoint policy can save exactly this tensor."""
    return x.clone()


attn_out.register_autograd(lambda ctx, grad: grad)

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default,
         torch.ops.k8s_ddl_torch.gmm.default)
# Operators whose outputs each policy saves through remat. "dots" is JAX's
# dots_with_no_batch_dims_saveable: the projection matmuls (aten.mm), not
# the batched attention products (aten.bmm), plus the MoE grouped matmul,
# as JAX's policy saves the outputs tagged "gmm_out": without it remat
# replays all three grouped GEMMs of a layer. "dots_attn" adds the tagged
# attention output and the flash forward, whose rerun it exists to skip.
# "nothing" is plain checkpointing.
REMAT_POLICIES = {
    "dots": _DOTS,
    "dots_attn": _DOTS + (torch.ops.k8s_ddl_torch.attn_out.default,
                          torch.ops.k8s_ddl_torch.flash_fwd.default),
    "nothing": (),
}


def _remat_context(saved: tuple):
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture knobs, as in the JAX package (scan, dropout and
    serving TP are not here)."""

    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int | None = None       # < n_heads => GQA
    head_dim: int | None = None         # default dim // n_heads
    mlp_dim: int | None = None          # default 4*dim
    max_seq_len: int = 2048
    causal: bool = True
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    position: str = "rope"              # "rope" | "none"
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype | None = None  # weight storage; None = dtype
                                        # (serving); training keeps f32
    attention_impl: str = "auto"        # "auto": the paged decode branch
                                        # calls the paged-attention kernel
                                        # wrapper (kernel on CUDA tensors,
                                        # plain version on CPU tensors);
                                        # "xla": the plain version always,
                                        # the reference path of a
                                        # kernel-vs-reference comparison.
                                        # The plain forward: "auto" picks
                                        # flash on the card at S >= 1024
                                        # (ops.attention.default_impl)
    remat: bool = False                 # checkpoint each block
    remat_policy: str = "dots"          # "dots" | "dots_attn" | "nothing"
    kv_quant: str | None = None         # "int8": the paged pools hold int8
                                        # K/V plus per-token-per-head f32
                                        # scales, quantized on write and
                                        # dequantized on read. None: pools
                                        # of the compute dtype

    def __post_init__(self):
        if self.activation != "swiglu":
            raise NotImplementedError(
                f"activation={self.activation!r}: the port has the SwiGLU "
                "MLP only so far")
        if self.norm != "rmsnorm":
            raise NotImplementedError(
                f"norm={self.norm!r}: the port has RMSNorm only so far")
        if self.position not in ("rope", "none"):
            raise NotImplementedError(
                f"position={self.position!r}: the port has RoPE or none")
        if self.attention_impl not in ("auto", "xla", "flash"):
            raise ValueError(
                f"attention_impl must be 'auto', 'xla' or 'flash', got "
                f"{self.attention_impl!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                f"got {self.remat_policy!r}")
        if self.kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {self.kv_quant!r}")

    @property
    def resolved_param_dtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @property
    def resolved_kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def resolved_mlp_dim(self) -> int:
        return self.mlp_dim or 4 * self.dim


class RMSNorm(nn.Module):
    """Root-mean-square norm: variance in f32, times the f32 scale, then
    cast to the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(self.dtype)


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` whose weight is stored at ``param_dtype``
    and cast, with the input, to the compute ``dtype`` at every use (flax
    ``Dense(dtype=..., param_dtype=...)``).

    After :meth:`set_int8` the weight is int8 and ``weight_scale`` holds
    ``c`` f32 scales, ``c`` dividing ``out_features``: row ``r`` uses
    ``weight_scale[r % c]``. Each use then computes the weight as
    ``(f32(int8) * scale).to(dtype)``, what the JAX engine feeds flax after
    dequantizing its params."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=param_dtype)
        self.compute_dtype = dtype
        self.register_buffer("weight_scale", None)

    def set_int8(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Replace the weight by ``q`` (int8, ``[out, in]``) and its scales
        (f32 ``[c]``); the old weight is released."""
        self.weight = nn.Parameter(q, requires_grad=False)
        self.weight_scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Dtype checks in Python, not no-op .to() calls: serving's decode
        # step is host-bound, and stores weights in the compute dtype.
        w, dt = self.weight, self.compute_dtype
        if w.dtype == torch.int8:
            # One op: int8 x f32 promotes to f32, rounded once to dt.
            s = self.weight_scale
            g = w.shape[0] // s.shape[0]
            deq = torch.empty((g, s.shape[0], w.shape[1]), dtype=dt,
                              device=w.device)
            torch.mul(w.view(g, s.shape[0], -1), s[None, :, None], out=deq)
            w = deq.view(w.shape)
        return F.linear(x if x.dtype == dt else x.to(dt),
                        w if w.dtype == dt else w.to(dt))


class Embed(nn.Embedding):
    """Token embedding stored at ``param_dtype``; the gathered rows are
    cast to the compute ``dtype`` (flax ``Embed``)."""

    def __init__(self, num: int, dim: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__(num, dim, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = super().forward(tokens)
        return x if x.dtype == self.compute_dtype else x.to(self.compute_dtype)


def packed_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-document positions for packed rows: positions restart at 0 at
    each document start."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device)[None, :].expand(b, s)
    is_start = torch.ones_like(segment_ids, dtype=torch.bool)
    is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    doc_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - doc_start


def lm_batch_views(batch) -> tuple:
    """Next-token-LM batch preamble (JAX ``lm_batch_views``): shift tokens
    (position i predicts i+1), slice packed segment ids, derive
    per-document positions, and build the loss mask (optional caller
    "mask" times the cross-document boundary-pair exclusion). Returns
    (inputs, targets, seg_in, positions, mask); seg_in/positions are None
    for unpacked batches."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    seg = batch.get("segment_ids")
    seg_in = None if seg is None else seg[:, :-1]
    positions = None if seg_in is None else packed_positions(seg_in)
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=tokens.device)
            if mask is None else mask[:, 1:].float())
    if seg is not None:
        mask = mask * (seg[:, :-1] == seg[:, 1:]).float()
    return inputs, targets, seg_in, positions, mask


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables, shape [max_seq_len, head_dim/2], f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def _rope_at(cos, sin, positions, s):
    """cos/sin rows for a [B, S] (or None => 0..S-1) position grid, shaped
    [B|1, S, 1, D/2]. Positions past the table are clamped to its last row,
    as the JAX gather clamps: only right-pad tokens reach them, and their
    outputs are never read."""
    if positions is None:
        cos_p, sin_p = cos[:s][None], sin[:s][None]
    else:
        idx = positions.long().clamp(0, cos.shape[0] - 1)
        cos_p, sin_p = cos[idx], sin[idx]
    return cos_p[:, :, None, :], sin_p[:, :, None, :]


def _rotate(x, cos_p, sin_p):
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    r1 = x1 * cos_p - x2 * sin_p
    r2 = x2 * cos_p + x1 * sin_p
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate INTERLEAVED pairs (x[..., ::2], x[..., 1::2]) by
    position-dependent angles. x: [B, S, H, D]; cos/sin: [max_seq, D/2];
    positions: [B, S] or None (0..S-1). Rotation in f32, cast back."""
    return _rotate(x, *_rope_at(cos, sin, positions, x.shape[1]))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize on write (JAX ``transformer.py:486-499``): per token and
    head, symmetric absmax over the last (head_dim) axis. Returns the int8
    values and the f32 scales ``absmax / 127`` (shape ``x.shape[:-1]``)."""
    w = x.float()
    scale = w.abs().amax(-1) / 127.0
    q = torch.round(w / torch.where(scale > 0.0, scale, 1.0)[..., None])
    return q.clamp_(-127, 127).to(torch.int8), scale


@dataclasses.dataclass
class PagedWrite:
    """Per-forward paged-pool addressing, shared by every layer: each
    chunk token's absolute position, and the (page, offset) cell it writes.
    Tokens whose block lies past the table's end write to scratch page 0."""

    tables: torch.Tensor     # [B, n_blocks] int32, contiguous
    positions: torch.Tensor  # [B, sq] int32, contiguous
    page: torch.Tensor       # [B, sq] int64
    offset: torch.Tensor     # [B, sq] int64

    @classmethod
    def build(cls, block_tables: torch.Tensor, positions: torch.Tensor,
              page_tokens: int) -> "PagedWrite":
        tables = block_tables.to(torch.int32).contiguous()
        wpos = positions.to(torch.int32).contiguous()
        n_blocks = tables.shape[1]
        blk = wpos.long() // page_tokens
        pg = torch.gather(tables, 1, blk.clamp_max(n_blocks - 1)).long()
        pg = torch.where(blk >= n_blocks, 0, pg)          # scratch page
        return cls(tables, wpos, pg, wpos.long() % page_tokens)


@dataclasses.dataclass
class DenseCache:
    """The dense KV cache of one batch (JAX ``cached_key``,
    ``cached_value``, ``cached_seg`` and ``cache_index``), written in place
    by every decode forward. K/V are ``[B, S_cache, kv·hd]`` at the compute
    dtype, one pair a layer, heads folded into the last axis as in JAX.
    ``seg`` holds each column's document id (0: left padding, never
    attended), all ones at creation; JAX keeps an identical copy in every
    layer. ``index`` is the shared cursor, a host int, so reading it costs
    no device sync. Slot mode (``cache_positions``) leaves ``seg`` and
    ``index`` as they are."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]
    seg: torch.Tensor
    index: int = 0

    @classmethod
    def create(cls, cfg: TransformerConfig, batch: int, length: int,
               device=None) -> "DenseCache":
        shape = (batch, length,
                 cfg.resolved_kv_heads * cfg.resolved_head_dim)
        return cls(
            [torch.zeros(shape, dtype=cfg.dtype, device=device)
             for _ in range(cfg.n_layers)],
            [torch.zeros(shape, dtype=cfg.dtype, device=device)
             for _ in range(cfg.n_layers)],
            torch.ones(batch, length, dtype=torch.int32, device=device))

    @property
    def length(self) -> int:
        return self.seg.shape[1]


@dataclasses.dataclass
class DenseWrite:
    """Per-forward dense-cache addressing, shared by every layer: where the
    chunk's K/V land in each ``[B, S_cache, kv·hd]`` buffer (a column
    slice at the shared cursor, or each token's (row, column) in slot
    mode), and the boolean mask ``[B, 1, sq, S_cache]`` of the columns
    each query attends."""

    index: tuple
    mask: torch.Tensor

    @classmethod
    def build(cls, cache: DenseCache, sq: int, *,
              segment_ids: torch.Tensor | None,
              cache_positions: torch.Tensor | None,
              positions: torch.Tensor | None) -> tuple["DenseWrite",
                                                       torch.Tensor]:
        """The addressing of one forward and the RoPE positions of its
        tokens. Shared-cursor mode also does the forward's bookkeeping,
        once for all layers: it writes ``segment_ids`` (when given) into
        ``cache.seg`` at the cursor and advances the cursor by ``sq``."""
        dev = cache.seg.device
        col = torch.arange(cache.length, device=dev)
        steps = torch.arange(sq, device=dev)
        if cache_positions is not None:
            if positions is None:
                positions = cache_positions.long()[:, None] + steps[None]
            wpos = positions.long()
            mask = (col[None, None, :] <= wpos[:, :, None])[:, None]
            rows = torch.arange(wpos.shape[0], device=dev)[:, None]
            return cls((rows, wpos), mask), positions
        cur = cache.index
        if cur + sq > cache.length:
            raise ValueError(
                f"a {sq}-token chunk at cursor {cur} overflows the "
                f"{cache.length}-column dense KV cache")
        row_pos = cur + steps
        base = (col[None, :] <= row_pos[:, None])[None, None]   # [1,1,sq,S]
        diag = (col[None, :] == row_pos[:, None])[None, None]
        if segment_ids is not None:
            # Same-document columns only (pads are id 0, never a query's
            # id). The diagonal keeps each query's own column, so even an
            # all-pad row has one finite score: without it the row's NaN
            # reaches its K/V in the next layer, and 0 x NaN in P.V then
            # poisons every row that masks it out.
            seg_now = segment_ids.to(torch.int32)
            cache.seg[:, cur:cur + sq] = seg_now
            same = cache.seg[:, None, None, :] == seg_now[:, None, :, None]
            mask = (base & same) | diag
        else:
            # The safety net for a caller that prefilled with segment ids
            # and steps without them: pad columns (id 0) stay invisible.
            mask = (base & (cache.seg[:, None, None, :] != 0)) | diag
        if positions is None:
            positions = row_pos[None]
        cache.index = cur + sq
        return cls((slice(None), slice(cur, cur + sq)), mask), positions


class Attention(nn.Module):
    """Multi-head / grouped-query attention with RoPE. Projection weights
    are ``nn.Linear`` ``[out, in]``: flax's ``[D, H, hd]`` q/k/v kernels
    and ``[H, hd, D]`` o_proj kernel, flattened and transposed."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, kv = cfg.resolved_head_dim, cfg.resolved_kv_heads
        kw = dict(device=device, dtype=cfg.dtype,
                  param_dtype=cfg.resolved_param_dtype)
        self.q_proj = Dense(cfg.dim, cfg.n_heads * hd, **kw)
        self.k_proj = Dense(cfg.dim, kv * hd, **kw)
        self.v_proj = Dense(cfg.dim, kv * hd, **kw)
        self.o_proj = Dense(cfg.n_heads * hd, cfg.dim, **kw)

    def forward(self, x: torch.Tensor, *, rope, mask=None, segment_ids=None,
                cache=None, paged: PagedWrite | None = None,
                dense: DenseWrite | None = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        hd, kv = cfg.resolved_head_dim, cfg.resolved_kv_heads
        q = self.q_proj(x).view(b, s, cfg.n_heads, hd)
        k = self.k_proj(x).view(b, s, kv, hd)
        v = self.v_proj(x).view(b, s, kv, hd)
        if rope is not None:
            q = _rotate(q, *rope)
            k = _rotate(k, *rope)
        if paged is not None:
            out = self._paged(q, k, v, cache, paged)
        elif dense is not None:
            out = self._dense(q, k, v, cache, dense)
        else:
            out = attention_ops.multi_head_attention(
                q, k, v, causal=cfg.causal, mask=mask,
                segment_ids=segment_ids, impl=cfg.attention_impl)
            if cfg.remat and cfg.remat_policy == "dots_attn":
                out = attn_out(out)
        return self.o_proj(out.reshape(b, s, cfg.n_heads * hd))

    def _dense(self, q, k, v, cache, dense: DenseWrite) -> torch.Tensor:
        """Write the chunk's K/V into this layer's dense cache at the
        forward's columns, then attend the whole cache under its mask on
        the einsum path (JAX ``impl="xla"``)."""
        keys, values = cache
        b, s, kv, hd = k.shape
        keys[dense.index] = k.reshape(b, s, kv * hd)
        values[dense.index] = v.reshape(b, s, kv * hd)
        width = keys.shape[1]
        return attention_ops.multi_head_attention(
            q, keys.view(b, width, kv, hd), values.view(b, width, kv, hd),
            causal=False, mask=dense.mask, impl="xla")

    def _paged(self, q, k, v, cache, paged: PagedWrite) -> torch.Tensor:
        """Write the chunk's K/V into the pool, then attend the rows' pages.
        In place: the JAX serving programs donate the pool and get it back
        updated; here the engine's pool tensors are written directly. Every
        token owns its (page, offset) cell and, under int8, its scale cell,
        except pads redirected to the scratch page, which nothing
        attends."""
        cfg = self.cfg
        b, s, kv, hd = k.shape
        idx = (paged.page, paged.offset)
        xla = cfg.attention_impl == "xla"
        if cfg.kv_quant != "int8":
            pool_k, pool_v = cache
            pool_k.index_put_(idx, k.reshape(b, s, kv * hd).to(pool_k.dtype))
            pool_v.index_put_(idx, v.reshape(b, s, kv * hd).to(pool_v.dtype))
            attend = (paged_attn.paged_decode_attention_reference if xla
                      else paged_attn.paged_decode_attention)
            return attend(q, pool_k, pool_v, paged.tables, paged.positions)
        pool_k, pool_v, k_scale, v_scale = cache
        for pool, scales, x in ((pool_k, k_scale, k), (pool_v, v_scale, v)):
            xq, xs = quantize_kv(x)
            pool.index_put_(idx, xq.reshape(b, s, kv * hd))
            scales.index_put_(idx, xs)
        if not xla:
            return paged_attn.paged_decode_attention(
                q, pool_k, pool_v, paged.tables, paged.positions,
                k_scale=k_scale, v_scale=v_scale)
        # The JAX XLA branch: gather the rows' pages, dequantize them to the
        # compute dtype, then fp attention over the gathered pages (a pool
        # of B x n_blocks pages addressed in order).
        tables = paged.tables.long()
        n_pages = tables.numel()
        shape = (n_pages,) + tuple(pool_k.shape[1:])

        def gathered(pool, scales):
            x = pool[tables].float().reshape(n_pages, -1, kv, hd)
            x = x * scales[tables].reshape(n_pages, -1, kv, 1)
            return x.to(cfg.dtype).reshape(shape)

        order = torch.arange(n_pages, dtype=torch.int32,
                             device=tables.device).view(tables.shape)
        return paged_attn.paged_decode_attention_reference(
            q, gathered(pool_k, k_scale), gathered(pool_v, v_scale), order,
            paged.positions)


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype,
                  param_dtype=cfg.resolved_param_dtype)
        m = cfg.resolved_mlp_dim
        self.gate_proj = Dense(cfg.dim, m, **kw)
        self.up_proj = Dense(cfg.dim, m, **kw)
        self.down_proj = Dense(m, cfg.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + mlp(norm(x)).

    ``mlp_factory(cfg, device=...)`` swaps the feed-forward module (the MoE
    layer) while the norms and residuals stay shared. Its module is called
    with ``decode`` and ``aux`` (the caller's collector of per-layer
    auxiliary losses, or None); the plain :class:`MLP` takes neither."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 mlp_factory=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.custom_mlp = mlp_factory is not None
        self.mlp = (mlp_factory(cfg, device=device) if self.custom_mlp
                    else MLP(cfg, device=device))

    def forward(self, x, *, decode: bool = False, aux=None, **attn_kw):
        x = x + self.attn(self.attn_norm(x), **attn_kw)
        h = self.mlp_norm(x)
        if self.custom_mlp:
            return x + self.mlp(h, decode=decode, aux=aux)
        return x + self.mlp(h)


class Transformer(nn.Module):
    """Tokens in, final-normed hidden states out.

    ``decode=True`` with ``block_tables`` ([B, n_blocks] int32) and
    ``cache`` (one ``(pool_k, pool_v)`` pair per layer, written in place)
    selects the paged serving branch. Its write positions are
    ``positions`` ([B, S]) or, for slot decode, ``cache_positions[:, None]
    + arange(S)`` ([B] cursors). ``decode=True`` without ``block_tables``
    selects the dense branch: ``cache`` is a :class:`DenseCache`
    (:func:`models.generate.prefill` creates one), slot mode when
    ``cache_positions`` is given, else the shared cursor, which advances
    by S; ``segment_ids`` there are the chunk's document ids (0 = pad).
    ``mlp_factory`` reaches every block; ``aux`` is handed to each block's
    factory MLP."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 mlp_factory=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.dim, device=device,
                               dtype=cfg.dtype,
                               param_dtype=cfg.resolved_param_dtype)
        self.blocks = nn.ModuleList(
            [Block(cfg, device=device, mlp_factory=mlp_factory)
             for _ in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.dim, dtype=cfg.dtype, device=device)
        if cfg.position == "rope":
            cos, sin = rope_frequencies(cfg.resolved_head_dim,
                                        cfg.max_seq_len, cfg.rope_theta,
                                        device=device)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, tokens: torch.Tensor, *,
                mask: torch.Tensor | None = None,
                positions: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                decode: bool = False,
                cache: list | None = None,
                cache_positions: torch.Tensor | None = None,
                block_tables: torch.Tensor | None = None,
                aux=None) -> torch.Tensor:
        cfg = self.cfg
        b, s = tokens.shape
        paged = dense = None
        if decode and block_tables is None:
            if mask is not None:
                raise NotImplementedError(
                    "decode mode builds its own cache-prefix mask and local "
                    "attention; a caller-provided mask/attention_fn would be "
                    "silently wrong")
            if cache_positions is not None and segment_ids is not None:
                raise NotImplementedError(
                    "slot decode isolates rows by construction (each slot "
                    "is one request); segment_ids have no meaning here")
            if not isinstance(cache, DenseCache):
                raise ValueError(
                    "dense decode (no block_tables) requires a DenseCache "
                    "(models.generate.prefill creates one)")
            dense, positions = DenseWrite.build(
                cache, s, segment_ids=segment_ids,
                cache_positions=cache_positions, positions=positions)
            segment_ids = None     # consumed into the cache mask
        elif decode:
            per_layer = 4 if cfg.kv_quant == "int8" else 2
            if (not isinstance(cache, (list, tuple))
                    or len(cache) != cfg.n_layers
                    or any(len(c) != per_layer for c in cache)):
                raise ValueError(
                    "paged decode requires the engine's page pool: one "
                    "(pool_k, pool_v) pair per layer, or under "
                    "kv_quant='int8' (pool_k, pool_v, k_scale, v_scale)")
            if mask is not None or segment_ids is not None:
                raise NotImplementedError(
                    "paged decode isolates rows by block tables and builds "
                    "its own cursor mask; mask/segment_ids have no meaning")
            if positions is None:
                if cache_positions is None:
                    raise ValueError(
                        "paged chunk prefill requires explicit positions; "
                        "only slot decode derives them from cache_positions")
                positions = (cache_positions.long()[:, None]
                             + torch.arange(s, device=tokens.device)[None])
            paged = PagedWrite.build(block_tables, positions,
                                     cache[0][0].shape[-2])
        elif cache_positions is not None or block_tables is not None:
            raise ValueError("cache_positions/block_tables require decode")
        rope = None
        if cfg.position == "rope":
            rope = _rope_at(self.rope_cos, self.rope_sin, positions, s)
        x = self.tok_embed(tokens)
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            layer_cache = None
            if paged is not None:
                layer_cache = cache[i]
            elif dense is not None:
                layer_cache = (cache.keys[i], cache.values[i])
            kw = dict(rope=rope, mask=mask, segment_ids=segment_ids,
                      cache=layer_cache, paged=paged, dense=dense,
                      decode=decode, aux=aux)
            if remat:
                saved = REMAT_POLICIES[cfg.remat_policy]
                if saved:
                    kw["context_fn"] = functools.partial(_remat_context,
                                                         saved)
                x = torch_checkpoint.checkpoint(block, x, use_reentrant=False,
                                                **kw)
            else:
                x = block(x, **kw)
        return self.final_norm(x)


def flops_per_token(cfg: TransformerConfig, *, seq_len: int | None = None,
                    include_vocab: bool = True) -> float:
    """Approximate fwd+bwd FLOPs per token for MFU accounting (6N +
    attention), as the JAX package counts them: QKV/O projections, the MLP
    matmuls (3 for SwiGLU), the S^2 score and P·V term at the actual
    sequence length (full S^2, so causal MFU is conservative), and the
    unembedding matmul."""
    hd = cfg.resolved_head_dim
    s = seq_len or cfg.max_seq_len
    n_mlp_matmuls = 3 if cfg.activation == "swiglu" else 2
    per_layer = (
        2 * cfg.dim * cfg.n_heads * hd                    # q proj
        + 2 * 2 * cfg.dim * cfg.resolved_kv_heads * hd    # k, v proj
        + 2 * cfg.n_heads * hd * cfg.dim                  # o proj
        + n_mlp_matmuls * 2 * cfg.dim * cfg.resolved_mlp_dim
        + 2 * 2 * cfg.n_heads * hd * s                    # scores + PV
    )
    vocab = 2 * cfg.dim * cfg.vocab_size if include_vocab else 0
    return 3.0 * (cfg.n_layers * per_layer + vocab)


class LMHead(nn.Module):
    """Hidden states -> f32 vocab logits. Untied: the matmul runs in the
    compute dtype and the result is cast to f32, as in the JAX head. Tied:
    f32 accumulation against the input embedding cast to the compute
    dtype."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.dim, cfg.vocab_size, device=device,
                                 dtype=cfg.dtype,
                                 param_dtype=cfg.resolved_param_dtype)

    def forward(self, x: torch.Tensor,
                embedding: torch.Tensor | None = None) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            if embedding is None:
                raise ValueError("tie_embeddings requires the embedding table")
            return F.linear(x.float(), embedding.to(self.cfg.dtype).float())
        return self.lm_head(x).float()


@torch.no_grad()
def glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax ``xavier_uniform`` on a kernel laid out ``[..., in, out]``:
    the leading axes fold into both fans (fan_in = in x rest, fan_out =
    out x rest), so a 3-D expert tensor [E, d, m] draws from
    +-sqrt(6 / ((d + m) E))."""
    rest = w.numel() // (w.shape[-2] * w.shape[-1])
    limit = math.sqrt(6.0 / ((w.shape[-2] + w.shape[-1]) * rest))
    w.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, with the JAX package's families:
    Glorot-uniform projections, N(0, 0.02) embeddings, unit norm scales.
    A module with a ``reset_from(generator)`` method (the MoE layer) draws
    its own."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            glorot_uniform_(m.weight, generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, RMSNorm):
            m.scale.fill_(1.0)
        elif hasattr(m, "reset_from"):
            m.reset_from(generator)
