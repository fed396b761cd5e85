"""Multi-head attention ops: the plain einsum path.

Port of ``k8s_distributed_deeplearning_tpu/ops/attention.py``. Layout is
``[batch, seq, heads, head_dim]``, as in the JAX package; grouped-query
attention takes fewer KV heads than Q heads. Only the einsum path
(``impl="xla"`` in the JAX package) exists here: the flash-attention
kernel (``ops/pallas_flash.py``) has not been ported yet, so
``impl="flash"`` raises and ``impl="auto"`` resolves to the einsum path.
"""
from __future__ import annotations

import torch


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Expand KV heads to match Q heads for grouped-query attention."""
    num_kv = k.shape[2]
    if num_kv == num_q_heads:
        return k
    if num_q_heads % num_kv:
        raise ValueError(
            f"{num_q_heads} q heads not divisible by {num_kv} kv heads")
    return k.repeat_interleave(num_q_heads // num_kv, dim=2)


def segment_mask(q_segment_ids: torch.Tensor,
                 kv_segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, Sq] x [B, Sk] segment ids -> [B, 1, Sq, Sk] bool mask (attend
    only within equal ids)."""
    return (q_segment_ids[:, None, :, None]
            == kv_segment_ids[:, None, None, :])


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          mask: torch.Tensor | None = None,
                          softmax_scale: float | None = None
                          ) -> torch.Tensor:
    """Einsum attention. q ``[B, Sq, Hq, D]``, k/v ``[B, Sk, Hkv, D]``,
    mask ``[B, 1|Hq, Sq, Sk]`` bool or additive. Scores accumulate in f32
    whatever the input dtype (the JAX path's ``preferred_element_type``),
    probabilities are cast to v's dtype for P·V, output in q's dtype."""
    sq, hq, d = q.shape[1:]
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        # Offset aligns the causal diagonal when Sq != Sk.
        scores = scores.masked_fill(row + (sk - sq) < col, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         mask: torch.Tensor | None = None,
                         segment_ids: torch.Tensor | None = None,
                         softmax_scale: float | None = None,
                         impl: str = "xla") -> torch.Tensor:
    """Dispatch on ``impl`` (``"auto"`` is the einsum path until the flash
    kernel is ported). ``segment_ids`` ([B, S], self-attention) is the
    packed-sequence mask: attend within equal ids."""
    if impl == "flash":
        raise NotImplementedError(
            "impl='flash' needs the flash-attention kernel, which the "
            "PyTorch port does not have yet; use impl='xla' or 'auto'")
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if segment_ids is not None:
        seg = segment_mask(segment_ids, segment_ids)
        if mask is None:
            mask = seg
        elif mask.dtype == torch.bool:
            mask = mask & seg
        else:
            mask = mask + torch.where(seg, 0.0, float("-inf"))
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 softmax_scale=softmax_scale)
