"""Multi-head attention ops: the einsum path and the flash kernels.

Port of ``k8s_distributed_deeplearning_tpu/ops/attention.py``. Layout is
``[batch, seq, heads, head_dim]``, as in the JAX package; grouped-query
attention takes fewer KV heads than Q heads. Two implementations share one
signature:

- ``impl="xla"``: einsum softmax attention, the plain path, everywhere;
- ``impl="flash"``: :func:`ops.flash_attn.flash_attention`, the
  hand-written CUDA kernels on CUDA tensors (their plain versions on CPU
  tensors).

``impl="auto"`` resolves through :func:`default_impl`.
"""
from __future__ import annotations

import torch

from k8s_distributed_deeplearning_torch.ops import flash_attn


def default_impl(seq_len: int, kv_seq_len: int | None = None,
                 platform: str | None = None, *, head_dim: int) -> str:
    """The ``impl="auto"`` rule (JAX ``default_impl`` with ``cuda`` in the
    place of the TPU): the flash kernels on the card when both sequence
    lengths tile well (>= 1024 and 128-aligned) and a flash kernel takes
    the head dim (``head_dim`` in :data:`flash_attn.HEAD_DIMS`), the
    einsum path otherwise and on the CPU, where flash would run its plain
    version. JAX's flash wrapper computes at any head
    dim; the port's kernels take those in ``HEAD_DIMS``, so on the card a
    model at another head dim (80, 96) takes the einsum path, chosen from
    the shape before any launch. ``platform`` is a device type
    (``"cuda"``, ``"cpu"``); None means the default device."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    kv = seq_len if kv_seq_len is None else kv_seq_len
    well_tiled = all(s >= 1024 and s % 128 == 0 for s in (seq_len, kv))
    if (platform == "cuda" and well_tiled
            and head_dim in flash_attn.HEAD_DIMS):
        return "flash"
    return "xla"


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
    """Dispatch between the einsum path and the flash kernels.
    ``segment_ids`` ([B, S], self-attention) is the packed-sequence mask:
    attend within equal ids; the flash path takes it natively, the einsum
    path expands it to a boolean mask. The flash kernels take no general
    ``mask``: ``impl="auto"`` with one resolves to the einsum path,
    ``impl="flash"`` with one raises. Otherwise ``impl="auto"`` resolves
    per :func:`default_impl` on q's device and head dim; ``impl="flash"``
    at a head dim no flash kernel takes raises on the card."""
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        impl = ("xla" if mask is not None
                else default_impl(q.shape[1], k.shape[1], q.device.type,
                                  head_dim=q.shape[-1]))
    if impl == "flash":
        if mask is not None:
            raise ValueError(
                "impl='flash' takes causal and segment_ids masking only, "
                "not a general mask; use impl='xla' (or 'auto') with a mask")
        return flash_attn.flash_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
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
