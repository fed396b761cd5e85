"""Memory-efficient (chunked) softmax cross-entropy for large vocabularies.

Port of ``k8s_distributed_deeplearning_tpu/ops/chunked_ce.py``. The plain
LM loss holds f32 logits of shape ``[B, S, V]``: at Llama-3 8B's vocabulary
(V = 128256) and 4 x 2048 tokens that is 4.2 GB, plus as much again for
the softmax. Here the sequence is cut into chunks; each chunk's logits are
reduced to its loss and accuracy sums under one ``torch.utils.checkpoint``,
so the backward recomputes that chunk's logits instead of storing them, and
at most one chunk of logits exists at a time.

The head product keeps the JAX rounding: inputs rounded to the compute
dtype, products summed and returned in f32 (JAX's
``preferred_element_type=jnp.float32``). On the card with bf16 inputs this
is one ``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS, bf16 tensor
cores, f32 output); elsewhere an f32 matmul of the rounded inputs.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils import checkpoint as torch_checkpoint


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and returned in f32, inputs taken as they are."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _HeadLogits(torch.autograd.Function):
    """f32 logits ``x @ w.T`` of compute-dtype ``x [N, D]`` and
    ``w [V, D]``. The backward takes the f32 logit gradient in the compute
    dtype (exact in f32; rounded to bf16 in a bf16 run, as a TPU's
    default-precision f32 matmul rounds it) and returns dx and dw in the
    inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (_mm_f32(g, w).to(x.dtype), _mm_f32(g.t(), x).to(w.dtype))


def _chunk_sums(x, w, targets, mask):
    """One chunk: (masked CE sum, masked correct-prediction sum)."""
    n, c, d = x.shape
    logits = _HeadLogits.apply(x.reshape(n * c, d), w)
    t = targets.reshape(-1)
    ce = F.cross_entropy(logits, t, reduction="none")
    correct = (logits.argmax(-1) == t).float()
    m = mask.reshape(-1)
    return (ce * m).sum(), (correct * m).sum()


def chunked_softmax_cross_entropy(
        x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
        mask: torch.Tensor | None = None, *, chunk_size: int = 1024,
        w_layout: str = "dv", compute_dtype: torch.dtype | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked-mean next-token CE without full-sequence logits.

    x: ``[B, S, D]`` final hidden states; w: the unembedding, ``[D, V]``
    (``w_layout="dv"``) or ``[V, D]`` (``"vd"``); targets: ``[B, S]`` ids;
    mask: ``[B, S]``, 1.0 = position counts (None = all count);
    compute_dtype: the head product's input dtype (default x's).
    Returns ``(loss, accuracy)``, f32 scalars."""
    if w_layout not in ("dv", "vd"):
        raise ValueError(f"w_layout must be 'dv' or 'vd', got {w_layout!r}")
    b, s, _ = x.shape
    dtype = compute_dtype or x.dtype
    w = w.to(dtype)
    if w_layout == "dv":
        w = w.t()
    if mask is None:
        mask = torch.ones(b, s, dtype=torch.float32, device=x.device)
    mask = mask.float()
    targets = targets.long()
    chunk = min(chunk_size, s)
    ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    corr_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        ce, corr = torch_checkpoint.checkpoint(
            _chunk_sums, x[:, sl].to(dtype), w, targets[:, sl], mask[:, sl],
            use_reentrant=False)
        ce_sum = ce_sum + ce
        corr_sum = corr_sum + corr
    denom = mask.sum().clamp_min(1.0)
    return ce_sum / denom, corr_sum / denom
