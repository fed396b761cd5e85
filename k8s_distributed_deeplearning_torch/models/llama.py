"""Llama-3-family causal language model.

Port of ``k8s_distributed_deeplearning_tpu/models/llama.py``: RMSNorm
pre-norm, interleaved-pair RoPE (theta 500k), GQA, SwiGLU MLP, untied
output head, all through :class:`models.transformer.TransformerConfig`;
and the next-token loss (:func:`loss_fn`), unchunked or chunked.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from k8s_distributed_deeplearning_torch.models import transformer
from k8s_distributed_deeplearning_torch.models.transformer import (
    LMHead, Transformer, TransformerConfig, init_weights, lm_batch_views)
from k8s_distributed_deeplearning_torch.utils.device import resolve_device


class LlamaLM(nn.Module):
    """Decoder-only causal LM: tokens -> f32 logits over the vocabulary.

    Built on ``device`` (default ``"cuda"``; ``"cpu"`` must be asked for)
    with random weights drawn from a ``torch.Generator`` seeded with
    ``seed``; :func:`models.convert.from_flax_params` gives the weights of
    a JAX model instead, through ``load_state_dict``."""

    def __init__(self, cfg: TransformerConfig, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.transformer = Transformer(cfg, device=dev)
        self.head = LMHead(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                decode: bool = False, cache: list | None = None,
                cache_positions: torch.Tensor | None = None,
                block_tables: torch.Tensor | None = None,
                return_hidden: bool = False) -> torch.Tensor:
        x = self.transformer(tokens, positions=positions,
                             segment_ids=segment_ids, decode=decode,
                             cache=cache, cache_positions=cache_positions,
                             block_tables=block_tables)
        if return_hidden:
            return x
        return self.logits(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head on final hidden states (any leading shape)."""
        emb = (self.transformer.tok_embed.weight
               if self.cfg.tie_embeddings else None)
        return self.head(hidden, emb)


def config_llama3_8b(**overrides) -> TransformerConfig:
    """Llama-3 8B (public architecture numbers)."""
    base = dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                n_kv_heads=8, mlp_dim=14336, max_seq_len=8192,
                rope_theta=500000.0, activation="swiglu", norm="rmsnorm",
                position="rope", causal=True, remat=True)
    base.update(overrides)
    return TransformerConfig(**base)


def config_tiny(**overrides) -> TransformerConfig:
    """Tiny config with the same topology (GQA, SwiGLU, RoPE) for tests."""
    base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                mlp_dim=128, max_seq_len=128, activation="swiglu",
                norm="rmsnorm", position="rope", causal=True)
    base.update(overrides)
    return TransformerConfig(**base)


def unembedding(cfg: TransformerConfig,
                model: LlamaLM) -> tuple[torch.Tensor, str]:
    """The LM-head weight and its layout: the input embedding ``[V, D]``
    ("vd") when tied, else the head weight, which ``nn.Linear`` also
    stores as ``[V, D]`` — flax's ``[D, V]`` kernel transposed."""
    if cfg.tie_embeddings:
        return model.transformer.tok_embed.weight, "vd"
    return model.head.lm_head.weight, "vd"


def loss_fn(model: LlamaLM, batch: dict, rng=None, *, chunked: bool = False,
            chunk_size: int = 1024) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (JAX ``llama.loss_fn``). ``batch``:
    {"tokens": [B, S] int, optional "mask": [B, S] (1.0 = count this
    position), optional "segment_ids": [B, S] packed-document ids}.
    Position i predicts token i+1; packed rows attend within their
    document, RoPE restarts per document, and cross-document pairs stay out
    of the loss. ``rng`` is the per-replica generator of the train step;
    no layer draws from it yet (dropout is not ported).

    ``chunked=True`` runs :func:`ops.chunked_ce.chunked_softmax_cross_entropy`
    on the final hidden states, so the ``[B, S, V]`` logits never exist.
    Returns ``(loss, {"accuracy", "perplexity"})``, f32 scalars."""
    del rng
    inputs, targets, seg_in, positions, mask = lm_batch_views(batch)
    targets = targets.long()
    kw = dict(segment_ids=seg_in, positions=positions)
    if chunked:
        from k8s_distributed_deeplearning_torch.ops.chunked_ce import (
            chunked_softmax_cross_entropy)
        hidden = model(inputs, return_hidden=True, **kw)
        w, layout = unembedding(model.cfg, model)
        loss, acc = chunked_softmax_cross_entropy(
            hidden, w, targets, mask, chunk_size=chunk_size, w_layout=layout)
        return loss, {"accuracy": acc, "perplexity": torch.exp(loss)}
    logits = model(inputs, **kw)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1), reduction="none").view(
                             targets.shape)
    denom = mask.sum().clamp_min(1.0)
    loss = (ce * mask).sum() / denom
    acc = ((logits.argmax(-1) == targets).float() * mask).sum() / denom
    return loss, {"accuracy": acc, "perplexity": torch.exp(loss)}


def flops_per_token(cfg: TransformerConfig, *,
                    seq_len: int | None = None) -> float:
    """Approximate fwd+bwd FLOPs per token (6N + attention) for MFU:
    :func:`models.transformer.flops_per_token`."""
    return transformer.flops_per_token(cfg, seq_len=seq_len)
