"""BERT-family masked-LM encoder.

Port of ``k8s_distributed_deeplearning_tpu/models/bert.py``: the shared
transformer core (``models/transformer.py``) with the BERT recipe:
bidirectional attention, learned positions, LayerNorm, the GELU MLP, and
the MLM head (a dense transform with bias, tanh GELU, LayerNorm, then the
decode TIED to the encoder's ``tok_embed`` plus ``mlm_bias``).
:func:`mask_tokens` draws BERT's 15 % / 80-10-10 masking from a
``torch.Generator`` (JAX draws it from its PRNG key, so masks are not
equal across packages; their proportions are).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from k8s_distributed_deeplearning_torch.models.transformer import (
    Dense, LayerNorm, LMHead, Transformer, TransformerConfig, init_weights)
from k8s_distributed_deeplearning_torch.utils.device import resolve_device


def config_bert_base(**overrides) -> TransformerConfig:
    base = dict(vocab_size=30522, dim=768, n_layers=12, n_heads=12,
                mlp_dim=3072, max_seq_len=512, causal=False,
                activation="gelu", norm="layernorm", position="learned",
                tie_embeddings=True)
    base.update(overrides)
    return TransformerConfig(**base)


def config_tiny(**overrides) -> TransformerConfig:
    base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, mlp_dim=128,
                max_seq_len=64, causal=False, activation="gelu",
                norm="layernorm", position="learned", tie_embeddings=True)
    base.update(overrides)
    return TransformerConfig(**base)


class BertMLM(nn.Module):
    """Encoder + tied MLM head: tokens ``[B, S]`` -> f32 logits ``[B, S,
    V]``. Built on ``device`` (default ``"cuda"``) with random weights
    from ``seed``; :func:`models.convert.bert_from_flax` gives a JAX
    model's instead. Params are kept at ``cfg.resolved_param_dtype``; pass
    ``param_dtype=torch.float32`` in the config to train."""

    def __init__(self, cfg: TransformerConfig, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Transformer(cfg, device=dev)
        self.mlm_dense = Dense(cfg.dim, cfg.dim, dtype=cfg.dtype,
                               param_dtype=cfg.resolved_param_dtype,
                               device=dev, bias=True)
        self.mlm_norm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=dev)
        # The decode ties to the input embedding whatever
        # cfg.tie_embeddings says (BERT semantics): no weight of its own.
        self.mlm_decode = LMHead(dataclasses.replace(cfg,
                                                     tie_embeddings=True))
        self.mlm_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=dev))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def forward(self, tokens: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.encoder(tokens, deterministic=deterministic,
                         generator=generator)
        x = self.mlm_norm(F.gelu(self.mlm_dense(x), approximate="tanh"))
        return (self.mlm_decode(x, self.encoder.tok_embed.weight)
                + self.mlm_bias)


def mask_tokens(tokens: torch.Tensor, generator: torch.Generator, *,
                vocab_size: int, mask_id: int, mask_prob: float = 0.15):
    """Standard BERT masking: select 15 %, of those 80 % -> ``mask_id``,
    10 % a random token, 10 % unchanged; three draws from ``generator``
    (on the tokens' device) in JAX's order. Returns ``(masked_inputs,
    targets, weights)``: targets are the tokens, weights 1.0 where
    selected."""
    dev = tokens.device
    selected = torch.rand(tokens.shape, generator=generator,
                          device=dev) < mask_prob
    action = torch.rand(tokens.shape, generator=generator, device=dev)
    random_tok = torch.randint(0, vocab_size, tokens.shape,
                               generator=generator, device=dev,
                               dtype=tokens.dtype)
    inputs = torch.where(selected & (action < 0.8),
                         torch.full_like(tokens, mask_id), tokens)
    inputs = torch.where(selected & (action >= 0.8) & (action < 0.9),
                         random_tok, inputs)
    return inputs, tokens, selected.float()


def loss_fn(model: BertMLM, batch: dict,
            rng=None) -> tuple[torch.Tensor, dict]:
    """MLM loss over the masked positions (JAX ``bert.loss_fn``):
    ``batch`` {"inputs", "targets", "weights"} from :func:`mask_tokens`.
    The forward runs deterministic. Returns ``(loss, {"accuracy"})``."""
    del rng
    logits = model(batch["inputs"])
    targets = batch["targets"].long()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1),
                         reduction="none").view(targets.shape)
    w = batch["weights"].float()
    denom = w.sum().clamp_min(1.0)
    loss = (ce * w).sum() / denom
    acc = ((logits.argmax(-1) == targets).float() * w).sum() / denom
    return loss, {"accuracy": acc}
