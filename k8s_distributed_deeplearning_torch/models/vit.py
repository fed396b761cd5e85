"""Vision Transformer (ViT-L/16 flagship).

Port of ``k8s_distributed_deeplearning_tpu/models/vit.py``: a patch
convolution of stride p, the ``[CLS]`` token, learned positions of ``h·w +
1`` rows, the shared transformer core (``models/transformer.py``; no
``tok_embed``, ``position="none"``), ``x[:, 0]`` and a dense head.

Images arrive NHWC, as in JAX, and are permuted to NCHW (a channels-last
view, no copy) for ``F.conv2d``; the patch grid is flattened row-major,
``[B, h·w, dim]``, as flax flattens its NHWC output. The encoder sees
``[B, h·w + 1, dim]``: 197 tokens for ViT-L/16 at 224².
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from k8s_distributed_deeplearning_torch.models import transformer
from k8s_distributed_deeplearning_torch.models.resnet import lecun_normal_
from k8s_distributed_deeplearning_torch.models.transformer import (
    Dense, Transformer, TransformerConfig, init_weights)
from k8s_distributed_deeplearning_torch.utils.device import resolve_device


def config_vit_l16(**overrides) -> TransformerConfig:
    base = dict(vocab_size=1, dim=1024, n_layers=24, n_heads=16,
                mlp_dim=4096, max_seq_len=257, causal=False,
                activation="gelu", norm="layernorm", position="none")
    base.update(overrides)
    return TransformerConfig(**base)


def config_tiny(**overrides) -> TransformerConfig:
    base = dict(vocab_size=1, dim=64, n_layers=2, n_heads=4, mlp_dim=128,
                max_seq_len=65, causal=False, activation="gelu",
                norm="layernorm", position="none")
    base.update(overrides)
    return TransformerConfig(**base)


def flops_per_image(model: "ViT", *, image_size: int = 224) -> float:
    """Approximate fwd+bwd FLOPs per image for MFU: the encoder at the
    image's token count ((H/p)^2 + [CLS]), the patch-embed conv and the
    head."""
    cfg = model.cfg
    tokens = (image_size // model.patch_size) ** 2 + 1
    encoder = transformer.flops_per_token(
        cfg, seq_len=tokens, include_vocab=False) * tokens
    patch = 3.0 * 2 * (model.patch_size ** 2 * 3) * cfg.dim * (tokens - 1)
    head = 3.0 * 2 * cfg.dim * model.num_classes
    return encoder + patch + head


class ViT(nn.Module):
    """Patchify -> [CLS] + learned positions -> encoder -> head: images
    ``[B, image_size, image_size, 3]`` -> f32 logits ``[B, classes]``.

    ``image_size`` sizes ``pos_embed`` (flax sizes it from the input at
    init). Built on ``device`` (default ``"cuda"``) with random weights from
    ``seed`` (``cls_token`` and the head at 0, as flax initialises them);
    :func:`models.convert.vit_from_flax` gives a JAX model's instead."""

    def __init__(self, cfg: TransformerConfig, patch_size: int = 16,
                 num_classes: int = 1000, *, image_size: int = 224,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.patch_size = cfg, patch_size
        self.num_classes = num_classes
        pdt = cfg.resolved_param_dtype
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, cfg.dim, patch_size, patch_size,
                                     device=dev, dtype=pdt)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim, dtype=pdt,
                                                  device=dev))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, n_patches + 1, cfg.dim, dtype=pdt, device=dev))
        self.encoder = Transformer(cfg, device=dev, token_embed=False)
        self.head = Dense(cfg.dim, num_classes, dtype=cfg.dtype,
                          param_dtype=pdt, device=dev, bias=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self.encoder, gen)
        with torch.no_grad():
            lecun_normal_(self.patch_embed.weight, gen)
            self.patch_embed.bias.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
            self.head.weight.zero_()
            self.head.bias.zero_()

    def forward(self, images: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.cfg.dtype
        conv = self.patch_embed
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                     stride=self.patch_size)
        x = x + conv.bias.to(dt)[:, None, None]
        x = x.flatten(2).transpose(1, 2)                  # [B, h*w, dim]
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, x.shape[2])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = self.encoder(x, deterministic=deterministic, generator=generator)
        return self.head(x[:, 0]).float()


def loss_fn(model: ViT, batch: dict, rng=None,
            label_smoothing: float = 0.1) -> tuple[torch.Tensor, dict]:
    """Label-smoothed softmax CE (JAX ``vit.loss_fn``): ``batch``
    {"image": [B, H, W, 3], "label": [B]}; the forward runs deterministic.
    Returns ``(loss, {"accuracy"})``."""
    del rng
    logits = model(batch["image"])
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
    return loss, {"accuracy": (logits.argmax(-1) == labels).float().mean()}
