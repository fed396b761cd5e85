"""ResNet-v1.5 family (ResNet-50 flagship).

Port of ``k8s_distributed_deeplearning_tpu/models/resnet.py``: bottleneck
blocks with the v1.5 stride in the 3x3, a zero-initialised last norm scale
in each block, the ``conv7`` stem (7x7/s2) or the ``s2d`` one (a 2x2
space-to-depth fold, then a 4x4/s1 conv), 3x3/s2 max pool, global average
pool and a dense head; compute in ``dtype`` (bf16 by default), params f32.

Images arrive NHWC, as in JAX. Inside, activations are NCHW tensors laid
out channels-last in memory (the NHWC input permuted, no copy), so
``F.conv2d`` runs cuDNN's NHWC kernels on the card. Convolutions copy
flax's ``"SAME"`` padding, which is asymmetric for a 3x3/s2 conv on an
even input (0 before, 1 after) and for the 4x4 s2d stem (1, 2).

Norms (``norm=``), each with flax's semantics rather than
``torch.nn.BatchNorm2d``'s:

- ``"batch"``: flax ``nn.BatchNorm`` (momentum 0.9, epsilon 1e-5). In
  training the statistics are the batch's, mean and E[x^2] - E[x]^2 in
  f32 clipped at 0, and the running variance takes that BIASED variance
  (``BatchNorm2d`` keeps the unbiased one); the output is ``(x - mean) *
  (rsqrt(var + eps) * scale) + bias`` in f32, cast to ``dtype``;
- ``"ghost"``: the JAX package's ``GhostBatchNorm``: the statistics of the
  first ``stats_examples`` examples only, then one per-channel affine in
  ``dtype``;
- ``"group"``: flax ``nn.GroupNorm(32, epsilon 1e-5)``, no running
  statistics.

A forward with ``train=True`` never writes the running statistics: given a
``batch_stats`` dict it fills it with each BatchNorm's NEW running mean and
variance by buffer name (``"blocks.stage1_block0.bn1.mean"`` ...), what
flax's ``mutable=["batch_stats"]`` returns; the train step averages them
across replicas and writes them into the buffers
(``parallel.data_parallel.make_stats_train_step``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from k8s_distributed_deeplearning_torch.utils.device import resolve_device


def _stats_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to at least f32, where flax computes statistics."""
    return x if x.dtype == torch.float64 else x.float()


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default conv/dense kernel init (``lecun_normal``): a normal
    truncated at two standard deviations, variance 1 / fan_in (fan_in =
    in-channels x kernel area; ``w`` is ``[out, in, ...]``)."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Conv(nn.Module):
    """Flax ``nn.Conv`` without bias: an OIHW f32 weight, input and weight
    cast to ``dtype``, padding ``"SAME"`` (flax's default, computed from
    the input's size) or explicit ``(before, after)`` pairs."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", *, dtype: torch.dtype, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            cout, cin, kernel, kernel, dtype=torch.float32, device=device))

    def reset_from(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            (t, b), (lft, r) = (_same_padding(x.shape[2], k, self.stride),
                                _same_padding(x.shape[3], k, self.stride))
        else:
            (t, b), (lft, r) = self.padding
        if (t, lft) == (b, r):
            return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                            padding=(t, lft))
        return F.conv2d(F.pad(x, (lft, r, t, b)), self.weight.to(self.dtype),
                        stride=self.stride)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (``stats_examples=None``) or the JAX package's
    ``GhostBatchNorm`` (statistics of the first ``stats_examples``
    examples) over NCHW: f32 ``scale``/``bias`` parameters and ``mean``/
    ``var`` buffers (0 and 1 at creation)."""

    def __init__(self, c: int, *, dtype: torch.dtype, momentum: float = 0.9,
                 eps: float = 1e-5, stats_examples: int | None = None,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.stats_examples, self.zero_scale = stats_examples, zero_scale
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(c, **f32))
        self.bias = nn.Parameter(torch.zeros(c, **f32))
        self.register_buffer("mean", torch.zeros(c, **f32))
        self.register_buffer("var", torch.ones(c, **f32))
        self.stats_name = ""             # set by ResNet: its buffer prefix

    def reset_from(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool,
                batch_stats: dict | None) -> torch.Tensor:
        if not train:
            mean, var = self.mean, self.var
        else:
            # flax BatchNorm promotes to at least f32; GhostBatchNorm casts
            # its subset to f32 whatever the dtype.
            xs = (_stats_dtype(x) if self.stats_examples is None
                  else x[:self.stats_examples].float())
            mean = xs.mean((0, 2, 3))
            var = (xs.square().mean((0, 2, 3))
                   - mean.square()).clamp_min(0.0)
            if batch_stats is not None:
                m = self.momentum
                batch_stats[self.stats_name + "mean"] = (
                    m * self.mean + (1 - m) * mean.detach())
                batch_stats[self.stats_name + "var"] = (
                    m * self.var + (1 - m) * var.detach())
        c = (1, -1, 1, 1)
        if self.stats_examples is None:
            mul = torch.rsqrt(var + self.eps) * self.scale
            return ((_stats_dtype(x) - mean.view(c)) * mul.view(c)
                    + self.bias.view(c)).to(self.dtype)
        inv = self.scale * torch.rsqrt(var + self.eps)
        return (x * inv.to(self.dtype).view(c)
                + (self.bias - mean * inv).to(self.dtype).view(c))


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(num_groups=32, epsilon=1e-5)`` over NCHW: each
    example's group statistics in f32 (E[x^2] - E[x]^2, clipped at 0),
    then flax's normalize with f32 ``scale`` and ``bias``."""

    def __init__(self, c: int, *, dtype: torch.dtype, groups: int = 32,
                 eps: float = 1e-5, zero_scale: bool = False, device=None):
        super().__init__()
        self.dtype, self.groups, self.eps = dtype, groups, eps
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(c, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=torch.float32,
                                             device=device))

    reset_from = BatchNorm.reset_from

    def forward(self, x: torch.Tensor, train: bool,
                batch_stats: dict | None) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = _stats_dtype(x).reshape(b, self.groups, c // self.groups, h, w)
        mean = xg.mean((2, 3, 4), keepdim=True)
        var = (xg.square().mean((2, 3, 4), keepdim=True)
               - mean.square()).clamp_min(0.0)
        shape = (1, self.groups, c // self.groups, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.scale.view(shape)
        y = (xg - mean) * mul + self.bias.view(shape)
        return y.reshape(b, c, h, w).to(self.dtype)


def make_norm(norm: str, c: int, *, dtype: torch.dtype,
              stats_examples: int = 32, zero_scale: bool = False,
              device=None) -> nn.Module:
    """The ResNet norm layer: ``"batch"`` | ``"ghost"`` | ``"group"``."""
    kw = dict(dtype=dtype, zero_scale=zero_scale, device=device)
    if norm == "batch":
        return BatchNorm(c, **kw)
    if norm == "ghost":
        return BatchNorm(c, stats_examples=stats_examples, **kw)
    if norm == "group":
        return GroupNorm(c, **kw)
    raise ValueError(f"norm must be 'batch', 'ghost' or 'group', got {norm!r}")


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride here, v1.5) -> 1x1 x4, each conv followed by its
    norm; the last norm's scale starts at 0, so the residual branch starts
    as the identity. A 1x1 strided projection (and its norm) meets the
    residual where the shapes differ."""

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, norm: str, stats_examples: int,
                 device=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        nrm = dict(dtype=dtype, stats_examples=stats_examples,
                   device=device)
        self.conv1 = Conv(cin, filters, 1, **conv)
        self.bn1 = make_norm(norm, filters, **nrm)
        self.conv2 = Conv(filters, filters, 3, stride, **conv)
        self.bn2 = make_norm(norm, filters, **nrm)
        self.conv3 = Conv(filters, 4 * filters, 1, **conv)
        self.bn3 = make_norm(norm, 4 * filters, zero_scale=True, **nrm)
        self.project = cin != 4 * filters or stride != 1
        if self.project:
            self.downsample_conv = Conv(cin, 4 * filters, 1, stride, **conv)
            self.downsample_bn = make_norm(norm, 4 * filters, **nrm)

    def forward(self, x: torch.Tensor, train: bool,
                batch_stats: dict | None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, batch_stats))
        y = F.relu(self.bn2(self.conv2(y), train, batch_stats))
        y = self.bn3(self.conv3(y), train, batch_stats)
        if self.project:
            x = self.downsample_bn(self.downsample_conv(x), train,
                                   batch_stats)
        return F.relu(y + x)


class ResNet(nn.Module):
    """Images ``[B, H, W, 3]`` (NHWC, any float dtype) -> f32 logits.

    Built on ``device`` (default ``"cuda"``; ``"cpu"`` must be asked for)
    with random weights from a ``torch.Generator`` seeded with ``seed``
    (flax's families: LeCun-normal kernels, unit norm scales, bn3 at 0);
    :func:`models.convert.resnet_from_flax` gives a JAX model's weights
    and running statistics instead."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "batch", stats_examples: int = 32,
                 stem: str = "conv7", *, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem must be 'conv7' or 's2d', got {stem!r}")
        dev = resolve_device(device)
        self.dtype, self.stem, self.norm = dtype, stem, norm
        if stem == "s2d":
            self.conv_init_s2d = Conv(12, 64, 4, 1, dtype=dtype, device=dev)
        else:
            self.conv_init = Conv(3, 64, 7, 2, ((3, 3), (3, 3)), dtype=dtype,
                                  device=dev)
        self.bn_init = make_norm(norm, 64, dtype=dtype,
                                 stats_examples=stats_examples, device=dev)
        self.blocks = nn.ModuleDict()
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = 64 * 2 ** i
                self.blocks[f"stage{i + 1}_block{j}"] = BottleneckBlock(
                    cin, filters, 2 if j == 0 and i > 0 else 1, dtype=dtype,
                    norm=norm, stats_examples=stats_examples, device=dev)
                cin = 4 * filters
        self.head = nn.Linear(cin, num_classes, dtype=torch.float32,
                              device=dev)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.stats_name = name + "."
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if hasattr(m, "reset_from"):
                    m.reset_from(gen)
            lecun_normal_(self.head.weight, gen)
            self.head.bias.zero_()

    def forward(self, images: torch.Tensor, *, train: bool = False,
                batch_stats: dict | None = None) -> torch.Tensor:
        dt = self.dtype
        x = images.to(dt)
        if self.stem == "s2d":
            # The 2x2 depth fold (NHWC, as JAX folds it) absorbs the stem's
            # stride: 224 -> 112 with 12 channels.
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            x = self.conv_init_s2d(x.permute(0, 3, 1, 2))
        else:
            x = self.conv_init(x.permute(0, 3, 1, 2))
        x = F.relu(self.bn_init(x, train, batch_stats))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks.values():
            x = block(x, train, batch_stats)
        x = x.mean((2, 3))                        # global average pool
        y = F.linear(x, self.head.weight.to(dt)) + self.head.bias.to(dt)
        return y.float()


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             norm: str = "batch", stats_examples: int = 32,
             stem: str = "conv7", *, device: str | torch.device = "cuda",
             seed: int = 0) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, dtype, norm, stats_examples,
                  stem, device=device, seed=seed)


def resnet18_cifar(num_classes: int = 10, dtype: torch.dtype = torch.float32,
                   norm: str = "batch", *,
                   device: str | torch.device = "cuda",
                   seed: int = 0) -> ResNet:
    """Small variant for tests and the example's default."""
    return ResNet((1, 1, 1, 1), num_classes, dtype, norm, device=device,
                  seed=seed)


def loss_fn(model: ResNet, batch: dict, rng=None,
            label_smoothing: float = 0.1) -> tuple[torch.Tensor, dict]:
    """Smoothed softmax CE of a training forward (JAX ``resnet.loss_fn``:
    optax's CE against ``one_hot * (1 - s) + s / n``, which is
    ``F.cross_entropy``'s ``label_smoothing``).
    ``batch``: {"image": [B, H, W, 3], "label": [B]}. Returns ``(loss,
    {"accuracy", "batch_stats"})``: the new running statistics by buffer
    name ({} under GroupNorm), for the step to merge."""
    del rng
    stats: dict = {}
    logits = model(batch["image"], train=True, batch_stats=stats)
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc, "batch_stats": stats}


def flops_per_example(image_size: int = 224) -> float:
    """~4.1 GFLOPs forward for ResNet-50 at 224; forward + backward ~3x."""
    return 3.0 * 4.1e9 * (image_size / 224) ** 2
