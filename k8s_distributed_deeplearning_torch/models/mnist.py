"""MNIST ConvNet, the reference's ``conv_model``.

Port of ``k8s_distributed_deeplearning_tpu/models/mnist.py``
(``horovod/tensorflow_mnist.py:38-73``): reshape to 28x28x1 -> conv 5x5x32
SAME + ReLU -> 2x2 maxpool -> conv 5x5x64 + ReLU -> 2x2 maxpool -> dense
1024 + ReLU -> dropout 0.5 -> dense 10, softmax cross-entropy loss, f32
logits. Parameters are f32 and cast to the compute ``dtype`` at each use.

The convolutions run in NCHW, torch's layout; the flatten before the
first dense layer is taken in NHWC order, (h, w, c) as flax flattens, so
a flax ``Dense(1024)`` kernel maps onto ``dense1`` by a transpose alone
(``models.convert.mnist_from_flax``). Dropout draws its mask from the
train step's generator, on the activation's device; the masks cannot
equal JAX's (another PRNG), so parity with JAX runs with dropout off.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from k8s_distributed_deeplearning_torch.utils.device import resolve_device


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """Flax's default kernel init: variance 1/fan_in from a normal
    truncated at two standard deviations, its stddev corrected for the
    truncation."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class MNISTConvNet(nn.Module):
    """Images (``[B, 784]`` flat or ``[B, 28, 28, 1]`` NHWC) -> f32 logits.

    Built on ``device`` (default ``"cuda"``; ``"cpu"`` must be asked for)
    with random weights from a generator seeded with ``seed``;
    ``convert.mnist_from_flax`` gives a JAX model's weights instead."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2, device=dev)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2, device=dev)
        self.dense1 = nn.Linear(7 * 7 * 64, 1024, device=dev)
        self.dense2 = nn.Linear(1024, num_classes, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for m in (self.conv1, self.conv2, self.dense1, self.dense2):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            nn.init.zeros_(m.bias)

    def _dropout(self, x: torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
        """Flax ``Dropout``: keep with probability ``1 - rate``, scale the
        kept values by ``1 / (1 - rate)``."""
        if self.dropout_rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train=True with dropout needs the step's "
                             "generator")
        keep_prob = 1.0 - self.dropout_rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.reshape(x.shape[0], 28, 28, 1).to(dt).permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=2)
            x = F.max_pool2d(F.relu(x), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        x = F.relu(F.linear(x, self.dense1.weight.to(dt),
                            self.dense1.bias.to(dt)))
        if train:
            x = self._dropout(x, generator)
        x = F.linear(x, self.dense2.weight.to(dt), self.dense2.bias.to(dt))
        return x.float()               # logits in f32 for a stable softmax


def _loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def loss_fn(model: MNISTConvNet, batch: dict,
            generator: torch.Generator | None = None
            ) -> tuple[torch.Tensor, dict]:
    """One replica's loss on its batch, in train mode (dropout from
    ``generator``): softmax CE (``tensorflow_mnist.py:68-71``), with the
    accuracy as aux."""
    logits = model(batch["image"], train=True, generator=generator)
    loss, acc = _loss_and_accuracy(logits, batch["label"])
    return loss, {"accuracy": acc}


@torch.no_grad()
def eval_fn(model: MNISTConvNet, batch: dict) -> dict:
    """Loss and accuracy in eval mode (no dropout)."""
    loss, acc = _loss_and_accuracy(model(batch["image"]), batch["label"])
    return {"loss": loss, "accuracy": acc}


def flops_per_example() -> float:
    """Approximate forward+backward FLOPs per example for MFU accounting."""
    # conv1: 28*28*32*(5*5*1)*2 ; conv2: 14*14*64*(5*5*32)*2
    # dense1: 7*7*64*1024*2 ; dense2: 1024*10*2 ; backward ~ 2x forward
    fwd = (28 * 28 * 32 * 25 * 2) + (14 * 14 * 64 * 25 * 32 * 2) \
        + (7 * 7 * 64 * 1024 * 2) + (1024 * 10 * 2)
    return 3.0 * fwd
