"""Per-channel int8 weight quantization for serving.

Port of ``k8s_distributed_deeplearning_tpu/serve/quant.py`` over the port's
modules. Serving weights are read-only, so quantization is a storage
transform: :func:`quantize_model` turns every matmul weight into int8 with
a symmetric absmax scale per output channel, in place, and each
:class:`models.transformer.Dense` dequantizes at use (``f32(int8) * scale``,
cast to the compute dtype). Embeddings, norm scales and the LM head stay as
they are, as in the JAX package (``_quantizable``): the projections are
where the bytes are.

The scales follow the JAX package's flax leaves, not the torch modules. A
flax kernel's absmax runs over every axis but its last, so the channels
are the last axis of ``[D, H, hd]`` (q/k/v: one scale per head_dim index,
shared by the heads), of ``[H, hd, D]`` (o_proj) and of ``[in, out]``
(the MLP). With ``scan_layers=True`` (the JAX default) the layers are one
stacked leaf, so a scale is also shared by every layer: the absmax runs
across the layers first, then each layer is quantized with it.
``scan_layers=False`` matches an unrolled JAX model, one scale per layer.

Calibration (optional): a JSON dump of per-channel absmax keyed by the JAX
parameter paths (``transformer/blocks/attn/q_proj/kernel/value``, or
``transformer/block_0/...`` unrolled); :func:`load_calibration` reads it
and ``quantize_model(..., calibration=...)`` clips each matching absmax to
it before the scales are derived.
"""
from __future__ import annotations

import json

import torch
from torch import nn

from k8s_distributed_deeplearning_torch.models.transformer import Dense

_PER_HEAD = ("q_proj", "k_proj", "v_proj")   # flax kernel [D, H, hd]


def jax_path_name(name: str, scan_layers: bool = True) -> str:
    """The JAX parameter path of the port's module ``name``'s weight:
    ``transformer.blocks.3.attn.q_proj`` -> ``transformer/blocks/attn/
    q_proj/kernel/value`` (scanned) or ``transformer/block_3/attn/q_proj/
    kernel/value`` (unrolled)."""
    parts = name.split(".")
    if parts[:2] == ["transformer", "blocks"]:
        layer = parts.pop(2)
        if not scan_layers:
            parts[1] = f"block_{layer}"
    return "/".join(parts + ["kernel", "value"])


def _quantizable(model: nn.Module) -> list[tuple[str, Dense]]:
    """Matmul weights only: every :class:`Dense` but the LM head."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, Dense) and not n.endswith("lm_head")]


def _channels(name: str, m: Dense, head_dim: int) -> int:
    """Size of the flax kernel's last axis: head_dim for q/k/v, the output
    width for the rest."""
    return head_dim if name.rsplit(".", 1)[-1] in _PER_HEAD \
        else m.out_features


@torch.no_grad()
def quantize_model(model: nn.Module, calibration: dict | None = None, *,
                   scan_layers: bool = True) -> None:
    """Quantize ``model``'s matmul weights to int8 in place.

    Each group of weights that shares one flax leaf (one module across all
    layers under ``scan_layers``, else one module) gets scales
    ``absmax / 127`` over its channels (see the module docstring); each
    weight becomes ``clip(round(w / where(scale > 0, scale, 1)), ±127)``,
    round half to even, with the scale tensor shared by the group. A
    layer's fp weight is released as soon as its int8 copy exists."""
    calib = (calibration or {}).get("weights", {})
    head_dim = model.cfg.resolved_head_dim
    groups: dict[str, list[tuple[str, Dense]]] = {}
    for name, m in _quantizable(model):
        if m.weight.dtype == torch.int8:
            raise ValueError(f"{name} is already quantized")
        groups.setdefault(jax_path_name(name, scan_layers), []).append(
            (name, m))
    for path, members in groups.items():
        c = _channels(members[0][0], members[0][1], head_dim)
        absmax = None
        for _, m in members:
            # abs and max are exact in any float dtype: no f32 copy here.
            a = m.weight.abs().amax(1).float().view(-1, c).amax(0)
            absmax = a if absmax is None else torch.maximum(absmax, a)
        cal = calib.get(path)
        if cal is not None:
            absmax = torch.minimum(absmax, torch.as_tensor(
                cal, dtype=torch.float32, device=absmax.device).reshape(c))
        scale = absmax / 127.0
        div = torch.where(scale > 0.0, scale, 1.0)[None, :, None]
        for _, m in members:
            w = m.weight
            q = w.to(torch.float32, copy=True).view(-1, c, w.shape[1])
            q = q.div_(div).round_().clamp_(-127, 127)
            m.set_int8(q.to(torch.int8).view(w.shape), scale)


@torch.no_grad()
def dequantize_model(model: nn.Module) -> None:
    """Invert :func:`quantize_model` in place: each int8 weight becomes
    ``f32(int8) * scale``, the int8 grid points, as float32 (the JAX
    ``dequantize_params`` leaves are float32 too)."""
    for _, m in _quantizable(model):
        w, s = m.weight, m.weight_scale
        if w.dtype != torch.int8:
            continue
        deq = w.view(-1, s.shape[0], w.shape[1]).float() * s[None, :, None]
        m.weight = nn.Parameter(deq.view(w.shape))
        m.weight_scale = None


def is_quantized(model: nn.Module) -> bool:
    """True when any matmul weight of ``model`` is int8."""
    return any(m.weight.dtype == torch.int8 for _, m in _quantizable(model))


def params_nbytes(model: nn.Module) -> int:
    """Bytes of ``model``'s parameters."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def quantized_nbytes(model: nn.Module) -> int:
    """Device bytes of the weights as they stand: parameters (int8 and
    the untouched ones) plus each distinct scale tensor once."""
    scales = {m.weight_scale.data_ptr(): m.weight_scale
              for _, m in _quantizable(model) if m.weight_scale is not None}
    return params_nbytes(model) + sum(
        s.numel() * s.element_size() for s in scales.values())


def load_calibration(path: str) -> dict:
    """Read a calibration dump: ``{"weights": {param_path: [per-channel
    absmax]}, "activations": {...}}``."""
    with open(path) as f:
        calib = json.load(f)
    if not isinstance(calib, dict) or "weights" not in calib:
        raise ValueError(
            f"{path}: not a calibration dump (missing 'weights' key)")
    return calib
