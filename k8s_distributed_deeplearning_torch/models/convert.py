"""Flax Llama, MoE, BERT, ViT, ResNet and MNIST parameters -> the port's
state dicts.

The JAX transformer trees (``LlamaLM`` and ``MoELM`` under ``transformer``,
``BertMLM`` and ``ViT`` under ``encoder``) come in two layouts: the
layer-scanned stack (``scan_layers=True``: one ``blocks`` subtree whose
every leaf carries a leading layer axis) and the unrolled one
(``block_{i}``). Both map onto the same ``nn.Module`` names. Leaves are
numpy arrays (or anything ``np.asarray`` takes, including boxed
partitioned leaves with an ``unbox()`` method).

Kernel layouts: flax ``DenseGeneral`` q/k/v kernels are ``[D, H, hd]``,
o_proj ``[H, hd, D]``, the MLP and head kernels ``[in, out]``;
``nn.Linear`` weights are ``[out, in]``. The embedding is ``[V, D]`` in
both. An MoE block's ``mlp`` holds ``router`` [D, E], ``w_gate`` and
``w_up`` [E, D, M] and ``w_down`` [E, M, D]; the port keeps that layout
(the grouped matmul takes ``rhs`` [E, K, N] as it is), the router in f32.
Flax conv kernels are HWIO, the port's OIHW. LayerNorm and BatchNorm
scales and biases, biases of the zoo's dense layers, and BatchNorm's
running statistics stay f32.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from k8s_distributed_deeplearning_torch.models.transformer import (
    TransformerConfig)


def _leaf(x: Any) -> np.ndarray:
    if hasattr(x, "unbox"):
        x = x.unbox()
    return np.asarray(x)


def _block_trees(cfg: TransformerConfig,
                 tr: Mapping) -> list[Mapping]:
    """One flax subtree per layer, slicing the scanned stack if needed."""
    if "blocks" in tr:
        stacked = tr["blocks"]

        def layer(tree, i):
            if isinstance(tree, Mapping):
                return {k: layer(v, i) for k, v in tree.items()}
            return _leaf(tree)[i]

        return [layer(stacked, i) for i in range(cfg.n_layers)]
    return [tr[f"block_{i}"] for i in range(cfg.n_layers)]


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(_leaf(x), order="C")).to(dtype)


def _norm(tree: Mapping, name: str) -> dict[str, torch.Tensor]:
    """An RMSNorm's scale, or a LayerNorm's scale and bias, in f32."""
    return {f"{name}.{k}": _tensor(tree[k], torch.float32)
            for k in ("scale", "bias") if k in tree}


def _dense(tree: Mapping, name: str,
           dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A flax Dense's ``[in, out]`` kernel as ``[out, in]``, and its bias
    when it has one (at ``dtype``, the port's parameter dtype)."""
    out = {f"{name}.weight": _tensor(_leaf(tree["kernel"]).T, dtype)}
    if "bias" in tree:
        out[f"{name}.bias"] = _tensor(tree["bias"], dtype)
    return out


def encoder_from_flax(cfg: TransformerConfig, tr: Mapping,
                      prefix: str) -> dict[str, torch.Tensor]:
    """The state dict of a port ``Transformer`` (keys under ``prefix``)
    from the flax ``Transformer`` subtree ``tr``: ``tok_embed`` and
    ``pos_embed`` when the tree has them, each block's norms, attention,
    MLP (SwiGLU, GELU with biases, or the MoE layer) and the final norm."""
    hd = cfg.resolved_head_dim
    dt = cfg.resolved_param_dtype

    def qkv(kernel):                       # [D, H, hd] -> [H*hd, D]
        k = _leaf(kernel)
        return _tensor(k.reshape(k.shape[0], -1).T, dt)

    sd = {prefix + f"{e}.weight": _tensor(tr[e]["embedding"], dt)
          for e in ("tok_embed", "pos_embed") if e in tr}
    sd.update(_norm(tr["final_norm"], prefix + "final_norm"))
    for i, blk in enumerate(_block_trees(cfg, tr)):
        p = f"{prefix}blocks.{i}."
        attn, mlp = blk["attn"], blk["mlp"]
        o = _leaf(attn["o_proj"]["kernel"])               # [H, hd, D]
        if o.shape[:2] != (cfg.n_heads, hd):
            raise ValueError(
                f"o_proj kernel {o.shape} does not match n_heads="
                f"{cfg.n_heads}, head_dim={hd}")
        sd.update({
            **_norm(blk["attn_norm"], p + "attn_norm"),
            **_norm(blk["mlp_norm"], p + "mlp_norm"),
            p + "attn.q_proj.weight": qkv(attn["q_proj"]["kernel"]),
            p + "attn.k_proj.weight": qkv(attn["k_proj"]["kernel"]),
            p + "attn.v_proj.weight": qkv(attn["v_proj"]["kernel"]),
            p + "attn.o_proj.weight": _tensor(o.reshape(-1, o.shape[-1]).T,
                                              dt),
        })
        if "router" in mlp:
            sd.update({p + "mlp.router": _tensor(mlp["router"],
                                                 torch.float32),
                       **{p + f"mlp.{w}": _tensor(mlp[w], dt)
                          for w in ("w_gate", "w_up", "w_down")}})
        else:
            for w in ("gate_proj", "up_proj", "down_proj"):
                if w in mlp:
                    sd.update(_dense(mlp[w], p + f"mlp.{w}", dt))
    return sd


def from_flax_params(cfg: TransformerConfig,
                     params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``LlamaLM(cfg)`` or ``MoELM(cfg, ...)`` from the
    matching flax model's ``params`` tree (the ``"params"`` collection).
    Weights are written at the port model's parameter dtype
    (``cfg.resolved_param_dtype``: f32 JAX params stay f32 for training);
    norm scales and MoE routers stay f32."""
    sd = encoder_from_flax(cfg, params["transformer"], "transformer.")
    if not cfg.tie_embeddings:
        sd["head.lm_head.weight"] = _tensor(_leaf(
            params["head"]["lm_head"]["kernel"]).T, cfg.resolved_param_dtype)
    return sd


def bert_from_flax(cfg: TransformerConfig,
                   params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``bert.BertMLM(cfg)`` from the flax ``BertMLM``'s
    ``params``: the encoder (``pos_embed``, LayerNorm scales and biases,
    MLP biases), the MLM transform ``mlm_dense`` and ``mlm_norm``, and
    ``mlm_bias``; the decode is tied to ``tok_embed`` and has no leaf."""
    dt = cfg.resolved_param_dtype
    return {**encoder_from_flax(cfg, params["encoder"], "encoder."),
            **_dense(params["mlm_dense"], "mlm_dense", dt),
            **_norm(params["mlm_norm"], "mlm_norm"),
            "mlm_bias": _tensor(params["mlm_bias"], torch.float32)}


def _conv(tree: Mapping, name: str,
          dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """A flax Conv's HWIO kernel as OIHW, and its bias when it has one."""
    out = {f"{name}.weight": _tensor(
        _leaf(tree["kernel"]).transpose(3, 2, 0, 1), dtype)}
    if "bias" in tree:
        out[f"{name}.bias"] = _tensor(tree["bias"], dtype)
    return out


def vit_from_flax(cfg: TransformerConfig,
                  params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``vit.ViT(cfg, ...)`` from the flax ``ViT``'s
    ``params``: ``patch_embed`` (HWIO -> OIHW, with its bias),
    ``cls_token``, ``pos_embed``, the encoder and the ``head``."""
    dt = cfg.resolved_param_dtype
    return {**_conv(params["patch_embed"], "patch_embed", dt),
            "cls_token": _tensor(params["cls_token"], dt),
            "pos_embed": _tensor(params["pos_embed"], dt),
            **encoder_from_flax(cfg, params["encoder"], "encoder."),
            **_dense(params["head"], "head", dt)}


def resnet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``resnet.ResNet`` from the flax ``ResNet``'s
    variables (``{"params": ..., "batch_stats": ...}``): every conv HWIO ->
    OIHW, each norm's ``scale`` and ``bias``, each BatchNorm's running
    ``mean`` and ``var`` (buffers), the ``head``. Block ``stage{i}_block{j}``
    sits under ``blocks.``; everything is f32, as flax keeps it."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, stat: Mapping, name: str) -> None:
        for k, sub in tree.items():
            key = (f"blocks.{k}" if k.startswith("stage") and not name
                   else f"{name}{k}")
            if "kernel" in sub:
                sd.update(_dense(sub, key, torch.float32)
                          if _leaf(sub["kernel"]).ndim == 2
                          else _conv(sub, key))
            elif "scale" in sub:
                sd.update(_norm(sub, key))
                for s in ("mean", "var"):
                    if s in stat.get(k, {}):
                        sd[f"{key}.{s}"] = _tensor(stat[k][s],
                                                   torch.float32)
            else:
                walk(sub, stat.get(k, {}), key + ".")

    walk(params, stats, "")
    return sd


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def flax_layout(cfg: TransformerConfig, scan_layers: bool = True,
                root: str = "transformer") -> Callable[[str], tuple]:
    """The flax leaf behind each of the port's ``LlamaLM``/``MoELM``
    parameter names (``root="encoder"``: ``BertMLM``'s and ``ViT``'s
    encoders), for an optimizer whose arithmetic runs per leaf
    (adafactor's block RMS and factored statistics): ``name -> (leaf path,
    stacked, to_flax, from_flax)``. Under ``scan_layers`` (the JAX default)
    one leaf stacks a block parameter of every layer along a new leading
    axis (``stacked``); ``to_flax`` takes one layer's tensor to the flax
    kernel's layout (q/k/v ``[D, H, hd]``, o_proj ``[H, hd, D]``, the MLP
    and head ``[in, out]``) and ``from_flax`` takes it back. A name this
    map does not know is a leaf of its own, as it stands."""
    hd = cfg.resolved_head_dim
    qkv = (lambda w: w.T.reshape(w.shape[1], -1, hd),
           lambda u: u.reshape(u.shape[0], -1).T)
    out = (lambda w: w.T.reshape(-1, hd, w.shape[0]),
           lambda u: u.reshape(-1, u.shape[-1]).T)
    dense = (lambda w: w.T, lambda u: u.T)
    plain = (_identity, _identity)
    fixed = {f"{root}.{e}.weight": (f"{root}/{e}/embedding", plain)
             for e in ("tok_embed", "pos_embed")}
    fixed.update({f"{root}.final_norm.{k}": (f"{root}/final_norm/{k}",
                                             plain)
                  for k in ("scale", "bias")})
    fixed["head.lm_head.weight"] = ("head/lm_head/kernel", dense)
    fixed["patch_embed.weight"] = ("patch_embed/kernel", _CONV)  # ViT

    def layout(name: str) -> tuple:
        if name in fixed:
            leaf, (to, frm) = fixed[name]
            return leaf, False, to, frm
        parts = name.split(".")
        if parts[:2] != [root, "blocks"] or len(parts) < 4:
            return name, False, _identity, _identity
        layer, rest = parts[2], parts[3:]
        to, frm = plain
        if rest[-1] == "weight":
            rest = rest[:-1] + ["kernel"]
            to, frm = (qkv if rest[-2] in ("q_proj", "k_proj", "v_proj")
                       else out if rest[-2] == "o_proj" else dense)
        if scan_layers:
            return ("/".join([root, "blocks", *rest]), True, to, frm)
        return ("/".join([root, f"block_{layer}", *rest]), False, to, frm)
    return layout


# OIHW conv weights <-> flax's HWIO kernels.
_CONV = (lambda w: w.permute(2, 3, 1, 0), lambda u: u.permute(3, 2, 0, 1))


def resnet_layout() -> Callable[[str], tuple]:
    """:func:`flax_layout` for ``resnet.ResNet``: each parameter is a flax
    leaf of its own (nothing is scanned), conv weights taken to HWIO and
    the head to ``[in, out]``, so adafactor factors a conv kernel over its
    (in, out) channels as optax does on the flax tree."""
    dense = (lambda w: w.T, lambda u: u.T)

    def layout(name: str) -> tuple:
        parts = name.split(".")
        if parts[0] == "blocks":
            parts = parts[1:]
        to, frm = _identity, _identity
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            to, frm = dense if parts[0] == "head" else _CONV
        return "/".join(parts), False, to, frm
    return layout


def mnist_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``mnist.MNISTConvNet`` from the flax
    ``MNISTConvNet``'s ``params`` tree: conv kernels HWIO -> OIHW, dense
    kernels ``[in, out]`` -> ``[out, in]``. ``dense1``'s input rows need no
    permutation: the port flattens its NCHW activations in NHWC order, as
    flax flattens."""
    def t(x):
        return torch.from_numpy(np.array(_leaf(x), np.float32, order="C"))

    sd = {}
    for flax_name, name in (("Conv_0", "conv1"), ("Conv_1", "conv2"),
                            ("Dense_0", "dense1"), ("Dense_1", "dense2")):
        k = _leaf(params[flax_name]["kernel"])
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        sd[f"{name}.weight"] = t(k)
        sd[f"{name}.bias"] = t(params[flax_name]["bias"])
    return sd
