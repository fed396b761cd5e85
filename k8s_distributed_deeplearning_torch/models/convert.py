"""Flax Llama and MoE parameters -> the port's state dict.

The JAX ``LlamaLM`` and ``MoELM`` parameter trees come in two layouts: the
layer-scanned
stack (``scan_layers=True``: one ``transformer/blocks`` subtree whose every
leaf carries a leading layer axis) and the unrolled one
(``transformer/block_{i}``). Both map onto the same ``nn.Module`` names.
Leaves are numpy arrays (or anything ``np.asarray`` takes, including
boxed partitioned leaves with an ``unbox()`` method).

Kernel layouts: flax ``DenseGeneral`` q/k/v kernels are ``[D, H, hd]``,
o_proj ``[H, hd, D]``, the MLP and head kernels ``[in, out]``;
``nn.Linear`` weights are ``[out, in]``. The embedding is ``[V, D]`` in
both. An MoE block's ``mlp`` holds ``router`` [D, E], ``w_gate`` and
``w_up`` [E, D, M] and ``w_down`` [E, M, D]; the port keeps that layout
(the grouped matmul takes ``rhs`` [E, K, N] as it is), the router in f32.
"""
from __future__ import annotations

from typing import Any, Mapping

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


def from_flax_params(cfg: TransformerConfig,
                     params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``LlamaLM(cfg)`` or ``MoELM(cfg, ...)`` from the
    matching flax model's ``params`` tree (the ``"params"`` collection).
    Weights are written at the port model's parameter dtype
    (``cfg.resolved_param_dtype``: f32 JAX params stay f32 for training);
    norm scales and MoE routers stay f32."""
    hd = cfg.resolved_head_dim

    def t(x, dtype=cfg.resolved_param_dtype):
        return torch.from_numpy(np.array(_leaf(x), order="C")).to(dtype)

    def qkv(kernel):                       # [D, H, hd] -> [H*hd, D]
        k = _leaf(kernel)
        return t(k.reshape(k.shape[0], -1).T)

    tr = params["transformer"]
    sd = {"transformer.tok_embed.weight": t(tr["tok_embed"]["embedding"]),
          "transformer.final_norm.scale": t(tr["final_norm"]["scale"],
                                            torch.float32)}
    for i, blk in enumerate(_block_trees(cfg, tr)):
        p = f"transformer.blocks.{i}."
        attn, mlp = blk["attn"], blk["mlp"]
        o = _leaf(attn["o_proj"]["kernel"])               # [H, hd, D]
        sd.update({
            p + "attn_norm.scale": t(blk["attn_norm"]["scale"],
                                     torch.float32),
            p + "mlp_norm.scale": t(blk["mlp_norm"]["scale"],
                                    torch.float32),
            p + "attn.q_proj.weight": qkv(attn["q_proj"]["kernel"]),
            p + "attn.k_proj.weight": qkv(attn["k_proj"]["kernel"]),
            p + "attn.v_proj.weight": qkv(attn["v_proj"]["kernel"]),
            p + "attn.o_proj.weight": t(o.reshape(-1, o.shape[-1]).T),
        })
        if "router" in mlp:
            sd.update({p + "mlp.router": t(mlp["router"], torch.float32),
                       **{p + f"mlp.{w}": t(mlp[w])
                          for w in ("w_gate", "w_up", "w_down")}})
        else:
            sd.update({p + f"mlp.{w}.weight": t(_leaf(mlp[w]["kernel"]).T)
                       for w in ("gate_proj", "up_proj", "down_proj")})
        if o.shape[:2] != (cfg.n_heads, hd):
            raise ValueError(
                f"o_proj kernel {o.shape} does not match n_heads="
                f"{cfg.n_heads}, head_dim={hd}")
    if not cfg.tie_embeddings:
        sd["head.lm_head.weight"] = t(_leaf(
            params["head"]["lm_head"]["kernel"]).T)
    return sd
