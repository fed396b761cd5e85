"""Mixture-of-Experts layers and the MoE language model.

Port of ``k8s_distributed_deeplearning_tpu/models/moe.py``, with the same
routing semantics and rounding points. Three dispatch mechanisms:

- ``dispatch="index"`` (default): index-based dispatch — position-in-expert
  from k cumsum passes over [T, E], then k scatters build the [E, C, d]
  expert buffers and a gather combines (capacity overflow drops tokens to
  the residual).
- ``dispatch="einsum"``: the Switch-style dense one-hot formulation, the
  readable reference, with the same keep set.
- ``dispatch="ragged"``: DROPLESS grouped-GEMM dispatch — tokens scatter
  into one flat buffer sorted by expert (block-aligned ragged layout, no
  capacity padding) and the expert SwiGLU runs as three grouped matmuls
  (:mod:`ops.gmm`: the hand-written CUDA kernels on the card) whose work
  tracks the real token counts.

Data parallelism is one process per replica (``parallel/data_parallel``):
each rank dispatches its own tokens and forms its own auxiliary losses from
its own routing statistics, as the JAX ``data_parallel.make_train_step``
does. The JAX layer's ``shard_mesh`` (a GSPMD ``shard_map`` of the ragged
dispatch with the statistics averaged over the batch axes) belongs to the
sharded trainer and is not ported; neither is expert parallelism.

Router details: top-k gating with renormalized probabilities (gates over
``max(sum, 1e-9)``), position-in-expert by cumulative sum (choice 0 first,
then token order), overflow tokens pass through the residual, Switch
load-balance loss plus router z-loss. The router weight stays f32 whatever
``param_dtype`` is and the logits are ``tokens.float() @ router``; expert
weights are stored at ``param_dtype`` and cast to the compute dtype at use.
JAX collects the auxiliary losses with ``sow``; here the caller passes an
:class:`AuxCollector` down the blocks, which keeps one entry per layer, so
a remat recompute neither counts a layer twice nor replaces what the loss
has read. The layer does no host sync (no ``.item()``, ``.tolist()`` or
``nonzero``), so a step stays device-bound.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import torch
from torch import nn
from torch.nn import functional as F

from k8s_distributed_deeplearning_torch.models import transformer
from k8s_distributed_deeplearning_torch.models.llama import unembedding
from k8s_distributed_deeplearning_torch.models.transformer import (
    LMHead, Transformer, TransformerConfig, glorot_uniform_, init_weights,
    lm_batch_views)
from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops
from k8s_distributed_deeplearning_torch.ops.chunked_ce import (
    chunked_softmax_cross_entropy)
from k8s_distributed_deeplearning_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """MoE knobs layered on top of a TransformerConfig.

    ``routing``: ``"topk"`` (tokens pick their top-k experts; capacity
    overflow drops to the residual) or ``"expert_choice"`` (experts pick
    their top-C tokens). ``ragged_block_m`` is the grouped-GEMM row block;
    on the card it must be a multiple of the kernels' row tile
    (``ops.gmm.KERNEL_BLOCK_M``, 128, the default here; the JAX package's
    TPU default is 512). Outputs do not depend on it."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    routing: str = "topk"            # "topk" | "expert_choice"
    dispatch: str = "index"          # "index" | "einsum" | "ragged"
    ragged_block_m: int = gmm_ops.KERNEL_BLOCK_M

    def __post_init__(self):
        if self.routing not in ("topk", "expert_choice"):
            raise ValueError(f"routing must be 'topk' or 'expert_choice', "
                             f"got {self.routing!r}")
        if self.dispatch not in ("index", "einsum", "ragged"):
            raise ValueError(f"dispatch must be 'index', 'einsum' or "
                             f"'ragged', got {self.dispatch!r}")
        if self.dispatch == "ragged" and self.routing == "expert_choice":
            raise ValueError(
                "dispatch='ragged' targets top-k routing: expert choice "
                "already runs every expert exactly full (its [E, C, d] "
                "buffers carry no capacity padding), so the grouped GEMM "
                "has nothing to reclaim — use dispatch='index'.")


def clamped_capacity(tokens: int, moe: MoEConfig) -> int:
    """Per-expert buffer capacity: capacity_factor·k·T/E, int-floored,
    clamped to [1, T] (the one formula the layer and
    :func:`flops_per_token` share)."""
    return min(tokens, max(1, int(moe.capacity_factor * moe.top_k
                                  * tokens / moe.num_experts)))


class AuxCollector:
    """The auxiliary losses of one forward, one entry per MoE layer, in
    layer order. The first entry a layer records stays: a remat recompute
    of the layer in the backward records nothing new."""

    def __init__(self):
        self.layers: dict[nn.Module, dict] = {}

    def add(self, layer: nn.Module, values: dict) -> None:
        self.layers.setdefault(layer, values)

    def total(self, name: str):
        """Sum over layers of ``name`` (0.0 when no layer has it)."""
        return sum(v[name] for v in self.layers.values() if name in v)


def _topk_assignments(logits: torch.Tensor, k: int):
    """Greedy top-k expert choices shared by every dispatch.

    Returns (probs [T, E] f32, idx list of k [T] int64 expert picks, assign
    list of k one-hot [T, E] f32, gate_stack [k, T] renormalized)."""
    e = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=-1)
    remaining = probs
    idx_list, assign, gates = [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)          # first maximum
        one_hot = F.one_hot(idx, e).float()
        idx_list.append(idx)
        assign.append(one_hot)
        gates.append((probs * one_hot).sum(-1))
        remaining = remaining * (1.0 - one_hot)
    gate_stack = torch.stack(gates, dim=0)                      # [k, T]
    gate_stack = gate_stack / gate_stack.sum(0, keepdim=True).clamp_min(1e-9)
    return probs, idx_list, assign, gate_stack


def _z_loss(logits: torch.Tensor) -> torch.Tensor:
    """Router z-loss (one definition for every routing and dispatch)."""
    return torch.logsumexp(logits.float(), dim=-1).square().mean()


def _router_aux(logits: torch.Tensor, probs: torch.Tensor,
                assign0: torch.Tensor) -> dict:
    """Switch load-balance loss and router z-loss."""
    e = logits.shape[1]
    return {"load_balance_loss": e * (assign0.mean(0) * probs.mean(0)).sum(),
            "router_z_loss": _z_loss(logits)}


def _ragged_aux(f: torch.Tensor, p: torch.Tensor, z: torch.Tensor) -> dict:
    """The aux dict from routing statistics: f = mean first-choice
    assignment [E], p = mean router probs [E], z = mean router z-loss.
    Dropless, so fraction_dropped is exactly 0."""
    return {"load_balance_loss": f.shape[0] * (f * p).sum(),
            "router_z_loss": z,
            "fraction_dropped": torch.zeros((), dtype=torch.float32,
                                            device=f.device)}


def _expert_choice_picks(logits: torch.Tensor, capacity: int):
    """Each expert takes its top-``capacity`` tokens by softmax affinity.
    Returns (gates [E, C] f32, idx [E, C] int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.topk(probs.t(), capacity, dim=-1)


def top_k_dispatch_indices(logits: torch.Tensor, k: int, capacity: int):
    """Index-based top-k routing: the keep set of :func:`top_k_routing`
    (choice 0 takes capacity priority, then token order) as scatter/gather
    indices. Returns (dest [k, T] int64 flat E*C buffer destination per
    choice, E*C when dropped; gate [k, T] f32; keep [k, T] bool; aux)."""
    e = logits.shape[1]
    probs, idx_list, assign, gate_stack = _topk_assignments(logits, k)
    used = torch.zeros(e, dtype=torch.float32, device=logits.device)
    dests, keeps = [], []
    for c in range(k):
        one_hot = assign[c]                                   # [T, E]
        pos = torch.cumsum(one_hot, 0) - one_hot + used       # [T, E]
        keep_m = one_hot * (pos < capacity)
        used = used + keep_m.sum(0)
        pos_t = (pos * one_hot).sum(-1).long()                # [T]
        kept = keep_m.sum(-1) > 0
        dests.append(torch.where(kept, idx_list[c] * capacity + pos_t,
                                 e * capacity))
        keeps.append(kept)
    dest, keep = torch.stack(dests), torch.stack(keeps)
    aux = dict(_router_aux(logits, probs, assign[0]),
               fraction_dropped=1.0 - keep.float().mean())
    return dest, gate_stack, keep, aux


def top_k_routing(logits: torch.Tensor, k: int, capacity: int):
    """Top-k routing in the dense one-hot formulation. Returns (dispatch
    [T, E, C] bool, combine [T, E, C] f32, aux)."""
    t, e = logits.shape
    probs, _, assign, gate_stack = _topk_assignments(logits, k)
    dev = logits.device
    dispatch = torch.zeros(t, e, capacity, dtype=torch.bool, device=dev)
    combine = torch.zeros(t, e, capacity, dtype=torch.float32, device=dev)
    used = torch.zeros(e, dtype=torch.float32, device=dev)
    for c in range(k):
        one_hot = assign[c]
        pos = torch.cumsum(one_hot, 0) - one_hot + used       # slot index
        keep = one_hot * (pos < capacity)
        # One-hot of the slot; positions past the buffer match no slot.
        slot = (pos.long()[..., None]
                == torch.arange(capacity, device=dev)).float()   # [T, E, C]
        sel = keep[..., None] * slot
        dispatch = dispatch | (sel > 0)
        combine = combine + gate_stack[c][:, None, None] * sel
        used = used + keep.sum(0)
    aux = {"load_balance_loss": e * (assign[0].mean(0) * probs.mean(0)).sum(),
           "router_z_loss": _z_loss(logits),
           "fraction_dropped": 1.0 - (combine > 0).sum() / (t * k)}
    return dispatch, combine, aux


def expert_choice_routing(logits: torch.Tensor, capacity: int):
    """Expert-choice routing: each expert takes its top-``capacity`` tokens.
    Same (dispatch, combine, aux) contract as :func:`top_k_routing`;
    ``fraction_dropped`` counts the tokens no expert picked."""
    t = logits.shape[0]
    gates, idx = _expert_choice_picks(logits, capacity)           # [E, C]
    sel = F.one_hot(idx, t).float()                               # [E, C, T]
    dispatch = sel.permute(2, 0, 1) > 0                           # [T, E, C]
    combine = sel.permute(2, 0, 1) * gates[None]
    covered = dispatch.sum((1, 2)).clamp(0, 1).float()
    aux = {"router_z_loss": _z_loss(logits),
           "fraction_dropped": 1.0 - covered.mean()}
    return dispatch, combine, aux


def _ragged_block_m(tokens: int, moe: MoEConfig) -> int:
    """The grouped-GEMM row block of a call routing ``tokens`` tokens: the
    configured block clipped to the call's rows (k·T rounded up to a power
    of two), as the JAX layer clips it, but never below the kernels' row
    tile, which the card needs a multiple of."""
    rows = tokens * moe.top_k
    return min(moe.ragged_block_m,
               max(gmm_ops.KERNEL_BLOCK_M, 1 << (rows - 1).bit_length()))


class MoEMLP(nn.Module):
    """SwiGLU MLP of ``num_experts`` experts with top-k or expert-choice
    routing. Weights keep the JAX layout: ``router`` [d, E] (f32),
    ``w_gate``/``w_up`` [E, d, m], ``w_down`` [E, m, d]."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig, device=None):
        super().__init__()
        self.cfg, self.moe = cfg, moe
        d, m, e = cfg.dim, cfg.resolved_mlp_dim, moe.num_experts
        pdt = cfg.resolved_param_dtype

        def param(*shape, dtype=pdt):
            return nn.Parameter(torch.empty(*shape, dtype=dtype,
                                            device=device))

        self.router = param(d, e, dtype=torch.float32)
        self.w_gate = param(e, d, m)
        self.w_up = param(e, d, m)
        self.w_down = param(e, m, d)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """JAX ``default_init`` (Glorot uniform) on every weight; on the 3-D
        expert tensors the expert axis folds into both fans, as flax's fan
        rule does."""
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            glorot_uniform_(w, generator)

    def _expert_weights(self):
        dt = self.cfg.dtype
        return tuple(w if w.dtype == dt else w.to(dt)
                     for w in (self.w_gate, self.w_up, self.w_down))

    def forward(self, x: torch.Tensor, decode: bool = False,
                aux: AuxCollector | None = None) -> torch.Tensor:
        moe = self.moe
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        t = b * s
        capacity = clamped_capacity(t, moe)
        logits = tokens.float() @ self.router
        weights = self._expert_weights()

        if decode:
            # Serving: DROPLESS per-token top-k, so a token's output depends
            # on that token alone and decode steps route as a prefill would
            # (expert choice forced to top-k: it has no causal decode
            # semantics). Wide calls (prefill, t >= 128) take the grouped
            # GEMMs; narrow ones the index path at capacity = T.
            if moe.dispatch == "ragged" and t >= 128:
                y, _ = self._ragged_dispatch(tokens, logits, weights)
            else:
                y, _ = self._index_dispatch(tokens, logits, t, weights,
                                            routing="topk")
            return y.reshape(b, s, d)
        if moe.dispatch == "ragged":
            y, stats = self._ragged_dispatch(tokens, logits, weights)
        elif moe.dispatch == "index":
            y, stats = self._index_dispatch(tokens, logits, capacity,
                                            weights)
        else:
            y, stats = self._einsum_dispatch(tokens, logits, capacity,
                                             weights)
        if aux is not None:
            aux.add(self, stats)
        return y.reshape(b, s, d)

    @staticmethod
    def _experts_apply(xe, weights):
        """[E, C, d] expert buffers -> [E, C, d] outputs."""
        w_gate, w_up, w_down = weights
        h = torch.einsum("ecd,edm->ecm", xe, w_gate)
        h = F.silu(h) * torch.einsum("ecd,edm->ecm", xe, w_up)
        return torch.einsum("ecm,emd->ecd", h, w_down)

    def _einsum_dispatch(self, tokens, logits, capacity, weights):
        """Dense one-hot dispatch and combine (the Switch reference)."""
        dt, moe = self.cfg.dtype, self.moe
        if moe.routing == "expert_choice":
            dispatch, combine, aux = expert_choice_routing(logits, capacity)
        else:
            dispatch, combine, aux = top_k_routing(logits, moe.top_k,
                                                   capacity)
        xe = torch.einsum("tec,td->ecd", dispatch.to(dt), tokens.to(dt))
        ye = self._experts_apply(xe, weights)
        return torch.einsum("tec,ecd->td", combine.to(dt), ye), aux

    def _index_dispatch(self, tokens, logits, capacity, weights,
                        routing=None):
        """Scatter/gather dispatch with the einsum path's routing; *routing*
        overrides the config's policy (decode forces "topk")."""
        dt, moe = self.cfg.dtype, self.moe
        t, d = tokens.shape
        e = moe.num_experts
        tok_c = tokens.to(dt)

        if (routing or moe.routing) == "expert_choice":
            gates, idx = _expert_choice_picks(logits, capacity)   # [E, C]
            sel = idx.reshape(-1)
            xe = tok_c.index_select(0, sel).reshape(e, capacity, d)
            ye = self._experts_apply(xe, weights)
            y = torch.zeros(t, d, dtype=dt, device=tokens.device).index_add(
                0, sel, gates.reshape(-1)[:, None].to(dt)
                * ye.reshape(e * capacity, d))
            covered = torch.zeros(t, dtype=torch.float32,
                                  device=tokens.device).index_fill(0, sel, 1.0)
            return y, {"router_z_loss": _z_loss(logits),
                       "fraction_dropped": 1.0 - covered.mean()}

        dest, gate, keep, aux = top_k_dispatch_indices(logits, moe.top_k,
                                                       capacity)
        # One row past the E*C buffer takes the dropped tokens (the JAX
        # scatter's mode="drop") and is cut off; kept slots are unique.
        xe = torch.zeros(e * capacity + 1, d, dtype=dt, device=tokens.device)
        for c in range(moe.top_k):
            xe = xe.index_add(0, dest[c], tok_c)
        ye = self._experts_apply(xe[:-1].reshape(e, capacity, d),
                                 weights).reshape(e * capacity, d)
        y = torch.zeros(t, d, dtype=dt, device=tokens.device)
        for c in range(moe.top_k):
            w = (keep[c] * gate[c])[:, None].to(dt)
            y = y + ye.index_select(0, dest[c].clamp_max(e * capacity - 1)) * w
        return y, aux

    def _ragged_dispatch(self, tokens, logits, weights):
        """Dropless grouped-GEMM dispatch: tokens scatter into one flat
        [M_pad, d] buffer sorted by expert (the capacity paths' cumsum
        position accounting with per-expert ragged offsets, no capacity
        clamp) and the expert SwiGLU runs as three :func:`ops.gmm.gmm`
        products. Padding rows stay zero: the gmm contract relies on it."""
        dt, moe = self.cfg.dtype, self.moe
        t, d = tokens.shape
        k, e = moe.top_k, moe.num_experts
        tok_c = tokens.to(dt)
        w_gate, w_up, w_down = weights

        probs, idx_list, assign, gate_stack = _topk_assignments(logits, k)
        counts = functools.reduce(torch.add, (a.sum(0) for a in assign))
        layout = gmm_ops.grouped_layout(counts.to(torch.int32), t * k,
                                        block_m=_ragged_block_m(t, moe))
        row_offset = layout.row_offset.long()
        used = torch.zeros(e, dtype=torch.float32, device=tokens.device)
        dests = []
        for c in range(k):
            one_hot = assign[c]
            pos = torch.cumsum(one_hot, 0) - one_hot + used
            used = used + one_hot.sum(0)
            pos_t = (pos * one_hot).sum(-1).long()
            dests.append(row_offset[idx_list[c]] + pos_t)
        # Destinations are unique across tokens and choices, so add == set,
        # and index_add's backward is a gather.
        xs = torch.zeros(layout.m_pad, d, dtype=dt, device=tokens.device)
        for c in range(k):
            xs = xs.index_add(0, dests[c], tok_c)
        h = (F.silu(gmm_ops.gmm(xs, w_gate, layout))
             * gmm_ops.gmm(xs, w_up, layout))
        ys = gmm_ops.gmm(h, w_down, layout)
        y = torch.zeros(t, d, dtype=dt, device=tokens.device)
        for c in range(k):
            y = y + (ys.index_select(0, dests[c])
                     * gate_stack[c][:, None].to(dt))
        return y, _ragged_aux(assign[0].mean(0), probs.mean(0),
                              _z_loss(logits))


class MoELM(nn.Module):
    """Decoder-only MoE language model: every layer's MLP is a
    :class:`MoEMLP` through the shared ``Transformer`` core's
    ``mlp_factory``, so remat, packed ``segment_ids`` and the chunked head
    work as for :class:`models.llama.LlamaLM`. Built on ``device`` (default
    ``"cuda"``) with random weights from ``seed``.

    ``routing="expert_choice"`` is non-causal in this decoder: each expert
    picks its top-C tokens over the whole flattened [B*S] batch, so position
    i's routing sees future tokens. Construction warns.

    It serves through :func:`models.generate.generate` (JAX ``MoELM``
    takes no block tables either): ``decode=True`` with a dense ``cache``
    (and, for slot decode, ``cache_positions``) runs each block's
    :class:`MoEMLP` on its decode branch, dropless per-token top-k, so a
    step routes as the prefill did. A wide call (the prefill, ``t >=
    128``) of ``dispatch="ragged"`` takes the grouped GEMMs, three a
    layer; a narrow one (a decode step, ``t = B``) the index path at
    capacity ``T``."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        if moe.routing == "expert_choice":
            warnings.warn(
                "expert_choice routing inside a causal LM is non-causal: "
                "experts pick their top-C tokens across the whole batch, "
                "so routing for position i sees future tokens and decode "
                "routes differently from training. Use routing='topk' for "
                "causal LMs (see MoELM docstring).", UserWarning,
                stacklevel=2)
        dev = resolve_device(device)
        self.cfg, self.moe = cfg, moe
        self.transformer = Transformer(
            cfg, device=dev, mlp_factory=functools.partial(MoEMLP, moe=moe))
        self.head = LMHead(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                decode: bool = False, cache=None,
                cache_positions: torch.Tensor | None = None,
                return_hidden: bool = False,
                aux: AuxCollector | None = None) -> torch.Tensor:
        x = self.transformer(tokens, positions=positions,
                             segment_ids=segment_ids, decode=decode,
                             cache=cache, cache_positions=cache_positions,
                             aux=aux)
        if return_hidden:
            return x
        return self.logits(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head on final hidden states (any leading shape)."""
        emb = (self.transformer.tok_embed.weight
               if self.cfg.tie_embeddings else None)
        return self.head(hidden, emb)


def flops_per_token(cfg: TransformerConfig, moe: MoEConfig, *,
                    seq_len: int | None = None,
                    tokens_per_batch: int | None = None) -> float:
    """Approximate fwd+bwd FLOPs per token for MFU: the dense accounting
    with the MLP term scaled by the active expert slots per token (top_k
    for token choice, capacity_factor·top_k for expert choice; with
    ``tokens_per_batch``, the exact E·C/T of the capacity buffers), plus the
    router matmul. Ragged dispatch is exactly top_k slots a token."""
    dense = transformer.flops_per_token(cfg, seq_len=seq_len)
    mlp_term = 3.0 * 3 * 2 * cfg.dim * cfg.resolved_mlp_dim
    if moe.dispatch == "ragged":
        tokens_per_batch = None
    if tokens_per_batch is not None:
        t = tokens_per_batch
        active = moe.num_experts * clamped_capacity(t, moe) / t
    else:
        active = (moe.capacity_factor * moe.top_k
                  if moe.routing == "expert_choice" else moe.top_k)
    router = 3.0 * 2 * cfg.dim * moe.num_experts
    return dense + cfg.n_layers * (mlp_term * (active - 1) + router)


def loss_fn(model: MoELM, moe: MoEConfig, batch: dict, rng=None, *,
            chunked: bool = False,
            chunk_size: int = 1024) -> tuple[torch.Tensor, dict]:
    """Next-token CE plus the load-balance and router-z auxiliary losses,
    each summed over layers (JAX ``moe.loss_fn``). ``batch`` follows
    :func:`models.llama.loss_fn` (tokens, optional mask and segment_ids);
    ``chunked=True`` runs the chunked LM-head CE on the hidden states.
    Returns ``(loss, {"ce", "aux_loss", "accuracy"})``, f32 scalars."""
    del rng
    inputs, targets, seg_in, positions, mask = lm_batch_views(batch)
    targets = targets.long()
    collector = AuxCollector()
    kw = dict(segment_ids=seg_in, positions=positions, aux=collector)
    if chunked:
        hidden = model(inputs, return_hidden=True, **kw)
        w, layout = unembedding(model.cfg, model)
        ce, acc = chunked_softmax_cross_entropy(
            hidden, w, targets, mask, chunk_size=chunk_size, w_layout=layout)
    else:
        logits = model(inputs, **kw)
        ce_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1),
                                 reduction="none").view(targets.shape)
        denom = mask.sum().clamp_min(1.0)
        ce = (ce_tok * mask).sum() / denom
        acc = ((logits.argmax(-1) == targets).float() * mask).sum() / denom
    aux_loss = (moe.aux_loss_weight * collector.total("load_balance_loss")
                + moe.router_z_weight * collector.total("router_z_loss"))
    return ce + aux_loss, {"ce": ce, "aux_loss": aux_loss, "accuracy": acc}
