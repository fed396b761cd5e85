"""Flash attention, forward and backward, on hand-written CUDA kernels.

Port of ``k8s_distributed_deeplearning_tpu/ops/pallas_flash.py``: the same
function and the same rounding points, ``[B, S, H, D]`` layout, native GQA
(``k``/``v`` carry ``H / group`` heads and are never repeated), causal
masking aligned bottom-right (row ``i`` sees column ``j`` iff
``i + (sk - sq) >= j``), and ``q_segment_ids``/``kv_segment_ids``
restricting attention to equal ids.

- :func:`flash_attention` is a ``torch.autograd.Function``. On CUDA tensors
  its forward launches the forward kernel of the route :func:`_fwd_route`
  names, and its backward computes ``delta = rowsum(dO * O)`` with a
  PyTorch reduction, as the JAX wrapper does outside its kernels, then
  launches the dQ kernel and the dK/dV kernel of the route
  :func:`_bwd_route` names. Both rules give ``"wgmma"`` (tensor cores
  through wgmma: ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) for bf16 at
  head_dim 64 or 128, ``"mma"`` (``csrc/flash_attn.cu``, mma.sync)
  otherwise. On CPU tensors the same function takes the plain versions. A
  CUDA tensor the kernels cannot take raises; there is no fallback from
  one kernel to another or to the plain version.
- :func:`flash_attention_reference` (``o`` and the log-sum-exp) and
  :func:`flash_attention_bwd_reference` (``dq, dk, dv`` from the forward's
  ``o`` and ``lse``, P recomputed from the LSE) are the plain versions, in
  the Pallas kernels' arithmetic.
- :func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` are the
  kernel wrappers; each adds one to its ``launches`` where it launches, and
  also to ``launches_wgmma`` on the ``"wgmma"`` route.

The log-sum-exp is ``[B, H, Sq]`` float32: the Pallas ``[B·Hkv, group,
Sq]`` array, reshaped. The forward is also registered as the operator
``k8s_ddl_torch::flash_fwd`` so that selective activation checkpointing
(``models/transformer.py``) can name it.
"""
from __future__ import annotations

import ctypes

import torch

from k8s_distributed_deeplearning_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)


def _shapes(q, k, v, segq, segk):
    """The Pallas wrapper's validation (pallas_flash.py:799-816). Returns
    (b, sq, sk, h, hkv, d)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, Sq, H, D] and k, v the same [B, Sk, Hkv, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"{h} q heads not divisible by {hkv} kv heads")
    if (segq is None) != (segk is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given "
                         "together")
    if segq is not None:
        if tuple(segq.shape) != (b, sq):
            raise ValueError(f"q_segment_ids {tuple(segq.shape)} must be "
                             f"[B, Sq] = {(b, sq)}")
        if tuple(segk.shape) != (b, sk):
            raise ValueError(f"kv_segment_ids {tuple(segk.shape)} must be "
                             f"[B, Sk] = {(b, sk)}")
    return b, sq, sk, h, hkv, d


def _scores(q, k, scale, causal, segq, segk):
    """Masked f32 scores ``[B, Hkv, group, Sq, Sk]``: q·k in f32 times the
    scale, NEG_INF where masked."""
    b, sq, sk, h, hkv, d = _shapes(q, k, k, segq, segk)
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    allow = None
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        allow = (row + (sk - sq) >= col)[None]
    if segq is not None:
        same = segq[:, :, None] == segk[:, None, :]
        allow = same if allow is None else allow & same
    if allow is not None:
        s = s.masked_fill(~allow[:, None, None], NEG_INF)
    return s


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              softmax_scale: float | None = None,
                              q_segment_ids=None, kv_segment_ids=None):
    """Plain version of the forward kernel. Returns ``o`` ``[B, Sq, H, D]``
    in q's dtype and ``lse`` ``[B, H, Sq]`` f32: p = exp(s − max) with
    p = 0 where s ≤ NEG_INF/2, the sum floored at 1e-30, P cast to v's
    dtype for P·V, lse = max + log(sum)."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, q_segment_ids, kv_segment_ids)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    s = _scores(q, k, scale, causal, q_segment_ids, kv_segment_ids)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF / 2, 0.0)
    norm = p.sum(-1).clamp_min(1e-30)                     # [B, Hkv, g, Sq]
    acc = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = acc / norm.permute(0, 3, 1, 2)[..., None]
    lse = m[..., 0] + torch.log(norm)
    return o.reshape(b, sq, h, d).to(q.dtype), lse.reshape(b, h, sq)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool = False,
                                  softmax_scale: float | None = None,
                                  q_segment_ids=None, kv_segment_ids=None):
    """Plain version of the two backward kernels: P recomputed as
    exp(s − lse) (0 where s ≤ NEG_INF/2), delta = rowsum(dO·O) in f32,
    dS = P·(dP − delta)·scale cast to k's dtype, P cast to dO's dtype for
    dV; dK and dV summed over each KV head's query group. Returns
    ``dq, dk, dv`` in q's, k's and v's dtypes."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, q_segment_ids, kv_segment_ids)
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    s = _scores(q, k, scale, causal, q_segment_ids, kv_segment_ids)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None])
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    dof = do.reshape(b, sq, hkv, g, d).float()
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    delta = (dof * o.reshape(b, sq, hkv, g, d).float()).sum(-1)
    ds = (p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale).to(
        k.dtype).float()
    qf = q.reshape(b, sq, hkv, g, d).float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(do.dtype).float(), dof)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_cuda(tensors: dict, segq, segk):
    """What the kernels take: float32 or bfloat16, one dtype, head_dim in
    HEAD_DIMS, contiguous, 16-byte aligned, on one device, int32
    contiguous segment ids."""
    q = tensors["q"]
    devices = {t.device for t in tensors.values()}
    devices |= {t.device for t in (segq, segk) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for t in (segq, segk):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise TypeError("segment ids must be contiguous int32")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which forward kernel takes a CUDA call: ``"wgmma"``
    (``flash_fwd_wgmma`` of ``csrc/flash_fwd.cu``, tensor cores) for bf16
    at head_dim 64 or 128; ``"mma"`` (``flash_fwd_kernel`` of
    ``csrc/flash_attn.cu``) for float32 and head_dim 16 or 32."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def _fwd_launch(q, k, v, segq, segk, o, lse, causal, scale, route):
    """Launch the forward kernel of ``route`` on CUDA tensors, writing
    ``o`` and ``lse``; returns the route launched. ``route`` None takes
    :func:`_fwd_route`'s choice."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, segq, segk)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention forward kernel for device "
                         f"{q.device}")
    _check_cuda({"q": q, "k": k, "v": v}, segq, segk)
    route = _fwd_route(q.dtype, d) if route is None else route
    if route == "wgmma":
        if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
            raise TypeError(f"the wgmma route takes bfloat16 at head_dim "
                            f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
        fn = _fwd_library().flash_attn_fwd_wgmma
    elif route == "mma":
        fn = _library().flash_attn_fwd
    else:
        raise ValueError(f"route must be 'wgmma' or 'mma', got {route!r}")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(segq),
                _ptr(segk), o.data_ptr(), lse.data_ptr(), b, sq, sk, h, hkv,
                d, int(causal), _DTYPE_CODE[q.dtype], scale,
                _stream(q.device))
    if rc:
        raise RuntimeError(f"flash forward ({route} route) launch failed: "
                           f"CUDA error {rc}")
    return route


def flash_fwd(q, k, v, segq, segk, causal: bool, scale: float, *,
              route: str | None = None):
    """The forward: ``(o, lse)``. CPU tensors take
    :func:`flash_attention_reference` (and refuse a named ``route``); CUDA
    tensors launch ``flash_fwd_wgmma`` on the ``"wgmma"`` route or
    ``flash_fwd_kernel`` on ``"mma"`` (default: :func:`_fwd_route`'s
    choice; naming it lets a caller time both routes on the same inputs),
    and add one to ``flash_fwd.launches``, and on the wgmma route to
    ``.launches_wgmma``."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, segq, segk)
    if q.device.type == "cpu" and route is None:
        return flash_attention_reference(
            q, k, v, causal=causal, softmax_scale=scale, q_segment_ids=segq,
            kv_segment_ids=segk)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if _fwd_launch(q, k, v, segq, segk, o, lse, causal, scale,
                   route) == "wgmma":
        flash_fwd.launches_wgmma += 1
    flash_fwd.launches += 1
    return o, lse


def _bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which backward kernels take a CUDA call: ``"wgmma"`` (the tensor-core
    kernels of ``csrc/flash_bwd.cu``) for bf16 at head_dim 64 or 128;
    ``"mma"`` (``flash_dq_kernel`` and ``flash_dkv_kernel`` of
    ``csrc/flash_attn.cu``) for float32 and head_dim 16 or 32."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def _bwd_launch(which, q, k, v, do, lse, delta, segq, segk, outs, causal,
                scale, route):
    """Launch the backward kernel ``which`` ("dq" or "dkv") of ``route`` on
    CUDA tensors, writing ``outs``; returns the route launched. ``route``
    None takes :func:`_bwd_route`'s choice; naming it lets a caller time
    both routes on the same inputs."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, segq, segk)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention backward kernel for device "
                         f"{q.device}")
    _check_cuda({"q": q, "k": k, "v": v, "do": do, "lse": lse,
                 "delta": delta}, segq, segk)
    route = _bwd_route(q.dtype, d) if route is None else route
    if route == "wgmma":
        if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
            raise TypeError(f"the wgmma route takes bfloat16 at head_dim "
                            f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
        lib = _bwd_library()
        fn = lib.flash_bwd_dq_wgmma if which == "dq" else \
            lib.flash_bwd_dkv_wgmma
    elif route == "mma":
        lib = _library()
        fn = lib.flash_attn_bwd_dq if which == "dq" else \
            lib.flash_attn_bwd_dkv
    else:
        raise ValueError(f"route must be 'wgmma' or 'mma', got {route!r}")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), _ptr(segq), _ptr(segk),
                *(t.data_ptr() for t in outs), b, sq, sk, h, hkv, d,
                int(causal), _DTYPE_CODE[q.dtype], scale, _stream(q.device))
    if rc:
        raise RuntimeError(f"flash backward {which} ({route} route) launch "
                           f"failed: CUDA error {rc}")
    return route


def flash_bwd_dq(q, k, v, do, lse, delta, segq, segk, causal: bool,
                 scale: float, *, route: str | None = None):
    """dQ on the card: ``flash_dq_wgmma`` on the ``"wgmma"`` route,
    ``flash_dq_kernel`` on ``"mma"`` (default: :func:`_bwd_route`'s
    choice). Adds one to ``flash_bwd_dq.launches``, and on the wgmma route
    to ``.launches_wgmma``. CUDA tensors only."""
    dq = torch.empty_like(q)
    if _bwd_launch("dq", q, k, v, do, lse, delta, segq, segk, (dq,), causal,
                   scale, route) == "wgmma":
        flash_bwd_dq.launches_wgmma += 1
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, segq, segk, causal: bool,
                  scale: float, *, route: str | None = None):
    """dK and dV on the card, the query-head group summed:
    ``flash_dkv_wgmma`` on the ``"wgmma"`` route, ``flash_dkv_kernel`` on
    ``"mma"``. Adds one to ``flash_bwd_dkv.launches``, and on the wgmma
    route to ``.launches_wgmma``. CUDA tensors only."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _bwd_launch("dkv", q, k, v, do, lse, delta, segq, segk, (dk, dv),
                   causal, scale, route) == "wgmma":
        flash_bwd_dkv.launches_wgmma += 1
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_fwd.launches_wgmma = 0
flash_bwd_dq.launches = 0
flash_bwd_dq.launches_wgmma = 0
flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_wgmma = 0


@torch.library.custom_op("k8s_ddl_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segq: torch.Tensor | None, segk: torch.Tensor | None,
                  causal: bool, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, segq, segk, causal, scale)


def flash_backward(q, k, v, o, lse, do, segq, segk, causal: bool,
                   scale: float):
    """``dq, dk, dv``: the plain version on CPU tensors; on CUDA tensors
    delta = rowsum(dO·O) (a PyTorch reduction), then the dQ kernel, then
    the dK/dV kernel, both of :func:`_bwd_route`'s route."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, softmax_scale=scale,
            q_segment_ids=segq, kv_segment_ids=segk)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, segq, segk, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, segq, segk, causal,
                           scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward saves ``(q, k, v, o, lse, segq, segk)``; backward computes
    delta, then dQ, then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, segq, segk, causal, scale):
        o, lse = torch.ops.k8s_ddl_torch.flash_fwd(q, k, v, segq, segk,
                                                   causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, segq, segk)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segq, segk = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(), segq,
                                    segk, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, softmax_scale: float | None = None,
                    q_segment_ids: torch.Tensor | None = None,
                    kv_segment_ids: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Flash attention, ``[B, S, H, D]`` layout, native GQA. Segment ids
    (``[B, S]``, given together) are taken as int32, as the JAX wrapper
    casts them. Differentiable in q, k and v."""
    _shapes(q, k, v, q_segment_ids, kv_segment_ids)
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    scale = (float(softmax_scale) if softmax_scale is not None
             else q.shape[-1] ** -0.5)
    return FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                bool(causal), scale)


def _library():
    lib = _build.load("flash_attn")
    if lib.flash_attn_fwd.argtypes is None:
        tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_attn_fwd.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.flash_attn_bwd_dq.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.flash_attn_bwd_dkv.argtypes = [ctypes.c_void_p] * 10 + tail
        for fn in (lib.flash_attn_fwd, lib.flash_attn_bwd_dq,
                   lib.flash_attn_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib


def _fwd_library():
    lib = _build.load("flash_fwd")
    if lib.flash_attn_fwd_wgmma.argtypes is None:
        lib.flash_attn_fwd_wgmma.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attn_fwd_wgmma.restype = ctypes.c_int
    return lib


def _bwd_library():
    lib = _build.load("flash_bwd")
    if lib.flash_bwd_dq_wgmma.argtypes is None:
        tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd_dq_wgmma.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.flash_bwd_dkv_wgmma.argtypes = [ctypes.c_void_p] * 10 + tail
        for fn in (lib.flash_bwd_dq_wgmma, lib.flash_bwd_dkv_wgmma):
            fn.restype = ctypes.c_int
    return lib
