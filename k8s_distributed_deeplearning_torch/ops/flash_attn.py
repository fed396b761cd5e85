"""Flash attention, forward and backward, on hand-written CUDA kernels.

Port of ``k8s_distributed_deeplearning_tpu/ops/pallas_flash.py``: the same
function and the same rounding points, ``[B, S, H, D]`` layout, native GQA
(``k``/``v`` carry ``H / group`` heads and are never repeated), causal
masking aligned bottom-right (row ``i`` sees column ``j`` iff
``i + (sk - sq) >= j``), and ``q_segment_ids``/``kv_segment_ids``
restricting attention to equal ids.

- :func:`flash_attention` is a ``torch.autograd.Function``. On CUDA tensors
  its forward launches the forward kernel of the route :func:`_fwd_route`
  names, and its backward computes delta, then launches the dQ kernel
  and the dK/dV kernel of the route :func:`_bwd_route` names for each of
  the two kernels. In f32 delta is ``rowsum(dO * O)``, a PyTorch
  reduction, as the JAX wrapper computes it outside its kernels; in bf16
  it comes from the kernel :func:`flash_bwd_delta`
  (``csrc/flash_delta.cu``) of the route :func:`_delta_route` names:
  the sum over keys of P·dP, the softmax backward's own term, where
  rowsum(dO·O) of the bf16 output is ~2^-9 of |dO||O| off, which
  dominates dQ where a row's values are nearly equal. The rules give
  ``"wgmma"`` (tensor cores through wgmma: ``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``, ``flash_delta_wgmma``) for bf16 at head_dim 64
  or 128, ``"small"`` (``csrc/flash_small.cu``, ``flash_delta_kernel``:
  mma.sync with ldmatrix fragments, P and dS in registers) for bf16 at
  head_dim 16 or 32, and ``"tf32x3"``
  (``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_f32.cu``: tensor cores
  through mma.sync, each f32 product a three-pass TF32 split,
  f32-accurate) for f32 at every head dim. The first kernels, of
  ``csrc/flash_attn.cu`` (mma.sync in bf16, the CUDA cores in f32), are
  the ``"mma"`` route, which only a caller that names it takes (delta
  has no mma route: its ``"small"`` kernel, ``flash_delta_kernel``,
  takes every head dim, and a caller may name it at 64 or 128). On CPU
  tensors the same function takes the plain versions. A CUDA tensor the
  kernels cannot take raises; there is no fallback from one kernel to
  another or to the plain version.
- :func:`flash_attention_reference` (``o`` and the log-sum-exp),
  :func:`flash_delta_reference` (delta) and
  :func:`flash_attention_bwd_reference` (``dq, dk, dv`` from the forward's
  ``o`` and ``lse``, P recomputed from the LSE) are the plain versions, in
  the Pallas kernels' arithmetic but for bf16's delta.
- :func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv` and
  :func:`flash_bwd_delta` are the kernel wrappers; each adds one to its
  ``launches`` where it launches, and also to ``launches_<route>`` on
  every route but ``"mma"`` (``launches_wgmma``, ``launches_tf32x3``,
  ``launches_small``).

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
SMALL_HEAD_DIMS = (16, 32)
# CTAs of one cluster that share a key tile's row steps on the small dK/dV
# kernel (csrc/flash_small.cu MAX_SPLITS), and the rows of a step.
SMALL_MAX_SPLITS = 8
SMALL_ROW_STEP = 64
SMALL_KEY_TILE = 64


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


def _p_dp(q, k, v, lse, do, scale, causal, segq, segk):
    """P = exp(s − lse) (0 where s ≤ NEG_INF/2) and dP = dO·V^T in f32,
    ``[B, Hkv, group, Sq, Sk]``."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, segq, segk)
    g = h // hkv
    s = _scores(q, k, scale, causal, segq, segk)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None])
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    dof = do.reshape(b, sq, hkv, g, d).float()
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    return p, dp


def flash_delta_reference(q, k, v, lse, do, *, causal: bool = False,
                          softmax_scale: float | None = None,
                          q_segment_ids=None, kv_segment_ids=None):
    """Plain version of :func:`flash_bwd_delta`: delta = sum over keys of
    P·dP in f32, ``[B, H, Sq]`` (0 for a row that sees no key)."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, q_segment_ids, kv_segment_ids)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    p, dp = _p_dp(q, k, v, lse, do, scale, causal, q_segment_ids,
                  kv_segment_ids)
    return (p * dp).sum(-1).reshape(b, h, sq)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool = False,
                                  softmax_scale: float | None = None,
                                  q_segment_ids=None, kv_segment_ids=None,
                                  delta=None):
    """Plain version of the two backward kernels: P recomputed as
    exp(s − lse) (0 where s ≤ NEG_INF/2), delta in f32 (``[B, H, Sq]``;
    when not given, f32: rowsum(dO·O), as the JAX wrapper; bf16: the sum
    over keys of P·dP, as :func:`flash_bwd_delta`), dS = P·(dP −
    delta)·scale cast to k's dtype, P cast to dO's dtype for dV; dK and dV
    summed over each KV head's query group. Returns ``dq, dk, dv`` in q's,
    k's and v's dtypes."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, q_segment_ids, kv_segment_ids)
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    p, dp = _p_dp(q, k, v, lse, do, scale, causal, q_segment_ids,
                  kv_segment_ids)
    dof = do.reshape(b, sq, hkv, g, d).float()
    if delta is not None:
        delta = delta.float().reshape(b, hkv, g, sq)
    elif q.dtype == torch.float32:
        delta = (dof * o.reshape(b, sq, hkv, g, d).float()).sum(-1).permute(
            0, 2, 3, 1)
    else:
        delta = (p * dp).sum(-1)
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype).float()
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
    at head_dim 64 or 128; ``"small"`` (``flash_fwd_small`` of
    ``csrc/flash_small.cu``) for bf16 at head_dim 16 or 32;
    ``"tf32x3"`` (``flash_fwd_tf32x3`` of ``csrc/flash_fwd_f32.cu``,
    three-pass TF32 on the tensor cores) for float32. ``"mma"``
    (``flash_fwd_kernel`` of ``csrc/flash_attn.cu``) only when a caller
    names it, to time it on the same inputs."""
    if dtype == torch.float32:
        return "tf32x3"
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.bfloat16 and head_dim in SMALL_HEAD_DIMS:
        return "small"
    return "mma"


def _check_small(dtype: torch.dtype, head_dim: int) -> None:
    if dtype != torch.bfloat16 or head_dim not in SMALL_HEAD_DIMS:
        raise TypeError(f"the small route takes bfloat16 at head_dim "
                        f"{SMALL_HEAD_DIMS}, got {dtype} at {head_dim}")


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
    elif route == "small":
        _check_small(q.dtype, d)
        fn = _small_library().flash_attn_fwd_small
    elif route == "tf32x3":
        if q.dtype != torch.float32:
            raise TypeError(f"the tf32x3 route takes float32, got {q.dtype}")
        fn = _fwd_tf32x3_library().flash_attn_fwd_tf32x3
    elif route == "mma":
        fn = _library().flash_attn_fwd
    else:
        raise ValueError(f"route must be 'wgmma', 'small', 'tf32x3' or "
                         f"'mma', got {route!r}")
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
    tensors launch ``flash_fwd_wgmma`` on the ``"wgmma"`` route,
    ``flash_fwd_small`` on ``"small"``, ``flash_fwd_tf32x3`` on
    ``"tf32x3"`` or ``flash_fwd_kernel`` on ``"mma"`` (default:
    :func:`_fwd_route`'s choice; naming it lets a caller time two routes
    on the same inputs), and add one to ``flash_fwd.launches``, and on
    every route but mma to ``.launches_<route>``."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, segq, segk)
    if q.device.type == "cpu" and route is None:
        return flash_attention_reference(
            q, k, v, causal=causal, softmax_scale=scale, q_segment_ids=segq,
            kv_segment_ids=segk)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _count(flash_fwd, _fwd_launch(q, k, v, segq, segk, o, lse, causal,
                                  scale, route))
    return o, lse


def _bwd_route(dtype: torch.dtype, head_dim: int, which: str) -> str:
    """Which kernel takes backward kernel ``which`` ("dq" or "dkv") of a
    CUDA call: ``"tf32x3"`` (the three-pass TF32 kernels of
    ``csrc/flash_bwd_f32.cu``) for float32; ``"wgmma"`` (the tensor-core
    kernels of ``csrc/flash_bwd.cu``) for bf16 at head_dim 64 or 128;
    ``"small"`` (``flash_dq_small`` and ``flash_dkv_small`` of
    ``csrc/flash_small.cu``) for bf16 at head_dim 16 or 32. A caller may
    name ``"mma"`` for either kernel at every dtype: the mma.sync and
    CUDA-core kernels of ``csrc/flash_attn.cu``, kept to be timed on the
    same inputs."""
    if which not in ("dq", "dkv"):
        raise ValueError(f"which must be 'dq' or 'dkv', got {which!r}")
    if dtype == torch.float32:
        return "tf32x3"
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.bfloat16 and head_dim in SMALL_HEAD_DIMS:
        return "small"
    return "mma"


def _dkv_small_splits(batch: int, n_kv: int, sq: int, sk: int, group: int,
                      causal: bool, sms: int) -> int:
    """CTAs (one cluster, 1 to ``SMALL_MAX_SPLITS``) that share a key tile's
    64-row steps on the small dK/dV kernel: enough that a CTA walks at most
    about 16 steps of the heaviest key tile (key tile 0: under causal
    masking every row sees it) and that the grid holds about two CTAs an
    SM, but never more than that key tile has steps. Each CTA more costs
    a K/V load, a prologue and a share of the merge: at phase Q's shape 2
    CTAs a key tile ran faster than 4 and 8 (``PERF.md``)."""
    rows = sq * group
    first = max(0, -(sk - sq)) * group if causal else 0   # rows of tile 0
    steps = max(1, -(-(rows - min(first, rows)) // SMALL_ROW_STEP))
    tiles = batch * n_kv * -(-sk // SMALL_KEY_TILE)
    want = max(-(-steps // 16), -(-2 * sms // tiles))
    return max(1, min(SMALL_MAX_SPLITS, steps, want))


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
    route = _bwd_route(q.dtype, d, which) if route is None else route
    extra = []
    if route == "wgmma":
        if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
            raise TypeError(f"the wgmma route takes bfloat16 at head_dim "
                            f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
        lib = _bwd_library()
        fn = lib.flash_bwd_dq_wgmma if which == "dq" else \
            lib.flash_bwd_dkv_wgmma
    elif route == "tf32x3":
        if q.dtype != torch.float32:
            raise TypeError(f"the tf32x3 route takes float32, got {q.dtype}")
        lib = _tf32x3_library()
        fn = lib.flash_bwd_dq_tf32x3 if which == "dq" else \
            lib.flash_bwd_dkv_tf32x3
    elif route == "small":
        _check_small(q.dtype, d)
        lib = _small_library()
        if which == "dq":
            fn = lib.flash_attn_bwd_dq_small
        else:
            fn = lib.flash_attn_bwd_dkv_small
            extra = [_dkv_small_splits(
                b, hkv, sq, sk, h // hkv, causal,
                torch.cuda.get_device_properties(
                    q.device).multi_processor_count)]
    elif route == "mma":
        lib = _library()
        fn = lib.flash_attn_bwd_dq if which == "dq" else \
            lib.flash_attn_bwd_dkv
    else:
        raise ValueError(f"route must be 'wgmma', 'tf32x3', 'small' or "
                         f"'mma', got {route!r}")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), _ptr(segq), _ptr(segk),
                *(t.data_ptr() for t in outs), b, sq, sk, h, hkv, d,
                int(causal), _DTYPE_CODE[q.dtype], scale, *extra,
                _stream(q.device))
    if rc:
        raise RuntimeError(f"flash backward {which} ({route} route) launch "
                           f"failed: CUDA error {rc}")
    return route


def flash_bwd_dq(q, k, v, do, lse, delta, segq, segk, causal: bool,
                 scale: float, *, route: str | None = None):
    """dQ on the card: ``flash_dq_wgmma`` on the ``"wgmma"`` route,
    ``flash_dq_tf32x3`` on ``"tf32x3"``, ``flash_dq_small`` on
    ``"small"``, ``flash_dq_kernel`` on ``"mma"`` (default:
    :func:`_bwd_route`'s choice). Adds one to ``flash_bwd_dq.launches``,
    and to ``.launches_wgmma``, ``.launches_tf32x3`` or
    ``.launches_small`` on those routes. CUDA tensors only."""
    dq = torch.empty_like(q)
    _count(flash_bwd_dq, _bwd_launch("dq", q, k, v, do, lse, delta, segq,
                                     segk, (dq,), causal, scale, route))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, segq, segk, causal: bool,
                  scale: float, *, route: str | None = None):
    """dK and dV on the card, the query-head group summed:
    ``flash_dkv_wgmma`` on the ``"wgmma"`` route, ``flash_dkv_tf32x3`` on
    ``"tf32x3"``, ``flash_dkv_small`` on ``"small"``, ``flash_dkv_kernel``
    on ``"mma"``. Adds one to ``flash_bwd_dkv.launches``, and to
    ``.launches_wgmma``, ``.launches_tf32x3`` or ``.launches_small`` on
    those routes. CUDA tensors only."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _count(flash_bwd_dkv, _bwd_launch("dkv", q, k, v, do, lse, delta, segq,
                                      segk, (dk, dv), causal, scale, route))
    return dk, dv


def _delta_route(head_dim: int) -> str:
    """Which delta kernel takes a bf16 CUDA call: ``"wgmma"``
    (``flash_delta_wgmma`` of ``csrc/flash_delta.cu``, tensor cores) at
    head_dim 64 or 128; ``"small"`` (``flash_delta_kernel``, mma.sync with
    ldmatrix, which takes every head dim) otherwise. A caller may name
    ``"small"`` at 64 or 128, to time it on the same inputs."""
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "small"


def flash_bwd_delta(q, k, v, do, lse, segq, segk, causal: bool,
                    scale: float, *, route: str | None = None):
    """delta ``[B, H, Sq]`` f32 for the bf16 backward on the card, the sum
    over keys of P·dP with P and dP as the dQ and dK/dV kernels recompute
    them: ``flash_delta_wgmma`` on the ``"wgmma"`` route,
    ``flash_delta_kernel`` on ``"small"`` (default: :func:`_delta_route`'s
    choice). Adds one to ``flash_bwd_delta.launches`` and to
    ``.launches_<route>``. bf16 CUDA tensors at a head dim the route takes
    only; anything else raises before any launch."""
    b, sq, sk, h, hkv, d = _shapes(q, k, v, segq, segk)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the delta kernel takes bfloat16, got {q.dtype}")
    route = _delta_route(d) if route is None else route
    if route == "wgmma":
        if d not in WGMMA_HEAD_DIMS:
            raise TypeError(f"the wgmma delta route takes head_dim "
                            f"{WGMMA_HEAD_DIMS}, got {d}")
    elif route != "small":
        raise ValueError(f"route must be 'wgmma' or 'small', got {route!r}")
    if q.device.type != "cuda":
        raise ValueError(f"no flash delta kernel for device {q.device}")
    _check_cuda({"q": q, "k": k, "v": v, "do": do, "lse": lse}, segq, segk)
    lib = _delta_library()
    fn = lib.flash_bwd_delta_wgmma if route == "wgmma" else \
        lib.flash_bwd_delta
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), _ptr(segq), _ptr(segk), delta.data_ptr(), b,
                sq, sk, h, hkv, d, int(causal), _DTYPE_CODE[q.dtype], scale,
                _stream(q.device))
    if rc:
        raise RuntimeError(f"flash delta ({route} route) launch failed: "
                           f"CUDA error {rc}")
    _count(flash_bwd_delta, route)
    return delta


def _count(wrapper, route: str) -> None:
    """One launch of a wrapper on ``route``: ``launches``, and
    ``launches_<route>`` for every route but ``"mma"``."""
    wrapper.launches += 1
    if route != "mma":
        name = f"launches_{route}"
        setattr(wrapper, name, getattr(wrapper, name) + 1)


flash_fwd.launches = 0
flash_fwd.launches_wgmma = 0
flash_fwd.launches_small = 0
flash_fwd.launches_tf32x3 = 0
flash_bwd_dq.launches = 0
flash_bwd_dq.launches_wgmma = 0
flash_bwd_dq.launches_tf32x3 = 0
flash_bwd_dq.launches_small = 0
flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_wgmma = 0
flash_bwd_dkv.launches_tf32x3 = 0
flash_bwd_dkv.launches_small = 0
flash_bwd_delta.launches = 0
flash_bwd_delta.launches_wgmma = 0
flash_bwd_delta.launches_small = 0


@torch.library.custom_op("k8s_ddl_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segq: torch.Tensor | None, segk: torch.Tensor | None,
                  causal: bool, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, segq, segk, causal, scale)


def flash_backward(q, k, v, o, lse, do, segq, segk, causal: bool,
                   scale: float):
    """``dq, dk, dv``: the plain version on CPU tensors; on CUDA tensors
    delta (bf16: :func:`flash_bwd_delta` on :func:`_delta_route`'s route;
    f32: rowsum(dO·O), a PyTorch reduction), then the dQ kernel, then the
    dK/dV kernel, each on
    :func:`_bwd_route`'s route for it (float32: ``"tf32x3"``; bf16 at
    head_dim 16 or 32: ``"small"``; at 64 or 128: ``"wgmma"``)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, softmax_scale=scale,
            q_segment_ids=segq, kv_segment_ids=segk)
    if q.dtype == torch.float32:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    else:
        delta = flash_bwd_delta(q, k, v, do, lse, segq, segk, causal, scale)
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


def _tf32x3_library():
    lib = _build.load("flash_bwd_f32")
    if lib.flash_bwd_dq_tf32x3.argtypes is None:
        tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd_dq_tf32x3.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.flash_bwd_dkv_tf32x3.argtypes = [ctypes.c_void_p] * 10 + tail
        for fn in (lib.flash_bwd_dq_tf32x3, lib.flash_bwd_dkv_tf32x3):
            fn.restype = ctypes.c_int
    return lib


def _small_library():
    lib = _build.load("flash_small")
    if lib.flash_attn_fwd_small.argtypes is None:
        tail = [ctypes.c_int] * 8 + [ctypes.c_float]
        lib.flash_attn_fwd_small.argtypes = (
            [ctypes.c_void_p] * 7 + tail + [ctypes.c_void_p])
        lib.flash_attn_bwd_dq_small.argtypes = (
            [ctypes.c_void_p] * 9 + tail + [ctypes.c_void_p])
        lib.flash_attn_bwd_dkv_small.argtypes = (
            [ctypes.c_void_p] * 10 + tail + [ctypes.c_int, ctypes.c_void_p])
        for fn in (lib.flash_attn_fwd_small, lib.flash_attn_bwd_dq_small,
                   lib.flash_attn_bwd_dkv_small):
            fn.restype = ctypes.c_int
    return lib


def _fwd_tf32x3_library():
    lib = _build.load("flash_fwd_f32")
    if lib.flash_attn_fwd_tf32x3.argtypes is None:
        lib.flash_attn_fwd_tf32x3.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attn_fwd_tf32x3.restype = ctypes.c_int
    return lib


def _delta_library():
    lib = _build.load("flash_delta")
    if lib.flash_bwd_delta.argtypes is None:
        for fn in (lib.flash_bwd_delta, lib.flash_bwd_delta_wgmma):
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
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
