"""Grouped matrix multiply (ragged GEMM), forward and weight gradient, on
hand-written CUDA kernels.

Port of ``k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py``, the MoE
expert compute of the dropless ``dispatch="ragged"`` path. Tokens are laid
out in one flat ``[M_pad, K]`` buffer sorted by expert, each expert's rows
rounded up to whole row blocks (:func:`grouped_layout`), and every row is
multiplied by its own expert's weight.

- :func:`gmm` is the differentiable product (a ``torch.autograd.Function``
  standing in for the JAX ``custom_vjp``). Its backward computes
  ``dlhs = gmm(g, rhsᵀ)`` with the same kernel, reading the weight
  transposed in place, and ``drhs = tgmm(lhs, g)``; ``g`` is cast to lhs's
  dtype and both gradients come out in lhs's dtype before they are cast to
  the primal dtypes, as in the JAX wrapper. The forward is also the
  operator ``k8s_ddl_torch::gmm``, so that a remat policy
  (``models/transformer.py``) can save it.
- :func:`gmm_forward` and :func:`tgmm` are the kernel wrappers: on CUDA
  tensors they launch the kernels of the route :func:`_gmm_route` names
  (bf16: ``gmm_wgmma`` and ``tgmm_wgmma`` of ``csrc/gmm_wgmma.cu``, on
  wgmma tensor cores; f32: ``gmm_tf32x3`` and ``tgmm_tf32x3`` of
  ``csrc/gmm_f32.cu``, three-pass TF32 on mma.sync tensor cores; the first
  kernels of ``csrc/gmm.cu``, ``"mma"``, only when a caller names them)
  and add one to their ``launches``, and on the wgmma route to
  ``launches_wgmma``, on the tf32x3 route to ``launches_tf32x3``; on CPU
  tensors they take the plain versions
  :func:`gmm_reference` and :func:`tgmm_reference`. A CUDA tensor the
  kernels cannot take raises; there is no fallback.

Semantics, shared by the kernels and the plain versions, the Pallas
kernels' block for block: a live row block (one holding a real row) of
expert ``e`` is ``lhs[block] @ rhs[e]`` with f32 accumulation, rounded
once to lhs's dtype, and a dead block is 0; ``tgmm`` sums
``lhs[r]ᵀ · dout[r]`` in f32 over the rows of each expert's live blocks,
and an expert with no rows gets zeros. With padding rows of zero, the MoE
layer's contract, rows that hold no token come out 0 and no output depends
on ``block_m``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from k8s_distributed_deeplearning_torch.ops import _build

# The CUDA kernels' row tile (BM of csrc/gmm.cu and csrc/gmm_wgmma.cu). On
# the card a layout's block_m must be a multiple of it; block_m = 128
# itself keeps the round-up slack per expert below 128 rows.
KERNEL_BLOCK_M = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class GroupedLayout(NamedTuple):
    """Per-step routing layout consumed by :func:`gmm` and the dispatcher.

    Shapes are static, values live on the device (no host sync builds it).

    - ``row_offset`` [E] int32: first row of each expert's block-aligned span.
    - ``block_expert`` [tiles_m] int32: owning expert of each row block
      (tail blocks past the last span clip to E-1; they are dead).
    - ``block_live`` [tiles_m] int32 (0/1): the block holds a real row.
    - ``block_first`` [tiles_m] int32 (0/1): first block of its expert's span.
    - ``group_sizes`` [E] int32: real rows of each expert (the port's
      addition: the weight-gradient kernel finds an expert's live blocks
      from it, with no pass over the block flags).
    - ``m_pad``: static padded row count (tiles_m · block_m).
    - ``block_m``: the row-block size the layout was built for.
    """

    row_offset: torch.Tensor
    block_expert: torch.Tensor
    block_live: torch.Tensor
    block_first: torch.Tensor
    group_sizes: torch.Tensor
    m_pad: int
    block_m: int


def padded_rows(total_rows: int, num_experts: int,
                block_m: int = KERNEL_BLOCK_M) -> int:
    """Static padded row count: every expert's span rounds up to a whole
    block (an empty expert still owns one dead block), so the worst case is
    ``ceil(total/bm) + E`` blocks."""
    return (-(-total_rows // block_m) + num_experts) * block_m


def grouped_layout(group_sizes: torch.Tensor, total_rows: int,
                   block_m: int = KERNEL_BLOCK_M) -> GroupedLayout:
    """The block-aligned ragged layout from per-expert row counts
    ``group_sizes`` [E] (``sum == total_rows``, a static bound), built on
    ``group_sizes``'s device."""
    e = group_sizes.shape[0]
    dev = group_sizes.device
    m_pad = padded_rows(total_rows, e, block_m)
    tiles_m = m_pad // block_m
    sizes = group_sizes.to(torch.int64)
    blocks = ((sizes + block_m - 1) // block_m).clamp_min(1)   # ceil, >= 1
    ends = torch.cumsum(blocks * block_m, 0)                   # span ends [E]
    row_offset = ends - blocks * block_m
    first_row = torch.arange(tiles_m, device=dev, dtype=torch.int64) * block_m
    # Block b belongs to expert e iff ends[e-1] <= b*bm < ends[e].
    block_expert = torch.searchsorted(ends, first_row, right=True).clamp(
        0, e - 1)
    live_end = row_offset[block_expert] + sizes[block_expert]
    block_live = first_row < live_end
    block_first = first_row == row_offset[block_expert]
    i32 = torch.int32
    return GroupedLayout(row_offset.to(i32), block_expert.to(i32),
                         block_live.to(i32), block_first.to(i32),
                         sizes.to(i32), m_pad, block_m)


def live_rows(layout: GroupedLayout) -> torch.Tensor:
    """[M_pad] bool: the row holds a real token of its block's expert."""
    e_row = layout.block_expert.long().repeat_interleave(layout.block_m)
    r = torch.arange(layout.m_pad, device=e_row.device)
    start = layout.row_offset.long()[e_row]
    return (r >= start) & (r < start + layout.group_sizes.long()[e_row])


def _check_layout(m_pad: int, num_experts: int, layout: GroupedLayout):
    if m_pad != layout.m_pad or m_pad % layout.block_m:
        raise ValueError(f"{m_pad} rows do not match the layout's m_pad "
                         f"{layout.m_pad} (block_m {layout.block_m})")
    if layout.row_offset.shape[0] != num_experts:
        raise ValueError(f"layout has {layout.row_offset.shape[0]} experts, "
                         f"the weight {num_experts}")


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                  layout: GroupedLayout, *,
                  transpose_rhs: bool = False) -> torch.Tensor:
    """Plain version of the forward kernel: one f32 product per live row
    block against its expert's weight (``rhs`` [E, K, N], or [E, N, K] read
    transposed), rounded to lhs's dtype; dead blocks give 0. Loops over row
    blocks, so memory stays O(M·N) at any expert count."""
    m_pad = lhs.shape[0]
    _check_layout(m_pad, rhs.shape[0], layout)
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    bm = layout.block_m
    out = torch.empty(m_pad, n, dtype=lhs.dtype, device=lhs.device)
    for b in range(m_pad // bm):
        rows = slice(b * bm, (b + 1) * bm)
        w = rhs.index_select(0, layout.block_expert[b:b + 1].long())[0]
        if transpose_rhs:
            w = w.t()
        prod = lhs[rows].float() @ w.float()
        out[rows] = torch.where(layout.block_live[b] != 0, prod,
                                0.0).to(lhs.dtype)
    return out


def tgmm_reference(lhs: torch.Tensor, dout: torch.Tensor, num_experts: int,
                   layout: GroupedLayout) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: ``[E, K, N]``, expert
    e's slice the f32 sum of ``lhs[r]ᵀ · dout[r]`` over the rows of its
    live blocks, accumulated block by block and rounded to lhs's dtype
    once."""
    m_pad, k = lhs.shape
    _check_layout(m_pad, num_experts, layout)
    bm = layout.block_m
    acc = torch.zeros(num_experts, k, dout.shape[1], dtype=torch.float32,
                      device=lhs.device)
    for b in range(m_pad // bm):
        rows = slice(b * bm, (b + 1) * bm)
        prod = lhs[rows].float().t() @ dout[rows].float()
        acc.index_add_(0, layout.block_expert[b:b + 1].long(),
                       torch.where(layout.block_live[b] != 0, prod, 0.0)[None])
    return acc.to(lhs.dtype)


def _check_cuda(tensors: dict, ints: dict, layout: GroupedLayout):
    """What the kernels take: float32 or bfloat16, one dtype, contiguous and
    16-byte aligned, inner sizes a multiple of 8, int32 contiguous layout
    arrays, block_m a multiple of the kernels' row tile, all on one
    device."""
    first = next(iter(tensors.values()))
    devices = {t.device for t in (*tensors.values(), *ints.values())}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {first.dtype}")
    for name, t in tensors.items():
        if t.dtype != first.dtype:
            raise TypeError(f"{name} must be {first.dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.shape[-1] % 8:
            raise ValueError(f"{name}'s last dimension {t.shape[-1]} must be "
                             "a multiple of 8")
    for name, t in ints.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"layout {name} must be contiguous int32")
    if layout.block_m % KERNEL_BLOCK_M:
        raise ValueError(f"layout block_m {layout.block_m} must be a multiple "
                         f"of the kernels' row tile {KERNEL_BLOCK_M}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _gmm_route(dtype: torch.dtype, which: str = "gmm") -> str:
    """Which kernel takes a CUDA call of ``which`` ("gmm": the forward and
    dlhs; "tgmm"): ``"wgmma"`` (``gmm_wgmma`` and ``tgmm_wgmma`` of
    ``csrc/gmm_wgmma.cu``, tensor cores) for bfloat16; for float32, which
    wgmma cannot multiply in full precision, ``"tf32x3"`` (``gmm_tf32x3``
    and ``tgmm_tf32x3`` of ``csrc/gmm_f32.cu``, three-pass TF32 on the
    tensor cores). ``"mma"`` (``csrc/gmm.cu``) is taken only when named."""
    del which                     # both kernels of a dtype share its route
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _entry(which: str, dtype: torch.dtype, route: str | None):
    """The C entry point of kernel ``which`` ("gmm" or "tgmm") on ``route``
    (None: :func:`_gmm_route`'s choice), and the route."""
    route = _gmm_route(dtype, which) if route is None else route
    if route == "wgmma":
        if dtype != torch.bfloat16:
            raise TypeError(f"the wgmma route takes bfloat16, got {dtype}")
        return getattr(_wgmma_library(), f"{which}_wgmma_launch"), route
    if route == "tf32x3":
        if dtype != torch.float32:
            raise TypeError(f"the tf32x3 route takes float32, got {dtype}")
        return getattr(_tf32x3_library(), f"{which}_tf32x3_launch"), route
    if route == "mma":
        return getattr(_library(), f"{which}_launch"), route
    raise ValueError(f"route must be 'wgmma', 'tf32x3' or 'mma', got "
                     f"{route!r}")


def gmm_forward(lhs: torch.Tensor, rhs: torch.Tensor, layout: GroupedLayout,
                *, transpose_rhs: bool = False,
                route: str | None = None) -> torch.Tensor:
    """``out [M_pad, N]`` in lhs's dtype: each live row block times its
    expert's ``rhs`` [E, K, N] (``transpose_rhs``: [E, N, K], read
    transposed in place), dead blocks 0. CPU tensors take
    :func:`gmm_reference` (and refuse a named ``route``); CUDA tensors
    launch ``gmm_wgmma`` on the ``"wgmma"`` route (bf16), ``gmm_tf32x3``
    on ``"tf32x3"`` (f32) or ``gmm_kernel`` on ``"mma"`` (default:
    :func:`_gmm_route`'s choice; naming it lets a caller time two routes
    on the same inputs), and add one to ``gmm_forward.launches``, and on
    the wgmma route to ``.launches_wgmma``, on the tf32x3 route to
    ``.launches_tf32x3``."""
    if lhs.ndim != 2 or rhs.ndim != 3:
        raise ValueError(f"lhs must be [M, K] and rhs [E, K, N], got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    k = rhs.shape[2] if transpose_rhs else rhs.shape[1]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if lhs.shape[1] != k:
        raise ValueError(f"lhs {tuple(lhs.shape)} does not contract with rhs "
                         f"{tuple(rhs.shape)} (transpose_rhs={transpose_rhs})")
    if lhs.device.type == "cpu" and route is None:
        return gmm_reference(lhs, rhs, layout, transpose_rhs=transpose_rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"no grouped matmul kernel for device {lhs.device}")
    _check_layout(lhs.shape[0], rhs.shape[0], layout)
    _check_cuda({"lhs": lhs, "rhs": rhs},
                {"block_expert": layout.block_expert,
                 "block_live": layout.block_live}, layout)
    launch, route = _entry("gmm", lhs.dtype, route)
    out = torch.empty(lhs.shape[0], n, dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        rc = launch(
            lhs.data_ptr(), rhs.data_ptr(), layout.block_expert.data_ptr(),
            layout.block_live.data_ptr(), out.data_ptr(), lhs.shape[0], k, n,
            rhs.shape[0], layout.block_m, int(transpose_rhs),
            _DTYPE_CODE[lhs.dtype], _stream(lhs.device))
    if rc:
        raise RuntimeError(f"gmm ({route} route) launch failed: CUDA error "
                           f"{rc}")
    if route == "wgmma":
        gmm_forward.launches_wgmma += 1
    gmm_forward.launches_tf32x3 += route == "tf32x3"
    gmm_forward.launches += 1
    return out


def tgmm(lhs: torch.Tensor, dout: torch.Tensor, num_experts: int,
         layout: GroupedLayout, *, route: str | None = None) -> torch.Tensor:
    """``drhs [E, K, N]`` in lhs's dtype: per expert, the f32 sum of
    ``lhs[r]ᵀ · dout[r]`` over the rows of its live blocks. CPU tensors take
    :func:`tgmm_reference` (and refuse a named ``route``); CUDA tensors
    launch ``tgmm_wgmma`` on the ``"wgmma"`` route (bf16), ``tgmm_tf32x3``
    on ``"tf32x3"`` (f32) or ``tgmm_kernel`` on ``"mma"`` (default:
    :func:`_gmm_route`'s choice), and add one to ``tgmm.launches``, and on
    the wgmma route to ``.launches_wgmma``, on the tf32x3 route to
    ``.launches_tf32x3``."""
    if lhs.ndim != 2 or dout.ndim != 2 or dout.shape[0] != lhs.shape[0]:
        raise ValueError(f"lhs [M, K] and dout [M, N] must share M, got "
                         f"{tuple(lhs.shape)}, {tuple(dout.shape)}")
    if lhs.device.type == "cpu" and route is None:
        return tgmm_reference(lhs, dout, num_experts, layout)
    if lhs.device.type != "cuda":
        raise ValueError(f"no grouped matmul kernel for device {lhs.device}")
    _check_layout(lhs.shape[0], num_experts, layout)
    _check_cuda({"lhs": lhs, "dout": dout},
                {"row_offset": layout.row_offset,
                 "group_sizes": layout.group_sizes}, layout)
    launch, route = _entry("tgmm", lhs.dtype, route)
    m_pad, k = lhs.shape
    n = dout.shape[1]
    out = torch.empty(num_experts, k, n, dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        rc = launch(
            lhs.data_ptr(), dout.data_ptr(), layout.row_offset.data_ptr(),
            layout.group_sizes.data_ptr(), out.data_ptr(), m_pad, k, n,
            num_experts, layout.block_m, _DTYPE_CODE[lhs.dtype],
            _stream(lhs.device))
    if rc:
        raise RuntimeError(f"tgmm ({route} route) launch failed: CUDA error "
                           f"{rc}")
    if route == "wgmma":
        tgmm.launches_wgmma += 1
    tgmm.launches_tf32x3 += route == "tf32x3"
    tgmm.launches += 1
    return out


gmm_forward.launches = 0
gmm_forward.launches_wgmma = 0
gmm_forward.launches_tf32x3 = 0
tgmm.launches = 0
tgmm.launches_wgmma = 0
tgmm.launches_tf32x3 = 0


@torch.library.custom_op("k8s_ddl_torch::gmm", mutates_args=())
def _gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, row_offset: torch.Tensor,
            block_expert: torch.Tensor, block_live: torch.Tensor,
            block_first: torch.Tensor, group_sizes: torch.Tensor, m_pad: int,
            block_m: int) -> torch.Tensor:
    layout = GroupedLayout(row_offset, block_expert, block_live, block_first,
                           group_sizes, m_pad, block_m)
    return gmm_forward(lhs, rhs, layout)


class GroupedMatmul(torch.autograd.Function):
    """Forward: the ``k8s_ddl_torch::gmm`` operator. Backward: ``g`` in
    lhs's dtype, ``dlhs = gmm(g, rhsᵀ)`` (the forward kernel reading rhs
    transposed) and ``drhs = tgmm(lhs, g)``, each cast to its primal's
    dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, row_offset, block_expert, block_live,
                block_first, group_sizes, m_pad, block_m):
        out = torch.ops.k8s_ddl_torch.gmm(lhs, rhs, row_offset, block_expert,
                                          block_live, block_first,
                                          group_sizes, m_pad, block_m)
        ctx.save_for_backward(lhs, rhs, row_offset, block_expert, block_live,
                              block_first, group_sizes)
        ctx.meta = (m_pad, block_m)
        return out

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, *arrays = ctx.saved_tensors
        layout = GroupedLayout(*arrays, *ctx.meta)
        g = g.to(lhs.dtype).contiguous()
        dlhs = gmm_forward(g, rhs, layout, transpose_rhs=True)
        drhs = tgmm(lhs, g, rhs.shape[0], layout)
        return (dlhs.to(lhs.dtype), drhs.to(rhs.dtype),
                None, None, None, None, None, None, None)


def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        layout: GroupedLayout) -> torch.Tensor:
    """Grouped matmul: rows of ``lhs`` [M_pad, K] laid out per
    :func:`grouped_layout` times the owning expert's ``rhs`` [E, K, N]
    weight, ``[M_pad, N]`` in lhs's dtype. Differentiable in lhs and rhs."""
    return GroupedMatmul.apply(
        lhs, rhs, layout.row_offset, layout.block_expert, layout.block_live,
        layout.block_first, layout.group_sizes, layout.m_pad, layout.block_m)


def _bind(name: str, kernel: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library with its ``<kernel>_launch`` and
    ``t<kernel>_launch`` entry points typed (the three sources take the
    same arguments)."""
    lib = _build.load(name)
    gmm_fn, tgmm_fn = (getattr(lib, f"{p}{kernel}_launch")
                       for p in ("", "t"))
    if gmm_fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        gmm_fn.argtypes = [ptr] * 5 + [i] * 7 + [ptr]
        tgmm_fn.argtypes = [ptr] * 5 + [i] * 6 + [ptr]
        gmm_fn.restype = tgmm_fn.restype = ctypes.c_int
    return lib


def _library():
    return _bind("gmm", "gmm")


def _wgmma_library():
    return _bind("gmm_wgmma", "gmm_wgmma")


def _tf32x3_library():
    return _bind("gmm_f32", "gmm_tf32x3")
