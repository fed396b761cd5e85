"""Paged grouped-query attention straight off the KV page pool.

Port of ``k8s_distributed_deeplearning_tpu/ops/pallas_paged_attn.py``,
both branches. The serving engine keeps K/V as one pool of fixed-size pages
per layer, ``[num_pages, page_tokens, kv·head_dim]``, and each batch row
maps its virtual sequence onto pool pages through a block table. Query
``i`` of row ``b`` attends virtual columns ``<= positions[b, i]``: stale
K/V beyond a row's cursor and the scratch page (table entries 0) are never
read into the result. Under int8 KV (``k_scale``/``v_scale`` given) the
pools are int8 and each token has one f32 scale per KV head,
``[num_pages, page_tokens, kv]``; K and V are dequantized as
``f32(int8) * scale``.

- :func:`paged_decode_attention` launches a hand-written CUDA kernel on
  CUDA tensors, and takes the plain version on CPU tensors. Three kernels
  share the contract, and :func:`_route` picks one by shape alone, for q
  with ``sq`` positions and ``group = H / kv`` query heads a KV head:
  bf16 decode and short verify windows (``sq x group <= 16``) at head_dim
  64 or 128 go to the tensor-core decode kernel (``csrc/paged_decode.cu``,
  route ``"decode"``); bf16 query chunks with ``sq x group >= 64`` at
  head_dim 64 or 128 to the tensor-core prefill kernel
  (``csrc/paged_prefill.cu``, route ``"prefill"``); f32 q, other head
  dims and the windows in between to the split kernel
  (``csrc/paged_attn.cu``, route ``"split"``). There is no fallback from
  one to another: a CUDA tensor the chosen kernel cannot take, or a
  failed build or launch, raises.
- :func:`paged_decode_attention_reference` is the plain version: gather the
  row's pages, mask, softmax, the same arithmetic as the XLA gather path in
  the JAX model (``models/transformer.py`` paged branch), except that a
  row with no visible column gives exactly 0, as the kernel does. Under
  int8 it follows the Pallas kernel's int8 arithmetic, not the XLA
  path's: K and V are dequantized to f32, and the probabilities stay f32
  for P·V.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from k8s_distributed_deeplearning_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
# The prefill route: bf16 q, at least one 64-row wgmma tile of flattened
# (position, group head) rows per KV head, head_dim 64 or 128.
_PREFILL_MIN_ROWS = 64
_PREFILL_HEAD_DIMS = (64, 128)
# The decode route: bf16 q, at most one 16-row mma tile of flattened rows
# per KV head, head_dim 64 or 128. A (row, KV head) takes a cluster of up
# to _DECODE_MAX_SPLITS CTAs, about _DECODE_CTAS_PER_SM an SM in all.
_DECODE_MAX_ROWS = 16
_DECODE_HEAD_DIMS = (64, 128)
_DECODE_CTAS_PER_SM = 2
_DECODE_MAX_SPLITS = 8


def _check_shapes(q, pool_k, pool_v, block_tables, positions,
                  k_scale=None, v_scale=None):
    """The Pallas wrapper's validation (pallas_paged_attn.py:167-197).
    Returns (b, sq, h, hd, page_tokens, hkv)."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, sq, H, hd], got {tuple(q.shape)}")
    if pool_k.ndim != 3 or pool_k.shape != pool_v.shape:
        raise ValueError(
            f"pool_k/pool_v must be identical [num_pages, page_tokens, "
            f"kv*hd], got {tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    b, sq, h, hd = q.shape
    _, page_tokens, kvhd = pool_k.shape
    if kvhd % hd:
        raise ValueError(
            f"pool lane dim {kvhd} is not a multiple of head_dim {hd}")
    hkv = kvhd // hd
    if h % hkv:
        raise ValueError(f"{h} q heads not divisible by {hkv} kv heads")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"block_tables must be [B={b}, n_blocks], "
            f"got {tuple(block_tables.shape)}")
    if tuple(positions.shape) != (b, sq):
        raise ValueError(
            f"positions must be [B={b}, sq={sq}], "
            f"got {tuple(positions.shape)}")
    scales = ()
    if k_scale is not None or v_scale is not None:
        if k_scale is None or v_scale is None:
            raise ValueError("k_scale and v_scale must be passed together")
        want = tuple(pool_k.shape[:2]) + (hkv,)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"k_scale/v_scale must be {want} (per-token-per-head), "
                f"got {tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
        if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
            raise TypeError(
                f"k_scale/v_scale come with int8 pools, got "
                f"{pool_k.dtype} / {pool_v.dtype}")
        scales = (k_scale, v_scale)
    devices = {t.device for t in (q, pool_k, pool_v, block_tables,
                                  positions, *scales)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    return b, sq, h, hd, page_tokens, hkv


def paged_decode_attention_reference(q: torch.Tensor, pool_k: torch.Tensor,
                                     pool_v: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     positions: torch.Tensor, *,
                                     k_scale: torch.Tensor | None = None,
                                     v_scale: torch.Tensor | None = None,
                                     softmax_scale: float | None = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_decode_attention`: gather each
    row's pages into its ``[n_blocks·page_tokens]`` virtual sequence, mask
    ``col > positions``, softmax in f32, probabilities cast to the value
    dtype for P·V (accumulated in f32), output in q's dtype. Int8 pools are
    dequantized to f32 (``f32(int8) * scale``), so their probabilities
    stay f32, as in the Pallas kernel's int8 branch."""
    b, sq, h, hd, page_tokens, hkv = _check_shapes(
        q, pool_k, pool_v, block_tables, positions, k_scale, v_scale)
    group = h // hkv
    s_virt = block_tables.shape[1] * page_tokens
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    tables = block_tables.long()
    k_all = pool_k[tables].reshape(b, s_virt, hkv, hd)
    v_all = pool_v[tables].reshape(b, s_virt, hkv, hd)
    if k_scale is not None:
        k_all = k_all.float() * k_scale[tables].reshape(b, s_virt, hkv, 1)
        v_all = v_all.float() * v_scale[tables].reshape(b, s_virt, hkv, 1)
    qg = q.reshape(b, sq, hkv, group, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k_all.float()) * scale
    col = torch.arange(s_virt, device=q.device)
    allow = col[None, None, :] <= positions.long()[:, :, None]  # [B, sq, S]
    scores = scores.masked_fill(~allow[:, None, None], float("-inf"))
    # exp(s - max) / sum, with a row that sees no column giving 0 (the
    # kernel's p = 0 guard and max(l, 1e-30) floor) instead of NaN.
    m = scores.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(scores - m)
    probs = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_all.dtype).float(),
                       v_all.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _route(sq: int, group: int, head_dim: int, q_dtype: torch.dtype,
           quant: bool) -> str:
    """Which kernel takes a CUDA call, with fp or int8 (``quant``) pools
    alike: for bf16 q at head_dim 64 or 128, ``"decode"`` (tensor cores)
    when the flattened (position, group head) rows per KV head fit one
    16-row tile, ``sq * group <= 16`` (decode at every group size the port
    serves, and short verify windows), and ``"prefill"`` (tensor cores)
    when they fill at least one 64-row wgmma tile, ``sq * group >= 64``;
    ``"split"`` otherwise: f32 q, other head dims, and ``16 < sq * group
    < 64``."""
    del quant                     # both branches take every route
    if q_dtype == torch.bfloat16:
        if sq * group <= _DECODE_MAX_ROWS and head_dim in _DECODE_HEAD_DIMS:
            return "decode"
        if (sq * group >= _PREFILL_MIN_ROWS
                and head_dim in _PREFILL_HEAD_DIMS):
            return "prefill"
    return "split"


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           softmax_scale: float | None = None
                           ) -> torch.Tensor:
    """Grouped-query attention straight off the page pool.

    q: ``[B, sq, H, hd]`` (``sq`` = 1 for decode, the chunk width for a
    prefill chunk); pool_k/pool_v: ``[num_pages, page_tokens, kv·hd]``,
    written BEFORE this call so a chunk's tokens see each other;
    block_tables: ``[B, n_blocks]`` int32 (0 = the never-attended scratch
    page); positions: ``[B, sq]`` int32, query ``i`` of row ``b`` attends
    virtual columns ``<= positions[b, i]``. Returns ``[B, sq, H, hd]`` in
    q's dtype. ``k_scale``/``v_scale`` (both or neither), each
    ``[num_pages, page_tokens, kv]`` f32, select the int8 branch: the pools
    are int8 and are dequantized in the kernel.

    CPU tensors go to :func:`paged_decode_attention_reference`. CUDA
    tensors launch the kernel :func:`_route` names from the shape: bf16 q
    at head_dim 64 or 128 runs the tensor-core decode kernel when
    ``sq * (H / kv) <= 16`` and the tensor-core prefill kernel when
    ``sq * (H / kv) >= 64``; everything else runs the split kernel. All
    three take pools of q's dtype (or int8 with f32 scales), int32 tables
    and positions, all contiguous and the pools 16-byte aligned; the
    decode and prefill kernels take bfloat16 q, 16-byte aligned; the split
    kernel takes float32 or bfloat16 q and a ``head_dim`` that is a
    multiple of 8 (of 16 for int8 pools) up to 256; anything else raises.
    Each launch adds one to ``paged_decode_attention.launches`` (fp pools)
    or ``.launches_int8`` (int8 pools), whichever the route; a launch of
    the decode route also adds one to ``.launches_decode`` or
    ``.launches_decode_int8``, one of the prefill route to
    ``.launches_prefill`` or ``.launches_prefill_int8``.
    """
    b, sq, h, hd, page_tokens, hkv = _check_shapes(
        q, pool_k, pool_v, block_tables, positions, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pool_k, pool_v, block_tables, positions, k_scale=k_scale,
            v_scale=v_scale, softmax_scale=softmax_scale)
    route = _route(sq, h // hkv, hd, q.dtype, k_scale is not None)
    return _launch(q, pool_k, pool_v, block_tables, positions,
                   k_scale=k_scale, v_scale=v_scale,
                   softmax_scale=softmax_scale, route=route)


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
paged_decode_attention.launches_prefill = 0
paged_decode_attention.launches_prefill_int8 = 0
paged_decode_attention.launches_decode = 0
paged_decode_attention.launches_decode_int8 = 0


def _launch(q, pool_k, pool_v, block_tables, positions, *, k_scale=None,
            v_scale=None, softmax_scale=None, route: str,
            tile_rows: int = 0) -> torch.Tensor:
    """Launch the kernel of ``route`` on CUDA tensors, counting the launch
    on :func:`paged_decode_attention`. :func:`paged_decode_attention`
    calls it with :func:`_route`'s choice; naming the route here lets a
    caller time two kernels on the same inputs. ``tile_rows`` (prefill
    route: 64 or 128, 0 = the kernel's own choice) fixes the row tile."""
    b, sq, h, hd, page_tokens, hkv = _check_shapes(
        q, pool_k, pool_v, block_tables, positions, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for device {q.device}")
    if route not in ("decode", "prefill", "split"):
        raise ValueError(f"route must be 'decode', 'prefill' or 'split', "
                         f"got {route!r}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16 q, got {q.dtype}")
    quant = k_scale is not None
    if quant:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"k_scale/v_scale must be float32, got "
                            f"{k_scale.dtype} / {v_scale.dtype}")
    elif pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(
            f"pools must share q's dtype {q.dtype}, got {pool_k.dtype} / "
            f"{pool_v.dtype}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError(
            f"block_tables/positions must be int32, got "
            f"{block_tables.dtype} / {positions.dtype}")
    if route == "prefill":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the prefill kernel takes bfloat16 q, got "
                            f"{q.dtype}")
        if hd not in _PREFILL_HEAD_DIMS:
            raise ValueError(f"the prefill kernel takes head_dim "
                             f"{_PREFILL_HEAD_DIMS}, got {hd}")
        if tile_rows not in (0, 64, 128):
            raise ValueError(f"tile_rows must be 0, 64 or 128, got "
                             f"{tile_rows}")
    elif route == "decode":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the decode kernel takes bfloat16 q, got "
                            f"{q.dtype}")
        if hd not in _DECODE_HEAD_DIMS:
            raise ValueError(f"the decode kernel takes head_dim "
                             f"{_DECODE_HEAD_DIMS}, got {hd}")
        if sq * (h // hkv) > _DECODE_MAX_ROWS:
            raise ValueError(f"the decode kernel takes sq x group <= "
                             f"{_DECODE_MAX_ROWS} rows per KV head, got "
                             f"{sq} x {h // hkv}")
    else:
        if hd > _MAX_HEAD_DIM or hd % 8:
            raise ValueError(f"kernel takes head_dim <= {_MAX_HEAD_DIM} and "
                             f"a multiple of 8, got {hd}")
        if quant and hd % 16:
            raise ValueError(f"the int8 kernel takes a head_dim that is a "
                             f"multiple of 16 (16-byte copies), got {hd}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_tables", block_tables), ("positions", positions),
                    *((("k_scale", k_scale), ("v_scale", v_scale))
                      if quant else ())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pool_k/pool_v must start 16-byte aligned")
    if route in ("decode", "prefill") and q.data_ptr() % 16:
        raise ValueError(f"the {route} kernel takes q 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n_blocks = block_tables.shape[1]
    out = torch.empty_like(q)
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quant
              else (None, None))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "decode":
            rc = _library("paged_decode").paged_decode_fwd(
                q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
                block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), b, sq, h, hkv, hd, page_tokens, n_blocks,
                _DTYPE_CODE[q.dtype], _decode_splits(b, hkv, _num_sms(
                    q.device)), scale, stream)
        elif route == "prefill":
            rc = _library("paged_prefill").paged_prefill_fwd(
                q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
                block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), b, sq, h, hkv, hd, page_tokens, n_blocks,
                _DTYPE_CODE[q.dtype], scale, tile_rows, stream)
        else:
            lib = _library("paged_attn")
            n_splits = lib.paged_attn_num_splits(
                b, sq, h, hkv, hd, page_tokens, n_blocks,
                _num_sms(q.device))
            # Decode splits its key range across blocks; the partial
            # softmax states (max, sum, unnormalized output per query row)
            # go here.
            ws = (torch.empty(b * n_splits * h * sq * (hd + 2),
                              dtype=torch.float32, device=q.device)
                  if n_splits > 1 else None)
            rc = lib.paged_attn_fwd(
                q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
                block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(), b, sq,
                h, hkv, hd, page_tokens, n_blocks, n_splits,
                _DTYPE_CODE[q.dtype], scale, stream)
    if rc:
        raise RuntimeError(f"{route} paged attention launch failed: CUDA "
                           f"error {rc}")
    fn = paged_decode_attention
    if quant:
        fn.launches_int8 += 1
        fn.launches_prefill_int8 += route == "prefill"
        fn.launches_decode_int8 += route == "decode"
    else:
        fn.launches += 1
        fn.launches_prefill += route == "prefill"
        fn.launches_decode += route == "decode"
    return out


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _decode_splits(batch: int, n_kv: int, num_sms: int) -> int:
    """CTAs per (row, KV head) of the decode kernel: _DECODE_CTAS_PER_SM
    an SM over the batch rows and KV heads, 1 to _DECODE_MAX_SPLITS."""
    want = -(-_DECODE_CTAS_PER_SM * num_sms // (batch * n_kv))
    return max(1, min(want, _DECODE_MAX_SPLITS))


# The C entry points of each kernel library: argument and result types.
_SIGNATURES = {
    "paged_decode": {
        "paged_decode_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                             + [ctypes.c_float, ctypes.c_void_p],
                             ctypes.c_int),
    },
    "paged_attn": {
        "paged_attn_num_splits": ([ctypes.c_int] * 8, ctypes.c_int),
        "paged_attn_fwd": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    },
    "paged_prefill": {
        "paged_prefill_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                              + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p], ctypes.c_int),
    },
}


def _library(name: str):
    lib = _build.load(name)
    for fn, (args, result) in _SIGNATURES[name].items():
        entry = getattr(lib, fn)
        if entry.argtypes is None:
            entry.argtypes, entry.restype = args, result
    return lib
