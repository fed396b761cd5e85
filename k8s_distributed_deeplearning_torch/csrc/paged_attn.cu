// Paged grouped-query attention straight off the KV page pool, for Hopper.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_paged_attn.py,
// `_kernel` (launched by `paged_decode_attention`), both branches: fp
// pools, and int8 pools with per-token-per-head scales (`quant=True`).
//
// Contract (identical to the Pallas kernel's):
//   q          [B, sq, H, hd]                   float32 or bfloat16
//   pool_k/v   [num_pages, page_tokens, kv*hd]  q's dtype, or int8
//   k/v_scale  [num_pages, page_tokens, kv]     float32, int8 pools only
//   tables     [B, n_blocks] int32  (virtual block -> pool page, 0 = scratch)
//   positions  [B, sq] int32        (query i of row b attends col <= pos[b,i])
//   out        [B, sq, H, hd]       q's dtype
// q head h attends KV head h / (H/kv). Scores are masked with NEG_INF =
// -1e30; a masked score contributes exactly 0 (p = 0 where s <= NEG_INF/2),
// and a fully masked row emits 0 through the max(l, 1e-30) floor.
// Rounding, as in the Pallas kernel: the fp branch rounds p to the value
// dtype for P.V; the int8 branch dequantizes each element as
// f32(int8) * scale (the scale of its token and KV head) when the tile is
// read, and keeps p in f32, since the dequantized V is f32.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense):
//   decode (sq = 1):  bytes.  K and V of the live pages, once each:
//                     sum_b live_b * kv * hd * 2 * itemsize / 3.35 TB/s,
//                     plus, for int8, the two f32 scales per token and head.
//   prefill (sq = C): max(FLOPs / 989 TF/s, bytes / 3.35 TB/s), with
//                     FLOPs = 4 * H * hd * sum_{b,i} (pos[b,i] + 1).
// What the design does about it:
// - One thread block per (row b, KV head, tile of query rows, key split).
//   A row tile holds every query head of the KV head's group, so each K/V
//   element is read from device memory once per tile and shared by the
//   whole group, and a block walks the block table only up to its tile's
//   largest cursor: bytes follow the live length, not the table width.
// - Decode has few rows (B * kv blocks), too few to fill 132 SMs, so the
//   key range is split across blocks (flash-decoding): each split writes
//   its partial (max, sum, unnormalized output) to a workspace and a
//   second kernel combines them. Prefill chunks have enough row tiles and
//   run unsplit.
// - 32-key tiles of K and V are copied page by page into shared memory
//   with cp.async, double-buffered, so the next tile's loads are in flight
//   while the current one is computed. An int8 tile is half a bf16 one;
//   its 32 f32 scales per pool ride the same cp.async group, and 16-byte
//   copies of a head's int8 slice need head_dim % 16 == 0.
// - Scores and P.V run in f32 on the CUDA cores (each lane owns one key
//   for the scores and hd/32 output dims for P.V; the online softmax lives
//   in registers), not on the tensor cores: prefill chunks stay far from
//   their FLOP bound (PERF.md has the measured times).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KT = 32;             // keys per tile: one per lane
constexpr int NWARPS = 4;          // warps per block
constexpr int NT = NWARPS * 32;    // threads per block
constexpr int RPW_MAX = 4;         // query rows per warp, at most
constexpr int MAX_HEAD_DIM = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four int8 values packed in a 32-bit word, lowest byte first, as floats.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float* o) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

// N consecutive elements of T starting at p, as floats. p is aligned to
// min(N * sizeof(T), 16) bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (sizeof(T) == 1) {
    if constexpr (N % 16 == 0) {
#pragma unroll
      for (int c = 0; c < N / 16; ++c) {
        const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
        s8x4_to_f32(raw.x, out + 16 * c);
        s8x4_to_f32(raw.y, out + 16 * c + 4);
        s8x4_to_f32(raw.z, out + 16 * c + 8);
        s8x4_to_f32(raw.w, out + 16 * c + 12);
      }
    } else if constexpr (N == 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      s8x4_to_f32(raw.x, out);
      s8x4_to_f32(raw.y, out + 4);
    } else if constexpr (N == 4) {
      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), out);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = static_cast<float>(p[i]);
    }
  } else if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float* o = out + c * (16 / (int)sizeof(T));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 4) {
          o[k] = __uint_as_float(w[k]);
        } else {
          o[2 * k] = __uint_as_float(w[k] << 16);
          o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
      }
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if constexpr (sizeof(T) == 4) {
        out[k] = __uint_as_float(w[k]);
      } else {
        out[2 * k] = __uint_as_float(w[k] << 16);
        out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;    // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4 bytes, through L1 (cp.async.cg takes only 16); zero-filled when
// !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Plan {
  int rpw, rows, row_tiles, n_splits, tiles_per_split, tab_cap;
  size_t smem;
};

// S: the pools' element type (float, bf16 or int8).
template <typename S>
Plan make_plan(int batch, int sq, int n_heads, int n_kv, int hd,
               int page_tokens, int n_blocks, int n_splits) {
  Plan p;
  const int rows_total = sq * (n_heads / n_kv);
  p.rpw = (rows_total + NWARPS - 1) / NWARPS;
  p.rpw = p.rpw < 1 ? 1 : (p.rpw > RPW_MAX ? RPW_MAX : p.rpw);
  p.rows = NWARPS * p.rpw;
  p.row_tiles = (rows_total + p.rows - 1) / p.rows;
  const int tiles_total = (n_blocks * page_tokens + KT - 1) / KT;
  p.n_splits = n_splits;
  p.tiles_per_split = (tiles_total + n_splits - 1) / n_splits;
  p.tab_cap = (p.tiles_per_split * KT + page_tokens - 1) / page_tokens + 2;
  const int vec = 16 / (int)sizeof(S);
  const size_t scales = sizeof(S) == 1 ? sizeof(float) * 4 * KT : 0;
  p.smem = sizeof(float) * (size_t)p.rows * hd +
           sizeof(S) * (size_t)2 * KT * (hd + vec) +
           sizeof(S) * (size_t)2 * KT * hd + scales +
           sizeof(int) * (size_t)p.tab_cap;
  return p;
}

// Grid: (row tiles, kv heads, B * n_splits). Flattened row r of a (b, kv
// head) is query position r / group of q head kvh * group + r % group;
// a row tile is NWARPS * rpw consecutive rows, rpw per warp. Split s
// covers key tiles [s * tiles_per_split, (s + 1) * tiles_per_split).
// T: q and out; S: the pools, T itself or int8 (then with the scales).
template <typename T, typename S, int DPL>
__global__ void __launch_bounds__(NT)
paged_attn_kernel(const T* __restrict__ q, const S* __restrict__ pool_k,
                  const S* __restrict__ pool_v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ positions, T* __restrict__ out,
                  float* __restrict__ ws, int sq, int n_heads, int n_kv,
                  int hd, int page_tokens, int n_blocks, int rpw,
                  int n_splits, int tiles_per_split, float scale) {
  constexpr bool QUANT = sizeof(S) == 1;
  constexpr int VEC = 16 / (int)sizeof(S);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int pos_s[NWARPS * RPW_MAX];
  __shared__ int kmax_s;

  const int group = n_heads / n_kv;
  const int rows_total = sq * group;
  const int rows = NWARPS * rpw;
  const int row0 = blockIdx.x * rows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / n_splits;
  const int split = blockIdx.z - b * n_splits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kstr = hd + VEC;   // padded K row: 16-byte chunks hit 32 banks

  float* q_s = reinterpret_cast<float*>(smem_raw);       // [rows][hd]
  S* k_s = reinterpret_cast<S*>(q_s + rows * hd);         // [2][KT][kstr]
  S* v_s = k_s + 2 * KT * kstr;                           // [2][KT][hd]
  // int8 only: K scales [2][KT], then V scales [2][KT].
  float* sc_s = reinterpret_cast<float*>(v_s + 2 * KT * hd);
  int* tab_s = reinterpret_cast<int*>(sc_s + (QUANT ? 4 * KT : 0));

  for (int idx = tid; idx < rows * hd; idx += NT) {
    const int r = idx / hd, d = idx - r * hd;
    const int fr = row0 + r;
    float x = 0.f;
    if (fr < rows_total) {
      const int i = fr / group, h = kvh * group + fr % group;
      x = to_f32(q[(((size_t)b * sq + i) * n_heads + h) * hd + d]);
    }
    q_s[idx] = x;
  }
  if (tid < rows) {
    const int fr = row0 + tid;
    pos_s[tid] = fr < rows_total ? positions[(size_t)b * sq + fr / group] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int m = -1;
    for (int r = 0; r < rows; ++r) m = max(m, pos_s[r]);
    // Columns past the table's last block do not exist.
    kmax_s = min(m, n_blocks * page_tokens - 1);
  }
  __syncthreads();
  const int c_begin = split * tiles_per_split * KT;
  const int c_end = min(c_begin + tiles_per_split * KT, kmax_s + 1);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + KT - 1) / KT : 0;
  const int blk0 = c_begin / page_tokens;
  if (n_tiles > 0) {
    const int n_tab = (c_end - 1) / page_tokens - blk0 + 1;
    for (int i = tid; i < n_tab; i += NT)
      tab_s[i] = tables[(size_t)b * n_blocks + blk0 + i];
  }
  __syncthreads();

  const size_t tok_stride = (size_t)n_kv * hd;
  const int chunks = hd / VEC;   // 16-byte chunks per K/V row
  auto issue = [&](int t, int buf) {
    const int c0 = c_begin + t * KT;
    S* kb = k_s + buf * KT * kstr;
    S* vb = v_s + buf * KT * hd;
    for (int idx = tid; idx < KT * chunks; idx += NT) {
      const int j = idx / chunks, ch = idx - j * chunks;
      const int c = c0 + j;
      const bool valid = c < c_end;
      size_t off = 0;
      if (valid) {
        const int pg = tab_s[c / page_tokens - blk0];
        off = ((size_t)pg * page_tokens + c % page_tokens) * tok_stride +
              (size_t)kvh * hd + ch * VEC;
      }
      cp_async16(kb + j * kstr + ch * VEC, pool_k + off, valid);
      cp_async16(vb + j * hd + ch * VEC, pool_v + off, valid);
    }
    if constexpr (QUANT) {
      if (tid < KT) {           // scale of (token c, this KV head)
        const int c = c0 + tid;
        const bool valid = c < c_end;
        size_t off = 0;
        if (valid)
          off = ((size_t)tab_s[c / page_tokens - blk0] * page_tokens +
                 c % page_tokens) * n_kv + kvh;
        cp_async4(sc_s + buf * KT + tid, k_scale + off, valid);
        cp_async4(sc_s + 2 * KT + buf * KT + tid, v_scale + off, valid);
      }
    }
    cp_async_commit();
  };

  float m_r[RPW_MAX], l_r[RPW_MAX], acc[RPW_MAX][DPL];
#pragma unroll
  for (int r = 0; r < RPW_MAX; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int d0 = lane * DPL;     // this lane's output dims [d0, d0 + DPL)

  if (n_tiles > 0) issue(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = c_begin + t * KT;
    bool live = false;           // warp-uniform: any row of this warp
#pragma unroll
    for (int r = 0; r < RPW_MAX; ++r)
      if (r < rpw) live |= pos_s[warp * rpw + r] >= c0;
    if (live) {
      const S* kb = k_s + (t & 1) * KT * kstr;
      const S* vb = v_s + (t & 1) * KT * hd;
      const float* vsc = sc_s + 2 * KT + (t & 1) * KT;
      float s[RPW_MAX];
#pragma unroll
      for (int r = 0; r < RPW_MAX; ++r) s[r] = 0.f;
      const S* kr = kb + lane * kstr;
      const float ksc = QUANT ? sc_s[(t & 1) * KT + lane] : 1.f;
      for (int d = 0; d < hd; d += VEC) {
        float kx[VEC];
        load_f32<S, VEC>(kr + d, kx);
        if constexpr (QUANT) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[e] *= ksc;   // dequant
        }
#pragma unroll
        for (int r = 0; r < RPW_MAX; ++r) {
          if (r >= rpw) break;
          const float4* qr =
              reinterpret_cast<const float4*>(q_s + (warp * rpw + r) * hd + d);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qv = qr[e];
            s[r] = fmaf(qv.x, kx[4 * e], s[r]);
            s[r] = fmaf(qv.y, kx[4 * e + 1], s[r]);
            s[r] = fmaf(qv.z, kx[4 * e + 2], s[r]);
            s[r] = fmaf(qv.w, kx[4 * e + 3], s[r]);
          }
        }
      }
      const int c = c0 + lane;
      float p[RPW_MAX];
#pragma unroll
      for (int r = 0; r < RPW_MAX; ++r) {
        p[r] = 0.f;
        if (r >= rpw) break;
        const int lim = pos_s[warp * rpw + r];
        const float x = (c < c_end && c <= lim) ? s[r] * scale : NEG_INF;
        const float m_new = fmaxf(m_r[r], warp_max(x));
        float pr = expf(x - m_new);
        pr = x <= NEG_INF * 0.5f ? 0.f : pr;
        const float alpha = expf(m_r[r] - m_new);
        l_r[r] = alpha * l_r[r] + warp_sum(pr);
        m_r[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
        // P.V takes p in the value dtype, as the Pallas kernel does: the
        // pool's for fp, f32 for int8 (V is dequantized to f32).
        if constexpr (QUANT)
          p[r] = pr;
        else
          p[r] = to_f32(from_f32<S>(pr));
      }
      for (int j = 0; j < KT; ++j) {
        float vx[DPL];
        if (d0 < hd) {
          load_f32<S, DPL>(vb + j * hd + d0, vx);
          if constexpr (QUANT) {
#pragma unroll
            for (int i = 0; i < DPL; ++i) vx[i] *= vsc[j];     // dequant
          }
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) vx[i] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < RPW_MAX; ++r) {
          if (r >= rpw) break;
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vx[i], acc[r][i]);
        }
      }
    }
    __syncthreads();
  }

  const size_t n_part = (size_t)gridDim.z * n_kv * rows_total;
#pragma unroll
  for (int r = 0; r < RPW_MAX; ++r) {
    if (r >= rpw) break;
    const int fr = row0 + warp * rpw + r;
    if (fr >= rows_total || d0 >= hd) continue;
    if (n_splits == 1) {
      const int i = fr / group, h = kvh * group + fr % group;
      const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
      T* o = out + (((size_t)b * sq + i) * n_heads + h) * hd + d0;
#pragma unroll
      for (int k = 0; k < DPL; ++k) o[k] = from_f32<T>(acc[r][k] * inv);
    } else {
      // Workspace: m [B][kv][splits][rows], l likewise, then acc [..][hd].
      const size_t part =
          (((size_t)b * n_kv + kvh) * n_splits + split) * rows_total + fr;
      if (lane == 0) {
        ws[part] = m_r[r];
        ws[n_part + part] = l_r[r];
      }
      float* a = ws + 2 * n_part + part * hd + d0;
#pragma unroll
      for (int k = 0; k < DPL; ++k) a[k] = acc[r][k];
    }
  }
}

// One thread per (b, kv head, row, dim): merge the splits' partial
// softmax states and write the normalized output.
template <typename T>
__global__ void __launch_bounds__(256)
paged_attn_combine(const float* __restrict__ ws, T* __restrict__ out,
                   int batch, int sq, int n_heads, int n_kv, int hd,
                   int n_splits) {
  const int group = n_heads / n_kv;
  const int rows_total = sq * group;
  const size_t total = (size_t)batch * n_kv * rows_total * hd;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % hd);
  size_t rest = idx / hd;
  const int r = (int)(rest % rows_total);
  rest /= rows_total;
  const int kvh = (int)(rest % n_kv);
  const int b = (int)(rest / n_kv);
  const size_t n_part = (size_t)batch * n_splits * n_kv * rows_total;
  const size_t base = ((size_t)b * n_kv + kvh) * n_splits * rows_total + r;
  float m = NEG_INF;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, ws[base + s * rows_total]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t part = base + (size_t)s * rows_total;
    const float w = expf(ws[part] - m);
    l += w * ws[n_part + part];
    o += w * ws[2 * n_part + part * hd + d];
  }
  const int i = r / group, h = kvh * group + r % group;
  out[(((size_t)b * sq + i) * n_heads + h) * hd + d] =
      from_f32<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, typename S, int DPL>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* ks, const void* vs, const void* tables,
                   const void* positions, void* out, void* ws, int batch,
                   int sq, int n_heads, int n_kv, int hd, int page_tokens,
                   int n_blocks, int n_splits, float scale,
                   cudaStream_t stream) {
  const Plan p = make_plan<S>(batch, sq, n_heads, n_kv, hd, page_tokens,
                              n_blocks, n_splits);
  // The static arrays share the default 48 KB with the dynamic part.
  if (p.smem > 47 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T, S, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(p.row_tiles, n_kv, batch * n_splits);
  paged_attn_kernel<T, S, DPL><<<grid, NT, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(pk),
      static_cast<const S*>(pv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions), static_cast<T*>(out),
      static_cast<float*>(ws), sq, n_heads, n_kv, hd, page_tokens, n_blocks,
      p.rpw, n_splits, p.tiles_per_split, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  const size_t total = (size_t)batch * n_kv * sq * (n_heads / n_kv) * hd;
  paged_attn_combine<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), batch, sq,
      n_heads, n_kv, hd, n_splits);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch(const void* q, const void* pk, const void* pv,
                     const void* ks, const void* vs, const void* tables,
                     const void* positions, void* out, void* ws, int batch,
                     int sq, int n_heads, int n_kv, int hd, int page_tokens,
                     int n_blocks, int n_splits, float scale,
                     cudaStream_t stream) {
  const int dpl = (hd + 31) / 32;
#define PAGED_ATTN_CASE(N)                                                   \
  if (dpl <= N)                                                              \
    return launch<T, S, N>(q, pk, pv, ks, vs, tables, positions, out, ws,   \
                           batch, sq, n_heads, n_kv, hd, page_tokens,        \
                           n_blocks, n_splits, scale, stream);
  PAGED_ATTN_CASE(1)
  PAGED_ATTN_CASE(2)
  PAGED_ATTN_CASE(4)
  PAGED_ATTN_CASE(8)
#undef PAGED_ATTN_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int batch, int sq, int n_heads, int n_kv, int hd,
               int page_tokens, int n_blocks) {
  return batch <= 0 || sq <= 0 || n_kv <= 0 || n_heads % n_kv || hd <= 0 ||
         hd % 8 || hd > MAX_HEAD_DIM || page_tokens <= 0 || n_blocks <= 0;
}

}  // namespace

// How many key splits `paged_attn_fwd` should run: enough blocks for two
// per SM, each split at least two 32-key tiles. The caller sizes the
// workspace from it: 4 * B * n_splits * H * sq * (hd + 2) bytes when it
// is above 1, none otherwise. Returns 0 for shapes the kernel does not
// take.
extern "C" int paged_attn_num_splits(int batch, int sq, int n_heads,
                                     int n_kv, int hd, int page_tokens,
                                     int n_blocks, int num_sms) {
  if (bad_shape(batch, sq, n_heads, n_kv, hd, page_tokens, n_blocks))
    return 0;
  const Plan p = make_plan<float>(batch, sq, n_heads, n_kv, hd, page_tokens,
                                  n_blocks, 1);
  const long base = (long)p.row_tiles * n_kv * batch;
  const long target = 2L * num_sms;
  if (base >= target) return 1;
  const int tiles_total = (n_blocks * page_tokens + KT - 1) / KT;
  long s = (target + base - 1) / base;
  const long cap = (tiles_total + 1) / 2;
  s = s < cap ? s : cap;
  return s < 1 ? 1 : (int)s;
}

// dtype: 0 = float32, 1 = bfloat16 (q, out, and fp pools). k_scale and
// v_scale: both null for fp pools of q's dtype, or both given for int8
// pools (then head_dim % 16 == 0). ws: float32 workspace sized as
// paged_attn_num_splits says (unused when n_splits == 1). Returns
// cudaGetLastError() after the launches (cudaSuccess = 0), or
// cudaErrorInvalidValue for arguments the kernel does not take; the Python
// wrapper checks those first and raises on any nonzero return.
extern "C" int paged_attn_fwd(const void* q, const void* pool_k,
                              const void* pool_v, const void* k_scale,
                              const void* v_scale, const void* tables,
                              const void* positions, void* out, void* ws,
                              int batch, int sq, int n_heads, int n_kv,
                              int hd, int page_tokens, int n_blocks,
                              int n_splits, int dtype, float scale,
                              void* stream) {
  const bool quant = k_scale != nullptr;
  if (bad_shape(batch, sq, n_heads, n_kv, hd, page_tokens, n_blocks) ||
      n_splits < 1 || (n_splits > 1 && ws == nullptr) ||
      quant != (v_scale != nullptr) || (quant && hd % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ATTN_DISPATCH(T, S)                                            \
  return (int)dispatch<T, S>(q, pool_k, pool_v, k_scale, v_scale, tables,    \
                             positions, out, ws, batch, sq, n_heads, n_kv,   \
                             hd, page_tokens, n_blocks, n_splits, scale, s)
  if (dtype == 0) {
    if (quant) PAGED_ATTN_DISPATCH(float, int8_t);
    PAGED_ATTN_DISPATCH(float, float);
  }
  if (dtype == 1) {
    if (quant) PAGED_ATTN_DISPATCH(__nv_bfloat16, int8_t);
    PAGED_ATTN_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  }
#undef PAGED_ATTN_DISPATCH
  return (int)cudaErrorInvalidValue;
}
