// Flash attention for Hopper: the forward kernel and the two backward
// kernels (dQ; dK and dV).
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_flash.py
//   `_fwd_kernel`      (launched by `_fwd`)  -> flash_fwd_kernel
//   `_bwd_dq_kernel`   (launched by `_bwd`)  -> flash_dq_kernel
//   `_bwd_dkv_kernel`  (launched by `_bwd`)  -> flash_dkv_kernel
//
// Contract (the Pallas kernels' semantics):
//   q          [B, sq, H, D]    float32 or bfloat16, contiguous
//   k, v       [B, sk, kv, D]   q's dtype; q head h reads KV head h / (H/kv)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   o          [B, sq, H, D]    q's dtype
//   lse        [B, H, sq]       float32 (the Pallas [B*kv, group, sq] layout)
//   delta      [B, H, sq]       float32, rowsum(dO * O), computed by the caller
//   dq [B, sq, H, D]; dk, dv [B, sk, kv, D]: the query-head group summed
// Causal masking is bottom-right aligned: row i sees column j iff
// i + (sk - sq) >= j. Masked scores are NEG_INF = -1e30, a masked score
// contributes exactly 0 (p = 0 where s <= NEG_INF / 2), the softmax sum is
// floored at 1e-30 and lse = m + log(max(l, 1e-30)), so a row that sees
// nothing gives exactly 0 in O, dQ, dK and dV. Matmul inputs stay in the
// storage dtype with f32 accumulation; the softmax scale multiplies the f32
// scores; P is cast to V's dtype before P.V; the backward folds the scale
// into dS, which is cast to the storage dtype before dS.K and dS^T.Q.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32, 3.35 TB/s):
// operations at the training shapes (S = 2048, hd 128). The forward does two
// products of 2 * sq * sk * D FLOPs per query head (halved under causal),
// the dQ kernel three, the dK/dV kernel four.
// What the design does about it:
// - Every tile product runs through one warp-level routine, `warp_mma`, in
//   the m16n8k16 accumulator layout: bf16 tiles go to the tensor cores with
//   `mma.sync` (f32 accumulation); f32 tiles are computed on the CUDA cores
//   in the same register layout, so the masking and softmax code is shared.
//   Operand fragments are read from shared memory element by element: no
//   ldmatrix, no TMA, no wgmma, no pipelining of the global loads. A simple
//   first design; PERF.md holds its times against the bound.
// - GQA is native. A query tile flattens (position, head of the KV head's
//   group) into rows, so one K/V tile in shared memory serves the whole
//   group, and K/V are never repeated to the query-head count.
// - The dQ kernel loops over key tiles for a tile of query rows. The dK/dV
//   kernel loops over tiles of flattened query rows for a tile of keys, so
//   the group sum accumulates in registers and dK/dV are written once, with
//   no atomics and no second pass.
// - Causal tiles past the frontier are skipped: the forward and dQ kernels
//   stop at the block's last visible key, the dK/dV kernel starts at the
//   first query row that sees its keys, and a warp skips a tile its rows
//   cannot see. Query tiles are launched heaviest first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;    // threads per block
constexpr int WR = 16;             // rows per warp: one mma M tile
constexpr int BR = NWARPS * WR;    // flattened query rows per fwd / dQ block
constexpr int BK = 64;             // keys per K/V tile in fwd / dQ
constexpr int BKV = NWARPS * WR;   // keys per dK/dV block
constexpr int BRQ = 32;            // flattened query rows per dK/dV step
constexpr int PAD = 8;             // shared-memory row padding, in elements

struct Geo {
  int batch, sq, sk, n_heads, n_kv, group, rows_total, off, causal, seg;
  float scale;
};

// Element (r, c) of a shared-memory tile at p[r * rs + c * cs].
template <typename T>
struct View {
  const T* p;
  int rs, cs;
  __device__ __forceinline__ T operator()(int r, int c) const {
    return p[r * rs + c * cs];
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[n][.] += A[16 x K] . B[K x 8N] for one warp. Accumulator layout of
// mma.m16n8k16: lane (g = lane / 4, t = lane % 4) holds rows g and g + 8,
// columns 8n + 2t and 8n + 2t + 1: acc[n][0..1] on row g, acc[n][2..3] on
// row g + 8. K is a multiple of 16.
template <int N>
__device__ __forceinline__ void warp_mma(float (*acc)[4], View<float> A,
                                         View<float> B, int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A(g, k), a1 = A(g + 8, k);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float b0 = B(k, 8 * n + 2 * t), b1 = B(k, 8 * n + 2 * t + 1);
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int N>
__device__ __forceinline__ void warp_mma(float (*acc)[4],
                                         View<__nv_bfloat16> A,
                                         View<__nv_bfloat16> B, int K,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int k = k0 + 2 * t;
    const uint32_t a0 = pack(A(g, k), A(g, k + 1));
    const uint32_t a1 = pack(A(g + 8, k), A(g + 8, k + 1));
    const uint32_t a2 = pack(A(g, k + 8), A(g, k + 9));
    const uint32_t a3 = pack(A(g + 8, k + 8), A(g + 8, k + 9));
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = 8 * n + g;
      const uint32_t b0 = pack(B(k, c), B(k + 1, c));
      const uint32_t b1 = pack(B(k + 8, c), B(k + 9, c));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
            "+f"(acc[n][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

// Copy `nrows` rows of D elements into a [nrows][D + PAD] tile, 16 bytes a
// thread per step; src(r) is the row's first element, or null for a row
// past the end, which is zero-filled.
template <typename T, int D, typename Src>
__device__ __forceinline__ void load_tile(T* dst, int nrows, Src src) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = D / VEC;
  for (int idx = threadIdx.x; idx < nrows * CH; idx += NT) {
    const int r = idx / CH, c = idx - r * CH;
    const T* s = src(r);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (s != nullptr) x = reinterpret_cast<const uint4*>(s)[c];
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c * VEC) = x;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Flattened query row r of KV head kvh: position r / group, head
// kvh * group + r % group. Its first element in a [B, sq, H, D] tensor.
__device__ __forceinline__ size_t row_offset(const Geo& g, int b, int kvh,
                                             int r, int D) {
  const int i = r / g.group, h = kvh * g.group + r % g.group;
  return (((size_t)b * g.sq + i) * g.n_heads + h) * D;
}
__device__ __forceinline__ size_t stat_offset(const Geo& g, int b, int kvh,
                                              int r) {
  const int i = r / g.group, h = kvh * g.group + r % g.group;
  return ((size_t)b * g.n_heads + h) * g.sq + i;
}

// Keys [0, kend) are visible to some row of a query tile whose last valid
// flattened row is r_last.
__device__ __forceinline__ int key_end(const Geo& g, int r_last) {
  if (!g.causal) return g.sk;
  return min(g.sk, r_last / g.group + g.off + 1);
}

template <typename T, int D>
struct Smem {
  static constexpr int LD = D + PAD;
  static constexpr size_t fwd() {
    return sizeof(T) * ((size_t)(BR + 2 * BK) * LD + NWARPS * WR * (BK + PAD)) +
           sizeof(int) * BK;
  }
  static constexpr size_t dq() {
    return sizeof(T) *
               ((size_t)(2 * BR + 2 * BK) * LD + NWARPS * WR * (BK + PAD)) +
           sizeof(int) * BK;
  }
  static constexpr size_t dkv() {
    return sizeof(T) * ((size_t)(2 * BKV + 2 * BRQ) * LD +
                        2 * NWARPS * WR * (BRQ + PAD)) +
           sizeof(int) * BKV;
  }
};

// Grid (query tiles, kv heads, B). A query tile is BR flattened rows; warp
// w owns rows [16w, 16w + 16).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ segq,
                 const int32_t* __restrict__ segk, T* __restrict__ o,
                 float* __restrict__ lse, Geo g) {
  constexpr int LD = D + PAD, LP = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BR * LD;
  T* v_s = k_s + BK * LD;
  T* p_s = v_s + BK * LD;
  int* segk_s = reinterpret_cast<int*>(p_s + NWARPS * WR * LP);
  __shared__ int pos_s[BR], segq_s[BR];

  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;   // heaviest first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  load_tile<T, D>(q_s, BR, [&](int r) -> const T* {
    const int fr = row0 + r;
    return fr < g.rows_total ? q + row_offset(g, b, kvh, fr, D) : nullptr;
  });
  if (threadIdx.x < BR) {
    const int fr = row0 + threadIdx.x;
    const int i = fr < g.rows_total ? fr / g.group : 0;
    pos_s[threadIdx.x] = i;
    segq_s[threadIdx.x] = g.seg ? segq[(size_t)b * g.sq + i] : 0;
  }
  const int r_last = min(row0 + BR, g.rows_total) - 1;
  const int kend = key_end(g, r_last);
  const int n_tiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int w_last = min(row0 + warp * WR + WR, g.rows_total) - 1;
  const int w_kend = w_last >= row0 + warp * WR ? key_end(g, w_last) : 0;

  const int ra = warp * WR + gq;      // this lane's rows: ra and ra + 8
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  T* p_w = p_s + warp * WR * LP;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * BK;
    __syncthreads();
    load_tile<T, D>(k_s, BK, [&](int r) -> const T* {
      const int j = j0 + r;
      return j < g.sk ? k + (((size_t)b * g.sk + j) * g.n_kv + kvh) * D
                      : nullptr;
    });
    load_tile<T, D>(v_s, BK, [&](int r) -> const T* {
      const int j = j0 + r;
      return j < g.sk ? v + (((size_t)b * g.sk + j) * g.n_kv + kvh) * D
                      : nullptr;
    });
    if (threadIdx.x < BK) {
      const int j = j0 + threadIdx.x;
      segk_s[threadIdx.x] =
          (g.seg && j < g.sk) ? segk[(size_t)b * g.sk + j] : 0;
    }
    __syncthreads();
    if (j0 >= w_kend) continue;        // warp-uniform: nothing visible

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_mma<BK / 8>(s, View<T>{q_s + warp * WR * LD, LD, 1},
                     View<T>{k_s, 1, LD}, D, lane);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = ra + 8 * h;
        const int jl = 8 * n + 2 * tq + (e & 1), j = j0 + jl;
        const bool ok = j < g.sk && (!g.causal || pos_s[r] + g.off >= j) &&
                        (!g.seg || segq_s[r] == segk_s[jl]);
        const float x = ok ? s[n][e] * g.scale : NEG_INF;
        s[n][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = s[n][e];
        const float p = x <= NEG_INF * 0.5f ? 0.f : expf(x - m[h]);
        sum[h] += p;
        // P.V takes p in the value dtype, as the Pallas kernel does.
        p_w[(gq + 8 * h) * LP + 8 * n + 2 * tq + (e & 1)] = from_f32<T>(p);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(sum[h]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    __syncwarp();
    warp_mma<D / 8>(acc, View<T>{p_w, LP, 1}, View<T>{v_s, LD, 1}, BK, lane);
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + ra + 8 * h;
    if (fr >= g.rows_total) continue;
    const float norm = fmaxf(l[h], 1e-30f);
    T* out = o + row_offset(g, b, kvh, fr, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      out[8 * n + 2 * tq] = from_f32<T>(acc[n][2 * h] / norm);
      out[8 * n + 2 * tq + 1] = from_f32<T>(acc[n][2 * h + 1] / norm);
    }
    if (tq == 0) lse[stat_offset(g, b, kvh, fr)] = m[h] + logf(norm);
  }
}

// Grid (query tiles, kv heads, B), as the forward.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int32_t* __restrict__ segq,
                const int32_t* __restrict__ segk, T* __restrict__ dq, Geo g) {
  constexpr int LD = D + PAD, LP = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BR * LD;
  T* k_s = do_s + BR * LD;
  T* v_s = k_s + BK * LD;
  T* ds_s = v_s + BK * LD;
  int* segk_s = reinterpret_cast<int*>(ds_s + NWARPS * WR * LP);
  __shared__ int pos_s[BR], segq_s[BR];
  __shared__ float lse_s[BR], delta_s[BR];

  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  load_tile<T, D>(q_s, BR, [&](int r) -> const T* {
    const int fr = row0 + r;
    return fr < g.rows_total ? q + row_offset(g, b, kvh, fr, D) : nullptr;
  });
  load_tile<T, D>(do_s, BR, [&](int r) -> const T* {
    const int fr = row0 + r;
    return fr < g.rows_total ? dout + row_offset(g, b, kvh, fr, D) : nullptr;
  });
  if (threadIdx.x < BR) {
    const int fr = row0 + threadIdx.x;
    const bool valid = fr < g.rows_total;
    const int i = valid ? fr / g.group : 0;
    pos_s[threadIdx.x] = i;
    segq_s[threadIdx.x] = g.seg ? segq[(size_t)b * g.sq + i] : 0;
    lse_s[threadIdx.x] = valid ? lse[stat_offset(g, b, kvh, fr)] : 0.f;
    delta_s[threadIdx.x] = valid ? delta[stat_offset(g, b, kvh, fr)] : 0.f;
  }
  const int r_last = min(row0 + BR, g.rows_total) - 1;
  const int kend = key_end(g, r_last);
  const int n_tiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int w_last = min(row0 + warp * WR + WR, g.rows_total) - 1;
  const int w_kend = w_last >= row0 + warp * WR ? key_end(g, w_last) : 0;

  const int ra = warp * WR + gq;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  T* ds_w = ds_s + warp * WR * LP;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * BK;
    __syncthreads();
    load_tile<T, D>(k_s, BK, [&](int r) -> const T* {
      const int j = j0 + r;
      return j < g.sk ? k + (((size_t)b * g.sk + j) * g.n_kv + kvh) * D
                      : nullptr;
    });
    load_tile<T, D>(v_s, BK, [&](int r) -> const T* {
      const int j = j0 + r;
      return j < g.sk ? v + (((size_t)b * g.sk + j) * g.n_kv + kvh) * D
                      : nullptr;
    });
    if (threadIdx.x < BK) {
      const int j = j0 + threadIdx.x;
      segk_s[threadIdx.x] =
          (g.seg && j < g.sk) ? segk[(size_t)b * g.sk + j] : 0;
    }
    __syncthreads();
    if (j0 >= w_kend) continue;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    warp_mma<BK / 8>(s, View<T>{q_s + warp * WR * LD, LD, 1},
                     View<T>{k_s, 1, LD}, D, lane);
    warp_mma<BK / 8>(dp, View<T>{do_s + warp * WR * LD, LD, 1},
                     View<T>{v_s, 1, LD}, D, lane);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = ra + 8 * h;
        const int jl = 8 * n + 2 * tq + (e & 1), j = j0 + jl;
        const bool ok = j < g.sk && (!g.causal || pos_s[r] + g.off >= j) &&
                        (!g.seg || segq_s[r] == segk_s[jl]);
        const float x = ok ? s[n][e] * g.scale : NEG_INF;
        const float p = x <= NEG_INF * 0.5f ? 0.f : expf(x - lse_s[r]);
        const float ds = p * (dp[n][e] - delta_s[r]) * g.scale;
        ds_w[(gq + 8 * h) * LP + jl] = from_f32<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<D / 8>(acc, View<T>{ds_w, LP, 1}, View<T>{k_s, LD, 1}, BK, lane);
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + ra + 8 * h;
    if (fr >= g.rows_total) continue;
    T* out = dq + row_offset(g, b, kvh, fr, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      out[8 * n + 2 * tq] = from_f32<T>(acc[n][2 * h]);
      out[8 * n + 2 * tq + 1] = from_f32<T>(acc[n][2 * h + 1]);
    }
  }
}

// Grid (key tiles, kv heads, B). A key tile is BKV keys; warp w owns keys
// [16w, 16w + 16) and accumulates their dK and dV over every flattened
// query row (all positions and all heads of the group) in registers.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int32_t* __restrict__ segq,
                 const int32_t* __restrict__ segk, T* __restrict__ dk,
                 T* __restrict__ dv, Geo g) {
  constexpr int LD = D + PAD, LP = BRQ + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BKV * LD;
  T* q_s = v_s + BKV * LD;
  T* do_s = q_s + BRQ * LD;
  T* p_s = do_s + BRQ * LD;
  T* ds_s = p_s + NWARPS * WR * LP;
  int* segk_s = reinterpret_cast<int*>(ds_s + NWARPS * WR * LP);
  __shared__ int pos_s[BRQ], segq_s[BRQ];
  __shared__ float lse_s[BRQ], delta_s[BRQ];

  const int j0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int jw = j0 + warp * WR;       // this warp's first key

  load_tile<T, D>(k_s, BKV, [&](int r) -> const T* {
    const int j = j0 + r;
    return j < g.sk ? k + (((size_t)b * g.sk + j) * g.n_kv + kvh) * D
                    : nullptr;
  });
  load_tile<T, D>(v_s, BKV, [&](int r) -> const T* {
    const int j = j0 + r;
    return j < g.sk ? v + (((size_t)b * g.sk + j) * g.n_kv + kvh) * D
                    : nullptr;
  });
  if (threadIdx.x < BKV) {
    const int j = j0 + threadIdx.x;
    segk_s[threadIdx.x] = (g.seg && j < g.sk) ? segk[(size_t)b * g.sk + j] : 0;
  }
  // The first position that sees key j0 is j0 - off.
  int r_begin = 0;
  if (g.causal) r_begin = max(0, j0 - g.off) * g.group;
  r_begin = r_begin / BRQ * BRQ;

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
    adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  }
  T* p_w = p_s + warp * WR * LP;
  T* ds_w = ds_s + warp * WR * LP;

  for (int r0 = r_begin; r0 < g.rows_total; r0 += BRQ) {
    __syncthreads();
    load_tile<T, D>(q_s, BRQ, [&](int r) -> const T* {
      const int fr = r0 + r;
      return fr < g.rows_total ? q + row_offset(g, b, kvh, fr, D) : nullptr;
    });
    load_tile<T, D>(do_s, BRQ, [&](int r) -> const T* {
      const int fr = r0 + r;
      return fr < g.rows_total ? dout + row_offset(g, b, kvh, fr, D)
                               : nullptr;
    });
    if (threadIdx.x < BRQ) {
      const int fr = r0 + threadIdx.x;
      const bool valid = fr < g.rows_total;
      const int i = valid ? fr / g.group : 0;
      pos_s[threadIdx.x] = i;
      segq_s[threadIdx.x] = g.seg ? segq[(size_t)b * g.sq + i] : 0;
      lse_s[threadIdx.x] = valid ? lse[stat_offset(g, b, kvh, fr)] : 0.f;
      delta_s[threadIdx.x] = valid ? delta[stat_offset(g, b, kvh, fr)] : 0.f;
    }
    __syncthreads();
    const int last = min(r0 + BRQ, g.rows_total) - 1;
    if (jw >= g.sk || (g.causal && last / g.group + g.off < jw)) continue;

    // S^T [16 keys x BRQ rows] = K_w . Q^T, dP^T = V_w . dO^T.
    float s[BRQ / 8][4], dp[BRQ / 8][4];
#pragma unroll
    for (int n = 0; n < BRQ / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    warp_mma<BRQ / 8>(s, View<T>{k_s + warp * WR * LD, LD, 1},
                      View<T>{q_s, 1, LD}, D, lane);
    warp_mma<BRQ / 8>(dp, View<T>{v_s + warp * WR * LD, LD, 1},
                      View<T>{do_s, 1, LD}, D, lane);
#pragma unroll
    for (int n = 0; n < BRQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int jl = warp * WR + gq + 8 * h, j = j0 + jl;
        const int c = 8 * n + 2 * tq + (e & 1);
        const bool ok = j < g.sk && r0 + c < g.rows_total &&
                        (!g.causal || pos_s[c] + g.off >= j) &&
                        (!g.seg || segq_s[c] == segk_s[jl]);
        const float x = ok ? s[n][e] * g.scale : NEG_INF;
        const float p = x <= NEG_INF * 0.5f ? 0.f : expf(x - lse_s[c]);
        const float ds = p * (dp[n][e] - delta_s[c]) * g.scale;
        p_w[(gq + 8 * h) * LP + c] = from_f32<T>(p);
        ds_w[(gq + 8 * h) * LP + c] = from_f32<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<D / 8>(adv, View<T>{p_w, LP, 1}, View<T>{do_s, LD, 1}, BRQ,
                    lane);
    warp_mma<D / 8>(adk, View<T>{ds_w, LP, 1}, View<T>{q_s, LD, 1}, BRQ,
                    lane);
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = jw + gq + 8 * h;
    if (j >= g.sk) continue;
    const size_t off = (((size_t)b * g.sk + j) * g.n_kv + kvh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      dk[off + 8 * n + 2 * tq] = from_f32<T>(adk[n][2 * h]);
      dk[off + 8 * n + 2 * tq + 1] = from_f32<T>(adk[n][2 * h + 1]);
      dv[off + 8 * n + 2 * tq] = from_f32<T>(adv[n][2 * h]);
      dv[off + 8 * n + 2 * tq + 1] = from_f32<T>(adv[n][2 * h + 1]);
    }
  }
}

// Static and dynamic shared memory together may exceed the default 48 KB
// only with this attribute, so it is set for every launch.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *segq, *segk;
  void *o, *lse_out, *dq, *dk, *dv;
};

// which: 0 forward, 1 dQ, 2 dK/dV.
template <typename T, int D>
cudaError_t launch(int which, const Args& a, const Geo& g,
                   cudaStream_t stream) {
  const dim3 q_grid((g.rows_total + BR - 1) / BR, g.n_kv, g.batch);
  const int32_t* segq = static_cast<const int32_t*>(a.segq);
  const int32_t* segk = static_cast<const int32_t*>(a.segk);
  cudaError_t e;
  if (which == 0) {
    const size_t bytes = Smem<T, D>::fwd();
    if ((e = set_smem(flash_fwd_kernel<T, D>, bytes)) != cudaSuccess) return e;
    flash_fwd_kernel<T, D><<<q_grid, NT, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), segq, segk, static_cast<T*>(a.o),
        static_cast<float*>(a.lse_out), g);
  } else if (which == 1) {
    const size_t bytes = Smem<T, D>::dq();
    if ((e = set_smem(flash_dq_kernel<T, D>, bytes)) != cudaSuccess) return e;
    flash_dq_kernel<T, D><<<q_grid, NT, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        segq, segk, static_cast<T*>(a.dq), g);
  } else {
    const size_t bytes = Smem<T, D>::dkv();
    if ((e = set_smem(flash_dkv_kernel<T, D>, bytes)) != cudaSuccess) return e;
    const dim3 k_grid((g.sk + BKV - 1) / BKV, g.n_kv, g.batch);
    flash_dkv_kernel<T, D><<<k_grid, NT, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        segq, segk, static_cast<T*>(a.dk), static_cast<T*>(a.dv), g);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, const Args& a, const Geo& g, int hd,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(which, a, g, stream);
    case 32: return launch<T, 32>(which, a, g, stream);
    case 64: return launch<T, 64>(which, a, g, stream);
    case 128: return launch<T, 128>(which, a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const Args& a, int batch, int sq, int sk, int n_heads,
        int n_kv, int hd, int causal, int dtype, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads % n_kv ||
      (a.segq == nullptr) != (a.segk == nullptr))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.batch = batch;
  g.sq = sq;
  g.sk = sk;
  g.n_heads = n_heads;
  g.n_kv = n_kv;
  g.group = n_heads / n_kv;
  g.rows_total = sq * g.group;
  g.off = sk - sq;
  g.causal = causal;
  g.seg = a.segq != nullptr;
  g.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(which, a, g, hd, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(which, a, g, hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 32, 64 or 128. segq/segk
// are both null or both set. Each returns cudaGetLastError() after its
// launch (0 = success) or cudaErrorInvalidValue for what the kernels do not
// take; the Python wrapper checks first and raises on any nonzero return.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* segq, const void* segk, void* o,
                              void* lse, int batch, int sq, int sk,
                              int n_heads, int n_kv, int hd, int causal,
                              int dtype, float scale, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.segq = segq; a.segk = segk;
  a.o = o; a.lse_out = lse;
  return run(0, a, batch, sq, sk, n_heads, n_kv, hd, causal, dtype, scale,
             stream);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* segq,
                                 const void* segk, void* dq, int batch,
                                 int sq, int sk, int n_heads, int n_kv,
                                 int hd, int causal, int dtype, float scale,
                                 void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.segq = segq; a.segk = segk; a.dq = dq;
  return run(1, a, batch, sq, sk, n_heads, n_kv, hd, causal, dtype, scale,
             stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* segq, const void* segk,
                                  void* dk, void* dv, int batch, int sq,
                                  int sk, int n_heads, int n_kv, int hd,
                                  int causal, int dtype, float scale,
                                  void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.segq = segq; a.segk = segk; a.dk = dk; a.dv = dv;
  return run(2, a, batch, sq, sk, n_heads, n_kv, hd, causal, dtype, scale,
             stream);
}
