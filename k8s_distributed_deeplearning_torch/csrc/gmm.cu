// Grouped matrix multiply for Hopper: the forward kernel (also the input
// gradient, with the weight read transposed) and the weight-gradient kernel.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py
//   `_gmm_kernel`   (launched by `_gmm_call`)  -> gmm_kernel
//   `_tgmm_kernel`  (launched by `_tgmm_call`) -> tgmm_kernel
//
// Contract (ops/gmm.py):
//   lhs          [M_pad, K]    float32 or bfloat16, contiguous, rows sorted
//                              by expert in block-aligned spans
//   rhs          [E, K, N]     lhs's dtype; trans_rhs: [E, N, K], read as
//                              its transpose (the backward's rhs^T, never
//                              materialized)
//   row_offset   [E] int32     first row of each expert's span
//   group_sizes  [E] int32     real rows of each expert
//   block_expert, block_live   [M_pad / block_m] int32: owning expert of
//                              each row block, and whether it holds a real
//                              row
//   gmm:  out[block] = lhs[block] . rhs[e] for a live row block of expert e,
//         0 for a dead block; [M_pad, N] in lhs's dtype.
//   tgmm: out[e] = sum over the rows of e's live blocks of
//         lhs[r]^T . dout[r]; [E, K, N] in lhs's dtype; an expert with no
//         rows gets zeros.
// The Pallas kernels' semantics, block for block. Products take the storage
// dtype with f32 accumulation, rounded once.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32, 3.35 TB/s):
// operations at the MoE training shapes. 16,384 routed rows against
// K 768 / N 2048 are 2 * M * K * N = 5.2e10 FLOPs (0.052 ms) against about
// 117 MB of operands and results (0.035 ms); the Mixtral-class expert
// shapes are further above the ridge.
// What the design does about it:
// - One block computes a 128 x 128 output tile with 8 warps, each a 64 x 32
//   sub-tile of m16n8k16 accumulators. bf16 tiles go to the tensor cores
//   with `mma.sync` (f32 accumulation), their fragments loaded with
//   `ldmatrix`; f32 tiles are computed on the CUDA cores in the same
//   accumulator layout, in full f32 (no TF32). Operand tiles (32 deep) are
//   staged in shared memory with `cp.async`, double buffered, zero-filled
//   past the edges. No wgmma, TMA or persistent scheduling yet: a simple
//   first design, whose times against the bound PERF.md keeps.
// - No scalar prefetch on Hopper: a gmm block reads its row block's expert
//   and live flag from device memory. A dead block writes zeros and
//   returns.
// - Row tiles of one expert launch next to each other (blockIdx.x walks the
//   rows, blockIdx.y the columns), so an expert's weight tile is read from
//   device memory about once and from L2 after that.
// - The TPU carried tgmm's accumulator across a sequential grid and
//   flushed it at the expert's last block. Blocks here run in no order, so
//   one block owns one (expert, K tile, N tile), loops over the rows of
//   that expert's live blocks inside the block, keeps the sum in registers
//   and writes it once: no atomics, no second pass, deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per block (the layout's row tile)
constexpr int BN = 128;        // output columns per block
constexpr int BK = 32;         // contraction depth per shared-memory stage
constexpr int NT = 256;        // 8 warps: 2 along rows x 4 along columns
constexpr int WM = 64, WN = 32;
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int PAD = 8;         // shared-memory row padding, in elements

// Two neighbouring outputs in one store (p is 4- or 8-byte aligned).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;          // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a [ROWS][COLS] tile into shared memory (row stride COLS + PAD), 16
// bytes a thread per step. src(r, c) is the global address of element
// (r, c) of the tile (c a multiple of the vector width) or null past the
// edge, which is zero-filled; `fallback` is any valid global address.
template <typename T, int ROWS, int COLS, typename Src>
__device__ __forceinline__ void stage(T* dst, const T* fallback, Src src) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = COLS / VEC;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx - r * CH) * VEC;
    const T* s = src(r, c);
    cp_async16(dst + r * (COLS + PAD) + c, s ? s : fallback, s != nullptr);
  }
}

// Element (i, j) of a shared-memory operand at p[i * rs + j * cs]: A is
// indexed (row of the output, contraction), B (contraction, column).
template <typename T>
struct View {
  const T* p;
  int rs, cs;
  __device__ __forceinline__ const T* at(int i, int j) const {
    return p + i * rs + j * cs;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p,
                                        bool trans) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// acc[i][j][.] += A[16i.., 0..BK) . B[0..BK), 8j..] for one warp's 64 x 32
// sub-tile (A and B already offset to it). Accumulator layout of
// mma.m16n8k16: lane (g = lane / 4, t = lane % 4) holds rows g and g + 8,
// columns 2t and 2t + 1 of each 16 x 8 tile: acc[.][.][0..1] on row g,
// [2..3] on row g + 8.
//
// bf16: A is row-major in shared memory (A_ROWS: rows of the output
// contiguous along the contraction) or contraction-major; B is
// contraction-major or column-major (B_COLS). ldmatrix reads each operand
// as 8 x 8 matrices of 16-byte rows and transposes where the storage runs
// the other way.
template <bool A_ROWS, bool B_COLS>
__device__ __forceinline__ void warp_tile(float (&acc)[MI][NI][4],
                                          View<__nv_bfloat16> A,
                                          View<__nv_bfloat16> B, int lane) {
  const int q = lane >> 3, r = lane & 7;   // this lane's matrix and row
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      // Matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
      // (rows 8-15, k 8-15) give a0..a3.
      const int i0 = 16 * i + 8 * (q & 1), k0 = kk + 8 * (q >> 1);
      if (A_ROWS)
        ldsm_x4(a[i], A.at(i0 + r, k0), false);
      else
        ldsm_x4(a[i], A.at(i0, k0 + r), true);
    }
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      // Matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
      // (k 8-15, n 8-15) give b0, b1 of column tiles j and j + 1.
      const int k0 = kk + 8 * (q & 1), n0 = 8 * j + 8 * (q >> 1);
      uint32_t x[4];
      if (B_COLS)
        ldsm_x4(x, B.at(k0, n0 + r), false);
      else
        ldsm_x4(x, B.at(k0 + r, n0), true);
      b[j][0] = x[0];
      b[j][1] = x[1];
      b[j + 1][0] = x[2];
      b[j + 1][1] = x[3];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
              "+f"(acc[i][j][3])
            : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
              "r"(b[j][0]), "r"(b[j][1]));
  }
}

// f32: the same sub-tile and accumulator layout on the CUDA cores, one
// contraction step at a time, in f32 (the views carry any layout).
template <bool A_ROWS, bool B_COLS>
__device__ __forceinline__ void warp_tile(float (&acc)[MI][NI][4],
                                          View<float> A, View<float> B,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[MI][2], b[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      a[i][0] = *A.at(16 * i + g, k);
      a[i][1] = *A.at(16 * i + g + 8, k);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      b[j][0] = *B.at(k, 8 * j + 2 * t);
      b[j][1] = *B.at(k, 8 * j + 2 * t + 1);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        acc[i][j][0] = fmaf(a[i][0], b[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i][0], b[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(a[i][1], b[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(a[i][1], b[j][1], acc[i][j][3]);
      }
  }
}

// Write the block's accumulators as out[row0 + r][col0 + c] (row stride
// ld), skipping rows for which keep(r) is false and columns past n_cols.
template <typename T, typename Keep>
__device__ __forceinline__ void store_tile(const float (&acc)[MI][NI][4],
                                           T* out, size_t ld, int row0,
                                           int col0, int n_cols, int wr,
                                           int wc, int lane, Keep keep) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 16 * i + g + 8 * h;
      if (!keep(r)) continue;
      T* row = out + (size_t)(row0 + r) * ld;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = col0 + wc + 8 * j + 2 * t;
        if (c >= n_cols) continue;       // n_cols is even: c + 1 fits too
        store2(row + c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <typename T, bool TRANS>
struct GmmSmem {
  static constexpr int A_ELEMS = BM * (BK + PAD);
  static constexpr int B_ELEMS = TRANS ? BN * (BK + PAD) : BK * (BN + PAD);
  static constexpr size_t bytes() {
    return 2 * sizeof(T) * (size_t)(A_ELEMS + B_ELEMS);
  }
};

// Grid (M_pad / BM, ceil(N / BN)). Block (x, y) computes rows
// [BM x, BM x + BM) and columns [BN y, BN y + BN) of out.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int32_t* __restrict__ block_expert,
           const int32_t* __restrict__ block_live, T* __restrict__ out,
           int K, int N, int block_m) {
  using S = GmmSmem<T, TRANS>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);
  T* b_s = a_s + 2 * S::A_ELEMS;

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int e = block_expert[row0 / block_m];
  const bool live = block_live[row0 / block_m] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 2) * WM, wc = (warp & 3) * WN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (live) {
    const T* a_g = lhs + (size_t)row0 * K;
    const T* w = rhs + (size_t)e * K * N;
    auto load = [&](int buf, int k0) {
      stage<T, BM, BK>(a_s + buf * S::A_ELEMS, lhs,
                       [&](int r, int c) -> const T* {
                         return k0 + c < K ? a_g + (size_t)r * K + k0 + c
                                           : nullptr;
                       });
      if (TRANS)        // rhs [E, N, K]: tile [BN][BK], K contiguous
        stage<T, BN, BK>(b_s + buf * S::B_ELEMS, rhs,
                         [&](int r, int c) -> const T* {
                           return (col0 + r < N && k0 + c < K)
                                      ? w + (size_t)(col0 + r) * K + k0 + c
                                      : nullptr;
                         });
      else              // rhs [E, K, N]: tile [BK][BN], N contiguous
        stage<T, BK, BN>(b_s + buf * S::B_ELEMS, rhs,
                         [&](int r, int c) -> const T* {
                           return (k0 + r < K && col0 + c < N)
                                      ? w + (size_t)(k0 + r) * N + col0 + c
                                      : nullptr;
                         });
      cp_async_commit();
    };
    const int n_k = (K + BK - 1) / BK;
    load(0, 0);
    for (int kt = 0; kt < n_k; ++kt) {
      if (kt + 1 < n_k) {
        load((kt + 1) & 1, (kt + 1) * BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* a = a_s + (kt & 1) * S::A_ELEMS;
      const T* b = b_s + (kt & 1) * S::B_ELEMS;
      const View<T> av{a + wr * (BK + PAD), BK + PAD, 1};
      const View<T> bv = TRANS ? View<T>{b + wc * (BK + PAD), 1, BK + PAD}
                               : View<T>{b + wc, BN + PAD, 1};
      warp_tile<true, TRANS>(acc, av, bv, lane);
      __syncthreads();
    }
  }
  // A dead block's accumulators stayed 0: it writes zeros.
  store_tile(acc, out, (size_t)N, row0, col0, N, wr, wc, lane,
             [](int) { return true; });
}

template <typename T>
struct TgmmSmem {
  static constexpr int A_ELEMS = BK * (BM + PAD);   // lhs rows, K contiguous
  static constexpr int B_ELEMS = BK * (BN + PAD);   // dout rows, N contiguous
  static constexpr size_t bytes() {
    return 2 * sizeof(T) * (size_t)(A_ELEMS + B_ELEMS);
  }
};

// Grid (ceil(K / BM), ceil(N / BN), E). Block (x, y, e) computes rows
// [BM x, BM x + BM) (of K) and columns [BN y, BN y + BN) (of N) of out[e],
// looping BK rows at a time over e's live blocks: the first
// ceil(group_sizes[e] / block_m) blocks of its span.
template <typename T>
__global__ void __launch_bounds__(NT)
tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
            const int32_t* __restrict__ row_offset,
            const int32_t* __restrict__ group_sizes, T* __restrict__ out,
            int K, int N, int block_m) {
  using S = TgmmSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);
  T* b_s = a_s + 2 * S::A_ELEMS;

  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int r_begin = row_offset[e];
  const int r_end =
      r_begin + (group_sizes[e] + block_m - 1) / block_m * block_m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 2) * WM, wc = (warp & 3) * WN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto load = [&](int buf, int r0) {
    stage<T, BK, BM>(a_s + buf * S::A_ELEMS, lhs,
                     [&](int r, int c) -> const T* {
                       return (r0 + r < r_end && k0 + c < K)
                                  ? lhs + (size_t)(r0 + r) * K + k0 + c
                                  : nullptr;
                     });
    stage<T, BK, BN>(b_s + buf * S::B_ELEMS, dout,
                     [&](int r, int c) -> const T* {
                       return (r0 + r < r_end && n0 + c < N)
                                  ? dout + (size_t)(r0 + r) * N + n0 + c
                                  : nullptr;
                     });
    cp_async_commit();
  };
  const int n_steps = (r_end - r_begin + BK - 1) / BK;
  if (n_steps > 0) load(0, r_begin);
  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) {
      load((st + 1) & 1, r_begin + (st + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* a = a_s + (st & 1) * S::A_ELEMS;
    const T* b = b_s + (st & 1) * S::B_ELEMS;
    // A(i, kk) = lhs[row kk][k0 + i]: contraction-major (rs == 1).
    const View<T> av{a + wr, 1, BM + PAD};
    const View<T> bv{b + wc, BN + PAD, 1};
    warp_tile<false, false>(acc, av, bv, lane);
    __syncthreads();
  }
  const int n_rows = min(BM, K - k0);
  store_tile(acc, out + (size_t)e * K * N, (size_t)N, k0, n0, N, wr, wc,
             lane, [&](int r) { return r < n_rows; });
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, bool TRANS>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const int32_t* be,
                       const int32_t* bl, void* out, int m_pad, int k, int n,
                       int block_m, cudaStream_t stream) {
  const size_t bytes = GmmSmem<T, TRANS>::bytes();
  cudaError_t e = set_smem(gmm_kernel<T, TRANS>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(m_pad / BM, (n + BN - 1) / BN);
  gmm_kernel<T, TRANS><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), be, bl,
      static_cast<T*>(out), k, n, block_m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tgmm(const void* lhs, const void* dout, const int32_t* ro,
                        const int32_t* gs, void* out, int k, int n, int e,
                        int block_m, cudaStream_t stream) {
  const size_t bytes = TgmmSmem<T>::bytes();
  cudaError_t err = set_smem(tgmm_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + BM - 1) / BM, (n + BN - 1) / BN, e);
  tgmm_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(dout), ro, gs,
      static_cast<T*>(out), k, n, block_m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch (0 = success) or cudaErrorInvalidValue for what the kernels do
// not take (K or N not a multiple of 8, block_m not a multiple of the row
// tile, m_pad not a multiple of block_m); the Python wrappers check first
// and raise on any nonzero return.
extern "C" int gmm_launch(const void* lhs, const void* rhs,
                          const void* block_expert, const void* block_live,
                          void* out, int m_pad, int k, int n,
                          int num_experts, int block_m, int trans_rhs,
                          int dtype, void* stream) {
  if (m_pad <= 0 || k <= 0 || n <= 0 || num_experts <= 0 || k % 8 ||
      n % 8 || block_m <= 0 || block_m % BM || m_pad % block_m)
    return (int)cudaErrorInvalidValue;
  const int32_t* be = static_cast<const int32_t*>(block_expert);
  const int32_t* bl = static_cast<const int32_t*>(block_live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(trans_rhs ? launch_gmm<float, true>(lhs, rhs, be, bl, out,
                                                     m_pad, k, n, block_m, s)
                           : launch_gmm<float, false>(lhs, rhs, be, bl, out,
                                                      m_pad, k, n, block_m,
                                                      s));
  if (dtype == 1)
    return (int)(trans_rhs
                     ? launch_gmm<__nv_bfloat16, true>(lhs, rhs, be, bl, out,
                                                       m_pad, k, n, block_m,
                                                       s)
                     : launch_gmm<__nv_bfloat16, false>(lhs, rhs, be, bl,
                                                        out, m_pad, k, n,
                                                        block_m, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" int tgmm_launch(const void* lhs, const void* dout,
                           const void* row_offset, const void* group_sizes,
                           void* out, int m_pad, int k, int n,
                           int num_experts, int block_m, int dtype,
                           void* stream) {
  if (m_pad <= 0 || k <= 0 || n <= 0 || num_experts <= 0 || k % 8 ||
      n % 8 || block_m <= 0 || block_m % BK || m_pad % block_m)
    return (int)cudaErrorInvalidValue;
  const int32_t* ro = static_cast<const int32_t*>(row_offset);
  const int32_t* gs = static_cast<const int32_t*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_tgmm<float>(lhs, dout, ro, gs, out, k, n, num_experts,
                                   block_m, s);
  if (dtype == 1)
    return (int)launch_tgmm<__nv_bfloat16>(lhs, dout, ro, gs, out, k, n,
                                           num_experts, block_m, s);
  return (int)cudaErrorInvalidValue;
}
