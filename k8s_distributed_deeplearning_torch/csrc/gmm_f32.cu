// The f32 grouped matrix multiply on Hopper's tensor cores: the forward
// kernel (also the input gradient, with the weight read transposed) and
// the weight-gradient kernel, every product a three-pass TF32 split
// (tf32x3.cuh) through mma.sync m16n8k8.
//
// Replaces, on the f32 path: k8s_distributed_deeplearning_tpu/ops/
// pallas_gmm.py `_gmm_kernel` (:159, launched by `_gmm_call` at :185) ->
// gmm_tf32x3; `_tgmm_kernel` (:209, launched by `_tgmm_call` at :249) ->
// tgmm_tf32x3. ops/gmm.py `_gmm_route` sends every f32 `gmm_forward` and
// `tgmm` here ("tf32x3"); csrc/gmm.cu's `gmm_kernel` and `tgmm_kernel`
// stay the route a caller may name ("mma").
//
// Contract (csrc/gmm.cu's, in float32):
//   lhs          [M_pad, K]    float32, contiguous, rows sorted by expert in
//                              block-aligned spans
//   rhs          [E, K, N]     float32; trans_rhs: [E, N, K], read as its
//                              transpose (the backward's rhs^T, never
//                              materialized)
//   block_expert, block_live   [M_pad / block_m] int32: owning expert of
//                              each row block, and whether it holds a real
//                              row
//   out[block] = lhs[block] . rhs[e] for a live row block of expert e, 0 for
//   a dead block (which reads nothing); [M_pad, N] float32.
//
// Why three passes: one TF32 pass keeps 11 significant bits of each
// operand, ~2^-11 relative a product, far past chip_smoke.py's f32 limit
// (1e-5 of the RMS + 1e-5 of the value). hi + lo carries 22 bits; the
// dropped lo.lo term is ~2^-22 relative.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 3.35 TB/s): operations.
// 16,384 routed rows against K 768 / N 2048 are 2 M K N = 5.15e10 FLOPs,
// 1.55e11 in three TF32 passes: 0.312 ms at the TF32 peak (0.769 ms for
// the f32 FLOPs on the CUDA cores, which csrc/gmm.cu's f32 path runs on).
// What the design does about it:
// - One CTA computes a 128 x 128 output tile with 8 warps, each a 64 x 32
//   sub-tile of m16n8k8 accumulators (csrc/gmm.cu's layout). Operand tiles
//   32 deep are staged in shared memory with cp.async, double-buffered
//   (STAGES), zero-filled past the edges; the next stage's copies run
//   under the current stage's products. Operands are split as their
//   fragments load (four integer instructions an element): no split copy
//   is stored.
// - The forward's B tile is [k][n] (N contiguous): rows of BN + 4 floats,
//   read as float4 rows two at a time (tf32x3.cuh `load_b_kn`: rows 2t
//   and 2t + 1, columns 4g .. 4g + 3), which fixes the contraction order;
//   the A tile [m][k] then loads in that order as one 8-byte read a row
//   (`load_a_pairs`), rows of BK + 8 floats, the pitch at which those
//   reads are free of bank conflicts. dlhs reads rhs [n][k] (K
//   contiguous): its B tile takes the same 8-byte reads and pitch
//   (`load_b_nk_pairs`).
// - The tensor cores' f32 accumulation rounds toward zero, a bias that
//   grows with the products chained into one accumulator: a K = 2048
//   contraction chained whole would drift by ~2048 x 2^-24 ~ 1.2e-4 of
//   the value, ten times the f32 limit. Each 32-deep stage's products
//   run from a zeroed accumulator and are added to the running sum in f32,
//   rounded to nearest.
// - A dead block writes zeros and reads nothing; row tiles of one expert
//   launch next to each other (blockIdx.x walks the rows), so its weight
//   tile is read from device memory about once and from L2 after that.
// - `kernel_breakdown.py gmm_f32` times each stage.
//
// tgmm_tf32x3, the weight gradient (csrc/gmm.cu's tgmm contract in f32):
//   out[e] = sum over the rows r of e's live blocks of lhs[r]^T . dout[r],
//   [E, K, N] float32; an expert with no rows gets zeros.
// 16,384 routed rows at K 768 / N 2048 are the forward's FLOPs: the same
// bound, 0.312 ms in three TF32 passes.
// - One CTA computes a 128 x 128 tile of out[e] (128 of K, 128 of N) with
//   the forward's 8 warps of 64 x 32, walking e's rows 32 at a time: only
//   the first ceil(group_sizes[e] / block_m) blocks of its span, so dead
//   blocks read nothing and an empty expert writes zeros. Blocks run in no
//   order, so the CTA owns its tile: the sum stays in registers and is
//   written once, with no atomics and no second pass, and two launches
//   give the same bits.
// - The contraction index is the row, strided in both operands. A(i, kk)
//   = lhs[row kk][k0 + i]: the A tile is [kk][i], K contiguous, which
//   ldmatrix.trans cannot read at 32 bits. It is staged as it lies (rows of
//   BM + 4 floats) and loaded by tf32x3.cuh `load_a_km4`, which permutes
//   the output rows as `load_b_kn` permutes the columns, so each lane
//   reads float4s, free of bank conflicts at that pitch; dout's B tile
//   [kk][n] is the forward's B tile.
// - A span is ~2,048 rows at phase I's balanced layout and every row in a
//   one-expert layout: chained whole into one accumulator, the tensor
//   cores' truncation would drift past the f32 limit. Each 32-row stage's
//   products run from a zeroed accumulator and are added to the running
//   sum in f32, rounded to nearest, as in the forward.
// - Load balance: a CTA walks its expert's rows alone. In a skewed layout
//   the CTAs of the large expert carry most rows (one expert with all
//   16,384 rows: 96 busy CTAs of 768, 512 stages each, against 64 a CTA
//   at the balanced layout over ~6 waves): chip_smoke.py phase G times
//   the balanced, skewed and one-expert layouts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"          // cp.async copies

namespace {

constexpr int BM = 128;        // output rows a CTA (the layout's row tile)
constexpr int BN = 128;        // output columns a CTA
constexpr int BK = 32;         // contraction depth a stage
constexpr int STAGES = 2;      // stages in shared memory: one ahead
constexpr int NT = 256;        // 8 warps: 2 along rows x 4 along columns
constexpr int WM = 64, WN = 32;
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int LDA = BK + 8;    // A [m][k] and dlhs's B [n][k]: 8 (mod 16)
constexpr int LDB = BN + 4;    // the forward's B [k][n]: 4 (mod 8)

template <bool TRANS>
struct Smem {
  static constexpr int A = BM * LDA;                // floats a stage
  static constexpr int B = TRANS ? BN * LDA : BK * LDB;
  static constexpr size_t BYTES = STAGES * 4 * (size_t)(A + B);
};

// Stage a [ROWS][COLS] f32 tile into shared memory (row pitch LD), 16
// bytes a thread a step. src(r, c) is the global address of element (r, c)
// (c a multiple of 4) or null past the edge, which is zero-filled;
// `fallback` is any valid global address.
template <int ROWS, int COLS, int LD, typename Src>
__device__ __forceinline__ void stage(float* dst, const float* fallback,
                                      Src src) {
  constexpr int CH = COLS / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx - r * CH) * 4;
    const float* s = src(r, c);
    cp_async16(dst + r * LD + c, s ? s : fallback, s != nullptr);
  }
}

// Grid (M_pad / BM, ceil(N / BN)). CTA (x, y) computes rows [BM x, BM x +
// BM) and columns [BN y, BN y + BN) of out. Warp w takes rows (w / 4) WM
// and columns (w % 4) WN of the tile.
template <bool TRANS>
__global__ void __launch_bounds__(NT, 1)
gmm_tf32x3(const float* __restrict__ lhs, const float* __restrict__ rhs,
           const int32_t* __restrict__ block_expert,
           const int32_t* __restrict__ block_live, float* __restrict__ out,
           int K, int N, int block_m) {
  using S = Smem<TRANS>;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* b_s = smem + STAGES * S::A;

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int e = block_expert[row0 / block_m];
  const bool live = block_live[row0 / block_m] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 2) * WM, wc = (warp & 3) * WN;
  const int g = lane >> 2, t = lane & 3;

  // acc[i][j]: rows wr + 16 i + g (+ 8); columns, forward: wc + 4 (2t) + j
  // and wc + 4 (2t + 1) + j (load_b_kn's fragments); dlhs: wc + 8 j + 2t
  // and + 1.
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (live) {
    const float* a_g = lhs + (size_t)row0 * K;
    const float* w = rhs + (size_t)e * K * N;
    auto load = [&](int buf, int k0) {
      stage<BM, BK, LDA>(a_s + buf * S::A, lhs,
                         [&](int r, int c) -> const float* {
                           return k0 + c < K ? a_g + (size_t)r * K + k0 + c
                                             : nullptr;
                         });
      if constexpr (TRANS)   // rhs [E, N, K]: tile [BN][BK], K contiguous
        stage<BN, BK, LDA>(b_s + buf * S::B, rhs,
                           [&](int r, int c) -> const float* {
                             return (col0 + r < N && k0 + c < K)
                                        ? w + (size_t)(col0 + r) * K + k0 + c
                                        : nullptr;
                           });
      else                   // rhs [E, K, N]: tile [BK][BN], N contiguous
        stage<BK, BN, LDB>(b_s + buf * S::B, rhs,
                           [&](int r, int c) -> const float* {
                             return (k0 + r < K && col0 + c < N)
                                        ? w + (size_t)(k0 + r) * N + col0 + c
                                        : nullptr;
                           });
    };
    const int n_k = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_k) load(s, s * BK);
      cp_async_commit();
    }
#pragma unroll 1
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();  // stage kt landed (this thread's part)
      __syncthreads();             // ... every thread's; stage kt - 1 done
      const int ahead = kt + STAGES - 1;
      if (ahead < n_k) load(ahead % STAGES, ahead * BK);
      cp_async_commit();
      const float* a = a_s + (kt % STAGES) * S::A + wr * LDA;
      const float* b = b_s + (kt % STAGES) * S::B;
      // The stage's products from zero, then into the running sums.
      float part[MI][NI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) part[i][j][x] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        FragB bf[NI];
        if constexpr (TRANS) {
#pragma unroll
          for (int j = 0; j < NI; ++j)
            bf[j] = load_b_nk_pairs(b + (wc + 8 * j) * LDA, LDA, kk, lane);
        } else {
          load_b_kn<NI>(bf, b, LDB, kk, wc, lane);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const FragA af = load_a_pairs(a + 16 * i * LDA, LDA, kk, lane);
#pragma unroll
          for (int j = 0; j < NI; ++j) mma3(part[i][j], af, bf[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[i][j][x] += part[i][j][x];
    }
    cp_async_wait<0>();
  }

  // A dead block's accumulators stayed 0: it writes zeros. N is a multiple
  // of 8, so a run of 8 (forward) or 2 (dlhs) columns fits whole or not at
  // all.
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = out + (size_t)(row0 + wr + 16 * i + g + 8 * h) * N + col0;
      if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int c = wc + 8 * j + 2 * t;
          if (col0 + c < N)
            *reinterpret_cast<float2*>(row + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      } else if (col0 + wc + 8 * t < N) {
        store_acc_row<NI>(row, wc, acc[i], h, lane);
      }
    }
}

// Grid (ceil(K / BM), ceil(N / BN), E). CTA (x, y, e) computes rows
// [BM x, BM x + BM) (of K) and columns [BN y, BN y + BN) (of N) of out[e].
// Warp w takes rows (w / 4) WM (permuted by load_a_km4) and columns (w %
// 4) WN of the tile.
__global__ void __launch_bounds__(NT, 1)
tgmm_tf32x3(const float* __restrict__ lhs, const float* __restrict__ dout,
            const int32_t* __restrict__ row_offset,
            const int32_t* __restrict__ group_sizes, float* __restrict__ out,
            int K, int N, int block_m) {
  constexpr int LD = BM + 4;            // both tiles [BK][128]: 4 (mod 8)
  constexpr int TILE = BK * LD;         // floats a tile
  static_assert(BM == BN, "one pitch for both tiles");
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                    // lhs rows, K contiguous
  float* b_s = smem + STAGES * TILE;    // dout rows, N contiguous

  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int r_begin = row_offset[e];
  const int r_end =
      r_begin + (group_sizes[e] + block_m - 1) / block_m * block_m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 2) * WM, wc = (warp & 3) * WN;
  const int g = lane >> 2, t = lane & 3;

  // acc[i][j]: output rows wr + 32 h + 4 g + i (h = 0: elements 0-1; 1:
  // 2-3); columns wc + 4 (2t) + j and wc + 4 (2t + 1) + j.
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto load = [&](int buf, int r0) {
    stage<BK, BM, LD>(a_s + buf * TILE, lhs,
                      [&](int r, int c) -> const float* {
                        return (r0 + r < r_end && k0 + c < K)
                                   ? lhs + (size_t)(r0 + r) * K + k0 + c
                                   : nullptr;
                      });
    stage<BK, BN, LD>(b_s + buf * TILE, dout,
                      [&](int r, int c) -> const float* {
                        return (r0 + r < r_end && n0 + c < N)
                                   ? dout + (size_t)(r0 + r) * N + n0 + c
                                   : nullptr;
                      });
  };
  const int n_steps = (r_end - r_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s, r_begin + s * BK);
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<STAGES - 2>();    // stage st landed (this thread's part)
    __syncthreads();                // ... every thread's; stage st - 1 done
    const int ahead = st + STAGES - 1;
    if (ahead < n_steps) load(ahead % STAGES, r_begin + ahead * BK);
    cp_async_commit();
    const float* a = a_s + (st % STAGES) * TILE;
    const float* b = b_s + (st % STAGES) * TILE;
    // The stage's products from zero, then into the running sums.
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[i][j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragB bf[NI];
      load_b_kn<NI>(bf, b, LD, kk, wc, lane);
      FragA af[MI];
      load_a_km4(af, a, LD, kk, wr, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma3(part[i][j], af[i], bf[j]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][j][x] += part[i][j][x];
  }
  cp_async_wait<0>();

  // An expert with no rows kept its zeros. K and N are multiples of 8: a
  // run of 8 columns fits whole or not at all.
  float* out_e = out + (size_t)e * K * N;
  if (n0 + wc + 8 * t < N) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = k0 + wr + 32 * h + 4 * g + i;
        if (m < K) store_acc_row<NI>(out_e + (size_t)m * N + n0, wc, acc[i],
                                     h, lane);
      }
  }
}

template <bool TRANS>
cudaError_t launch(const void* lhs, const void* rhs, const int32_t* be,
                   const int32_t* bl, void* out, int m_pad, int k, int n,
                   int block_m, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gmm_tf32x3<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<TRANS>::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(m_pad / BM, (n + BN - 1) / BN);
  gmm_tf32x3<TRANS><<<grid, NT, Smem<TRANS>::BYTES, stream>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs), be, bl,
      static_cast<float*>(out), k, n, block_m);
  return cudaGetLastError();
}

}  // namespace

// gmm_launch's arguments (csrc/gmm.cu): dtype must be 0 (float32). Returns
// cudaGetLastError() after the launch (0 = success) or
// cudaErrorInvalidValue for what the kernel does not take (K or N not a
// multiple of 8, block_m not a multiple of the row tile, m_pad not a
// multiple of block_m); the Python wrapper checks first and raises on any
// nonzero return.
extern "C" int gmm_tf32x3_launch(const void* lhs, const void* rhs,
                                 const void* block_expert,
                                 const void* block_live, void* out,
                                 int m_pad, int k, int n, int num_experts,
                                 int block_m, int trans_rhs, int dtype,
                                 void* stream) {
  if (m_pad <= 0 || k <= 0 || n <= 0 || num_experts <= 0 || k % 8 ||
      n % 8 || block_m <= 0 || block_m % BM || m_pad % block_m || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* be = static_cast<const int32_t*>(block_expert);
  const int32_t* bl = static_cast<const int32_t*>(block_live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(trans_rhs
                   ? launch<true>(lhs, rhs, be, bl, out, m_pad, k, n,
                                  block_m, s)
                   : launch<false>(lhs, rhs, be, bl, out, m_pad, k, n,
                                   block_m, s));
}

// tgmm_launch's arguments (csrc/gmm.cu): dtype must be 0 (float32). Returns
// cudaGetLastError() after the launch (0 = success) or
// cudaErrorInvalidValue for what the kernel does not take (K or N not a
// multiple of 8, block_m not a multiple of the row tile, m_pad not a
// multiple of block_m); the Python wrapper checks first and raises on any
// nonzero return.
extern "C" int tgmm_tf32x3_launch(const void* lhs, const void* dout,
                                  const void* row_offset,
                                  const void* group_sizes, void* out,
                                  int m_pad, int k, int n, int num_experts,
                                  int block_m, int dtype, void* stream) {
  if (m_pad <= 0 || k <= 0 || n <= 0 || num_experts <= 0 || k % 8 ||
      n % 8 || block_m <= 0 || block_m % BM || m_pad % block_m || dtype != 0)
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = (size_t)STAGES * 2 * BK * (BM + 4) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      tgmm_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((k + BM - 1) / BM, (n + BN - 1) / BN, num_experts);
  tgmm_tf32x3<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(dout),
      static_cast<const int32_t*>(row_offset),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(out), k,
      n, block_m);
  return (int)cudaGetLastError();
}
