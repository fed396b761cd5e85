// Grouped matrix multiply on Hopper's tensor cores (wgmma), bf16 in, f32
// accumulation, rounded once to bf16: the forward (also the input
// gradient, with the weight read transposed) and the weight gradient.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py
//   `_gmm_kernel`  (:159, launched by `_gmm_call` at :176) -> gmm_wgmma
//   `_tgmm_kernel` (:209, launched by `_tgmm_call` at :239) -> tgmm_wgmma
// ops/gmm.py `_gmm_route` sends bf16 calls here; float32 stays on
// gmm_kernel and tgmm_kernel (csrc/gmm.cu, mma.sync and CUDA cores).
//
// Contract (gmm.cu's, narrowed to bfloat16):
//   lhs          [M_pad, K]    rows sorted by expert in block-aligned spans
//   rhs          [E, K, N];    trans_rhs: [E, N, K], read as its transpose
//   row_offset, group_sizes    [E] int32: first row and real rows of each
//                              expert
//   block_expert, block_live   [M_pad / block_m] int32
//   gmm:  out[block] = lhs[block] . rhs[e] for a live row block of expert e,
//         0 for a dead block; [M_pad, N].
//   tgmm: out[e] = sum over the rows of e's live blocks of
//         lhs[r]^T . dout[r]; [E, K, N]; an expert with no rows gets 0.
// K and N are multiples of 8, block_m a multiple of 128. Edges are
// zero-filled on load and masked on store.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): operations.
// 16,384 routed rows at the MoE slice's K 768 -> N 2048 are 2 M K N =
// 51.5 GFLOP (0.0521 ms) against 123 MB read or written once (0.037 ms);
// at Mixtral's 4096 -> 14336 they are 1.92 TFLOP (1.9455 ms) against
// 1.58 GB (0.47 ms).
// What the design does about it:
// - Every product runs on wgmma m64n256k16 from shared memory. A CTA
//   computes a 128 x 256 output tile with two consumer warpgroups of 64
//   rows; operand tiles are 64 deep, stored [cols / 64][rows][64] with the
//   128-byte swizzle. gmm reads lhs K-major and rhs N-major (trans-b), or
//   in dlhs rhs [E, N, K] K-major, so its transpose is never formed; tgmm
//   reads lhs^T M-major (trans-a) and dout N-major (trans-b). A 256-wide
//   tile moves a quarter fewer bytes into shared memory per product than
//   a 128-wide one, whose copies alone took about as long as its
//   products.
// - A four-slot cp.async ring, the copies two stages ahead: those of
//   stages t + 1 and t + 2 run under the products of stage t, which run on
//   while the next stage's barrier and copies are issued. One barrier a
//   stage publishes the copies and frees the slot of stage t - 2.
// - One CTA an SM (193 KB of shared memory, up to 255 registers a
//   thread). The tile's prologue and epilogue are not overlapped with
//   another tile's loop: the designs that did so (two 128 x 128 CTAs an
//   SM; persistent grids of these CTAs, the ring running on across tiles
//   or the next tile's copies started under this tile's epilogue) were
//   slower on dlhs and tgmm and no faster on the forward (PERF.md).
// - The epilogue stages the bf16 tile through shared memory (swizzled, no
//   bank conflicts) and stores 16 bytes a thread, whole rows of the tile
//   in turn.
// - gmm: a CTA owns one 128-row block of the layout, so it never straddles
//   two experts, and reads that block's expert and live flag from device
//   memory; a dead block writes zeros and returns. Tiles run in groups of
//   GROUP_M row tiles (about one expert's rows at 2,048 rows an expert),
//   rows fastest: a group's weight column tile comes from L2 after its
//   first read, and its lhs rows stay in L2 across the column tiles.
// - tgmm: a CTA owns one (expert, K tile, N tile) and loops over the rows
//   of the expert's live blocks, 64 a stage (spans are whole 128-row
//   blocks, so no stage is ragged). The sum stays in registers and is
//   written once: no atomics, no split, the same bits on every launch. The
//   experts run heaviest first (each CTA ranks them by group_sizes, with
//   no host sync), so the skewed case's largest expert does not set the
//   tail; within an expert the smaller of the K and N tile counts runs
//   fastest, so the operand rows its CTAs share stay in L2.
// `kernel_breakdown.py gmm` times each stage; PERF.md keeps the times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // output rows of a tile (gmm rows, tgmm K)
constexpr int BN = 256;       // output columns of a tile
constexpr int BK = 64;        // contraction depth of a stage
constexpr int NT = 256;       // two consumer warpgroups
constexpr int STAGES = 4;     // ring slots
constexpr int DIST = 2;       // stages whose copies run ahead of the products
constexpr int GROUP_M = 16;   // gmm row tiles that run next to each other
constexpr unsigned FULL = 0xffffffffu;
// Shared memory, in bytes from a 1024-byte aligned base: each ring slot
// holds the A tile (16 KB), then the B tile (32 KB); the epilogue's
// 128 x 256 bf16 tile (64 KB) reuses the ring.
constexpr int A_TILE = BM * BK * 2;
constexpr int STAGE = A_TILE + BK * BN * 2;
constexpr int SMEM_BYTES = STAGES * STAGE + 1024;

// Copy a [ROWS][CH x 8] bf16 tile at src (row stride ld elements) into the
// swizzled layout at dst with 16-byte cp.async: rows past row_lim and
// 16-byte chunks past ch_lim are zero-filled. A thread copies chunk
// tid % CH of every (NT / CH)-th row; that step is a multiple of 8 rows,
// so the swizzled destination moves by whole rows.
template <int ROWS, int CH>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* src, size_t ld,
                                          int row_lim, int ch_lim, int tid) {
  constexpr int RS = NT / CH;
  static_assert(RS % 8 == 0 && ROWS % RS == 0, "copy grid");
  const int c = tid % CH, r0 = tid / CH;
  const uint32_t d0 = swz(ROWS, r0, c);
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i) {
    const int r = r0 + i * RS;
    const bool valid = r < row_lim && c < ch_lim;
    cp_async16(dst + d0 + i * RS * 128,
               src + (valid ? (size_t)r * ld + c * 8 : 0), valid);
  }
}

// acc (this warpgroup's 64 x BN f32 tile) += the products of n_steps
// stages. issue(u, slot) starts the copies of stage u into ring slot
// `slot`; a_desc(base, kk) and b_desc(base, kk) give the descriptors of
// k-step kk of the A and B tiles of the slot at shared address base.
// n_steps must be warp-uniform (the products stay asynchronous only then).
template <int TA, int TB, typename Issue, typename ADesc, typename BDesc>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2], int n_steps,
                                         uint32_t sbase, Issue issue,
                                         ADesc a_desc, BDesc b_desc) {
#pragma unroll 1
  for (int u = 0; u < DIST; ++u) {
    if (u < n_steps) issue(u, u);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<DIST - 1>();         // stage t landed
    fence_proxy_async();
    __syncthreads();                   // ... for every thread; t - 2 done
    if (t + DIST < n_steps) issue(t + DIST, (t + DIST) % STAGES);
    cp_async_commit();
    const uint32_t st = sbase + (t % STAGES) * STAGE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n256<TA, TB>(acc, a_desc(st, kk), b_desc(st, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();                   // stage t - 1's products are done
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
}

// Write the CTA's BM x BN tile (acc: this thread's part of its
// warpgroup's 64 rows) as bf16 to out[r][c] (row stride ld), rows below
// row_lim and 8-column chunks below ch_lim. The tile goes through shared
// memory (row r at 2 BN r, its chunk c at chunk c ^ (r % 8)), then every
// thread stores 16 bytes at a time, a whole row of the tile per BN / 8
// threads. Reuses the ring: the caller's products and copies are done.
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           unsigned char* smem, bf16* out,
                                           size_t ld, int row_lim,
                                           int ch_lim, int tid) {
  const int lane = tid & 31;
  // Accumulator layout: element i is in row r0 (bit 1 of i clear) or
  // r0 + 8, column 8 (i / 4) + cq + (i & 1).
  const int r0 = (tid >> 7) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  __syncthreads();                     // every warpgroup is off the ring
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<uint32_t*>(smem + r * BN * 2 + ((j ^ (r & 7)) << 4) +
                                   2 * cq) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM * BN / 8 / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / (BN / 8), c = idx % (BN / 8);
    if (r < row_lim && c < ch_lim)
      *reinterpret_cast<uint4*>(out + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(smem + r * BN * 2 +
                                          ((c ^ (r & 7)) << 4));
  }
}

// One CTA per BM x BN output tile, a 1-D grid walked in groups of
// GROUP_M row tiles, rows fastest.
template <bool TRANS>
__global__ void __launch_bounds__(NT, 1)
gmm_wgmma(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
          const int32_t* __restrict__ block_expert,
          const int32_t* __restrict__ block_live, bf16* __restrict__ out,
          int K, int N, int tiles_m, int block_m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first = blockIdx.x / per_group * GROUP_M;
  const int in_group = blockIdx.x % per_group;
  const int gm = min(tiles_m - first, GROUP_M);
  const int row0 = (first + in_group % gm) * BM;
  const int col0 = in_group / gm * BN;
  const int blk = row0 / block_m;
  // Broadcast from lane 0: warp-uniform to the compiler.
  const int e = __shfl_sync(FULL, block_expert[blk], 0);
  const int live = __shfl_sync(FULL, block_live[blk], 0);
  bf16* o = out + (size_t)row0 * N + col0;
  const int ch_lim = (N - col0) / 8;
  if (!live) {                         // a dead block writes zeros
    for (int idx = tid; idx < BM * BN / 8; idx += NT) {
      const int r = idx / (BN / 8), c = idx % (BN / 8);
      if (c < ch_lim)
        *reinterpret_cast<uint4*>(o + (size_t)r * N + c * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const bf16* a_g = lhs + (size_t)row0 * K;
  const bf16* w = rhs + (size_t)e * K * N;
  auto issue = [&](int u, int slot) {
    unsigned char* st = smem + slot * STAGE;
    const int k0 = u * BK;
    load_tile<BM, BK / 8>(st, a_g + k0, K, BM, (K - k0) / 8, tid);
    if constexpr (TRANS)    // rhs [E, N, K]: BN rows of N, K contiguous
      load_tile<BN, BK / 8>(st + A_TILE, w + (size_t)col0 * K + k0, K,
                            N - col0, (K - k0) / 8, tid);
    else          // rhs [E, K, N]: BK rows of K, N contiguous
      load_tile<BK, BN / 8>(st + A_TILE, w + (size_t)k0 * N + col0, N,
                            K - k0, ch_lim, tid);
  };
  const int wg = tid >> 7;
  // A: this warpgroup's 64 rows, K-major; k-step kk is 32 bytes into the
  // swizzle atom. B: N-major (the k-step is 16 rows of 128 bytes, the two
  // 64-column halves LBO apart) or, transposed, K-major.
  auto a_desc = [=](uint32_t st, int kk) {
    return desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
  };
  auto b_desc = [=](uint32_t st, int kk) {
    if constexpr (TRANS) return desc(st + A_TILE + kk * 32, 16, 1024);
    return desc(st + A_TILE + kk * 2048, BK * 128, 1024);
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int n_steps = (K + BK - 1) / BK;
  mainloop<0, TRANS ? 0 : 1>(acc, n_steps, sbase, issue, a_desc, b_desc);
  store_tile(acc, smem, o, (size_t)N, BM, ch_lim, tid);
}

// One CTA per (expert, K tile, N tile), a 1-D grid: the experts by rank,
// the most rows first (ties by index); within an expert, the smaller of
// the K and N tile counts fastest.
__global__ void __launch_bounds__(NT, 1)
tgmm_wgmma(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
           const int32_t* __restrict__ row_offset,
           const int32_t* __restrict__ group_sizes, bf16* __restrict__ out,
           int K, int N, int num_experts, int block_m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  __shared__ int picked;
  const int tid = threadIdx.x;
  const int tiles_k = (K + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_e = tiles_k * tiles_n;
  const int rank = blockIdx.x / per_e, in_e = blockIdx.x % per_e;
  const bool k_fast = tiles_k <= tiles_n;
  const int k0 = (k_fast ? in_e % tiles_k : in_e / tiles_n) * BM;
  const int n0 = (k_fast ? in_e / tiles_k : in_e % tiles_n) * BN;
  for (int x = tid; x < num_experts; x += NT) {
    const int gx = group_sizes[x];
    int ahead = 0;
    for (int y = 0; y < num_experts; ++y) {
      const int gy = group_sizes[y];
      ahead += gy > gx || (gy == gx && y < x);
    }
    if (ahead == rank) picked = x;
  }
  __syncthreads();
  const int e = __shfl_sync(FULL, picked, 0);
  const int r_begin = row_offset[e];
  // e's live blocks, whole: a multiple of 128 rows, so of BK.
  const int n_steps = __shfl_sync(
      FULL, (group_sizes[e] + block_m - 1) / block_m * (block_m / BK), 0);
  const int k_ch = (K - k0) / 8, n_ch = (N - n0) / 8;
  auto issue = [&](int u, int slot) {
    unsigned char* st = smem + slot * STAGE;
    const size_t r = (size_t)r_begin + (size_t)u * BK;
    load_tile<BK, BM / 8>(st, lhs + r * K + k0, K, BK, k_ch, tid);
    load_tile<BK, BN / 8>(st + A_TILE, dout + r * N + n0, N, BK, n_ch, tid);
  };
  const int wg = tid >> 7;
  // A = lhs^T, M-major: this warpgroup's 64 columns of K are the tile's
  // 64-column half wg. B = dout, N-major. The k-step is 16 rows.
  auto a_desc = [=](uint32_t st, int kk) {
    return desc(st + wg * BK * 128 + kk * 2048, BK * 128, 1024);
  };
  auto b_desc = [=](uint32_t st, int kk) {
    return desc(st + A_TILE + kk * 2048, BK * 128, 1024);
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  mainloop<1, 1>(acc, n_steps, sbase, issue, a_desc, b_desc);
  store_tile(acc, smem, out + ((size_t)e * K + k0) * N + n0, (size_t)N,
             K - k0, n_ch, tid);
}

template <typename Kern>
cudaError_t prepare(Kern kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <bool TRANS>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const int32_t* be,
                       const int32_t* bl, void* out, int m_pad, int k, int n,
                       int block_m, cudaStream_t stream) {
  cudaError_t e = prepare(gmm_wgmma<TRANS>);
  if (e != cudaSuccess) return e;
  const int tiles_m = m_pad / BM;
  gmm_wgmma<TRANS><<<tiles_m * ((n + BN - 1) / BN), NT, SMEM_BYTES,
                     stream>>>(static_cast<const bf16*>(lhs),
                               static_cast<const bf16*>(rhs), be, bl,
                               static_cast<bf16*>(out), k, n, tiles_m,
                               block_m);
  return cudaGetLastError();
}

}  // namespace

// gmm_launch's and tgmm_launch's arguments (csrc/gmm.cu). dtype must be 1
// (bfloat16). Each returns cudaGetLastError() after its launch (0 =
// success) or cudaErrorInvalidValue for what the kernels do not take (K or
// N not a multiple of 8, block_m not a multiple of 128, m_pad not a
// multiple of block_m); the Python wrappers check first and raise on any
// nonzero return.
extern "C" int gmm_wgmma_launch(const void* lhs, const void* rhs,
                                const void* block_expert,
                                const void* block_live, void* out, int m_pad,
                                int k, int n, int num_experts, int block_m,
                                int trans_rhs, int dtype, void* stream) {
  if (m_pad <= 0 || k <= 0 || n <= 0 || num_experts <= 0 || k % 8 ||
      n % 8 || block_m <= 0 || block_m % BM || m_pad % block_m || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* be = static_cast<const int32_t*>(block_expert);
  const int32_t* bl = static_cast<const int32_t*>(block_live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(trans_rhs
                   ? launch_gmm<true>(lhs, rhs, be, bl, out, m_pad, k, n,
                                      block_m, s)
                   : launch_gmm<false>(lhs, rhs, be, bl, out, m_pad, k, n,
                                       block_m, s));
}

extern "C" int tgmm_wgmma_launch(const void* lhs, const void* dout,
                                 const void* row_offset,
                                 const void* group_sizes, void* out,
                                 int m_pad, int k, int n, int num_experts,
                                 int block_m, int dtype, void* stream) {
  if (m_pad <= 0 || k <= 0 || n <= 0 || num_experts <= 0 || k % 8 ||
      n % 8 || block_m <= 0 || block_m % BM || m_pad % block_m || dtype != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(tgmm_wgmma);
  if (e != cudaSuccess) return (int)e;
  const int blocks = num_experts * ((k + BM - 1) / BM) * ((n + BN - 1) / BN);
  tgmm_wgmma<<<blocks, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout),
      static_cast<const int32_t*>(row_offset),
      static_cast<const int32_t*>(group_sizes), static_cast<bf16*>(out), k,
      n, num_experts, block_m);
  return (int)cudaGetLastError();
}
