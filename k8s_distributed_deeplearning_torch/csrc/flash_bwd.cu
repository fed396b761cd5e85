// Flash-attention backward on Hopper's tensor cores (wgmma): the dQ kernel
// and the dK/dV kernel, bf16 in, f32 accumulation, head_dim 64 or 128.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_flash.py
//   `_bwd_dq_kernel`  (:396, launched by `_bwd` at :690) -> flash_dq_wgmma
//   `_bwd_dkv_kernel` (:520, launched by `_bwd` at :723) -> flash_dkv_wgmma
// ops/flash_attn.py `_bwd_route` sends bf16 calls at head_dim 64 or 128
// here; float32 and head_dim 16 or 32 stay on the mma.sync kernels of
// csrc/flash_attn.cu.
//
// Contract (flash_attn.cu's backward, narrowed to what these take):
//   q, dout    [B, sq, H, D]    bfloat16, D 64 or 128
//   k, v       [B, sk, kv, D]   bfloat16; q head h reads KV head h / (H/kv)
//   lse, delta [B, H, sq]       float32 (delta = rowsum(dO * O), the caller's)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   dq [B, sq, H, D]; dk, dv [B, sk, kv, D], bfloat16: the group summed
// Causal masking is bottom-right aligned: row i sees key j iff
// i + (sk - sq) >= j. Rounding points, flash_attention_bwd_reference's:
// P = exp(s * scale - lse) in f32, 0 where masked; dS = P (dP - delta)
// scale, rounded to bf16 before dS.K and dS^T.Q; P rounded to bf16 before
// P^T.dO; products of bf16 values summed in f32; each output cast once. The
// exponential runs in the log2 domain, 2^(s * scale * log2 e - lse * log2 e)
// (ex2.approx.ftz), the same value to a few ulp. A masked pair gives
// exactly 0, so a row that sees nothing gives exactly 0 in dQ, dK and dV.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): operations.
// Each product is 2 * D FLOPs per visible (query, key) pair and query
// head; the dQ kernel does three (S = Q.K^T, dP = dO.V^T, dQ += dS.K), the
// dK/dV kernel four (S^T = K.Q^T, dP^T = V.dO^T, dV += P^T.dO,
// dK += dS^T.Q). Causal, B 2, S 2048, 32/8 heads, D 128: 103 and 137
// GFLOP, 0.104 and 0.139 ms, against 118 and 102 MB read or written once
// (0.035 and 0.030 ms).
// What the design does about it:
// - Every product runs on wgmma. S, dP, S^T and dP^T read both operands
//   K-major from shared memory (m64n64k16); dQ, dV and dK take dS, P^T or
//   dS^T from registers (the accumulator's layout is the A operand's) and
//   read K, dO or Q N-major (trans-b) from the same tiles the first
//   products used. Tiles are [D / 64][rows][64] bf16 with the 128-byte
//   swizzle.
// - A flattened row is (query position, head of the KV head's group), so
//   one K/V tile serves the whole group (dQ) and the group sum of dK and dV
//   stays in registers (dK/dV): no atomics, every output written once, the
//   same bits from run to run.
// - dQ: one CTA per (tile of 128 flattened query rows, two consumer
//   warpgroups of 64), KV head, batch row; heaviest tiles first. Q and dO are
//   loaded once; 64-key K/V tiles stream through a three-slot cp.async
//   ring two tiles ahead, up to the rows' last visible key.
// - dK/dV: one CTA per (tile of 128 keys, two warpgroups of 64), KV
//   head, batch row; K and V loaded once; 64-row Q/dO
//   tiles, with each row's lse, delta, segment id and last visible key,
//   stream through the same kind of ring from the causal frontier to the
//   end. At D 128 a thread holds dK and dV (128 f32), S^T and dP^T (64),
//   which die into the bf16 P^T and dS^T fragments (32) as they are
//   computed, and the products of one tile finish before the next tile's
//   S^T is zeroed: about 200 values live at once, which ptxas fits in 242
//   registers without a spill (launch bound 255).
// - The loop bounds and the test that lets a tile skip its mask are
//   broadcast from lane 0, and the loop body is straight-line: every
//   warpgroup walks every tile of its CTA (a pair it cannot see gives
//   p = 0 and adds exactly 0), so ptxas keeps the products asynchronous.
// - Within a warpgroup the products of a tile run one after the other
//   (S and dP together, then dQ; or S^T and dP^T, then dV and dK); the
//   two warpgroups of a CTA overlap one another's products and softmax.
//   Leaving a tile's second products running beside the next tile's first
//   (paged_prefill.cu's pattern) was tried and is not done: its gain was
//   small beside its cost, a fourth ring slot and more code (PERF.md §6).
//   `kernel_breakdown.py flash_bwd` times each stage.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>

#include "wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int KT = 64;          // keys per K/V tile of the dQ kernel
constexpr int QT = 64;          // flattened query rows per Q/dO tile (dK/dV)
constexpr int DIST = 2;         // tiles in flight ahead of the current one
// Ring slots: the tiles in flight and the current one. A tile's products
// are waited for before the barrier that frees its slot.
constexpr int STAGES = DIST + 1;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of the dQ kernel, in bytes from a 1024-byte aligned base:
// ROWS query rows (64 per consumer warpgroup) of Q and dO, then the ring of
// K and V tiles, then each stage's key segment ids. Every tile that wgmma
// reads starts 1024-byte aligned, as the 128-byte swizzle needs.
template <int HD>
struct DqPlan {
  static constexpr int ROWS = 128;
  static constexpr int THREADS = 256;
  static constexpr int TILE = KT * HD * 2;        // a bf16 K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = ROWS * HD * 2;
  static constexpr int RING_OFF = 2 * ROWS * HD * 2;
  static constexpr int STAGE = 2 * TILE;          // K, then V
  static constexpr int SEG_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BYTES = SEG_OFF + STAGES * KT * 4 + 1024;
};

// Shared memory of the dK/dV kernel: ROWS keys of K and V, the ring of Q
// and dO tiles, then per stage and column (flattened query row) its lse,
// delta, segment id and last visible key.
template <int HD>
struct DkvPlan {
  static constexpr int ROWS = 128;
  static constexpr int THREADS = 256;
  static constexpr int TILE = QT * HD * 2;        // a bf16 Q or dO tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = ROWS * HD * 2;
  static constexpr int RING_OFF = 2 * ROWS * HD * 2;
  static constexpr int STAGE = 2 * TILE;          // Q, then dO
  static constexpr int COL_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BYTES = COL_OFF + STAGES * 4 * QT * 4 + 1024;
};

struct Geo {
  int batch, sq, sk, n_heads, n_kv, group, rows_total, off, causal, seg;
  float scale;
};

// Flattened query row fr of KV head kvh in batch row b: position
// fr / group, head kvh * group + fr % group. Its row in a [B, sq, H, D]
// tensor, and its element of a [B, H, sq] statistic.
__device__ __forceinline__ size_t q_row(const Geo& g, int b, int kvh,
                                        int fr) {
  const int i = fr / g.group, h = kvh * g.group + fr % g.group;
  return ((size_t)b * g.sq + i) * g.n_heads + h;
}
__device__ __forceinline__ size_t stat_at(const Geo& g, int b, int kvh,
                                          int fr) {
  const int i = fr / g.group, h = kvh * g.group + fr % g.group;
  return ((size_t)b * g.n_heads + h) * g.sq + i;
}

// Grid: (n_kv * B, row tiles). CTA (x, y) serves KV head x % n_kv of batch
// row x / n_kv and row tile (row tiles - 1 - y), the heaviest first under
// causal masking: flattened rows [tile * ROWS, (tile + 1) * ROWS).
template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_dq_wgmma(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const int32_t* __restrict__ segq,
               const int32_t* __restrict__ segk,
               __nv_bfloat16* __restrict__ dq, Geo g) {
  using P = DqPlan<HD>;
  constexpr int ROWS = P::ROWS;
  constexpr int NT = P::THREADS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  int* segk_s = reinterpret_cast<int*>(smem + P::SEG_OFF);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;                 // consumer warpgroup
  const int kvh = blockIdx.x % g.n_kv;
  const int b = blockIdx.x / g.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * ROWS;

  // Q and dO, zero rows past the end; they land with K/V tile 0.
  {
    constexpr int CPR = HD / 8;
    for (int idx = tid; idx < ROWS * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR;
      const int fr = row0 + r;
      const bool valid = fr < g.rows_total;
      const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
      const uint32_t d = swz(ROWS, r, ch);
      cp_async16(smem + P::Q_OFF + d, q + off, valid);
      cp_async16(smem + P::DO_OFF + d, dout + off, valid);
    }
  }
  // Keys [0, kend) are visible to some row of the CTA; keys [0, c_full)
  // to every row of this warpgroup (none with segment ids). Broadcast from
  // lane 0, the loop bounds and the mask test are warp-uniform to the
  // compiler, which then keeps the products asynchronous.
  const int r_last = min(row0 + ROWS, g.rows_total) - 1;
  const int kend =
      g.causal ? max(0, min(g.sk, r_last / g.group + g.off + 1)) : g.sk;
  const int n_tiles = __shfl_sync(FULL, (kend + KT - 1) / KT, 0);
  int c_full = g.sk;
  if (g.seg)
    c_full = 0;
  else if (g.causal)
    c_full = max(0, min(g.sk, (row0 + wg * 64) / g.group + g.off + 1));
  c_full = __shfl_sync(FULL, c_full, 0);

  // This thread's rows of its warpgroup's 64-row tile (the wgmma
  // accumulator layout): r0 and r0 + 8; in each 8-column group, columns
  // cq and cq + 1. Element i of an accumulator is in row r0 when bit 1 of
  // i is clear, r1 otherwise; its column is 8 * (i / 4) + cq + (i & 1).
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float lse2[2], dlt[2];
  int lim[2], sgq[2];           // last visible key; segment id
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + r0 + 8 * h;
    const bool valid = fr < g.rows_total;
    const int i = valid ? fr / g.group : 0;
    const size_t st = valid ? stat_at(g, b, kvh, fr) : 0;
    lse2[h] = valid ? lse[st] * LOG2E : 0.f;
    dlt[h] = valid ? delta[st] : 0.f;
    lim[h] = !valid ? -1 : g.causal ? min(i + g.off, g.sk - 1) : g.sk - 1;
    sgq[h] = (valid && g.seg) ? segq[(size_t)b * g.sq + i] : 0;
  }

  // Gather key tile u into ring stage `stage`: called by every thread. A
  // thread copies the same 16-byte column `ch` of every JS-th key; JS is a
  // multiple of 8, so the swizzled destination moves by JS rows a step.
  constexpr int CPR = HD / 8;
  constexpr int JS = NT / CPR;
  static_assert(NT % CPR == 0 && JS % 8 == 0 && KT % JS == 0, "copy grid");
  const int ch = tid % CPR, j0 = tid / CPR;
  const uint32_t dst0 = swz(KT, j0, ch);
  const size_t key_stride = (size_t)g.n_kv * HD;
  const size_t kv_base = ((size_t)b * g.sk * g.n_kv + kvh) * HD + ch * 8;
  auto issue = [&](int u, int stage) {
    unsigned char* st = smem + P::RING_OFF + stage * P::STAGE;
#pragma unroll
    for (int kk = 0; kk < KT / JS; ++kk) {
      const int j = u * KT + j0 + kk * JS;
      const bool valid = j < g.sk;
      const size_t off = valid ? kv_base + (size_t)j * key_stride : 0;
      cp_async16(st + dst0 + kk * JS * 128, k + off, valid);
      cp_async16(st + P::TILE + dst0 + kk * JS * 128, v + off, valid);
    }
    if (g.seg) {
      for (int jj = tid; jj < KT; jj += NT) {
        const int j = u * KT + jj;
        const bool valid = j < g.sk;
        cp_async4(segk_s + stage * KT + jj,
                  segk + (valid ? (size_t)b * g.sk + j : 0), valid);
      }
    }
  };

  const uint32_t q_addr = sbase + P::Q_OFF + wg * 64 * 128;
  const uint32_t do_addr = sbase + P::DO_OFF + wg * 64 * 128;
  const float sl = g.scale * LOG2E;   // scores go to the log2 domain
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) issue(u, u);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DIST - 1>();       // tile t (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();                 // ... for every thread; tile t - 1 done
    if (t + DIST < n_tiles) issue(t + DIST, (t + DIST) % STAGES);
    cp_async_commit();
    const int stage = t % STAGES;
    const uint32_t k_addr = sbase + P::RING_OFF + stage * P::STAGE;
    const uint32_t v_addr = k_addr + P::TILE;

    // S = Q . K^T and dP = dO . V^T, two commit groups.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_ss_rows<HD>(s, q_addr, ROWS, k_addr);
    wgmma_commit();
    wgmma_ss_rows<HD>(dp, do_addr, ROWS, v_addr);
    wgmma_commit();

    wgmma_wait<1>();                 // S is in s
    fence_regs(s);
    const int c0 = t * KT;
    const bool full = c0 + KT <= c_full;
    const int* sk_s = segk_s + stage * KT;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = ex2(fmaf(s[i], sl, -lse2[h]));
      if (!full) {
        const int col = 8 * (i >> 2) + cq + (i & 1);
        const bool ok =
            c0 + col <= lim[h] && (!g.seg || sk_s[col] == sgq[h]);
        p = ok ? p : 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();                 // dP is in dp
    fence_regs(dp);
    // dS in bf16 as wgmma A fragments: register r of k-step kk holds
    // elements 8kk + 2r and 8kk + 2r + 1, both in row r0 + 8 (r & 1).
    uint32_t dsf[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, h = r & 1;
        dsf[kk][r] = pack_bf16(s[i] * (dp[i] - dlt[h]) * g.scale,
                               s[i + 1] * (dp[i + 1] - dlt[h]) * g.scale);
      }
    }
    // dQ += dS . K, K read N-major from the same tile.
    fence_regs(dsf);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs<HD>(acc, dsf[kk], desc(k_addr + kk * 2048, KT * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = row0 + r0 + 8 * half;
    if (fr >= g.rows_total) continue;
    __nv_bfloat16* op = dq + q_row(g, b, kvh, fr) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * half;
      *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(acc[e], acc[e + 1]);
    }
  }
}

// Grid: (n_kv * B, key tiles). CTA (x, y) serves KV head x % n_kv of batch
// row x / n_kv and keys [y * ROWS, (y + 1) * ROWS); under causal masking
// key tile 0 sees the most rows and launches first.
template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_dkv_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ segq,
                const int32_t* __restrict__ segk,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, Geo g) {
  using P = DkvPlan<HD>;
  constexpr int ROWS = P::ROWS;
  constexpr int NT = P::THREADS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  // Per stage, per column: lse, delta, segment id, last visible key.
  float* lse_s = reinterpret_cast<float*>(smem + P::COL_OFF);
  float* dlt_s = lse_s + STAGES * QT;
  int* sgq_s = reinterpret_cast<int*>(dlt_s + STAGES * QT);
  int* lim_s = sgq_s + STAGES * QT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int kvh = blockIdx.x % g.n_kv;
  const int b = blockIdx.x / g.n_kv;
  const int key0 = blockIdx.y * ROWS;

  // K and V, zero keys past the end; they land with Q/dO tile 0.
  {
    constexpr int CPR = HD / 8;
    for (int idx = tid; idx < ROWS * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR;
      const int j = key0 + r;
      const bool valid = j < g.sk;
      const size_t off =
          valid ? (((size_t)b * g.sk + j) * g.n_kv + kvh) * HD + ch * 8 : 0;
      const uint32_t d = swz(ROWS, r, ch);
      cp_async16(smem + P::K_OFF + d, k + off, valid);
      cp_async16(smem + P::V_OFF + d, v + off, valid);
    }
  }
  // Query tiles [u0, u0 + n_tiles): under causal masking from the tile of
  // the first flattened row that sees key0 (position key0 - off). A tile
  // skips the mask when all its rows are real and see this warpgroup's
  // last real key j_last (and there are no segment ids). Broadcast from
  // lane 0, as in the dQ kernel.
  const int u_first =
      g.causal ? max(0, key0 - g.off) * g.group / QT : 0;
  const int u0 = __shfl_sync(FULL, u_first, 0);
  const int n_tiles =
      __shfl_sync(FULL, (g.rows_total + QT - 1) / QT - u_first, 0);
  const int j_last =
      __shfl_sync(FULL, min(key0 + wg * 64 + 63, g.sk - 1), 0);

  // This thread's keys (the accumulator rows): key0 + r0 and key0 + r0 + 8;
  // in each 8-column group, columns cq and cq + 1.
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int key[2], sgk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = key0 + r0 + 8 * h;
    sgk[h] = (g.seg && key[h] < g.sk) ? segk[(size_t)b * g.sk + key[h]] : 0;
  }

  // Gather query tile u (flattened rows [u * QT, (u + 1) * QT)) into ring
  // stage `stage`, with each row's statistics: called by every thread.
  constexpr int CPR = HD / 8;
  constexpr int JS = NT / CPR;
  static_assert(NT % CPR == 0 && JS % 8 == 0 && QT % JS == 0, "copy grid");
  const int ch = tid % CPR, jr = tid / CPR;
  const uint32_t dst0 = swz(QT, jr, ch);
  auto issue = [&](int u, int stage) {
    unsigned char* st = smem + P::RING_OFF + stage * P::STAGE;
#pragma unroll
    for (int kk = 0; kk < QT / JS; ++kk) {
      const int fr = u * QT + jr + kk * JS;
      const bool valid = fr < g.rows_total;
      const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
      cp_async16(st + dst0 + kk * JS * 128, q + off, valid);
      cp_async16(st + P::TILE + dst0 + kk * JS * 128, dout + off, valid);
    }
    for (int c = tid; c < QT; c += NT) {
      const int fr = u * QT + c;
      const bool valid = fr < g.rows_total;
      const int i = valid ? fr / g.group : 0;
      const size_t so = valid ? stat_at(g, b, kvh, fr) : 0;
      cp_async4(lse_s + stage * QT + c, lse + so, valid);
      cp_async4(dlt_s + stage * QT + c, delta + so, valid);
      if (g.seg)
        cp_async4(sgq_s + stage * QT + c, segq + (size_t)b * g.sq + i, valid);
      lim_s[stage * QT + c] =
          !valid ? -1 : g.causal ? i + g.off : INT_MAX;
    }
  };

  const uint32_t k_addr = sbase + P::K_OFF + wg * 64 * 128;
  const uint32_t v_addr = sbase + P::V_OFF + wg * 64 * 128;
  const float sl = g.scale * LOG2E;
  float adk[HD / 2], adv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;

#pragma unroll 1
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) issue(u0 + u, u);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DIST - 1>();       // tile t (and K, V) landed
    fence_proxy_async();
    __syncthreads();                 // ... for every thread; tile t - 1 done
    if (t + DIST < n_tiles) issue(u0 + t + DIST, (t + DIST) % STAGES);
    cp_async_commit();
    const int stage = t % STAGES;
    const uint32_t q_t = sbase + P::RING_OFF + stage * P::STAGE;
    const uint32_t do_t = q_t + P::TILE;

    // S^T = K . Q^T and dP^T = V . dO^T, two commit groups.
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    wgmma_ss_rows<HD>(st, k_addr, ROWS, q_t);
    wgmma_commit();
    wgmma_ss_rows<HD>(dpt, v_addr, ROWS, do_t);
    wgmma_commit();

    const int u = u0 + t;
    const bool full = !g.seg && (u + 1) * QT <= g.rows_total &&
                      (!g.causal || u * QT / g.group + g.off >= j_last);
    const float* ls = lse_s + stage * QT;
    const float* ds_ = dlt_s + stage * QT;
    const int* gs = sgq_s + stage * QT;
    const int* ms = lim_s + stage * QT;
    wgmma_wait<1>();                 // S^T is in st
    fence_regs(st);
    // P^T = 2^(s * scale * log2 e - lse * log2 e) of each column's row.
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + cq;
      const float2 l = *reinterpret_cast<const float2*>(ls + col);
      float p0 = ex2(fmaf(st[i], sl, -(l.x * LOG2E)));
      float p1 = ex2(fmaf(st[i + 1], sl, -(l.y * LOG2E)));
      if (!full) {
        const int2 m = *reinterpret_cast<const int2*>(ms + col);
        bool ok0 = key[h] <= m.x, ok1 = key[h] <= m.y;
        if (g.seg) {
          const int2 sg = *reinterpret_cast<const int2*>(gs + col);
          ok0 = ok0 && sg.x == sgk[h];
          ok1 = ok1 && sg.y == sgk[h];
        }
        p0 = ok0 ? p0 : 0.f;
        p1 = ok1 ? p1 : 0.f;
      }
      st[i] = p0;
      st[i + 1] = p1;
    }
    wgmma_wait<0>();                 // dP^T is in dpt
    fence_regs(dpt);
    // P^T and dS^T in bf16 as A fragments (see the dQ kernel).
    uint32_t pf[QT / 16][4], dsf[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const int col = 8 * (i >> 2) + cq;
        const float2 d = *reinterpret_cast<const float2*>(ds_ + col);
        pf[kk][r] = pack_bf16(st[i], st[i + 1]);
        dsf[kk][r] = pack_bf16(st[i] * (dpt[i] - d.x) * g.scale,
                               st[i + 1] * (dpt[i + 1] - d.y) * g.scale);
      }
    }
    // dV += P^T . dO and dK += dS^T . Q, dO and Q read N-major.
    fence_regs(pf);
    fence_regs(dsf);
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_rs<HD>(adv, pf[kk], desc(do_t + kk * 2048, QT * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_rs<HD>(adk, dsf[kk], desc(q_t + kk * 2048, QT * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = key[half];
    if (j >= g.sk) continue;
    const size_t off = (((size_t)b * g.sk + j) * g.n_kv + kvh) * HD + cq;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int e = 4 * c + 2 * half;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * c) =
          pack_bf16(adk[e], adk[e + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * c) =
          pack_bf16(adv[e], adv[e + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *segq, *segk;
  void *dq, *dk, *dv;
};

template <int HD>
cudaError_t launch_dq(const Args& a, const Geo& g, cudaStream_t stream) {
  using P = DqPlan<HD>;
  auto kernel = flash_dq_wgmma<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.rows_total + P::ROWS - 1) / P::ROWS);
  kernel<<<grid, P::THREADS, P::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.segq),
      static_cast<const int32_t*>(a.segk),
      static_cast<__nv_bfloat16*>(a.dq), g);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const Args& a, const Geo& g, cudaStream_t stream) {
  using P = DkvPlan<HD>;
  auto kernel = flash_dkv_wgmma<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.sk + P::ROWS - 1) / P::ROWS);
  kernel<<<grid, P::THREADS, P::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.segq),
      static_cast<const int32_t*>(a.segk),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      g);
  return cudaGetLastError();
}

// which: 1 dQ, 2 dK/dV.
template <int HD>
cudaError_t dispatch(int which, const Args& a, const Geo& g, cudaStream_t s) {
  return which == 1 ? launch_dq<HD>(a, g, s) : launch_dkv<HD>(a, g, s);
}

int run(int which, const Args& a, int batch, int sq, int sk, int n_heads,
        int n_kv, int hd, int causal, int dtype, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || dtype != 1 || (hd != 64 && hd != 128) ||
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
  if (hd == 128) return (int)dispatch<128>(which, a, g, s);
  return (int)dispatch<64>(which, a, g, s);
}

}  // namespace

// flash_attn_bwd_dq's and flash_attn_bwd_dkv's arguments (csrc/
// flash_attn.cu). dtype must be 1 (bfloat16), hd 64 or 128; segq/segk
// both null or both set. Each returns cudaGetLastError() after its launch (0 = success)
// or cudaErrorInvalidValue for what the kernels do not take; the Python
// wrapper checks first and raises on any nonzero return.
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* segq, const void* segk,
                                  void* dq, int batch, int sq, int sk,
                                  int n_heads, int n_kv, int hd, int causal,
                                  int dtype, float scale, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.segq = segq; a.segk = segk; a.dq = dq;
  return run(1, a, batch, sq, sk, n_heads, n_kv, hd, causal, dtype, scale,
             stream);
}

extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k,
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
