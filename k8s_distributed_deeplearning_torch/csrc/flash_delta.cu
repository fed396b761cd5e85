// The flash backward's row statistic delta for bf16: delta_i = sum_j
// P_ij dP_ij over the keys row i sees, with P_ij = exp(s_ij - lse_i) and
// dP = dO . V^T, the same f32 P and dP that the dQ and dK/dV kernels
// recompute, so that dS = P (dP - delta) is the softmax backward of the P
// they use. Two kernels: flash_delta_wgmma (Hopper's tensor cores through
// wgmma, head_dim 64 and 128; ops/flash_attn.py `_delta_route` "wgmma")
// and flash_delta_kernel (mma.sync with ldmatrix, every head dim; route
// "small": head_dim 16 and 32, and forced at 64/128 as the yardstick).
//
// Part of the port of k8s_distributed_deeplearning_tpu/ops/pallas_flash.py
// `_bwd` (the `delta` operand of `_bwd_dq_kernel` and `_bwd_dkv_kernel`,
// :669-676). The Pallas wrapper computes delta = rowsum(dO * O) from the
// bf16 output O; that O rounds P to bf16 for P.V and then rounds itself,
// so delta misses sum_j P dP by ~2^-9 |dO| |O|. dQ_i = sum_j dS_ij k_j
// turns that miss into a term -(miss_i) x (the attention-weighted mean of
// k), which dominates dQ wherever the values a row attends are nearly
// equal (deep encoders at initialisation: in BERT-base's last layer dQ
// read 0.67 relative L2 from f64 against the einsum path's 0.004, on the
// card). f32 keeps rowsum(dO * O): the tf32x3 forward's O is f32-accurate.
//
// Contract (both kernels; flash_small.cu's rows):
//   q, do      [B, sq, H, D]    bfloat16
//   k, v       [B, sk, kv, D]   bfloat16; q head h reads KV head h / (H/kv)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   lse        [B, H, sq]       float32, the forward's (natural units)
//   delta      [B, H, sq]       float32, written
// Causal masking bottom-right aligned, as the other flash kernels. A row
// that sees no key gets delta = 0. Rounding points: bf16 products summed
// in f32 (S and dP), P = 2^(s scale log2 e - lse log2 e) with the scale
// folded into one FFMA and ex2.approx (the dQ kernels' P), each thread's
// products P dP summed in f32 over its columns in key order, then the
// four lanes of a row summed by shuffles (lane order 0+1, 2+3, then the
// pairs): the same bits on every launch.
//
// Bound on an H100 SXM: the larger of the two products (4 x D FLOPs a
// visible pair and query head at 989 TF/s), the exponentials (one a pair,
// 16 an SM a clock, 132 SMs at 1.98 GHz) and reading Q, dO, K and V once
// (3.35 TB/s). At the main path's shapes, in ms (products / exponentials
// / bytes): Llama-3 8B's causal attention (B 2, S 2048, 32/8 heads, D
// 128) 0.0695 / 0.0321 / 0.0253, products; the MoE slice's (B 8, S 1024,
// 12/4, D 64, causal) 0.0130 / 0.0121 / 0.0103, products; BERT-base (B
// 16, S 512, 12/12, D 64) 0.0130 / 0.0120 / 0.0153, bytes; ViT-L/16 (B 32,
// S 197, 16/16, D 64) 0.0051 / 0.0048 / 0.0157, bytes. At D 64 the
// products and the exponentials cost about the same, so they must run at
// once; at D 128 the products lead.
//
// flash_delta_wgmma, what the design does about it:
// - Both products run on wgmma m64n64k16 and read K and V K-major from
//   shared memory, in the [D / 64][rows][64] 128-byte-swizzled tiles of
//   flash_bwd.cu's S and dP: each 64-key K or V tile feeds 64 rows a
//   product (mma.sync re-reads it through ldmatrix for every 16 rows). At
//   D 128 Q and dO are register A fragments, loaded once: wgmma then
//   reads 64 FLOPs a byte of shared memory, not 32 (at 32 the products
//   alone use the SM's 128 bytes a clock); at D 64 they stay in shared
//   memory, which leaves registers for two CTAs an SM.
// - One CTA per (tile of 128 flattened query rows, two consumer
//   warpgroups of 64; KV head; batch row). A flattened row is (query
//   position, head of the KV head's group), so one K/V tile serves the
//   whole group. Q and dO are loaded once a CTA. Under a causal mask the
//   row tiles launch heaviest first; without one a head's row tiles
//   launch side by side, so its K and V come from memory once
//   (`by_head_order`).
// - K/V tiles stream through a four-slot ring that one producer thread
//   (warp 8) keeps full with TMA copies (128-byte swizzled boxes; keys
//   past the end read as 0), up to the CTA's causal frontier. Each slot
//   has a full and an empty mbarrier, so the two consumer warpgroups run
//   apart: no barrier of the whole CTA a tile, no copy instructions in
//   the consumers, no proxy fence a tile.
// - The consumer warpgroups running apart (two a CTA; at D 64 two CTAs an
//   SM) overlap one's exponentials and FMAs with another's products. A
//   thread holds one buffer of S and dP: a second, to issue tile t + 1's
//   products before tile t's exponentials, needs more registers than a
//   9-warp CTA gets (168 at one CTA an SM; at D 128 it spilled and ran
//   slower). Each product is waited for in the step that issues it, and
//   the loop is straight-line (the loop bounds and the test that lets a
//   tile skip its mask are broadcast from lane 0; a pair a warpgroup
//   cannot see gives p = 0 and adds exactly 0), so ptxas keeps the
//   products asynchronous. Segment ids are read from global memory (L1),
//   only on tiles that need the mask, two a column group ahead of its
//   exponentials.
// - What holds it back (PERF.md): at D 64 moving the inputs. With the L2
//   cold, the kernel without products and exponentials takes 0.042 of
//   its 0.0515 ms at BERT-base, and the launch with Q, dO and the
//   epilogue alone 0.019. At D 128 (Llama-3 8B, causal) the products
//   take 0.061 of 0.168 ms, about their bound, and run beside little.
// `kernel_breakdown.py flash_delta` times each stage and the design
// points beside these (a persistent kernel, which streamed the next row
// tile's Q and dO by TMA during the current one, ran slower at every
// shape and was not kept).
//
// flash_delta_kernel: flash_dq_small's loop without the dS.K product. One
// CTA of four warps per 64 flattened query rows, 16 a warp; Q and dO
// fragments loaded once through ldmatrix.x4 and kept in registers; K and
// V in 64-key tiles through a two-slot cp.async ring; S and dP for 16 rows
// x 64 keys in registers; masks only on tiles that need them. At D 16/32
// the exponentials bound it and tensor cores would not help.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>     // CUtensorMap, cuTensorMapEncodeTiled's type
#include <stdint.h>

#include "flash_rows.cuh"     // Geo, the flattened rows
#include "mma_sync.cuh"
#include "wgmma.cuh"          // cp.async copies, ex2, the wgmma products

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;            // four warps a CTA
constexpr int ROWS = 64;           // flattened query rows a CTA
constexpr int KT = 64;             // keys a K/V tile
constexpr int STAGES = 2;          // ring slots of K/V tiles

// Shared memory in bytes: the Q and dO tiles, then STAGES ring stages of
// (K tile, V tile, key segment ids). Rows pitched D + 8 elements, so the
// eight 16-byte rows of each 8x8 matrix ldmatrix reads fall in distinct
// banks.
template <int HD>
struct Plan {
  static constexpr int LD = HD + 8;
  static constexpr int ROW_BYTES = ROWS * LD * 2;
  static constexpr int TILE = KT * LD * 2;
  static constexpr int STAGE = 2 * TILE + KT * 4;
  static constexpr int BYTES = 2 * ROW_BYTES + STAGES * STAGE;
};

// Grid (KV heads x B, row tiles): CTA (x, y) serves KV head x % kv of batch
// row x / kv and flattened rows [tile * 64, tile * 64 + 64) with tile =
// row tiles - 1 - y (heaviest first under a causal mask); warp w owns 16.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_delta_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const int32_t* __restrict__ segq,
                   const int32_t* __restrict__ segk,
                   float* __restrict__ delta, Geo g) {
  using P = Plan<HD>;
  constexpr int LD = P::LD;
  constexpr int CPR = HD / 8;                   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = reinterpret_cast<bf16*>(smem + P::ROW_BYTES);
  auto k_at = [&](int st) {
    return reinterpret_cast<bf16*>(smem + 2 * P::ROW_BYTES + st * P::STAGE);
  };
  auto seg_at = [&](int st) {
    return reinterpret_cast<int*>(smem + 2 * P::ROW_BYTES + st * P::STAGE +
                                  2 * P::TILE);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int kvh = blockIdx.x % g.n_kv, b = blockIdx.x / g.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * ROWS;

  for (int idx = tid; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR, fr = row0 + r;
    const bool valid = fr < g.rows_total;
    const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
    cp_async16(q_s + r * LD + ch * 8, q + off, valid);
    cp_async16(do_s + r * LD + ch * 8, dout + off, valid);
  }
  cp_async_commit();

  // Keys [0, kend) are visible to some row of the CTA.
  const int kend = last_key(g, min(row0 + ROWS, g.rows_total) - 1) + 1;
  const int n_tiles = kend > 0 ? (kend + KT - 1) / KT : 0;
  const size_t key_stride = (size_t)g.n_kv * HD;
  const size_t kv_base = ((size_t)b * g.sk * g.n_kv + kvh) * HD;
  auto fetch = [&](int t, int st) {
    bf16* ks = k_at(st);
    bf16* vs = ks + P::TILE / 2;
    for (int idx = tid; idx < KT * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR, j = t * KT + r;
      const bool valid = j < g.sk;
      const size_t off = valid ? kv_base + (size_t)j * key_stride + ch * 8
                               : 0;
      cp_async16(ks + r * LD + ch * 8, k + off, valid);
      cp_async16(vs + r * LD + ch * 8, v + off, valid);
    }
    if (g.seg) {
      int* ss = seg_at(st);
      for (int jj = tid; jj < KT; jj += NT) {
        const int j = t * KT + jj;
        const bool valid = j < g.sk;
        cp_async4(ss + jj, segk + (valid ? (size_t)b * g.sk + j : 0), valid);
      }
    }
  };
  constexpr int DIST = STAGES - 1;               // tiles in flight ahead
#pragma unroll
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) fetch(u, u);
    cp_async_commit();
  }

  // This lane's rows: wr0 + gq and wr0 + gq + 8, with their lse times
  // log2 e, last visible key and segment id. The warp's keys [0, w_kend)
  // are visible to some of its rows, [0, w_full) to all.
  const int wr0 = row0 + warp * 16;
  int lim[2], sgq[2];
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + gq + 8 * h;
    const bool valid = fr < g.rows_total;
    lim[h] = last_key(g, fr);
    sgq[h] = (valid && g.seg) ? segq[(size_t)b * g.sq + fr / g.group] : 0;
    lse2[h] = valid ? lse[stat_at(g, b, kvh, fr)] * LOG2E : 0.f;
  }
  const int w_kend =
      wr0 < g.rows_total
          ? last_key(g, min(wr0 + 16, g.rows_total) - 1) + 1 : 0;
  const int w_full =
      (g.seg || wr0 >= g.rows_total) ? 0 : last_key(g, wr0) + 1;

  cp_async_wait<DIST>();                    // Q and dO landed
  __syncthreads();
  uint32_t qa[HD / 16][4], da[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int at = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(qa[kk], q_s + at);
    ldsm_x4(da[kk], do_s + at);
  }

  const float sl = g.scale * LOG2E;
  float acc[2] = {0.f, 0.f};                // sum of P dP, the lane's rows

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DIST - 1>();              // tile t landed ...
    __syncthreads();                        // ... for all; tile t - 1 done
    if (t + DIST < n_tiles) fetch(t + DIST, (t + DIST) % STAGES);
    cp_async_commit();
    const int c0 = t * KT;
    if (c0 >= w_kend) continue;             // warp-uniform: nothing visible
    const int slot = t % STAGES;
    const bf16* ks = k_at(slot);
    const bf16* vs = ks + P::TILE / 2;

    // S = Q . K^T and dP = dO . V^T, 16 rows x KT keys.
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int np = 0; np < KT / 16; ++np)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, ks + at);
        mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        ldsm_x4(vb, vs + at);
        mma_bf16(dp[2 * np], da[kk], vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da[kk], vb[2], vb[3]);
      }
    if (c0 + KT > w_full) {                 // the tile needs the mask
      const int* ss = seg_at(slot);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * n + 2 * tq + (e & 1);
          const bool ok = c0 + col < g.sk && c0 + col <= lim[h] &&
                          (!g.seg || ss[col] == sgq[h]);
          if (!ok) s[n][e] = neg_inf();
        }
    }
    // P = 2^(s sl - lse log2 e), 0 where masked; the lane's P dP in key
    // order (columns 8n + 2tq, 8n + 2tq + 1 of its two rows).
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        acc[h] = fmaf(ex2(fmaf(s[n][e], sl, -lse2[h])), dp[n][e], acc[h]);
      }
  }
  cp_async_wait<0>();

  // The four lanes of a row: (0 + 1) + (2 + 3), in that order on every lane.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], 1);
    acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], 2);
    const int fr = wr0 + gq + 8 * h;
    if (tq == 0 && fr < g.rows_total)
      delta[stat_at(g, b, kvh, fr)] = lim[h] >= 0 ? acc[h] : 0.f;
  }
}

// ---- flash_delta_wgmma

constexpr int W_ROWS = 128;        // flattened query rows a CTA, 64 a
constexpr int W_CONSUMERS = 256;   // consumer warpgroup
constexpr int W_THREADS = W_CONSUMERS + 32;   // and one producer warp
constexpr int W_STAGES = 4;        // ring slots of K/V tiles
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in bytes from a 1024-byte aligned base: W_ROWS rows of Q
// and of dO, the ring of K and V tiles, then each slot's two barriers
// (full: its tile landed; empty: every consumer is done with it). Every
// tile that wgmma reads starts 1024-byte aligned, as the 128-byte swizzle
// needs.
template <int HD>
struct WgmmaPlan {
  static constexpr int TILE = KT * HD * 2;        // a bf16 K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = W_ROWS * HD * 2;
  static constexpr int RING_OFF = 2 * W_ROWS * HD * 2;
  static constexpr int STAGE = 2 * TILE;          // K, then V
  static constexpr int BAR_OFF = RING_OFF + W_STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * W_STAGES * 8 + 1024;
  // Shared memory allows one CTA an SM at head_dim 128, two at 64.
  static constexpr int CTAS_PER_SM = HD == 128 ? 1 : 2;
  // Q and dO as register A fragments (wgmma reads only K and V from
  // shared memory); at two CTAs an SM the registers do not fit.
  static constexpr bool A_IN_REGS = CTAS_PER_SM == 1;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 2^26 polls traps (a launch error that the wrapper raises)
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}
// Box {64 columns, 1 head, KT keys, 1 batch row} of a [B, sk, kv, D]
// tensor at (column c, KV head h, key j, batch row b) into shared memory
// at dst, 128-byte swizzled; keys past the end read as 0. Completes its
// bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const void* map,
                                         int c, int h, int j, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h),
        "r"(j), "r"(b), "r"(bar)
      : "memory");
}

// The launch order of the CTAs. Without a causal mask every row tile does
// the same work, and a head's row tiles run side by side, so its K and V
// come from memory once (grid (row tiles, KV heads x B)). With one the
// row tiles run heaviest first across the heads (grid (KV heads x B, row
// tiles), as the dQ kernel's), which balances the SMs' work. Each order
// ran faster in its own case (`kernel_breakdown.py flash_delta`'s
// `tiles_first` and `heads_first`; PERF.md).
__host__ __device__ __forceinline__ bool by_head_order(const Geo& g) {
  return !g.causal && g.n_kv * g.batch <= 65535;
}

// CTA (head, tile) serves KV head `head` % kv of batch row `head` / kv and
// flattened rows [tile * 128, tile * 128 + 128); consumer warpgroup w owns
// 64 of them, warp 8 streams K and V.
template <int HD>
__global__ void __launch_bounds__(W_THREADS, WgmmaPlan<HD>::CTAS_PER_SM)
flash_delta_wgmma(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const bf16* __restrict__ q, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const int32_t* __restrict__ segq,
                  const int32_t* __restrict__ segk,
                  float* __restrict__ delta, Geo g) {
  using P = WgmmaPlan<HD>;
  constexpr int CPR = HD / 8;                   // 16-byte chunks a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full_bar = sbase + P::BAR_OFF;   // slot st: + 8 st
  const uint32_t empty_bar = full_bar + 8 * W_STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool by_head = by_head_order(g);
  const int head = by_head ? blockIdx.y : blockIdx.x;
  const int kvh = head % g.n_kv, b = head / g.n_kv;
  const int row0 =
      (by_head ? blockIdx.x : gridDim.y - 1 - blockIdx.y) * W_ROWS;
  // Keys [0, kend) are visible to some row of the CTA. Broadcast from lane
  // 0, the loop bounds are warp-uniform to the compiler.
  const int kend = last_key(g, min(row0 + W_ROWS, g.rows_total) - 1) + 1;
  const int n_tiles =
      __shfl_sync(FULL, kend > 0 ? (kend + KT - 1) / KT : 0, 0);

  if (tid == 0) {
    for (int st = 0; st < W_STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, W_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= W_CONSUMERS) {
    // The producer: one thread keeps the ring full, a slot at a time as the
    // consumers free it (a fresh barrier passes a wait on parity 1).
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&k_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&v_map)) : "memory");
#pragma unroll 1
      for (int u = 0; u < n_tiles; ++u) {
        const int st = u % W_STAGES;
        mbar_wait(empty_bar + 8 * st, ((u / W_STAGES) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * st;
        mbar_expect(bar, P::STAGE);
        const uint32_t kdst = sbase + P::RING_OFF + st * P::STAGE;
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load(kdst + c * KT * 128, &k_map, 64 * c, kvh, u * KT, b, bar);
          tma_load(kdst + P::TILE + c * KT * 128, &v_map, 64 * c, kvh,
                   u * KT, b, bar);
        }
      }
    }
    return;
  }

  // The consumers. Q and dO, zero rows past the end, through cp.async;
  // made visible to wgmma (the async proxy) and to both warpgroups.
  for (int idx = tid; idx < W_ROWS * CPR; idx += W_CONSUMERS) {
    const int r = idx / CPR, ch = idx % CPR, fr = row0 + r;
    const bool valid = fr < g.rows_total;
    const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
    const uint32_t d = swz(W_ROWS, r, ch);
    cp_async16(smem + P::Q_OFF + d, q + off, valid);
    cp_async16(smem + P::DO_OFF + d, dout + off, valid);
  }
  cp_async_commit();

  // Keys [0, c_full) are visible to every row of this warpgroup (none
  // with segment ids); broadcast from lane 0, the test that lets a tile
  // skip its mask is warp-uniform.
  const int wg = tid >> 7;
  const int wr0 = row0 + wg * 64;
  int c_full = g.sk;
  if (g.seg || wr0 >= g.rows_total)
    c_full = 0;
  else if (g.causal)
    c_full = max(0, last_key(g, wr0) + 1);
  c_full = __shfl_sync(FULL, c_full, 0);

  // This thread's rows of its warpgroup's 64-row tile (the wgmma
  // accumulator layout): r0 and r0 + 8; in each 8-column group, columns
  // cq and cq + 1. Element i of an accumulator is in row r0 when bit 1 of
  // i is clear, r0 + 8 otherwise; its column is 8 * (i / 4) + cq + (i & 1).
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float lse2[2];
  int lim[2], sgq[2];           // last visible key; segment id
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + r0 + 8 * h;
    const bool valid = fr < g.rows_total;
    lim[h] = last_key(g, fr);
    sgq[h] = (valid && g.seg) ? segq[(size_t)b * g.sq + fr / g.group] : 0;
    lse2[h] = valid ? lse[stat_at(g, b, kvh, fr)] * LOG2E : 0.f;
  }
  const int32_t* segk_b = segk + (g.seg ? (size_t)b * g.sk : 0);

  cp_async_wait<0>();
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" ::"n"(W_CONSUMERS) : "memory");

  const uint32_t q_addr = sbase + P::Q_OFF + wg * 64 * 128;
  const uint32_t do_addr = sbase + P::DO_OFF + wg * 64 * 128;
  // The A fragments of this warp's 16 rows (mma_sync.cuh's layout, which
  // is wgmma's): k-step kk reads 16-byte chunks 2 kk and 2 kk + 1.
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  if constexpr (P::A_IN_REGS) {
    const int r = wg * 64 + ((tid & 127) >> 5) * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t at = swz(W_ROWS, r, 2 * kk + (lane >> 4));
      ldsm_x4(qa[kk], smem + P::Q_OFF + at);
      ldsm_x4(da[kk], smem + P::DO_OFF + at);
    }
  }
  const float sl = g.scale * LOG2E;   // scores go to the log2 domain
  float acc[2] = {0.f, 0.f};          // sum of P dP, the thread's rows
  float s0[32], d0[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = d0[i] = 0.f;

  // Wait for tile t, then S = Q . K^T and dP = dO . V^T, one commit group.
  auto products = [&](int t, float (&s)[32], float (&dp)[32]) {
    const int st = t % W_STAGES;
    mbar_wait(full_bar + 8 * st, (t / W_STAGES) & 1);
    const uint32_t k_addr = sbase + P::RING_OFF + st * P::STAGE;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (P::A_IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_n64<0>(s, qa[kk],
                        desc(k_addr + (kk >> 2) * (KT * 128) + (kk & 3) * 32,
                             16, 1024), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_n64<0>(dp, da[kk],
                        desc(k_addr + P::TILE + (kk >> 2) * (KT * 128) +
                                 (kk & 3) * 32, 16, 1024), kk);
    } else {
      wgmma_ss_rows<HD>(s, q_addr, W_ROWS, k_addr);
      wgmma_ss_rows<HD>(dp, do_addr, W_ROWS, k_addr + P::TILE);
    }
    wgmma_commit();
  };
  auto land = [&](float (&s)[32], float (&dp)[32]) {
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
  };
  // Tile t's P = 2^(s sl - lse log2 e), 0 where masked, and the thread's
  // sums of P dP, element by element in key order; then the thread is
  // done with tile t's slot (its products landed before).
  auto accumulate = [&](int t, float (&s)[32], float (&dp)[32]) {
    const int c0 = t * KT;
    const bool full = c0 + KT <= c_full;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      // Columns j and j + 1 of 8-column group n, with their segment ids
      // where the tile needs the mask (loaded before the group's
      // exponentials, not behind each element's key test).
      const int j = c0 + 8 * n + cq;
      int sg[2] = {0, 0};
      if (!full && g.seg) {
        sg[0] = j < g.sk ? segk_b[j] : 0;
        sg[1] = j + 1 < g.sk ? segk_b[j + 1] : 0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e, h = e >> 1;
        float p = ex2(fmaf(s[i], sl, -lse2[h]));
        if (!full) {
          const bool ok = j + (e & 1) <= lim[h] &&
                          (!g.seg || sg[e & 1] == sgq[h]);
          p = ok ? p : 0.f;
        }
        acc[h] = fmaf(p, dp[i], acc[h]);
      }
    }
    mbar_arrive(empty_bar + 8 * (t % W_STAGES));
  };
  // One buffer of S and dP: the SM's other consumer warpgroups run their
  // exponentials while this one's products hold the tensor cores.
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    products(t, s0, d0);
    land(s0, d0);
    accumulate(t, s0, d0);
  }

  // The four lanes of a row: (0 + 1) + (2 + 3), in that order on every lane.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc[h] += __shfl_xor_sync(FULL, acc[h], 1);
    acc[h] += __shfl_xor_sync(FULL, acc[h], 2);
    const int fr = row0 + r0 + 8 * h;
    if ((lane & 3) == 0 && fr < g.rows_total)
      delta[stat_at(g, b, kvh, fr)] = lim[h] >= 0 ? acc[h] : 0.f;
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *segq, *segk;
  void* delta;
};

template <int HD>
cudaError_t launch_small(const Args& a, const Geo& g, cudaStream_t stream) {
  using P = Plan<HD>;
  auto kernel = flash_delta_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.rows_total + ROWS - 1) / ROWS);
  kernel<<<grid, NT, P::BYTES, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const int32_t*>(a.segq),
      static_cast<const int32_t*>(a.segk), static_cast<float*>(a.delta), g);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library does not link libcuda); null if the driver lacks it.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const auto fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The TMA map of a [B, sk, kv, hd] bf16 tensor in boxes of {64 columns, 1
// head, KT keys, 1 batch row}, 128-byte swizzled, keys past the end read
// as 0. False if it cannot be made.
bool kv_map(CUtensorMap* map, const void* base, const Geo& g, int hd) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)g.n_kv,
                              (cuuint64_t)g.sk, (cuuint64_t)g.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)g.n_kv * hd * 2,
                                 (cuuint64_t)g.sk * g.n_kv * hd * 2};
  const cuuint32_t box[4] = {64, 1, KT, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const Args& a, const Geo& g, cudaStream_t stream) {
  using P = WgmmaPlan<HD>;
  CUtensorMap k_map, v_map;
  if (!kv_map(&k_map, a.k, g, HD) || !kv_map(&v_map, a.v, g, HD))
    return cudaErrorInvalidValue;
  auto kernel = flash_delta_wgmma<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const int heads = g.n_kv * g.batch;
  const int tiles = (g.rows_total + W_ROWS - 1) / W_ROWS;
  const dim3 grid = by_head_order(g) ? dim3(tiles, heads)
                                     : dim3(heads, tiles);
  kernel<<<grid, W_THREADS, P::BYTES, stream>>>(
      k_map, v_map, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const int32_t*>(a.segq),
      static_cast<const int32_t*>(a.segk), static_cast<float*>(a.delta), g);
  return cudaGetLastError();
}

// wgmma: flash_delta_wgmma (hd 64, 128); else flash_delta_kernel (hd 16,
// 32, 64, 128).
int run(bool wgmma, const Args& a, int batch, int sq, int sk, int n_heads,
        int n_kv, int hd, int causal, int dtype, float scale, void* stream) {
  const bool hd_ok = wgmma ? (hd == 64 || hd == 128)
                           : (hd == 16 || hd == 32 || hd == 64 || hd == 128);
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || dtype != 1 || !hd_ok ||
      (a.segq == nullptr) != (a.segk == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         a.segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma)
    return (int)(hd == 128 ? launch_wgmma<128>(a, g, s)
                           : launch_wgmma<64>(a, g, s));
  switch (hd) {
    case 16: return (int)launch_small<16>(a, g, s);
    case 32: return (int)launch_small<32>(a, g, s);
    case 64: return (int)launch_small<64>(a, g, s);
    default: return (int)launch_small<128>(a, g, s);
  }
}

}  // namespace

// delta for the bf16 flash backward. dtype must be 1 (bfloat16);
// segq/segk both null or both set. flash_bwd_delta launches
// flash_delta_kernel (hd 16, 32, 64 or 128), flash_bwd_delta_wgmma
// flash_delta_wgmma (hd 64 or 128). Each returns cudaGetLastError() after
// the launch (0 = success) or cudaErrorInvalidValue for what its kernel
// does not take; the Python wrapper checks first and raises on any
// nonzero return.
extern "C" int flash_bwd_delta(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* segq, const void* segk,
                               void* delta, int batch, int sq, int sk,
                               int n_heads, int n_kv, int hd, int causal,
                               int dtype, float scale, void* stream) {
  const Args a = {q, k, v, dout, lse, segq, segk, delta};
  return run(false, a, batch, sq, sk, n_heads, n_kv, hd, causal, dtype,
             scale, stream);
}

extern "C" int flash_bwd_delta_wgmma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* segq,
                                     const void* segk, void* delta,
                                     int batch, int sq, int sk, int n_heads,
                                     int n_kv, int hd, int causal, int dtype,
                                     float scale, void* stream) {
  const Args a = {q, k, v, dout, lse, segq, segk, delta};
  return run(true, a, batch, sq, sk, n_heads, n_kv, hd, causal, dtype,
             scale, stream);
}
