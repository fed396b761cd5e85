// The flash backward's row statistic delta for bf16, at head_dim 16, 32, 64
// and 128: delta_i = sum_j P_ij dP_ij over the keys row i sees, with
// P_ij = exp(s_ij - lse_i) and dP = dO . V^T, the same f32 P and dP that
// the dQ and dK/dV kernels recompute, so that dS = P (dP - delta) is the
// softmax backward of the P they use.
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
// Contract (csrc/flash_small.cu's, any of the four head dims):
//   q, do      [B, sq, H, D]    bfloat16
//   k, v       [B, sk, kv, D]   bfloat16; q head h reads KV head h / (H/kv)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   lse        [B, H, sq]       float32, the forward's (natural units)
//   delta      [B, H, sq]       float32, written
// Causal masking bottom-right aligned, as the other flash kernels. A row
// that sees no key gets delta = 0. Rounding points: bf16 products summed
// in f32 (S and dP, mma.sync), P = 2^(s scale log2 e - lse log2 e) with
// the scale folded into one FFMA and ex2.approx (the dQ kernels' P), each
// lane's products P dP summed in f32 over its columns in key order, then
// the four lanes of a row summed by shuffles (lane order 0+1, 2+3, then
// the pairs): the same bits on every launch.
//
// Design: flash_dq_small's without the dS.K product. One CTA of four warps
// per 64 flattened (position, group head) query rows, 16 a warp; Q and dO
// fragments loaded once through ldmatrix.x4 and kept in registers; K and
// V in 64-key tiles through a two-slot cp.async ring; S and dP for 16 rows
// x 64 keys in registers; masks only on tiles that need them. Bound: the
// two products (4 x D FLOPs a visible pair and query head at 989 TF/s) or
// the exponentials (one a pair, 16 an SM a clock), whichever is larger,
// or reading Q, dO, K and V once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_rows.cuh"     // Geo, the flattened rows
#include "mma_sync.cuh"
#include "wgmma.cuh"          // cp.async copies, ex2

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

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* segq,
                   const void* segk, void* delta, const Geo& g,
                   cudaStream_t stream) {
  using P = Plan<HD>;
  auto kernel = flash_delta_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.rows_total + ROWS - 1) / ROWS);
  kernel<<<grid, NT, P::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const int32_t*>(segq),
      static_cast<const int32_t*>(segk), static_cast<float*>(delta), g);
  return cudaGetLastError();
}

}  // namespace

// delta for the bf16 flash backward. dtype must be 1 (bfloat16), hd 16,
// 32, 64 or 128; segq/segk both null or both set. Returns
// cudaGetLastError() after the launch (0 = success) or
// cudaErrorInvalidValue for what the kernel does not take; the Python
// wrapper checks first and raises on any nonzero return.
extern "C" int flash_bwd_delta(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* segq, const void* segk,
                               void* delta, int batch, int sq, int sk,
                               int n_heads, int n_kv, int hd, int causal,
                               int dtype, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || dtype != 1 ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128) ||
      (segq == nullptr) != (segk == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16>(q, k, v, dout, lse, segq, segk, delta, g, s);
    case 32:
      return (int)launch<32>(q, k, v, dout, lse, segq, segk, delta, g, s);
    case 64:
      return (int)launch<64>(q, k, v, dout, lse, segq, segk, delta, g, s);
    default:
      return (int)launch<128>(q, k, v, dout, lse, segq, segk, delta, g, s);
  }
}
