// Flash attention for Hopper in bf16 at head_dim 16 and 32: the forward,
// the dQ and the dK/dV kernel, built around mma.sync's register layout.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_flash.py
//   `_fwd_kernel`     (:148, launched by `_fwd` at :364) -> flash_fwd_small
//   `_bwd_dq_kernel`  (:396, launched by `_bwd` at :690) -> flash_dq_small
//   `_bwd_dkv_kernel` (:520, launched by `_bwd` at :723) -> flash_dkv_small
// for bf16 at head_dim 16 and 32: ops/flash_attn.py routes those calls
// "small". The kernels of csrc/flash_attn.cu stay reachable as the forced
// "mma" route.
//
// Contract (flash_attn.cu's, narrowed to what these kernels take):
//   q, do      [B, sq, H, D]    bfloat16, D 16 or 32
//   k, v       [B, sk, kv, D]   bfloat16; q head h reads KV head h / (H/kv)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   o, dq      [B, sq, H, D]    bfloat16
//   lse, delta [B, H, sq]       float32 (delta = rowsum(dO * O))
//   dk, dv     [B, sk, kv, D]   bfloat16, the query-head group summed
// Causal masking is bottom-right aligned: row i sees key j iff
// i + (sk - sq) >= j. Rounding points, the Pallas kernels': products of
// bf16 values summed in f32; the forward rounds p to bf16 at the running
// max for P.V and sums l over the f32 p; dQ and dK/dV round dS = P (dP -
// delta) scale to bf16 before dS.K and dS^T.Q, dK/dV also P before
// P^T.dO; each output is rounded once. A row that sees no key gives O = 0,
// lse = -1e30 (the sum floored at 1e-30) and dQ = 0 exactly, and its dK/dV
// terms are exactly 0. The softmax runs in the log2 domain: p = 2^(s *
// scale * log2 e - m) with the scale folded into one FFMA and ex2.approx;
// lse goes back to natural units (m ln 2 + log(max(l, 1e-30))); dQ and
// dK/dV read lse times log2 e.
//
// Bound on an H100 SXM: at head_dim 16 and 32 the exponentials, not the
// products: one ex2 per visible (query, key) pair and query head in each
// kernel, at 16 an SM a clock (132 SMs, 1.98 GHz), against 4 (forward), 6
// (dQ) or 8 (dK/dV) x D FLOPs per pair at 989 TFLOP/s.
// What the design does about it:
// - Fragments come from shared memory through ldmatrix.x4 (Q and K as A
//   and B of S = Q.K^T, dO and V of dP = dO.V^T; V, K, Q and dO
//   transposed as B of P.V, dS.K, dS^T.Q and P^T.dO), in tiles with a
//   row pitch of D + 8 elements, so that the eight 16-byte rows of each
//   8x8 matrix fall in distinct banks.
// - P and dS never leave registers: the S (or S^T, dP^T) accumulator,
//   masked, exponentiated and packed to bf16 pairs, is the A fragment of
//   the next product (csrc/mma_sync.cuh has the layouts).
// - Global loads go through cp.async 16-byte copies into a ring of
//   FWD_STAGES / DKV_STAGES slots, that many less one tiles ahead, with one
//   barrier a tile.
// - Masks only where needed: a tile that every row of a warp sees whole
//   (no segment ids, inside the causal frontier and the sequence) skips
//   them. Masked scores are -inf, so the max ignores them and the FFMA and
//   ex2 give p = 0 with no further test.
// - Forward: one CTA of four warps per 64 flattened (position, group head)
//   query rows, 16 a warp, walking 128-key tiles up to its causal frontier;
//   grid (KV heads x B, row tiles), heaviest row tiles first.
// - dQ: the forward's CTAs and grid, walking DQ_KT-key tiles (half the
//   forward's: S and dP both live in registers) through the same ring; Q
//   and dO fragments are loaded once and stay in registers, lse and delta
//   of a lane's two rows too; the f32 dQ accumulates in registers over the
//   key tiles, in order, and is rounded once. No atomics: the same bits on
//   every launch.
// - dK/dV: one CTA of four warps per 64 keys, 16 a warp, walking 64-row
//   steps of flattened query rows from the first one that sees its keys.
//   The steps of a key tile are split over a thread-block cluster of up to
//   MAX_SPLITS CTAs (the host's choice); their f32 partial dK and dV meet
//   in distributed shared memory and are summed in rank order before the
//   one bf16 cast: no atomics, the same bits on every launch. Grid
//   (splits, KV heads x B, key tiles), heaviest key tiles first.
// `kernel_breakdown.py flash_small` times each stage; PERF.md keeps the
// times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "flash_rows.cuh"     // Geo, the flattened rows
#include "mma_sync.cuh"
#include "wgmma.cuh"          // cp.async copies, ex2, pack_bf16

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;            // four warps a CTA
constexpr int FWD_ROWS = 64;       // flattened query rows a forward CTA
constexpr int KT = 128;            // keys a forward K/V tile
constexpr int DQ_KT = 64;          // keys a dQ K/V tile
constexpr int DKV_KEYS = 64;       // keys a dK/dV CTA
constexpr int RT = 64;             // flattened query rows a dK/dV step
constexpr int MAX_SPLITS = 8;      // CTAs a dK/dV cluster
constexpr int FWD_STAGES = 2;      // ring slots of K/V tiles
constexpr int DKV_STAGES = 2;      // ring slots of row steps
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of the forward, in bytes: the Q tile, then FWD_STAGES ring
// stages of (K tile, V tile, key segment ids).
template <int HD>
struct FwdPlan {
  static constexpr int LD = HD + 8;             // row pitch, elements
  static constexpr int Q_BYTES = FWD_ROWS * LD * 2;
  static constexpr int TILE = KT * LD * 2;
  static constexpr int STAGE = 2 * TILE + KT * 4;
  static constexpr int BYTES = Q_BYTES + FWD_STAGES * STAGE;
};

// Grid (KV heads x B, row tiles). CTA (x, y) serves KV head x % kv of
// batch row x / kv and flattened rows [tile * 64, tile * 64 + 64) with
// tile = row tiles - 1 - y; warp w owns 16 of them.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_small(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int32_t* __restrict__ segq,
                const int32_t* __restrict__ segk, bf16* __restrict__ o,
                float* __restrict__ lse, Geo g) {
  using P = FwdPlan<HD>;
  constexpr int LD = P::LD;
  constexpr int CPR = HD / 8;                   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  auto k_at = [&](int st) {
    return reinterpret_cast<bf16*>(smem + P::Q_BYTES + st * P::STAGE);
  };
  auto seg_at = [&](int st) {
    return reinterpret_cast<int*>(smem + P::Q_BYTES + st * P::STAGE +
                                  2 * P::TILE);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int kvh = blockIdx.x % g.n_kv, b = blockIdx.x / g.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * FWD_ROWS;

  for (int idx = tid; idx < FWD_ROWS * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR, fr = row0 + r;
    const bool valid = fr < g.rows_total;
    cp_async16(q_s + r * LD + ch * 8,
               q + (valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0), valid);
  }
  cp_async_commit();

  // Keys [0, kend) are visible to some row of the CTA.
  const int kend = last_key(g, min(row0 + FWD_ROWS, g.rows_total) - 1) + 1;
  const int n_tiles = (kend + KT - 1) / KT;
  const size_t key_stride = (size_t)g.n_kv * HD;
  const size_t kv_base = ((size_t)b * g.sk * g.n_kv + kvh) * HD;
  auto issue = [&](int t, int st) {
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
  constexpr int DIST = FWD_STAGES - 1;           // tiles in flight ahead
#pragma unroll
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) issue(u, u);
    cp_async_commit();
  }

  // This lane's rows: wr0 + gq and wr0 + gq + 8. The warp's keys
  // [0, w_kend) are visible to some of its rows, [0, w_full) to all.
  const int wr0 = row0 + warp * 16;
  int lim[2], sgq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + gq + 8 * h;
    lim[h] = last_key(g, fr);
    sgq[h] = (lim[h] >= 0 && g.seg)
                 ? segq[(size_t)b * g.sq + fr / g.group] : 0;
  }
  const int w_kend =
      wr0 < g.rows_total
          ? last_key(g, min(wr0 + 16, g.rows_total) - 1) + 1 : 0;
  const int w_full =
      (g.seg || wr0 >= g.rows_total) ? 0 : last_key(g, wr0) + 1;

  cp_async_wait<DIST>();                    // Q landed
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);

  const float sl = g.scale * LOG2E;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DIST - 1>();              // tile t landed ...
    __syncthreads();                        // ... for all; tile t - 1 done
    if (t + DIST < n_tiles) issue(t + DIST, (t + DIST) % FWD_STAGES);
    cp_async_commit();
    const int c0 = t * KT;
    if (c0 >= w_kend) continue;             // warp-uniform: nothing visible
    const int slot = t % FWD_STAGES;
    const bf16* ks = k_at(slot);
    const bf16* vs = ks + P::TILE / 2;

    // S = Q . K^T, 16 rows x 128 keys.
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < KT / 16; ++np)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    if (c0 + KT > w_full) {                 // the tile needs the mask
      const int* ss = seg_at(slot);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * n + 2 * tq + (e & 1);
          const bool ok = c0 + col <= lim[h] &&
                          (!g.seg || ss[col] == sgq[h]);
          if (!ok) s[n][e] = neg_inf();
        }
    }
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * sl), mn1 = fmaxf(m1, mx1 * sl);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p = 2^(s sl - m), packed to bf16 pairs as the A fragments of P.V.
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float p0 = ex2(fmaf(s[n][0], sl, -mn0));
      const float p1 = ex2(fmaf(s[n][1], sl, -mn0));
      const float p2 = ex2(fmaf(s[n][2], sl, -mn1));
      const float p3 = ex2(fmaf(s[n][3], sl, -mn1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = a0 * l0 + sum0;      // per-lane partial sums; the quad's at the end
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    // O += P . V, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LD + np * 16 +
                              (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], vb[2], vb[3]);
      }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + gq + 8 * h;
    if (fr >= g.rows_total) continue;
    const float n = fmaxf(h ? l1 : l0, 1e-30f);
    const float inv = 1.f / n;
    const float m = h ? m1 : m0;
    bf16* op = o + q_row(g, b, kvh, fr) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    if (tq == 0)
      lse[stat_at(g, b, kvh, fr)] =
          (m <= NEG_INF * 0.5f ? NEG_INF : m * LN2) + logf(n);
  }
}

// Shared memory of dQ, in bytes: the Q and dO tiles, then FWD_STAGES ring
// stages of (K tile, V tile, key segment ids).
template <int HD>
struct DqPlan {
  static constexpr int LD = HD + 8;             // row pitch, elements
  static constexpr int ROWS = FWD_ROWS * LD * 2;
  static constexpr int TILE = DQ_KT * LD * 2;
  static constexpr int STAGE = 2 * TILE + DQ_KT * 4;
  static constexpr int BYTES = 2 * ROWS + FWD_STAGES * STAGE;
};

// Grid (KV heads x B, row tiles), as the forward's: CTA (x, y) serves KV
// head x % kv of batch row x / kv and flattened rows [tile * 64, tile * 64
// + 64) with tile = row tiles - 1 - y; warp w owns 16 of them.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_dq_small(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const int32_t* __restrict__ segq,
               const int32_t* __restrict__ segk, bf16* __restrict__ dq,
               Geo g) {
  using P = DqPlan<HD>;
  constexpr int LD = P::LD;
  constexpr int CPR = HD / 8;                   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = reinterpret_cast<bf16*>(smem + P::ROWS);
  auto k_at = [&](int st) {
    return reinterpret_cast<bf16*>(smem + 2 * P::ROWS + st * P::STAGE);
  };
  auto seg_at = [&](int st) {
    return reinterpret_cast<int*>(smem + 2 * P::ROWS + st * P::STAGE +
                                  2 * P::TILE);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int kvh = blockIdx.x % g.n_kv, b = blockIdx.x / g.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * FWD_ROWS;

  for (int idx = tid; idx < FWD_ROWS * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR, fr = row0 + r;
    const bool valid = fr < g.rows_total;
    const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
    cp_async16(q_s + r * LD + ch * 8, q + off, valid);
    cp_async16(do_s + r * LD + ch * 8, dout + off, valid);
  }
  cp_async_commit();

  // Keys [0, kend) are visible to some row of the CTA.
  const int kend = last_key(g, min(row0 + FWD_ROWS, g.rows_total) - 1) + 1;
  const int n_tiles = kend > 0 ? (kend + DQ_KT - 1) / DQ_KT : 0;
  const size_t key_stride = (size_t)g.n_kv * HD;
  const size_t kv_base = ((size_t)b * g.sk * g.n_kv + kvh) * HD;
  auto fetch = [&](int t, int st) {
    bf16* ks = k_at(st);
    bf16* vs = ks + P::TILE / 2;
    for (int idx = tid; idx < DQ_KT * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR, j = t * DQ_KT + r;
      const bool valid = j < g.sk;
      const size_t off = valid ? kv_base + (size_t)j * key_stride + ch * 8
                               : 0;
      cp_async16(ks + r * LD + ch * 8, k + off, valid);
      cp_async16(vs + r * LD + ch * 8, v + off, valid);
    }
    if (g.seg) {
      int* ss = seg_at(st);
      for (int jj = tid; jj < DQ_KT; jj += NT) {
        const int j = t * DQ_KT + jj;
        const bool valid = j < g.sk;
        cp_async4(ss + jj, segk + (valid ? (size_t)b * g.sk + j : 0), valid);
      }
    }
  };
  constexpr int DIST = FWD_STAGES - 1;           // tiles in flight ahead
#pragma unroll
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) fetch(u, u);
    cp_async_commit();
  }

  // This lane's rows: wr0 + gq and wr0 + gq + 8, with their lse times
  // log2 e, delta, last visible key and segment id. The warp's keys
  // [0, w_kend) are visible to some of its rows, [0, w_full) to all.
  const int wr0 = row0 + warp * 16;
  int lim[2], sgq[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + gq + 8 * h;
    const bool valid = fr < g.rows_total;
    const size_t at = valid ? stat_at(g, b, kvh, fr) : 0;
    lim[h] = last_key(g, fr);
    sgq[h] = (valid && g.seg) ? segq[(size_t)b * g.sq + fr / g.group] : 0;
    lse2[h] = valid ? lse[at] * LOG2E : 0.f;
    dlt[h] = valid ? delta[at] : 0.f;
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
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DIST - 1>();              // tile t landed ...
    __syncthreads();                        // ... for all; tile t - 1 done
    if (t + DIST < n_tiles) fetch(t + DIST, (t + DIST) % FWD_STAGES);
    cp_async_commit();
    const int c0 = t * DQ_KT;
    if (c0 >= w_kend) continue;             // warp-uniform: nothing visible
    const int slot = t % FWD_STAGES;
    const bf16* ks = k_at(slot);
    const bf16* vs = ks + P::TILE / 2;

    // S = Q . K^T and dP = dO . V^T, 16 rows x DQ_KT keys.
    float s[DQ_KT / 8][4], dp[DQ_KT / 8][4];
#pragma unroll
    for (int n = 0; n < DQ_KT / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int np = 0; np < DQ_KT / 16; ++np)
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
    if (c0 + DQ_KT > w_full) {              // the tile needs the mask
      const int* ss = seg_at(slot);
#pragma unroll
      for (int n = 0; n < DQ_KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * n + 2 * tq + (e & 1);
          const bool ok = c0 + col <= lim[h] &&
                          (!g.seg || ss[col] == sgq[h]);
          if (!ok) s[n][e] = neg_inf();
        }
    }
    // P = 2^(s sl - lse log2 e), 0 where masked; dS = P (dP - delta)
    // scale, packed to bf16 pairs as the A fragments of dS . K.
    uint32_t dsa[DQ_KT / 16][4];
#pragma unroll
    for (int n = 0; n < DQ_KT / 8; ++n) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = ex2(fmaf(s[n][e], sl, -lse2[h]));
        d[e] = p * (dp[n][e] - dlt[h]) * g.scale;
      }
      dsa[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
    // dQ += dS . K, 16 keys a step: K read transposed as the B operand.
#pragma unroll
    for (int kk = 0; kk < DQ_KT / 16; ++kk)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t kt[4];
        ldsm_x4_trans(kt, ks + (kk * 16 + (lane & 15)) * LD + np * 16 +
                              (lane >> 4) * 8);
        mma_bf16(acc[2 * np], dsa[kk], kt[0], kt[1]);
        mma_bf16(acc[2 * np + 1], dsa[kk], kt[2], kt[3]);
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + gq + 8 * h;
    if (fr >= g.rows_total) continue;
    bf16* out = dq + q_row(g, b, kvh, fr) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Shared memory of dK/dV, in bytes: the K and V tiles, the key segment
// ids, then DKV_STAGES ring stages of (Q rows, dO rows, lse, delta, last
// visible key, query segment id). After the row loop the f32 partial dK
// and dV ([2][64][D]) take the ring's place.
template <int HD>
struct DkvPlan {
  static constexpr int LD = HD + 8;
  static constexpr int KV_TILE = DKV_KEYS * LD * 2;
  static constexpr int SEGK_OFF = 2 * KV_TILE;
  static constexpr int RING_OFF = SEGK_OFF + DKV_KEYS * 4;
  static constexpr int ROWS = RT * LD * 2;      // a Q or dO step tile
  static constexpr int STATS_OFF = 2 * ROWS;    // within a stage
  static constexpr int STAGE = 2 * ROWS + 4 * RT * 4;
  static constexpr int PART = 2 * DKV_KEYS * HD * 4;
  static constexpr int RING = DKV_STAGES * STAGE;
  static constexpr int BYTES = RING_OFF + (RING > PART ? RING : PART);
};

// Grid (splits, KV heads x B, key tiles), clusters of `splits` CTAs along
// x. CTA (r, y, z) serves keys [64 z, 64 z + 64) of KV head y % kv of batch
// row y / kv, and share r of the 64-row steps that see them; warp w owns
// 16 of the keys.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_dkv_small(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ segq,
                const int32_t* __restrict__ segk, bf16* __restrict__ dk,
                bf16* __restrict__ dv, Geo g) {
  using P = DkvPlan<HD>;
  constexpr int LD = P::LD;
  constexpr int CPR = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + P::KV_TILE);
  int* segk_s = reinterpret_cast<int*>(smem + P::SEGK_OFF);
  unsigned char* ring = smem + P::RING_OFF;
  // Stage st: Q rows, dO rows, then lse, delta, last key, segment id.
  auto q_at = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * P::STAGE);
  };
  auto stat_of = [&](int st, int which) {
    return reinterpret_cast<float*>(ring + st * P::STAGE + P::STATS_OFF) +
           which * RT;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_split = gridDim.x, rank = blockIdx.x;
  const int kvh = blockIdx.y % g.n_kv, b = blockIdx.y / g.n_kv;
  const int j0 = blockIdx.z * DKV_KEYS;

  const size_t key_stride = (size_t)g.n_kv * HD;
  const size_t kv_base = ((size_t)b * g.sk * g.n_kv + kvh) * HD;
  for (int idx = tid; idx < DKV_KEYS * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR, j = j0 + r;
    const bool valid = j < g.sk;
    const size_t off = valid ? kv_base + (size_t)j * key_stride + ch * 8 : 0;
    cp_async16(k_s + r * LD + ch * 8, k + off, valid);
    cp_async16(v_s + r * LD + ch * 8, v + off, valid);
  }
  if (g.seg && tid < DKV_KEYS) {
    const int j = j0 + tid;
    const bool valid = j < g.sk;
    cp_async4(segk_s + tid, segk + (valid ? (size_t)b * g.sk + j : 0),
              valid);
  }

  // The rows that see key j0 start at position j0 - off; this CTA takes
  // steps [u_lo, u_hi) of the 64-row steps from there.
  int r_begin = g.causal ? max(0, j0 - g.off) * g.group : 0;
  r_begin = min(r_begin, g.rows_total);
  const int n_steps = (g.rows_total - r_begin + RT - 1) / RT;
  const int u_lo = n_steps * rank / n_split;
  const int n_my = n_steps * (rank + 1) / n_split - u_lo;
  auto issue = [&](int u, int st) {
    const int r0 = r_begin + (u_lo + u) * RT;
    bf16* qs = q_at(st);
    bf16* ds = qs + P::ROWS / 2;
    for (int idx = tid; idx < RT * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR, fr = r0 + r;
      const bool valid = fr < g.rows_total;
      const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
      cp_async16(qs + r * LD + ch * 8, q + off, valid);
      cp_async16(ds + r * LD + ch * 8, dout + off, valid);
    }
    if (tid < RT) {
      const int fr = r0 + tid;
      const bool valid = fr < g.rows_total;
      const size_t at = valid ? stat_at(g, b, kvh, fr) : 0;
      cp_async4(stat_of(st, 0) + tid, lse + at, valid);
      cp_async4(stat_of(st, 1) + tid, delta + at, valid);
      reinterpret_cast<int*>(stat_of(st, 2))[tid] = last_key(g, fr);
      if (g.seg)
        cp_async4(stat_of(st, 3) + tid,
                  segq + (valid ? (size_t)b * g.sq + fr / g.group : 0),
                  valid);
    }
  };
  cp_async_commit();                        // K, V, key segment ids
  constexpr int DIST = DKV_STAGES - 1;
#pragma unroll
  for (int u = 0; u < DIST; ++u) {
    if (u < n_my) issue(u, u);
    cp_async_commit();
  }
  cp_async_wait<DIST>();                    // K and V landed
  __syncthreads();

  // This warp's 16 keys as A fragments of S^T = K_w.Q^T and dP^T =
  // V_w.dO^T; this lane's keys are jw + gq and jw + gq + 8.
  const int jl = warp * 16, jw = j0 + jl;
  uint32_t kf[HD / 16][4], vf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int at = (jl + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(kf[kk], k_s + at);
    ldsm_x4(vf[kk], v_s + at);
  }
  int sgk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sgk[h] = g.seg ? segk_s[jl + gq + 8 * h] : 0;

  const float sl = g.scale * LOG2E;
  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
    adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  }

#pragma unroll 1
  for (int u = 0; u < n_my; ++u) {
    cp_async_wait<DIST - 1>();              // step u landed ...
    __syncthreads();                        // ... for all; step u - 1 done
    if (u + DIST < n_my) issue(u + DIST, (u + DIST) % DKV_STAGES);
    cp_async_commit();
    const int r0 = r_begin + (u_lo + u) * RT;
    const int r_end = min(r0 + RT, g.rows_total);
    // Warp-uniform: skip a step none of whose rows sees the warp's keys.
    if (jw >= g.sk || last_key(g, r_end - 1) < jw) continue;
    const bool full = !g.seg && jw + 16 <= g.sk && r0 + RT <= g.rows_total &&
                      last_key(g, r0) >= jw + 15;
    const int slot = u % DKV_STAGES;
    const bf16* qs = q_at(slot);
    const bf16* ds = qs + P::ROWS / 2;
    const float* lse_s = stat_of(slot, 0);
    const float* dl_s = stat_of(slot, 1);
    const int* lim_s = reinterpret_cast<const int*>(stat_of(slot, 2));
    const int* sq_s = reinterpret_cast<const int*>(stat_of(slot, 3));

    // S^T = K_w . Q^T and dP^T = V_w . dO^T, 16 keys x 64 rows.
    float st[RT / 8][4], dpt[RT / 8][4];
#pragma unroll
    for (int n = 0; n < RT / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int np = 0; np < RT / 16; ++np)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, qs + at);
        mma_bf16(st[2 * np], kf[kk], qb[0], qb[1]);
        mma_bf16(st[2 * np + 1], kf[kk], qb[2], qb[3]);
        ldsm_x4(ob, ds + at);
        mma_bf16(dpt[2 * np], vf[kk], ob[0], ob[1]);
        mma_bf16(dpt[2 * np + 1], vf[kk], ob[2], ob[3]);
      }
    // P^T = 2^(s sl - lse log2 e), 0 where masked; dS^T = P^T (dP^T -
    // delta) scale. Column c is query row r0 + c.
#pragma unroll
    for (int n = 0; n < RT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * n + 2 * tq + (e & 1);
        float p = ex2(fmaf(st[n][e], sl, -(lse_s[c] * LOG2E)));
        if (!full) {
          const bool ok = jw + gq + 8 * h <= lim_s[c] &&
                          (!g.seg || sq_s[c] == sgk[h]);
          p = ok ? p : 0.f;
        }
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dl_s[c]) * g.scale;
      }
    // dV += P^T . dO and dK += dS^T . Q, 16 rows a step: packed to bf16,
    // the accumulators are the A fragments.
#pragma unroll
    for (int kk = 0; kk < RT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        const int at = (kk * 16 + (lane & 15)) * LD + np * 16 +
                       (lane >> 4) * 8;
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, ds + at);
        mma_bf16(adv[2 * np], pa, ob[0], ob[1]);
        mma_bf16(adv[2 * np + 1], pa, ob[2], ob[3]);
        ldsm_x4_trans(qb, qs + at);
        mma_bf16(adk[2 * np], da, qb[0], qb[1]);
        mma_bf16(adk[2 * np + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring is free: partials

  // This CTA's f32 partial dK and dV, [2][64][HD], in its shared memory.
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (jl + gq + 8 * h) * HD + 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(part + at) =
          make_float2(adk[n][2 * h], adk[n][2 * h + 1]);
      *reinterpret_cast<float2*>(part + DKV_KEYS * HD + at) =
          make_float2(adv[n][2 * h], adv[n][2 * h + 1]);
    }
  constexpr int D4 = HD / 4;
  constexpr int ITEMS = 2 * DKV_KEYS * D4;  // float4s of dK, then dV
  auto store = [&](int it, float4 x) {
    const int half = it / (DKV_KEYS * D4), rem = it % (DKV_KEYS * D4);
    const int j = j0 + rem / D4, d = (rem % D4) * 4;
    if (j >= g.sk) return;
    bf16* out = (half ? dv : dk) + kv_base + (size_t)j * key_stride + d;
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  };
  const float4* part4 = reinterpret_cast<const float4*>(part);
  if (n_split == 1) {
    __syncthreads();
    for (int it = tid; it < ITEMS; it += NT) store(it, part4[it]);
    return;
  }
  // The cluster's partials summed in rank order, through distributed
  // shared memory; CTA r writes items r, r + splits, ...
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // every partial is written
  for (int it = rank + n_split * tid; it < ITEMS; it += n_split * NT) {
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {  // one round of remote loads
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < n_split) x[j] = cluster.map_shared_rank(part4, j)[it];
    }
    float4 sum = x[0];
#pragma unroll
    for (int j = 1; j < MAX_SPLITS; ++j)
      if (j < n_split) {
        sum.x += x[j].x;
        sum.y += x[j].y;
        sum.z += x[j].z;
        sum.w += x[j].w;
      }
    store(it, sum);
  }
  cluster.sync();                           // no CTA leaves while read
}

bool bad_shape(int batch, int sq, int sk, int n_heads, int n_kv, int hd,
               int dtype, const void* segq, const void* segk) {
  return batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
         n_heads % n_kv || dtype != 1 || (hd != 16 && hd != 32) ||
         (segq == nullptr) != (segk == nullptr);
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* segq, const void* segk, void* o,
                       void* lse, const Geo& g, cudaStream_t stream) {
  using P = FwdPlan<HD>;
  auto kernel = flash_fwd_small<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch,
                  (g.rows_total + FWD_ROWS - 1) / FWD_ROWS);
  kernel<<<grid, NT, P::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(segq),
      static_cast<const int32_t*>(segk), static_cast<bf16*>(o),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* segq, const void* segk, void* dq,
                      const Geo& g, cudaStream_t stream) {
  using P = DqPlan<HD>;
  auto kernel = flash_dq_small<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch,
                  (g.rows_total + FWD_ROWS - 1) / FWD_ROWS);
  kernel<<<grid, NT, P::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(segq), static_cast<const int32_t*>(segk),
      static_cast<bf16*>(dq), g);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* segq, const void* segk, void* dk,
                       void* dv, const Geo& g, int splits,
                       cudaStream_t stream) {
  using P = DkvPlan<HD>;
  auto kernel = flash_dkv_small<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, g.n_kv * g.batch,
                     (g.sk + DKV_KEYS - 1) / DKV_KEYS);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = P::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(segq), static_cast<const int32_t*>(segk),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// flash_attn_fwd's arguments (csrc/flash_attn.cu). dtype must be 1
// (bfloat16), hd 16 or 32; segq/segk both null or both set. Returns
// cudaGetLastError() after the launch (0 = success) or
// cudaErrorInvalidValue for what the kernel does not take; the Python
// wrapper checks first and raises on any nonzero return.
extern "C" int flash_attn_fwd_small(const void* q, const void* k,
                                    const void* v, const void* segq,
                                    const void* segk, void* o, void* lse,
                                    int batch, int sq, int sk, int n_heads,
                                    int n_kv, int hd, int causal, int dtype,
                                    float scale, void* stream) {
  if (bad_shape(batch, sq, sk, n_heads, n_kv, hd, dtype, segq, segk))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 32) return (int)launch_fwd<32>(q, k, v, segq, segk, o, lse, g, s);
  return (int)launch_fwd<16>(q, k, v, segq, segk, o, lse, g, s);
}

// flash_attn_bwd_dq's arguments (csrc/flash_attn.cu), the forward's
// conditions.
extern "C" int flash_attn_bwd_dq_small(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* segq, const void* segk,
    void* dq, int batch, int sq, int sk, int n_heads, int n_kv, int hd,
    int causal, int dtype, float scale, void* stream) {
  if (bad_shape(batch, sq, sk, n_heads, n_kv, hd, dtype, segq, segk))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 32)
    return (int)launch_dq<32>(q, k, v, dout, lse, delta, segq, segk, dq, g,
                              s);
  return (int)launch_dq<16>(q, k, v, dout, lse, delta, segq, segk, dq, g, s);
}

// flash_attn_bwd_dkv's arguments, and `splits`: the CTAs (1 to 8, one
// cluster) that share a key tile's row steps, the host's choice.
extern "C" int flash_attn_bwd_dkv_small(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* segq, const void* segk,
    void* dk, void* dv, int batch, int sq, int sk, int n_heads, int n_kv,
    int hd, int causal, int dtype, float scale, int splits, void* stream) {
  if (bad_shape(batch, sq, sk, n_heads, n_kv, hd, dtype, segq, segk) ||
      splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 32)
    return (int)launch_dkv<32>(q, k, v, dout, lse, delta, segq, segk, dk,
                               dv, g, splits, s);
  return (int)launch_dkv<16>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                             g, splits, s);
}
