// Flash-attention backward in f32 on Hopper's tensor cores: the dQ kernel
// and the dK/dV kernel, every product a three-pass TF32 split (tf32x3.cuh)
// through mma.sync m16n8k8, head_dim 16, 32, 64 or 128.
//
// Replaces, on the f32 path: k8s_distributed_deeplearning_tpu/ops/
// pallas_flash.py
//   `_bwd_dq_kernel`  (:396, launched by `_bwd` at :690) -> flash_dq_tf32x3
//   `_bwd_dkv_kernel` (:520, launched by `_bwd` at :723) -> flash_dkv_tf32x3
// ops/flash_attn.py `_bwd_route` sends every float32 call here ("tf32x3");
// bf16 stays on csrc/flash_bwd.cu (head_dim 64/128) and csrc/
// flash_small.cu (16/32). The mma.sync kernels of csrc/flash_attn.cu,
// whose f32 branch runs on the CUDA cores, stay reachable as the forced
// "mma" route.
//
// Contract (flash_attn.cu's backward in f32):
//   q, dout    [B, sq, H, D]    float32
//   k, v       [B, sk, kv, D]   float32; q head h reads KV head h / (H/kv)
//   lse, delta [B, H, sq]       float32 (delta = rowsum(dO * O), the caller's)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   dq [B, sq, H, D]; dk, dv [B, sk, kv, D], float32: the group summed
// Causal masking is bottom-right aligned: row i sees key j iff
// i + (sk - sq) >= j. P = exp(s * scale - lse), exactly 0 where masked
// (the plain version's p = 0 where s <= NEG_INF / 2), dS = P (dP - delta)
// scale, all in f32; a row that sees no key gives exactly 0 in dQ, and a
// key that no row sees exactly 0 in dK and dV.
//
// Why three passes and not one: a TF32 operand keeps 11 significant bits,
// so one pass moves a scaled score at head_dim 64 by ~1e-3 and dQ, dK, dV
// by a few 1e-4 of their size, past the f32 gates (chip_smoke.py
// FLASH_TOL[float32] = 1e-4, phase F's gradients 1e-4). hi + lo carries 22
// bits; the dropped lo.lo term is ~2^-22 relative, f32's own order.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 67 TFLOP/s f32 on the CUDA
// cores, 3.35 TB/s): operations. Each product is 2 * D FLOPs per visible
// (query, key) pair and query head; the dQ kernel does three (S = Q.K^T,
// dP = dO.V^T, dQ += dS.K), the dK/dV kernel four (S^T = K.Q^T, dP^T =
// V.dO^T, dV += P^T.dO, dK += dS^T.Q). Causal, B 2, S 2048, 32/8 heads,
// D 128: 103 and 137 GFLOP of f32 work; three passes issue 309 and 412
// GFLOP of TF32, 0.62 and 0.83 ms at the TF32 peak (1.54 and 2.05 ms at
// the CUDA-core f32 peak that flash_attn.cu's f32 kernels are bound by).
// What the design does about it:
// - Every product runs on the tensor cores, three mma.sync a fragment
//   pair. Operands are split as their fragments load, in four
//   instructions (cvt.rna.tf32.f32's rounding as an integer add on the
//   operand's bits, which the mma reads only the top 19 of; a mask, a
//   subtraction, the add again): no split copy is stored.
// - No staging tile: the contraction index of a product may be permuted,
//   so S's accumulator is dS's A fragment for dQ += dS.K as it stands (and
//   S^T's is P^T's and dS^T's for dV and dK), and the B tile of those
//   products (K; dO and Q), stored [k][n], loads as float4 or float2 rows.
// - Tiles are rows of D + 4 floats: reads in the (g, t) pattern and in
//   the (2t, NV g) vector patterns are all free of bank conflicts.
// - The tensor cores' f32 accumulation rounds toward zero: a tile's share
//   of dQ, dK or dV is summed from zero and added to the running sum in
//   f32 (tf32x3.cuh add_part), so no chain of truncations grows with the
//   sequence; dQ's S and dP keep the small passes in accumulators of
//   their own (mma3_split), since dP - delta cancels in a row that sees
//   few keys.
// - dQ: one CTA per (128 flattened query rows, KV head, batch row), eight
//   warps of 16 rows, heaviest tiles first; Q and dO loaded once; 32-key
//   K/V tiles double-buffered with cp.async, the next tile loading under
//   the current tile's products, up to the rows' last visible key; a warp
//   skips a tile none of its rows can see.
// - dK/dV: one CTA per (64 keys, KV head, batch row), eight warps: four
//   16-key groups x two 32-row halves of each 64-row Q/dO tile, which is
//   double-buffered with each row's lse, delta, segment id and last
//   visible key, from the causal frontier on. A flattened row is (query
//   position, head of the KV head's group), so the group sum of dK and dV
//   stays in registers; the two halves' sums meet once through shared
//   memory at the end, in a fixed order: no atomics, every output written
//   once, the same bits from run to run.
// - `kernel_breakdown.py flash_bwd_f32` times each stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "flash_rows.cuh"     // Geo, the flattened rows, copy_rows
#include "tf32x3.cuh"
#include "wgmma.cuh"          // cp.async copies

namespace {

constexpr int NW = 8;               // warps a CTA
constexpr int NT = NW * 32;
constexpr int DQ_ROWS = NW * 16;    // flattened query rows a dQ CTA
constexpr int DQ_KEYS = 32;         // keys a K/V tile (dQ)
constexpr int DKV_KEYS = 64;        // keys a dK/dV CTA: 4 groups of 16
constexpr int DKV_ROWS = 64;        // flattened rows a Q/dO tile: 2 halves
constexpr int PAD = 4;              // row pitch D + 4 floats (= 4 mod 8),
                                    // copy_rows' pitch
constexpr unsigned FULL = 0xffffffffu;

// B fragments a vector load feeds in dQ's [k][n] product: 4 (float4 rows)
// when D is a multiple of 32, else 2. The dK/dV kernel takes 2 (float2
// rows) at every D: fewer registers live beside dK and dV.
template <int D> constexpr int NV_OF = D % 32 == 0 ? 4 : 2;
constexpr int NV_KV = 2;

// Shared memory of the dQ kernel, in floats: Q and dO (DQ_ROWS rows each),
// two stages of K then V (DQ_KEYS rows each), two stages of key segment ids.
template <int D>
struct DqPlan {
  static constexpr int LD = D + PAD;
  static constexpr int DO_OFF = DQ_ROWS * LD;
  static constexpr int RING_OFF = 2 * DQ_ROWS * LD;
  static constexpr int STAGE = 2 * DQ_KEYS * LD;
  static constexpr int SEG_OFF = RING_OFF + 2 * STAGE;
  static constexpr size_t BYTES = 4 * ((size_t)SEG_OFF + 2 * DQ_KEYS);
};

// Shared memory of the dK/dV kernel, in floats: K and V (DKV_KEYS rows
// each), two stages of Q then dO (DKV_ROWS rows each), then per stage and
// row its lse, delta, segment id and last visible key. The halves' sums
// meet in the ring once the walk is done.
template <int D>
struct DkvPlan {
  static constexpr int LD = D + PAD;
  static constexpr int V_OFF = DKV_KEYS * LD;
  static constexpr int RING_OFF = 2 * DKV_KEYS * LD;
  static constexpr int STAGE = 2 * DKV_ROWS * LD;
  static constexpr int COL_OFF = RING_OFF + 2 * STAGE;
  static constexpr size_t BYTES = 4 * ((size_t)COL_OFF + 2 * 4 * DKV_ROWS);
  static_assert(4 * D * 32 <= 2 * STAGE, "the halves' sums fit the ring");
};

// Grid: (n_kv * B, row tiles). CTA (x, y) serves KV head x % n_kv of batch
// row x / n_kv and flattened rows [tile * DQ_ROWS, (tile + 1) * DQ_ROWS),
// tile = row tiles - 1 - y: under causal masking the heaviest first. Warp
// w owns rows [16w, 16w + 16).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ segq,
                const int32_t* __restrict__ segk, float* __restrict__ dq,
                Geo g) {
  using P = DqPlan<D>;
  constexpr int LD = P::LD, NV = NV_OF<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = smem + P::DO_OFF;
  int* segk_s = reinterpret_cast<int*>(smem + P::SEG_OFF);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x % g.n_kv, b = blockIdx.x / g.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;

  copy_rows<D, NT>(q_s, DQ_ROWS, q, [&](int r) -> const float* {
    const int fr = row0 + r;
    return fr < g.rows_total ? q + q_row(g, b, kvh, fr) * D : nullptr;
  });
  copy_rows<D, NT>(do_s, DQ_ROWS, dout, [&](int r) -> const float* {
    const int fr = row0 + r;
    return fr < g.rows_total ? dout + q_row(g, b, kvh, fr) * D : nullptr;
  });
  const size_t kv_stride = (size_t)g.n_kv * D;
  const float* k_b = k + ((size_t)b * g.sk * g.n_kv + kvh) * D;
  const float* v_b = v + ((size_t)b * g.sk * g.n_kv + kvh) * D;
  auto issue = [&](int u, int stage) {
    float* ks = smem + P::RING_OFF + stage * P::STAGE;
    const int j0 = u * DQ_KEYS;
    copy_rows<D, NT>(ks, DQ_KEYS, k, [&](int r) -> const float* {
      return j0 + r < g.sk ? k_b + (j0 + r) * kv_stride : nullptr;
    });
    copy_rows<D, NT>(ks + DQ_KEYS * LD, DQ_KEYS, v, [&](int r) -> const float* {
      return j0 + r < g.sk ? v_b + (j0 + r) * kv_stride : nullptr;
    });
    if (g.seg && threadIdx.x < DQ_KEYS) {
      const int j = j0 + threadIdx.x;
      cp_async4(segk_s + stage * DQ_KEYS + threadIdx.x,
                segk + (j < g.sk ? (size_t)b * g.sk + j : 0), j < g.sk);
    }
  };

  // This lane's rows of the warp's 16: h = 0 row g, h = 1 row g + 8, with
  // their lse, delta, segment id and last visible key (-1: none).
  float lse_r[2], dlt[2];
  int lim[2], sgq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + 16 * warp + (lane >> 2) + 8 * h;
    const bool valid = fr < g.rows_total;
    const int i = valid ? fr / g.group : 0;
    const size_t st = valid ? stat_at(g, b, kvh, fr) : 0;
    lse_r[h] = valid ? lse[st] : 0.f;
    dlt[h] = valid ? delta[st] : 0.f;
    lim[h] = !valid ? -1 : g.causal ? min(i + g.off, g.sk - 1) : g.sk - 1;
    sgq[h] = (valid && g.seg) ? segq[(size_t)b * g.sq + i] : 0;
  }
  // Keys [0, kend) are visible to some row of the CTA, [0, w_kend) to some
  // row of this warp.
  const int r_last = min(row0 + DQ_ROWS, g.rows_total) - 1;
  const int kend =
      g.causal ? max(0, min(g.sk, r_last / g.group + g.off + 1)) : g.sk;
  const int n_tiles = (kend + DQ_KEYS - 1) / DQ_KEYS;
  const int w_kend = __reduce_max_sync(FULL, max(lim[0], lim[1]) + 1);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* qa = q_s + 16 * warp * LD;
  const float* da = do_s + 16 * warp * LD;
  const int tq = lane & 3;

  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                // tile t (and Q, dO) landed
    __syncthreads();                   // ... for every thread; t - 1 done
    if (t + 1 < n_tiles) issue(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int j0 = t * DQ_KEYS;
    if (j0 >= w_kend) continue;        // warp-uniform: nothing visible
    const float* ks = smem + P::RING_OFF + (t & 1) * P::STAGE;
    const float* vs = ks + DQ_KEYS * LD;
    const int* sk_s = segk_s + (t & 1) * DQ_KEYS;

    // S = Q.K^T and dP = dO.V^T: 16 rows x 32 keys, the small passes
    // apart (a row that sees few keys takes dP - delta near 0, where the
    // accumulation's bias in dP would reach dQ whole).
    float s[4][4], dp[4][4], s_lo[4][4], dp_lo[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = dp[n][e] = s_lo[n][e] = dp_lo[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      const FragA aq = load_a(qa, LD, kk, lane);
      const FragA ad = load_a(da, LD, kk, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma3_split(s[n], s_lo[n], aq, load_b_nk(ks + 8 * n * LD, LD, kk,
                                                lane));
        mma3_split(dp[n], dp_lo[n], ad, load_b_nk(vs + 8 * n * LD, LD, kk,
                                                  lane));
      }
    }
    // dS = P (dP - delta) scale, into s.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, jl = 8 * n + 2 * tq + (e & 1);
        const bool ok = j0 + jl <= lim[h] && (!g.seg || sk_s[jl] == sgq[h]);
        const float x = (s[n][e] + s_lo[n][e]) * g.scale;
        const float p = ok ? expf(x - lse_r[h]) : 0.f;
        s[n][e] = p * (dp[n][e] + dp_lo[n][e] - dlt[h]) * g.scale;
      }
    }
    // dQ += dS.K: K read [key][d]; the tile's share of each group of
    // columns summed from zero, then added in f32.
    FragA a[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) a[n] = a_from_acc(s[n]);
#pragma unroll
    for (int c = 0; c < D / 8; c += NV) {
      float part[NV][4] = {};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragB bk[NV];
        load_b_kn<NV>(bk, ks, LD, 8 * n, 8 * c, lane);
#pragma unroll
        for (int i = 0; i < NV; ++i) mma3(part[i], a[n], bk[i]);
      }
      add_part<NV>(acc + c, part);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + 16 * warp + (lane >> 2) + 8 * h;
    if (fr >= g.rows_total) continue;
    float* out = dq + q_row(g, b, kvh, fr) * D;
#pragma unroll
    for (int c = 0; c < D / 8; c += NV)
      store_acc_row<NV>(out, 8 * c, acc + c, h, lane);
  }
}

// Grid: (n_kv * B, key tiles). CTA (x, y) serves KV head x % n_kv of batch
// row x / n_kv and keys [y * DKV_KEYS, (y + 1) * DKV_KEYS); under causal
// masking key tile 0 sees the most rows and launches first. Warp w owns
// keys [16 (w % 4), + 16) and rows [32 (w / 4), + 32) of every Q/dO tile.
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int32_t* __restrict__ segq,
                 const int32_t* __restrict__ segk, float* __restrict__ dk,
                 float* __restrict__ dv, Geo g) {
  using P = DkvPlan<D>;
  constexpr int LD = P::LD, NV = NV_KV;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = smem + P::V_OFF;
  // Per stage, per row of the tile: lse, delta, segment id, last visible
  // key.
  float* lse_s = smem + P::COL_OFF;
  float* dlt_s = lse_s + 2 * DKV_ROWS;
  int* sgq_s = reinterpret_cast<int*>(dlt_s + 2 * DKV_ROWS);
  int* lim_s = sgq_s + 2 * DKV_ROWS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = warp & 3, rh = warp >> 2;
  const int kvh = blockIdx.x % g.n_kv, b = blockIdx.x / g.n_kv;
  const int key0 = blockIdx.y * DKV_KEYS;

  const size_t kv_stride = (size_t)g.n_kv * D;
  const float* k_b = k + ((size_t)b * g.sk * g.n_kv + kvh) * D;
  const float* v_b = v + ((size_t)b * g.sk * g.n_kv + kvh) * D;
  copy_rows<D, NT>(k_s, DKV_KEYS, k, [&](int r) -> const float* {
    return key0 + r < g.sk ? k_b + (key0 + r) * kv_stride : nullptr;
  });
  copy_rows<D, NT>(v_s, DKV_KEYS, v, [&](int r) -> const float* {
    return key0 + r < g.sk ? v_b + (key0 + r) * kv_stride : nullptr;
  });
  // Row tiles [u0, n_rt): under causal masking from the tile of the first
  // flattened row that sees key0 (position key0 - off).
  const int u0 = g.causal ? max(0, key0 - g.off) * g.group / DKV_ROWS : 0;
  const int n_rt = (g.rows_total + DKV_ROWS - 1) / DKV_ROWS;
  // Per stage, the row of q and dout (in rows of D floats; -1 past the
  // end) that each flattened row of a Q/dO tile reads: written by the
  // first DKV_ROWS threads one tile ahead of the copies, so a thread
  // divides by the group once a tile and not once a 16-byte copy.
  __shared__ int roff_s[2 * DKV_ROWS];
  auto row_offsets = [&](int u, int stage) {
    if (u < n_rt && threadIdx.x < DKV_ROWS) {
      const int fr = u * DKV_ROWS + threadIdx.x;
      roff_s[stage * DKV_ROWS + threadIdx.x] =
          fr < g.rows_total ? (int)q_row(g, b, kvh, fr) : -1;
    }
  };
  // Tile u into `stage` (its row offsets written and visible), and tile
  // u + 1's row offsets into the other stage's.
  auto issue = [&](int u, int stage) {
    float* qs = smem + P::RING_OFF + stage * P::STAGE;
    const int* ro = roff_s + stage * DKV_ROWS;
    constexpr int CPR = D / 4;
    for (int idx = threadIdx.x; idx < DKV_ROWS * CPR; idx += NT) {
      const int r = idx / CPR, c = idx - r * CPR;
      const int row = ro[r];
      const size_t off = row >= 0 ? (size_t)row * D + 4 * c : 0;
      cp_async16(qs + r * LD + 4 * c, q + off, row >= 0);
      cp_async16(qs + (DKV_ROWS + r) * LD + 4 * c, dout + off, row >= 0);
    }
    row_offsets(u + 1, stage ^ 1);
    if (threadIdx.x < DKV_ROWS) {
      const int r0 = u * DKV_ROWS;
      const int c = threadIdx.x, fr = r0 + c;
      const bool valid = fr < g.rows_total;
      const int i = valid ? fr / g.group : 0;
      const size_t so = valid ? stat_at(g, b, kvh, fr) : 0;
      cp_async4(lse_s + stage * DKV_ROWS + c, lse + so, valid);
      cp_async4(dlt_s + stage * DKV_ROWS + c, delta + so, valid);
      if (g.seg)
        cp_async4(sgq_s + stage * DKV_ROWS + c, segq + (size_t)b * g.sq + i,
                  valid);
      lim_s[stage * DKV_ROWS + c] = !valid ? -1
                                    : g.causal ? i + g.off : g.sk - 1;
    }
  };

  // This lane's keys: h = 0 key kw0 + g, h = 1 key kw0 + g + 8 (the
  // accumulator rows), with their segment ids. A row's last visible key
  // is at most sk - 1, so a key past the end sees nothing.
  const int kw0 = key0 + 16 * kw;
  int key[2], sgk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = kw0 + (lane >> 2) + 8 * h;
    sgk[h] = (g.seg && key[h] < g.sk) ? segk[(size_t)b * g.sk + key[h]] : 0;
  }

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float* ka = k_s + 16 * kw * LD;
  const float* va = v_s + 16 * kw * LD;
  const int tq = lane & 3;

  row_offsets(u0, 0);
  __syncthreads();
  if (u0 < n_rt) issue(u0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int u = u0; u < n_rt; ++u) {
    const int stage = (u - u0) & 1;
    cp_async_wait<0>();                // tile u (and K, V) landed
    __syncthreads();                   // ... for every thread; u - 1 done
    if (u + 1 < n_rt) issue(u + 1, stage ^ 1);
    cp_async_commit();
    // This warp's 32 rows [r0, r0 + 32): nothing to do past the end, or
    // under causal masking when the last of them is before the first key.
    const int r0 = u * DKV_ROWS + 32 * rh;
    if (kw0 >= g.sk || r0 >= g.rows_total ||
        (g.causal &&
         (min(r0 + 31, g.rows_total - 1) / g.group + g.off < kw0)))
      continue;                        // warp-uniform
    const float* qs = smem + P::RING_OFF + stage * P::STAGE + 32 * rh * LD;
    const float* dos = qs + DKV_ROWS * LD;
    const int cbase = stage * DKV_ROWS + 32 * rh;

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 32 rows.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      const FragA ak = load_a(ka, LD, kk, lane);
      const FragA av = load_a(va, LD, kk, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma3(st[n], ak, load_b_nk(qs + 8 * n * LD, LD, kk, lane));
        mma3(dpt[n], av, load_b_nk(dos + 8 * n * LD, LD, kk, lane));
      }
    }
    // P^T into st, dS^T = P^T (dP^T - delta) scale into dpt.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = cbase + 8 * n + 2 * tq + (e & 1);
        const bool ok =
            key[h] <= lim_s[c] && (!g.seg || sgq_s[c] == sgk[h]);
        const float p = ok ? expf(st[n][e] * g.scale - lse_s[c]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dlt_s[c]) * g.scale;
      }
    }
    // dV += P^T.dO and dK += dS^T.Q: dO and Q read [row][d]; the half
    // tile's share of each group of columns summed from zero, then added
    // in f32. The A fragments are split again for each group: registers,
    // not instructions, are short here.
#pragma unroll
    for (int c = 0; c < D / 8; c += NV) {
      float part[NV][4] = {};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragB bf[NV];
        load_b_kn<NV>(bf, dos, LD, 8 * n, 8 * c, lane);
        const FragA ap = a_from_acc(st[n]);
#pragma unroll
        for (int i = 0; i < NV; ++i) mma3(part[i], ap, bf[i]);
      }
      add_part<NV>(adv + c, part);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragB bf[NV];
        load_b_kn<NV>(bf, qs, LD, 8 * n, 8 * c, lane);
        const FragA as = a_from_acc(dpt[n]);
#pragma unroll
        for (int i = 0; i < NV; ++i) mma3(part[i], as, bf[i]);
      }
      add_part<NV>(adk + c, part);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free

  // The second half's sums join the first's through the ring, register by
  // register (consecutive lanes on consecutive words).
  float* red = smem + P::RING_OFF + kw * (D * 32);
  if (rh == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(4 * n + e) * 32 + lane] = adk[n][e];
        red[(D / 2 + 4 * n + e) * 32 + lane] = adv[n][e];
      }
  }
  __syncthreads();
  if (rh == 1) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[n][e] += red[(4 * n + e) * 32 + lane];
      adv[n][e] += red[(D / 2 + 4 * n + e) * 32 + lane];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= g.sk) continue;
    const size_t off = (((size_t)b * g.sk + key[h]) * g.n_kv + kvh) * D;
#pragma unroll
    for (int c = 0; c < D / 8; c += NV) {
      store_acc_row<NV>(dk + off, 8 * c, adk + c, h, lane);
      store_acc_row<NV>(dv + off, 8 * c, adv + c, h, lane);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *segq, *segk;
  void *dq, *dk, *dv;
};

template <int D>
cudaError_t launch_dq(const Args& a, const Geo& g, cudaStream_t stream) {
  auto kernel = flash_dq_tf32x3<D>;
  const size_t bytes = DqPlan<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.rows_total + DQ_ROWS - 1) / DQ_ROWS);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.segq),
      static_cast<const int32_t*>(a.segk), static_cast<float*>(a.dq), g);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, const Geo& g, cudaStream_t stream) {
  auto kernel = flash_dkv_tf32x3<D>;
  const size_t bytes = DkvPlan<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.sk + DKV_KEYS - 1) / DKV_KEYS);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.segq),
      static_cast<const int32_t*>(a.segk), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), g);
  return cudaGetLastError();
}

// which: 1 dQ, 2 dK/dV.
template <int D>
cudaError_t dispatch(int which, const Args& a, const Geo& g, cudaStream_t s) {
  return which == 1 ? launch_dq<D>(a, g, s) : launch_dkv<D>(a, g, s);
}

int run(int which, const Args& a, int batch, int sq, int sk, int n_heads,
        int n_kv, int hd, int causal, int dtype, float scale, void* stream) {
  // The dK/dV kernel indexes rows of q with an int.
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || dtype != 0 ||
      (long long)batch * sq * n_heads > INT_MAX ||
      (a.segq == nullptr) != (a.segk == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         a.segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)dispatch<16>(which, a, g, s);
    case 32: return (int)dispatch<32>(which, a, g, s);
    case 64: return (int)dispatch<64>(which, a, g, s);
    case 128: return (int)dispatch<128>(which, a, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_attn_bwd_dq's and flash_attn_bwd_dkv's arguments (csrc/
// flash_attn.cu). dtype must be 0 (float32), hd 16, 32, 64 or 128;
// segq/segk both null or both set. Each returns cudaGetLastError() after
// its launch (0 = success) or cudaErrorInvalidValue for what the kernels
// do not take; the Python wrapper checks first and raises on any nonzero
// return.
extern "C" int flash_bwd_dq_tf32x3(const void* q, const void* k,
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

extern "C" int flash_bwd_dkv_tf32x3(const void* q, const void* k,
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
