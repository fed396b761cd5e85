// Paged grouped-query attention with f32 q on Hopper's tensor cores: every
// product a three-pass TF32 split (tf32x3.cuh) through mma.sync m16n8k8,
// for decode, speculative verify windows and prefill chunks alike.
//
// Replaces, for f32 q at head_dim 16, 32, 64 and 128: k8s_distributed_
// deeplearning_tpu/ops/pallas_paged_attn.py `_kernel` (:66, launched by
// `paged_decode_attention` at :243), both branches: f32 pools, and int8
// pools with per-token-per-head f32 scales (`quant=True`). ops/
// paged_attn.py `_route` sends f32 q at those head dims here ("tf32x3") at
// every row count; f32 q at other head dims stays on csrc/paged_attn.cu
// (the split kernel, which a caller may still name).
//
// Contract (paged_attn.cu's, narrowed to what this kernel takes):
//   q          [B, sq, H, hd]                   float32, hd 16, 32, 64, 128
//   pool_k/v   [num_pages, page_tokens, kv*hd]  float32, or int8
//   k/v_scale  [num_pages, page_tokens, kv]     float32, int8 pools only
//   tables     [B, n_blocks] int32  (virtual block -> pool page, 0 = scratch)
//   positions  [B, sq] int32        (query i of row b attends col <= pos[b,i])
//   out        [B, sq, H, hd]       float32
// q head h attends KV head h / (H/kv). Masked scores are NEG_INF = -1e30,
// p = 0 where s <= NEG_INF/2, and the output is O / max(l, 1e-30), so a
// fully masked row is exactly 0. The softmax runs in the log2 domain (p =
// 2^(s * scale * log2 e - m)), the same values to an ulp. p stays f32 for
// P.V in both branches (the Pallas kernel rounds p to the value dtype,
// f32 here; int8 V is dequantized to f32).
//
// Why three passes: a TF32 operand keeps 11 significant bits, so one pass
// moves a score by ~1e-3 of its size and the output by a few 1e-4, past
// chip_smoke.py's f32 limit (1e-4). hi + lo carries 22 bits; the dropped
// lo.lo term is ~2^-22 relative. int8 values are exact in TF32, so the
// int8 branch takes two passes a product: S = k_scale[j] (q_hi.k + q_lo.k)
// and, with the V scale folded into p (p'_j = p_j v_scale[j]), O += p'_hi.v
// + p'_lo.v.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 3.35 TB/s): decode and
// verify windows: bytes, K and V of the live tokens once (f32: 8 * kv * hd
// bytes a token; int8: 2 * kv * (hd + 4)); chunks: operations, 4 * H * hd
// FLOPs a visible (query, key) pair, three passes (two for int8) at the
// TF32 rate. Phase A's 512-query chunk at offset 1024 (32/8 heads, hd 128)
// is 1.07e10 FLOPs: 0.065 ms at 495 / 3 TFLOP/s. At head_dim 16 and 32
// (the serve CLI's tiny preset: 4/2 heads, hd 16) the bytes and the
// operations are both about 0 (5.0e-5 and 3.2e-5 ms for phase A's 8-slot
// decode and 128-query prefill): the time is the launch and the latency of
// the chain of copies and tiles. There the design keeps one launch (the
// cluster merge replaces csrc/paged_attn.cu's combine kernel), one memory
// round trip before the first K/V copy (the cursors, the block table and
// the Q tile fetched together) and few key tiles a CTA (the cluster splits
// a row's live tiles).
// What the design does about it:
// - Rows are flattened (query position, head of the KV head's group) rows
//   of a KV head, as in paged_decode.cu: each K/V element is read once a
//   row tile and shared by the group. A CTA holds the host's `tile_rows`:
//   16 rows when the KV head has at most 64 (decode at every group size,
//   verify windows, short chunks: one to four tiles, the last padded),
//   else 64 (four warps of 16 rows).
// - Grid (splits, KV heads x row tiles, B): a cluster of `splits` CTAs (1
//   to 8, the host's choice from the batch, the KV heads, the row tiles
//   and the SM count, never from the table width) serves one (row, KV
//   head, row tile), each CTA an equal share of the tile's live 32-key
//   tiles, counted from its rows' largest cursor read on the device: bytes
//   follow the live length, and no launch waits on the device. The
//   cluster's states merge through distributed shared memory in CTA
//   order, in the same launch, with no workspace.
// - 32-key tiles of K and V go page by page into shared memory with
//   cp.async, double-buffered: the next tile's copies run under the
//   current tile's products. A 64-row CTA's four warps each take all 32
//   keys of a tile for their 16 rows; a 16-row CTA's four warps each take
//   8 keys of it with a softmax state of their own, merged in warp order
//   at the end.
// - S = Q.K^T: Q and K rows both run along head_dim, so both load as
//   float4 rows (tf32x3.cuh `load_a_x4`, `load_b_nk_x4`: four k-steps a
//   load; at hd 16 `load_a_x2`, `load_b_nk_x2`: two), split as they load;
//   rows of hd + 4 floats (16 at hd 16) are free of bank conflicts. O +=
//   P.V: S's accumulators are P's A fragments as they stand
//   (`a_from_acc`), V rows [key][d] load as float4 (`load_b_kn<4>`; at hd
//   16 float2, `load_b_kn<2>`). int8 tiles load unsplit, at pitches
//   (`Plan::LDK`, `LDV`) where their 8-, 4- and 2-byte reads are free of
//   conflicts.
// - The tensor cores' f32 accumulation rounds toward zero: a tile's P.V
//   is summed from zero and taken into O in f32 with one fused multiply-
//   add (O = alpha O + part, rounded to nearest), so no chain of
//   truncations grows with the sequence.
// - `kernel_breakdown.py paged_f32` times each stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include <cooperative_groups.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"          // cp.async copies, ex2

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KT = 32;          // keys a tile
constexpr int NW = 4;           // warps a CTA
constexpr int NT = NW * 32;
constexpr int MAX_SPLITS = 8;   // CTAs a (row, KV head, row tile): a cluster
constexpr int TAB_W = 512;      // block-table entries kept in shared memory
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one CTA, in bytes. RT: 16-row sub-tiles a CTA (1 or 4).
template <int HD, bool QUANT, int RT>
struct Plan {
  static constexpr int ROWS = 16 * RT;
  static constexpr int KW = NW / RT;         // warps a sub-tile, by keys
  static constexpr int KN = KT / KW;         // keys a warp a tile
  static constexpr int NN = KN / 8;          // S n-tiles a warp
  // Row pitches, in elements, at which the loaders' reads are free of
  // bank conflicts (tf32x3.cuh): f32 Q and K at hd + 4 floats (16 at hd
  // 16: two rows of float4s a phase); int8 K at 32 (mod 64) bytes (48 at hd
  // 16: 4-byte reads), int8 V at 16 (mod 32) bytes (48 at hd 16: 2-byte
  // reads).
  static constexpr int LDQ = HD == 16 ? 16 : HD + 4;
  static constexpr int ELEM = QUANT ? 1 : 4;
  static constexpr int LDK = !QUANT ? LDQ
                             : HD == 16 ? 48 : HD == 32 ? 96 : HD + 32;
  static constexpr int LDV = !QUANT ? HD + 4 : HD == 16 ? 48 : HD + 16;
  // k-steps a Q/K load in S = Q.K^T; V fragments a load in P.V.
  static constexpr int SJ = HD >= 32 ? 4 : 2;
  static constexpr int NV = HD >= 32 ? 4 : 2;
  static constexpr int K_BYTES = KT * LDK * ELEM;
  static constexpr int V_BYTES = KT * LDV * ELEM;
  // A stage: K, V, then for int8 KT K scales and KT V scales.
  static constexpr int STAGE = K_BYTES + V_BYTES + (QUANT ? 2 * KT * 4 : 0);
  static constexpr int Q_OFF = 0;
  static constexpr int TAB_OFF = ROWS * LDQ * 4;
  static constexpr int WMAX_OFF = TAB_OFF + TAB_W * 4;
  static constexpr int RING_OFF = WMAX_OFF + 16 * 4;
  static constexpr int RING_END = RING_OFF + 2 * STAGE;
  // After the loop the ring holds, with several warps a sub-tile, each
  // warp's state, O [NW][16][OSTR] and (m, l) [NW][16]; then the CTA's, O
  // [ROWS][HD] and (m, l) [ROWS].
  static constexpr int OSTR = HD + 4;
  static constexpr int WO_BYTES = KW > 1 ? NW * 16 * (OSTR * 4 + 8) : 0;
  static constexpr int CO_OFF = RING_OFF + WO_BYTES;
  static constexpr int CML_OFF = CO_OFF + ROWS * HD * 4;
  static constexpr int MERGE_END = CML_OFF + ROWS * 8;
  static constexpr int BYTES = RING_END > MERGE_END ? RING_END : MERGE_END;
  static_assert(STAGE % 16 == 0 && TAB_OFF % 16 == 0, "16-byte copies");
};

// Grid: (splits, KV heads x row tiles, B), clusters of `splits` CTAs along
// x. CTA (s, kvh * n_rt + t, b) serves flattened rows [ROWS t, ROWS t +
// ROWS) of KV head kvh of batch row b: key tiles [s T / splits, (s + 1) T
// / splits) of its T live 32-key tiles. Flattened row r is query position
// r / group of q head kvh * group + r % group. Warp w takes sub-tile w %
// RT (16 rows) and keys (w / RT) KN .. + KN of each tile.
template <int HD, bool QUANT, int RT>
__global__ void __launch_bounds__(NT, 2)
paged_attn_tf32x3(const float* __restrict__ q,
                  const void* __restrict__ pool_k_raw,
                  const void* __restrict__ pool_v_raw,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ positions,
                  float* __restrict__ out, int sq, int n_heads, int n_kv,
                  int page_tokens, int n_blocks, float scale) {
  using P = Plan<HD, QUANT, RT>;
  using S = typename std::conditional<QUANT, int8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const S* pool_k = static_cast<const S*>(pool_k_raw);
  const S* pool_v = static_cast<const S*>(pool_v_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = warp % RT, kq = warp / RT;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv;
  const int rows = sq * group;
  const int n_rt = (rows + P::ROWS - 1) / P::ROWS;
  const int kvh = (int)blockIdx.y / n_rt;
  const int r0 = (int)blockIdx.y % n_rt * P::ROWS;
  const int tr = min(rows - r0, P::ROWS);      // the tile's real rows
  const int width = n_blocks * page_tokens;
  const int g = lane >> 2, qd = lane & 3;

  // The Q tile (rows past `tr` zero) and the row's block table, as one
  // copy group.
  float* q_s = reinterpret_cast<float*>(smem + P::Q_OFF);
  int* tab_s = reinterpret_cast<int*>(smem + P::TAB_OFF);
  const int32_t* table = tables + (size_t)b * n_blocks;
  {
    constexpr int CPR = HD / 4;
    for (int idx = tid; idx < P::ROWS * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR;
      const bool valid = r < tr;
      size_t off = 0;
      if (valid)
        off = (((size_t)b * sq + (r0 + r) / group) * n_heads + kvh * group +
               (r0 + r) % group) * HD + ch * 4;
      cp_async16(q_s + r * P::LDQ + ch * 4, q + off, valid);
    }
    for (int i = tid; i < min(n_blocks, TAB_W); i += NT)
      cp_async4(tab_s + i, table + i, true);
    cp_async_commit();
  }
  // This thread's rows g and g + 8 of the warp's sub-tile and their
  // cursors (-1 past the tile's real rows); the warp's largest cursor and
  // its real rows' smallest.
  const int rg0 = 16 * sub + g, rg1 = rg0 + 8;
  const int32_t* pos_b = positions + (size_t)b * sq;
  const int cur0 = rg0 < tr ? __ldg(pos_b + (r0 + rg0) / group) : -1;
  const int cur1 = rg1 < tr ? __ldg(pos_b + (r0 + rg1) / group) : -1;
  const int wmax = __reduce_max_sync(FULL, max(cur0, cur1));
  const int wmin = __reduce_min_sync(
      FULL, min(rg0 < tr ? cur0 : INT_MAX, rg1 < tr ? cur1 : INT_MAX));
  int* wmax_s = reinterpret_cast<int*>(smem + P::WMAX_OFF);
  if (lane == 0) wmax_s[warp] = wmax;
  cp_async_wait<0>();
  __syncthreads();                // Q, the table and the warps' cursors
  int kmax = wmax_s[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) kmax = max(kmax, wmax_s[w]);
  const int c_lim = min(kmax + 1, width);      // columns the tile reads
  const int n_tiles = c_lim > 0 ? (c_lim + KT - 1) / KT : 0;
  const int t_lo = split * n_tiles / n_split;
  const int t_hi = (split + 1) * n_tiles / n_split;

  // The pools and scales from this KV head on.
  pool_k += (size_t)kvh * HD;
  pool_v += (size_t)kvh * HD;
  if constexpr (QUANT) {
    k_scale += kvh;
    v_scale += kvh;
  }
  const size_t tok_stride = (size_t)n_kv * HD;
  const int pt_shift =
      (page_tokens & (page_tokens - 1)) ? -1 : __ffs(page_tokens) - 1;
  // Token of column col (< c_lim) in the pools.
  auto token = [&](int col) {
    const int blk = pt_shift >= 0 ? col >> pt_shift : col / page_tokens;
    const int page = blk < TAB_W ? tab_s[blk] : __ldg(table + blk);
    return (long long)page * page_tokens + (col - blk * page_tokens);
  };
  auto issue = [&](int t, int stage) {
    unsigned char* st = smem + P::RING_OFF + stage * P::STAGE;
    constexpr int VEC = 16 / (int)sizeof(S);   // elements a 16-byte chunk
    constexpr int CPK = HD / VEC;              // chunks a key
    for (int idx = tid; idx < KT * CPK; idx += NT) {
      const int j = idx / CPK, ch = idx % CPK;
      const int col = t * KT + j;
      const bool valid = col < c_lim;
      const size_t off =
          valid ? (size_t)token(col) * tok_stride + ch * VEC : 0;
      cp_async16(st + (j * P::LDK + ch * VEC) * P::ELEM, pool_k + off,
                 valid);
      cp_async16(st + P::K_BYTES + (j * P::LDV + ch * VEC) * P::ELEM,
                 pool_v + off, valid);
    }
    if constexpr (QUANT) {
      if (tid < KT) {
        const int col = t * KT + tid;
        const bool valid = col < c_lim;
        const size_t off = valid ? (size_t)token(col) * n_kv : 0;
        float* sc = reinterpret_cast<float*>(st + P::K_BYTES + P::V_BYTES);
        cp_async4(sc + tid, k_scale + off, valid);
        cp_async4(sc + KT + tid, v_scale + off, valid);
      }
    }
  };

  const float* qa = q_s + 16 * sub * P::LDQ;
  const float sl = scale * LOG2E;   // scores go to the log2 domain
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  if (t_lo < t_hi) issue(t_lo, 0);
  cp_async_commit();
#pragma unroll 1
  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait<0>();             // tile t landed (this thread's part)
    __syncthreads();                // ... every thread's; tile t - 1 done
    if (t + 1 < t_hi) issue(t + 1, (t + 1 - t_lo) & 1);
    cp_async_commit();
    const int c0 = t * KT + kq * P::KN;        // this warp's first key
    if (c0 > wmax) continue;        // warp-uniform: no row sees a key
    const unsigned char* st = smem + P::RING_OFF + ((t - t_lo) & 1) * P::STAGE;
    const S* kt = reinterpret_cast<const S*>(st) + kq * P::KN * P::LDK;
    const S* vt = reinterpret_cast<const S*>(st + P::K_BYTES) +
                  kq * P::KN * P::LDV;
    const float* ksc =
        reinterpret_cast<const float*>(st + P::K_BYTES + P::V_BYTES) +
        kq * P::KN;
    const float* vsc = ksc + KT;

    // S = Q . K^T: keys 8n + 2qd + (e & 1) of rows g (e < 2), g + 8.
    float s[P::NN][4];
#pragma unroll
    for (int n = 0; n < P::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    constexpr int SJ = P::SJ;
#pragma unroll
    for (int c = 0; c < HD / (8 * SJ); ++c) {
      FragA a[SJ];
      if constexpr (SJ == 4)
        load_a_x4(a, qa, P::LDQ, 32 * c, lane);
      else
        load_a_x2(a, qa, P::LDQ, 16 * c, lane);
#pragma unroll
      for (int n = 0; n < P::NN; ++n) {
        FragB bk[SJ];
        const S* kn = kt + 8 * n * P::LDK;
        if constexpr (QUANT && SJ == 4)
          load_b_nk_x4_s8(bk, kn, P::LDK, 32 * c, lane);
        else if constexpr (QUANT)
          load_b_nk_x2_s8(bk, kn, P::LDK, 16 * c, lane);
        else if constexpr (SJ == 4)
          load_b_nk_x4(bk, kn, P::LDK, 32 * c, lane);
        else
          load_b_nk_x2(bk, kn, P::LDK, 16 * c, lane);
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          if constexpr (QUANT)
            mma2(s[n], a[j], bk[j]);
          else
            mma3(s[n], a[j], bk[j]);
        }
      }
    }

    // Scale (int8: the K scale first), mask, online softmax in the log2
    // domain.
    const bool full = c0 + P::KN - 1 <= wmin && c0 + P::KN <= c_lim;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < P::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * n + 2 * qd + (e & 1);
        float x = s[n][e];
        if constexpr (QUANT) x *= ksc[key];
        x *= sl;
        if (!full) {
          const int col = c0 + key;
          if (col > ((e & 2) ? cur1 : cur0) || col >= c_lim) x = NEG_INF;
        }
        s[n][e] = x;
        if (e & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < P::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        float p = ex2(x - ((e & 2) ? mn1 : mn0));
        if (!full) p = x <= NEG_INF * 0.5f ? 0.f : p;
        if (e & 2)
          sum1 += p;
        else
          sum0 += p;
        // int8: the V scale folds into p.
        if constexpr (QUANT) p *= vsc[8 * n + 2 * qd + (e & 1)];
        s[n][e] = p;
      }
    l0 = a0 * l0 + sum0;    // per-thread partial sums; the quad's at the end
    l1 = a1 * l1 + sum1;

    // O = alpha O + P . V, each group of 8 NV columns' share summed from
    // zero and taken in with one rounding.
    constexpr int NV = P::NV;
    FragA pa[P::NN];
#pragma unroll
    for (int n = 0; n < P::NN; ++n) pa[n] = a_from_acc(s[n]);
#pragma unroll
    for (int c = 0; c < HD / (8 * NV); ++c) {
      float part[NV][4];
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
      for (int n = 0; n < P::NN; ++n) {
        FragB bv[NV];
        if constexpr (QUANT && NV == 4)
          load_b_kn4_s8(bv, vt, P::LDV, 8 * n, 32 * c, lane);
        else if constexpr (QUANT)
          load_b_kn2_s8(bv, vt, P::LDV, 8 * n, 16 * c, lane);
        else
          load_b_kn<NV>(bv, vt, P::LDV, 8 * n, 8 * NV * c, lane);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if constexpr (QUANT)
            mma2(part[i], pa[n], bv[i]);
          else
            mma3(part[i], pa[n], bv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[NV * c + i][e] = fmaf(o[NV * c + i][e], (e & 2) ? a1 : a0,
                                  part[i][e]);
    }
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);

  // Flattened row r of the tile in `out`.
  auto out_row = [&](int r) {
    return out + (((size_t)b * sq + (r0 + r) / group) * n_heads +
                  kvh * group + (r0 + r) % group) * HD;
  };
  __syncthreads();                  // the ring is free
  float* co = reinterpret_cast<float*>(smem + P::CO_OFF);
  float2* cml = reinterpret_cast<float2*>(smem + P::CML_OFF);
  if constexpr (P::KW == 1) {
    // One warp a sub-tile: its state is the CTA's for its 16 rows. With
    // one split it is the rows': the output.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rg1 : rg0;
      if (r >= tr) continue;
      const float l = h ? l1 : l0;
      if (n_split == 1) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        float x[HD / 8][4];
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[n][e] = o[n][e] * inv;
#pragma unroll
        for (int c = 0; c < HD / (8 * P::NV); ++c)
          store_acc_row<P::NV>(out_row(r), 8 * P::NV * c, x + P::NV * c, h,
                               lane);
      } else {
#pragma unroll
        for (int c = 0; c < HD / (8 * P::NV); ++c)
          store_acc_row<P::NV>(co + r * HD, 8 * P::NV * c, o + P::NV * c, h,
                               lane);
        if (qd == 0) cml[r] = make_float2(h ? m1 : m0, l);
      }
    }
    if (n_split == 1) return;
  } else {
    // Several warps a sub-tile (RT = 1): their states merged in warp
    // order, in shared memory.
    float* wo = reinterpret_cast<float*>(smem + P::RING_OFF);
    float2* wml = reinterpret_cast<float2*>(wo + NW * 16 * P::OSTR);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = wo + (warp * 16 + g + 8 * h) * P::OSTR;
#pragma unroll
      for (int c = 0; c < HD / (8 * P::NV); ++c)
        store_acc_row<P::NV>(row, 8 * P::NV * c, o + P::NV * c, h, lane);
    }
    if (qd == 0) {
      wml[warp * 16 + g] = make_float2(m0, l0);
      wml[warp * 16 + g + 8] = make_float2(m1, l1);
    }
    __syncthreads();
    constexpr int D4 = HD / 4;
    for (int it = tid; it < tr * D4; it += NT) {
      const int r = it / D4, d = (it % D4) * 4;
      float mm = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wml[w * 16 + r].x);
      float ll = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float2 ml = wml[w * 16 + r];
        const float a = ex2(ml.x - mm);
        const float4 x =
            *reinterpret_cast<const float4*>(wo + (w * 16 + r) * P::OSTR + d);
        ll += a * ml.y;
        acc.x += a * x.x;
        acc.y += a * x.y;
        acc.z += a * x.z;
        acc.w += a * x.w;
      }
      if (n_split == 1) {
        const float n = fmaxf(ll, 1e-30f);
        *reinterpret_cast<float4*>(out_row(r) + d) =
            make_float4(acc.x / n, acc.y / n, acc.z / n, acc.w / n);
      } else {
        *reinterpret_cast<float4*>(co + r * HD + d) = acc;
        if (d == 0) cml[r] = make_float2(mm, ll);
      }
    }
    if (n_split == 1) return;
  }

  // The cluster's CTA states merged in CTA order, through distributed
  // shared memory; CTA s writes items s, s + splits, ... A state with l = 0
  // saw no key (its O is 0) and is left out.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                   // every CTA's state is written
  const int rank = (int)cluster.block_rank();
  constexpr int D4 = HD / 4;
  for (int it = rank + n_split * tid; it < tr * D4; it += n_split * NT) {
    const int r = it / D4, d = (it % D4) * 4;
    float2 ml[MAX_SPLITS];
    float4 x[MAX_SPLITS];
    float mm = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {     // one round of remote loads
      ml[j] = make_float2(NEG_INF, 0.f);
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < n_split) {
        ml[j] = cluster.map_shared_rank(cml, j)[r];
        x[j] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(co, j) + r * HD + d);
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) mm = fmaxf(mm, ml[j].x);
    float ll = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const float a = ml[j].y > 0.f ? ex2(ml[j].x - mm) : 0.f;
      ll += a * ml[j].y;
      acc.x += a * x[j].x;
      acc.y += a * x[j].y;
      acc.z += a * x[j].z;
      acc.w += a * x[j].w;
    }
    const float n = fmaxf(ll, 1e-30f);
    *reinterpret_cast<float4*>(out_row(r) + d) =
        make_float4(acc.x / n, acc.y / n, acc.z / n, acc.w / n);
  }
  cluster.sync();                   // no CTA leaves while read
}

template <int HD, bool QUANT, int RT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* ks, const void* vs, const void* tables,
                   const void* positions, void* out, int batch, int sq,
                   int n_heads, int n_kv, int page_tokens, int n_blocks,
                   int splits, float scale, cudaStream_t stream) {
  using P = Plan<HD, QUANT, RT>;
  auto kernel = paged_attn_tf32x3<HD, QUANT, RT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  const int row_tiles = (sq * (n_heads / n_kv) + P::ROWS - 1) / P::ROWS;
  cfg.gridDim = dim3(splits, n_kv * row_tiles, batch);
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
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(q), pk, pv,
                         static_cast<const float*>(ks),
                         static_cast<const float*>(vs),
                         static_cast<const int32_t*>(tables),
                         static_cast<const int32_t*>(positions),
                         static_cast<float*>(out), sq, n_heads, n_kv,
                         page_tokens, n_blocks, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// paged_decode_fwd's arguments without the dtype (q, out and fp pools are
// float32): the key splits of a (row, KV head, row tile), 1 to MAX_SPLITS
// CTAs launched as one cluster; hd 16, 32, 64 or 128; k_scale and v_scale
// both
// null for f32 pools or both given for int8 pools. A KV head's sq * (H /
// kv) flattened rows run in tiles of `tile_rows` (16 or 64), the host's
// choice, which also sizes `splits` from the same row-tile count. Returns
// cudaGetLastError() after the launch
// (cudaSuccess = 0), or cudaErrorInvalidValue for arguments the kernel
// does not take; the Python wrapper checks those first and raises on any
// nonzero return.
extern "C" int paged_attn_tf32x3_fwd(const void* q, const void* pool_k,
                                     const void* pool_v, const void* k_scale,
                                     const void* v_scale, const void* tables,
                                     const void* positions, void* out,
                                     int batch, int sq, int n_heads,
                                     int n_kv, int hd, int page_tokens,
                                     int n_blocks, int splits, float scale,
                                     int tile_rows, void* stream) {
  const bool quant = k_scale != nullptr;
  if (batch <= 0 || sq <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || page_tokens <= 0 || n_blocks <= 0 ||
      quant != (v_scale != nullptr) ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128) ||
      splits < 1 || splits > MAX_SPLITS ||
      (tile_rows != 16 && tile_rows != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_TF32X3_CASE(HD, QUANT, RT)                                     \
  if (hd == HD && quant == QUANT && tile_rows == 16 * RT)                    \
    return (int)launch<HD, QUANT, RT>(q, pool_k, pool_v, k_scale, v_scale,   \
                                      tables, positions, out, batch, sq,     \
                                      n_heads, n_kv, page_tokens, n_blocks,  \
                                      splits, scale, s);
  PAGED_TF32X3_CASE(16, false, 1)
  PAGED_TF32X3_CASE(32, false, 1)
  PAGED_TF32X3_CASE(16, true, 1)
  PAGED_TF32X3_CASE(32, true, 1)
  PAGED_TF32X3_CASE(16, false, 4)
  PAGED_TF32X3_CASE(32, false, 4)
  PAGED_TF32X3_CASE(16, true, 4)
  PAGED_TF32X3_CASE(32, true, 4)
  PAGED_TF32X3_CASE(64, false, 1)
  PAGED_TF32X3_CASE(128, false, 1)
  PAGED_TF32X3_CASE(64, true, 1)
  PAGED_TF32X3_CASE(128, true, 1)
  PAGED_TF32X3_CASE(64, false, 4)
  PAGED_TF32X3_CASE(128, false, 4)
  PAGED_TF32X3_CASE(64, true, 4)
  PAGED_TF32X3_CASE(128, true, 4)
#undef PAGED_TF32X3_CASE
  return (int)cudaErrorInvalidValue;
}
