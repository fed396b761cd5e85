// Paged grouped-query attention for decode, on Hopper's tensor cores
// (mma.sync), with the key range split over the live length and the
// splits merged in the same launch.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_paged_attn.py,
// `_kernel` (launched by `paged_decode_attention`), for decode and short
// verify windows, both branches: fp pools, and int8 pools with
// per-token-per-head f32 scales (`quant=True`). ops/paged_attn.py `_route`
// sends bf16 q with at most 16 flattened (position, group head) rows per
// KV head, sq * group <= 16, at head_dim 64 or 128 here; prefill chunks go
// to csrc/paged_prefill.cu, everything else to csrc/paged_attn.cu.
//
// Contract (paged_attn.cu's, narrowed to what this kernel takes):
//   q          [B, sq, H, hd]                   bfloat16, hd 64 or 128
//   pool_k/v   [num_pages, page_tokens, kv*hd]  bfloat16, or int8
//   k/v_scale  [num_pages, page_tokens, kv]     float32, int8 pools only
//   tables     [B, n_blocks] int32  (virtual block -> pool page, 0 = scratch)
//   positions  [B, sq] int32        (query i of row b attends col <= pos[b,i])
//   out        [B, sq, H, hd]       bfloat16
// q head h attends KV head h / (H/kv). Masked scores are NEG_INF = -1e30,
// p = 0 where s <= NEG_INF/2, and the output is O / max(l, 1e-30), so a
// fully masked row is exactly 0. The softmax runs in the log2 domain
// (p = 2^(s * scale * log2 e - m)), the same values to an ulp.
// Rounding, as paged_prefill.cu. fp, as the Pallas kernel: p is rounded
// to bf16 at the running max for P.V (`p.astype(v_h.dtype)`), l sums the
// f32 p. int8: int8 values, exact in bf16, meet bf16 q on the tensor
// cores: S = Q.K_int8 in f32, then column j times k_scale[j]; for P.V the
// V scale folds into p, p'_j = p_j * v_scale[j], split into hi = bf16(p')
// and lo = bf16(p' - hi), two products against V_int8.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes. Decode
// does 4 * H * hd FLOPs per live key on 2 * kv * hd * itemsize bytes of
// K/V per live key (int8: plus 8 * kv bytes of scales): about 4 FLOPs a
// byte at Llama-3 8B's heads, far below the card's ~295. Phase A's decode
// case (B 4, 4,710 live keys, 32/8 heads, hd 128) moves 19.3 MB of bf16
// K/V: 0.0058 ms.
// What the design does about it:
// - Grid (splits, KV heads, batch rows): a cluster of `splits` CTAs (at
//   most 8, the host's choice from the batch, the KV heads and the SM
//   count: about two CTAs an SM) serves one (row, KV head), each CTA an
//   equal share of the row's live 16-key tiles, read from the row's cursor
//   on the device: bytes follow the live length, not the table width, and
//   no launch waits on the device.
// - A CTA holds all the query rows of its KV head (the group's heads at
//   each position, padded to 16), so each K/V byte is read once. It loads
//   the row's cursors, the row's block table (its first TAB_W entries, into
//   shared memory) and Q at once, so one memory round trip precedes the
//   first K/V copy.
// - Its four warps work alone: warp w takes tiles w, w + 4, ... of the
//   CTA's share through its own ring of two 16-key slots, one tile ahead,
//   filled by 16-byte cp.async of each key's head slice, so a warp waits
//   only on its own copies (one __syncwarp a tile, no CTA barrier in the
//   loop). Three CTAs fit an SM (70 KB each at bf16 and head_dim 128),
//   with 96 KB of K/V in flight; a third slot a warp, at two CTAs an SM,
//   measured slower.
// - Both products run on the tensor cores with mma.sync m16n8k16, the
//   query rows as M: S = Q.K^T (Q fragments loaded once, K by ldmatrix)
//   and O += P.V (P from the S accumulators, V by ldmatrix.trans). The
//   online softmax stays in registers. int8 tiles are converted to bf16
//   in shared memory by the warp that owns them (exact, no integer
//   conversions), then take the same path.
// - The warps' states merge in shared memory in warp order, and the
//   cluster's CTA states through distributed shared memory in CTA order,
//   each CTA writing a slice of the output: the bits do not depend on the
//   order in which CTAs finish, and a call is one launch with no
//   workspace.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KT = 16;          // keys a tile: one mma k-step of P.V
constexpr int NW = 4;           // warps a CTA, each with its own ring
constexpr int NT = NW * 32;
constexpr int RING = 2;         // ring slots a warp: one tile ahead
constexpr int MAX_ROWS = 16;    // query rows a KV head: one mma M tile
constexpr int MAX_SPLITS = 8;   // CTAs a (row, KV head): a portable cluster
constexpr int TAB_W = 512;      // block-table entries kept in shared memory
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one CTA, in bytes. A bf16 tile is [rows][HD] with the
// 16-byte chunks of row r XORed with r % 8, so ldmatrix reads eight rows
// at one chunk from eight bank groups.
template <int HD, bool QUANT>
struct Plan {
  static constexpr int ROWB = HD * 2;              // a bf16 row
  static constexpr int TILE = KT * ROWB;           // a bf16 K or V tile
  // A ring slot: bf16 K then V; or int8 K, int8 V, KT K scales, KT V
  // scales.
  static constexpr int SLOT = QUANT ? 2 * KT * HD + 2 * KT * 4 : 2 * TILE;
  static constexpr int V_OFF = QUANT ? KT * HD : TILE;
  // A warp: its ring, and for int8 the slot it computes as bf16 K and V.
  static constexpr int WARP = RING * SLOT + (QUANT ? 2 * TILE : 0);
  static constexpr int Q_OFF = 0;
  static constexpr int TAB_OFF = MAX_ROWS * ROWB;
  static constexpr int RING_OFF = TAB_OFF + TAB_W * 4;
  static constexpr int RING_END = RING_OFF + NW * WARP;
  // After the loop the ring holds each warp's state, O [NW][16][OSTR] f32
  // and (m, l) [NW][16], then the CTA's, O [16][HD] and (m, l) [16].
  static constexpr int OSTR = HD + 8;
  static constexpr int WML_OFF = RING_OFF + NW * MAX_ROWS * OSTR * 4;
  static constexpr int CO_OFF = WML_OFF + NW * MAX_ROWS * 8;
  static constexpr int CML_OFF = CO_OFF + MAX_ROWS * HD * 4;
  static constexpr int MERGE_END = CML_OFF + MAX_ROWS * 8;
  static constexpr int BYTES = RING_END > MERGE_END ? RING_END : MERGE_END;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d (m16n8, f32) += a (m16k16, bf16, row) . b (k16n8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a K/V row comes from: the element offset of its head slice in the
// pools and of its scale in the scale pages; `valid` false zero-fills.
struct Src {
  unsigned long long off;
  int soff;
  int valid;
};

// Grid: (splits, KV heads, B), clusters of `splits` CTAs along x. CTA
// (s, kvh, b) serves KV head kvh of batch row b: tiles [s T / splits,
// (s + 1) T / splits) of the row's T live 16-key tiles. Flattened row r is
// query position r / group of q head kvh * group + r % group.
template <int HD, bool QUANT>
__global__ void __launch_bounds__(NT, 3)    // three CTAs an SM
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ pool_k_raw,
                    const void* __restrict__ pool_v_raw,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int sq, int n_heads,
                    int n_kv, int page_tokens, int n_blocks, float scale) {
  using P = Plan<HD, QUANT>;
  using S = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const S* pool_k = static_cast<const S*>(pool_k_raw);
  const S* pool_v = static_cast<const S*>(pool_v_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv;
  const int rows = sq * group;
  const int width = n_blocks * page_tokens;

  // The row's cursors: lane i < sq holds query i's. Rows past `rows` see
  // nothing (-1).
  const int pos_l =
      lane < sq ? __ldg(positions + (size_t)b * sq + lane) : -1;

  // The Q tile (rows past `rows` zero), swizzled, and the row's block
  // table, as one copy group.
  const int32_t* table = tables + (size_t)b * n_blocks;
  int* tab_s = reinterpret_cast<int*>(smem + P::TAB_OFF);
  {
    constexpr int CPR = HD / 8;
    for (int idx = tid; idx < MAX_ROWS * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR;
      const bool valid = r < rows;
      size_t off = 0;
      if (valid)
        off = (((size_t)b * sq + r / group) * n_heads + kvh * group +
               r % group) * HD + ch * 8;
      cp_async16(smem + P::Q_OFF + r * P::ROWB + ((ch ^ (r & 7)) << 4),
                 q + off, valid);
    }
    for (int i = tid; i < min(n_blocks, TAB_W); i += NT)
      cp_async4(tab_s + i, table + i, true);
    cp_async_commit();
  }
  const int kmax = __reduce_max_sync(FULL, pos_l);
  const int kmin = __reduce_min_sync(FULL, lane < sq ? pos_l : INT_MAX);
  const int c_lim = min(kmax + 1, width);      // columns the row reads
  const int n_tiles = c_lim > 0 ? (c_lim + KT - 1) / KT : 0;
  const int g = lane >> 2;                     // this thread's rows g, g + 8
  const int qd = lane & 3;
  const int pos0 = __shfl_sync(FULL, pos_l, g < rows ? g / group : 0);
  const int pos1 =
      __shfl_sync(FULL, pos_l, g + 8 < rows ? (g + 8) / group : 0);
  const int cur0 = g < rows ? pos0 : -1, cur1 = g + 8 < rows ? pos1 : -1;
  const int t_lo = split * n_tiles / n_split;
  const int t_hi = (split + 1) * n_tiles / n_split;
  const int my_n = t_hi - t_lo > warp ? (t_hi - t_lo - warp + NW - 1) / NW
                                      : 0;
  cp_async_wait<0>();
  __syncthreads();                // Q and the table, every thread's part

  // This warp's tiles: t_lo + warp + k * NW, k < my_n. Lane j < 16 looks
  // up key j of a tile; the copies take each key's offset from its lane.
  const size_t tok_stride = (size_t)n_kv * HD;
  const int pt_shift =
      (page_tokens & (page_tokens - 1)) ? -1 : __ffs(page_tokens) - 1;
  auto lookup = [&](int k) {
    Src s{0ull, 0, 0};
    const int col = (t_lo + warp + k * NW) * KT + (lane & 15);
    if (k < my_n && col < c_lim) {
      const int blk = pt_shift >= 0 ? col >> pt_shift : col / page_tokens;
      const int page = blk < TAB_W ? tab_s[blk] : __ldg(table + blk);
      const long long tok =
          (long long)page * page_tokens + (col - blk * page_tokens);
      s.off = (unsigned long long)tok * tok_stride + (size_t)kvh * HD;
      s.soff = (int)(tok * n_kv + kvh);
      s.valid = 1;
    }
    return s;
  };
  unsigned char* ring = smem + P::RING_OFF + warp * P::WARP;
  constexpr int VEC = 16 / (int)sizeof(S);       // elements a chunk
  constexpr int CPK = HD / VEC;                  // chunks a key
  constexpr int KPP = 32 / CPK;                  // keys a pass of the warp
  static_assert(32 % CPK == 0 && KT % KPP == 0, "copy grid");
  auto issue = [&](const Src& src, int slot) {
    unsigned char* st = ring + slot * P::SLOT;
    const int ch = lane % CPK;
#pragma unroll
    for (int p = 0; p < KT / KPP; ++p) {
      const int j = lane / CPK + p * KPP;
      const unsigned long long off = __shfl_sync(FULL, src.off, j);
      const bool valid = __shfl_sync(FULL, src.valid, j);
      const uint32_t dst =
          QUANT ? j * HD + ch * 16 : j * P::ROWB + ((ch ^ (j & 7)) << 4);
      cp_async16(st + dst, pool_k + off + ch * VEC, valid);
      cp_async16(st + P::V_OFF + dst, pool_v + off + ch * VEC, valid);
    }
    if constexpr (QUANT) {
      if (lane < KT) {
        float* sc = reinterpret_cast<float*>(st + 2 * KT * HD);
        cp_async4(sc + lane, k_scale + src.soff, src.valid);
        cp_async4(sc + KT + lane, v_scale + src.soff, src.valid);
      }
    }
  };

  {
    Src first[RING - 1];
#pragma unroll
    for (int k = 0; k < RING - 1; ++k) first[k] = lookup(k);
#pragma unroll
    for (int k = 0; k < RING - 1; ++k) {
      if (k < my_n) issue(first[k], k);
      cp_async_commit();
    }
  }

  // ldmatrix.x4 addressing: lane supplies row rr of matrix mi.
  const int mi = lane >> 3, rr = lane & 7;
  uint32_t qa[HD / 16][4];        // Q as A fragments, loaded once
  {
    const uint32_t qb = smem_u32(smem + P::Q_OFF) +
                        ((mi & 1) * 8 + rr) * P::ROWB;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qb + (((2 * kk + (mi >> 1)) ^ rr) << 4), qa[kk]);
  }
  // K rows for S (keys (mi >> 1) * 8 + rr, chunk 2 kk + (mi & 1)); V rows
  // for P.V (keys (mi & 1) * 8 + rr, chunk 2 np + (mi >> 1)).
  const uint32_t k_row = ((mi >> 1) * 8 + rr) * P::ROWB;
  const uint32_t v_row = ((mi & 1) * 8 + rr) * P::ROWB;

  const float sl = scale * LOG2E;   // scores go to the log2 domain
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  Src next = lookup(RING - 1);
#pragma unroll 1
  for (int k = 0; k < my_n; ++k) {
    if (k + RING - 1 < my_n) issue(next, (k + RING - 1) % RING);
    cp_async_commit();
    next = lookup(k + RING);        // its latency hides behind this tile
    cp_async_wait<RING - 1>();      // tile k landed
    __syncwarp();
    const unsigned char* st = ring + (k % RING) * P::SLOT;
    const float* ks = reinterpret_cast<const float*>(st + 2 * KT * HD);
    const float* vs = ks + KT;
    uint32_t kb = smem_u32(st);
    if constexpr (QUANT) {
      // Eight int8 (chunk ch of key j, K then V) as eight bf16, swizzled.
      unsigned char* cvt = ring + RING * P::SLOT;
      constexpr int UPK = HD / 8;                   // units a key
#pragma unroll
      for (int i = 0; i < 2 * KT * UPK / 32; ++i) {
        const int u = lane + 32 * i;
        const int kv = u / (KT * UPK), j = (u / UPK) % KT, ch = u % UPK;
        const uint2 raw = *reinterpret_cast<const uint2*>(
            st + kv * KT * HD + j * HD + ch * 8);
        *reinterpret_cast<uint4*>(cvt + kv * P::TILE + j * P::ROWB +
                                  ((ch ^ (j & 7)) << 4)) = s8x8_to_bf16(raw);
      }
      __syncwarp();
      kb = smem_u32(cvt);
    }
    const uint32_t vb = kb + P::TILE;

    // S = Q . K^T: keys 8j + 2 qd + (e & 1) of rows g (e < 2), g + 8.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kb + k_row + (((2 * kk + (mi & 1)) ^ rr) << 4), kf);
      mma16816(s[0], qa[kk], kf[0], kf[1]);
      mma16816(s[1], qa[kk], kf[2], kf[3]);
    }

    // Scale (int8: the K scale first), mask, online softmax in the log2
    // domain.
    const int c0 = (t_lo + warp + k * NW) * KT;
    const bool full = c0 + KT - 1 <= kmin && c0 + KT <= c_lim;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * qd + (e & 1);
        float x = s[j][e];
        if constexpr (QUANT) x *= ks[key];
        x *= sl;
        if (!full) {
          const int col = c0 + key;
          if (col > ((e & 2) ? cur1 : cur0) || col >= c_lim) x = NEG_INF;
        }
        s[j][e] = x;
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        float p = ex2(x - ((e & 2) ? mn1 : mn0));
        if (!full) p = x <= NEG_INF * 0.5f ? 0.f : p;
        s[j][e] = p;
        if (e & 2)
          sum1 += p;
        else
          sum0 += p;
      }
    l0 = a0 * l0 + sum0;    // per-thread partial sums; the quad's at the end
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // P as the A fragment of O += P . V (register r: rows g, g + 8 at keys
    // 2 qd, 2 qd + 1 of n-tile 0, then of n-tile 1); int8: p' = p *
    // v_scale, high and low bf16 halves.
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = r >> 1, e = (r & 1) * 2;
      float x = s[j][e], y = s[j][e + 1];
      if constexpr (QUANT) {
        const int key = 8 * j + 2 * qd;
        x *= vs[key];
        y *= vs[key + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
        pa[r] = *reinterpret_cast<const uint32_t*>(&h2);
        pl[r] = pack_bf16(x - __low2float(h2), y - __high2float(h2));
      } else {
        pa[r] = pack_bf16(x, y);
        pl[r] = 0u;
      }
    }
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vf[4];
      ldsm_x4_t(vb + v_row + (((2 * np + (mi >> 1)) ^ rr) << 4), vf);
      mma16816(o[2 * np], pa, vf[0], vf[1]);
      mma16816(o[2 * np + 1], pa, vf[2], vf[3]);
      if constexpr (QUANT) {
        mma16816(o[2 * np], pl, vf[0], vf[1]);
        mma16816(o[2 * np + 1], pl, vf[2], vf[3]);
      }
    }
    __syncwarp();                   // the slot is free for the next copies
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);

  // The warps' states, in the ring's place.
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem + P::RING_OFF);
  float2* mls = reinterpret_cast<float2*>(mo + NW * MAX_ROWS * P::OSTR);
  {
    float* w0 = mo + (warp * MAX_ROWS + g) * P::OSTR + 2 * qd;
    float* w1 = w0 + 8 * P::OSTR;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(w0 + 8 * n) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(w1 + 8 * n) = make_float2(o[n][2], o[n][3]);
    }
    if (qd == 0) {
      mls[warp * MAX_ROWS + g] = make_float2(m0, l0);
      mls[warp * MAX_ROWS + g + 8] = make_float2(m1, l1);
    }
  }
  __syncthreads();

  // The CTA's state: the warps merged in order. With one split it is the
  // row's: the output.
  constexpr int D4 = HD / 4;
  float* co = reinterpret_cast<float*>(smem + P::CO_OFF);
  float2* cml = reinterpret_cast<float2*>(smem + P::CML_OFF);
  for (int it = tid; it < rows * D4; it += NT) {
    const int r = it / D4, d = (it % D4) * 4;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, mls[w * MAX_ROWS + r].x);
    float ll = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float2 ml = mls[w * MAX_ROWS + r];
      const float a = ex2(ml.x - mm);
      const float4 x = *reinterpret_cast<const float4*>(
          mo + (w * MAX_ROWS + r) * P::OSTR + d);
      ll += a * ml.y;
      acc.x += a * x.x;
      acc.y += a * x.y;
      acc.z += a * x.z;
      acc.w += a * x.w;
    }
    if (n_split == 1) {
      const float n = fmaxf(ll, 1e-30f);
      __nv_bfloat16* op = out + (((size_t)b * sq + r / group) * n_heads +
                                 kvh * group + r % group) * HD + d;
      *reinterpret_cast<uint2*>(op) =
          make_uint2(pack_bf16(acc.x / n, acc.y / n),
                     pack_bf16(acc.z / n, acc.w / n));
    } else {
      *reinterpret_cast<float4*>(co + r * HD + d) = acc;
      if (d == 0) cml[r] = make_float2(mm, ll);
    }
  }
  if (n_split == 1) return;

  // The cluster's CTA states merged in CTA order, through distributed
  // shared memory; CTA s writes items s, s + splits, ... A state with l = 0
  // saw no key (its O is 0) and is left out.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                   // every CTA's state is written
  const int rank = (int)cluster.block_rank();
  for (int it = rank + n_split * tid; it < rows * D4; it += n_split * NT) {
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
    __nv_bfloat16* op = out + (((size_t)b * sq + r / group) * n_heads +
                               kvh * group + r % group) * HD + d;
    *reinterpret_cast<uint2*>(op) = make_uint2(
        pack_bf16(acc.x / n, acc.y / n), pack_bf16(acc.z / n, acc.w / n));
  }
  cluster.sync();                   // no CTA leaves while read
}

template <int HD, bool QUANT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* ks, const void* vs, const void* tables,
                   const void* positions, void* out, int batch, int sq,
                   int n_heads, int n_kv, int page_tokens, int n_blocks,
                   int splits, float scale, cudaStream_t stream) {
  using P = Plan<HD, QUANT>;
  auto kernel = paged_decode_kernel<HD, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_kv, batch);
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
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q),
                         pk, pv, static_cast<const float*>(ks),
                         static_cast<const float*>(vs),
                         static_cast<const int32_t*>(tables),
                         static_cast<const int32_t*>(positions),
                         static_cast<__nv_bfloat16*>(out), sq, n_heads, n_kv,
                         page_tokens, n_blocks, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// paged_prefill_fwd's arguments, with the key splits of a (row, KV head)
// in place of the row tile: 1 to MAX_SPLITS CTAs, launched as one
// cluster. dtype must be 1 (bfloat16); hd 64 or 128; sq * (H / kv) <= 16;
// k_scale and v_scale both null for bf16 pools or both given for int8
// pools. Returns cudaGetLastError() after the launch (cudaSuccess = 0),
// or cudaErrorInvalidValue for arguments the kernel does not take; the
// Python wrapper checks those first and raises on any nonzero return.
extern "C" int paged_decode_fwd(const void* q, const void* pool_k,
                                const void* pool_v, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* positions, void* out, int batch,
                                int sq, int n_heads, int n_kv, int hd,
                                int page_tokens, int n_blocks, int dtype,
                                int splits, float scale, void* stream) {
  const bool quant = k_scale != nullptr;
  if (batch <= 0 || sq <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || sq * (n_heads / n_kv) > MAX_ROWS ||
      page_tokens <= 0 || n_blocks <= 0 || dtype != 1 ||
      quant != (v_scale != nullptr) || (hd != 64 && hd != 128) ||
      splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_DECODE_CASE(HD, QUANT)                                         \
  if (hd == HD && quant == QUANT)                                            \
    return (int)launch<HD, QUANT>(q, pool_k, pool_v, k_scale, v_scale,       \
                                  tables, positions, out, batch, sq,         \
                                  n_heads, n_kv, page_tokens, n_blocks,      \
                                  splits, scale, s);
  PAGED_DECODE_CASE(64, false)
  PAGED_DECODE_CASE(128, false)
  PAGED_DECODE_CASE(64, true)
  PAGED_DECODE_CASE(128, true)
#undef PAGED_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
