// Paged grouped-query attention for prefill chunks, on Hopper's tensor
// cores (wgmma).
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_paged_attn.py,
// `_kernel` (launched by `paged_decode_attention`), for a query chunk
// (sq > 1), both branches: fp pools, and int8 pools with per-token-per-head
// f32 scales (`quant=True`). ops/paged_attn.py `_route` sends bf16 chunks
// with head_dim 64 or 128 here by shape; decode and every other case stay
// on csrc/paged_attn.cu.
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
// Rounding. fp, as the Pallas kernel: p is rounded to bf16 at the running
// max for P.V (`p.astype(v_h.dtype)`), l sums the f32 p. int8: Pallas
// works in f32 there (K and V dequantized to f32, p kept f32). Here int8
// values, exact in bf16, meet bf16 q on the tensor cores: S = Q.K_int8 in
// f32, then column j times k_scale[j]; for P.V the V scale folds into p,
// p'_j = p_j * v_scale[j] in f32, split into hi = bf16(p') and
// lo = bf16(p' - hi), two products against V_int8: about 2^-16 of p' lost
// per term (one rounding of p' would lose 2^-9).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): operations.
// A chunk does 4 * H * hd * sum_{b,i} (pos[b,i] + 1) FLOPs on K/V bytes
// proportional to the live length: 512 queries at offset 1024 at Llama-3
// 8B's heads (32/8, hd 128) are 10.7 GFLOP, 0.0109 ms, against 6.3 MB of
// K/V, 0.002 ms.
// What the design does about it:
// - Both products run on the tensor cores: S = Q.K^T with Q and K from
//   shared memory (wgmma m64n64k16, bf16 in, f32 accumulation), O += P.V
//   with P from registers (the S accumulator's layout is the A operand's)
//   and V from shared memory read N-major (trans-b). The online softmax
//   stays in registers: a thread owns two rows of each 64-row tile.
// - One CTA per (batch row, KV head, tile of 128 flattened query rows: two
//   consumer warpgroups of 64), or of 64 rows (one warpgroup) when the
//   64-row grid fits in one wave. A flattened row is (query position, head
//   of the KV head's group), so every K/V tile is shared by the whole
//   group. The tiles whose rows see the most keys launch first.
// - K/V tiles of 64 keys are gathered page by page through the block table
//   (any page_tokens; a window of the table is cached in shared memory)
//   with 16-byte cp.async, two tiles ahead, into a ring of four slots, in
//   the 128-byte swizzled layout wgmma reads; a thread copies the same
//   16-byte column of every tile, so only the page lookup is per tile.
//   TMA would need one box per page; a chunk is bound by operations, and
//   cp.async keeps the page walk in plain code.
// - A CTA walks keys only up to its rows' largest cursor, and tiles that
//   lie wholly inside every row's cursor skip the mask.
// - Each tile's S product is issued beside the previous tile's P.V, and
//   the next tiles' copies are issued while they run; the softmax waits
//   for S alone, the rescale of O for P.V.
// - int8 tiles and their f32 scales ride one cp.async group; each landed
//   tile is converted to bf16 in shared memory once, for both warpgroups,
//   by byte permutes and one f32 add (no integer-to-float conversions).
// - All threads copy, and one barrier a tile keeps the two warpgroups in
//   step: no producer warp, no ping-pong between the warpgroups. PERF.md
//   keeps the times and what holds them back.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KT = 64;          // keys per tile
constexpr int DIST = 2;         // tiles in flight ahead of the current one
// Ring slots: the tiles in flight, the current one, and the previous one,
// whose P.V runs beside the current tile's S.
constexpr int STAGES = DIST + 2;
constexpr int TAB_W = 1024;     // block-table entries cached in shared memory

// Shared memory of one CTA, in bytes from a 1024-byte aligned base: ROWS
// query rows (64 per consumer warpgroup) at head_dim HD. Every tile that
// wgmma reads starts 1024-byte aligned, as the 128-byte swizzle needs.
template <int HD, int WGS, bool QUANT>
struct Plan {
  static constexpr int ROWS = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int TILE = KT * HD * 2;        // a bf16 K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int RING_OFF = ROWS * HD * 2;
  // A stage: bf16 K then V; or int8 K, int8 V, then KT K and KT V scales.
  static constexpr int STAGE = QUANT ? 2 * KT * HD + 2 * KT * 4 : 2 * TILE;
  // int8 only: two bf16 (K, V) pairs converted from the stages, the
  // current tile's and the previous one's.
  static constexpr int CVT_OFF =
      (RING_OFF + STAGES * STAGE + 1023) / 1024 * 1024;
  static constexpr int POS_OFF =
      QUANT ? CVT_OFF + 4 * TILE : RING_OFF + STAGES * STAGE;
  static constexpr int RED_OFF = POS_OFF + ROWS * 4;
  static constexpr int TAB_OFF = RED_OFF + 16 * 4;
  static constexpr int BYTES = TAB_OFF + TAB_W * 4 + 1024;   // + alignment
};

// Grid: (n_kv * B, row tiles). CTA (x, y) serves KV head x % n_kv of batch
// row x / n_kv and row tile (row tiles - 1 - y): flattened rows
// [tile * ROWS, (tile + 1) * ROWS), row r being query position r / group
// of q head kvh * group + r % group.
template <int HD, int WGS, bool QUANT>
__global__ void __launch_bounds__(128 * WGS, 1)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const void* __restrict__ pool_k_raw,
                     const void* __restrict__ pool_v_raw,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int32_t* __restrict__ tables,
                     const int32_t* __restrict__ positions,
                     __nv_bfloat16* __restrict__ out, int sq, int n_heads,
                     int n_kv, int page_tokens, int n_blocks, float scale) {
  using P = Plan<HD, WGS, QUANT>;
  using S = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  constexpr int ROWS = P::ROWS;
  constexpr int NT = P::THREADS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  int* pos_s = reinterpret_cast<int*>(smem + P::POS_OFF);
  int* red_s = reinterpret_cast<int*>(smem + P::RED_OFF);
  int* tab_s = reinterpret_cast<int*>(smem + P::TAB_OFF);
  const S* pool_k = static_cast<const S*>(pool_k_raw);
  const S* pool_v = static_cast<const S*>(pool_v_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;                 // consumer warpgroup
  const int group = n_heads / n_kv;
  const int rows_total = sq * group;
  const int kvh = blockIdx.x % n_kv;
  const int b = blockIdx.x / n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int c_cap = n_blocks * page_tokens;   // no column past the table

  // The Q tile, zero rows past the chunk; it lands with K/V tile 0.
  {
    constexpr int CPR = HD / 8;
    for (int idx = tid; idx < ROWS * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR;
      const int fr = row0 + r;
      const bool valid = fr < rows_total;
      size_t off = 0;
      if (valid) {
        const int i = fr / group, h = kvh * group + fr % group;
        off = (((size_t)b * sq + i) * n_heads + h) * HD + ch * 8;
      }
      cp_async16(smem + P::Q_OFF + swz(ROWS, r, ch), q + off, valid);
    }
  }
  // Row cursors (-1 for rows past the chunk); per warp their largest and
  // the smallest of the real rows.
  int pmax = -1, pmin = INT_MAX;
  if (tid < ROWS) {
    const int fr = row0 + tid;
    if (fr < rows_total) pmax = pmin = positions[(size_t)b * sq + fr / group];
    pos_s[tid] = pmax;
  }
  pmax = __reduce_max_sync(0xffffffffu, pmax);
  pmin = __reduce_min_sync(0xffffffffu, pmin);
  if (lane == 0) {
    red_s[warp] = pmax;
    red_s[8 + warp] = pmin;
  }
  int win0 = 0;                 // tab_s holds blocks [win0, win0 + TAB_W)
  for (int i = tid; i < min(TAB_W, n_blocks); i += NT)
    tab_s[i] = tables[(size_t)b * n_blocks + i];
  __syncthreads();
  int kmax = -1;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) kmax = max(kmax, red_s[w]);
  // Rows of warpgroup g are loaded by threads [64g, 64g + 64).
  const int wg_min = min(red_s[8 + 2 * wg], red_s[8 + 2 * wg + 1]);
  const int c_lim = min(kmax + 1, c_cap);          // columns the CTA reads
  // Broadcast from lane 0, the loop bounds are warp-uniform to the
  // compiler, which then keeps the products asynchronous.
  const int n_tiles =
      __shfl_sync(0xffffffffu, c_lim > 0 ? (c_lim + KT - 1) / KT : 0, 0);
  const int c_full =              // columns all the warpgroup's rows see
      __shfl_sync(0xffffffffu, min(wg_min, c_lim - 1) + 1, 0);

  const size_t tok_stride = (size_t)n_kv * HD;
  // Column c's block and offset in it: shifts for a power-of-two page.
  const int pt_shift =
      (page_tokens & (page_tokens - 1)) ? -1 : __ffs(page_tokens) - 1;
  auto page_of = [&](int c) {
    const int blk = pt_shift >= 0 ? c >> pt_shift : c / page_tokens;
    return make_int2(tab_s[blk - win0], c - blk * page_tokens);
  };
  // Gather key tile u into ring stage `stage`: called by every thread.
  // A thread copies the same 16-byte column `ch` of every JS-th key of
  // each tile, keys j0, j0 + JS, ...; JS is a multiple of 8, so the
  // swizzled destination moves by JS rows a step.
  constexpr int VEC = 16 / (int)sizeof(S);      // elements a chunk
  constexpr int CPR = HD / VEC;                 // chunks a key
  constexpr int JS = NT / CPR;
  static_assert(NT % CPR == 0 && JS % 8 == 0 && KT % JS == 0, "copy grid");
  const int ch = tid % CPR, j0 = tid / CPR;
  const size_t col = (size_t)kvh * HD + ch * VEC;
  const uint32_t dst0 = QUANT ? j0 * HD + ch * 16 : swz(KT, j0, ch);
  auto issue = [&](int u, int stage) {
    const int c0 = u * KT;
    const int last = (min(c0 + KT, c_lim) - 1) / page_tokens;
    if (last >= win0 + TAB_W) {   // uniform: slide the table window
      __syncthreads();
      win0 = c0 / page_tokens;
      for (int i = tid; i < min(TAB_W, n_blocks - win0); i += NT)
        tab_s[i] = tables[(size_t)b * n_blocks + win0 + i];
      __syncthreads();
    }
    unsigned char* st = smem + P::RING_OFF + stage * P::STAGE;
    // K then V: bf16 in the swizzled layout, int8 plain ([KT][HD]).
    constexpr int V_OFF = QUANT ? KT * HD : P::TILE;
    constexpr int ROW = QUANT ? HD : 128;       // bytes a key row
#pragma unroll
    for (int k = 0; k < KT / JS; ++k) {
      const int c = c0 + j0 + k * JS;
      const bool valid = c < c_lim;
      size_t off = 0;
      if (valid) {
        const int2 pg = page_of(c);
        off = ((size_t)pg.x * page_tokens + pg.y) * tok_stride + col;
      }
      unsigned char* d = st + dst0 + k * JS * ROW;
      cp_async16(d, pool_k + off, valid);
      cp_async16(d + V_OFF, pool_v + off, valid);
    }
    if constexpr (QUANT) {         // the scales of (token c, this KV head)
      float* sc = reinterpret_cast<float*>(st + 2 * KT * HD);
      for (int j = tid; j < KT; j += NT) {
        const int c = c0 + j;
        const bool valid = c < c_lim;
        size_t off = 0;
        if (valid) {
          const int2 pg = page_of(c);
          off = ((size_t)pg.x * page_tokens + pg.y) * n_kv + kvh;
        }
        cp_async4(sc + j, k_scale + off, valid);
        cp_async4(sc + KT + j, v_scale + off, valid);
      }
    }
  };

  // This thread's rows of its warpgroup's 64-row tile (the wgmma
  // accumulator layout): r0 and r0 + 8; in each 8-column group, columns
  // cq and cq + 1. Element i of s is in row r0 when bit 1 of i is clear,
  // r1 otherwise; its column is 8 * (i / 4) + cq + (i & 1).
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const uint32_t q_addr = sbase + P::Q_OFF + wg * 64 * 128;
  const float sl = scale * LOG2E;   // scores go to the log2 domain
  float o[HD / 2];
  float s[32];
  uint32_t pa[KT / 16][4];          // P (int8: the high halves of p')
  uint32_t pl[KT / 16][4];          // int8: the low halves of p'
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pl[kk][r] = 0u;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int pos0 = pos_s[r0], pos1 = pos_s[r1];
  uint32_t v_prev = 0;     // the previous tile's V, for its P.V

  // O += P . V over the tile whose V sits at v_addr, 16 keys a step.
  auto issue_pv = [&](uint32_t v_addr) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t db = desc(v_addr + kk * 2048, KT * 128, 1024);
      wgmma_rs<HD>(o, pa[kk], db);
      if constexpr (QUANT) wgmma_rs<HD>(o, pl[kk], db);
    }
    wgmma_commit();
  };

#pragma unroll 1
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) issue(u, u);
    cp_async_commit();
  }
  // Every warpgroup walks every tile of the CTA: a tile past all of its
  // rows' cursors is masked whole and changes nothing (p = 0, alpha = 1),
  // and the loop body stays free of branches around the products.
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<DIST - 1>();       // tile t (and Q) landed
    fence_proxy_async();
    __syncthreads();                 // ... for every thread
    const unsigned char* st = smem + P::RING_OFF + (t % STAGES) * P::STAGE;
    uint32_t k_addr = smem_u32(st);
    if constexpr (QUANT) {
      // Eight int8 of column chunk cc (of HD / 8) of every JC-th key, K
      // then V, as bf16 in the swizzled layout.
      unsigned char* cvt = smem + P::CVT_OFF + (t & 1) * 2 * P::TILE;
      constexpr int CC = HD / 8, JC = NT / CC;
      static_assert(NT % CC == 0 && JC % 8 == 0 && KT % JC == 0, "grid");
      const int cc = tid % CC, jc = tid / CC;
      const uint32_t from = jc * HD + cc * 8, to = swz(KT, jc, cc);
#pragma unroll
      for (int k = 0; k < 2 * KT / JC; ++k) {
        const int kv = k / (KT / JC), jj = (k % (KT / JC)) * JC;
        const uint2 raw = *reinterpret_cast<const uint2*>(
            st + kv * KT * HD + from + jj * HD);
        *reinterpret_cast<uint4*>(cvt + kv * P::TILE + to + jj * 128) =
            s8x8_to_bf16(raw);
      }
      fence_proxy_async();
      __syncthreads();
      k_addr = smem_u32(cvt);
    }
    const uint32_t v_addr = k_addr + P::TILE;

    // S = Q . K^T (head_dim / 16 steps), and beside it the previous
    // tile's P.V (at t = 0, P is zero and adds nothing).
    fence_regs(s);
    fence_regs(o);
    fence_regs(pa);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(
          s,
          desc(q_addr + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024),
          desc(k_addr + (kk >> 2) * (KT * 128) + (kk & 3) * 32, 16, 1024),
          kk);
    wgmma_commit();
    issue_pv(t ? v_prev : v_addr);
    // While the products run: gather tile t + DIST into the slot of tile
    // t - 2, whose products are done.
    if (t + DIST < n_tiles) issue(t + DIST, (t + DIST) % STAGES);
    cp_async_commit();

    wgmma_wait<1>();                 // S is in s
    fence_regs(s);
    // Scale (int8: the K scale first), mask, online softmax in the log2
    // domain: p = 2^(s * scale * log2(e) - m).
    const int c0 = t * KT;
    const float* ks = reinterpret_cast<const float*>(st + 2 * KT * HD);
    const bool full = c0 + KT <= c_full;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + cq + (i & 1);
      float x = s[i];
      if constexpr (QUANT) x *= ks[col];
      x *= sl;
      if (!full) {
        const int c = c0 + col;
        if (c > ((i & 2) ? pos1 : pos0) || c >= c_cap) x = NEG_INF;
      }
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = s[i];
      float p = ex2(x - ((i & 2) ? mn1 : mn0));
      if (!full) p = x <= NEG_INF * 0.5f ? 0.f : p;
      s[i] = p;
      if (i & 2)
        sum1 += p;
      else
        sum0 += p;
    }
    l0 = a0 * l0 + sum0;      // per-thread partial sums; the quad's at the end
    l1 = a1 * l1 + sum1;

    wgmma_wait<0>();                 // the previous P.V is in o
    fence_regs(o);
    fence_regs(pa);
    fence_regs(pl);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
    // P as wgmma A fragments: register r of k-step kk holds elements
    // 8kk + 2r and 8kk + 2r + 1.
    const float* vs = ks + KT;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        float x = s[i], y = s[i + 1];
        if constexpr (QUANT) {
          const int col = 8 * (i >> 2) + cq;
          x *= vs[col];
          y *= vs[col + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          pa[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
        } else {
          pa[kk][r] = pack_bf16(x, y);
        }
      }
    }
    v_prev = v_addr;
  }
  if (n_tiles > 0) {                  // the last tile's P.V
    fence_regs(o);
    fence_regs(pa);
    fence_regs(pl);
    wgmma_fence();
    issue_pv(v_prev);
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = row0 + (half ? r1 : r0);
    if (fr >= rows_total) continue;
    const float n = fmaxf(half ? l1 : l0, 1e-30f);
    const int i = fr / group, h = kvh * group + fr % group;
    __nv_bfloat16* op = out + (((size_t)b * sq + i) * n_heads + h) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * half;
      *reinterpret_cast<uint32_t*>(op + 8 * j) =
          pack_bf16(o[e] / n, o[e + 1] / n);
    }
  }
}

template <int HD, int WGS, bool QUANT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* ks, const void* vs, const void* tables,
                   const void* positions, void* out, int batch, int sq,
                   int n_heads, int n_kv, int page_tokens, int n_blocks,
                   float scale, cudaStream_t stream) {
  using P = Plan<HD, WGS, QUANT>;
  auto kernel = paged_prefill_kernel<HD, WGS, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const int rows_total = sq * (n_heads / n_kv);
  const dim3 grid(n_kv * batch, (rows_total + P::ROWS - 1) / P::ROWS);
  kernel<<<grid, P::THREADS, P::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), pk, pv,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions),
      static_cast<__nv_bfloat16*>(out), sq, n_heads, n_kv, page_tokens,
      n_blocks, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(bool quant, int tile_rows, const void* q,
                     const void* pk, const void* pv, const void* ks,
                     const void* vs, const void* tables,
                     const void* positions, void* out, int batch, int sq,
                     int n_heads, int n_kv, int page_tokens, int n_blocks,
                     float scale, cudaStream_t stream) {
#define PAGED_PREFILL_CASE(WGS, QUANT)                                       \
  if (tile_rows == 64 * WGS && quant == QUANT)                               \
    return launch<HD, WGS, QUANT>(q, pk, pv, ks, vs, tables, positions, out, \
                                  batch, sq, n_heads, n_kv, page_tokens,     \
                                  n_blocks, scale, stream);
  PAGED_PREFILL_CASE(1, false)
  PAGED_PREFILL_CASE(2, false)
  PAGED_PREFILL_CASE(1, true)
  PAGED_PREFILL_CASE(2, true)
#undef PAGED_PREFILL_CASE
  return cudaErrorInvalidValue;
}

// The row tile `paged_prefill_fwd` picks by default: 64 rows (one
// warpgroup) when the 64-row grid fits in one wave of `num_sms` CTAs, else
// 128 (two warpgroups, half the CTAs).
int default_tile_rows(int batch, int sq, int n_heads, int n_kv,
                      int num_sms) {
  const long rows = (long)sq * (n_heads / n_kv);
  return (rows + 63) / 64 * n_kv * batch <= num_sms ? 64 : 128;
}

}  // namespace

// paged_attn_fwd's arguments without the workspace and the key splits,
// plus the row tile: 64 or 128 rows, or 0 for default_tile_rows' choice
// on the current device. dtype must be 1 (bfloat16); hd 64 or 128;
// k_scale and v_scale both null for bf16 pools or both given for int8
// pools. Returns cudaGetLastError() after the launch (cudaSuccess = 0), or
// cudaErrorInvalidValue for arguments the kernel does not take; the Python
// wrapper checks those first and raises on any nonzero return.
extern "C" int paged_prefill_fwd(const void* q, const void* pool_k,
                                 const void* pool_v, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* positions, void* out, int batch,
                                 int sq, int n_heads, int n_kv, int hd,
                                 int page_tokens, int n_blocks, int dtype,
                                 float scale, int tile_rows, void* stream) {
  const bool quant = k_scale != nullptr;
  if (batch <= 0 || sq <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || page_tokens <= 0 || n_blocks <= 0 || dtype != 1 ||
      quant != (v_scale != nullptr) || (hd != 64 && hd != 128) ||
      (tile_rows != 0 && tile_rows != 64 && tile_rows != 128))
    return (int)cudaErrorInvalidValue;
  if (tile_rows == 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    tile_rows = default_tile_rows(batch, sq, n_heads, n_kv, sms);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return (int)dispatch<128>(quant, tile_rows, q, pool_k, pool_v, k_scale,
                              v_scale, tables, positions, out, batch, sq,
                              n_heads, n_kv, page_tokens, n_blocks, scale, s);
  return (int)dispatch<64>(quant, tile_rows, q, pool_k, pool_v, k_scale,
                           v_scale, tables, positions, out, batch, sq,
                           n_heads, n_kv, page_tokens, n_blocks, scale, s);
}
