// Flash-attention forward on Hopper's tensor cores (wgmma), bf16 in, f32
// accumulation, head_dim 64 or 128.
//
// Replaces: k8s_distributed_deeplearning_tpu/ops/pallas_flash.py
//   `_fwd_kernel` (:148, launched by `_fwd` at :364) -> flash_fwd_wgmma
// ops/flash_attn.py `_fwd_route` sends bf16 calls at head_dim 64 or 128
// here; float32 and head_dim 16 or 32 stay on flash_fwd_kernel
// (csrc/flash_attn.cu, mma.sync).
//
// Contract (flash_attn.cu's forward, narrowed to what this kernel takes):
//   q          [B, sq, H, D]    bfloat16, D 64 or 128
//   k, v       [B, sk, kv, D]   bfloat16; q head h reads KV head h / (H/kv)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   o          [B, sq, H, D]    bfloat16
//   lse        [B, H, sq]       float32
// Causal masking is bottom-right aligned: row i sees key j iff
// i + (sk - sq) >= j. Masked scores are NEG_INF = -1e30 and give p = 0;
// the sum is floored at 1e-30 and lse = m + log(max(l, 1e-30)), so a row
// that sees no key gives exactly 0 in O and lse = -1e30, as the plain
// version does. Rounding points, the Pallas kernel's: scores summed in
// f32, p rounded to bf16 at the running max for P.V, l summed over the f32
// p, O cast once. The softmax runs in the log2 domain (scores times
// scale * log2 e, p = 2^(x - m), ex2.approx.ftz), the same values to a few
// ulp; m goes back to natural units for lse, and a row whose m is still
// the NEG_INF sentinel keeps it unscaled.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): operations.
// Two products of 2 * D FLOPs per visible (query, key) pair and query
// head: 4 * sq * sk * D per head, halved under causal masking. Causal,
// B 2, S 2048, 32/8 heads, D 128: 68.7 GFLOP, 0.0695 ms, against 67 MB
// read or written once (0.020 ms).
// What the design does about it:
// - Both products run on wgmma. S = Q.K^T reads Q (loaded once) and K
//   K-major from shared memory (m64n64k16); O += P.V takes P from
//   registers (the S accumulator's layout is the A operand's) and reads V
//   N-major (trans-b) from the tile the ring holds. Tiles are
//   [D / 64][rows][64] bf16 with the 128-byte swizzle.
// - One CTA per (tile of 128 flattened query rows, two consumer
//   warpgroups of 64; KV head; batch row), heaviest tiles first. A
//   flattened row is (query position, head of the KV head's group), so
//   every K/V tile serves the whole group.
// - 64-key K/V tiles, with their key segment ids, stream through a
//   five-slot cp.async ring two tiles ahead, up to the CTA's last visible
//   key (the causal frontier); a tile that every row of a warpgroup sees
//   whole (no segment ids) skips the mask. One barrier a tile publishes
//   the copies, which every thread makes.
// - A warpgroup issues tile t's S beside tile t - 1's P.V; its softmax
//   waits for S alone and the rescale of O for P.V. The two warpgroups run
//   half a tile apart (warpgroup 1 does tile t - 1's softmax while
//   warpgroup 0's products of tile t run, then issues its own), so one's
//   exponentials run while the other's products hold the tensor cores
//   (in step, both softmaxes left the tensor cores idle at once; PERF.md
//   has the times of both).
// - The loop bounds and the skip-mask test are broadcast from lane 0, each
//   warpgroup's loop is straight-line, and every product is waited for in
//   the iteration that issues it: every warpgroup walks every tile of its
//   CTA (a pair it cannot see gives p = 0 and alpha = 1), so ptxas keeps
//   the products asynchronous.
// - The output is scaled by one reciprocal a row, not divided element by
//   element (HD / 4 full-precision divisions a thread).
// `kernel_breakdown.py flash_fwd` times each stage; PERF.md keeps the
// times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int KT = 64;          // keys per K/V tile
constexpr int DIST = 2;         // tiles in flight ahead of the current one
// Ring slots: the tiles in flight, the current one and the two before it:
// the lagging warpgroup's P.V of tile t - 2 may still run when the copies
// of tile t + 2 start.
constexpr int STAGES = DIST + 3;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in bytes from a 1024-byte aligned base: ROWS query rows
// (64 per consumer warpgroup), the ring of K and V tiles, then each
// stage's key segment ids. Every tile that wgmma reads starts 1024-byte
// aligned, as the 128-byte swizzle needs.
template <int HD>
struct FwdPlan {
  static constexpr int ROWS = 128;
  static constexpr int THREADS = 256;
  static constexpr int TILE = KT * HD * 2;        // a bf16 K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int RING_OFF = ROWS * HD * 2;
  static constexpr int STAGE = 2 * TILE;          // K, then V
  static constexpr int SEG_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BYTES = SEG_OFF + STAGES * KT * 4 + 1024;
};

struct Geo {
  int batch, sq, sk, n_heads, n_kv, group, rows_total, off, causal, seg;
  float scale;
};

// Flattened query row fr of KV head kvh in batch row b: position
// fr / group, head kvh * group + fr % group. Its row in a [B, sq, H, D]
// tensor, and its element of the [B, H, sq] log-sum-exp.
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
// At head_dim 64 two CTAs share an SM (98 KB of shared memory each), so
// a thread gets at most 128 registers.
template <int HD>
__global__ void __launch_bounds__(256, HD == 64 ? 2 : 1)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int32_t* __restrict__ segq,
                const int32_t* __restrict__ segk,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Geo g) {
  using P = FwdPlan<HD>;
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

  // The Q tile, zero rows past the end; it lands with K/V tile 0.
  {
    constexpr int CPR = HD / 8;
    for (int idx = tid; idx < ROWS * CPR; idx += NT) {
      const int r = idx / CPR, ch = idx % CPR;
      const int fr = row0 + r;
      const bool valid = fr < g.rows_total;
      const size_t off = valid ? q_row(g, b, kvh, fr) * HD + ch * 8 : 0;
      cp_async16(smem + P::Q_OFF + swz(ROWS, r, ch), q + off, valid);
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
  // i is clear, r0 + 8 otherwise; its column is 8 * (i / 4) + cq + (i & 1).
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int lim[2], sgq[2];           // last visible key; segment id
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + r0 + 8 * h;
    const bool valid = fr < g.rows_total;
    const int i = valid ? fr / g.group : 0;
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
  const float sl = g.scale * LOG2E;   // scores go to the log2 domain
  float acc[HD / 2];
  float s[32];
  uint32_t pa[KT / 16][4];            // P in bf16, as wgmma A fragments
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = 0u;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  auto v_addr = [&](int t) {
    return sbase + P::RING_OFF + (t % STAGES) * P::STAGE + P::TILE;
  };

  // O += P . V over the tile whose V sits at va, 16 keys a step.
  auto issue_pv = [&](uint32_t va) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs<HD>(acc, pa[kk], desc(va + kk * 2048, KT * 128, 1024));
    wgmma_commit();
  };
  // S = Q . K^T of tile t, and beside it the previous tile's P.V (at t = 0,
  // P is zero and adds nothing).
  auto products = [&](int t) {
    fence_regs(s);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    wgmma_ss_rows<HD>(s, q_addr, ROWS, v_addr(t) - P::TILE);
    wgmma_commit();
    issue_pv(v_addr(t ? t - 1 : 0));
  };
  // Tile t's softmax: wait for S, mask, online softmax in the log2 domain
  // (p = 2^(s scale log2 e - m)); then wait for the previous P.V, rescale
  // O and keep P as wgmma A fragments.
  auto softmax = [&](int t) {
    wgmma_wait<1>();                 // S is in s
    fence_regs(s);
    const int c0 = t * KT;
    const bool full = c0 + KT <= c_full;
    const int* sk_s = segk_s + (t % STAGES) * KT;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sl;
      if (!full) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + cq + (i & 1);
        const bool ok =
            c0 + col <= lim[h] && (!g.seg || sk_s[col] == sgq[h]);
        x = ok ? x : NEG_INF;
      }
      s[i] = x;
      if (i & 2)
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

    wgmma_wait<0>();                 // the previous P.V is in acc
    fence_regs(acc);
    fence_regs(pa);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
    // Register r of k-step kk holds elements 8kk + 2r and 8kk + 2r + 1.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

#pragma unroll 1
  for (int u = 0; u < DIST; ++u) {
    if (u < n_tiles) issue(u, u);
    cp_async_commit();
  }
  // Wait for tile t and free the slot of tile t - 3 (barrier), then start
  // the copies of tile t + DIST into it.
  auto next_tile = [&](int t) {
    cp_async_wait<DIST - 1>();       // tile t (and Q) landed
    fence_proxy_async();
    __syncthreads();                 // ... for every thread; tile t - 3 done
    if (t + DIST < n_tiles) issue(t + DIST, (t + DIST) % STAGES);
    cp_async_commit();
  };
  // Between the barriers of tiles t and t + 1 warpgroup 0 runs
  // products(t), then softmax(t); warpgroup 1 runs softmax(t - 1), then
  // products(t). Half a tile apart, the one's softmax runs while the
  // other's products hold the tensor cores. Warpgroup 1's loop puts the
  // barrier between products(t) and softmax(t), so in both loops every
  // product is waited for in the iteration that issues it: ptxas keeps
  // them asynchronous only then.
  const bool lead = __shfl_sync(FULL, wg, 0) == 0;
  if (n_tiles > 0) {
    if (lead) {
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        next_tile(t);
        products(t);
        softmax(t);
      }
    } else {
      next_tile(0);
#pragma unroll 1
      for (int t = 0; t + 1 < n_tiles; ++t) {
        products(t);
        next_tile(t + 1);
        softmax(t);
      }
      products(n_tiles - 1);
      softmax(n_tiles - 1);
    }
    fence_regs(acc);                  // the last tile's P.V
    fence_regs(pa);
    wgmma_fence();
    issue_pv(v_addr(n_tiles - 1));
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = row0 + r0 + 8 * half;
    if (fr >= g.rows_total) continue;
    const float n = fmaxf(half ? l1 : l0, 1e-30f);
    const float inv = 1.f / n;
    const float m = half ? m1 : m0;
    __nv_bfloat16* op = o + q_row(g, b, kvh, fr) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * half;
      *reinterpret_cast<uint32_t*>(op + 8 * j) =
          pack_bf16(acc[e] * inv, acc[e + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[stat_at(g, b, kvh, fr)] =
          (m <= NEG_INF * 0.5f ? NEG_INF : m * LN2) + logf(n);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* segq, const void* segk, void* o, void* lse,
                   const Geo& g, cudaStream_t stream) {
  using P = FwdPlan<HD>;
  auto kernel = flash_fwd_wgmma<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.rows_total + P::ROWS - 1) / P::ROWS);
  kernel<<<grid, P::THREADS, P::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(segq), static_cast<const int32_t*>(segk),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), g);
  return cudaGetLastError();
}

}  // namespace

// flash_attn_fwd's arguments (csrc/flash_attn.cu). dtype must be 1
// (bfloat16), hd 64 or 128; segq/segk both null or both set. Returns
// cudaGetLastError() after the launch (0 = success) or
// cudaErrorInvalidValue for what the kernel does not take; the Python
// wrapper checks first and raises on any nonzero return.
extern "C" int flash_attn_fwd_wgmma(const void* q, const void* k,
                                    const void* v, const void* segq,
                                    const void* segk, void* o, void* lse,
                                    int batch, int sq, int sk, int n_heads,
                                    int n_kv, int hd, int causal, int dtype,
                                    float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || dtype != 1 || (hd != 64 && hd != 128) ||
      (segq == nullptr) != (segk == nullptr))
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
  g.seg = segq != nullptr;
  g.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return (int)launch<128>(q, k, v, segq, segk, o, lse, g, s);
  return (int)launch<64>(q, k, v, segq, segk, o, lse, g, s);
}
