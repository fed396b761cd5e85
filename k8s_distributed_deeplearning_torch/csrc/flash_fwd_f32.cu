// Flash-attention forward in f32 on Hopper's tensor cores: every product a
// three-pass TF32 split (tf32x3.cuh) through mma.sync m16n8k8, head_dim
// 16, 32, 64 or 128.
//
// Replaces, on the f32 path: k8s_distributed_deeplearning_tpu/ops/
// pallas_flash.py `_fwd_kernel` (:148, launched by `_fwd` at :364) ->
// flash_fwd_tf32x3. ops/flash_attn.py `_fwd_route` sends every float32
// call here ("tf32x3"); bf16 stays on csrc/flash_fwd.cu (head_dim 64/128)
// and csrc/flash_small.cu (16/32). flash_fwd_kernel of csrc/flash_attn.cu,
// whose f32 branch runs on the CUDA cores, stays reachable as the forced
// "mma" route.
//
// Contract (flash_attn.cu's forward in f32):
//   q          [B, sq, H, D]    float32
//   k, v       [B, sk, kv, D]   float32; q head h reads KV head h / (H/kv)
//   segq, segk [B, sq], [B, sk] int32 or null: attend only where equal
//   o          [B, sq, H, D]    float32
//   lse        [B, H, sq]       float32
// Causal masking is bottom-right aligned: row i sees key j iff
// i + (sk - sq) >= j. The online softmax runs in the log2 domain: masked
// scores are -inf, m = max(m, max(s) * scale * log2 e), p = 2^(s * scale
// * log2 e - m) with the scale folded into one FFMA and ex2.approx (about
// 2 ulp: f32-accurate), so p = 0 where masked; l sums the f32 p, O = sum
// p V / max(l, 1e-30) and lse = m ln 2 + log(max(l, 1e-30)). A row that
// sees no key gives O = 0 and lse = -1e30 exactly, the plain version's.
//
// Why three passes and not one: a TF32 operand keeps 11 significant bits,
// so one pass moves a score by ~1e-3 of its size, and O, through p and
// through P.V, by a few 1e-4 of its own: past chip_smoke.py's f32 limit
// (FLASH_TOL[float32] = 1e-4). hi + lo carries 22 bits; the dropped lo.lo
// term is ~2^-22 relative, f32's own order.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 67 TFLOP/s f32 on the CUDA
// cores, 3.35 TB/s): operations. Two products of 2 * D FLOPs per visible
// (query, key) pair and query head; three passes make three times that
// in TF32. Causal, B 2, S 2048, 32/8 heads, D 128: 68.7 GFLOP of f32 work,
// 0.416 ms at a third of the TF32 peak (1.03 ms at the CUDA-core peak that
// flash_attn.cu's f32 branch is bound by).
// What the design does about it:
// - Both products run on the tensor cores, three mma.sync a fragment pair,
//   operands split as their fragments load (tf32x3.cuh): no split copy is
//   stored.
// - S = Q.K^T: Q and K rows both run along head_dim, so at D = 32, 64 and
//   128 both load as float4 rows (`load_a_x4`, `load_b_nk_x4`: four
//   k-steps a load); at D = 16 in the (g, t) pattern (`load_a`,
//   `load_b_nk`). Rows of D + 4 floats are free of bank conflicts in both.
// - No staging tile: S's accumulator, masked and exponentiated, is P's A
//   fragment for O += P.V as it stands (`a_from_acc`, the permuted
//   contraction index), and V, stored [key][d], loads as float4 (float2 at
//   D = 16) rows (`load_b_kn`).
// - The tensor cores' f32 accumulation rounds toward zero: each tile's
//   P.V is summed from zero and taken into the running O in f32 with the
//   softmax's rescale in one rounding (tf32x3.cuh `add_part`), so no chain
//   of truncations grows with the sequence. S's chain is one tile's D / 8
//   k-steps, as in csrc/paged_attn_f32.cu, whose forward on the same
//   arithmetic held 0.03 of the f32 limit.
// - One CTA per (128 flattened query rows, KV head, batch row): eight warps
//   of 16 rows, a row being (query position, head of the KV head's group),
//   so one K/V tile serves the whole group. Grid (KV heads x B, row
//   tiles), heaviest row tiles first under causal masking. Q is loaded
//   once; 32-key K/V tiles are double-buffered with cp.async, the next
//   tile loading under the current tile's products, up to the CTA's last
//   visible key; a warp skips a tile none of its rows sees, and masks only
//   tiles some of its rows see in part.
// - `kernel_breakdown.py flash_fwd_f32` times each stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_rows.cuh"     // Geo, the flattened rows, copy_rows
#include "tf32x3.cuh"
#include "wgmma.cuh"          // cp.async copies, ex2

namespace {

constexpr int NW = 8;               // warps a CTA
constexpr int NT = NW * 32;
constexpr int ROWS = NW * 16;       // flattened query rows a CTA
constexpr int KT = 32;              // keys a K/V tile
constexpr int PAD = 4;              // row pitch D + 4 floats (= 4 mod 8),
                                    // copy_rows' pitch
constexpr unsigned FULL = 0xffffffffu;

// B fragments a vector load of V feeds: 4 (float4 rows) when D is a
// multiple of 32, else 2.
template <int D> constexpr int NV_OF = D % 32 == 0 ? 4 : 2;

// Shared memory, in floats: Q (ROWS rows), two stages of K then V (KT rows
// each), two stages of key segment ids.
template <int D>
struct Plan {
  static constexpr int LD = D + PAD;
  static constexpr int RING_OFF = ROWS * LD;
  static constexpr int STAGE = 2 * KT * LD;
  static constexpr int SEG_OFF = RING_OFF + 2 * STAGE;
  static constexpr size_t BYTES = 4 * ((size_t)SEG_OFF + 2 * KT);
};

// Grid: (n_kv * B, row tiles). CTA (x, y) serves KV head x % n_kv of batch
// row x / n_kv and flattened rows [tile * ROWS, (tile + 1) * ROWS), tile =
// row tiles - 1 - y: under causal masking the heaviest first. Warp w owns
// rows [16w, 16w + 16).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int32_t* __restrict__ segq,
                 const int32_t* __restrict__ segk, float* __restrict__ o,
                 float* __restrict__ lse, Geo g) {
  using P = Plan<D>;
  constexpr int LD = P::LD, NV = NV_OF<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  int* segk_s = reinterpret_cast<int*>(smem + P::SEG_OFF);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int kvh = blockIdx.x % g.n_kv, b = blockIdx.x / g.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * ROWS;

  copy_rows<D, NT>(q_s, ROWS, q, [&](int r) -> const float* {
    const int fr = row0 + r;
    return fr < g.rows_total ? q + q_row(g, b, kvh, fr) * D : nullptr;
  });
  const size_t kv_stride = (size_t)g.n_kv * D;
  const float* k_b = k + ((size_t)b * g.sk * g.n_kv + kvh) * D;
  const float* v_b = v + ((size_t)b * g.sk * g.n_kv + kvh) * D;
  auto fetch = [&](int u, int stage) {
    float* ks = smem + P::RING_OFF + stage * P::STAGE;
    const int j0 = u * KT;
    copy_rows<D, NT>(ks, KT, k, [&](int r) -> const float* {
      return j0 + r < g.sk ? k_b + (j0 + r) * kv_stride : nullptr;
    });
    copy_rows<D, NT>(ks + KT * LD, KT, v, [&](int r) -> const float* {
      return j0 + r < g.sk ? v_b + (j0 + r) * kv_stride : nullptr;
    });
    if (g.seg && threadIdx.x < KT) {
      const int j = j0 + threadIdx.x;
      cp_async4(segk_s + stage * KT + threadIdx.x,
                segk + (j < g.sk ? (size_t)b * g.sk + j : 0), j < g.sk);
    }
  };

  // This lane's rows of the warp's 16: h = 0 row g, h = 1 row g + 8, with
  // their last visible key and segment id. Keys [0, kend) are visible to
  // some row of the CTA, [0, w_kend) to some row of this warp, [0, w_full)
  // to all of its rows.
  const int wr0 = row0 + 16 * warp;
  int lim[2], sgq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + (lane >> 2) + 8 * h;
    lim[h] = last_key(g, fr);
    sgq[h] = (fr < g.rows_total && g.seg)
                 ? segq[(size_t)b * g.sq + fr / g.group] : 0;
  }
  const int kend = last_key(g, min(row0 + ROWS, g.rows_total) - 1) + 1;
  const int n_tiles = kend > 0 ? (kend + KT - 1) / KT : 0;
  const int w_kend = __reduce_max_sync(FULL, max(lim[0], lim[1]) + 1);
  const int w_full =
      (g.seg || wr0 >= g.rows_total) ? 0 : last_key(g, wr0) + 1;

  const float sl = g.scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float* qa = q_s + 16 * warp * LD;

  if (n_tiles > 0) fetch(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                // tile t (and Q) landed
    __syncthreads();                   // ... for every thread; t - 1 done
    if (t + 1 < n_tiles) fetch(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int j0 = t * KT;
    if (j0 >= w_kend) continue;        // warp-uniform: nothing visible
    const float* ks = smem + P::RING_OFF + (t & 1) * P::STAGE;
    const float* vs = ks + KT * LD;
    const int* sk_s = segk_s + (t & 1) * KT;

    // S = Q.K^T: 16 rows x 32 keys, keys 8n + 2t + (e & 1) of rows g
    // (e < 2) and g + 8.
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (D % 32 == 0) {
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        FragA aq[4];
        load_a_x4(aq, qa, LD, 32 * c, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          FragB bk[4];
          load_b_nk_x4(bk, ks + 8 * n * LD, LD, 32 * c, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma3(s[n], aq[j], bk[j]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        const FragA aq = load_a(qa, LD, kk, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(s[n], aq, load_b_nk(ks + 8 * n * LD, LD, kk, lane));
      }
    }
    if (j0 + KT > w_full) {            // the tile needs the mask
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, jl = 8 * n + 2 * tq + (e & 1);
          const bool ok =
              j0 + jl <= lim[h] && (!g.seg || sk_s[jl] == sgq[h]);
          if (!ok) s[n][e] = neg_inf();
        }
    }
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
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
    // p = 2^(s sl - m) into s: P's A fragments.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], sl, -((e & 2) ? mn1 : mn0)));
        if (e & 2)
          sum1 += p;
        else
          sum0 += p;
        s[n][e] = p;
      }
    l0 = a0 * l0 + sum0;      // per-lane partial sums; the quad's at the end
    l1 = a1 * l1 + sum1;

    // O = alpha O + P.V: V read [key][d]; each group of 8 NV columns' share
    // summed from zero and taken in with one rounding.
    FragA pa[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) pa[n] = a_from_acc(s[n]);
#pragma unroll
    for (int c = 0; c < D / 8; c += NV) {
      float part[NV][4] = {};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragB bv[NV];
        load_b_kn<NV>(bv, vs, LD, 8 * n, 8 * c, lane);
#pragma unroll
        for (int i = 0; i < NV; ++i) mma3(part[i], pa[n], bv[i]);
      }
      add_part<NV>(acc + c, part, a0, a1);
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + (lane >> 2) + 8 * h;
    if (fr >= g.rows_total) continue;
    const float n = fmaxf(h ? l1 : l0, 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[c][2 * h] /= n;
      acc[c][2 * h + 1] /= n;
    }
    float* out = o + q_row(g, b, kvh, fr) * D;
#pragma unroll
    for (int c = 0; c < D / 8; c += NV)
      store_acc_row<NV>(out, 8 * c, acc + c, h, lane);
    const float m = h ? m1 : m0;
    if (tq == 0)
      lse[stat_at(g, b, kvh, fr)] =
          (m <= NEG_INF * 0.5f ? NEG_INF : m * LN2) + logf(n);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* segq, const void* segk, void* o, void* lse,
                   const Geo& g, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3<D>;
  const size_t bytes = Plan<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.n_kv * g.batch, (g.rows_total + ROWS - 1) / ROWS);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(segq),
      static_cast<const int32_t*>(segk), static_cast<float*>(o),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

}  // namespace

// flash_attn_fwd's arguments (csrc/flash_attn.cu). dtype must be 0
// (float32), hd 16, 32, 64 or 128; segq/segk both null or both set.
// Returns cudaGetLastError() after the launch (0 = success) or
// cudaErrorInvalidValue for what the kernel does not take; the Python
// wrapper checks first and raises on any nonzero return.
extern "C" int flash_attn_fwd_tf32x3(const void* q, const void* k,
                                     const void* v, const void* segq,
                                     const void* segk, void* o, void* lse,
                                     int batch, int sq, int sk, int n_heads,
                                     int n_kv, int hd, int causal, int dtype,
                                     float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_heads <= 0 ||
      n_heads % n_kv || dtype != 0 || (segq == nullptr) != (segk == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(batch, sq, sk, n_heads, n_kv, causal,
                         segq != nullptr, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, segq, segk, o, lse, g, s);
    case 32: return (int)launch<32>(q, k, v, segq, segk, o, lse, g, s);
    case 64: return (int)launch<64>(q, k, v, segq, segk, o, lse, g, s);
    case 128: return (int)launch<128>(q, k, v, segq, segk, o, lse, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
