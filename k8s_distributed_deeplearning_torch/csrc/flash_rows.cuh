// The flattened query rows of the flash kernels of csrc/flash_small.cu,
// csrc/flash_fwd_f32.cu and csrc/flash_bwd_f32.cu. A KV head's query rows
// are flattened (query position, head of the KV head's group): row fr is
// position fr / group of head kvh * group + fr % group, so one K/V tile in
// shared memory serves the whole group. Causal masking is bottom-right
// aligned: position i sees key j iff i + (sk - sq) >= j. Device-inline;
// ops/_build.py hashes every csrc/*.cuh with each source.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"          // cp.async copies

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Geo {
  int batch, sq, sk, n_heads, n_kv, group, rows_total, off, causal, seg;
  float scale;
};

inline Geo make_geo(int batch, int sq, int sk, int n_heads, int n_kv,
                    int causal, bool seg, float scale) {
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
  g.seg = seg;
  g.scale = scale;
  return g;
}

// Flattened query row fr of KV head kvh in batch row b: its row in a
// [B, sq, H, D] tensor, and its element of a [B, H, sq] statistic.
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
// The last key a valid row sees (negative: none, causal with sq > sk); -1
// for a row past the end.
__device__ __forceinline__ int last_key(const Geo& g, int fr) {
  if (fr >= g.rows_total) return -1;
  return g.causal ? min(fr / g.group + g.off, g.sk - 1) : g.sk - 1;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// Copy rows [0, n) of D floats into a tile of rows of D + 4 floats (the
// tf32x3.cuh tiles' pitch), 16 bytes a thread a step over NT threads;
// src(r) is row r's first float, null for a row past the end (zero-filled;
// `base`, any address of the tensor, stands in for its source).
template <int D, int NT, typename Src>
__device__ __forceinline__ void copy_rows(float* dst, int n,
                                          const float* base, Src src) {
  constexpr int CPR = D / 4;
  for (int idx = threadIdx.x; idx < n * CPR; idx += NT) {
    const int r = idx / CPR, c = idx - r * CPR;
    const float* s = src(r);
    cp_async16(dst + r * (D + 4) + 4 * c, s ? s + 4 * c : base,
               s != nullptr);
  }
}

}  // namespace
