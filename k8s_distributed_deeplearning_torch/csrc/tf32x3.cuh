// f32 products on Hopper's tensor cores at f32 accuracy: the three-pass
// TF32 split ("tf32x3") through mma.sync m16n8k8, for csrc/flash_fwd_f32.cu
// and csrc/flash_bwd_f32.cu (the f32 flash forward and backward),
// csrc/paged_attn_f32.cu (paged attention with f32 q) and csrc/gmm_f32.cu
// (the f32 grouped GEMM and its weight gradient).
//
// One TF32 value keeps 11 significant bits (10 stored), so one TF32
// product of two f32 tiles is off by ~2^-11 relative: too coarse for f32.
// Each f32 operand is split in registers as its fragment is loaded,
//   hi = rna_tf32(x),  lo = rna_tf32(x - hi)     (x = hi + lo + ~2^-22 x)
// with cvt.rna.tf32.f32's rounding (to nearest, ties away from zero;
// `split` does it in integer instructions), and a product of fragments
// accumulates a_lo.b_hi, then a_hi.b_lo, then
// a_hi.b_hi (the small terms first) in f32. Each product of TF32 values is
// exact in f32; only a_lo.b_lo (~2^-22 relative) is dropped, so the
// result is f32-accurate at a third of the TF32 rate (495 / 3 = 165
// TFLOP/s dense on an H100 SXM, against 67 for f32 on the CUDA cores).
//
// Fragments (PTX's m16n8k8 .tf32 layouts): lane (g = lane / 4, t = lane %
// 4) holds A (16 x 8) at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B
// (8 x 8) at (t, g), (t + 4, g); the f32 accumulator C (16 x 8) at (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Within one product the
// contraction index may be permuted, as long as A and B agree: the
// loaders below use that so that an accumulator is an A fragment as it
// stands (a_from_acc) and B tiles stored [k][n] load as vectors
// (load_b_kn). Tiles sit in shared memory as rows of `ld` floats with
// ld = 4 (mod 8): then every loader's pattern is free of bank conflicts,
// the (g, t) scalar reads and the (2t, NV g) vector reads. Two more
// contraction orders serve tiles whose contraction index is contiguous in
// both operands: the "x4" loaders take four k-steps of 8 at once, lane t
// reading 8 adjacent floats (k-step j: k0 + 8t + 2j in slot t, + 1 in slot
// t + 4), free of conflicts at ld = 4 (mod 8); the "pairs" loaders take
// load_b_kn's order (k0 + 2t, k0 + 2t + 1) as one 8-byte read a row, free
// of conflicts at ld = 8 (mod 16); the "x2" loaders are the x4 ones at
// half the depth (head_dim 16). A tile stored [k][m] (M contiguous, a
// weight gradient's lhs^T) loads as A with M permuted (load_a_km4). int8
// operands (exact in TF32) load unsplit, and their products take two
// passes (mma2).
//
// Everything is device-inline; ops/_build.py hashes every csrc/*.cuh with
// each source. kernel_breakdown.py builds variants of a source with
// TF32X3_NO_SPLIT (hi = x, lo = 0: no split work) or TF32X3_NO_MMA (no
// products: their operands are folded into one accumulator element by
// integer XORs) defined before this header; their numbers are wrong on
// purpose.
#pragma once

#include <stdint.h>

namespace {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero), as an operand: the mma reads the top 19 bits of
// the register and not the 13 below, so adding half a TF32 unit in the
// last place to the bit pattern is the whole rounding, one integer add.
// (cvt.rna compiles to three instructions on sm_90a, two of them to pass
// infinities and NaN through.)
__device__ __forceinline__ uint32_t tf32_operand(float x) {
  return __float_as_uint(x) + 0x1000u;
}
// The value of a tf32_operand: its low 13 bits cleared.
__device__ __forceinline__ float tf32_value(uint32_t op) {
  return __uint_as_float(op & 0xffffe000u);
}

// hi = rna_tf32(x), lo = rna_tf32(x - hi), as operands: four instructions.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#ifdef TF32X3_NO_SPLIT
  hi = __float_as_uint(x);
  lo = 0u;
#else
  hi = tf32_operand(x);
  lo = tf32_operand(x - tf32_value(hi));
#endif
}

// c += a . b: one m16n8k8 product of TF32 fragments, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#ifdef TF32X3_NO_MMA
  // Four integer instructions keep every operand live; c[0] stays a
  // finite number in [1, 2), so nothing downstream meets a NaN.
  c[0] = __uint_as_float(
      ((__float_as_uint(c[0]) ^ a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]) &
       0x007fffffu) | 0x3f800000u);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// A split f32 fragment.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a . b at f32 accuracy: the three passes, small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// The same three passes into two accumulators: the small terms into
// `small`, a_hi.b_hi into `big`; the product is big + small. The tensor
// cores' f32 accumulation rounds toward zero, a bias of up to one unit in
// the sum's last place a chained product; keeping the small terms apart
// cuts the chain at the sum's magnitude to one product in three, and the
// small sum's own bias is ~2^-11 of it.
__device__ __forceinline__ void mma3_split(float (&big)[4],
                                           float (&small)[4],
                                           const FragA& a, const FragB& b) {
  mma_tf32(small, a.lo, b.hi);
  mma_tf32(small, a.hi, b.lo);
  mma_tf32(big, a.hi, b.hi);
}

// c += a . b where b holds exact TF32 values in `hi` (int8 operands): two
// passes, the small one first.
__device__ __forceinline__ void mma2(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.hi);
}

// acc[i][e] = acc[i][e] * a + part[i][e], rounded once (a = a0 on row g,
// e < 2; a1 on row g + 8), then part = 0. The tensor cores' f32
// accumulation drops the bits below the sum's last place (it rounds toward
// zero, not to nearest), a bias that grows with the number of products
// chained into one accumulator: chained over a causal row of 2,048 keys
// (768 products), it put the f32 flash dQ at 1.67x chip_smoke.py's f32
// limit at B 2, 32/8 heads, D 128 on an H100. So a tile's products run
// from a zeroed accumulator and the running sums take them in f32,
// rounded to nearest; the flash forward's online softmax rescales its sum
// by a in the same instruction.
template <int NV>
__device__ __forceinline__ void add_part(float (*acc)[4],
                                         float (&part)[NV][4],
                                         float a0 = 1.f, float a1 = 1.f) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] = fmaf(acc[i][e], e < 2 ? a0 : a1, part[i][e]);
      part[i][e] = 0.f;
    }
}

// Four int8 values packed in a 32-bit word, lowest byte first, as floats.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float* o) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

// An exact operand: x's bits as they stand (an int8 value, or 0).
__device__ __forceinline__ FragB exact_b(float x0, float x1) {
  FragB b;
  b.hi[0] = __float_as_uint(x0);
  b.hi[1] = __float_as_uint(x1);
  b.lo[0] = b.lo[1] = 0u;
  return b;
}

// Four k-steps of A (16 x 32) from a tile stored [m][k], columns [k0, k0
// + 32): lane (g, t) reads columns k0 + 8t .. k0 + 8t + 7 of rows g and g
// + 8 as float4s; k-step j takes column k0 + 8t + 2j in slot t and k0 +
// 8t + 2j + 1 in slot t + 4 (load_b_nk_x4's order).
__device__ __forceinline__ void load_a_x4(FragA (&a)[4], const float* tile,
                                          int ld, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + 8 * t;
  const float4 u0 = *reinterpret_cast<const float4*>(p);
  const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
  const float4 w0 = *reinterpret_cast<const float4*>(p + 8 * ld);
  const float4 w1 = *reinterpret_cast<const float4*>(p + 8 * ld + 4);
  const float x[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  const float y[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(x[2 * j], a[j].hi[0], a[j].lo[0]);
    split(y[2 * j], a[j].hi[1], a[j].lo[1]);
    split(x[2 * j + 1], a[j].hi[2], a[j].lo[2]);
    split(y[2 * j + 1], a[j].hi[3], a[j].lo[3]);
  }
}

// Four k-steps of B (32 x 8) from a tile stored [n][k] (B's transpose
// row-major, e.g. K for S = Q.K^T), columns [k0, k0 + 32) of rows [0, 8),
// in load_a_x4's order: lane (g, t) reads row g at k0 + 8t .. + 7.
__device__ __forceinline__ void load_b_nk_x4(FragB (&b)[4], const float* tile,
                                             int ld, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + 8 * t;
  const float4 u0 = *reinterpret_cast<const float4*>(p);
  const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
  const float x[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(x[2 * j], b[j].hi[0], b[j].lo[0]);
    split(x[2 * j + 1], b[j].hi[1], b[j].lo[1]);
  }
}

// Two k-steps of A (16 x 16) from a tile stored [m][k], columns [k0, k0
// + 16): load_a_x4 at half the depth, for head_dim 16. Lane (g, t) reads
// columns k0 + 4t .. k0 + 4t + 3 of rows g and g + 8 as float4s; k-step j
// takes column k0 + 4t + 2j in slot t and k0 + 4t + 2j + 1 in slot t + 4
// (load_b_nk_x2's order); free of conflicts at ld = 16 (mod 32).
__device__ __forceinline__ void load_a_x2(FragA (&a)[2], const float* tile,
                                          int ld, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + 4 * t;
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 w = *reinterpret_cast<const float4*>(p + 8 * ld);
  const float x[4] = {u.x, u.y, u.z, u.w};
  const float y[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split(x[2 * j], a[j].hi[0], a[j].lo[0]);
    split(y[2 * j], a[j].hi[1], a[j].lo[1]);
    split(x[2 * j + 1], a[j].hi[2], a[j].lo[2]);
    split(y[2 * j + 1], a[j].hi[3], a[j].lo[3]);
  }
}

// Two k-steps of B (16 x 8) from a tile stored [n][k], in load_a_x2's
// order: lane (g, t) reads row g at k0 + 4t .. + 3.
__device__ __forceinline__ void load_b_nk_x2(FragB (&b)[2], const float* tile,
                                             int ld, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float4 u =
      *reinterpret_cast<const float4*>(tile + g * ld + k0 + 4 * t);
  const float x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split(x[2 * j], b[j].hi[0], b[j].lo[0]);
    split(x[2 * j + 1], b[j].hi[1], b[j].lo[1]);
  }
}

// load_b_nk_x2 from an int8 tile (`ld` in bytes): exact, one 4-byte read
// a lane, free of conflicts at ld = 48 (mod 128) bytes.
__device__ __forceinline__ void load_b_nk_x2_s8(FragB (&b)[2],
                                                const int8_t* tile, int ld,
                                                int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float x[4];
  s8x4_to_f32(*reinterpret_cast<const uint32_t*>(tile + g * ld + k0 + 4 * t),
              x);
#pragma unroll
  for (int j = 0; j < 2; ++j) b[j] = exact_b(x[2 * j], x[2 * j + 1]);
}

// load_b_nk_x4 from an int8 tile (`ld` in bytes, k0 a multiple of 8):
// exact, one 8-byte read a lane, free of conflicts at ld = 32 (mod 64)
// bytes.
__device__ __forceinline__ void load_b_nk_x4_s8(FragB (&b)[4],
                                                const int8_t* tile, int ld,
                                                int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint2 raw =
      *reinterpret_cast<const uint2*>(tile + g * ld + k0 + 8 * t);
  float x[8];
  s8x4_to_f32(raw.x, x);
  s8x4_to_f32(raw.y, x + 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = exact_b(x[2 * j], x[2 * j + 1]);
}

// load_b_kn<4> from an int8 tile stored [k][n] (`ld` in bytes): rows k0 +
// 2t and k0 + 2t + 1, columns n0 + 4g + i for fragment i, one 4-byte read
// a row, exact; free of conflicts at ld = 16 (mod 32) bytes.
__device__ __forceinline__ void load_b_kn4_s8(FragB (&b)[4],
                                              const int8_t* tile, int ld,
                                              int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = tile + (k0 + 2 * t) * ld + n0 + 4 * g;
  float x0[4], x1[4];
  s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), x0);
  s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p + ld), x1);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = exact_b(x0[i], x1[i]);
}

// load_b_kn<2> from an int8 tile stored [k][n] (`ld` in bytes): rows k0 +
// 2t and k0 + 2t + 1, columns n0 + 2g + i for fragment i, one 2-byte read
// a row, exact; free of conflicts at ld = 48 (mod 128) bytes.
__device__ __forceinline__ void load_b_kn2_s8(FragB (&b)[2],
                                              const int8_t* tile, int ld,
                                              int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = tile + (k0 + 2 * t) * ld + n0 + 2 * g;
  const uint32_t r0 = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t r1 = *reinterpret_cast<const uint16_t*>(p + ld);
  float x0[4], x1[4];
  s8x4_to_f32(r0, x0);
  s8x4_to_f32(r1, x1);
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = exact_b(x0[i], x1[i]);
}

// Four A fragments (16 x 8 each) from a tile stored [k][m] (M contiguous:
// the operand that a weight gradient reads transposed, lhs^T), k-rows k0 +
// 2t and k0 + 2t + 1 in load_b_kn's order, 64 values of M from m0. M is
// permuted as load_b_kn permutes N: fragment i takes column m0 + 4g + i of
// the tile as its row g and m0 + 32 + 4g + i as its row g + 8, so a lane
// reads four float4s (two k-rows, two halves of the 64) and the
// accumulator of fragment i holds, on its row h (0: g, 1: g + 8), output
// row m0 + 32 h + 4 g + i. Free of conflicts at ld = 4 (mod 8).
__device__ __forceinline__ void load_a_km4(FragA (&a)[4], const float* tile,
                                           int ld, int k0, int m0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * ld + m0 + 4 * g;
  const float4 u0 = *reinterpret_cast<const float4*>(p);
  const float4 u1 = *reinterpret_cast<const float4*>(p + 32);
  const float4 w0 = *reinterpret_cast<const float4*>(p + ld);
  const float4 w1 = *reinterpret_cast<const float4*>(p + ld + 32);
  const float x0[4] = {u0.x, u0.y, u0.z, u0.w};
  const float x1[4] = {u1.x, u1.y, u1.z, u1.w};
  const float y0[4] = {w0.x, w0.y, w0.z, w0.w};
  const float y1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split(x0[i], a[i].hi[0], a[i].lo[0]);   // row g, slot t
    split(x1[i], a[i].hi[1], a[i].lo[1]);   // row g + 8, slot t
    split(y0[i], a[i].hi[2], a[i].lo[2]);   // row g, slot t + 4
    split(y1[i], a[i].hi[3], a[i].lo[3]);   // row g + 8, slot t + 4
  }
}

// A (16 x 8) from a tile stored [m][k] in load_b_kn's order: column k0 +
// 2t in slot t and k0 + 2t + 1 in slot t + 4, one 8-byte read a row.
__device__ __forceinline__ FragA load_a_pairs(const float* tile, int ld,
                                              int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + 2 * t;
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 w = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float x[4] = {u.x, w.x, u.y, w.y};
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], a.hi[i], a.lo[i]);
  return a;
}

// B (8 x 8) from a tile stored [n][k] in load_b_kn's order (load_a_pairs
// for the other operand): row g at k0 + 2t and k0 + 2t + 1.
__device__ __forceinline__ FragB load_b_nk_pairs(const float* tile, int ld,
                                                 int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 u =
      *reinterpret_cast<const float2*>(tile + g * ld + k0 + 2 * t);
  FragB b;
  split(u.x, b.hi[0], b.lo[0]);
  split(u.y, b.hi[1], b.lo[1]);
  return b;
}

// A (16 x 8) from a tile stored [m][k]: rows [0, 16), columns [k0, k0 + 8).
__device__ __forceinline__ FragA load_a(const float* tile, int ld, int k0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + t;
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], a.hi[i], a.lo[i]);
  return a;
}

// A (16 x 8) from an accumulator C (16 x 8) of an earlier product: the
// product's contraction runs over C's columns in the order 0, 2, 4, 6
// (k = t) and 1, 3, 5, 7 (k = t + 4); load_b_kn reads B's rows in that
// order.
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], a.hi[i], a.lo[i]);
  return a;
}

// B (8 x 8) from a tile stored [n][k] (B's transpose row-major, e.g. K for
// S = Q.K^T): rows [0, 8) of the tile are B's columns, columns [k0, k0 +
// 8) its rows.
__device__ __forceinline__ FragB load_b_nk(const float* tile, int ld, int k0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + t;
  FragB b;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4], b.hi[1], b.lo[1]);
  return b;
}

// NV B fragments (8 x 8 each) from a tile stored [k][n] (e.g. K for dQ =
// dS.K): rows [k0, k0 + 8) in a_from_acc's order, columns [n0, n0 + 8 NV).
// Fragment i takes column n0 + NV g + i as its column g, so a lane reads
// NV adjacent floats of two rows, one vector load each. The accumulator of
// fragment i then holds, for its rows, columns n0 + NV (2t) + i and
// n0 + NV (2t + 1) + i: store_acc_row writes them back in order.
template <int NV>
__device__ __forceinline__ void load_b_kn(FragB (&b)[NV], const float* tile,
                                          int ld, int k0, int n0, int lane) {
  static_assert(NV == 2 || NV == 4, "vector width");
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * ld + n0 + NV * g;
  float x0[NV], x1[NV];
  if constexpr (NV == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    const float4 w = *reinterpret_cast<const float4*>(p + ld);
    x0[0] = u.x; x0[1] = u.y; x0[2] = u.z; x0[3] = u.w;
    x1[0] = w.x; x1[1] = w.y; x1[2] = w.z; x1[3] = w.w;
  } else {
    const float2 u = *reinterpret_cast<const float2*>(p);
    const float2 w = *reinterpret_cast<const float2*>(p + ld);
    x0[0] = u.x; x0[1] = u.y;
    x1[0] = w.x; x1[1] = w.y;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    split(x0[i], b[i].hi[0], b[i].lo[0]);
    split(x1[i], b[i].hi[1], b[i].lo[1]);
  }
}

// Row h (0: g, 1: g + 8) of the NV accumulators that load_b_kn's
// fragments fed, columns [n0, n0 + 8 NV): this lane's 2 NV adjacent
// values, from column n0 + 2 NV t, written to `row` (the row's column 0)
// as vectors.
template <int NV>
__device__ __forceinline__ void store_acc_row(float* row, int n0,
                                              const float (*acc)[4], int h,
                                              int lane) {
  const int t = lane & 3;
  float* p = row + n0 + 2 * NV * t;
  if constexpr (NV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(
        acc[0][2 * h], acc[1][2 * h], acc[2][2 * h], acc[3][2 * h]);
    *reinterpret_cast<float4*>(p + 4) =
        make_float4(acc[0][2 * h + 1], acc[1][2 * h + 1], acc[2][2 * h + 1],
                    acc[3][2 * h + 1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(
        acc[0][2 * h], acc[1][2 * h], acc[0][2 * h + 1], acc[1][2 * h + 1]);
  }
}

}  // namespace
