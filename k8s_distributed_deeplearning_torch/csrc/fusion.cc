// Host runtime core of the PyTorch port: the gradient-fusion planner,
// Horovod's C++ tensor-fusion machinery (the reference builds Horovod
// 0.19.0's native core at horovod/Dockerfile:64-65; its fusion buffer
// batches small gradients into few large allreduces, with an autotuner
// picking the buffer size). A copy of the JAX package's native/fusion.cc,
// built on its own by ops/_build.py (c++, plain C interface, ctypes).
//
// NCCL owns collective *execution*; this file owns what Horovod's core
// owned outside the framework's kernels:
//   1. plan_buckets      — greedy gradient->fusion-bucket assignment under a
//                          byte threshold (arrival order, Horovod semantics).
//   2. autotune_threshold — pick the bucket byte-threshold minimizing an
//                          alpha-beta (latency-bandwidth) ring-allreduce cost
//                          model, the analytic form of Horovod's autotuner.
//   3. probe_memcpy_bw   — host memory bandwidth probe (bytes/sec).
//
// C ABI (ctypes-consumed from runtime/fusion.py); no Python dependencies.

#include <cstdint>
#include <cstring>
#include <chrono>
#include <vector>

extern "C" {

// Assign each of n tensors (sizes[i] bytes, arrival order) to a bucket such
// that no bucket exceeds threshold bytes (a tensor larger than the threshold
// gets its own bucket). Writes bucket ids to out[i]; returns bucket count.
int64_t plan_buckets(const int64_t* sizes, int64_t n, int64_t threshold,
                     int64_t* out) {
  if (n <= 0) return 0;
  int64_t bucket = 0;
  int64_t filled = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = sizes[i];
    if (filled > 0 && filled + s > threshold) {
      ++bucket;
      filled = 0;
    }
    out[i] = bucket;
    filled += s;
    if (filled >= threshold) {  // close an exactly-full / oversized bucket
      ++bucket;
      filled = 0;
    }
  }
  // bucket index of the last tensor + 1 == number of buckets
  return out[n - 1] + 1;
}

// Ring-allreduce time for `bytes` over `world` ranks under the alpha-beta
// model: 2(w-1) latency hops + 2(w-1)/w of the payload over the bandwidth.
static double ring_allreduce_seconds(double bytes, int64_t world,
                                     double alpha_s, double beta_s_per_byte) {
  if (world <= 1) return 0.0;
  const double w = static_cast<double>(world);
  return 2.0 * (w - 1.0) * alpha_s + 2.0 * (w - 1.0) / w * bytes * beta_s_per_byte;
}

// Total modeled step-communication time if gradients `sizes` are fused under
// `threshold`: each bucket costs one ring allreduce.
double model_comm_seconds(const int64_t* sizes, int64_t n, int64_t threshold,
                          int64_t world, double alpha_s,
                          double beta_s_per_byte) {
  if (n <= 0) return 0.0;
  std::vector<int64_t> ids(static_cast<size_t>(n));
  const int64_t nbuckets = plan_buckets(sizes, n, threshold, ids.data());
  std::vector<double> bucket_bytes(static_cast<size_t>(nbuckets), 0.0);
  for (int64_t i = 0; i < n; ++i) bucket_bytes[static_cast<size_t>(ids[i])] += static_cast<double>(sizes[i]);
  double total = 0.0;
  for (double b : bucket_bytes)
    total += ring_allreduce_seconds(b, world, alpha_s, beta_s_per_byte);
  return total;
}

// Sweep power-of-two thresholds in [min_threshold, max_threshold] and return
// the one minimizing the modeled communication time.
int64_t autotune_threshold(const int64_t* sizes, int64_t n, int64_t world,
                           double alpha_s, double beta_s_per_byte,
                           int64_t min_threshold, int64_t max_threshold) {
  if (min_threshold < 1) min_threshold = 1;  // t *= 2 must make progress
  int64_t best = min_threshold;
  double best_t = -1.0;
  for (int64_t t = min_threshold; t <= max_threshold; t *= 2) {
    const double cost = model_comm_seconds(sizes, n, t, world, alpha_s,
                                           beta_s_per_byte);
    if (best_t < 0.0 || cost < best_t) {
      best_t = cost;
      best = t;
    }
  }
  return best;
}

// Measure host memcpy bandwidth (bytes/sec) over `bytes` copied `iters`
// times.
double probe_memcpy_bw(int64_t bytes, int64_t iters) {
  if (bytes <= 0 || iters <= 0) return 0.0;
  std::vector<char> src(static_cast<size_t>(bytes), 1);
  std::vector<char> dst(static_cast<size_t>(bytes), 0);
  // Warm both buffers into cache/TLB.
  std::memcpy(dst.data(), src.data(), static_cast<size_t>(bytes));
  const auto t0 = std::chrono::steady_clock::now();
  for (int64_t i = 0; i < iters; ++i) {
    std::memcpy(dst.data(), src.data(), static_cast<size_t>(bytes));
    src[0] = static_cast<char>(i);  // defeat dead-copy elimination
  }
  const auto t1 = std::chrono::steady_clock::now();
  const double secs = std::chrono::duration<double>(t1 - t0).count();
  if (secs <= 0.0) return 0.0;
  return static_cast<double>(bytes) * static_cast<double>(iters) / secs;
}

}  // extern "C"
