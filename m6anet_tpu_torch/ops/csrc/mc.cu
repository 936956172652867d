// Monte-Carlo site probability with draws shared by all sites, hand-written
// for Hopper (sm_90a).
//
// Replaces: m6anet_tpu/ops/mc_kernel.py:269 (site_probability_mc_pallas, whose pallas_call is mc_chunk_call at :199)
//
// What it computes, for a batch packed by data/batching.py::pack_sites (site
// s owns the contiguous reads [offsets[s], offsets[s] + counts[s])) and the
// shared draws U (n_samples, n_iters) of ops/random.py::shared_draws:
//
//   per site s with c = counts[s] >= 1
//     l[r]      = max(log1p(-p[offsets[s] + r]), -1e4)            r < c
//     S_t       = sum_{j < n_samples} l[min(trunc(U[j, t] * c), c - 1)]
//     site_p[s] = 1 - (1 / n_iters) * sum_t exp(S_t)
//   count 0 gives 0.
//
// exp(S_t) is the product of the iteration's 20 draws of (1 - p), so this is
// the reference's estimator, 1 - mean_t prod_j (1 - p_draw)
// (reference: m6anet/utils/inference_utils.py:74-87).  The -1e4 clamp keeps
// a read with p == 1 finite, as the TPU kernel does; trunc(U * c) is the f32
// product truncated to int32, as there.
//
// Bound on the card, counting what a batch's real sites need (S' sites with
// a count >= 1, R of their reads, T iterations, 20 draws):
//   operations  S' * T * (20 adds + 1 exp) + R log1p
//               ~3.4e8 at the production batch (16,384 sites, T = 1000),
//               ~5 us at 67 TFLOP/s f32;
//   bytes       p once (4 R), U once (80 T), offsets and counts (8 S),
//               site_p (4 S): ~4.3 MB, ~1.3 us at 3.35 TB/s;
// so the bound is the operations', ~5 us.  The kernel cannot come near it:
// each of its S' * T * 20 = 3.3e8 draws is a gather from shared memory, and
// an SM issues 32 shared-memory loads a clock.  That gather count over the
// 132 SMs' load rate (32 x 132 x 1.98 GHz) is a second figure, ~40 us, and
// bank conflicts of random gathers raise it further.
//
// What this design does about it:
//  * One block per site.  Its c values of l are staged once in dynamic
//    shared memory, sized at each launch to the batch's largest count (4 KB
//    at dataprep's default cap of 1,000 reads), so each draw is one
//    shared-memory load, with no one-hot or histogram matmul.
//  * Threads stride over the iterations t, so the loads of U[j, t] are
//    coalesced along t; U (80 KB at T = 1000) stays in L2 and L1 for every
//    block.  Each thread sums its 20 draws in the fixed order j = 0..19 in
//    f32 and adds exp of that sum to an f64 accumulator.
//  * A fixed-shape reduction (a shuffle tree per warp, then the warps in
//    order) combines the accumulators: no float atomics, so repeat runs are
//    bit-identical.
//  * The TPU kernel's count sort, run decomposition, bf16 hi/lo split, draw
//    histograms and lane-shift alignment existed to turn the gathers into
//    MXU work; Hopper gathers from shared memory directly.  Sharing U loads
//    across several sites of a block is left for later.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// without --use_fast_math (log1pf and expf stay accurate).  Plain C
// interface, called through ctypes from ops/mc_kernel.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
mc_site_kernel(const float* __restrict__ p, const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ counts, const float* __restrict__ u,
               int n_iters, int n_samples, float* __restrict__ site_p) {
  extern __shared__ float l[];  // [max_count]
  __shared__ double partial[kWarps];
  const int64_t site = blockIdx.x;
  const int c = counts[site];
  if (c <= 0) {  // uniform across the block
    if (threadIdx.x == 0) site_p[site] = 0.f;
    return;
  }
  const float* ps = p + offsets[site];
  for (int r = threadIdx.x; r < c; r += kThreads) {
    const float v = log1pf(-ps[r]);
    l[r] = v < -1e4f ? -1e4f : v;  // a NaN stays NaN
  }
  __syncthreads();

  const float cf = static_cast<float>(c);
  double acc = 0.0;
  for (int t = threadIdx.x; t < n_iters; t += kThreads) {
    float s = 0.f;
    for (int j = 0; j < n_samples; ++j) {
      const float draw = __ldg(u + static_cast<int64_t>(j) * n_iters + t);
      const int idx = static_cast<int>(draw * cf);  // truncation, as int32 casts
      s += l[idx < c - 1 ? idx : c - 1];
    }
    acc += static_cast<double>(expf(s));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w];
    site_p[site] = static_cast<float>(1.0 - total / n_iters);
  }
}

}  // namespace

extern "C" {

// MC site probabilities of n_sites sites on `stream`.  The caller passes
// the largest count, checks it against the shared memory a block may hold,
// and checks that every span lies inside p.  Returns the CUDA error code of
// the launch (0 = success).
int mc_site_launch(const float* p, const int32_t* offsets, const int32_t* counts,
                   const float* u, float* site_p, int64_t n_sites, int n_iters,
                   int n_samples, int max_count, void* stream_ptr) {
  if (n_sites <= 0) return static_cast<int>(cudaSuccess);
  const size_t shared = static_cast<size_t>(max_count > 0 ? max_count : 1) * sizeof(float);
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_site_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  mc_site_kernel<<<static_cast<unsigned>(n_sites), kThreads, shared, stream>>>(
      p, offsets, counts, u, n_iters, n_samples, site_p);
  return static_cast<int>(cudaGetLastError());
}

const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
