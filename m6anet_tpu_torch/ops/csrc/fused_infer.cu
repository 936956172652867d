// Fused inference step of the production m6A MIL model, hand-written for
// Hopper (sm_90a).
//
// Replaces: m6anet_tpu/ops/fused_infer_kernel.py:397 (fused_inference_t)
//
// What it computes, for a batch packed by data/batching.py::pack_sites
// (site s owns the contiguous reads [offsets[s], offsets[s] + counts[s]);
// padding reads sit past sum(counts) and padding sites have count 0):
//
//   per read r   x = [features[r, 0:9], emb[k0], emb[k1], emb[k2]]   (15)
//                h1 = relu(W1' x + b1')     (150; eval BatchNorm folded in)
//                h2 = relu(W2 h1 + b2)      (32)
//                p[r] = sigmoid(w3 . h2 + b3)
//   per site s   site_p[s]    = 1 - (sum(1 - p) / max(n, 1)) ** n_samples
//                mod_ratio[s] = #{p >= threshold} / max(n, 1)
//
// Padding sites give site_p = 1 and mod_ratio = 0, as the TPU kernel does.
//
// Bound on the card.  Each read costs 2 * (15*150 + 150*32 + 32) = 14,164
// f32 FLOP and moves 43 bytes (36 B of features, 3 B of int8 k-mer ids, 4 B
// of p): ~330 FLOP per byte, far above the H100's ~20 FLOP/B f32 ridge
// (67 TFLOP/s over 3.35 TB/s on the SXM part), so the step is bound by the
// f32 CUDA cores: ~0.22 ms for a 1,048,576-read batch on an H100 SXM.  The
// per-site phase reads p once more (4 B per read) and is negligible.
//
// What this design does about it:
//  * Phase A, one thread per read (grid-stride).  All ~30 KB of weights are
//    staged in shared memory once per block and read as warp-uniform float4
//    broadcasts, so every FFMA takes its weight from a broadcast load with
//    no bank conflicts.  For each of the 150 hidden units the thread forms
//    h1_k from its 15 inputs in registers and folds it at once into 32
//    register accumulators of layer 2: h1 never leaves registers, and the
//    only device-memory traffic is the inputs once and p once.  The k-mer
//    embedding is a direct table read with the int8 id (no one-hot).  The
//    loop order is fixed, so p is deterministic.
//  * Phase B, one warp per site.  Lanes walk the site's span in a fixed
//    stride, accumulate sum(1 - p) in f64 and the hit count in int, and a
//    fixed-shape shuffle tree combines them: no float atomics, so repeat
//    runs are bit-identical.  (The f64 sum makes the site mean independent
//    of the summation order; the plain PyTorch version sums in f64 too.)
//    The power is the binary exponentiation XLA uses for an integer power.
//  * Tensor cores (a 150x15 and a 32x150 product per read would suit
//    wgmma in TF32 only at a loss of parity), TMA staging of the read
//    stream and fusing the two phases into one launch are left for later.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// without --use_fast_math (expf and f32 division stay IEEE-accurate).
// Plain C interface, called through ctypes from ops/fused_infer_kernel.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFeat = 9;     // signal features per read
constexpr int kPos = 3;      // k-mer positions per read
constexpr int kVocab = 66;   // k-mer vocabulary
constexpr int kEmb = 2;      // embedding width
constexpr int kIn = kFeat + kPos * kEmb;  // 15
constexpr int kH1 = 150;
constexpr int kH2 = 32;

// Packed weight image (floats), written by prepare_fused_params_t:
//   W1B [150][16]  row k = BN-folded W1'[k, 0:15], then b1'[k]
//   EMB [66][2]    embedding table
//   W2  [150][32]  row k = W2[:, k]  (hidden unit k's fan-out)
//   B2  [32], W3 [32], B3 [1], zero padding to a multiple of 4
constexpr int kW1Stride = 16;
constexpr int kOffW1B = 0;
constexpr int kOffEmb = kOffW1B + kH1 * kW1Stride;  // 2400
constexpr int kOffW2 = kOffEmb + kVocab * kEmb;     // 2532
constexpr int kOffB2 = kOffW2 + kH1 * kH2;          // 7332
constexpr int kOffW3 = kOffB2 + kH2;                // 7364
constexpr int kOffB3 = kOffW3 + kH2;                // 7396
constexpr int kWeights = 7400;
static_assert(kOffW2 % 4 == 0 && kWeights % 4 == 0, "float4 alignment");
static_assert(kIn + 1 == kW1Stride, "W1B row holds 15 weights and a bias");

constexpr int kReadThreads = 256;
constexpr int kSiteThreads = 256;  // 8 warps: 8 sites per block

// kmer_ids are int8 ids in [0, 66); the Python wrapper checks the range
__global__ void __launch_bounds__(kReadThreads, 2)
read_prob_kernel(const float* __restrict__ features,
                 const int8_t* __restrict__ kmer_ids,
                 const float* __restrict__ weights, int64_t n_reads,
                 float* __restrict__ p_out) {
  __shared__ __align__(16) float w[kWeights];
  for (int i = threadIdx.x; i < kWeights / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(weights)[i];
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n_reads; r += stride) {
    float x[kIn];
    const float* f = features + r * kFeat;
#pragma unroll
    for (int i = 0; i < kFeat; ++i) x[i] = __ldg(f + i);
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const int k = static_cast<int>(kmer_ids[r * kPos + j]);
      x[kFeat + kEmb * j] = w[kOffEmb + kEmb * k];
      x[kFeat + kEmb * j + 1] = w[kOffEmb + kEmb * k + 1];
    }

    float acc[kH2];
#pragma unroll
    for (int j = 0; j < kH2; ++j) acc[j] = 0.f;

#pragma unroll 2
    for (int k = 0; k < kH1; ++k) {
      const float4* row = reinterpret_cast<const float4*>(w + kOffW1B + k * kW1Stride);
      const float4 a = row[0], b = row[1], c = row[2], d = row[3];
      float h = a.x * x[0];
      h = fmaf(a.y, x[1], h);
      h = fmaf(a.z, x[2], h);
      h = fmaf(a.w, x[3], h);
      h = fmaf(b.x, x[4], h);
      h = fmaf(b.y, x[5], h);
      h = fmaf(b.z, x[6], h);
      h = fmaf(b.w, x[7], h);
      h = fmaf(c.x, x[8], h);
      h = fmaf(c.y, x[9], h);
      h = fmaf(c.z, x[10], h);
      h = fmaf(c.w, x[11], h);
      h = fmaf(d.x, x[12], h);
      h = fmaf(d.y, x[13], h);
      h = fmaf(d.z, x[14], h);
      h = fmaxf(h + d.w, 0.f);  // + b1'[k], relu
      const float4* fan = reinterpret_cast<const float4*>(w + kOffW2 + k * kH2);
#pragma unroll
      for (int q = 0; q < kH2 / 4; ++q) {
        const float4 v = fan[q];
        acc[4 * q] = fmaf(v.x, h, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, h, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, h, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, h, acc[4 * q + 3]);
      }
    }

    float z = 0.f;
#pragma unroll
    for (int j = 0; j < kH2; ++j) {
      z = fmaf(w[kOffW3 + j], fmaxf(acc[j] + w[kOffB2 + j], 0.f), z);
    }
    z += w[kOffB3];
    const float p = 1.f / (1.f + expf(-z));
    p_out[r] = p;
  }
}

// x ** n by binary exponentiation, in the multiplication order of XLA's
// integer_pow (so the JAX package and this kernel round alike)
__device__ __forceinline__ float integer_pow(float x, int n) {
  float acc = 1.f;
  bool first = true;
  while (n > 0) {
    if (n & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return acc;
}

__global__ void __launch_bounds__(kSiteThreads)
site_reduce_kernel(const float* __restrict__ p, const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ counts, int64_t n_reads,
                   int64_t n_sites, float threshold, int n_samples,
                   float* __restrict__ site_p, float* __restrict__ mod_ratio) {
  const int64_t site = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (site >= n_sites) return;  // uniform across the warp
  const int n = counts[site];
  const int64_t begin = offsets[site];
  const int64_t stop = begin + (n > 0 ? n : 0);
  const int64_t end = stop < n_reads ? stop : n_reads;

  double sum = 0.0;
  int hits = 0;
  for (int64_t i = begin + lane; i < end; i += 32) {
    const float v = p[i];
    sum += static_cast<double>(1.f - v);
    hits += v >= threshold ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    hits += __shfl_down_sync(0xffffffffu, hits, o);
  }
  if (lane == 0) {
    const double cnt = n > 1 ? static_cast<double>(n) : 1.0;
    const float mean = static_cast<float>(sum / cnt);
    site_p[site] = 1.f - integer_pow(mean, n_samples);
    mod_ratio[site] = static_cast<float>(hits) / static_cast<float>(cnt);
  }
}

cudaError_t launch_read_prob(const float* features, const int8_t* kmer_ids,
                             const float* weights, int64_t n_reads, float* p,
                             cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, read_prob_kernel, kReadThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int64_t needed = (n_reads + kReadThreads - 1) / kReadThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  read_prob_kernel<<<grid, kReadThreads, 0, stream>>>(features, kmer_ids, weights, n_reads, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One inference step: phase A (per-read p) then phase B (per-site
// reductions), both on `stream`.  Returns the CUDA error code of the
// launches (0 = success).
int fused_infer_launch(const float* features, const int8_t* kmer_ids,
                       const int32_t* offsets, const int32_t* counts,
                       const float* weights, float* p, float* site_p,
                       float* mod_ratio, int64_t n_reads, int64_t n_sites,
                       float threshold, int n_samples, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  if (n_reads > 0) {
    err = launch_read_prob(features, kmer_ids, weights, n_reads, p, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_sites > 0) {
    const int64_t warps_per_block = kSiteThreads / 32;
    const int64_t blocks = (n_sites + warps_per_block - 1) / warps_per_block;
    site_reduce_kernel<<<static_cast<unsigned>(blocks), kSiteThreads, 0, stream>>>(
        p, offsets, counts, n_reads, n_sites, threshold, n_samples, site_p, mod_ratio);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* fused_infer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
