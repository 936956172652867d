// Phase A of the fused inference step in its two reduced-precision modes,
// f32x3 and bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces: m6anet_tpu/ops/fused_infer_kernel.py:397 (fused_inference_t, compute_dtype f32x3 / bf16)
//
// Its entry point read_prob_tc_launch is phase A of the same two modes of
// three TPU kernels; the two fused ones follow it with phase B of
// fused_infer.cu (site_reduce_launch, unchanged), and all three follow
// fused_inference_t's arithmetic (see ops/fused_infer_kernel.py):
//   fused_inference_t       m6anet_tpu/ops/fused_infer_kernel.py:397 (body :304-348)
//   fused_read_probability  m6anet_tpu/ops/encoder_kernel.py:207 (policies :108-193)
//   fused_inference         m6anet_tpu/ops/fused_infer_kernel.py:134 (body :83-92)
//
// What it computes, per read r (x = [features[r, 0:9], emb[k0], emb[k1],
// emb[k2]], eval BatchNorm folded into W1', b1'), as the JAX kernel
// _fused_infer_kernel_t (m6anet_tpu/ops/fused_infer_kernel.py:304-348):
//
//   f32x3  emb value hi + lo (hi = bf16(e), lo = bf16(e - hi));
//          h1 = relu(W1' x + b1') in full f32, in fused_infer.cu's operation
//          order; h2 = relu(((W2lo.h1hi + W2hi.h1lo) + W2hi.h1hi) + b2);
//          z = ((w3lo.h2hi + w3hi.h2lo) + w3hi.h2hi) + b3
//   bf16   emb value bf16(e); h1 = relu(bf16(W1') bf16(x) + b1');
//          h2 = relu(bf16(W2) bf16(h1) + b2); z = bf16(w3) bf16(h2) + b3
//   p[r] = 1 / (1 + expf(-z))
//
// with hi/lo splits rounded to nearest even and every product summed in f32.
//
// Bound on an H100 SXM (1,048,576 reads): the reads move 45 MB (0.0135 ms
// at 3.35 TB/s).  f32x3: layer 1 is 4.72 GFLOP on the FP32 cores (0.070 ms
// at 67 TFLOP/s), the three-pass layer 2 and the head 30.4 GFLOP of bf16 on
// the tensor cores (0.031 ms at 989 TFLOP/s, another pipe): 0.070 ms.
// bf16: 14.85 GFLOP of bf16, 0.015 ms.
//
// Design (a simple, correct first kernel; wgmma, TMA and one launch for
// both phases are later work):
//  * A warp takes 16 reads at a time, the M dimension of
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  Lane l is group
//    g = l / 4, thread t = l % 4 of the fragments: it owns reads g and g + 8
//    of the tile.  The weights are staged once per block in shared memory,
//    laid out by prepare_fused_params_t in fragment order, so every operand
//    load is one conflict-free LDS.64 (B fragments) or LDS.128 (f32 rows).
//    Hidden units are padded 150 -> 160 with zero weights and zero bias.
//  * bf16: layer 1 (K = 15 padded to 16, bias never folded into the bf16
//    operand) is one mma per n8 tile.  The f32 accumulators of n8 tiles 2j
//    and 2j + 1 are exactly the A fragment of layer 2's k16 step j: after
//    bias and relu they convert in registers, so h1 never leaves them.
//  * f32x3: layer 1 stays on the FP32 cores.  Each lane computes exactly
//    the h1 values its A fragment holds (2 reads x 4 units per k step),
//    splits them into bf16 hi and lo, and runs three mma per n8 tile
//    against the pre-split W2.
//  * Sums.  The tensor cores add a k16 step's products and truncate the
//    sum toward zero, so accumulating ten steps in the mma's C operand
//    drifts by several ulp of h2 in one direction.  The hi.hi (f32x3) or
//    bf16 product of each k step therefore goes into a zero accumulator
//    and is added to the running sum with an f32 add, in step order; the
//    plain version sums the same k16 chunks, truncated.  The small cross
//    terms of f32x3 (2^-8 of the sum) accumulate in C.
//  * The head (32 -> 1) is a dot over the lane's 8 entries of layer 2's
//    accumulator fragment, summed across the quad with two xor shuffles,
//    so all four lanes hold the same z; lane 0 stores read g, lane 1 read
//    g + 8.  Past the end of the batch a lane reads the last read again and
//    stores nothing.  Repeats are bit-identical (no atomics).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// without --use_fast_math.  Plain C interface, called through ctypes from
// ops/fused_infer_kernel.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFeat = 9;
constexpr int kPos = 3;
constexpr int kVocab = 66;
constexpr int kEmb = 2;
constexpr int kIn = kFeat + kPos * kEmb;  // 15
constexpr int kH1Pad = 160;               // 150 hidden units, zero padded
constexpr int kH2 = 32;
constexpr int kKSteps = 10;   // layer 2's k16 steps
constexpr int kTiles1 = 20;   // layer 1's n8 tiles (bf16)
constexpr int kTiles2 = 4;    // layer 2's n8 tiles
static_assert(kKSteps * 16 == kH1Pad && kTiles1 * 8 == kH1Pad && kTiles2 * 8 == kH2, "tiles");

// Weight image (32-bit words), written by prepare_fused_params_t (lane l =
// 4g + t; a bf16x2 word holds the smaller k in its low half):
//   W1F  [10 k steps][4 slots c][4 quads q][4 threads t] float4: f32x3
//        layer 1, floats 4q..4q+3 of row u = 16j + 2t + (c & 1) + 8 (c >> 1)
//        of [W1'[u, 0:15], b1'[u]] (zero for u >= 150)
//   EMBX [66][2] f32: hi + lo of the embedding (f32x3)
//   W3L  [32] f32: bf16(w3 - bf16(w3)) (f32x3)
//   W2L  [10 k steps][4 n tiles][32 lanes][2] bf16x2: B fragments of
//        W2 - bf16(W2) (f32x3); n = 8 tile + g, k = 16 step + 2t + 8 reg + half
//   W2H  the same for bf16(W2) (both modes)
//   B2 [32], W3H [32] bf16(w3), B3 [1] + zero padding (both modes)
//   W1H  [20 n tiles][32 lanes][2] bf16x2: B fragments of layer 1 (bf16),
//        n = 8 tile + g, k = 2t + 8 reg + half; k = 15 is zero
//   B1   [160] f32: b1', zero past 150 (bf16)
//   EMBH [66][2] f32: bf16(e) (bf16)
constexpr int kTcOffW1F = 0;
constexpr int kTcOffEmbX = kTcOffW1F + kKSteps * 4 * 4 * 4 * 4;   // 2560
constexpr int kTcOffW3L = kTcOffEmbX + kVocab * kEmb;             // 2692
constexpr int kTcOffW2L = kTcOffW3L + kH2;                        // 2724
constexpr int kTcOffW2H = kTcOffW2L + kKSteps * kTiles2 * 32 * 2;  // 5284
constexpr int kTcOffB2 = kTcOffW2H + kKSteps * kTiles2 * 32 * 2;   // 7844
constexpr int kTcOffW3H = kTcOffB2 + kH2;                         // 7876
constexpr int kTcOffB3 = kTcOffW3H + kH2;                         // 7908
constexpr int kTcOffW1H = kTcOffB3 + 4;                           // 7912
constexpr int kTcOffB1 = kTcOffW1H + kTiles1 * 32 * 2;            // 9192
constexpr int kTcOffEmbH = kTcOffB1 + kH1Pad;                     // 9352
constexpr int kTcWords = kTcOffEmbH + kVocab * kEmb;              // 9484

// Each mode stages one contiguous range of the image: f32x3 everything
// before W1H, bf16 everything from W2H on.
constexpr int kModeF32x3 = 1;
constexpr int kModeBf16 = 2;
static_assert(kTcOffW2L % 4 == 0 && kTcOffW2H % 4 == 0 && kTcOffW1H % 4 == 0 && kTcWords % 4 == 0,
              "16-byte aligned ranges");

constexpr int kThreads = 256;  // 8 warps, 16 reads each per step
constexpr int kMinBlocks = 2;
// unrolling of the loop over layer 2's k steps.  scripts/sweep_read_prob_tc.py
// rewrites it and kMinBlocks; on an H100 SXM at the production batch (f32x3 /
// bf16 ms): unroll 1 at 2 blocks/SM 0.2916 / 0.0993, unroll 2 0.2852 /
// 0.0934, full 0.2959 / 0.0966; 3 blocks/SM (f32x3 spills) 0.3165 / 0.0992;
// 1 block/SM 0.2915 / 0.0926, unroll 2 there 0.3183 / 0.0917.
constexpr int kStepUnroll = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kTileReads = 16;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// two floats rounded to bf16 in one operand register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// hi = bf16(a), lo = bf16(a - hi) of a pair, packed as two operand registers
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  const float ah = bf16_round(a), bh = bf16_round(b);
  hi = pack_bf16x2(ah, bh);
  lo = pack_bf16x2(a - ah, b - bh);
}

// d = a . b + d over one m16n8k16 tile, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// sum += a . b over one k16 step, through a zero accumulator
__device__ __forceinline__ void mma_step(float (&sum)[4], const uint32_t (&a)[4], uint2 b) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(part, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] += part[i];
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the 15 inputs of read r, with the mode's embedding table `emb` (shared)
__device__ __forceinline__ void load_inputs(const float* __restrict__ features,
                                            const int8_t* __restrict__ kmer_ids,
                                            const float* emb, int64_t r, float (&x)[kIn]) {
  const float* f = features + r * kFeat;
#pragma unroll
  for (int i = 0; i < kFeat; ++i) x[i] = __ldg(f + i);
#pragma unroll
  for (int q = 0; q < kPos; ++q) {
    const int k = static_cast<int>(kmer_ids[r * kPos + q]);
    x[kFeat + kEmb * q] = emb[kEmb * k];
    x[kFeat + kEmb * q + 1] = emb[kEmb * k + 1];
  }
}

// input column c (0..15; 15 is the zero padding) of read r
__device__ __forceinline__ float input_col(const float* __restrict__ features,
                                           const int8_t* __restrict__ kmer_ids,
                                           const float* emb, int64_t r, int c) {
  if (c < kFeat) return __ldg(features + r * kFeat + c);
  if (c >= kIn) return 0.f;
  const int k = static_cast<int>(kmer_ids[r * kPos + (c - kFeat) / kEmb]);
  return emb[kEmb * k + (c - kFeat) % kEmb];
}

// z of reads g and g + 8 (rows l0, l1), f32x3; s is the staged range [0, W1H)
__device__ __forceinline__ void f32x3_reads(const float* __restrict__ features,
                                            const int8_t* __restrict__ kmer_ids,
                                            const uint32_t* s, int64_t l0, int64_t l1,
                                            int lane, float (&z)[2]) {
  const float* sf = reinterpret_cast<const float*>(s);
  const int t = lane & 3;
  float x[2][kIn];
  load_inputs(features, kmer_ids, sf + kTcOffEmbX, l0, x[0]);
  load_inputs(features, kmer_ids, sf + kTcOffEmbX, l1, x[1]);

  float cross[kTiles2][4] = {};  // W2lo.h1hi + W2hi.h1lo, accumulated in C
  float high[kTiles2][4] = {};   // W2hi.h1hi, summed per k step
  const float4* w1 = reinterpret_cast<const float4*>(sf + kTcOffW1F);
  const uint2* w2l = reinterpret_cast<const uint2*>(s + kTcOffW2L);
  const uint2* w2h = reinterpret_cast<const uint2*>(s + kTcOffW2H);
#pragma unroll (kStepUnroll)
  for (int j = 0; j < kKSteps; ++j) {
    float h[4][2];  // [slot c][read]: units 16j + 2t + (c & 1) + 8 (c >> 1)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4* row = w1 + (j * 4 + c) * 16 + t;  // [j][c][q][t]
      const float4 a = row[0], b = row[4], cc = row[8], d = row[12];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* in = x[i];
        float u = a.x * in[0];  // fused_infer.cu's order
        u = fmaf(a.y, in[1], u);
        u = fmaf(a.z, in[2], u);
        u = fmaf(a.w, in[3], u);
        u = fmaf(b.x, in[4], u);
        u = fmaf(b.y, in[5], u);
        u = fmaf(b.z, in[6], u);
        u = fmaf(b.w, in[7], u);
        u = fmaf(cc.x, in[8], u);
        u = fmaf(cc.y, in[9], u);
        u = fmaf(cc.z, in[10], u);
        u = fmaf(cc.w, in[11], u);
        u = fmaf(d.x, in[12], u);
        u = fmaf(d.y, in[13], u);
        u = fmaf(d.z, in[14], u);
        h[c][i] = fmaxf(u + d.w, 0.f);  // + b1', relu
      }
    }
    // A fragment of k step j: {read g, read g + 8} x {units 2t.., 2t + 8..}
    uint32_t ahi[4], alo[4];
    split_pack(h[0][0], h[1][0], ahi[0], alo[0]);
    split_pack(h[0][1], h[1][1], ahi[1], alo[1]);
    split_pack(h[2][0], h[3][0], ahi[2], alo[2]);
    split_pack(h[2][1], h[3][1], ahi[3], alo[3]);
#pragma unroll
    for (int nt = 0; nt < kTiles2; ++nt) {
      const uint2 bl = w2l[(j * kTiles2 + nt) * 32 + lane];
      const uint2 bh = w2h[(j * kTiles2 + nt) * 32 + lane];
      mma_bf16(cross[nt], ahi, bl);
      mma_bf16(cross[nt], alo, bh);
      mma_step(high[nt], ahi, bh);
    }
  }

  // head: this lane's h2 entries n = 8 nt + 2t + e of reads g (i = 0), g + 8
  float zx[2][2] = {}, zh[2] = {};  // w3lo.h2hi, w3hi.h2lo; w3hi.h2hi
#pragma unroll
  for (int nt = 0; nt < kTiles2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nt + 2 * t + e;
      const float b2 = sf[kTcOffB2 + n], w3h = sf[kTcOffW3H + n], w3l = sf[kTcOffW3L + n];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = fmaxf(cross[nt][2 * i + e] + high[nt][2 * i + e] + b2, 0.f);
        const float vh = bf16_round(v), vl = bf16_round(v - vh);
        zx[i][0] = fmaf(w3l, vh, zx[i][0]);
        zx[i][1] = fmaf(w3h, vl, zx[i][1]);
        zh[i] = fmaf(w3h, vh, zh[i]);
      }
    }
  }
  const float b3 = sf[kTcOffB3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    z[i] = ((quad_sum(zx[i][0]) + quad_sum(zx[i][1])) + quad_sum(zh[i])) + b3;
  }
}

// z of reads g and g + 8 (rows l0, l1), bf16; s is the staged range [W2H, end)
__device__ __forceinline__ void bf16_reads(const float* __restrict__ features,
                                           const int8_t* __restrict__ kmer_ids,
                                           const uint32_t* s, int64_t l0, int64_t l1,
                                           int lane, float (&z)[2]) {
  constexpr int kBase = kTcOffW2H;
  const float* sf = reinterpret_cast<const float*>(s);
  const float* emb = sf + (kTcOffEmbH - kBase);
  const int t = lane & 3;
  // layer 1's A fragment: columns 2t, 2t + 1, 2t + 8, 2t + 9 of reads g, g + 8
  uint32_t a1[4];
  a1[0] = pack_bf16x2(input_col(features, kmer_ids, emb, l0, 2 * t),
                      input_col(features, kmer_ids, emb, l0, 2 * t + 1));
  a1[1] = pack_bf16x2(input_col(features, kmer_ids, emb, l1, 2 * t),
                      input_col(features, kmer_ids, emb, l1, 2 * t + 1));
  a1[2] = pack_bf16x2(input_col(features, kmer_ids, emb, l0, 2 * t + 8),
                      input_col(features, kmer_ids, emb, l0, 2 * t + 9));
  a1[3] = pack_bf16x2(input_col(features, kmer_ids, emb, l1, 2 * t + 8),
                      input_col(features, kmer_ids, emb, l1, 2 * t + 9));

  const uint2* w1h = reinterpret_cast<const uint2*>(s + (kTcOffW1H - kBase));
  const uint2* w2h = reinterpret_cast<const uint2*>(s + (kTcOffW2H - kBase));
  const float2* b1 = reinterpret_cast<const float2*>(sf + (kTcOffB1 - kBase));
  float acc[kTiles2][4] = {};
#pragma unroll (kStepUnroll)
  for (int j = 0; j < kKSteps; ++j) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};  // n8 tiles 2j, 2j + 1
    mma_bf16(c0, a1, w1h[(2 * j) * 32 + lane]);
    mma_bf16(c1, a1, w1h[(2 * j + 1) * 32 + lane]);
    const float2 bl = b1[8 * j + t], bh = b1[8 * j + 4 + t];  // units 16j + 2t.., 16j + 8 + 2t..
    uint32_t a2[4];
    a2[0] = pack_bf16x2(fmaxf(c0[0] + bl.x, 0.f), fmaxf(c0[1] + bl.y, 0.f));
    a2[1] = pack_bf16x2(fmaxf(c0[2] + bl.x, 0.f), fmaxf(c0[3] + bl.y, 0.f));
    a2[2] = pack_bf16x2(fmaxf(c1[0] + bh.x, 0.f), fmaxf(c1[1] + bh.y, 0.f));
    a2[3] = pack_bf16x2(fmaxf(c1[2] + bh.x, 0.f), fmaxf(c1[3] + bh.y, 0.f));
#pragma unroll
    for (int nt = 0; nt < kTiles2; ++nt) mma_step(acc[nt], a2, w2h[(j * kTiles2 + nt) * 32 + lane]);
  }

  float zz[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kTiles2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nt + 2 * t + e;
      const float b2 = sf[kTcOffB2 - kBase + n], w3 = sf[kTcOffW3H - kBase + n];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        zz[i] = fmaf(w3, bf16_round(fmaxf(acc[nt][2 * i + e] + b2, 0.f)), zz[i]);
      }
    }
  }
  const float b3 = sf[kTcOffB3 - kBase];
  z[0] = quad_sum(zz[0]) + b3;
  z[1] = quad_sum(zz[1]) + b3;
}

// kmer_ids are int8 ids in [0, 66); the Python wrapper checks the range
template <int Mode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
read_prob_tc_kernel(const float* __restrict__ features, const int8_t* __restrict__ kmer_ids,
                    const uint32_t* __restrict__ image, int64_t n_reads, float* __restrict__ p_out) {
  constexpr int kBegin = Mode == kModeF32x3 ? kTcOffW1F : kTcOffW2H;
  constexpr int kWords = (Mode == kModeF32x3 ? kTcOffW1H : kTcWords) - kBegin;
  __shared__ __align__(16) uint32_t s[kWords];
  for (int i = threadIdx.x; i < kWords / 4; i += kThreads) {
    reinterpret_cast<uint4*>(s)[i] = reinterpret_cast<const uint4*>(image + kBegin)[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t n_tiles = (n_reads + kTileReads - 1) / kTileReads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  // the tile index is the same on all lanes of a warp, so every mma sees a
  // converged warp
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; tile < n_tiles;
       tile += stride) {
    const int64_t r0 = tile * kTileReads + lane / 4, r1 = r0 + 8;
    const int64_t l0 = r0 < n_reads ? r0 : n_reads - 1;  // valid reads; not stored
    const int64_t l1 = r1 < n_reads ? r1 : n_reads - 1;
    float z[2];
    if constexpr (Mode == kModeF32x3) {
      f32x3_reads(features, kmer_ids, s, l0, l1, lane, z);
    } else {
      bf16_reads(features, kmer_ids, s, l0, l1, lane, z);
    }
    const int t = lane & 3;
    if (t == 0 && r0 < n_reads) p_out[r0] = 1.f / (1.f + expf(-z[0]));
    if (t == 1 && r1 < n_reads) p_out[r1] = 1.f / (1.f + expf(-z[1]));
  }
}

template <int Mode>
cudaError_t launch(const float* features, const int8_t* kmer_ids, const uint32_t* image,
                   int64_t n_reads, float* p, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, read_prob_tc_kernel<Mode>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n_reads + kTileReads - 1) / kTileReads;
  const int64_t needed = (tiles + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  read_prob_tc_kernel<Mode><<<grid, kThreads, 0, stream>>>(features, kmer_ids, image, n_reads, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Phase A in a reduced-precision mode (1 = f32x3, 2 = bf16): per-read p on
// `stream`.  Returns the CUDA error code of the launch (0 = success).
int read_prob_tc_launch(const float* features, const int8_t* kmer_ids, const uint32_t* image,
                        float* p, int64_t n_reads, int mode, void* stream_ptr) {
  if (n_reads <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (mode == kModeF32x3) {
    return static_cast<int>(launch<kModeF32x3>(features, kmer_ids, image, n_reads, p, stream));
  }
  if (mode == kModeBf16) {
    return static_cast<int>(launch<kModeBf16>(features, kmer_ids, image, n_reads, p, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Reads one block takes per step (warps x 16): the tile whose ragged edge
// the tests and chip_smoke.py exercise.
int read_prob_tc_block_reads(void) { return kWarps * kTileReads; }

const char* read_prob_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
