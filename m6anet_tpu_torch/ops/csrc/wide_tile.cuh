// The block tiles of phase A's wide plans, shared by fused_infer.cu
// (read_prob_wide_kernel, f32) and read_prob_tc.cu
// (read_prob_tc_wide_kernel<f32x3>, whose layer 1 stays on the FP32 cores).
//
// A block takes a tile of reads and walks H1 in chunks of hidden units, each
// chunk's weights staged in shared memory once for all the tile's reads.
// Layer 1 of a chunk is a product on the FP32 cores in which every (read,
// unit) chain keeps fused_infer.cu's order (t = w[0] x[0], then fmaf in
// input order): each thread holds a micro-tile of 4 GR reads x 4 GN units
// in registers, and its operands wait in shared memory input-major,
// x[input][read] and w[input][unit], so an input costs a thread GR + GN
// float4 loads for 16 GR GN FMAs.  A warp covers min(TN, 8) column groups x
// 32 / min(TN, 8) row groups, so each of its float4 loads is one contiguous
// run of at most 128 bytes that the threads sharing a row or a column read
// as a broadcast.  f32's layer 2 is the same product over a chunk's units.
//
// Copies into shared memory are cp.async, zero-filled where there is no
// data (units past H1, inputs past n_in, outputs past H2), in commit groups
// that a kernel waits for before a block barrier.
//
// Included inside each kernel file's anonymous namespace, after its
// constants; nothing here reads them.
#pragma once

namespace wide_tile {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global `src` to shared `dst`, or zeros (nothing read) where
// !valid.  No memory clobber: plain loads may move across a copy (what it
// writes is read only after wait() and a barrier, which are ordered).
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// 16 bytes (both ends 16-byte aligned), or zeros where !valid
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// elements a thread takes at once in the gathers below: their k-mer ids'
// loads are all in flight before the copies that need them
constexpr int kGatherBatch = 16;

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `Pending` of this thread's commit groups are in flight
template <int Pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// A thread's place in a grid of TR row groups x TN column groups of 4; a
// thread past the grid (tr >= TR) takes no part.
template <int TR, int TN>
struct Place {
  static constexpr int kLn = TN < 8 ? TN : 8;  // column groups a warp covers
  static constexpr int kLr = 32 / kLn;
  static_assert(TN % kLn == 0 && TR % kLr == 0, "a warp covers whole groups");
  int tr, tn;
  __device__ __forceinline__ explicit Place(int tid) {
    const int warp = tid / 32, lane = tid % 32;
    tn = warp % (TN / kLn) * kLn + lane % kLn;
    tr = warp / (TN / kLn) * kLr + lane / kLn;
  }
  __device__ __forceinline__ bool active() const { return tr < TR; }
};

// acc[4 g + e][4 h + f] of row 4 (tr + g TR) + e and column 4 (tn + h TN) +
// f, over k in [0, n) of a[k AS + row] and b[k BS + column]: acc =
// fmaf(b, a, acc), k in order; with `first`, k = 0 writes b * a alone (a
// chain's first term).  a and b 16-byte aligned, AS and BS multiples of 4.
template <int GR, int GN, int TR, int TN, int AS, int BS>
__device__ __forceinline__ void fma_rows(const float* a, const float* b, int n, bool first, int tr, int tn,
                                         float (&acc)[4 * GR][4 * GN]) {
  const float* ap = a + 4 * tr;
  const float* bp = b + 4 * tn;
  int k = 0;
  if (first && n > 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float4 av = *reinterpret_cast<const float4*>(ap + 4 * g * TR);
      const float x[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int h = 0; h < GN; ++h) {
        const float4 bv = *reinterpret_cast<const float4*>(bp + 4 * h * TN);
        const float w[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[4 * g + e][4 * h + f] = w[f] * x[e];
        }
      }
    }
    k = 1;
  }
#pragma unroll 4
  for (; k < n; ++k) {
    float x[4 * GR], w[4 * GN];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(ap + k * AS + 4 * g * TR);
      x[4 * g] = v.x, x[4 * g + 1] = v.y, x[4 * g + 2] = v.z, x[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < GN; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(bp + k * BS + 4 * h * TN);
      w[4 * h] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z, w[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * GR; ++i) {
#pragma unroll
      for (int j = 0; j < 4 * GN; ++j) acc[i][j] = fmaf(w[j], x[i], acc[i][j]);
    }
  }
}

// Inputs [i0, i0 + N) of the Reads reads from `first` into dst[(i - i0) XS
// + r] (a read past n_reads stands in as the last read; it is not stored):
// the read's Feat features, then its Pos k-mers' rows of the table `emb`
// (Emb floats a k-mer), zeros past n_in.
template <int Reads, int N, int XS, int Threads, int Feat, int Pos, int Emb, class Id>
__device__ __forceinline__ void stage_x(float* dst, const float* features, const Id* kmer_ids, const float* emb,
                                        int64_t first, int64_t n_reads, int i0) {
  constexpr int n_in = Feat + Pos * Emb;
  for (int e0 = threadIdx.x; e0 < Reads * N; e0 += kGatherBatch * Threads) {
    const float* src[kGatherBatch];
#pragma unroll
    for (int j = 0; j < kGatherBatch; ++j) {
      const int e = e0 + j * Threads, r = e / N, i = i0 + e % N;
      const int64_t want = first + r, read = want < n_reads ? want : n_reads - 1;
      src[j] = features + read * Feat;  // a valid address where nothing is read
      if (e < Reads * N && i < Feat) {
        src[j] += i;
      } else if (e < Reads * N && i < n_in) {
        const int c = i - Feat;
        src[j] = emb + Emb * static_cast<int>(kmer_ids[read * Pos + c / Emb]) + c % Emb;
      }
    }
#pragma unroll
    for (int j = 0; j < kGatherBatch; ++j) {
      const int e = e0 + j * Threads, r = e / N, i = i0 + e % N;
      if (e < Reads * N) copy4(dst + (i - i0) * XS + r, src[j], i < n_in);
    }
  }
}

// The k-mer ids of reads [first, first + Reads), Pos an id of `Id`, into
// dst (16-byte aligned), zeros past n_reads: 4-byte copies where the ids
// start 4-byte aligned (the tail's last bytes from a shorter copy), else
// plain loads (the ids of a view off a 4-byte boundary).
template <int Reads, int Pos, int Threads, class Id>
__device__ __forceinline__ void stage_ids(Id* dst, const Id* kmer_ids, int64_t first, int64_t n_reads) {
  constexpr int kBytes = Reads * Pos * static_cast<int>(sizeof(Id));
  static_assert(kBytes % 4 == 0, "whole 4-byte copies");
  const int64_t start = first * Pos * static_cast<int64_t>(sizeof(Id));
  const int64_t total = n_reads * Pos * static_cast<int64_t>(sizeof(Id));
  const uint8_t* src = reinterpret_cast<const uint8_t*>(kmer_ids);
  uint8_t* out = reinterpret_cast<uint8_t*>(dst);
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    for (int e = 4 * threadIdx.x; e < kBytes; e += 4 * Threads) {
      const int64_t left = total - start - e;
      const int n = left >= 4 ? 4 : left > 0 ? static_cast<int>(left) : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(out + e)),
                   "l"(src + (n > 0 ? start + e : 0)), "r"(n));
    }
  } else {
    for (int e = threadIdx.x; e < kBytes; e += Threads) out[e] = start + e < total ? src[start + e] : 0;
  }
}

// stage_x with the k-mer ids from shared memory (stage_ids'; a read past
// n_reads takes the last read's features and k-mer 0): every input a
// copy, none waiting for a load.
template <int Reads, int XS, int Threads, int Feat, int Pos, int Emb, class Id>
__device__ __forceinline__ void stage_x_ids(float* dst, const float* features, const Id* ids, const float* emb,
                                            int64_t first, int64_t n_reads) {
  constexpr int n_in = Feat + Pos * Emb;
  for (int e = threadIdx.x; e < Reads * n_in; e += Threads) {
    const int r = e / n_in, i = e % n_in;
    const int64_t want = first + r, read = want < n_reads ? want : n_reads - 1;
    const float* src = features + read * Feat + i;
    if (i >= Feat) {
      const int c = i - Feat;
      src = emb + Emb * static_cast<int>(ids[r * Pos + c / Emb]) + c % Emb;
    }
    copy4(dst + i * XS + r, src, true);
  }
}

// Columns [i0, i0 + N) of units [u0, u0 + BK) of layer 1's rows (n_in
// weights, then the bias: columns 0..n_in) into dst[(i - i0) WS + (u -
// u0)], the unit-major image read at image[offset(u, i)]; zeros past H1 and
// past the bias.
template <int BK, int N, int WS, int Threads, class Offset>
__device__ __forceinline__ void stage_w1(float* dst, const float* image, int u0, int i0, int h1, int n_in,
                                         Offset offset) {
  for (int e = threadIdx.x; e < BK * N; e += Threads) {
    const int u = u0 + e / N, i = i0 + e % N;
    const bool valid = u < h1 && i <= n_in;
    copy4(dst + (i - i0) * WS + (u - u0), image + (valid ? offset(u, i) : 0), valid);
  }
}

}  // namespace wide_tile
