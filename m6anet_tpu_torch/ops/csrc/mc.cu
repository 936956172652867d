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
// n_samples is a compile-time constant, kSamples (M6A_SAMPLES): 20 by
// default, the reference's; ops/mc_kernel.py builds a library for any other
// at first use.  Counts go up to 2^23 - 1 (the draw index below).
//
// exp(S_t) is the product of the iteration's n_samples draws of (1 - p), so this is
// the reference's estimator, 1 - mean_t prod_j (1 - p_draw)
// (reference: m6anet/utils/inference_utils.py:74-87).  The -1e4 clamp keeps
// a read with p == 1 finite, as the TPU kernel does; trunc(U * c) is the f32
// product truncated to int32, as there.
//
// Bound on the card, counting what a batch's real sites need (S' sites with
// a count >= 1, R of their reads, T iterations, n = n_samples draws):
//   operations  S' * T * (n adds + 1 exp) + R log1p
//               ~3.4e8 at the production batch (16,384 sites, T = 1000,
//               n = 20), ~5 us at 67 TFLOP/s f32;
//   bytes       p once (4 R), U once (4 n T), offsets and counts (8 S),
//               site_p (4 S): ~4.3 MB, ~1.3 us at 3.35 TB/s;
// so the bound is the operations', ~5 us.  A site past the staged cap
// (mc_long_site_kernel, below) needs only its draws: T (2 n + 1)
// operations, and U once (4 n T bytes) with each 32-byte sector of p that
// its draws touch, since they land at random in p (at most one a draw and
// one per 8 reads: 18,495 sectors, 0.59 MB, ~0.2 us at 3.35 TB/s for a
// 1,000,000-read site at T = 1000; scripts/_sweep.py::long_site_sectors
// counts them).  The bound counts no gathers and
// no index arithmetic; every one of the S' * T * 20 = 3.3e8 draws needs
// both, which gives this design two floors of its own at the production
// batch (132 SMs at 1.98 GHz):
//   gathers  one warp-wide shared-memory load a clock per SM (32 lanes):
//            3.3e8 / 32 / (132 x 1.98e9) = 0.039 ms without bank conflicts.
//            Random indices into a site's ~60 values conflict: a warp's
//            gather takes 1.87 passes on average at the production count
//            law (scripts/sweep_mc.py counts them from the batch and U),
//            0.075 ms.
//   issue    four warp instructions a clock per SM (128 lanes); a draw
//            issues 5 (FMUL, FADD.RZ, IMAD, LDS, FADD), and each iteration
//            adds its expf and f64 add: 3.3e8 x 5 / (128 x 132 x 1.98e9)
//            = 0.049 ms for the draws alone (the sweep reads the
//            instructions per draw from the SASS).
// On an NVIDIA H100 80GB HBM3 at 700 W the draws take ~0.080 ms of the
// kernel's 0.120 ms (twice what half the draws save, scripts/sweep_mc.py's
// ablations; PERF.md): 94% of the gather floor with bank conflicts, and 5
// instructions per 1.87 clocks is the ~2.7 a clock they issue at, so the
// shared-memory pipe, not issue, is what the numbers point to (ncu would
// tell; it does not run there).  The other ~0.040 ms is staging, expf, the
// f64 sums, finish and barriers.
//
// What this design does about each limit of the one-block-per-site kernel
// it replaces (16,384 blocks, each loading all of U and converting each
// index with F2I):
//  * U is loaded once per block, not once per site.  A persistent grid (the
//    blocks that fit on the card at once; twice as many gained nothing in
//    the sweep, 0.1262 ms against 0.1244 ms) walks groups of sites.  Thread k of kThreads keeps iterations t = k + kThreads * i,
//    i < kHeld, and holds their kSamples x kHeld draws in registers (80
//    floats at 20 draws and T <= 1,024; kHeld shrinks as kSamples grows)
//    for all of its block's sites, so U passes from L2 once per block (~21
//    MB a batch, not 1.3 GB) and a draw costs no global load.  For T >
//    kThreads * kHeld the draws are loaded again per site and iteration
//    chunk; each site's sum keeps its order across the chunks, whatever
//    kHeld (thread k adds t = k, k + kThreads, ... in order).
//  * No F2I and no integer min.  The index is computed on the FP32 pipe:
//    x = U * c rounded to nearest, as before; then __fadd_rz(x, 2^23) has
//    the bits 0x4B000000 + trunc(x), exactly, for 0 <= x < 2^23 (c <
//    2^23).  The product may round up to exactly c, so the staged
//    l holds l[c] = l[c - 1].  Both give the old index bit for bit.  The
//    0x4B000000 and the 4-byte stride fold into one IMAD a draw.
//  * Staging off the critical path.  A group of up to kGroup sites is
//    staged between two barriers (its c + 1 values of l per site, one log1p
//    per read, the rows spread over all warps).  While a group's draws run,
//    cp.async copies the next group's p into the other of two buffers and
//    the counts and offsets of the group after it, so no global load waits
//    in the draw loop.  A batch whose largest site does not fit twice in
//    kStagingBytes takes one buffer and loads p directly; any count up to
//    57,344 fits (57,345 floats, 224 KB).  Every branch on a count is
//    uniform across the block.
//  * Sites longer than that (up to 2^23 - 1 reads) take mc_long_site_kernel
//    in a second launch, which reads each draw's p from device memory (a
//    log1p a draw, not one a read: 2e4 at 1,000 iterations against 1e6 for
//    a 1,000,000-read site) and takes the index with the same __fadd_rz
//    and the clamp to c - 1 as an integer min.  The same values, index,
//    sum order over j, f64 sum order over t and reduction: the same site_p
//    bits as this kernel would give (scripts and chip_smoke.py send short
//    sites there to show it).  mc_site_kernel marks such a site NaN, and
//    the long kernel, after it on the stream, writes its value.  Its design
//    is in the note above it.
//  * Each thread runs kTogether sites side by side over the same draws, for
//    more independent sums (in the sweep at the production batch: 1 site at
//    a time 0.1265 ms, 2 sites 0.1244 ms, 4 sites 0.1218 ms; a site past the
//    group or of count 0 reads l[0] of the first one and is not kept), and
//    leaves its f64 sum of exp(S_t) per site in shared memory.  A warp per
//    site turns them into site_p during the next group, so no shuffle chain
//    waits at the end of each site.
//  * A site's count and offset are checked as they arrive in shared memory:
//    a count above the slot the launch was sized for, or a span outside p,
//    stages and reads nothing and gives NaN.  The wrapper checks the sites
//    before the launch, so this happens only when the arrays it checked are
//    not the ones on the card; then no load or store leaves p or the slot.
//  * Every site_p bit as in the kernel before it: the same staged values,
//    indices and f32 sum in the order j = 0..n_samples-1, exp of it added to an f64
//    sum for t = k, k + 256, k + 512, ..., then the pairs a shuffle-down
//    tree adds within each warp, and the warps in order.  No float atomics,
//    so repeats are bit-identical, and a site's value does not depend on the
//    block or the place in the batch it falls to.
//  * Bank conflicts are left as they are.  Copies of l per lane for sites
//    of 33-128 reads took them away for those sites and gained nothing on
//    the card in a one-site-a-time form of this design, whose time went
//    elsewhere, and two buffers of a group of such copies do not fit two
//    blocks an SM (PERF.md).
//
// The constants below are the ones scripts/sweep_mc.py varies.  Built by
// ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3, without
// --use_fast_math (log1pf and expf stay accurate).  Plain C interface,
// called through ctypes from ops/mc_kernel.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per block; the reduction's shape
constexpr int kIters = 4;      // iterations a thread holds the draws of
constexpr int kMinBlocks = 2;  // blocks per SM asked of __launch_bounds__
constexpr int kGroup = 8;     // sites staged together, at most
constexpr int kTogether = 4;   // sites whose draws a thread runs side by side
#ifndef M6A_SAMPLES
#define M6A_SAMPLES 20
#endif
constexpr int kSamples = M6A_SAMPLES;  // draws per iteration
static_assert(kSamples >= 1, "at least one draw an iteration");
// a thread holds kHeld x kSamples draws in registers: kIters x 20 = 80 at
// the default; fewer iterations (at least one) for more draws, and past 80
// draws one block an SM's registers
constexpr int kDrawRegisters = kIters * 20;
constexpr int kHeld = kIters * kSamples <= kDrawRegisters ? kIters
                      : (kDrawRegisters / kSamples > 1 ? kDrawRegisters / kSamples : 1);
constexpr int kBlocks = kHeld * kSamples <= kDrawRegisters ? kMinBlocks : 1;
constexpr int kWarps = kThreads / 32;
static_assert((kThreads & (kThreads - 1)) == 0, "the row spread takes kThreads a power of two");
constexpr int kChunk = kThreads * kHeld;
constexpr int kSharedLimitBytes = 232448;  // what one block may opt into on sm_90
constexpr int kStagingBytes = 72 * 1024;   // a launch's staged l, unless one site needs more
constexpr int kDefaultSharedBytes = 48 * 1024;
constexpr unsigned kMagicBits = 0x4B000000u;  // the bits of 2^23
constexpr int32_t kBadSite = INT32_MIN;       // the count of a site the launch cannot take
// mc_long_site_kernel's shape (scripts/sweep_mc.py rewrites the three
// tunings): a block of kLongThreads threads takes a slice of kLongSlice
// iterations of one site; in a site's last block a thread sums
// kLongChains of the kThreads f64 chains, loading kLongLoads of each
// chain's values at a time.  The sweep's fastest set at T = 1000 on all
// three of its shapes (H100 80GB HBM3, 700 W; PERF.md): 32 to 256
// threads up to 19% slower, 2 or 4 iterations a thread 1.2-1.5x, 4
// loads (T = 1000 is 4 rows of kThreads) ahead of 8 and 16 by 5-14%
constexpr int kLongThreads = 64;
constexpr int kLongIters = 1;
constexpr int kLongLoads = 4;
constexpr int kLongSlice = kLongThreads * kLongIters;
constexpr int kLongChains = kThreads / kLongThreads;
static_assert(kThreads % kLongThreads == 0 && kLongThreads % 32 == 0,
              "a whole number of chains a thread, whole warps a block");
static_assert(kLongIters >= 1 && kLongLoads >= 1, "at least one iteration and one load");
// An iteration's draws go out in kLongRounds rounds of kLongDraws loads of
// U and then kLongDraws gathers: one round up to kLongRound draws (every
// n_samples the sweep times), so the draws held in registers do not grow
// with n_samples past it
constexpr int kLongRound = 32;
constexpr int kLongRounds = (kSamples + kLongRound - 1) / kLongRound;
constexpr int kLongDraws = (kSamples + kLongRounds - 1) / kLongRounds;

// Blocks of mc_long_site_kernel a site: its n_iters iterations in slices.
constexpr int64_t long_blocks_per_site(int64_t n_iters) { return (n_iters + kLongSlice - 1) / kLongSlice; }

__device__ __forceinline__ float clamped_log1m(float p) {
  const float v = log1pf(-p);
  return v < -1e4f ? -1e4f : v;  // a NaN stays NaN
}

__device__ __forceinline__ float load_shared(unsigned address) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(address) : "memory");
  return v;
}

__device__ __forceinline__ void copy_async(void* shared_dst, const void* global_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(shared_dst))),
               "l"(global_src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// The draws of iterations base + threadIdx.x + kThreads * i, i < kHeld.
__device__ __forceinline__ void load_draws(float (&draws)[kHeld][kSamples],
                                           const float* __restrict__ u, int n_iters,
                                           int base) {
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int t = base + i * kThreads + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int j = 0; j < kSamples; ++j)
      draws[i][j] = t < n_iters ? __ldg(u + static_cast<int64_t>(j) * n_iters + t) : 0.f;
  }
}

// The sum of a site's kThreads f64 sums `a` (one a thread), in lane 0 of the
// warp that calls it: each warp's slice summed in place with the pairs a
// shuffle-down reduction adds (own value + the one o lanes up), then the
// warps' sums in order.
__device__ __forceinline__ double threads_total(double* a, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    for (int i = lane; i < kWarps * o; i += 32) {
      double* v = a + (i / o) * 32 + i % o;
      v[0] += v[o];
    }
    __syncwarp();
  }
  double total = 0.0;
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += a[32 * w];
  }
  return total;
}

// p of read r of a site's c + 1 staged values (read c is read c - 1 again).
__device__ __forceinline__ const float* site_read(const float* __restrict__ p, int offset, int r, int c) {
  return p + offset + (r < c ? r : c - 1);
}

// A block takes groups of `group` consecutive sites, the blockIdx.x-th
// group and every gridDim.x-th after it.  Site g of a group is staged at
// g * slot of a buffer: its c + 1 values l[r], with l[c] = l[c - 1].
// pipelined: two buffers; while a group's draws run, the next group's p is
// copied into the other buffer with cp.async (each thread the reads it will
// turn into l itself, so no barrier sits between the copy and its use).
// Otherwise one buffer, staged from p directly.  meta holds each site's
// count and offset, copied two groups ahead, in a ring of four groups.
__global__ void __launch_bounds__(kThreads, kBlocks)
mc_site_kernel(const float* __restrict__ p, const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ counts, const float* __restrict__ u,
               int64_t n_sites, int64_t n_reads, int n_iters, int group, int slot,
               int pipelined, unsigned magic_bytes, float* __restrict__ site_p) {
  // [1 or 2][group][kThreads] doubles: each thread's sum of exp(S_t) per
  // site; then [1 or 2][group][slot] floats: the staged l
  extern __shared__ double dynamic[];
  const int n_buffers = pipelined ? 2 : 1;
  double* const sums = dynamic;
  float* const staged = reinterpret_cast<float*>(dynamic + n_buffers * group * kThreads);
  __shared__ int32_t meta[4][kGroup][2];
  const int tid = threadIdx.x;
  const int n_chunks = (n_iters + kChunk - 1) / kChunk;
  const int64_t grid = gridDim.x;
  const int64_t n_groups = (n_sites + group - 1) / group;
  float draws[kHeld][kSamples];
  bool held = false;

  // counts and offsets of the k-th group of this block into ring slot k % 4
  auto fetch_meta = [&](int k) {
    if (tid < group) {
      const int64_t site = (blockIdx.x + k * grid) * group + tid;
      if (site < n_sites) {
        copy_async(&meta[k % 4][tid][0], counts + site);
        copy_async(&meta[k % 4][tid][1], offsets + site);
      } else {
        meta[k % 4][tid][0] = 0;
        meta[k % 4][tid][1] = 0;
      }
    }
  };
  // once this thread's copies of the k-th group's meta have landed: a count
  // the slot cannot hold or a span outside p becomes kBadSite (no rows, NaN)
  auto check_meta = [&](int k) {
    if (tid < group) {
      int32_t* m = meta[k % 4][tid];
      if (m[0] >= slot || (m[0] > 0 && (m[1] < 0 || static_cast<int64_t>(m[1]) + m[0] > n_reads)))
        m[0] = kBadSite;
    }
  };
  // fn(g, r, c, offset) for each row r <= c of the k-th group's sites that
  // this thread stages: the group's rows counted one after another, every
  // kThreads-th from tid, so that the rows spread over all warps
  auto for_my_rows = [&](int k, auto&& fn) {
    int before = 0;  // rows of the group's sites before site g
    for (int g = 0; g < group; ++g) {
      const int c = meta[k % 4][g][0], offset = meta[k % 4][g][1];
      const int rows = c > 0 ? c + 1 : 0;
      for (int r = (tid - before) & (kThreads - 1); r < rows; r += kThreads) fn(g, r, c, offset);
      before += rows;
    }
  };
  // p of the k-th group's reads into buffer `into`
  auto fetch_reads = [&](int k, float* into) {
    for_my_rows(k, [&](int g, int r, int c, int offset) {
      copy_async(into + g * slot + r, site_read(p, offset, r, c));
    });
  };
  auto sums_of = [&](int k) { return sums + (pipelined ? (k & 1) : 0) * group * kThreads; };
  // site_p of the k-th group from its threads' sums, warp g for site g:
  // each warp's slice summed in place with the pairs a shuffle-down
  // reduction adds (own value + the one o lanes up), then the warps' sums
  // in order
  auto finish = [&](int k) {
    const int g = tid >> 5, lane = tid & 31;
    const int64_t site = (blockIdx.x + k * grid) * group + g;
    if (g >= group || site >= n_sites) return;  // uniform across the warp
    const double total = threads_total(sums_of(k) + g * kThreads, lane);
    if (lane == 0) {
      const int c = meta[k % 4][g][0];
      site_p[site] = c > 0             ? static_cast<float>(1.0 - total / n_iters)
                     : c == kBadSite ? __int_as_float(0x7fc00000)  // NaN
                                     : 0.f;
    }
  };

  fetch_meta(0);
  fetch_meta(1);
  commit_copies();
  wait_copies();
  check_meta(0);
  check_meta(1);
  __syncthreads();
  if (pipelined) fetch_reads(0, staged);
  commit_copies();

  int k = 0;  // the groups of this block so far
  for (int64_t gi = blockIdx.x; gi < n_groups; gi += grid, ++k) {
    float* buffer = staged + (pipelined ? (k & 1) * group * slot : 0);
    wait_copies();  // this thread's reads of group k; meta of group k + 1
    check_meta(k + 1);  // read by others only after the barrier below
    if (!pipelined && k > 0) {
      __syncthreads();  // the last group's draws are done
      finish(k - 1);
    }
    for_my_rows(k, [&](int g, int r, int c, int offset) {
      float* l = buffer + g * slot;
      l[r] = clamped_log1m(pipelined ? l[r] : __ldg(site_read(p, offset, r, c)));
    });
    __syncthreads();
    fetch_meta(k + 2);
    if (pipelined) fetch_reads(k + 1, staged + ((k + 1) & 1) * group * slot);
    commit_copies();

    double* my_sums = sums_of(k) + tid;
    // kTogether sites at a time over the same draws: more independent sums
    // per thread.  A site past the group or with count <= 0 reads l[0] of
    // the first site's slot and is not kept.
    for (int g0 = 0; g0 < group; g0 += kTogether) {
      // the last group's site_p, once this group's first sites are done,
      // when the warps no longer run in step
      if (pipelined && k > 0 && g0 == (group > kTogether ? kTogether : 0)) finish(k - 1);
      bool keep[kTogether], any = false;
      float cf[kTogether];
      unsigned bias[kTogether];
#pragma unroll
      for (int q = 0; q < kTogether; ++q) {
        const int g = g0 + q;
        const int c = g < group ? meta[k % 4][g][0] : 0;
        keep[q] = c > 0;
        any = any || keep[q];
        // byte address of draw index bits: (bits - kMagicBits) * 4 + l's,
        // as bits * 4 + bias, one IMAD a draw (magic_bytes = kMagicBits * 4
        // is a kernel argument, so the compiler cannot split it off)
        const int at = keep[q] ? g : g0;
        cf[q] = keep[q] ? static_cast<float>(c) : 0.f;
        bias[q] = static_cast<unsigned>(__cvta_generic_to_shared(buffer + at * slot)) - magic_bytes;
      }
      if (!any) continue;  // uniform across the block
      double acc[kTogether];
#pragma unroll
      for (int q = 0; q < kTogether; ++q) acc[q] = 0.0;
      for (int base = 0; base < n_iters; base += kChunk) {
        if (!held) {
          load_draws(draws, u, n_iters, base);
          held = n_chunks == 1;
        }
        // the kHeld sums of each site run side by side, each in the order
        // j = 0..kSamples-1; an iteration past n_iters (its draws are 0, so it
        // reads l[0]) adds nothing to acc
        float s[kTogether][kHeld];
#pragma unroll
        for (int q = 0; q < kTogether; ++q)
#pragma unroll
          for (int i = 0; i < kHeld; ++i) s[q][i] = 0.f;
#pragma unroll
        for (int j = 0; j < kSamples; ++j) {
#pragma unroll
          for (int i = 0; i < kHeld; ++i) {
#pragma unroll
            for (int q = 0; q < kTogether; ++q) {
              const float x = __fmul_rn(draws[i][j], cf[q]);
              const unsigned bits = __float_as_uint(__fadd_rz(x, 8388608.f));
              s[q][i] += load_shared(bits * 4u + bias[q]);
            }
          }
        }
        // every expf runs, side by side; one past n_iters adds +0.0, which
        // leaves acc as it is
#pragma unroll
        for (int q = 0; q < kTogether; ++q) {
          float e[kHeld];
#pragma unroll
          for (int i = 0; i < kHeld; ++i) e[i] = expf(s[q][i]);
#pragma unroll
          for (int i = 0; i < kHeld; ++i)
            acc[q] += base + i * kThreads + tid < n_iters ? static_cast<double>(e[i]) : 0.0;
        }
      }
#pragma unroll
      for (int q = 0; q < kTogether; ++q)
        if (keep[q]) my_sums[(g0 + q) * kThreads] = acc[q];
    }
  }
  wait_copies();
  __syncthreads();
  if (k > 0) finish(k - 1);
}

// The listed sites (long_sites[slot], slot < n_long) whose count is above
// long_from: mc_site_kernel's launch stages none of them, and gives those
// above its slot NaN; this kernel writes their value, after it on the
// stream.  A listed site of count <= long_from keeps mc_site_kernel's
// value; a count of 2^23 or more, or a span outside p, gives NaN.
//
// What limited the kernel this replaces (a block a site, each thread
// iterations t = tid, tid + 256, ... in turn; on an NVIDIA H100 80GB HBM3
// at 700 W 0.0227 ms of device time for a 1,000,000-read site at T = 1000,
// against ~0.0002 ms of bytes; PERF.md): each draw was a load of U, then a
// gather of p, the draw loop unrolled 4, so ~40 dependent round trips a
// thread on one SM while the others idled; and each block scanned every
// count of the batch for the long sites.  This design:
//  * Spreads a site over blocks.  The grid is n_long x long_blocks_per_site
//    blocks; block b of a site takes iterations [b kLongSlice, (b + 1)
//    kLongSlice), thread tid of it t = b kLongSlice + tid + kLongThreads q,
//    q < kLongIters.  At T = 1000 a site's 20,000 gathers go out from 16
//    blocks of 64 threads on 16 SMs at once.
//  * One round trip a thread for its draws: kSamples is a compile-time
//    constant, so the draws of its iterations unroll whole: every U load
//    goes out (before the site's count, which U does not depend on), then
//    every gather, then the f32 sums in the order j = 0..kSamples-1.  Past
//    kLongRound draws an iteration they go out in rounds (a round trip
//    each), the sums carried across them in the same order.
//  * Keeps the order of the sums across blocks: each iteration's e[t] =
//    expf(S_t) is an f32 value, written to e_all (n_iters floats a listed
//    site).  The site's last block to finish (its thread 0 takes a ticket,
//    atomicInc wrapping at blocks_per_site - 1, so the tickets are 0 again
//    after every launch; __threadfence before the ticket and after it, and
//    e read through L2) sums chain k < kThreads, e[k], e[k + kThreads],
//    ... in f64 in that order (thread tid the chains tid + kLongThreads a),
//    then threads_total's tree as mc_site_kernel does.  Which block
//    computes an e[t], or comes last, changes no bit: repeats are
//    bit-identical, and a site's value is the staged kernel's.
//  * No scan of the counts: the wrapper lists the long sites (from the
//    host arrays, or on the card), so no block's work grows with n_sites.
__global__ void __launch_bounds__(kLongThreads)
mc_long_site_kernel(const float* __restrict__ p, const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ counts, const float* __restrict__ u,
                    const int32_t* __restrict__ long_sites, int64_t n_sites, int64_t n_reads, int n_iters,
                    int blocks_per_site, int long_from, float* __restrict__ e_all,
                    unsigned* __restrict__ tickets, float* __restrict__ site_p) {
  __shared__ double sums[kThreads];
  __shared__ int last_block;
  const int tid = threadIdx.x;
  const int64_t slot = blockIdx.x / blocks_per_site;
  const int slice = static_cast<int>(blockIdx.x - slot * blocks_per_site);
  const int t0 = slice * kLongSlice + tid;  // this thread's first iteration
  // the draws j = j0 + d, d < kLongDraws, of this thread's iterations;
  // one past n_iters or n_samples is 0 (it reads nothing and is not added)
  float draws[kLongIters][kLongDraws];
  const auto load_draws = [&](int j0) {
#pragma unroll
    for (int q = 0; q < kLongIters; ++q) {
      const int t = t0 + q * kLongThreads;
#pragma unroll
      for (int d = 0; d < kLongDraws; ++d) {
        const int j = j0 + d;
        const bool drawn_j = kLongRounds * kLongDraws == kSamples || j < kSamples;
        draws[q][d] = t < n_iters && drawn_j ? __ldg(u + static_cast<int64_t>(j) * n_iters + t) : 0.f;
      }
    }
  };
  load_draws(0);
  // the site after the first round's U loads are out, and no branch before
  // the gathers (so that no load waits behind it); each flag is uniform
  // across the site's blocks
  const int32_t site = __ldg(long_sites + slot);
  const bool listed = site >= 0 && site < n_sites;
  const int c = listed ? __ldg(counts + site) : 0, offset = listed ? __ldg(offsets + site) : 0;
  const bool taken = c > long_from;
  const bool bad = taken && (c >= (1 << 23) || offset < 0 || static_cast<int64_t>(offset) + c > n_reads);
  const bool ok = taken && !bad;
  const float cf = static_cast<float>(c);
  const unsigned last = static_cast<unsigned>(c - 1);
  const float* __restrict__ reads = p + (ok ? offset : 0);
  // each iteration's f32 sum in the order j = 0..kSamples-1, across rounds;
  // a round's sums after a branch on ok, past its gathers
  float sum[kLongIters];
#pragma unroll
  for (int q = 0; q < kLongIters; ++q) sum[q] = 0.f;
  const auto draw_round = [&](int j0) {
    float drawn[kLongIters][kLongDraws];
#pragma unroll
    for (int q = 0; q < kLongIters; ++q) {
      const bool live = ok && t0 + q * kLongThreads < n_iters;
#pragma unroll
      for (int d = 0; d < kLongDraws; ++d) {
        const float x = __fmul_rn(draws[q][d], cf);
        const unsigned r = __float_as_uint(__fadd_rz(x, 8388608.f)) - kMagicBits;  // trunc(x)
        drawn[q][d] = live ? __ldg(reads + (r < last ? r : last)) : 0.f;
      }
    }
    if (!ok) return;
#pragma unroll
    for (int q = 0; q < kLongIters; ++q)
#pragma unroll
      for (int d = 0; d < kLongDraws; ++d)
        if (kLongRounds * kLongDraws == kSamples || j0 + d < kSamples) sum[q] += clamped_log1m(drawn[q][d]);
  };
  draw_round(0);
  // past kLongRound draws an iteration, the other rounds (no loop at all
  // up to it)
#pragma unroll 1
  for (int j0 = kLongDraws; ok && j0 < kSamples; j0 += kLongDraws) {
    load_draws(j0);
    draw_round(j0);
  }
  if (!ok) {  // mc_site_kernel's value stands, or NaN
    if (bad && slice == 0 && tid == 0) site_p[site] = __int_as_float(0x7fc00000);
    return;
  }
  float* __restrict__ e = e_all + slot * n_iters;
#pragma unroll
  for (int q = 0; q < kLongIters; ++q) {
    const int t = t0 + q * kLongThreads;
    if (t < n_iters) e[t] = expf(sum[q]);
  }

  __threadfence();  // this thread's e[t], seen device-wide before the ticket
  __syncthreads();
  if (tid == 0) {
    last_block = atomicInc(tickets + slot, static_cast<unsigned>(blocks_per_site - 1)) ==
                 static_cast<unsigned>(blocks_per_site - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last_block) return;

  // chain k = tid + kLongThreads a: e[k + kThreads m], m = 0, 1, ... in order
  const int rows = (n_iters + kThreads - 1) / kThreads;
  double acc[kLongChains];
#pragma unroll
  for (int a = 0; a < kLongChains; ++a) acc[a] = 0.0;
  for (int m0 = 0; m0 < rows; m0 += kLongLoads) {
    float v[kLongLoads][kLongChains];
#pragma unroll
    for (int m = 0; m < kLongLoads; ++m)
#pragma unroll
      for (int a = 0; a < kLongChains; ++a) {
        const int t = (m0 + m) * kThreads + a * kLongThreads + tid;
        v[m][a] = t < n_iters ? __ldcg(e + t) : 0.f;
      }
#pragma unroll
    for (int m = 0; m < kLongLoads; ++m)
#pragma unroll
      for (int a = 0; a < kLongChains; ++a)
        if ((m0 + m) * kThreads + a * kLongThreads + tid < n_iters) acc[a] += static_cast<double>(v[m][a]);
  }
#pragma unroll
  for (int a = 0; a < kLongChains; ++a) sums[a * kLongThreads + tid] = acc[a];
  __syncthreads();
  if (tid < 32) {
    const double total = threads_total(sums, tid);
    if (tid == 0) site_p[site] = static_cast<float>(1.0 - total / n_iters);
  }
}

}  // namespace

extern "C" {

// MC site probabilities of n_sites sites on `stream`, p holding n_reads
// values.  The caller passes the largest count (which sizes the staging)
// and checks that every span lies inside p; a site that breaks either gives
// NaN.  n_samples must be kSamples.  Returns the CUDA error code of the launch
// (0 = success); cudaErrorInvalidValue for arguments the kernel does not
// take.
int mc_site_launch(const float* p, const int32_t* offsets, const int32_t* counts,
                   const float* u, float* site_p, int64_t n_sites, int64_t n_reads,
                   int n_iters, int n_samples, int max_count, void* stream_ptr) {
  if (n_sites <= 0) return static_cast<int>(cudaSuccess);
  if (n_samples != kSamples || n_iters < 1 || max_count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a slot holds the largest site; pipelined (two buffers) when a group of
  // at least one site fits kStagingBytes twice, else one buffer
  const int64_t slot = static_cast<int64_t>(max_count) + 1;
  const int64_t slot_bytes = slot * static_cast<int64_t>(sizeof(float));
  const int pipelined = 2 * slot_bytes <= kStagingBytes;
  int64_t group = kStagingBytes / ((pipelined ? 2 : 1) * slot_bytes);
  group = group < 1 ? 1 : (group > kGroup ? kGroup : group);
  // per buffer and site: the threads' sums, then the staged values
  const size_t shared = static_cast<size_t>((pipelined ? 2 : 1) * group *
                                            (kThreads * sizeof(double) + slot_bytes));
  cudaFuncAttributes attributes;
  cudaError_t err = cudaFuncGetAttributes(&attributes, mc_site_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared + attributes.sharedSizeBytes > static_cast<size_t>(kSharedLimitBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (shared > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(mc_site_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the grid: the blocks that fit on the card at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mc_site_kernel, kThreads, shared)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int64_t n_groups = (n_sites + group - 1) / group;
  const unsigned grid = static_cast<unsigned>(n_groups < resident ? n_groups : resident);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  mc_site_kernel<<<grid, kThreads, shared, stream>>>(p, offsets, counts, u, n_sites, n_reads, n_iters,
                                                      static_cast<int>(group), static_cast<int>(slot),
                                                      pipelined, kMagicBits * 4u, site_p);
  return static_cast<int>(cudaGetLastError());
}

// The n_long sites of long_sites (site indices, in any order, none twice)
// whose count is above long_from, after mc_site_launch on the same `stream`
// (which gives those above its slot NaN).  e_all holds n_long x n_iters
// floats, tickets n_long zeros (the kernel leaves them 0).  The caller
// checks every count below 2^23 and every span inside p; a site that
// breaks either gives NaN.  n_samples must be kSamples.  Returns the CUDA
// error code of the launch (0 = success); cudaErrorInvalidValue for
// arguments the kernel does not take.
int mc_long_site_launch(const float* p, const int32_t* offsets, const int32_t* counts, const float* u,
                        const int32_t* long_sites, float* e_all, unsigned* tickets, float* site_p,
                        int64_t n_sites, int64_t n_reads, int n_iters, int n_samples, int n_long, int long_from,
                        void* stream_ptr) {
  if (n_sites <= 0 || n_long <= 0) return static_cast<int>(cudaSuccess);
  if (n_samples != kSamples || n_iters < 1 || long_from < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks_per_site = long_blocks_per_site(n_iters);
  const int64_t grid = blocks_per_site * n_long;
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  mc_long_site_kernel<<<static_cast<unsigned>(grid), kLongThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      p, offsets, counts, u, long_sites, n_sites, n_reads, n_iters, static_cast<int>(blocks_per_site), long_from,
      e_all, tickets, site_p);
  return static_cast<int>(cudaGetLastError());
}

const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
