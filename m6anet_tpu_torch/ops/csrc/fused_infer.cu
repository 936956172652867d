// Fused inference step of the production m6A MIL model, hand-written for
// Hopper (sm_90a).
//
// Replaces: m6anet_tpu/ops/fused_infer_kernel.py:397 (fused_inference_t)
//
// Its entry points also serve two more TPU kernels of the same function:
//   fused_infer_launch  m6anet_tpu/ops/fused_infer_kernel.py:134
//                       (fused_inference: the same contract given site ids;
//                       its wrapper derives the offsets from the counts)
//   read_prob_launch    m6anet_tpu/ops/encoder_kernel.py:207
//                       (fused_read_probability: phase A alone)
//   site_reduce_launch  m6anet_tpu/ops/fused_infer_kernel.py:358
//                       (phase B alone: the site half of fused_inference_t's
//                       kernel body, after the f32x3 and bf16 phase A of
//                       read_prob_tc.cu)
//
// What it computes, for a batch packed by data/batching.py::pack_sites
// (site s owns the contiguous reads [offsets[s], offsets[s] + counts[s]);
// padding reads sit past sum(counts) and padding sites have count 0), at
// the model's widths: P k-mer positions with 3 P signal features, an
// embedding of E dimensions over V k-mers, hidden widths H1 and H2 (the
// released models: P = 3, E = 2, V = 66, H1 = 150, H2 = 32):
//
//   per read r   x = [features[r, 0:3P], emb[k0], ..., emb[k(P-1)]]   (n_in = 3P + PE)
//                h1 = relu(W1' x + b1')     (H1; eval BatchNorm folded in)
//                h2 = relu(W2 h1 + b2)      (H2)
//                p[r] = sigmoid(w3 . h2 + b3)
//   per site s   site_p[s]    = 1 - (sum(1 - p) / max(n, 1)) ** n_samples
//                mod_ratio[s] = #{p >= threshold} / max(n, 1)
//
// The widths are compile-time constants: the M6A_* macros below, set by
// ops/fused_infer_kernel.py::kernel_defines for a model of other widths
// (one library each, built at first use) and by default the released
// models'.
//
// Built with no k-mer input (M6A_POS 0 and M6A_TAIL_IN = n_in, set by
// ops/encoder_kernel.py::tail_defines), phase A is the per-read tail of a
// model whose blocks before its last two Linear run as PyTorch modules on
// the torch backend: x = features[r, 0:n_in] (those blocks' output), then
// h1, h2 and p as above, with no id read and no embedding in the image.
//
// Padding sites give site_p = 1 and mod_ratio = 0, as the TPU kernel does.
// A site whose span leaves [0, n_reads) (a negative offset or count, or
// offset + count > n_reads; pack_sites never makes one) gives NaN for both,
// as mc.cu does, and reads nothing.
//
// Bound on the card.  Each read costs 2 (n_in H1 + H1 H2 + H2) f32 FLOP
// and moves 13 P + 4 bytes (12 P of features, P of int8 k-mer ids, 4 of
// p).  At the released widths that is 14,164 FLOP and 43 bytes, ~330 FLOP
// per byte, far above the H100's ~20 FLOP/B f32 ridge (67 TFLOP/s over
// 3.35 TB/s on the SXM part), so the step is bound by the f32 CUDA cores:
// ~0.22 ms for a 1,048,576-read batch on an H100 SXM; every width is as far
// above it (4.0 ms at P = 11, E = 8, H1 = 512, H2 = 128).
// The per-site phase (phase B) reads p once more (4 B per read) and the
// spans (8 B per site) and writes 8 B per site: 4.45 MB at the production
// batch (16,384 sites), 1.3 us at 3.35 TB/s, whatever the widths.  It is
// bound by latency, not bytes: each site is a chain of dependent round
// trips to device memory (its span, then its reads, then its results).
//
// What this design does about it:
//  * Phase A, R reads per thread (register blocking over reads, R =
//    kReads), grid-stride over tiles of kReadThreads * R reads.  All the
//    weights (~30 KB at the released widths, at most 227 KB: past that the
//    wide plan below) are staged in shared memory once per block and read as
//    warp-uniform float4 broadcasts (no bank conflicts); past 48 KB as
//    dynamic shared memory.  For each of the H1 hidden units a thread loads
//    W1'/b1' row k (n_in + 1 floats padded to float4s) and W2's fan-out of
//    unit k (H2 padded to float4s) once and uses them for all R of its
//    reads: it forms h1_k of each read from that read's n_in inputs in
//    registers and folds it at once into the read's H2 register
//    accumulators of layer 2.  h1 never leaves registers, and the only
//    device-memory traffic is the inputs once and p once.  The k-mer
//    embedding is a direct table read with the int8 id (no one-hot).
//  * What held the one-read-per-thread design to ~41% of the bound: every
//    weight it loaded fed one read, so 12 shared loads shared the issue
//    slots with 49 FP32 instructions per hidden unit; layer 1 was one
//    chain of 15 dependent FMAs per thread; and at ~100 registers only 16
//    warps fit on an SM (25% occupancy) to hide that chain.  With R reads a
//    thread issues the same 12 loads per 49 * R FP32 instructions and runs R
//    independent layer-1 chains, so latency is hidden inside the thread
//    instead of by more warps; the price is R * (n_in inputs + H2
//    accumulators) registers: 94 at the released widths.  Wider models
//    take R = 1, and past 94 values one block an SM's registers (kReads,
//    kReadBlocks below).
//  * Lane groups (G = kLaneGroup).  With R reads a thread, each float4 of
//    W2 a thread loaded still fed only its own R reads: at 9 inputs and H2
//    = 32 a hidden unit took 11 LDS.128 a thread (3 of W1'/b1', 8 of W2)
//    for 86 FP32 instructions, and the loads held the kernel at ~50% of
//    its bound: built with no W2 loads it ran 30% faster, with no shared
//    loads at all in half the time (ablations, PERF.md section 6).
//    So G neighbouring lanes of a warp share their reads: each forms h1_k
//    of its own R reads as before, the group swaps those by
//    __shfl_xor_sync (R (G - 1) shuffles a unit), and each lane
//    accumulates its own H2 / G outputs of layer 2 for the group's G R
//    reads, so a float4 of W2 feeds 4 G R FMAs, not 4 R: at G = 2, 3 + 4
//    LDS.128 and 2 shuffles a unit.  A thread keeps R x H2 accumulators,
//    as before.  After the last unit the group swaps the accumulators back
//    ((G - 1) R H2 / G shuffles a tile), so each lane runs the head of its
//    own reads.  A float4 of W2 is read at G addresses a warp (a lane's
//    slice of the row), in distinct banks.  Where it fits (kLaneGroup
//    below) this takes the tail's 9 -> 150 -> 32 from 0.384 to 0.332 ms at
//    1,048,576 reads.
//  * The wide plan (kWide: past 144 values a read or a 227 KB image, e.g.
//    121 inputs and H2 = 128, a 0.55 MB image) keeps each read's operation
//    sequence, so p is the same bits, but not its registers.  Its earlier
//    design (a read a thread, weights loaded through L1 as warp-uniform
//    float4s) issued ~0.75 memory instructions an FMA, no weight feeding
//    more than one read from registers, and ran behind cuBLAS's matmuls of
//    the plain version.  Now the two layers are two back-to-back products on
//    the FP32 cores, tiled over a block (wide_tile.cuh): a block takes 128
//    reads, stages their inputs and each step's weights (64 hidden units of
//    W1 and W2) in shared memory once by cp.async, double-buffered, the
//    next tile's inputs copied in under this one's last step, and each
//    thread holds a micro-tile (8 reads x 4 units in layer 1, up to 8 reads
//    x 8 outputs in layer 2), so a float4 from shared memory feeds 4 to 8
//    FMAs and the FP32 pipe, not the load pipe, sets the pace.
//  * Each read keeps the exact operation sequence of the one-read design
//    (layer 1: W1'[k,0] * x0, then fmaf in input order, + b1', relu;
//    layer 2: fmaf in k order; head: fmaf in j order, + b3, 1 / (1 +
//    expf(-z))), whichever lane of its group adds an output's terms, so p
//    is bit-identical to it and deterministic.  Threads
//    take reads base + t + j * kReadThreads, so each of a warp's loads
//    covers 32 neighbouring reads; past the end of the batch a thread
//    computes the last read again and does not store it.
//  * Phase B is bound by latency and by its own instruction issue, not by
//    bytes: on an H100 an empty kernel launched in its place takes about
//    half its time.  So it takes one round trip of each kind per site, with
//    every load of a kind in flight at once, and few instructions a read.
//    A site's reads are spread over kSiteLanes lanes (32 / kSiteLanes sites
//    a warp): each lane loads the site's offset and count (one address for
//    the site's lanes, neighbouring ones for the warp's sites), then its
//    share of the span's 16-byte chunks (the span taken from the 16-byte
//    boundary at or below its first read, reads outside it masked),
//    kChunkLoads chunks a round, all in flight; a warp skips the chunks
//    none of its lanes holds.  At 8 lanes and 8 loads a 60-read site is two
//    loads a lane in one round, a 1,000-read site four rounds.  Each site's
//    sums add up over its own lanes in redux.sync, every site of the warp
//    in the same instructions, and the site's first lane finishes it
//    (division and power).  A grid sized to the SMs walks the warps' runs
//    of sites.  Launched as a programmatic dependent of phase A (sm_90's
//    PDL), phase B gained nothing measurable, while the trigger in phase A
//    cost read_prob_tc.cu spills, so it is launched plainly.
//  * Exact integer sums.  For f32 p in [0, 1], 1 - p rounds to a multiple
//    of 2^-24 (exact for p >= 0.5; in (0.5, 1] otherwise, whose spacing is
//    2^-24), at most 2^24 units.  So a chunk's four terms sum to at most
//    2^26 units and a lane's kChunkLoads chunks of a round to 2^31; a lane
//    adds its rounds in 64 bits, and split at bit 24 the lanes' totals add
//    up over the site's lanes in two redux.sync (__reduce_add_sync) that
//    cannot overflow: exact integer sums, in any order.  The mean,
//    (double)units * 2^-24 / max(n, 1) rounded to f32, is that of the exact
//    sum, as an f64 sum of the terms and the plain version's int64 sums in
//    2^-32 (ops/site_ops.py) give it, bit for bit.  The domain is
//    what phase A makes: p in [0, 1] or NaN.  A read outside it (NaN, an
//    infinity, p < 0 or p > 1) makes its site's site_p NaN (with n_samples
//    = 0: 0, as 1 - NaN ** 0); mod_ratio counts it as p >= threshold says.
//    The power is the binary exponentiation XLA uses for an integer power.
//  * No tensor cores in this f32 mode: Hopper's take f32 operands only as
//    TF32, and even a 3xTF32 split would change every read's rounding,
//    which the 1e-6 per-read parity with the plain version and the JAX
//    package does not allow.  The f32x3 and bf16 modes run their phase A
//    on the tensor cores in read_prob_tc.cu and their phase B here
//    (site_reduce_launch).  TMA staging of the read stream (6% of the
//    bound) and fusing the two phases into one launch are left for later.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// without --use_fast_math (expf and f32 division stay IEEE-accurate).
// Plain C interface, called through ctypes from ops/fused_infer_kernel.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The widths (the released models' by default; ops/fused_infer_kernel.py
// sets them for a model of other widths)
#ifndef M6A_POS
#define M6A_POS 3
#endif
#ifndef M6A_EMB
#define M6A_EMB 2
#endif
#ifndef M6A_VOCAB
#define M6A_VOCAB 66
#endif
#ifndef M6A_H1
#define M6A_H1 150
#endif
#ifndef M6A_H2
#define M6A_H2 32
#endif
// the inputs a read gives layer 1 straight from its features with no k-mer
// input (M6A_POS 0): 0 where the read has k-mer positions
#ifndef M6A_TAIL_IN
#define M6A_TAIL_IN 0
#endif
// bytes of a k-mer id the kernels read: 1 (int8) by default, 2 (int16) for
// ids of a vocabulary past 127 (ops/fused_infer_kernel.py::kernel_defines)
#ifndef M6A_KMER_ID_BYTES
#define M6A_KMER_ID_BYTES 1
#endif
#if M6A_KMER_ID_BYTES == 2
using KmerId = int16_t;
#else
using KmerId = int8_t;
#endif
constexpr int kIdBytes = M6A_KMER_ID_BYTES;
static_assert(kIdBytes == sizeof(KmerId), "k-mer ids of 1 or 2 bytes");
constexpr int kPos = M6A_POS;                 // k-mer positions per read
constexpr int kFeat = 3 * kPos + M6A_TAIL_IN;  // features per read
static_assert(kPos == 0 || M6A_TAIL_IN == 0, "k-mer positions or a tail's inputs, not both");
constexpr int kVocab = M6A_VOCAB;             // k-mer vocabulary
constexpr int kEmb = M6A_EMB;                 // embedding width
constexpr int kIn = kFeat + kPos * kEmb;      // n_in, 15 at the released widths
constexpr int kH1 = M6A_H1;
constexpr int kH2 = M6A_H2;

// Packed weight image (floats), written by prepare_fused_params_t
// (ops/fused_infer_kernel.py::f32_layout):
//   W1B [H1][kW1Stride]  row k = BN-folded W1'[k, 0:n_in], then b1'[k], zeros
//   EMB [V][E]           embedding table, zeros to kEmbWords
//   W2  [H1][kH2Pad]     row k = W2[:, k] (hidden unit k's fan-out), zero past H2
//   B2 [kH2Pad], W3 [kH2Pad], B3 [1], zero padding to a multiple of 4
constexpr int kW1Stride = (kIn + 4) / 4 * 4;           // n_in + 1, to float4s
constexpr int kH2Pad = (kH2 + 3) / 4 * 4;              // float4s of layer 2
constexpr int kEmbWords = (kVocab * kEmb + 3) / 4 * 4;
constexpr int kOffW1B = 0;
constexpr int kOffEmb = kOffW1B + kH1 * kW1Stride;  // 2400
constexpr int kOffW2 = kOffEmb + kEmbWords;         // 2532
constexpr int kOffB2 = kOffW2 + kH1 * kH2Pad;       // 7332
constexpr int kOffW3 = kOffB2 + kH2Pad;             // 7364
constexpr int kOffB3 = kOffW3 + kH2Pad;             // 7396
constexpr int kWeights = kOffB3 + 4;                // 7400
static_assert(kOffW2 % 4 == 0 && kWeights % 4 == 0, "float4 alignment");
static_assert(kIn + 1 <= kW1Stride, "W1B row holds n_in weights and a bias");
// past the 48 KB of static shared memory the image is dynamic
constexpr bool kWeightsDynamic = kWeights * 4 > 48 * 1024;

// Phase A's tiling: kReadTile reads per thread (R), kReadThreads threads per
// block, kReadMinBlocks blocks per SM asked of __launch_bounds__ (which caps
// a thread's registers at 65536 / (threads * blocks)), the unrolling of
// the hidden-unit loop, and the lane groups' three (G, below).
// scripts/sweep_read_tile.py re-derives them: it builds copies of this file
// with these seven lines rewritten and times each on the card.  Measured
// for R = 1 to 4 on an H100 SXM: R = 2 at 256 threads takes 126 registers
// with no spills and keeps 16 warps on an SM, and ran fastest; R = 3 and 4
// (168 to 241 registers) fit only 8 to 10 warps on an SM and lost more to
// the latency of the shared loads than they saved in issue.  They hold
// wherever a read keeps no more values in registers than at the released
// widths (kReadValues: its n_in inputs and H2 padded to 4 accumulators, 47
// there).  A wider read takes R = 1, two blocks an SM up to twice those
// values and one block (255 registers a thread) past them.
// The lane groups (kLaneGroupTile lanes, G) keep a thread's R reads'
// inputs and G R reads' H2 / G accumulators, as many as G = 1 keeps, but
// each unit's shuffle puts its latency between layers 1 and 2, so their
// unit loop is unrolled by kLaneGroupUnroll: one unit's layer 2 issues
// under the next one's layer 1 and exchange.  That loop holds two units'
// temporaries, so groups are taken where a read keeps at most
// kLaneGroupValues values (and H2, to 4, splits into G lanes' float4s):
// at 41 (9 inputs, the signal-only tail) it took 124 registers and ran
// 13.5% faster than R = 2 alone; at the released widths' 47 it spilled and
// ran 13% slower, and unrolled by 1 8% slower (PERF.md section 6).
constexpr int kReadTile = 2;
constexpr int kReadThreads = 256;
constexpr int kReadMinBlocks = 2;
constexpr int kReadUnroll = 1;
constexpr int kLaneGroupTile = 2;
constexpr int kLaneGroupUnroll = 2;
constexpr int kLaneGroupValues = 41;
constexpr int kReadValues = kIn + kH2Pad;
constexpr int kReleasedReadValues = 47;
constexpr int kReads = kReadValues <= kReleasedReadValues ? kReadTile : 1;
constexpr int kReadBlocks = kReadValues <= kReleasedReadValues ? kReadMinBlocks
                            : kReadValues <= 2 * kReleasedReadValues ? 2 : 1;
constexpr int kLaneGroup =
    kReadValues <= kLaneGroupValues && kH2Pad % (4 * kLaneGroupTile) == 0 ? kLaneGroupTile : 1;
constexpr int kUnitUnroll = kLaneGroup > 1 ? kLaneGroupUnroll : kReadUnroll;
static_assert(kLaneGroup >= 1 && 32 % kLaneGroup == 0, "a warp holds whole lane groups");
// Past 144 values a read (a thread's registers) or past a block's shared
// memory for the image, phase A takes the wide plan: read_prob_wide_kernel,
// a block a tile of kWideReads reads, H1 in steps of kWideChunk units whose
// weights are staged in shared memory once for the tile, both layers as
// register micro-tiles (wide_tile.cuh).
constexpr int kMaxReadValues = 144;
constexpr int kSharedLimit = 232448;  // dynamic shared memory a block may opt into on sm_90
constexpr bool kWide = kReadValues > kMaxReadValues || kWeights * 4 > kSharedLimit;
// The wide plan's tunings: reads a tile, hidden units a step, reads of a
// thread's layer-1 micro-tile (4 or 8; its units follow from the threads),
// buffers of weights in flight (2: a step's copies run under the step
// before), layer-2 outputs a pass at most (a power of two), and inputs a
// step where a tile's inputs do not fit the shared memory whole.
// scripts/sweep_wide.py builds copies with these lines rewritten and times
// each on the card; these ran fastest at (11, 8, 512, 128) (PERF.md
// section 6).
constexpr int kWideThreads = 256;
constexpr int kWideReads = 128;
constexpr int kWideChunk = 64;
constexpr int kWideTileReads = 8;
constexpr int kWideStages = 2;
constexpr int kWidePassCap = 128;
constexpr int kWideInCap = 64;
// layer-2 outputs a pass: H2 (to 4) up to a power of two of at least 16
constexpr int pow2_at_least(int n, int p) { return p >= n ? p : pow2_at_least(n, 2 * p); }
constexpr int kWidePass = pow2_at_least(kH2Pad, 16) < kWidePassCap ? pow2_at_least(kH2Pad, 16) : kWidePassCap;
constexpr int kWidePasses = (kH2Pad + kWidePass - 1) / kWidePass;
// layer 1's micro-tile, 4 kL1Gr reads x 4 kL1Gn units a thread of a kL1Tr x
// kL1Tn grid; layer 2's, 4 kL2Gr reads x 4 kL2Gn outputs (8 x 8 at 128
// outputs a pass, fewer threads than the block's below 32)
constexpr int kL1Gr = kWideTileReads / 4;
constexpr int kL1Gn = kWideReads * kWideChunk / kWideThreads / kWideTileReads / 4;
constexpr int kL1Tr = kWideReads / (4 * kL1Gr);
constexpr int kL1Tn = kWideChunk / (4 * (kL1Gn > 0 ? kL1Gn : 1));
constexpr int kL2Gn = kWidePass >= 128 ? 2 : 1;
constexpr int kL2Values = kWideReads * kWidePass / kWideThreads;
constexpr int kL2Gr = kL2Values >= 32 * kL2Gn ? kL2Values / (16 * kL2Gn) : 1;
constexpr int kL2Tr = kWideReads / (4 * kL2Gr);
constexpr int kL2Tn = kWidePass / (4 * kL2Gn);
static_assert(kL1Gr >= 1 && kL1Gn >= 1 && kL1Tr * kL1Tn == kWideThreads, "layer 1's micro-tiles cover a step");
static_assert(kL2Tr * kL2Tn <= kWideThreads && kL2Tr * 4 * kL2Gr == kWideReads, "layer 2's micro-tiles cover a pass");
// Shared memory (floats): x[input][read], the step's layer-1 rows
// w1[column][unit] (columns: n_in weights, then the bias as column n_in),
// W2's rows w2[unit][output], h1[unit][read] (then the head's outputs
// [output][read]).  A tile's inputs are staged once where all fit, with
// the next tile's k-mer ids (so its inputs are copied in under this one's
// last step), else kWideInCap inputs a step (x in a buffer a stage, as the
// weights).
constexpr int kXStride = kWideReads + 4;
constexpr int kW1sStride = kWideChunk + 4;
constexpr int kHStride = kWideReads + 4;
constexpr int kIdFloats = (kWideReads * kPos * kIdBytes + 15) / 16 * 4;
constexpr int wide_floats(int cols, bool whole) {
  return (whole ? kIn * kXStride + kIdFloats : kWideStages * cols * kXStride) + kWideStages * cols * kW1sStride +
         kWideStages * kWideChunk * kWidePass + kWideChunk * kHStride;
}
constexpr bool kWideWhole = 4 * wide_floats(kIn + 1, true) <= kSharedLimit;
constexpr int kWideCols = kWideWhole ? kIn + 1 : kWideInCap;  // layer-1 columns a step
constexpr int kWideInSteps = (kIn + 1 + kWideCols - 1) / kWideCols;
constexpr int kWideUnitSteps = (kH1 + kWideChunk - 1) / kWideChunk;
constexpr int kWideSmem = 4 * wide_floats(kWideCols, kWideWhole);
static_assert(kWideSmem <= kSharedLimit && kWideStages >= 2 && kWideChunk % 4 == 0, "a wide block fits the card");
// Phase B's shape: kSiteThreads threads a block (its occupancy is asked of
// the card at launch), kSiteLanes lanes a site's reads are spread over (a
// power of two, at most 32: 32 / kSiteLanes sites a warp) and kChunkLoads
// 16-byte loads a lane issues at once.  scripts/sweep_site_reduce.py
// builds copies with these three lines rewritten and times each on the
// card.
constexpr int kSiteThreads = 256;
constexpr int kSiteLanes = 8;
constexpr int kChunkLoads = 8;
static_assert(kSiteLanes >= 1 && kSiteLanes <= 32 && (kSiteLanes & (kSiteLanes - 1)) == 0,
              "a warp holds whole sites");
static_assert(kChunkLoads >= 1 && kChunkLoads <= 32, "a lane's chunks of a round sum below 2^32");

// kmer_ids are ids in [0, kVocab); the Python wrapper checks the range.
// R = kReads, G = kLaneGroup (templates, so that only the plan the widths
// take is built)
template <int R, int G>
__global__ void __launch_bounds__(kReadThreads, kReadBlocks)
read_prob_kernel(const float* __restrict__ features,
                 const KmerId* __restrict__ kmer_ids,
                 const float* __restrict__ weights, int64_t n_reads,
                 float* __restrict__ p_out) {
  static_assert(R > 0 && !kWide, "the wide plan runs read_prob_wide_kernel");
  static_assert(G >= 1 && 32 % G == 0 && kH2Pad % (4 * G) == 0, "a group's lanes split H2 in float4s");
  constexpr int kSlice = kH2Pad / G;  // the outputs of layer 2 a lane accumulates
  constexpr unsigned kAll = 0xffffffffu;
  const int place = threadIdx.x % G;  // in the lane's group: it holds outputs [place kSlice, (place + 1) kSlice)
  extern __shared__ __align__(16) float dynamic_w[];
  __shared__ __align__(16) float static_w[kWeightsDynamic ? 4 : kWeights];
  float* const w = kWeightsDynamic ? dynamic_w : static_w;
  for (int i = threadIdx.x; i < kWeights / 4; i += kReadThreads) {
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(weights)[i];
  }
  __syncthreads();

  constexpr int64_t kTile = static_cast<int64_t>(kReadThreads) * R;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile; base < n_reads; base += stride) {
    float x[R][kIn];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t want = base + threadIdx.x + static_cast<int64_t>(j) * kReadThreads;
      const int64_t r = want < n_reads ? want : n_reads - 1;  // a valid read; not stored
      const float* f = features + r * kFeat;
#pragma unroll
      for (int i = 0; i < kFeat; ++i) x[j][i] = __ldg(f + i);
#pragma unroll
      for (int q = 0; q < kPos; ++q) {
        const int k = static_cast<int>(kmer_ids[r * kPos + q]);
#pragma unroll
        for (int e = 0; e < kEmb; ++e) x[j][kFeat + kEmb * q + e] = w[kOffEmb + kEmb * k + e];
      }
    }

    // acc[d][j][i]: output place kSlice + i of read j of the group's lane place ^ d
    float acc[G][R][kSlice];
#pragma unroll
    for (int d = 0; d < G; ++d) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int i = 0; i < kSlice; ++i) acc[d][j][i] = 0.f;
      }
    }

#pragma unroll (kUnitUnroll)
    for (int k = 0; k < kH1; ++k) {
      // W1'[k, i] . x[i] in input order (W1'[k, 0] x0, then fmaf), + b1'[k]
      // (the row's entry n_in), relu
      const float4* row = reinterpret_cast<const float4*>(w + kOffW1B + k * kW1Stride);
      float t[R], h[R];
#pragma unroll
      for (int q = 0; q < kW1Stride / 4; ++q) {
        const float4 v = row[q];
        const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (i == 0) {
              t[j] = c[e] * x[j][0];
            } else if (i < kIn) {
              t[j] = fmaf(c[e], x[j][i], t[j]);
            } else if (i == kIn) {
              h[j] = fmaxf(t[j] + c[e], 0.f);  // + b1'[k], relu
            }
          }
        }
      }
      // the group's h1_k: hs[d][j] of lane place ^ d's read j, by shuffle
      float hs[G][R];
#pragma unroll
      for (int d = 0; d < G; ++d) {
#pragma unroll
        for (int j = 0; j < R; ++j) hs[d][j] = d == 0 ? h[j] : __shfl_xor_sync(kAll, h[j], d);
      }
      // this lane's kSlice outputs of W2's fan-out of unit k, each float4
      // into the G x R reads of the group
      const float4* fan = reinterpret_cast<const float4*>(w + kOffW2 + k * kH2Pad + place * kSlice);
#pragma unroll
      for (int q = 0; q < kSlice / 4; ++q) {
        const float4 v = fan[q];
#pragma unroll
        for (int d = 0; d < G; ++d) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            acc[d][j][4 * q] = fmaf(v.x, hs[d][j], acc[d][j][4 * q]);
            acc[d][j][4 * q + 1] = fmaf(v.y, hs[d][j], acc[d][j][4 * q + 1]);
            acc[d][j][4 * q + 2] = fmaf(v.z, hs[d][j], acc[d][j][4 * q + 2]);
            acc[d][j][4 * q + 3] = fmaf(v.w, hs[d][j], acc[d][j][4 * q + 3]);
          }
        }
      }
    }

    // each lane's own reads whole: acc[d] of lane place ^ d holds its slice
    // of this lane's reads, so after the swap acc[d] holds slice place ^ d
#pragma unroll
    for (int d = 1; d < G; ++d) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int i = 0; i < kSlice; ++i) acc[d][j][i] = __shfl_xor_sync(kAll, acc[d][j][i], d);
      }
    }

#pragma unroll
    for (int j = 0; j < R; ++j) {
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < kH2; ++i) {
        float a = acc[0][j][i % kSlice];  // output i sits in slice i / kSlice: acc[place ^ (i / kSlice)]
#pragma unroll
        for (int d = 1; d < G; ++d) a = (place ^ (i / kSlice)) == d ? acc[d][j][i % kSlice] : a;
        z = fmaf(w[kOffW3 + i], fmaxf(a + w[kOffB2 + i], 0.f), z);
      }
      z += w[kOffB3];
      const int64_t r = base + threadIdx.x + static_cast<int64_t>(j) * kReadThreads;
      if (r < n_reads) p_out[r] = 1.f / (1.f + expf(-z));
    }
  }
}

// ------------------------------------------------------ the wide plan
#include "wide_tile.cuh"

// Phase A of the wide plan (kWide): the function of read_prob_kernel, in
// its operation sequence for every read, so p is the same bits.  A block
// takes tiles of kWideReads reads in turn.  For each pass of layer 2 (one
// at H2 <= 128; a later pass forms h1 again), H1 runs in steps of
// kWideChunk units (and of kWideCols layer-1 columns where a tile's inputs
// do not fit whole).  The block's steps form one stream across its passes
// and tiles: step g's weights (W1 rows transposed to w1[column][unit], W2
// rows) sit in buffer g % kWideStages and are copied by cp.async while the
// kWideStages - 1 steps before compute.  Where a tile's inputs fit whole,
// the next tile's k-mer ids are copied in at its first step and its inputs
// after this tile's last layer-1 read, so no step waits for a gather.
// Layer 1 adds the step's columns into its micro-tile's chains; at a
// chunk's last column, bias and relu go to h1[unit][read] in shared memory,
// and layer 2 adds the chunk's units, in unit order, into the pass's
// accumulators.  The head runs each read's outputs in order, through shared
// memory, in thread r < kWideReads for read r: z = fmaf(w3, relu(acc +
// b2), z).  Units past H1 have zero weights (h1 = 0 adds nothing to a sum
// but the sign of a zero, which p cannot show); reads past n_reads are
// computed from the last read's features and are not stored.
template <int Threads>
__global__ void __launch_bounds__(Threads, 1)
read_prob_wide_kernel(const float* __restrict__ features,
                      const KmerId* __restrict__ kmer_ids,
                      const float* __restrict__ weights, int64_t n_reads,
                      float* __restrict__ p_out) {
  static_assert(Threads == kWideThreads, "the plan's threads");
  constexpr int kS = kWideStages;
  constexpr int kSteps = kWideUnitSteps * kWideInSteps;  // a pass's
  constexpr int kTileSteps = kSteps * kWidePasses;
  constexpr bool kAhead = kWideWhole && kTileSteps >= kS;  // the next tile's inputs come in under this one
  constexpr int kPiece = kWideChunk < kWidePass ? kWideChunk : kWidePass;  // head columns through hs at once
  static_assert(kWidePass % kPiece == 0, "the head's pieces cover a pass");
  extern __shared__ __align__(16) float wide_smem[];
  float* const xs = wide_smem;
  float* const w1s = xs + (kWideWhole ? kIn * kXStride + kIdFloats : kS * kWideCols * kXStride);
  float* const w2s = w1s + kS * kWideCols * kW1sStride;
  float* const hs = w2s + kS * kWideChunk * kWidePass;
  KmerId* const ids = reinterpret_cast<KmerId*>(xs + kIn * kXStride);  // where kWideWhole
  const int tid = threadIdx.x;
  const wide_tile::Place<kL1Tr, kL1Tn> p1(tid);
  const wide_tile::Place<kL2Tr, kL2Tn> p2(tid);
  const auto w1_at = [](int u, int i) { return kOffW1B + u * kW1Stride + i; };
  // the copies of step k of a tile's (pass k / kSteps), the block's step
  // g: W1 columns and, where a tile's inputs come in steps, x into buffer
  // g % kS; W2 at a unit chunk's first step into buffer (the block's unit
  // chunk) % kS
  const auto stage = [&](int64_t first, int k, int g) {
    const int j0 = k / kSteps * kWidePass, s = k % kSteps, c = s / kWideInSteps, q = s % kWideInSteps;
    const int b = g % kS;
    wide_tile::stage_w1<kWideChunk, kWideCols, kW1sStride, Threads>(w1s + b * kWideCols * kW1sStride, weights,
                                                                    c * kWideChunk, q * kWideCols, kH1, kIn, w1_at);
    if constexpr (!kWideWhole) {
      wide_tile::stage_x<kWideReads, kWideCols, kXStride, Threads, kFeat, kPos, kEmb>(
          xs + b * kWideCols * kXStride, features, kmer_ids, weights + kOffEmb, first, n_reads, q * kWideCols);
    }
    if (q == 0) {
      float* w2 = w2s + g / kWideInSteps % kS * kWideChunk * kWidePass;
      for (int e = tid; e < kWideChunk * kWidePass / 4; e += Threads) {
        const int k2 = e / (kWidePass / 4), o = 4 * (e % (kWidePass / 4));
        const int u = c * kWideChunk + k2;
        const bool valid = u < kH1 && j0 + o < kH2Pad;
        wide_tile::copy16(w2 + k2 * kWidePass + o, weights + kOffW2 + (valid ? u * kH2Pad + j0 + o : 0), valid);
      }
    }
  };
  const auto stage_inputs = [&](int64_t first) {  // a whole tile's, its ids staged and visible
    wide_tile::stage_x_ids<kWideReads, kXStride, Threads, kFeat, kPos, kEmb>(xs, features, ids, weights + kOffEmb,
                                                                             first, n_reads);
  };
  const int64_t n_tiles = (n_reads + kWideReads - 1) / kWideReads;
  int64_t tile = blockIdx.x;
  if constexpr (kWideWhole) {
    wide_tile::stage_ids<kWideReads, kPos, Threads>(ids, kmer_ids, tile * kWideReads, n_reads);
    wide_tile::commit();
    wide_tile::wait<0>();
    __syncthreads();
    stage_inputs(tile * kWideReads);
  }
  // the stream's first kS - 1 steps (those of later tiles where a tile has fewer)
#pragma unroll
  for (int k = 0; k < kS - 1; ++k) {
    const int64_t at = tile + static_cast<int64_t>(k / kTileSteps) * gridDim.x;
    if (at < n_tiles) stage(at * kWideReads, k % kTileSteps, k);
    wide_tile::commit();
  }
  int g = 0;  // the block's steps so far: step g's weights sit in buffer g % kS
  for (; tile < n_tiles; tile += gridDim.x) {
    const int64_t first = tile * kWideReads, next = tile + gridDim.x;
    float z = 0.f;  // thread r's read first + r
    for (int pass = 0; pass < kWidePasses; ++pass) {
      const int j0 = pass * kWidePass;
      float t[4 * kL1Gr][4 * kL1Gn];
      float acc[4 * kL2Gr][4 * kL2Gn];
#pragma unroll
      for (int i = 0; i < 4 * kL2Gr; ++i) {
#pragma unroll
        for (int j = 0; j < 4 * kL2Gn; ++j) acc[i][j] = 0.f;
      }
      for (int s = 0; s < kSteps; ++s, ++g) {
        const int k = pass * kSteps + s;
        if (k == 0) {
          wide_tile::wait<0>();  // and the tile's inputs
        } else {
          wide_tile::wait<kS - 2>();
        }
        __syncthreads();  // step g has landed; step g - 1's readers are done
        const int kn = k + kS - 1;  // the stream's step g + kS - 1, of this tile or a later one
        const int64_t at = tile + static_cast<int64_t>(kn / kTileSteps) * gridDim.x;
        if (at < n_tiles) stage(at * kWideReads, kn % kTileSteps, g + kS - 1);
        if (kAhead && k == 0 && next < n_tiles) {
          wide_tile::stage_ids<kWideReads, kPos, Threads>(ids, kmer_ids, next * kWideReads, n_reads);
        }
        wide_tile::commit();
        const int c = s / kWideInSteps, q = s % kWideInSteps, i0 = q * kWideCols, b = g % kS;
        const float* x = kWideWhole ? xs : xs + b * kWideCols * kXStride;
        const float* w1 = w1s + b * kWideCols * kW1sStride;
        const int n_x = kIn - i0 < kWideCols ? kIn - i0 : kWideCols;  // the step's inputs (the bias aside)
        if (p1.active()) {
          wide_tile::fma_rows<kL1Gr, kL1Gn, kL1Tr, kL1Tn, kXStride, kW1sStride>(x + (kWideWhole ? i0 : 0) * kXStride,
                                                                               w1, n_x, q == 0, p1.tr, p1.tn, t);
        }
        if (q == kWideInSteps - 1) {
          // + b1' (column n_in of the step), relu, to h1[unit][read]
          if (p1.active()) {
            const float* bias = w1 + (kIn - i0) * kW1sStride;
#pragma unroll
            for (int h = 0; h < kL1Gn; ++h) {
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                const int u = 4 * (p1.tn + h * kL1Tn) + f;
                const float b1 = bias[u];
#pragma unroll
                for (int gr = 0; gr < kL1Gr; ++gr) {
                  *reinterpret_cast<float4*>(hs + u * kHStride + 4 * (p1.tr + gr * kL1Tr)) = make_float4(
                      fmaxf(t[4 * gr][4 * h + f] + b1, 0.f), fmaxf(t[4 * gr + 1][4 * h + f] + b1, 0.f),
                      fmaxf(t[4 * gr + 2][4 * h + f] + b1, 0.f), fmaxf(t[4 * gr + 3][4 * h + f] + b1, 0.f));
                }
              }
            }
          }
          __syncthreads();
          if (kAhead && k == kTileSteps - 1 && next < n_tiles) {  // x is read no more: the next tile's
            stage_inputs(next * kWideReads);
            wide_tile::commit();
          }
          if (p2.active()) {
            wide_tile::fma_rows<kL2Gr, kL2Gn, kL2Tr, kL2Tn, kHStride, kWidePass>(
                hs, w2s + g / kWideInSteps % kS * kWideChunk * kWidePass, kWideChunk, false, p2.tr, p2.tn, acc);
          }
        }
      }
      // the head of the pass: kPiece outputs at a time through hs, each
      // read's in output order
      for (int p0 = 0; p0 < kWidePass; p0 += kPiece) {
        __syncthreads();  // hs is free
        if (p2.active()) {
#pragma unroll
          for (int h = 0; h < kL2Gn; ++h) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int o = 4 * (p2.tn + h * kL2Tn) + f - p0;
              if (o < 0 || o >= kPiece) continue;
#pragma unroll
              for (int gr = 0; gr < kL2Gr; ++gr) {
                *reinterpret_cast<float4*>(hs + o * kHStride + 4 * (p2.tr + gr * kL2Tr)) =
                    make_float4(acc[4 * gr][4 * h + f], acc[4 * gr + 1][4 * h + f], acc[4 * gr + 2][4 * h + f],
                                acc[4 * gr + 3][4 * h + f]);
              }
            }
          }
        }
        __syncthreads();
        if (tid < kWideReads) {
          for (int o = 0; o < kPiece && j0 + p0 + o < kH2; ++o) {
            const int j = j0 + p0 + o;
            z = fmaf(__ldg(weights + kOffW3 + j), fmaxf(hs[o * kHStride + tid] + __ldg(weights + kOffB2 + j), 0.f), z);
          }
        }
      }
    }
    if (tid < kWideReads) {
      z += __ldg(weights + kOffB3);
      if (first + tid < n_reads) p_out[first + tid] = 1.f / (1.f + expf(-z));
    }
    if (kWideWhole && !kAhead && next < n_tiles) {  // a tile of fewer steps than stages: its inputs now
      __syncthreads();
      wide_tile::stage_ids<kWideReads, kPos, Threads>(ids, kmer_ids, next * kWideReads, n_reads);
      wide_tile::commit();
      wide_tile::wait<0>();
      __syncthreads();
      stage_inputs(next * kWideReads);
      wide_tile::commit();
    }
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

// 1 - v in units of 2^-24: exact for v in [0, 1] (the note above)
__device__ __forceinline__ uint32_t one_minus_units(float v) {
  return __float2uint_rz((1.f - v) * 16777216.f);
}

// the sum of v over the lanes of `group` (a site's), in each of them
__device__ __forceinline__ uint32_t group_sum(unsigned group, uint32_t v) {
  return __reduce_add_sync(group, v);
}

__global__ void __launch_bounds__(kSiteThreads)
site_reduce_kernel(const float* __restrict__ p, const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ counts, int64_t n_reads,
                   int64_t n_sites, float threshold, int n_samples,
                   float* __restrict__ site_p, float* __restrict__ mod_ratio) {
  constexpr int G = kSiteLanes;
  constexpr int kSitesPerWarp = 32 / G;
  constexpr int kWarps = kSiteThreads / 32;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, t = lane % G;
  const unsigned group = G == 32 ? kAll : ((1u << G) - 1u) << (lane - t);  // the lanes of this lane's site
  const int64_t n_runs = (n_sites + kSitesPerWarp - 1) / kSitesPerWarp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t run = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; run < n_runs; run += stride) {
    const int64_t site = run * kSitesPerWarp + lane / G;
    int32_t begin = 0, count = 0;
    if (site < n_sites) {  // the G lanes of a site read one address, the warp's sites neighbouring ones
      begin = offsets[site];
      count = counts[site];
    }
    // a span that leaves p gives NaN and loads nothing
    const bool ok = count >= 0 && begin >= 0 && static_cast<int64_t>(begin) + count <= n_reads;
    // the span's 16-byte chunks: chunk q holds reads a + 4q .. a + 4q + 3,
    // of which read a + 4q + k is the site's when mis <= 4q + k < mis + n
    const uint32_t mis = ok ? static_cast<uint32_t>((reinterpret_cast<uintptr_t>(p + begin) >> 2) & 3) : 0u;
    const float* a = p + begin - mis;
    const int chunks = ok && count > 0 ? static_cast<int>((static_cast<int64_t>(mis) + count + 3) >> 2) : 0;
    uint64_t units = 0;  // this lane's share of the site's 1 - p, in 2^-24 units
    uint32_t hits = 0;
    bool bad = false;    // a read outside [0, 1]
    // lane t of the site takes chunks t, t + G, ...: kChunkLoads of them at once
    for (int q0 = t; __any_sync(kAll, q0 < chunks); q0 += G * kChunkLoads) {
      float4 v[kChunkLoads];
#pragma unroll
      for (int m = 0; m < kChunkLoads; ++m) {
        const int q = q0 + G * m;
        v[m] = q < chunks ? reinterpret_cast<const float4*>(a)[q] : make_float4(1.f, 1.f, 1.f, 1.f);
      }
      uint32_t round_units = 0;  // at most kChunkLoads * 2^26
#pragma unroll
      for (int m = 0; m < kChunkLoads; ++m) {
        const int q = q0 + G * m;
        if (q >= chunks) break;  // a warp skips what none of its lanes holds
        const uint32_t r = 4u * static_cast<uint32_t>(q) - mis;  // span index of the chunk's first read
        const float x[4] = {v[m].x, v[m].y, v[m].z, v[m].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = r + k < static_cast<uint32_t>(count);
          const float y = in ? x[k] : 1.f;
          round_units += one_minus_units(y);
          hits += in && y >= threshold ? 1u : 0u;
          bad |= !(y >= 0.f && y <= 1.f);
        }
      }
      units += round_units;
    }
    // the site's sums, exact in any order: split at bit 24, neither half's
    // sum over the site's lanes passes 32 bits; every site of the warp adds
    // up at once, each over its own lanes
    const uint32_t sum_hi = group_sum(group, static_cast<uint32_t>(units >> 24));
    const uint32_t sum_lo = group_sum(group, static_cast<uint32_t>(units & 0xffffffu));
    const uint32_t sum_hits = group_sum(group, hits);
    const bool any_bad = (__ballot_sync(kAll, bad) & group) != 0;
    if (t == 0 && site < n_sites) {
      float sp = __int_as_float(0x7fc00000), mr = sp;
      if (ok) {
        const double cnt = count > 1 ? static_cast<double>(count) : 1.0;
        const uint64_t total = (static_cast<uint64_t>(sum_hi) << 24) + sum_lo;
        const float mean = any_bad ? sp : static_cast<float>(static_cast<double>(total) * 0x1p-24 / cnt);
        sp = 1.f - integer_pow(mean, n_samples);
        mr = static_cast<float>(sum_hits) / static_cast<float>(cnt);
      }
      site_p[site] = sp;
      mod_ratio[site] = mr;
    }
  }
}

// `kernel` (a phase A of `threads` threads a block taking `tile` reads a
// block and round, with `smem` bytes of dynamic shared memory) over the
// batch, on a grid of the blocks that fit the card at once
template <class Kernel>
cudaError_t launch_phase_a(Kernel kernel, int threads, int64_t tile, int smem, const float* features,
                           const KmerId* kmer_ids, const float* weights, int64_t n_reads, float* p,
                           cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t needed = (n_reads + tile - 1) / tile;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  kernel<<<grid, threads, smem, stream>>>(features, kmer_ids, weights, n_reads, p);
  return cudaGetLastError();
}

// (a template, so that only the kernel of the widths' plan is built; a
// tail, M6A_TAIL_IN, takes the fast plan alone: where its widths take the
// wide one, read_prob_wide() says so and no kernel is built or launched)
template <bool Wide = kWide>
cudaError_t launch_read_prob(const float* features, const KmerId* kmer_ids,
                             const float* weights, int64_t n_reads, float* p,
                             cudaStream_t stream) {
  if constexpr (Wide && M6A_TAIL_IN > 0) {
    return cudaErrorNotSupported;
  } else if constexpr (Wide) {
    return launch_phase_a(read_prob_wide_kernel<kWideThreads>, kWideThreads, kWideReads, kWideSmem, features,
                          kmer_ids, weights, n_reads, p, stream);
  } else {
    return launch_phase_a(read_prob_kernel<kReads, kLaneGroup>, kReadThreads,
                          static_cast<int64_t>(kReadThreads) * kReads, kWeightsDynamic ? kWeights * 4 : 0, features,
                          kmer_ids, weights, n_reads, p, stream);
  }
}

cudaError_t launch_site_reduce(const float* p, const int32_t* offsets, const int32_t* counts,
                               int64_t n_reads, int64_t n_sites, float threshold, int n_samples,
                               float* site_p, float* mod_ratio, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, site_reduce_kernel, kSiteThreads, 0);
  }
  if (err != cudaSuccess) return err;
  constexpr int64_t kWarps = kSiteThreads / 32;
  const int64_t runs = (n_sites + 32 / kSiteLanes - 1) / (32 / kSiteLanes);
  const int64_t needed = (runs + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  site_reduce_kernel<<<grid, kSiteThreads, 0, stream>>>(p, offsets, counts, n_reads, n_sites, threshold,
                                                        n_samples, site_p, mod_ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One inference step: phase A (per-read p) then phase B (per-site
// reductions), both on `stream`.  Returns the CUDA error code of the
// launches (0 = success).
int fused_infer_launch(const float* features, const KmerId* kmer_ids,
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
    err = launch_site_reduce(p, offsets, counts, n_reads, n_sites, threshold, n_samples, site_p,
                             mod_ratio, stream);
  }
  return static_cast<int>(err);
}

// Phase B alone: per-site site_p and mod_ratio from a p computed before on
// `stream` (the reduced-precision modes' phase A is read_prob_tc.cu).
// Returns the CUDA error code of the launch (0 = success).
int site_reduce_launch(const float* p, const int32_t* offsets, const int32_t* counts,
                       float* site_p, float* mod_ratio, int64_t n_reads, int64_t n_sites,
                       float threshold, int n_samples, void* stream_ptr) {
  if (n_sites <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_site_reduce(p, offsets, counts, n_reads, n_sites, threshold,
                                             n_samples, site_p, mod_ratio,
                                             static_cast<cudaStream_t>(stream_ptr)));
}

// Phase A alone: per-read p, on `stream` (the encoder-only entry point,
// replacing m6anet_tpu/ops/encoder_kernel.py:207 fused_read_probability).
// Returns the CUDA error code of the launch (0 = success).
int read_prob_launch(const float* features, const KmerId* kmer_ids,
                     const float* weights, float* p, int64_t n_reads,
                     void* stream_ptr) {
  if (n_reads <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_read_prob(features, kmer_ids, weights, n_reads, p,
                                           static_cast<cudaStream_t>(stream_ptr)));
}

// Reads one block of phase A takes per tile (threads x reads per thread):
// the tile whose ragged edge the tests and chip_smoke.py exercise.
int read_prob_tile_reads(void) { return kWide ? kWideReads : kReadThreads * kReads; }

// 1 where phase A takes the wide plan (read_prob_wide_kernel), else 0.
int read_prob_wide(void) { return kWide ? 1 : 0; }

// The lanes of a group that share their reads' h1 in phase A (G): 1 where
// each lane keeps its own reads (the R plan alone, or the wide plan).
int read_prob_lane_group(void) { return kWide ? 1 : kLaneGroup; }

const char* fused_infer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
