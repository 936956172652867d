// Phase A of the fused inference step in its two reduced-precision modes,
// f32x3 and bf16, on Hopper's tensor cores (sm_90a): warpgroup wgmma with
// the read stream staged by bulk asynchronous copies.
//
// Replaces: m6anet_tpu/ops/fused_infer_kernel.py:397 (fused_inference_t, compute_dtype f32x3 / bf16)
//
// Its entry point read_prob_tc_launch is phase A of the same two modes of
// three TPU kernels; the two fused ones follow it with phase B of
// fused_infer.cu (site_reduce_launch), and all three follow
// fused_inference_t's arithmetic (see ops/fused_infer_kernel.py):
//   fused_inference_t       m6anet_tpu/ops/fused_infer_kernel.py:397 (body :304-348)
//   fused_read_probability  m6anet_tpu/ops/encoder_kernel.py:207 (policies :108-193)
//   fused_inference         m6anet_tpu/ops/fused_infer_kernel.py:134 (body :83-92)
//
// What it computes, per read r (x = [features[r, 0:3P], emb[k0], ...,
// emb[k(P-1)]], n_in = 3P + PE inputs, eval BatchNorm folded into W1', b1'),
// as the JAX kernel _fused_infer_kernel_t
// (m6anet_tpu/ops/fused_infer_kernel.py:304-348), at the model's widths:
// P k-mer positions, an embedding of E dimensions over V k-mers, hidden
// widths H1 and H2 (the released models: 3, 2, 66, 150, 32).  The widths
// are compile-time constants, the M6A_* macros below: by default the
// released models', else set by ops/fused_infer_kernel.py::kernel_defines
// (one library a set of widths, built at first use).
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
// Bound on an H100 SXM, per read: 13 P + 4 bytes (features, int8 k-mer
// ids, p); f32x3: layer 1's 2 n_in H1 FLOP on the FP32 cores (67 TFLOP/s)
// beside the three-pass layer 2 and head's 6 (H1 H2 + H2) FLOP of bf16 on
// the tensor cores (989 TFLOP/s, another pipe); bf16: 2 (n_in H1 + H1 H2 +
// H2) FLOP on the tensor cores.  At the released widths and 1,048,576
// reads: 45 MB (0.0135 ms at 3.35 TB/s); f32x3 4.72 GFLOP f32 (0.070 ms)
// and 30.4 GFLOP bf16 (0.031 ms): 0.070 ms; bf16 14.85 GFLOP, 0.015 ms.
//
// Design.  The kernel before this one (a warp per 16 reads on mma.sync)
// issued about half of its slots: each tile waited for its scalar input
// loads, each k step was one dependent chain at 4 warps a scheduler, and
// mma.sync took 80 B-fragment loads a tile.  scripts/sweep_read_prob_tc.py
// --reference times its ablations.  This one:
//  * A persistent grid of one block per SM, warp-specialised.  The last
//    warpgroup is the producer: one of its threads keeps bulk copies
//    (cp.async.bulk ... mbarrier::complete_tx) in flight, one per array per
//    item, into a ring of stages, each with a full and an empty mbarrier.
//    An item is one or more tiles of 64 reads (wgmma's M): 2,304 B of
//    features and 192 B of k-mer ids a tile, so every item starts 16-byte
//    aligned from the tensors' start.  Inputs that start off a 16-byte
//    boundary (a view such as features[k:]) are copied from the boundary
//    below, within the same 16-byte chunk; an item whose copy would end
//    past the tensors (the ragged last one) is read with plain loads, never
//    past n_reads.  The consumer warpgroups take the ring's items in turn;
//    setmaxnreg moves the producer's registers to them.  Each consumer
//    thread frees its stage as soon as its reads' inputs are in registers.
//    Each mode has its own block (Cfg): f32x3 2 consumer warpgroups of 2
//    tiles an item, bf16 3 of 1, at the released widths; wider models hold
//    more a tile, so f32x3_plan gives f32x3 1 tile where H2 > 32 or n_in >
//    32 and bf16_plan 2 consumer warpgroups (168 registers a thread in a
//    block of 384, against 128 in 512) where H1 > 160 or H2 > 32, each with
//    fewer stages where the block would pass a block's shared memory.
//  * Past H1 = 256 or H2 = 64 (a thread's accumulators) or where even the
//    smallest block passes the shared memory, a mode takes the wide plan
//    (wide() below): read_prob_tc_wide_kernel on mma.sync.m16n8k16 (whose
//    fragments are the layouts wgmma gives each warp here, so every sum is
//    the same chunked tensor-core sum).  Its earlier design, a warp per 16
//    reads fetching every B fragment itself from device memory for one mma
//    and forming layer 1 again for each pass of 64 outputs, was bound by
//    that traffic (bf16: ~384 KB of weights through L1 and L2 a 16-read
//    tile) and by f32x3's layer-1 loads.  Now a block of 8 warps takes 128
//    reads, a warp each m16 tile, and walks H1 in steps of 32 to 256 units
//    (tc_chunk) whose weights it stages in shared memory once (cp.async, up
//    to 4 steps in flight), so each fragment fetched feeds 8 tiles, and the
//    next tile's inputs come in under this one; f32x3's layer 1 runs over the
//    whole tile on the FP32 cores as fused_infer.cu's wide plan does
//    (wide_tile.cuh's micro-tiles) and reaches each warp as hi / lo bf16
//    through shared memory (ldmatrix), once per step.  A warp holds up to
//    16 n8 tiles of H2 (128 outputs), so layer 1 is formed once where H2 <=
//    128, and the head's per-lane sums run in the plain version's order.
//  * The weights are staged once per block (the mode's range of the image;
//    prepare_fused_params_t lays it out).  Each wgmma B operand (bf16(W2),
//    W2 - bf16(W2), bf16(W1')) sits in the canonical K-major layout without
//    swizzle: core matrices of 8 n x 8 k bf16 (128 contiguous bytes, a row
//    of 8 k per 16 bytes), the two k halves of a k16 step kBLbo bytes apart,
//    groups of 8 n kBSbo bytes apart, addressed by matrix descriptors.
//  * Lane l of warp w of a consumer warpgroup is group g = l / 4, thread
//    t = l % 4 of the fragments: it owns rows 16w + g and 16w + g + 8 of
//    each 64-read tile.  wgmma's register A fragment and its m64nN
//    accumulator give every warp the layouts of mma.m16n8k16 and its n8
//    tiles, so the per-lane arithmetic is the earlier kernel's.
//  * f32x3: layer 1 stays on the FP32 cores in fused_infer.cu's FMA order
//    (h1 bit for bit as before), each lane for 2 reads of each of its
//    tiles and the 4 units its A fragment holds per k step (a group of 8
//    padded units past H1, 152-159 of step 9 at H1 = 150, is skipped: its
//    h1 is 0).  A lane keeps its reads' n_in inputs in registers (4 x 15
//    at the released widths); where they do not fit (f32x3_plan: more
//    than 60 values) it copies them from the stage into a shared-memory
//    row per read (an odd stride, so the 8 rows a warp reads at once sit
//    in 8 banks) and layer 1 reads them there.  Layer 2 runs on
//    wgmma.m64nNk16 (N = H2 padded to 8, 32 at the released widths) with
//    A from registers: W2lo.h1hi then W2hi.h1lo accumulate in one
//    accumulator, step by step; each step's W2hi.h1hi
//    goes into its own accumulator (scale-d = 0) and is added to the
//    running f32 sum in step order.  The A fragments are double-buffered:
//    layer 1 of step j + 1 runs while step j's wgmma is in flight.
//  * bf16: layer 1 is one wgmma.m64n160k16 per tile at the released
//    widths (A the packed inputs, k = 15 zero, the bias never folded into
//    the bf16 operand); at others ceil(n_in / 16) k steps into one
//    accumulator, each as wgmma of N = H1 padded to 16 in pieces of at most
//    64 (160 whole).  Its accumulators of n8 tiles 2j, 2j + 1 are exactly
//    layer 2's A fragment
//    of k step j: bias, relu and the bf16 pack happen in registers, so h1
//    never leaves them.  Layer 2 takes one zero-accumulator wgmma a step,
//    f32-added in order; its accumulator is double-buffered under
//    wgmma.wait_group 1, so two steps are in flight.
//  * Sums.  The tensor cores add a k16 step's products and truncate the
//    sum toward zero; the zero-accumulator steps and f32 adds keep that
//    from drifting over the steps (the plain version models the same
//    truncated k16 chunks).
//  * The head (H2 -> 1) is a dot over the lane's H2 / 4 entries of a read's
//    layer-2 accumulators, summed across the quad with two xor shuffles;
//    lane t = 0 stores read g, t = 1 read g + 8.  Repeats are
//    bit-identical (no atomics), and a read's p does not depend on its
//    place in the batch.
//  * A barrier wait that spins for ~10 s traps (a fault, never a hang).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// without --use_fast_math.  Plain C interface, called through ctypes from
// ops/fused_infer_kernel.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The widths (the released models' by default)
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
// bytes of a k-mer id: 1 (int8) by default, 2 (int16) for ids past 127
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
constexpr int kPos = M6A_POS;
constexpr int kFeat = 3 * kPos;
constexpr int kVocab = M6A_VOCAB;
constexpr int kEmb = M6A_EMB;
constexpr int kIn = kFeat + kPos * kEmb;        // n_in, 15
constexpr int kH1 = M6A_H1;
constexpr int kH2 = M6A_H2;
constexpr int kH1Pad = (kH1 + 15) / 16 * 16;    // hidden units, zero padded (160)
constexpr int kH2Pad = (kH2 + 7) / 8 * 8;       // (32)
constexpr int kKSteps = kH1Pad / 16;   // layer 2's k16 steps (10)
constexpr int kTiles1 = kH1Pad / 8;    // layer 1's n8 tiles, bf16 (20)
constexpr int kTiles2 = kH2Pad / 8;    // layer 2's n8 tiles (4)
constexpr int kK1Steps = (kIn + 15) / 16;       // layer 1's k16 steps, bf16 (1)
constexpr int kW1Stride = (kIn + 4) / 4 * 4;    // f32x3 layer 1's row: n_in weights, the bias (16)
constexpr int kW1Quads = kW1Stride / 4;
constexpr int kEmbWords = (kVocab * kEmb + 3) / 4 * 4;
static_assert(kKSteps * 16 == kH1Pad && kTiles1 * 8 == kH1Pad && kTiles2 * 8 == kH2Pad, "tiles");

// Weight image (32-bit words), written by prepare_fused_params_t
// (ops/fused_infer_kernel.py::tc_layout; a bf16x2 word holds the smaller k
// in its low half):
//   W1F  [kKSteps][4 slots c][kW1Quads quads q][4 threads t] float4: f32x3
//        layer 1, floats 4q..4q+3 of row u = 16j + 2t + (c & 1) + 8 (c >> 1)
//        of [W1'[u, 0:n_in], b1'[u], zeros] (zero for u >= H1)
//   EMBX [V][E] f32: hi + lo of the embedding (f32x3), zeros to kEmbWords
//   W3L  [kH2Pad] f32: bf16(w3 - bf16(w3)) (f32x3)
//   W2L  [kKSteps][kTiles2 n groups][2 k halves][8 n][8 k] bf16: W2 - bf16(W2)
//        at n = 8 group + row, k = 16 step + 8 half + col (f32x3)
//   W2H  the same for bf16(W2) (both modes)
//   B2 [kH2Pad], W3H [kH2Pad] bf16(w3), B3 [1] + zero padding (both modes)
//   W1H  [kK1Steps][kTiles1 n groups][2 k halves][8 n][8 k] bf16: bf16(W1'),
//        zero for k >= n_in (bf16)
//   B1   [kH1Pad] f32: b1', zero past H1 (bf16)
//   EMBH [V][E] f32: bf16(e), zeros to kEmbWords (bf16)
//   W1T  [n_in + 1][kH1Pad] f32: W1F's rows input-major, the bias last
//        (f32x3's wide plan: a step's columns are whole 16-byte runs)
constexpr int kTcOffW1F = 0;
constexpr int kTcOffEmbX = kTcOffW1F + kKSteps * 4 * kW1Stride * 4;  // 2560
constexpr int kTcOffW3L = kTcOffEmbX + kEmbWords;                     // 2692
constexpr int kTcOffW2L = kTcOffW3L + kH2Pad;                         // 2724
constexpr int kTcOffW2H = kTcOffW2L + kKSteps * kTiles2 * 32 * 2;     // 5284
constexpr int kTcOffB2 = kTcOffW2H + kKSteps * kTiles2 * 32 * 2;      // 7844
constexpr int kTcOffW3H = kTcOffB2 + kH2Pad;                          // 7876
constexpr int kTcOffB3 = kTcOffW3H + kH2Pad;                          // 7908
constexpr int kTcOffW1H = kTcOffB3 + 4;                               // 7912
constexpr int kTcOffB1 = kTcOffW1H + kK1Steps * kTiles1 * 32 * 2;     // 9192
constexpr int kTcOffEmbH = kTcOffB1 + kH1Pad;                         // 9352
constexpr int kTcOffW1T = kTcOffEmbH + kEmbWords;                     // 9484
constexpr int kTcWords = kTcOffW1T + (kIn + 1) * kH1Pad;              // 12044

// The B operands' canonical K-major layout (bytes): a core matrix row of 8
// k values, the two k halves of a k16 step, groups of 8 n, a k step of W2
// and of W1H.
constexpr int kBRowBytes = 16;
constexpr int kBLbo = 128;
constexpr int kBSbo = 256;
constexpr int kW2StepBytes = kTiles2 * kBSbo;  // 1024
constexpr int kW1StepBytes = kTiles1 * kBSbo;  // 5120
static_assert(8 * kBRowBytes == kBLbo && 2 * kBLbo == kBSbo, "core matrices back to back");
static_assert(kKSteps * kW2StepBytes == kKSteps * kTiles2 * 32 * 2 * 4, "W2's size in the image");

constexpr int kModeF32x3 = 1;
constexpr int kModeBf16 = 2;
static_assert(kTcOffW2L % 4 == 0 && kTcOffW2H % 4 == 0 && kTcOffW1H % 4 == 0 && kTcOffW1T % 4 == 0 &&
                  kTcWords % 4 == 0,
              "16-byte aligned ranges");

// The block of each mode: consumer warpgroups and one producer warpgroup,
// stages in the input ring, 64-read tiles an item (a lane holds 2 reads of
// each), and the registers setmaxnreg leaves a producer thread.
// scripts/sweep_read_prob_tc.py rewrites them and times each build: f32x3
// gains from 4 reads a lane (layer 1's W1 rows feed twice the reads), bf16
// from a third consumer warpgroup (more wgmma chains in flight).  They hold
// at the released widths; at others the block follows from the widths
// (f32x3_plan, bf16_plan below).
constexpr int kF32x3Consumers = 2;
constexpr int kF32x3Stages = 4;
constexpr int kF32x3Tiles = 2;
constexpr int kBf16Consumers = 3;
constexpr int kBf16Stages = 3;
constexpr int kBf16Tiles = 1;
constexpr int kProducerRegs = 24;
constexpr int kGroupThreads = 128;
constexpr int kTileReads = 64;
constexpr long long kWaitTrapCycles = 20000000000LL;  // ~10 s at 2 GHz
constexpr int kSharedLimit = 232448;  // dynamic shared memory a block may opt into on sm_90
constexpr int kLaneInputs = 60;       // f32x3 inputs a lane holds in registers: 4 reads x 15

struct Plan {
  int consumers;
  int stages;
  int tiles;       // 64-read tiles an item
  bool x_shared;   // f32x3: a lane's inputs wait in a shared-memory row per read
};

// Dynamic shared memory of a block of `plan`: the mode's contiguous range
// of the image (f32x3 everything before W1H, bf16 W2H up to W1T),
// the ring's stages (an item's features and k-mer ids, each with the up to
// 15 bytes before a misaligned start), f32x3's input rows (kIn | 1 floats a
// read, odd so the 8 rows a warp reads at once sit in 8 banks), the ring's
// full and empty barriers.  ops/fused_infer_kernel.py::kernel_limit checks
// that the smallest block (one tile, 2 stages, the rows) fits.
constexpr int stage_bytes(int tiles) {
  return kTileReads * tiles * kFeat * 4 + 16 + kTileReads * tiles * kPos * kIdBytes + 16;
}
constexpr int image_bytes(bool f32x3) { return (f32x3 ? kTcOffW1H - kTcOffW1F : kTcOffW1T - kTcOffW2H) * 4; }
constexpr int rows_bytes(const Plan& plan) {
  return plan.x_shared ? plan.consumers * kTileReads * plan.tiles * (kIn | 1) * 4 : 0;
}
constexpr int smem_bytes(bool f32x3, const Plan& plan) {
  return image_bytes(f32x3) + plan.stages * stage_bytes(plan.tiles) + rows_bytes(plan) + 2 * plan.stages * 8;
}

// f32x3: kF32x3Tiles tiles an item where a lane's three layer-2
// accumulators (3 kH2Pad / 2 a tile) and layer-1 rows fit its registers
// (H2 <= 32 and n_in <= 32), else 1; a lane's inputs in registers up to
// kLaneInputs, else in shared memory; kF32x3Stages stages, or fewer where
// the block would pass kSharedLimit.
constexpr Plan f32x3_plan() {
  for (int tiles = kH2Pad <= 32 && kIn <= 32 ? kF32x3Tiles : 1; tiles >= 1; --tiles) {
    for (int stages = kF32x3Stages; stages >= kF32x3Consumers; stages -= kF32x3Consumers) {
      const Plan plan{kF32x3Consumers, stages, tiles, 2 * tiles * kIn > kLaneInputs};
      if (smem_bytes(true, plan) <= kSharedLimit) return plan;
    }
  }
  return Plan{kF32x3Consumers, kF32x3Consumers, 1, 2 * kIn > kLaneInputs};  // the smallest: kWide below
}

// bf16: a consumer thread holds kH1Pad / 2 layer-1 accumulators; kBf16Consumers
// warpgroups (128 registers a thread in a block of 512) up to the released
// 160 / 32, else 2 (168 in a block of 384) over 4 stages, or 2 where the
// block would pass kSharedLimit.
constexpr Plan bf16_plan() {
  const Plan plan = kH1Pad <= 160 && kH2Pad <= 32 ? Plan{kBf16Consumers, kBf16Stages, kBf16Tiles, false}
                                                  : Plan{2, 4, kBf16Tiles, false};
  return smem_bytes(false, plan) <= kSharedLimit ? plan : Plan{2, 2, kBf16Tiles, false};
}

// The warpgroup kernel above takes H1 <= 256 and H2 <= 64 (a thread's
// accumulators) where its smallest block fits the shared memory.  Past
// that a mode takes the wide plan: read_prob_tc_wide_kernel, a warp per
// 16-read m16 tile of a block's kTcWideWarps, on mma.sync.m16n8k16; H1 in
// steps of tc_chunk() units whose weights the block stages in shared
// memory once for all its tiles; layer 2 in passes of at most
// kWidePassTiles n8 tiles of H2 (one at H2 <= 128).
constexpr bool wide(bool f32x3) {
  return kH1Pad > 256 || kH2Pad > 64 || smem_bytes(f32x3, f32x3 ? f32x3_plan() : bf16_plan()) > kSharedLimit;
}
// The wide plan's tunings: layer-2 n8 tiles a pass at most, warps a block
// (a 16-read tile each), hidden units a step (a multiple of 32: f32x3's
// layer-1 micro-tiles of 4 reads x 4 units cover it; twice the chunk where
// a pass's accumulators leave a thread the registers, at most 8 n8 tiles
// in f32x3, 4 in bf16, and four times in bf16 where layer 1 also takes at
// most 2 k16 steps, its accumulators then consumed as they are formed:
// fewer steps, fewer barriers), weight buffers in flight at most (a step's
// copies run under the steps before; fewer where the block would pass the
// shared memory), and inputs a step where a tile's inputs do not fit whole
// (f32x3: columns; bf16: this over 16 k16 steps of them).  Where a pass
// holds at most 4 n8 tiles, two blocks share an SM where they fit
// (wide_plan).  scripts/sweep_wide.py builds copies with these lines
// rewritten and times each on the card; these ran fastest at (11, 8, 512,
// 128) and (3, 2, 512, 32) (PERF.md section 6).
constexpr int kWidePassCap = 16;
constexpr int kTcWideWarps = 8;
constexpr int kF32x3WideChunk = 32;
constexpr int kBf16WideChunk = 64;
constexpr int kTcWideStages = 4;
constexpr int kTcWideInCap = 64;
constexpr int kWidePassTiles = kTiles2 < kWidePassCap ? kTiles2 : kWidePassCap;
constexpr int kWidePasses = (kTiles2 + kWidePassTiles - 1) / kWidePassTiles;
constexpr int kTcWideReads = 16 * kTcWideWarps;
constexpr int kTcWideThreads = 32 * kTcWideWarps;
// hidden units a step
constexpr int tc_chunk(bool f32x3) {
  return f32x3 ? (kWidePassTiles <= 8 ? 2 : 1) * kF32x3WideChunk
               : (kWidePassTiles > 4 ? 1 : kK1Steps <= 2 ? 4 : 2) * kBf16WideChunk;
}
// f32x3's layer-1 micro-tile: 4 reads x 4 (chunk / 32) units a thread, a
// kX3Tr x 8 grid of threads (wide_tile.cuh), as fused_infer.cu's
constexpr int kX3Tr = kTcWideReads / 4;
constexpr int kX3Tn = 8;
static_assert(tc_chunk(true) % 32 == 0 && tc_chunk(false) % 16 == 0 && kX3Tr * kX3Tn == kTcWideThreads,
              "f32x3's micro-tiles cover a step, bf16's k16 steps");
// Shared memory.  x as f32 [input][read] (f32x3's layer-1 operand; bf16
// rounds it into bf16 [read][column] at a tile's first step) and the next
// tile's k-mer ids, where a tile's inputs fit whole; else x in steps (f32x3
// f32, bf16 bf16), a buffer a stage.  A step's layer-1 weights (f32x3 W1T's
// columns as w1[column][unit]; bf16 W1H's fragments as the image holds
// them, [k16 step][n8 tile][256 B]) and, at a unit chunk's first step, its
// W2 fragments (hi, and f32x3's lo) and bf16's b1'.  f32x3's h1 as hi and
// lo bf16 [read][unit] (a 16-byte row offset a row, so ldmatrix's 8 rows
// sit in 8 bank groups).
constexpr int kTcXStride = kTcWideReads + 4;
constexpr int up16(int n) { return (n + 15) / 16 * 16; }
struct WideLayout {
  int x, ids, xb, w1, b1, w2h, w2l, a, end;  // byte offsets in a block's dynamic shared memory
};
constexpr WideLayout tc_wide_layout(bool f32x3, bool whole, int cols, int stages) {
  const int chunk = tc_chunk(f32x3);
  const int w2_words = chunk / 16 * kWidePassTiles * 64;  // a step's W2 fragments, each of hi and lo
  WideLayout l{};
  int at = 0;
  l.x = at;
  at += 4 * (whole ? kIn : f32x3 ? stages * cols : 0) * kTcXStride;
  l.ids = at;
  at += whole ? up16(kTcWideReads * kPos * kIdBytes) : 0;
  l.xb = at;
  at += f32x3 ? 0 : 2 * (whole ? 1 : stages) * kTcWideReads * (16 * cols + 8);
  l.w1 = at;
  at += 4 * stages * cols * (f32x3 ? chunk + 4 : chunk / 8 * 64);
  l.b1 = at;
  at += f32x3 ? 0 : 4 * stages * chunk;
  l.w2h = at;
  at += 4 * stages * w2_words;
  l.w2l = at;
  at += f32x3 ? 4 * stages * w2_words : 0;
  l.a = at;
  at += f32x3 ? 2 * 2 * kTcWideReads * (chunk + 8) : 0;
  l.end = at;
  return l;
}
struct WidePlan {
  int blocks;    // blocks an SM (two at 128 registers a thread where a pass holds at most 4 n8 tiles)
  bool whole;    // a tile's inputs staged once (else in steps, a buffer a stage)
  int cols;      // a step's inputs: f32x3 layer-1 columns (the bias is column n_in), bf16 k16 steps
  int in_steps;  // steps a unit chunk takes over its inputs
  int stages;    // weight buffers
  int smem;      // dynamic shared memory bytes
};
// two blocks an SM where a pass holds at most 4 n8 tiles and they fit, the
// inputs whole where they fit, and the most stages that fit
constexpr WidePlan wide_plan(bool f32x3) {
  const int all = f32x3 ? kIn + 1 : kK1Steps;
  const int cap = f32x3 ? kTcWideInCap : kTcWideInCap / 16;
  for (int blocks = kWidePassTiles <= 4 ? 2 : 1; blocks >= 1; --blocks) {
    const int limit = blocks == 1 ? kSharedLimit : kSharedLimit / blocks - 1024;  // 1 KB an SM keeps a block
    for (int whole = 1; whole >= 0; --whole) {
      const int cols = whole ? all : cap;
      for (int stages = kTcWideStages; stages >= 2; --stages) {
        const int smem = tc_wide_layout(f32x3, whole == 1, cols, stages).end;
        if (smem <= limit) return WidePlan{blocks, whole == 1, cols, (all + cols - 1) / cols, stages, smem};
      }
    }
  }
  return WidePlan{1, false, cap, (all + cap - 1) / cap, 2, tc_wide_layout(f32x3, false, cap, 2).end};
}
static_assert(wide_plan(true).smem <= kSharedLimit && wide_plan(false).smem <= kSharedLimit && kTcWideStages >= 2,
              "a wide block fits the card");
template <int Mode>
struct WideCfg {
  static constexpr WidePlan kPlan = wide_plan(Mode == kModeF32x3);
  static constexpr int kBlocks = kPlan.blocks;
  static constexpr bool kWhole = kPlan.whole;
  static constexpr int kCols = kPlan.cols;
  static constexpr int kInSteps = kPlan.in_steps;
  static constexpr int kStages = kPlan.stages;
  static constexpr int kSmem = kPlan.smem;
  static constexpr WideLayout kAt = tc_wide_layout(Mode == kModeF32x3, kWhole, kCols, kStages);
  // the layout's offsets as scalars (what device code reads)
  static constexpr int kAtX = kAt.x, kAtIds = kAt.ids, kAtXb = kAt.xb, kAtW1 = kAt.w1, kAtB1 = kAt.b1;
  static constexpr int kAtW2h = kAt.w2h, kAtW2l = kAt.w2l, kAtA = kAt.a;
  // a step's hidden units, layer 2's k16 steps and bf16 layer 1's n8
  // tiles in them, f32x3's units a thread of its micro-tile holds / 4, the
  // rows of its w1 and h1 halves, and the words of a step's W2 fragments
  static constexpr int kChunk = tc_chunk(Mode == kModeF32x3);
  static constexpr int kKSteps = kChunk / 16, kGroups = kChunk / 8, kX3Gn = kChunk / 32;
  static constexpr int kW1Stride = kChunk + 4, kAStride = kChunk + 8, kW2Words = kKSteps * kWidePassTiles * 64;
};

template <int Mode>
struct Cfg {
  static constexpr bool kF32x3 = Mode == kModeF32x3;
  static constexpr bool kWide = wide(kF32x3);
  static constexpr Plan kPlan = kF32x3 ? f32x3_plan() : bf16_plan();
  static constexpr int kConsumers = kPlan.consumers;
  static constexpr int kStages = kPlan.stages;
  static constexpr int kTilesPerGroup = kPlan.tiles;
  static constexpr int kThreads = kGroupThreads * (kConsumers + 1);
  // Item q goes to consumer warpgroup q % kConsumers and stage q % kStages,
  // so every use of a stage goes to the same warpgroup: it has seen the
  // stage's last fill land before it waits for the next.  Otherwise a
  // warpgroup could wait on a full barrier two phases ahead, which its
  // parity wait takes for the phase before.
  static_assert(kStages % kConsumers == 0, "each stage serves one consumer warpgroup");
  static constexpr int kItemReads = kTileReads * kTilesPerGroup;
  static constexpr int kReads = 2 * kTilesPerGroup;  // reads a lane holds
  static constexpr int kItemFeatBytes = kItemReads * kFeat * 4;
  static constexpr int kItemKmerBytes = kItemReads * kPos * kIdBytes;
  static_assert(kItemFeatBytes % 16 == 0 && kItemKmerBytes % 16 == 0, "items start 16-byte aligned");
  // a stage holds an item and the up to 15 bytes before it of a misaligned start
  static constexpr int kStageFeatBytes = kItemFeatBytes + 16;
  static constexpr int kStageBytes = stage_bytes(kTilesPerGroup);
  static_assert(kStageBytes % 16 == 0, "stages stay 16-byte aligned");
  // registers a consumer thread, after setmaxnreg (with two or more consumer groups)
  static constexpr int kConsumerRegs = (65536 / kGroupThreads - kProducerRegs) / kConsumers / 8 * 8;
  static_assert(kConsumers < 2 || kConsumerRegs <= 256, "setmaxnreg takes at most 256");
  static constexpr bool kXShared = kF32x3 && kPlan.x_shared;
  static constexpr int kXStride = kIn | 1;
  // shared memory, in smem_bytes' order
  static constexpr int kBegin = kF32x3 ? kTcOffW1F : kTcOffW2H;
  static constexpr int kWords = image_bytes(kF32x3) / 4;
  static constexpr int kStagesAt = kWords * 4;  // 16-byte aligned
  static constexpr int kRowsAt = kStagesAt + kStages * kStageBytes;
  static constexpr int kBarriersAt = kRowsAt + rows_bytes(kPlan);
  static constexpr int kSmemBytes = smem_bytes(kF32x3, kPlan);
  static_assert(kBarriersAt + 2 * kStages * 8 == kSmemBytes && (kWide || kSmemBytes <= kSharedLimit),
                "a warpgroup block fits the shared memory");
};
using F32x3 = Cfg<kModeF32x3>;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > kWaitTrapCycles) __trap();
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned `src` to `dst`, counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// matrix descriptor of a K-major B operand without swizzle at `addr`
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kBLbo >> 4) << 16) |
         (static_cast<uint64_t>(kBSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_one() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// keeps the compiler from moving reads of `d` across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . B over one m64nNk16 step: A from registers, B by descriptor;
// scale_d = 0 writes the product alone.  The N this file takes: layer 2's
// H2 padded to 8 (at most 64), and bf16 layer 1's pieces (16 to 64, or 160
// whole).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<24>(float (&d)[12], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %25, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<56>(float (&d)[28], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %33, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %85, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d += a . b over one m16n8k16 step of a warp (the wide plan): A's
// fragment as wgmma's register A holds it for the warp's 16 rows, B's two
// registers (k = 2t.., 2t + 8.. of column g)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the accumulators of n8 tiles [n0 / 8, n0 / 8 + N / 8) of an m64nNk16 tile
template <int N>
__device__ __forceinline__ float (&tiles_at(float* d, int n0))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(d + n0 / 2);
}

// ------------------------------------------------------------- arithmetic
// two floats rounded to bf16 in one operand register, `lo` in the low half
// (one cvt.rn.bf16x2.f32)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// hi = bf16(a), lo = bf16(a - hi) of a pair, packed as two operand registers
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  const float ah = __uint_as_float(hi << 16), bh = __uint_as_float(hi & 0xffff0000u);
  lo = pack_bf16x2(a - ah, b - bh);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// input column c (0..n_in - 1, zero past it) of a read: its features row
// `f` and k-mer ids `k` (shared or device memory), with the mode's
// embedding table `emb` (shared)
__device__ __forceinline__ float input_col(const float* f, const KmerId* k, const float* emb, int c) {
  if (c < kFeat) return f[c];
  if (c >= kIn) return 0.f;
  return emb[kEmb * static_cast<int>(k[(c - kFeat) / kEmb]) + (c - kFeat) % kEmb];
}

// the n_in inputs of one read into registers
__device__ __forceinline__ void load_inputs(const float* f, const KmerId* k, const float* emb, float (&x)[kIn]) {
#pragma unroll
  for (int i = 0; i < kFeat; ++i) x[i] = f[i];
#pragma unroll
  for (int q = 0; q < kPos; ++q) {
    const int id = static_cast<int>(k[q]);
#pragma unroll
    for (int e = 0; e < kEmb; ++e) x[kFeat + kEmb * q + e] = emb[kEmb * id + e];
  }
}

// f32x3's inputs of a lane's reads (read i: row g + 8 (i % 2) of tile i / 2)
// in registers ...
struct RegisterInputs {
  float v[F32x3::kReads][kIn];
  __device__ __forceinline__ float at(int i, int k) const { return v[i][k]; }
};

// ... or in shared memory, from this lane's row of its item
struct SharedInputs {
  const float* row;
  __device__ __forceinline__ float at(int i, int k) const {
    return row[(64 * (i / 2) + 8 * (i % 2)) * F32x3::kXStride + k];
  }
};

// layer 1 of f32x3 for k step j: h1 of this lane's 4 units (slot c: unit
// 16j + 2t + (c & 1) + 8 (c >> 1)) for each of its reads, split and packed
// as the A fragments (hi, lo) of each tile
template <int J, class X>
__device__ __forceinline__ void layer1_f32x3(const float4* w1, int t, const X& x,
                                             uint32_t (&ahi)[F32x3::kTilesPerGroup][4],
                                             uint32_t (&alo)[F32x3::kTilesPerGroup][4]) {
  float h[4][F32x3::kReads];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (16 * J + 8 * (c >> 1) >= kH1) {  // 8 units past H1: zero weights and bias
#pragma unroll
      for (int i = 0; i < F32x3::kReads; ++i) h[c][i] = 0.f;
      continue;
    }
    const float4* row = w1 + (J * 4 + c) * 4 * kW1Quads + t;  // [j][c][q][t]
    float u[F32x3::kReads];
#pragma unroll
    for (int q = 0; q < kW1Quads; ++q) {
      const float4 v = row[4 * q];
      const float wq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
#pragma unroll
        for (int i = 0; i < F32x3::kReads; ++i) {
          if (k == 0) {
            u[i] = wq[e] * x.at(i, 0);  // fused_infer.cu's order
          } else if (k < kIn) {
            u[i] = fmaf(wq[e], x.at(i, k), u[i]);
          } else if (k == kIn) {
            h[c][i] = fmaxf(u[i] + wq[e], 0.f);  // + b1', relu
          }
        }
      }
    }
  }
  // tile tt holds reads 2tt (row g) and 2tt + 1 (row g + 8):
  // {row g, row g + 8} x {units 2t.., 2t + 8..}
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) {
    split_pack(h[0][2 * tt], h[1][2 * tt], ahi[tt][0], alo[tt][0]);
    split_pack(h[0][2 * tt + 1], h[1][2 * tt + 1], ahi[tt][1], alo[tt][1]);
    split_pack(h[2][2 * tt], h[3][2 * tt], ahi[tt][2], alo[tt][2]);
    split_pack(h[2][2 * tt + 1], h[3][2 * tt + 1], ahi[tt][3], alo[tt][3]);
  }
}

// one k step of f32x3's layer 2 and, while it runs, layer 1 of the next
template <int J, class X>
__device__ __forceinline__ void step_f32x3(const float4* w1, uint32_t w2l, uint32_t w2h, int t, const X& x,
                                           uint32_t (&ahi)[2][F32x3::kTilesPerGroup][4],
                                           uint32_t (&alo)[2][F32x3::kTilesPerGroup][4],
                                           float (&cross)[F32x3::kTilesPerGroup][kH2Pad / 2],
                                           float (&high)[F32x3::kTilesPerGroup][kH2Pad / 2],
                                           float (&part)[F32x3::kTilesPerGroup][kH2Pad / 2]) {
  constexpr int B = J & 1;
  const uint64_t dl = b_desc(w2l + J * kW2StepBytes), dh = b_desc(w2h + J * kW2StepBytes);
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) {
    fence_operands(cross[tt]);
    fence_operands(part[tt]);
  }
  wgmma_fence();
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) {
    wgmma<kH2Pad>(cross[tt], ahi[B][tt], dl, 1);  // W2lo.h1hi
    wgmma<kH2Pad>(cross[tt], alo[B][tt], dh, 1);  // + W2hi.h1lo
    wgmma<kH2Pad>(part[tt], ahi[B][tt], dh, 0);   // W2hi.h1hi alone
  }
  wgmma_commit();
  if constexpr (J + 1 < kKSteps) layer1_f32x3<J + 1>(w1, t, x, ahi[B ^ 1], alo[B ^ 1]);
  wgmma_wait_all();
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) {
    fence_operands(part[tt]);
#pragma unroll
    for (int i = 0; i < kH2Pad / 2; ++i) high[tt][i] += part[tt][i];
  }
  if constexpr (J + 1 < kKSteps) step_f32x3<J + 1>(w1, w2l, w2h, t, x, ahi, alo, cross, high, part);
}

// z of this lane's reads (2tt: row g, 2tt + 1: row g + 8 of tile tt), f32x3;
// s is the staged range [0, W1H)
template <class X>
__device__ __forceinline__ void f32x3_reads(const uint32_t* s, int t, const X& x, float (&z)[F32x3::kReads]) {
  const float* sf = reinterpret_cast<const float*>(s);
  const float4* w1 = reinterpret_cast<const float4*>(sf + kTcOffW1F);
  const uint32_t w2l = smem_addr(s + kTcOffW2L), w2h = smem_addr(s + kTcOffW2H);
  uint32_t ahi[2][F32x3::kTilesPerGroup][4], alo[2][F32x3::kTilesPerGroup][4];
  float cross[F32x3::kTilesPerGroup][kH2Pad / 2], high[F32x3::kTilesPerGroup][kH2Pad / 2];
  float part[F32x3::kTilesPerGroup][kH2Pad / 2];
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) {
#pragma unroll
    for (int i = 0; i < kH2Pad / 2; ++i) cross[tt][i] = high[tt][i] = part[tt][i] = 0.f;
  }
  layer1_f32x3<0>(w1, t, x, ahi[0], alo[0]);
  step_f32x3<0>(w1, w2l, w2h, t, x, ahi, alo, cross, high, part);
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) fence_operands(cross[tt]);

  // head: this lane's h2 entries n = 8 nt + 2t + e of rows g (r = 0), g + 8
  const float b3 = sf[kTcOffB3];
#pragma unroll
  for (int tt = 0; tt < F32x3::kTilesPerGroup; ++tt) {
    float zx[2][2] = {}, zh[2] = {};  // w3lo.h2hi, w3hi.h2lo; w3hi.h2hi
#pragma unroll
    for (int nt = 0; nt < kTiles2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * nt + 2 * t + e;
        const float b2 = sf[kTcOffB2 + n], w3h = sf[kTcOffW3H + n], w3l = sf[kTcOffW3L + n];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = fmaxf(cross[tt][4 * nt + 2 * r + e] + high[tt][4 * nt + 2 * r + e] + b2, 0.f);
          const float vh = bf16_round(v), vl = bf16_round(v - vh);
          zx[r][0] = fmaf(w3l, vh, zx[r][0]);
          zx[r][1] = fmaf(w3h, vl, zx[r][1]);
          zh[r] = fmaf(w3h, vh, zh[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      z[2 * tt + r] = ((quad_sum(zx[r][0]) + quad_sum(zx[r][1])) + quad_sum(zh[r])) + b3;
    }
  }
}

// layer 1's A fragment of k step s of one read pair: columns 16s + 2t,
// + 1, + 8, + 9 of rows g (f0, k0) and g + 8 (f1, k1)
__device__ __forceinline__ void load_a1(const float* f0, const KmerId* k0, const float* f1, const KmerId* k1,
                                        const float* emb, int t, uint32_t (&a)[kK1Steps][4]) {
#pragma unroll
  for (int s = 0; s < kK1Steps; ++s) {
    const int c = 16 * s + 2 * t;
    a[s][0] = pack_bf16x2(input_col(f0, k0, emb, c), input_col(f0, k0, emb, c + 1));
    a[s][1] = pack_bf16x2(input_col(f1, k1, emb, c), input_col(f1, k1, emb, c + 1));
    a[s][2] = pack_bf16x2(input_col(f0, k0, emb, c + 8), input_col(f0, k0, emb, c + 9));
    a[s][3] = pack_bf16x2(input_col(f1, k1, emb, c + 8), input_col(f1, k1, emb, c + 9));
  }
}

// layer 2's A fragment of k step j: layer 1's n8 tiles 2j, 2j + 1 with the
// bias (units 16j + 2t.., 16j + 8 + 2t..), relu, packed to bf16
__device__ __forceinline__ void pack_a2(const float (&h)[kH1Pad / 2], const float2* b1, int j, int t,
                                        uint32_t (&a)[4]) {
  const float2 bl = b1[8 * j + t], bh = b1[8 * j + 4 + t];
  const float* c0 = h + 8 * j;
  const float* c1 = h + 8 * j + 4;
  a[0] = pack_bf16x2(fmaxf(c0[0] + bl.x, 0.f), fmaxf(c0[1] + bl.y, 0.f));
  a[1] = pack_bf16x2(fmaxf(c0[2] + bl.x, 0.f), fmaxf(c0[3] + bl.y, 0.f));
  a[2] = pack_bf16x2(fmaxf(c1[0] + bh.x, 0.f), fmaxf(c1[1] + bh.y, 0.f));
  a[3] = pack_bf16x2(fmaxf(c1[2] + bh.x, 0.f), fmaxf(c1[3] + bh.y, 0.f));
}

// bf16 layer 1's k step into h from unit n0 on: one wgmma.m64n160k16 at the
// released widths, else pieces of N <= 64
template <int N0>
__device__ __forceinline__ void layer1_bf16(float (&h)[kH1Pad / 2], const uint32_t (&a)[4], uint32_t w1h,
                                            int scale_d) {
  if constexpr (N0 < kH1Pad) {
    constexpr int N = kH1Pad == 160 ? 160 : (kH1Pad - N0 < 64 ? kH1Pad - N0 : 64);
    wgmma<N>(tiles_at<N>(h, N0), a, b_desc(w1h + N0 / 8 * kBSbo), scale_d);
    layer1_bf16<N0 + N>(h, a, w1h, scale_d);
  }
}

// z of rows g (z[0]) and g + 8 (z[1]) of one tile, bf16, from its layer-1
// A fragments; s is the staged range [W2H, end).  A template, so that it is
// built only where the warpgroup kernel runs (its wgmma takes N <= 64).
template <int Mode>
__device__ __forceinline__ void bf16_tile(const uint32_t* s, int t, const uint32_t (&a1)[kK1Steps][4],
                                          float (&z)[2]) {
  constexpr int kBase = kTcOffW2H;
  const float* sf = reinterpret_cast<const float*>(s);
  const uint32_t w2h = smem_addr(s + (kTcOffW2H - kBase));
  const float2* b1 = reinterpret_cast<const float2*>(sf + (kTcOffB1 - kBase));
  const uint32_t w1h = smem_addr(s + (kTcOffW1H - kBase));
  float h[kH1Pad / 2];
#pragma unroll
  for (int i = 0; i < kH1Pad / 2; ++i) h[i] = 0.f;
  fence_operands(h);
  wgmma_fence();
#pragma unroll
  for (int k1 = 0; k1 < kK1Steps; ++k1) layer1_bf16<0>(h, a1[k1], w1h + k1 * kW1StepBytes, k1 > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(h);

  uint32_t a2[kKSteps][4];  // every k step's A fragment at once: h dies here
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) pack_a2(h, b1, j, t, a2[j]);
  // two steps in flight: step j + 1 is issued before step j's product,
  // in its own accumulator, is added to the sum
  float acc[kH2Pad / 2], part[2][kH2Pad / 2];
#pragma unroll
  for (int i = 0; i < kH2Pad / 2; ++i) acc[i] = part[0][i] = part[1][i] = 0.f;
  fence_operands(part[0]);
  wgmma_fence();
  wgmma<kH2Pad>(part[0], a2[0], b_desc(w2h), 0);
  wgmma_commit();
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    if (j + 1 < kKSteps) {
      fence_operands(part[(j + 1) & 1]);
      wgmma_fence();
      wgmma<kH2Pad>(part[(j + 1) & 1], a2[j + 1], b_desc(w2h + (j + 1) * kW2StepBytes), 0);
      wgmma_commit();
      wgmma_wait_one();
    } else {
      wgmma_wait_all();
    }
    fence_operands(part[j & 1]);
#pragma unroll
    for (int i = 0; i < kH2Pad / 2; ++i) acc[i] += part[j & 1][i];
  }

  float zz[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kTiles2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nt + 2 * t + e;
      const float b2 = sf[kTcOffB2 - kBase + n], w3 = sf[kTcOffW3H - kBase + n];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        zz[r] = fmaf(w3, bf16_round(fmaxf(acc[4 * nt + 2 * r + e] + b2, 0.f)), zz[r]);
      }
    }
  }
  const float b3 = sf[kTcOffB3 - kBase];
  z[0] = quad_sum(zz[0]) + b3;
  z[1] = quad_sum(zz[1]) + b3;
}

// Where item `item`'s inputs come from: bulk copies into a stage, or (the
// ragged last item, or one whose copy from a misaligned start would end past
// the tensors) plain loads from device memory.
template <class C>
struct Stream {
  const float* features;
  const KmerId* kmer_ids;
  int64_t n_reads;
  uint32_t feat_skew, kmer_skew;  // bytes the tensors start past a 16-byte boundary

  __device__ bool bulk(int64_t item) const {
    const int64_t rest = n_reads - (item + 1) * C::kItemReads;  // reads after the item
    return rest >= 0 && rest * kFeat * 4 >= (feat_skew ? 16 - feat_skew : 0) &&
           rest * kPos * kIdBytes >= (kmer_skew ? 16 - kmer_skew : 0);
  }
  __device__ uint32_t feat_bytes() const { return C::kItemFeatBytes + (feat_skew ? 16 : 0); }
  __device__ uint32_t kmer_bytes() const { return C::kItemKmerBytes + (kmer_skew ? 16 : 0); }
};

// kmer_ids are ids in [0, kVocab); the Python wrapper checks the range
template <int Mode>
__global__ void __launch_bounds__(Cfg<Mode>::kThreads, 1)
read_prob_tc_kernel(const float* __restrict__ features, const KmerId* __restrict__ kmer_ids,
                    const uint32_t* __restrict__ image, int64_t n_reads, float* __restrict__ p_out) {
  using C = Cfg<Mode>;
  static_assert(!C::kWide, "the wide plan runs read_prob_tc_wide_kernel");
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  uint8_t* stages = smem + C::kStagesAt;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarriersAt);  // full[kStages], empty[kStages]

  for (int i = threadIdx.x; i < C::kWords / 4; i += C::kThreads) {
    reinterpret_cast<uint4*>(s)[i] = reinterpret_cast<const uint4*>(image + C::kBegin)[i];
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      bar_init(smem_addr(bars + k), 1);
      bar_init(smem_addr(bars + kStages + k), kGroupThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weights were written by the generic proxy; wgmma reads them by the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const Stream<C> in{features, kmer_ids, n_reads,
                     static_cast<uint32_t>(reinterpret_cast<uintptr_t>(features) & 15),
                     static_cast<uint32_t>(reinterpret_cast<uintptr_t>(kmer_ids) & 15)};
  const int64_t n_items = (n_reads + C::kItemReads - 1) / C::kItemReads;
  const int group = threadIdx.x / kGroupThreads;

  if (group == C::kConsumers) {  // the producer warpgroup
    if constexpr (C::kConsumers >= 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != C::kConsumers * kGroupThreads) return;
    const uint8_t* feat_base = reinterpret_cast<const uint8_t*>(features) - in.feat_skew;
    const uint8_t* kmer_base = reinterpret_cast<const uint8_t*>(kmer_ids) - in.kmer_skew;
    for (int64_t q = 0;; ++q) {
      const int64_t item = blockIdx.x + q * gridDim.x;
      if (item >= n_items) break;
      const int k = static_cast<int>(q % kStages);
      const uint32_t full = smem_addr(bars + k), empty = smem_addr(bars + kStages + k);
      bar_wait(empty, static_cast<uint32_t>(((q / kStages) & 1) ^ 1));
      if (in.bulk(item)) {
        const uint32_t stage = smem_addr(stages + k * C::kStageBytes);
        bar_arrive_tx(full, in.feat_bytes() + in.kmer_bytes());
        bulk_copy(stage, feat_base + item * C::kItemFeatBytes, in.feat_bytes(), full);
        bulk_copy(stage + C::kStageFeatBytes, kmer_base + item * C::kItemKmerBytes, in.kmer_bytes(), full);
      } else {
        bar_arrive(full);  // the consumer reads this item from device memory
      }
    }
    return;
  }

  if constexpr (C::kConsumers >= 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = 16 * ((threadIdx.x / 32) & 3) + lane / 4;  // row g of this warp's 16 in a tile
  const float* sf = reinterpret_cast<const float*>(s);
  for (int64_t q = group;; q += C::kConsumers) {
    const int64_t item = blockIdx.x + q * gridDim.x;
    if (item >= n_items) break;
    const int k = static_cast<int>(q % kStages);
    bar_wait(smem_addr(bars + k), static_cast<uint32_t>((q / kStages) & 1));
    const int64_t first = item * C::kItemReads;
    const bool bulk = in.bulk(item);
    const uint8_t* stage = stages + k * C::kStageBytes;
    const float* stage_f = reinterpret_cast<const float*>(stage + in.feat_skew);
    const KmerId* stage_k = reinterpret_cast<const KmerId*>(stage + C::kStageFeatBytes + in.kmer_skew);
    float z[C::kReads];
    if constexpr (Mode == kModeF32x3 && C::kXShared) {
      // this warp's rows of its warpgroup's item: lane t of a quad copies
      // inputs t, t + 4, ... of the quad's reads, once the warp is done
      // with the last item's
      float* rows = reinterpret_cast<float*>(smem + C::kRowsAt) + group * C::kItemReads * C::kXStride;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < C::kReads; ++i) {
        const int r = 64 * (i / 2) + row + 8 * (i % 2);  // read of the item
        const int64_t want = first + r, l = want < n_reads ? want : n_reads - 1;  // valid; not stored
        const float* f = bulk ? stage_f + r * kFeat : features + l * kFeat;
        const KmerId* ids = bulk ? stage_k + r * kPos : kmer_ids + l * kPos;
        for (int c = t; c < kIn; c += 4) rows[r * C::kXStride + c] = input_col(f, ids, sf + kTcOffEmbX, c);
      }
      bar_arrive(smem_addr(bars + kStages + k));  // the stage is free
      __syncwarp();
      f32x3_reads(s, t, SharedInputs{rows + row * C::kXStride}, z);
    } else if constexpr (Mode == kModeF32x3) {
      RegisterInputs x;
#pragma unroll
      for (int i = 0; i < C::kReads; ++i) {
        const int r = 64 * (i / 2) + row + 8 * (i % 2);  // read of the item
        if (bulk) {
          load_inputs(stage_f + r * kFeat, stage_k + r * kPos, sf + kTcOffEmbX, x.v[i]);
        } else {
          const int64_t want = first + r, l = want < n_reads ? want : n_reads - 1;  // valid; not stored
          load_inputs(features + l * kFeat, kmer_ids + l * kPos, sf + kTcOffEmbX, x.v[i]);
        }
      }
      bar_arrive(smem_addr(bars + kStages + k));  // the stage is free
      f32x3_reads(s, t, x, z);
    } else {
      const float* emb = sf + (kTcOffEmbH - kTcOffW2H);
      uint32_t a1[C::kTilesPerGroup][kK1Steps][4];
#pragma unroll
      for (int tt = 0; tt < C::kTilesPerGroup; ++tt) {
        const int r = 64 * tt + row;
        if (bulk) {
          load_a1(stage_f + r * kFeat, stage_k + r * kPos, stage_f + (r + 8) * kFeat, stage_k + (r + 8) * kPos,
                  emb, t, a1[tt]);
        } else {
          const int64_t w0 = first + r, w1 = w0 + 8;
          const int64_t l0 = w0 < n_reads ? w0 : n_reads - 1, l1 = w1 < n_reads ? w1 : n_reads - 1;
          load_a1(features + l0 * kFeat, kmer_ids + l0 * kPos, features + l1 * kFeat, kmer_ids + l1 * kPos,
                  emb, t, a1[tt]);
        }
      }
      bar_arrive(smem_addr(bars + kStages + k));
#pragma unroll
      for (int tt = 0; tt < C::kTilesPerGroup; ++tt) {
        float zt[2];
        bf16_tile<Mode>(s, t, a1[tt], zt);
        z[2 * tt] = zt[0];
        z[2 * tt + 1] = zt[1];
      }
    }
#pragma unroll
    for (int i = 0; i < C::kReads; ++i) {
      const int64_t r = first + 64 * (i / 2) + row + 8 * (i % 2);
      if (t == i % 2 && r < n_reads) p_out[r] = 1.f / (1.f + expf(-z[i]));
    }
  }
}

// ------------------------------------------------------ the wide plan
#include "wide_tile.cuh"

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8, and register i gets this lane's pair of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(row))
               : "memory");
}

// The A fragment of rows [16 m, 16 m + 16) and columns [c0, c0 + 16) of a
// bf16 [row][column] matrix in shared memory (rows `stride` apart): its
// quarters rows 0-7 | 8-15 then columns 0-7 | 8-15 are a0..a3.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* base, int stride, int m, int c0,
                                       int lane) {
  ldmatrix_x4(a, base + (16 * m + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + c0 + 8 * (lane >> 4));
}

// B fragment (b0, b1) of lane (g, t) from a staged 256-byte n8 x k16 group
// in the image's core-matrix layout (k = 2t.. of column g, then 2t + 8..)
__device__ __forceinline__ void b_shared(const uint32_t* group, int g, int t, uint32_t& b0, uint32_t& b1) {
  b0 = group[g * (kBRowBytes / 4) + t];
  b1 = group[kBLbo / 4 + g * (kBRowBytes / 4) + t];
}

// Rows [row0, row0 + Rows) x n8 groups [group0, group0 + Groups) of an
// image operand laid out [row][row_groups groups][256 B] from word `base`
// (W2's rows are k16 steps of H1, W1H's k16 steps of n_in) into
// dst[row][group][64 words] by 16-byte copies; zeros past `rows` or `groups`.
template <int Rows, int Groups, int Threads>
__device__ __forceinline__ void stage_groups(uint32_t* dst, const uint32_t* image, int base, int row_groups, int row0,
                                             int rows, int group0, int groups) {
  for (int e = threadIdx.x; e < Rows * Groups * 16; e += Threads) {
    const int row = e / (Groups * 16), group = e / 16 % Groups, chunk = e % 16;
    const bool valid = row0 + row < rows && group0 + group < groups;
    wide_tile::copy16(dst + (row * Groups + group) * 64 + 4 * chunk,
                 image + (valid ? base + ((row0 + row) * row_groups + group0 + group) * 64 + 4 * chunk : 0), valid);
  }
}

// bf16's inputs: columns [16 k0, 16 (k0 + K)) of the tile's reads from
// `first` (a read past n_reads stands in as the last read), rounded to bf16
// as pairs into dst[read][stride]; zeros past n_in.
template <int K, int Threads>
__device__ __forceinline__ void stage_x_bf16(uint16_t* dst, int stride, const float* features,
                                             const KmerId* kmer_ids, const float* emb, int64_t first,
                                             int64_t n_reads, int k0) {
  constexpr int kPairs = kTcWideReads * 8 * K;
  for (int e0 = threadIdx.x; e0 < kPairs; e0 += wide_tile::kGatherBatch * Threads) {
    float v[wide_tile::kGatherBatch][2];  // every load of the batch in flight at once
#pragma unroll
    for (int j = 0; j < wide_tile::kGatherBatch; ++j) {
      const int e = e0 + j * Threads, r = e / (8 * K), c = 16 * k0 + 2 * (e % (8 * K));
      const int64_t want = first + r, read = want < n_reads ? want : n_reads - 1;
      const float* f = features + read * kFeat;
      const KmerId* k = kmer_ids + read * kPos;
      v[j][0] = e < kPairs ? input_col(f, k, emb, c) : 0.f;
      v[j][1] = e < kPairs ? input_col(f, k, emb, c + 1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < wide_tile::kGatherBatch; ++j) {
      const int e = e0 + j * Threads, r = e / (8 * K), c = 2 * (e % (8 * K));
      if (e < kPairs) *reinterpret_cast<uint32_t*>(dst + r * stride + c) = pack_bf16x2(v[j][0], v[j][1]);
    }
  }
}

// Phase A of the wide plan: a block takes tiles of kTcWideReads reads in
// turn, warp w the tile's reads [16 w, 16 w + 16).  For each pass of layer
// 2 (one at H2 <= 128; a later pass forms h1 again), H1 runs in steps of
// WideCfg::kChunk units (and of a plan's inputs where a tile's do not fit
// whole).  The block's steps form one stream across its passes and tiles:
// step g's weights sit in buffer g % kStages and are copied by cp.async
// while the steps before compute, once for all the block's warps, each
// fragment then feeding every m16 tile.  Where a tile's inputs fit whole,
// the next tile's k-mer ids are copied in at its first step and its inputs
// once this tile's are read no more, so no step waits for a gather.
// f32x3: layer 1 on the FP32 cores, all threads over the tile
// (wide_tile.cuh, fused_infer.cu's order), then + b1', relu and the hi /
// lo split into bf16 [read][unit] in shared memory; each warp takes its A
// fragments there by ldmatrix, and runs the three products on every n8 tile
// of the pass (W2lo.h1hi and W2hi.h1lo into one accumulator, W2hi.h1hi
// alone, f32-added).  bf16: each warp forms its tile's layer 1 on the
// tensor cores (every k16 step of n_in into one accumulator a unit group),
// bias, relu and the pack in registers, then layer 2 (a zero accumulator a
// k16 step, f32-added in step order).  A warp holds all the pass's n8
// tiles, so the head's per-lane sums run in the earlier kernel's order and
// across the passes in unit order: every read's p is the same bits as
// before.  Repeats are bit-identical, and a read's p does not depend on its
// place in the batch (a read past n_reads, not stored, takes the last
// read's features).
template <int Mode>
__global__ void __launch_bounds__(kTcWideThreads, WideCfg<Mode>::kBlocks)
read_prob_tc_wide_kernel(const float* __restrict__ features, const KmerId* __restrict__ kmer_ids,
                         const uint32_t* __restrict__ image, int64_t n_reads, float* __restrict__ p_out) {
  static_assert(Cfg<Mode>::kWide, "the warpgroup plan runs read_prob_tc_kernel");
  constexpr bool kX3 = Mode == kModeF32x3;
  using P = WideCfg<Mode>;
  constexpr int kS = P::kStages;
  constexpr int kSteps = (kH1 + P::kChunk - 1) / P::kChunk * P::kInSteps;  // a pass's
  constexpr int kTileSteps = kSteps * kWidePasses;
  constexpr bool kAhead = P::kWhole && kTileSteps >= kS;  // the next tile's inputs come in under this one
  constexpr int kXbStride = 16 * P::kCols + 8;              // bf16's x row (whole: every k16 step)
  constexpr int kW1Words = kX3 ? P::kCols * P::kW1Stride : P::kCols * P::kGroups * 64;  // a buffer's
  extern __shared__ __align__(16) uint8_t wide_smem[];
  float* const xs = reinterpret_cast<float*>(wide_smem + P::kAtX);  // f32 x[input][read]
  KmerId* const ids = reinterpret_cast<KmerId*>(wide_smem + P::kAtIds);
  uint16_t* const xb = reinterpret_cast<uint16_t*>(wide_smem + P::kAtXb);  // bf16 x[read][column]
  float* const w1s = reinterpret_cast<float*>(wide_smem + P::kAtW1);
  float* const b1s = reinterpret_cast<float*>(wide_smem + P::kAtB1);
  uint32_t* const w2h = reinterpret_cast<uint32_t*>(wide_smem + P::kAtW2h);
  uint32_t* const w2l = reinterpret_cast<uint32_t*>(wide_smem + P::kAtW2l);
  uint16_t* const ahi = reinterpret_cast<uint16_t*>(wide_smem + P::kAtA);
  uint16_t* const alo = ahi + kTcWideReads * P::kAStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane / 4, t = lane & 3;
  const float* imf = reinterpret_cast<const float*>(image);
  const float* emb = imf + (kX3 ? kTcOffEmbX : kTcOffEmbH);
  const wide_tile::Place<kX3Tr, kX3Tn> p1(threadIdx.x);
  // the copies of step k of a tile's (pass k / kSteps, its n8 tiles from
  // nt0), the block's step gs: layer-1 weights and, where a tile's inputs
  // come in steps, x into buffer gs % kS; W2 (and bf16's b1') at a unit
  // chunk's first step into buffer (the block's unit chunk) % kS
  const auto stage = [&](int64_t first, int k, int gs) {
    const int nt0 = k / kSteps * kWidePassTiles, s = k % kSteps, c = s / P::kInSteps, q = s % P::kInSteps;
    const int b = gs % kS, bc = gs / P::kInSteps % kS;
    if constexpr (kX3) {
      // W1T's rows [q cols, ...) x units [c P::kChunk, ...): whole 16-byte runs
      float* w1 = w1s + b * kW1Words;
      for (int e = threadIdx.x; e < P::kCols * P::kChunk / 4; e += kTcWideThreads) {
        const int i = q * P::kCols + e / (P::kChunk / 4), u = c * P::kChunk + 4 * (e % (P::kChunk / 4));
        const bool valid = i <= kIn && u < kH1Pad;
        wide_tile::copy16(w1 + (i - q * P::kCols) * P::kW1Stride + (u - c * P::kChunk),
                          image + (valid ? kTcOffW1T + i * kH1Pad + u : 0), valid);
      }
      if constexpr (!P::kWhole) {
        wide_tile::stage_x<kTcWideReads, P::kCols, kTcXStride, kTcWideThreads, kFeat, kPos, kEmb>(
            xs + b * P::kCols * kTcXStride, features, kmer_ids, emb, first, n_reads, q * P::kCols);
      }
    } else {
      stage_groups<P::kCols, P::kGroups, kTcWideThreads>(reinterpret_cast<uint32_t*>(w1s) + b * kW1Words, image,
                                                            kTcOffW1H, kTiles1, q * P::kCols, kK1Steps,
                                                            c * P::kGroups, kTiles1);
      if constexpr (!P::kWhole) {
        stage_x_bf16<P::kCols, kTcWideThreads>(xb + b * kTcWideReads * kXbStride, kXbStride, features, kmer_ids,
                                               emb, first, n_reads, q * P::kCols);
      }
    }
    if (q == 0) {
      stage_groups<P::kKSteps, kWidePassTiles, kTcWideThreads>(
          w2h + bc * P::kW2Words, image, kTcOffW2H, kTiles2, c * P::kKSteps, kKSteps, nt0, kTiles2);
      if constexpr (kX3) {
        stage_groups<P::kKSteps, kWidePassTiles, kTcWideThreads>(
            w2l + bc * P::kW2Words, image, kTcOffW2L, kTiles2, c * P::kKSteps, kKSteps, nt0, kTiles2);
      } else {
        for (int e = threadIdx.x; e < P::kChunk / 4; e += kTcWideThreads) {
          const int u = c * P::kChunk + 4 * e;
          wide_tile::copy16(b1s + bc * P::kChunk + 4 * e, image + kTcOffB1 + (u < kH1Pad ? u : 0), u < kH1Pad);
        }
      }
    }
  };
  const auto stage_inputs = [&](int64_t first) {  // a whole tile's as f32, its ids staged and visible
    wide_tile::stage_x_ids<kTcWideReads, kTcXStride, kTcWideThreads, kFeat, kPos, kEmb>(xs, features, ids, emb,
                                                                                         first, n_reads);
  };
  const int64_t n_tiles = (n_reads + kTcWideReads - 1) / kTcWideReads;
  int64_t tile = blockIdx.x;
  if constexpr (P::kWhole) {
    wide_tile::stage_ids<kTcWideReads, kPos, kTcWideThreads>(ids, kmer_ids, tile * kTcWideReads, n_reads);
    wide_tile::commit();
    wide_tile::wait<0>();
    __syncthreads();
    stage_inputs(tile * kTcWideReads);
  }
  // the stream's first kS - 1 steps (those of later tiles where a tile has fewer)
#pragma unroll
  for (int k = 0; k < kS - 1; ++k) {
    const int64_t at = tile + static_cast<int64_t>(k / kTileSteps) * gridDim.x;
    if (at < n_tiles) stage(at * kTcWideReads, k % kTileSteps, k);
    wide_tile::commit();
  }
  int gs = 0;  // the block's steps so far
  for (; tile < n_tiles; tile += gridDim.x) {
    const int64_t first = tile * kTcWideReads, next = tile + gridDim.x;
    float zx[2][2] = {}, zh[2] = {}, zz[2] = {};  // f32x3: w3lo.h2hi, w3hi.h2lo; w3hi.h2hi; bf16: w3.h2
    for (int pass = 0; pass < kWidePasses; ++pass) {
      const int nt0 = pass * kWidePassTiles;
      float cross[kWidePassTiles][4], high[kWidePassTiles][4];  // f32x3; bf16 sums in high
      float t1[4][4 * P::kX3Gn];                                     // f32x3 layer 1's micro-tile
      float h1[P::kGroups][4];                                 // bf16 layer 1 of a unit chunk
#pragma unroll
      for (int i = 0; i < kWidePassTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cross[i][e] = high[i][e] = 0.f;
      }
      for (int s = 0; s < kSteps; ++s, ++gs) {
        const int k = pass * kSteps + s;
        if (k == 0) {
          wide_tile::wait<0>();  // and the tile's inputs
        } else {
          wide_tile::wait<kS - 2>();
        }
        __syncthreads();  // step gs has landed; step gs - 1's readers are done
        if (!kX3 && P::kWhole && k == 0) {
          // bf16: the tile's inputs rounded into [read][column], zeros past n_in
          for (int e = threadIdx.x; e < kTcWideReads * kXbStride / 2; e += kTcWideThreads) {
            const int r = e / (kXbStride / 2), c = 2 * (e % (kXbStride / 2));
            const float v0 = c < kIn ? xs[c * kTcXStride + r] : 0.f;
            const float v1 = c + 1 < kIn ? xs[(c + 1) * kTcXStride + r] : 0.f;
            *reinterpret_cast<uint32_t*>(xb + r * kXbStride + c) = pack_bf16x2(v0, v1);
          }
          __syncthreads();
        }
        const int kn = k + kS - 1;  // the stream's step gs + kS - 1, of this tile or a later one
        const int64_t at = tile + static_cast<int64_t>(kn / kTileSteps) * gridDim.x;
        if (at < n_tiles) stage(at * kTcWideReads, kn % kTileSteps, gs + kS - 1);
        if (kAhead && k == 0 && next < n_tiles) {
          wide_tile::stage_ids<kTcWideReads, kPos, kTcWideThreads>(ids, kmer_ids, next * kTcWideReads, n_reads);
        }
        if (!kX3 && kAhead && k == kS - 1 && next < n_tiles) stage_inputs(next * kTcWideReads);  // xs is free
        wide_tile::commit();
        const int c = s / P::kInSteps, q = s % P::kInSteps, b = gs % kS, bc = gs / P::kInSteps % kS;
        const uint32_t* l2h = w2h + bc * P::kW2Words;
        if constexpr (kX3) {
          const int i0 = q * P::kCols;
          const float* x = P::kWhole ? xs : xs + b * P::kCols * kTcXStride;
          const float* w1 = w1s + b * kW1Words;
          const int n_x = kIn - i0 < P::kCols ? kIn - i0 : P::kCols;  // the step's inputs (the bias aside)
          wide_tile::fma_rows<1, P::kX3Gn, kX3Tr, kX3Tn, kTcXStride, P::kW1Stride>(x, w1, n_x, q == 0, p1.tr, p1.tn,
                                                                                    t1);
          if (q == P::kInSteps - 1) {
            // + b1' (column n_in of the step), relu, hi / lo to [read][unit]
            const float* bias = w1 + (kIn - i0) * P::kW1Stride;
#pragma unroll
            for (int h = 0; h < P::kX3Gn; ++h) {
              const int u = 4 * (p1.tn + h * kX3Tn);
              const float b0 = bias[u], b1 = bias[u + 1], b2 = bias[u + 2], b3 = bias[u + 3];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = 4 * p1.tr + e;
                uint32_t hi01, lo01, hi23, lo23;
                split_pack(fmaxf(t1[e][4 * h] + b0, 0.f), fmaxf(t1[e][4 * h + 1] + b1, 0.f), hi01, lo01);
                split_pack(fmaxf(t1[e][4 * h + 2] + b2, 0.f), fmaxf(t1[e][4 * h + 3] + b3, 0.f), hi23, lo23);
                *reinterpret_cast<uint2*>(ahi + r * P::kAStride + u) = make_uint2(hi01, hi23);
                *reinterpret_cast<uint2*>(alo + r * P::kAStride + u) = make_uint2(lo01, lo23);
              }
            }
            __syncthreads();
            if (kAhead && k == kTileSteps - 1 && next < n_tiles) {  // x is read no more: the next tile's
              stage_inputs(next * kTcWideReads);
              wide_tile::commit();
            }
            const uint32_t* l2l = w2l + bc * P::kW2Words;
#pragma unroll
            for (int jj = 0; jj < P::kKSteps; ++jj) {
              if (c * P::kKSteps + jj < kKSteps) {
                uint32_t ah[4], al[4];
                load_a(ah, ahi, P::kAStride, warp, 16 * jj, lane);
                load_a(al, alo, P::kAStride, warp, 16 * jj, lane);
#pragma unroll
                for (int i = 0; i < kWidePassTiles; ++i) {
                  if (nt0 + i < kTiles2) {  // the last pass may hold fewer
                    uint32_t l0, l1, h0, h1;
                    b_shared(l2l + (jj * kWidePassTiles + i) * 64, g, t, l0, l1);
                    b_shared(l2h + (jj * kWidePassTiles + i) * 64, g, t, h0, h1);
                    mma_bf16(cross[i], ah, l0, l1);  // W2lo.h1hi
                    mma_bf16(cross[i], al, h0, h1);  // + W2hi.h1lo
                    float part[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_bf16(part, ah, h0, h1);  // W2hi.h1hi alone
#pragma unroll
                    for (int e = 0; e < 4; ++e) high[i][e] += part[e];
                  }
                }
              }
            }
          }
        } else {
          if (q == 0) {
#pragma unroll
            for (int nn = 0; nn < P::kGroups; ++nn) {
#pragma unroll
              for (int e = 0; e < 4; ++e) h1[nn][e] = 0.f;
            }
          }
          const uint16_t* x = P::kWhole ? xb : xb + b * kTcWideReads * kXbStride;
          const uint32_t* w1 = reinterpret_cast<const uint32_t*>(w1s) + b * kW1Words;
#pragma unroll 4
          for (int s1 = 0; s1 < P::kCols; ++s1) {
            if (q * P::kCols + s1 < kK1Steps) {
              uint32_t a[4];
              load_a(a, x, kXbStride, warp, 16 * (P::kWhole ? q * P::kCols + s1 : s1), lane);
#pragma unroll
              for (int nn = 0; nn < P::kGroups; ++nn) {
                if (c * P::kGroups + nn < kTiles1) {
                  uint32_t b0, b1;
                  b_shared(w1 + (s1 * P::kGroups + nn) * 64, g, t, b0, b1);
                  mma_bf16(h1[nn], a, b0, b1);
                }
              }
            }
          }
          if (q == P::kInSteps - 1) {
            const float* bias = b1s + bc * P::kChunk;
#pragma unroll
            for (int jj = 0; jj < P::kKSteps; ++jj) {
              if (c * P::kKSteps + jj < kKSteps) {
                const float2 bl = *reinterpret_cast<const float2*>(bias + 16 * jj + 2 * t);
                const float2 bh = *reinterpret_cast<const float2*>(bias + 16 * jj + 8 + 2 * t);
                const uint32_t a2[4] = {
                    pack_bf16x2(fmaxf(h1[2 * jj][0] + bl.x, 0.f), fmaxf(h1[2 * jj][1] + bl.y, 0.f)),
                    pack_bf16x2(fmaxf(h1[2 * jj][2] + bl.x, 0.f), fmaxf(h1[2 * jj][3] + bl.y, 0.f)),
                    pack_bf16x2(fmaxf(h1[2 * jj + 1][0] + bh.x, 0.f), fmaxf(h1[2 * jj + 1][1] + bh.y, 0.f)),
                    pack_bf16x2(fmaxf(h1[2 * jj + 1][2] + bh.x, 0.f), fmaxf(h1[2 * jj + 1][3] + bh.y, 0.f))};
#pragma unroll
                for (int i = 0; i < kWidePassTiles; ++i) {
                  if (nt0 + i < kTiles2) {
                    uint32_t w0, w1r;
                    b_shared(l2h + (jj * kWidePassTiles + i) * 64, g, t, w0, w1r);
                    float part[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_bf16(part, a2, w0, w1r);
#pragma unroll
                    for (int e = 0; e < 4; ++e) high[i][e] += part[e];
                  }
                }
              }
            }
          }
        }
      }
      // the head of the pass: this lane's outputs n = 8 nt + 2t + e of rows
      // g (r = 0) and g + 8, nt in order
#pragma unroll
      for (int i = 0; i < kWidePassTiles; ++i) {
        if (nt0 + i < kTiles2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * (nt0 + i) + 2 * t + e;
            const float b2 = __ldg(imf + kTcOffB2 + n), w3h = __ldg(imf + kTcOffW3H + n);
            if constexpr (kX3) {
              const float w3l = __ldg(imf + kTcOffW3L + n);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float v = fmaxf(cross[i][2 * r + e] + high[i][2 * r + e] + b2, 0.f);
                const float vh = bf16_round(v), vl = bf16_round(v - vh);
                zx[r][0] = fmaf(w3l, vh, zx[r][0]);
                zx[r][1] = fmaf(w3h, vl, zx[r][1]);
                zh[r] = fmaf(w3h, vh, zh[r]);
              }
            } else {
#pragma unroll
              for (int r = 0; r < 2; ++r) zz[r] = fmaf(w3h, bf16_round(fmaxf(high[i][2 * r + e] + b2, 0.f)), zz[r]);
            }
          }
        }
      }
    }
    const float b3 = __ldg(imf + kTcOffB3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float z = kX3 ? ((quad_sum(zx[r][0]) + quad_sum(zx[r][1])) + quad_sum(zh[r])) + b3 : quad_sum(zz[r]) + b3;
      const int64_t read = first + 16 * warp + g + 8 * r;
      if (t == r && read < n_reads) p_out[read] = 1.f / (1.f + expf(-z));
    }
    if (P::kWhole && !kAhead && next < n_tiles) {  // a tile of fewer steps than stages: its inputs now
      __syncthreads();
      wide_tile::stage_ids<kTcWideReads, kPos, kTcWideThreads>(ids, kmer_ids, next * kTcWideReads, n_reads);
      wide_tile::commit();
      wide_tile::wait<0>();
      __syncthreads();
      stage_inputs(next * kTcWideReads);
      wide_tile::commit();
    }
  }
}

template <int Mode>
cudaError_t launch(const float* features, const KmerId* kmer_ids, const uint32_t* image,
                   int64_t n_reads, float* p, cudaStream_t stream) {
  using C = Cfg<Mode>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if constexpr (C::kWide) {
    constexpr int kSmem = WideCfg<Mode>::kSmem;
    int per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(read_prob_tc_wide_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, read_prob_tc_wide_kernel<Mode>, kTcWideThreads,
                                                          kSmem);
    }
    if (err != cudaSuccess) return err;
    const int64_t needed = (n_reads + kTcWideReads - 1) / kTcWideReads;
    const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(needed < resident ? needed : resident);
    read_prob_tc_wide_kernel<Mode><<<grid, kTcWideThreads, kSmem, stream>>>(features, kmer_ids, image, n_reads, p);
  } else {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(read_prob_tc_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::kSmemBytes);
    }
    if (err != cudaSuccess) return err;
    const int64_t items = (n_reads + C::kItemReads - 1) / C::kItemReads;
    const int grid = static_cast<int>(items < sms ? items : sms);
    read_prob_tc_kernel<Mode><<<grid, C::kThreads, C::kSmemBytes, stream>>>(features, kmer_ids, image, n_reads, p);
  }
  return cudaGetLastError();
}

template <int Mode>
void config(int32_t* out) {
  using C = Cfg<Mode>;
  out[0] = C::kWide ? kTcWideThreads : C::kThreads;
  out[1] = C::kWide ? 0 : C::kConsumers;
  out[2] = C::kWide ? WideCfg<Mode>::kStages : C::kStages;
  out[3] = C::kWide ? kTcWideReads : C::kItemReads;
  out[4] = C::kWide ? WideCfg<Mode>::kSmem : C::kSmemBytes;
  out[5] = C::kWide ? 1 : 0;
}

}  // namespace

extern "C" {

// Phase A in a reduced-precision mode (1 = f32x3, 2 = bf16): per-read p on
// `stream`.  Returns the CUDA error code of the launch (0 = success).
int read_prob_tc_launch(const float* features, const KmerId* kmer_ids, const uint32_t* image,
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

// The launch of `mode` (1 = f32x3, 2 = bf16): threads a block, consumer
// warpgroups, ring stages, reads an item (a consumer warpgroup's 64-read
// tiles, a block's tile in the wide plan: the tile whose ragged edge the
// tests and chip_smoke.py exercise), dynamic shared memory bytes, and 1 for
// the wide plan (fused_infer_kernel.TC_CONFIG_KEYS; the wide plan has no
// consumer warpgroups, 0, and its stages are its weight buffers).  Returns
// cudaErrorInvalidValue for another mode.
int read_prob_tc_config(int mode, int32_t* out) {
  if (mode == kModeF32x3) {
    config<kModeF32x3>(out);
  } else if (mode == kModeBf16) {
    config<kModeBf16>(out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

const char* read_prob_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
