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
//    (wide() below): read_prob_tc_wide_kernel, a warp per 16 reads on
//    mma.sync.m16n8k16 (whose fragments are the layouts wgmma gives each
//    warp here, so every sum is the same chunked tensor-core sum), the
//    weights read from the same image in device memory through L1 and L2,
//    the inputs in shared memory.  Layer 1 runs a k16 step of H1 at a time
//    and feeds that step of layer 2 at once (no thread holds all of H1);
//    layer 2 runs in passes of at most 8 n8 tiles of H2 (64 outputs),
//    forming h1 again for a later pass, and the head's per-lane sums run on
//    across the passes in unit order, the plain version's order.
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
constexpr int kTcWords = kTcOffEmbH + kEmbWords;                      // 9484

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
static_assert(kTcOffW2L % 4 == 0 && kTcOffW2H % 4 == 0 && kTcOffW1H % 4 == 0 && kTcWords % 4 == 0,
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
// of the image (f32x3 everything before W1H, bf16 everything from W2H on),
// the ring's stages (an item's features and k-mer ids, each with the up to
// 15 bytes before a misaligned start), f32x3's input rows (kIn | 1 floats a
// read, odd so the 8 rows a warp reads at once sit in 8 banks), the ring's
// full and empty barriers.  ops/fused_infer_kernel.py::kernel_limit checks
// that the smallest block (one tile, 2 stages, the rows) fits.
constexpr int stage_bytes(int tiles) {
  return kTileReads * tiles * kFeat * 4 + 16 + kTileReads * tiles * kPos * kIdBytes + 16;
}
constexpr int image_bytes(bool f32x3) { return (f32x3 ? kTcOffW1H - kTcOffW1F : kTcWords - kTcOffW2H) * 4; }
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
// that a mode takes the wide plan: read_prob_tc_wide_kernel, a warp per 16
// reads on mma.sync.m16n8k16, the weights read from device memory (through
// L1 and L2), layer 1 in k16 steps of H1 that feed layer 2 at once, and
// layer 2 in passes of at most kWidePassTiles n8 tiles of H2.
constexpr bool wide(bool f32x3) {
  return kH1Pad > 256 || kH2Pad > 64 || smem_bytes(f32x3, f32x3 ? f32x3_plan() : bf16_plan()) > kSharedLimit;
}
// layer-2 n8 tiles a pass holds at most: 8 (64 outputs) ran fastest of 4,
// 8 and 16 at (11, 8, 512, 128), where 16 spills (scripts/sweep_wide.py
// rewrites this line and times each build on the card; PERF.md section 6)
constexpr int kWidePassCap = 8;
constexpr int kWidePassTiles = kTiles2 < kWidePassCap ? kTiles2 : kWidePassCap;
constexpr int kWidePasses = (kTiles2 + kWidePassTiles - 1) / kWidePassTiles;
constexpr int kWideRowBytes = 16 * (kIn | 1) * 4;  // a warp's 16 reads' inputs (an odd stride)
// warps a block of the wide plan: 4, fewer where their inputs would pass
// the shared memory
constexpr int kWideWarps = 4 * kWideRowBytes <= kSharedLimit ? 4 : 2 * kWideRowBytes <= kSharedLimit ? 2 : 1;
static_assert(kWideRowBytes <= kSharedLimit, "a warp's inputs fit a block: kernel_limit in ops/fused_infer_kernel.py");

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
// Layer 1 of f32x3 for k step j of the wide plan: h1 of this lane's 4 units
// (slot c: unit 16j + 2t + (c & 1) + 8 (c >> 1)) for rows g (x0) and g + 8
// (x1), in fused_infer.cu's FMA order, split and packed as the A fragments
// (hi, lo): layer1_f32x3's arithmetic, the W1F rows read from device memory.
__device__ __forceinline__ void wide_layer1_f32x3(const float4* w1, int j, int t, const float* x0, const float* x1,
                                                  uint32_t (&ahi)[4], uint32_t (&alo)[4]) {
  // the inputs run outermost, so that each is read from shared memory once
  // for the lane's 4 units; each unit's chain stays in input order
  float u[4][2], h[4][2];
  const float4* row = w1 + j * 4 * 4 * kW1Quads + t;  // [j][c][q][t]: slot c at row + 4 c kW1Quads
#pragma unroll
  for (int q = 0; q < kW1Quads; ++q) {
    float4 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = __ldg(row + 4 * (c * kW1Quads + q));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const float a0 = k < kIn ? x0[k] : 0.f, a1 = k < kIn ? x1[k] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = e == 0 ? v[c].x : e == 1 ? v[c].y : e == 2 ? v[c].z : v[c].w;
        if (k == 0) {
          u[c][0] = w * a0;  // fused_infer.cu's order
          u[c][1] = w * a1;
        } else if (k < kIn) {
          u[c][0] = fmaf(w, a0, u[c][0]);
          u[c][1] = fmaf(w, a1, u[c][1]);
        } else if (k == kIn) {
          h[c][0] = fmaxf(u[c][0] + w, 0.f);  // + b1', relu
          h[c][1] = fmaxf(u[c][1] + w, 0.f);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (16 * j + 8 * (c >> 1) >= kH1) h[c][0] = h[c][1] = 0.f;  // 8 units past H1: zero weights and bias
  }
  split_pack(h[0][0], h[1][0], ahi[0], alo[0]);
  split_pack(h[0][1], h[1][1], ahi[1], alo[1]);
  split_pack(h[2][0], h[3][0], ahi[2], alo[2]);
  split_pack(h[2][1], h[3][1], ahi[3], alo[3]);
}

// B fragment (b0, b1) of n8 group `group` of k step `step` of a K-major
// operand at word `base` of the image: lane (g, t) holds k = 2t, 2t + 1 of
// column g (half 0) and k = 2t + 8, 2t + 9 (half 1), kBLbo bytes on
__device__ __forceinline__ void b_frag(const uint32_t* image, int base, int groups, int step, int group, int g,
                                       int t, uint32_t& b0, uint32_t& b1) {
  const uint32_t* at = image + base + (step * groups + group) * (kBSbo / 4) + g * (kBRowBytes / 4) + t;
  b0 = __ldg(at);
  b1 = __ldg(at + kBLbo / 4);
}

// z of rows g (z[0]) and g + 8 (z[1]) of a warp's 16 reads, f32x3, from
// their inputs (rows x0, x1): for each pass over H2, every k step's layer 1
// then its three products on each n8 tile of the pass (W2lo.h1hi and
// W2hi.h1lo into one accumulator, W2hi.h1hi alone, f32-added), as
// f32x3_reads takes them; the head's sums run on across the passes in
// unit order (the plain version's _lane_dot).
__device__ __forceinline__ void wide_f32x3(const uint32_t* image, int g, int t, const float* x0, const float* x1,
                                           float (&z)[2]) {
  const float* imf = reinterpret_cast<const float*>(image);
  const float4* w1 = reinterpret_cast<const float4*>(imf + kTcOffW1F);
  float zx[2][2] = {}, zh[2] = {};  // w3lo.h2hi, w3hi.h2lo; w3hi.h2hi
  for (int pass = 0; pass < kWidePasses; ++pass) {
    const int nt0 = pass * kWidePassTiles;
    float cross[kWidePassTiles][4], high[kWidePassTiles][4];
#pragma unroll
    for (int i = 0; i < kWidePassTiles; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cross[i][e] = high[i][e] = 0.f;
    }
#pragma unroll 1
    for (int j = 0; j < kKSteps; ++j) {
      uint32_t ahi[4], alo[4];
      wide_layer1_f32x3(w1, j, t, x0, x1, ahi, alo);
#pragma unroll
      for (int i = 0; i < kWidePassTiles; ++i) {
        if (nt0 + i >= kTiles2) continue;  // the last pass may hold fewer
        uint32_t l0, l1, h0, h1;
        b_frag(image, kTcOffW2L, kTiles2, j, nt0 + i, g, t, l0, l1);
        b_frag(image, kTcOffW2H, kTiles2, j, nt0 + i, g, t, h0, h1);
        mma_bf16(cross[i], ahi, l0, l1);  // W2lo.h1hi
        mma_bf16(cross[i], alo, h0, h1);  // + W2hi.h1lo
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, ahi, h0, h1);  // W2hi.h1hi alone
#pragma unroll
        for (int e = 0; e < 4; ++e) high[i][e] += part[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kWidePassTiles; ++i) {
      if (nt0 + i >= kTiles2) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * (nt0 + i) + 2 * t + e;
        const float b2 = __ldg(imf + kTcOffB2 + n), w3h = __ldg(imf + kTcOffW3H + n), w3l = __ldg(imf + kTcOffW3L + n);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = fmaxf(cross[i][2 * r + e] + high[i][2 * r + e] + b2, 0.f);
          const float vh = bf16_round(v), vl = bf16_round(v - vh);
          zx[r][0] = fmaf(w3l, vh, zx[r][0]);
          zx[r][1] = fmaf(w3h, vl, zx[r][1]);
          zh[r] = fmaf(w3h, vh, zh[r]);
        }
      }
    }
  }
  const float b3 = __ldg(imf + kTcOffB3);
#pragma unroll
  for (int r = 0; r < 2; ++r) z[r] = ((quad_sum(zx[r][0]) + quad_sum(zx[r][1])) + quad_sum(zh[r])) + b3;
}

// z of rows g and g + 8 of a warp's 16 reads, bf16: for each pass over H2,
// layer 1 a k16 step of H1 at a time (its two n8 tiles over every k16 step
// of n_in, one accumulator each), bias, relu and the bf16 pack in
// registers, then that step of layer 2 on each n8 tile of the pass (a zero
// accumulator, f32-added in step order), as bf16_tile takes them.
__device__ __forceinline__ void wide_bf16(const uint32_t* image, int g, int t, const float* x0, const float* x1,
                                          float (&z)[2]) {
  const float* imf = reinterpret_cast<const float*>(image);
  uint32_t a1[kK1Steps][4];  // layer 1's A fragments: columns 16s + 2t.., + 8.. of rows g, g + 8
#pragma unroll
  for (int s = 0; s < kK1Steps; ++s) {
    const int c = 16 * s + 2 * t;
    const auto col = [](const float* x, int k) { return k < kIn ? x[k] : 0.f; };
    a1[s][0] = pack_bf16x2(col(x0, c), col(x0, c + 1));
    a1[s][1] = pack_bf16x2(col(x1, c), col(x1, c + 1));
    a1[s][2] = pack_bf16x2(col(x0, c + 8), col(x0, c + 9));
    a1[s][3] = pack_bf16x2(col(x1, c + 8), col(x1, c + 9));
  }
  float zz[2] = {0.f, 0.f};
  for (int pass = 0; pass < kWidePasses; ++pass) {
    const int nt0 = pass * kWidePassTiles;
    float acc[kWidePassTiles][4];
#pragma unroll
    for (int i = 0; i < kWidePassTiles; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
#pragma unroll 1
    for (int j = 0; j < kKSteps; ++j) {
      float h[2][4] = {};  // layer 1's n8 tiles 2j, 2j + 1
#pragma unroll
      for (int s = 0; s < kK1Steps; ++s) {
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          uint32_t b0, b1;
          b_frag(image, kTcOffW1H, kTiles1, s, 2 * j + tile, g, t, b0, b1);
          mma_bf16(h[tile], a1[s], b0, b1);
        }
      }
      const float2 bl = __ldg(reinterpret_cast<const float2*>(imf + kTcOffB1) + 8 * j + t);
      const float2 bh = __ldg(reinterpret_cast<const float2*>(imf + kTcOffB1) + 8 * j + 4 + t);
      const uint32_t a2[4] = {pack_bf16x2(fmaxf(h[0][0] + bl.x, 0.f), fmaxf(h[0][1] + bl.y, 0.f)),
                              pack_bf16x2(fmaxf(h[0][2] + bl.x, 0.f), fmaxf(h[0][3] + bl.y, 0.f)),
                              pack_bf16x2(fmaxf(h[1][0] + bh.x, 0.f), fmaxf(h[1][1] + bh.y, 0.f)),
                              pack_bf16x2(fmaxf(h[1][2] + bh.x, 0.f), fmaxf(h[1][3] + bh.y, 0.f))};
#pragma unroll
      for (int i = 0; i < kWidePassTiles; ++i) {
        if (nt0 + i >= kTiles2) continue;
        uint32_t b0, b1;
        b_frag(image, kTcOffW2H, kTiles2, j, nt0 + i, g, t, b0, b1);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, a2, b0, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += part[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kWidePassTiles; ++i) {
      if (nt0 + i >= kTiles2) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * (nt0 + i) + 2 * t + e;
        const float b2 = __ldg(imf + kTcOffB2 + n), w3 = __ldg(imf + kTcOffW3H + n);
#pragma unroll
        for (int r = 0; r < 2; ++r) zz[r] = fmaf(w3, bf16_round(fmaxf(acc[i][2 * r + e] + b2, 0.f)), zz[r]);
      }
    }
  }
  const float b3 = __ldg(imf + kTcOffB3);
  z[0] = quad_sum(zz[0]) + b3;
  z[1] = quad_sum(zz[1]) + b3;
}

// Phase A of the wide plan: each warp takes 16-read tiles in turn (a
// grid-stride loop), copies their n_in inputs into its rows of shared
// memory (lanes over the columns; past n_reads the last read again, not
// stored), and computes the tile's p.  Repeats are bit-identical, and a
// read's p does not depend on its place in the batch.
template <int Mode>
__global__ void __launch_bounds__(kWideWarps * 32)
read_prob_tc_wide_kernel(const float* __restrict__ features, const KmerId* __restrict__ kmer_ids,
                         const uint32_t* __restrict__ image, int64_t n_reads, float* __restrict__ p_out) {
  static_assert(Cfg<Mode>::kWide, "the warpgroup plan runs read_prob_tc_kernel");
  constexpr int kStride = kIn | 1;
  extern __shared__ __align__(16) float wide_rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane / 4, t = lane & 3;
  float* rows = wide_rows + warp * 16 * kStride;
  const float* emb = reinterpret_cast<const float*>(image) + (Mode == kModeF32x3 ? kTcOffEmbX : kTcOffEmbH);
  const int64_t n_tiles = (n_reads + 15) / 16;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWideWarps + warp; tile < n_tiles;
       tile += static_cast<int64_t>(gridDim.x) * kWideWarps) {
    const int64_t first = tile * 16;
    __syncwarp();  // the warp is done with the last tile's rows
    for (int r = 0; r < 16; ++r) {
      const int64_t l = first + r < n_reads ? first + r : n_reads - 1;
      for (int c = lane; c < kIn; c += 32) rows[r * kStride + c] = input_col(features + l * kFeat, kmer_ids + l * kPos, emb, c);
    }
    __syncwarp();
    float z[2];
    if constexpr (Mode == kModeF32x3) {
      wide_f32x3(image, g, t, rows + g * kStride, rows + (g + 8) * kStride, z);
    } else {
      wide_bf16(image, g, t, rows + g * kStride, rows + (g + 8) * kStride, z);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t read = first + g + 8 * r;
      if (t == r && read < n_reads) p_out[read] = 1.f / (1.f + expf(-z[r]));
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
    constexpr int kSmem = kWideWarps * kWideRowBytes;
    int per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(read_prob_tc_wide_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, read_prob_tc_wide_kernel<Mode>, kWideWarps * 32,
                                                          kSmem);
    }
    if (err != cudaSuccess) return err;
    const int64_t needed = ((n_reads + 15) / 16 + kWideWarps - 1) / kWideWarps;
    const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(needed < resident ? needed : resident);
    read_prob_tc_wide_kernel<Mode><<<grid, kWideWarps * 32, kSmem, stream>>>(features, kmer_ids, image, n_reads, p);
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
  out[0] = C::kWide ? kWideWarps * 32 : C::kThreads;
  out[1] = C::kWide ? 0 : C::kConsumers;
  out[2] = C::kWide ? 0 : C::kStages;
  out[3] = C::kWide ? 16 : C::kItemReads;
  out[4] = C::kWide ? kWideWarps * kWideRowBytes : C::kSmemBytes;
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
// tiles, a warp's 16 in the wide plan: the tile whose ragged edge the tests
// and chip_smoke.py exercise), dynamic shared memory bytes, and 1 for the
// wide plan (fused_infer_kernel.TC_CONFIG_KEYS; the wide plan has no
// consumer warpgroups or stages: 0).  Returns cudaErrorInvalidValue for
// another mode.
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
