// Flash attention for the backbone's training forwards, forward and backward
// (K6): causal or local-window softmax attention, O = softmax(mask(Q K^T)) V,
// with the per-row log-sum-exp kept for the backward.
//
// Replaces: rstnet_tpu/ops/flash_attention.py:46 (flash_attention), which
// calls jax's Pallas splash kernel (make_splash_mha, CausalMask or LocalMask
// with window (context - 1, 0)) and its custom VJP, whose backward is two
// Pallas kernels of its own (dQ, and dK/dV). Contract: Q arrives pre-scaled
// in its own dtype (the wrapper does q * scale); K and V arrive at their own
// head count, and query head h reads KV head h / (H / Hkv) (GQA inside the
// kernels: nothing is repeated in memory); key j is visible to query i iff
// 0 <= i - j < window (window = context if context < T, else T). dK and dV
// come out at the KV heads, summed over each group inside the kernel. Head
// dims 64 and 128: every kernel a template on D but the backwards at 128,
// flash_bwd_wgmma_d128 (bf16) and flash_bwd_f32_d128 (float32) (the text
// below is D = 64's design; D = 128's follows it, "At head dim 128").
//
// What bounds it on the H100: operations. At the training shape (B=4, 32
// query heads over 8 KV heads, T=1024, D=64, causal) there are 67.2 M
// visible (query, key) pairs per call. The forward needs 4 D FLOPs a pair
// (Q K^T and P V): 17.2 GFLOP, 0.0174 ms at the bf16 dense peak, against
// ~21 MB of inputs and outputs (0.006 ms at 3.35 TB/s). The backward needs
// 10 D a pair (the five products S, dP, dV, dK, dQ): 0.0435 ms. float32
// inputs run three bf16 products a product (below): three times that.
//
// bf16 (the route of bf16 training), Hopper kernels; each block is three
// warpgroups: two consumer warpgroups and one that loads (setmaxnreg hands
// its registers to the consumers):
// 1. flash_fwd_wgmma: persistent, one block per SM, over (128-row query
//    tile, batch x head) work tiles taken longest first (the causal tiles
//    with the most keys run first, the short ones fill the tail). Each
//    consumer warpgroup owns 64 query rows. One producer thread streams Q
//    (double-buffered across work tiles) and K and V tiles of 128 keys by
//    TMA (128-byte swizzle: a 64-wide bf16 row is one swizzle row) into
//    separate K and V rings of kFwdStages stages with full/empty mbarriers;
//    tiles wholly outside the causal band or the window are never loaded,
//    and only the diagonal and window-edge tiles are masked. S = Q K^T is a
//    wgmma with both operands in shared memory; O += P V a wgmma with P from
//    registers (the accumulator layout is the A operand's) and V as an
//    MN-major B operand straight from the TMA tile. S of the next tile is
//    issued ahead of P V of this one, and its online softmax (float32, base
//    2: log2(e) is the only scale, q being pre-scaled) runs while P V does.
// 2. flash_bwd_delta: delta = rowsum(dO * O), a row pre-pass of the
//    backward (memory-bound, ~17 MB read at the training shape).
// 3. flash_bwd_wgmma: one launch for dQ, dK and dV. Persistent: one block
//    per SM takes work items from an atomic counter. An item is (batch, KV
//    head g, key tile j of 128 keys, 64 per consumer warpgroup); it keeps K
//    and V in shared memory and visits every (query head of g, 64-row query
//    tile) pair that sees the tile, Q, dO, LSE and delta arriving through a
//    TMA ring. Per pair, five wgmma products in float32: S^T = K Q^T and
//    dP^T = V dO^T (recomputed, then P^T = exp2(S^T log2 e - LSE log2 e),
//    dS^T = P^T (dP^T - delta)); dV += P^T dO and dK += dS^T Q from
//    registers (the GQA group's sum is the register accumulation); the dQ
//    partial dS K over all 128 keys, dS^T staged in shared memory (an
//    MN-major A operand). dQ has no floating-point atomics: three writer
//    warps take the partials from a staging ring, one pair each, and add
//    them into a float32 workspace in key-tile order behind a per-(batch,
//    head, query tile) turn counter (acquire on entry, release on exit); the
//    last contributor writes dq. Items are handed out j-major, so the
//    longest items start first and an item only ever waits on items that
//    were handed out before it: progress does not rest on launch order or
//    residency. Every sum runs in a fixed order, so the results are
//    bit-identical from call to call.
// Measured at the training shape (PERF.md): the forward within 1.1x of
// SDPA, the backward ~5x its bound, set by the elementwise phase between
// the products (both consumer warpgroups run it at once) and the dQ
// handoffs.
// Waits that last seconds can only be faults; they trap instead of hanging.
//
// float32 (the float32 trainer and small slices) runs the same pipeline on
// split operands: every product is three bf16 wgmma products, hi.hi + hi.lo
// + lo.hi, summed into the same float32 accumulator, with lo = bf16(x - hi)
// and hi = bf16(x) rounded to nearest (the pre-passes' planes and Q) or x
// cut to bf16 (P, P^T and dS^T, split in registers: one conversion for two
// values instead of two, and the conversions bound the forward's softmax
// phase). Either way x - hi - lo is within 2^-16 |x|, and the dropped lo.lo
// term within 2^-16 of the product: about float32 accuracy (1e-4 of each
// 64-row tile's scale, where a bf16-only product reads ~2e-3). bf16 wgmma and not TF32: TF32 wgmma takes K-major operands
// only, and the products need MN-major B operands (V in P V, dO in
// dV += P^T dO, Q in dK += dS^T Q, K in dQ = dS K), which only 16-bit
// wgmma reads from shared memory. The float32 kernels keep the consumers
// within the launch's 168 registers a thread (the layouts below). Above it,
// setmaxnreg's grant does reach ptxas (nvcc 12.9; tools/k6_registers.py: a
// consumer loop holding 192 accumulator floats after setmaxnreg.inc 240
// compiles to registers up to R215 with no spill, and to 380 spill stores
// without the grant), but not where a trap can be reached after the grant:
// with a __trap() (or asm trap) in its consumers' mbarrier waits,
// flash_bwd_wgmma_d128 spilled 1.8 KB and ptxas serialized its wgmma
// ("insufficient register resources"); with trap-free waits it spills
// nothing (ptxas -v, as chip_smoke.py's build prints it).
// 4. flash_split_f32: the pre-pass of the forward, K and V into bf16 hi and
//    lo planes ([rows, D] each, taken by TMA in 64-column boxes with the
//    128-byte swizzle as the bf16 tiles are); memory-bound, 8 bytes read and
//    8 written an element. flash_bwd_prep_f32: the backward's pre-pass,
//    delta and the planes of Q, dO, K and V in one launch.
// 5. flash_fwd_f32 (D = 64 here; D = 128 below): flash_fwd_wgmma's
//    schedule over 128-row query tiles,
//    with 64-key K/V tiles: Q is split in each consumer's registers (an A
//    operand, loaded once per work tile), S = Q K^T reads K's two planes,
//    P is split in registers after the online softmax, and O += P V reads
//    V's two planes. A warpgroup passes over (waits for and releases,
//    without computing) a key tile that none of its 64 rows sees: the last
//    tile of the causal band for the upper half, the first under a window
//    for the lower. Shared memory: kF32Stages = 6 stages of K (hi, lo) and
//    V (hi, lo) tiles of 64 keys, 8 KB a plane: 6 x 32 KB = 192 KB; Q takes
//    none. Registers a consumer thread: O 32, S 32, Q's parts 32, P's parts
//    32 and the next tile's 32.
// 6. flash_bwd_f32 (D = 64; D = 128 is flash_bwd_f32_d128, below):
//    flash_bwd_wgmma's items, pairs and dQ order, with the
//    two consumer warpgroups decoupled: each computes, for its own 64 keys,
//    S^T and dP^T (all operands' planes from shared memory), P^T and dS^T,
//    dV += P^T dO (P^T's parts from registers), dK += dS^T Q and its half
//    of the dQ partial, dS K over its 64 keys (dS^T's parts staged in its
//    own rows of a shared buffer, a K-major A operand for dK and an
//    MN-major one for dQ). No barrier ties the two warpgroups (in lockstep,
//    as in flash_bwd_wgmma, both leave the tensor cores idle during their
//    elementwise phases at once), so one's elementwise phase runs beside
//    the other's products; they meet only at the ring's empty barriers and
//    the staged halves, which the dQ writers add in a fixed order (half 0,
//    then half 1), so results stay bit-identical. K's and V's planes are
//    resident for the item (V as registers would be read again for every
//    pair: 16 loads a thread, each across 8 rows, which held up the pair
//    and the ring's mbarrier waits behind them). tools/k6_phase_marks.py
//    splits a pair's time by phase.
//    Shared memory: K and V planes 64 KB, dS^T planes 32 KB, a ring of
//    kF32BwdStages = 2 stages of Q and dO planes (32 KB a stage) with LSE
//    and delta, and kF32DqSlots = 2 staged dQ partials of two unpadded
//    16 KB halves: 225 KB. Two writer warps (as many as the slots).
//    Registers a consumer thread: dK and dV 64, S^T and dP^T 64, then P^T's
//    parts 32 and the dQ half 32.
//
// At head dim 128 a tile is two 64-column chunks (each D = 64's swizzled
// layout, loaded as its own TMA box), so every operand is a chunk or, as
// an MN-major B operand of 128 columns, two chunks kMnLbo apart (LBO steps
// between 64-wide chunks).
// - bf16 forward (flash_fwd_wgmma<128>): D = 64's schedule with 128-key
//   tiles, the consumers at 240 registers a thread (O 64, S 64, P and the
//   next tile's P 32 each), the producer's warpgroup at 24; P V one
//   m64n128 product per k16 step over both chunks of V. K and V rings of 2
//   stages (32 KB a tile) beside Q double-buffered (64 KB): 193 KB. Half the
//   online-softmax rescales, mbarrier round trips and wgmma issue groups of
//   64-key tiles.
// - bf16 backward (flash_bwd_wgmma_d128): items of 128 keys with all 128
//   columns, so S^T and dP^T are formed once for each (key tile, query
//   tile) pair: each consumer warpgroup owns 64 keys, with dK and dV as
//   64 x 128 accumulators (128 registers; the consumers at 240 a thread,
//   warpgroup 2 at 24). A pair: S^T and dP^T (64 x 64 over 128 columns)
//   in two commit groups, P^T formed while dP^T is on the tensor cores;
//   dV += P^T dO issued while dS^T is formed; dS^T into the warpgroup's
//   rows (double-buffered); dK += dS^T Q; then, both warpgroups' rows in,
//   each warpgroup's 64 columns of dQ over the item's 128 keys, added onto
//   the running float32 sum of dQ in a staging slot. The two dQ writer
//   warps move whole 64 x 128 sums by TMA: in key-tile order behind the
//   turn counters, a writer loads the sum from dq_acc into its slot (none
//   at turn 0), the consumers add onto it, and the writer stores it back
//   (or, at the last turn, converts it into dq); the consumers never wait
//   on a global round trip unless a turn is late. No floating-point
//   atomics: each element of dQ is one chain of adds in key-tile order,
//   bit-identical from call to call. When the longest item holds more than
//   1.5 times an SM's share of the pairs (Qwen2.5-7B's 7:1 groups at B=4,
//   T=1024: 128 items of up to 112 pairs for 132 SMs), the first
//   group / 2 key tiles' items each take half of the group's heads
//   (BwdGeom128), and the halves' dK and dV meet in float32
//   (bwd_d128_combine). 225 KB of shared memory (BwdSmem128). The
//   consumers' waits do not trap (mbar_spin, above); the producer's and
//   the writers' do, and every consumer wait is in a cycle with one of
//   theirs. tools/k6_phase_marks.py --dtype bf16 splits a pair's time by
//   phase: a pair takes ~6800 cycles, of which its products would need
//   ~2450 at the tensor cores' peak; the rest is the elementwise phase,
//   the waits on the products and the dQ slot's loads and stores, both
//   warpgroups in step (PERF.md §6).
// - float32 forward (flash_fwd_f32<128>): D = 64's schedule with key tiles
//   of 64 keys and O as two 64-column accumulators; Q's parts over both
//   column chunks stay in each consumer's registers, split once a work tile
//   (no Q planes, no Q pre-pass, no per-tile Q load). Shared memory: three
//   stages of K's and V's planes (64 KB a stage), 192 KB. Registers a
//   consumer thread, at 240 (setmaxnreg; the producer's warpgroup at 24; the
//   consumers' waits trap-free): O 64, Q's parts 64, S 32, P's parts 32. P
//   is split once its tile's P V is done, not while it runs: the next
//   tile's parts, 32 more, made ptxas serialize the products (C7513).
// - float32 backward (flash_bwd_f32_d128): items of 64 keys with all 128
//   columns (K's and V's planes for 128 keys would leave no room beside the
//   ring). The two consumer warpgroups share each (head, query tile) pair,
//   split by product, so that no product and no elementwise step runs
//   twice: warpgroup 0 forms S^T = K Q^T, P^T (handed over in float32
//   through shared memory), dV += P^T dO (P^T's parts from registers) and
//   dK += dS^T Q; warpgroup 1 forms dP^T = V dO^T, dS^T (its parts in
//   shared memory: dK's K-major A operand, dQ's MN-major one) and the dQ
//   partial dS K. dK, dV and dQ are 64 x 128 accumulators (one m64n128
//   product a k16 step: each A tile read once for all 128 columns). The
//   warpgroups meet at three named barriers a pair: P^T in, dS^T in, dV
//   and dK done. Each issues the next pair's first product behind its last
//   ones and waits for it at the pair's end (no wgmma in flight across
//   pairs; ptxas otherwise injects a wait, C7517). Warpgroup 1 stages the
//   pair's 64 x 128 float32 dQ partial where Q's planes were in its ring
//   stage; one writer warp moves it onto dq itself by TMA, in key-tile
//   order behind the turn counters: a store at turn 0, a TMA reduction
//   (float32 adds) after, so there is no dQ workspace, no last-turn
//   conversion and no floating-point atomic, and every call is bit-
//   identical. The writer frees the ring stage once its copy has read the
//   partial. Shared memory: K's and V's planes 64 KB, two ring stages of
//   Q's and dO's planes (64 KB each) with LSE and delta, a 32 KB exchange
//   buffer (P^T 16 KB, dS^T's planes 16 KB): 225 KB. Registers a consumer
//   thread, at 240 (trap-free waits; warpgroup 2 at 24): warpgroup 0 dV 64,
//   dK 64, S^T 32, P^T's parts 32; warpgroup 1 the dQ partial 64, dP^T 32,
//   dS^T's parts 32 (the two warpgroups run separate loops, so that each is
//   allocated for its own). tools/k6_phase_marks.py --dtype f32 --head-dim
//   128 splits a pair's time by phase.
// Times at B=4, T=1024, causal, on an H100 80GB HBM3 at 700 W (PERF.md §6,
// chip_smoke.py): bf16 forward Qwen 28/4 0.074 ms and Llama-8B 32/8 0.084
// (SDPA 0.073, 0.082); bf16 backward 0.35 and 0.34-0.41 ms across calls
// (SDPA 0.285, 0.320; bounds 0.076, 0.087 by operations).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Head dims: 64 and 128. A tile of R rows and D columns lives in shared
// memory as D / 64 chunks of [R][64] bf16, each a run of 128-byte swizzle
// rows (one TMA box of 64 columns each): chunk c of a tile at base p starts
// at p + c R 64. Every wgmma operand below is one chunk or a 64-row slice
// of one, so D = 128 reuses D = 64's descriptors chunk by chunk.
constexpr int kChunk = 64;  // columns of a chunk

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Phase marks of the float32 backwards and of the bf16 backward at head dim
// 128 (a build with RSTNET_K6_MARKS defined: tools/k6_phase_marks.py).
// Thread 0 of each consumer warpgroup writes its SM's clock64 at 8 points
// of each of the block's first kMarkPairs pairs,
// k6_marks[block][warpgroup][pair][8]: [0] before the ring's full wait, [1]
// after it; float32 at 64: [2] S^T and dP^T done, [3] P^T's parts formed,
// [4] dS^T's parts written and synced, [5] dV, dK, dQ done, [6] a staging
// slot free, [7] the dQ half staged; bf16 at 128: [2] S^T done, [3] dS^T
// written (P^T formed, dV issued, dP^T done), [4] dK issued, both
// warpgroups' dS^T in and the dQ slot loaded, [5] dV, dK and dQ done, [6]
// dQ in the slot, [7] handed to the writer. float32 at 128 (the pair's
// first product waited for at the previous pair's end): [0] the pair's
// start, [1] P^T stored (warpgroup 0) or dS^T formed (1), [2] dS^T in, [3]
// dK or dQ issued, [4] the next pair's first product issued, [5] the
// pair's products done, [6] dV and dK done (warpgroup 1 waits), [7] the dQ
// partial staged (1) and the next first product done. Lane 0 of each dQ
// writer at 4 points of its pairs, k6_writer_marks[block][pair][4]: [0]
// before its turn, [1] its turn (and, bf16 at 128, the sum's load issued),
// [2] the consumers' parts in, [3] added and stored (float32 at 128: read
// by its TMA). Thread 0: k6_span_marks[block] = {clock64 at start, at end,
// global timer (ns) at start, at end}.
#ifdef RSTNET_K6_MARKS
constexpr int kMarkBlocks = 132, kMarkPairs = 160;
__device__ long long k6_marks[kMarkBlocks * 2 * kMarkPairs * 8];
__device__ long long k6_writer_marks[kMarkBlocks * kMarkPairs * 4];
__device__ long long k6_span_marks[kMarkBlocks * 4];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K6_MARK(n)                                                                          \
  do {                                                                                      \
    if (threadIdx.x % 128 == 0 && slot < kMarkPairs && blockIdx.x < kMarkBlocks)           \
      k6_marks[((blockIdx.x * 2 + wg) * kMarkPairs + slot) * 8 + (n)] = clock64();          \
  } while (0)
#define K6_WRITER_MARK(n)                                                                   \
  do {                                                                                      \
    if (lane == 0 && slot < kMarkPairs && blockIdx.x < kMarkBlocks)                         \
      k6_writer_marks[(blockIdx.x * kMarkPairs + slot) * 4 + (n)] = clock64();              \
  } while (0)
#define K6_SPAN_MARK(i)                                                                     \
  do {                                                                                      \
    if (threadIdx.x == 0 && blockIdx.x < kMarkBlocks) {                                     \
      k6_span_marks[blockIdx.x * 4 + (i)] = clock64();                                      \
      k6_span_marks[blockIdx.x * 4 + 2 + (i)] = global_ns();                                \
    }                                                                                       \
  } while (0)
#else
#define K6_MARK(n)
#define K6_WRITER_MARK(n)
#define K6_SPAN_MARK(i)
#endif


// ---------------------------------------------------------------------------
// Hopper kernels (bf16): TMA, mbarriers and wgmma.
// ---------------------------------------------------------------------------

constexpr int kRowBytes = kChunk * 2;   // one 64-wide bf16 row: 128 B, one 128-byte swizzle row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kConsumers = 256;         // two consumer warpgroups
constexpr int kWsThreads = kConsumers + 128;  // plus the producer's warpgroup
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a wait this long is a bug

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive, and make the phase wait for `bytes` more of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}
// Until the phase of this parity has completed. A wait of seconds can only
// be a fault: trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}
// The same without the trap, for consumers above the launch's register
// share: a trap reachable after setmaxnreg.inc holds ptxas's allocation there
// to about 184 registers (flash_bwd_wgmma_d128 spilled 1.8 KB around its
// waits; header, "At head dim 128"). Each of their waits is in a cycle with
// a wait of the producer or a dQ writer, which traps.
__device__ __forceinline__ void mbar_spin(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// TMA: a [rows, 64] box of a 2-D bf16 tensor map at (col, row) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}
// A [Rows, D] tile at `row` as its D / 64 chunks (the map's box is [Rows, 64]).
template <int D, int Rows>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row) {
#pragma unroll
  for (int c = 0; c < D / kChunk; ++c) tma_load(dst + c * Rows * kChunk, map, bar, row, c * kChunk);
}
// TMA bulk copy of contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Register hand-off between warpgroups (the kernel launches with an even
// split; the producer's warpgroup gives its registers to the consumers').
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// Arrive at a named barrier without waiting: the writes before it are
// visible to the threads that then complete it with named_sync.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor for a tile whose rows are 128 bytes with
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B; the tile starts on
// a 1024-byte boundary). lbo / sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (K along the 128-byte row): 8-row swizzle atoms 1024 B
// apart; a k16 step advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_k(const void* p) { return make_desc(p, 16, 1024); }
// MN-major operand (M or N along the row, one row per k): 8-row groups
// along K 1024 B apart (SBO); a k16 step advances the start by 16 rows.
// LBO would step between 64-wide MN chunks; every MN-major operand here is
// at most 64 wide.
constexpr uint32_t kMnLbo = 8192, kMnSbo = 1024;
__device__ __forceinline__ uint64_t desc_mn(const void* p) { return make_desc(p, kMnLbo, kMnSbo); }
// a descriptor advanced by `bytes` (a multiple of 16)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// Byte offset of bf16 element (r, c) in a [rows][64] tile with the
// 128-byte swizzle: the 16-byte chunk index is XORed with r % 8.
__device__ __forceinline__ uint32_t swizzle_offset(int r, int c) {
  return r * kRowBytes + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma boundaries (before wgmma.fence and after
// the wait).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keeps A operands in registers alive (unreused) until the wgmma that reads
// them has been waited for; otherwise ptxas serializes the wgmmas.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B, m64n32k16, A and B from shared memory (descriptors); TA / TB:
// 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A B, m64n64k16, A and B from shared memory (descriptors); TA / TB:
// 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A B, m64n128k16, A and B from shared memory (descriptors); TA / TB:
// 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A B, m64n128k16, A and B from shared memory (descriptors), into an
// accumulator kept as two 64-column halves (d[c]: columns [64 c, 64 c + 64)
// in D = 64's layout); TA / TB: 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[2][32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A B over N columns of B (64 or 128), both from shared memory.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 128) wgmma_ss_n128<TA, TB>(d, a, b, acc);
  else wgmma_ss_n64<TA, TB>(d, a, b, acc);
}

// d += A B, m64n64k16, A from registers (the accumulator layout, as bf16
// pairs), B from shared memory; TB: 1 for an MN-major B.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d += A B, m64n128k16, A from registers (the accumulator layout, as bf16
// pairs), B from shared memory; TB: 1 for an MN-major B. d[c] holds the
// accumulator's columns [64 c, 64 c + 64) in D = 64's layout.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[2][32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A operands (k16 steps) from a 64 x N float32 accumulator: step kk takes
// accumulator columns [16 kk, 16 kk + 16), whose layout is the A fragment's.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[R / 8][4], const float (&d)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Accumulator element e of a thread of a warpgroup: its row in the 64-row
// tile and its column.
__device__ __forceinline__ int acc_row(int e) {
  const int t = threadIdx.x % 128;
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return (e >> 2) * 8 + 2 * (threadIdx.x % 4) + (e & 1);
}


__device__ __forceinline__ bool sees(int i, int j, int window) {
  const int d = i - j;
  return d >= 0 && d < window;
}

// ---- forward --------------------------------------------------------------

constexpr int kFwdRows = 128;   // query rows of a work tile: 64 per consumer warpgroup
// keys of a K/V tile: 128 at both head dims (at D = 128 the consumer holds
// O 64 registers, S 64 and P twice 32, above the launch's 168: see the
// registers of setmaxnreg in the header)
template <int D>
constexpr int kFwdKeys = 128;
// stages of the K and V rings: 16 KB a tile at D = 64, 32 KB at D = 128
template <int D>
constexpr int kFwdStages = D == 64 ? 4 : 2;

template <int D>
struct FwdSmem {
  bf16 q[2][kFwdRows * D];  // double-buffered: the next tile's Q loads during this one
  bf16 k[kFwdStages<D>][kFwdKeys<D> * D];
  bf16 v[kFwdStages<D>][kFwdKeys<D> * D];
  // K and V are separate rings: S needs only K, and K's slot frees up as
  // soon as S is done
  uint64_t q_full[2], q_empty[2], k_full[kFwdStages<D>], k_empty[kFwdStages<D>],
      v_full[kFwdStages<D>], v_empty[kFwdStages<D>];
};
template <int D>
constexpr int kFwdSmemBytes = sizeof(FwdSmem<D>) + 1024;  // + alignment slack

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023);
  return reinterpret_cast<unsigned char*>(a);
}
// The same as an offset into the shared array itself, so that the compiler
// keeps its address space (shared loads and stores instead of generic ones).
__device__ __forceinline__ unsigned char* align1024_shared(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// The forward's work tiles, longest first: tile w is query tile
// n_qt - 1 - w / bh_count of batch x head w % bh_count. Block b takes the
// tiles of rounds r = 0, 1, ... at r G + b, snaking (G - 1 - b on odd
// rounds) so that the long and the short tiles of each round even out.
// Keys: the width of a K/V tile.
template <int Keys>
struct FwdWork {
  int bh_count, n_qt, seq, window, group;
  __device__ int count() const { return bh_count * n_qt; }
  __device__ int tile(int round) const {
    const int g = gridDim.x, b = blockIdx.x;
    return round * g + ((round & 1) ? g - 1 - b : b);
  }
  __device__ int qt(int w) const { return n_qt - 1 - w / bh_count; }
  __device__ int bh(int w) const { return w % bh_count; }
  __device__ int j_lo(int w) const { return max(0, qt(w) * kFwdRows - window + 1) / Keys; }
  // the key tiles a work tile sees; the last holds the diagonal
  __device__ int n_tiles(int w) const {
    return (qt(w) * kFwdRows + kFwdRows - 1) / Keys - j_lo(w) + 1;
  }
};

// One step of the online softmax over a 64-row score tile of R / 2 columns,
// in base 2 (q is pre-scaled, so log2(e) is the only factor): masks when
// asked, updates the running max m and sum l, returns each row's rescale
// factor for O in alpha, and leaves the tile's unnormalized P in sc. A row
// that sees nothing of the tile (-inf everywhere) keeps its m and gets P = 0.
template <int R>
__device__ __forceinline__ void softmax_scores(float (&sc)[R], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool masked, int row0, int k0,
                                               int window) {
  if (masked) {
#pragma unroll
    for (int e = 0; e < R; ++e)
      if (!sees(row0 + acc_row(e), k0 + acc_col(e), window)) sc[e] = -INFINITY;
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < R / 4; ++c) mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx) * kLog2e);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
    alpha[r] = fast_exp2(m[r] - base[r]);
    l[r] *= alpha[r];
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < R; ++e) {
    sc[e] = fast_exp2(fmaf(sc[e], kLog2e, -base[(e >> 1) & 1]));
    l[(e >> 1) & 1] += sc[e];
  }
}

// O (D / 64 accumulators of 64 x 64) divided by the row sums, into o, and
// the rows' log-sum-exp into lse.
template <int D, typename Out>
__device__ __forceinline__ void store_o(const float (&acc)[D / kChunk][32], const float (&m)[2],
                                        const float (&l)[2], Out* __restrict__ o,
                                        float* __restrict__ lse, int bh, int seq, int row0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(l[r]);
    const float inv = 1.f / total;
    const int row = row0 + acc_row(2 * r);
    Out* orow = o + (static_cast<size_t>(bh) * seq + row) * D;
#pragma unroll
    for (int c = 0; c < D / kChunk; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        store2(orow + c * kChunk + acc_col(4 * e), acc[c][4 * e + 2 * r] * inv,
               acc[c][4 * e + 2 * r + 1] * inv);
    if (threadIdx.x % 4 == 0)
      lse[static_cast<size_t>(bh) * seq + row] = (m[r] + log2f(total)) * kLn2;
  }
}

template <int C>
__device__ __forceinline__ void fence_acc(float (&acc)[C][32]) {
#pragma unroll
  for (int c = 0; c < C; ++c) fence_regs(acc[c]);
}

// Persistent, one block per SM. Warps 0-7: two consumer warpgroups, 64
// query rows of the work tile each (232 registers a thread at D = 64, 240
// at D = 128); warp 8: the producer, one thread of which issues every TMA
// load (Q per work tile, K/V per key tile); warps 9-11 only give their
// registers away.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, FwdWork<kFwdKeys<D>> wk) {
  constexpr int Keys = kFwdKeys<D>, NC = D / kChunk, Stages = kFwdStages<D>;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align1024(smem_raw));
  const int seq = wk.seq;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.q_full[b], 1);
      mbar_init(&sm.q_empty[b], kConsumers);
    }
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup: one thread loads
    regs_dec<D == 64 ? 40 : 24>();
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (int n = 0, w = wk.tile(0); w < wk.count(); w = wk.tile(++n)) {
      const int qb = n & 1, bh = wk.bh(w), kv_row = (bh / wk.group) * seq, j_lo = wk.j_lo(w);
      mbar_wait(&sm.q_empty[qb], ((n >> 1) & 1) ^ 1);
      mbar_expect_tx(&sm.q_full[qb], kFwdRows * D * 2);
      tma_tile<D, kFwdRows>(sm.q[qb], &tq, &sm.q_full[qb], bh * seq + wk.qt(w) * kFwdRows);
      for (int t = 0; t < wk.n_tiles(w); ++t, ++slot) {
        const int s = slot % Stages, row = kv_row + (j_lo + t) * Keys;
        const uint32_t phase = ((slot / Stages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[s], phase);
        mbar_expect_tx(&sm.k_full[s], Keys * D * 2);
        tma_tile<D, Keys>(sm.k[s], &tk, &sm.k_full[s], row);
        mbar_wait(&sm.v_empty[s], phase);
        mbar_expect_tx(&sm.v_full[s], Keys * D * 2);
        tma_tile<D, Keys>(sm.v[s], &tv, &sm.v_full[s], row);
      }
    }
    return;
  }
  regs_inc<D == 64 ? 232 : 240>();

  const int wg = threadIdx.x / 128;
  int slot = 0;
  for (int n = 0, w = wk.tile(0); w < wk.count(); w = wk.tile(++n)) {
    const int qb = n & 1, bh = wk.bh(w), j_lo = wk.j_lo(w), n_tiles = wk.n_tiles(w);
    const int row0 = wk.qt(w) * kFwdRows + wg * 64;  // this warpgroup's first query row
    // only the diagonal tile and the window's edge tile are masked
    auto masked = [&](int k0) { return k0 + Keys - 1 > row0 || row0 + 63 - k0 >= wk.window; };
    float acc[NC][32], sc[Keys / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[Keys / 16][4], pn[Keys / 16][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    mbar_wait(&sm.q_full[qb], (n >> 1) & 1);
    const bf16* q_rows = sm.q[qb] + wg * 64 * kChunk;  // this warpgroup's rows of chunk 0
    auto issue_s = [&](int s) {  // sc = Q K^T for the K tile in stage s
#pragma unroll
      for (int e = 0; e < Keys / 2; ++e) sc[e] = 0.f;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dq = desc_k(q_rows + c * kFwdRows * kChunk);
        const uint64_t dk = desc_k(sm.k[s] + c * Keys * kChunk);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          wgmma_ss<Keys, 0, 0>(sc, desc_add(dq, 32 * kk), desc_add(dk, 32 * kk), c + kk > 0);
      }
      wg_commit();
    };

    mbar_wait(&sm.k_full[slot % Stages], (slot / Stages) & 1);
    issue_s(slot % Stages);
    wg_wait0();
    fence_regs(sc);
    mbar_arrive(&sm.k_empty[slot % Stages]);
    softmax_scores(sc, m, l, alpha, masked(j_lo * Keys), row0, j_lo * Keys, wk.window);
    acc_to_a<Keys / 2>(p, sc);
    // Tile t: S of tile t + 1 goes to the tensor cores ahead of P V of tile
    // t, and its softmax runs while P V does; O is rescaled once P V is done.
    // The last tile's P V follows the loop, so the loop body has no branch
    // (ptxas then sees that the wait of one group retires S).
    auto issue_pv = [&](int s) {  // acc += P V for the V tile in stage s
      mbar_wait(&sm.v_full[s], (slot / Stages) & 1);
      fence_acc(acc);
      fence_regs(p);
      wg_fence();
      if constexpr (NC == 2) {  // both column chunks of V in one product per k16 step
        const uint64_t dv = make_desc(sm.v[s], Keys * kRowBytes, kMnSbo);
#pragma unroll
        for (int kk = 0; kk < Keys / 16; ++kk)
          wgmma_rs_n128<1>(acc, p[kk], desc_add(dv, kk * 16 * kRowBytes));
      } else {
        const uint64_t dv = desc_mn(sm.v[s]);
#pragma unroll
        for (int kk = 0; kk < Keys / 16; ++kk)
          wgmma_rs_n64<1>(acc[0], p[kk], desc_add(dv, kk * 16 * kRowBytes));
      }
      wg_commit();
    };
    for (int t = 0; t + 1 < n_tiles; ++t, ++slot) {
      const int s = slot % Stages, s1 = (slot + 1) % Stages;
      mbar_wait(&sm.k_full[s1], ((slot + 1) / Stages) & 1);
      issue_s(s1);
      issue_pv(s);
      wg_wait1();
      fence_regs(sc);
      mbar_arrive(&sm.k_empty[s1]);
      const int k1 = (j_lo + t + 1) * Keys;
      softmax_scores(sc, m, l, alpha, masked(k1), row0, k1, wk.window);
      acc_to_a<Keys / 2>(pn, sc);
      wg_wait0();
      fence_acc(acc);
      fence_regs(p);
      mbar_arrive(&sm.v_empty[s]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < Keys / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[kk][i] = pn[kk][i];
    }
    issue_pv(slot % Stages);
    wg_wait0();
    fence_acc(acc);
    fence_regs(p);
    mbar_arrive(&sm.v_empty[slot % Stages]);
    ++slot;
    mbar_arrive(&sm.q_empty[qb]);
    store_o<D>(acc, m, l, o, lse, bh, seq, row0);
  }
}

// ---- backward -------------------------------------------------------------

// delta = rowsum(dO * O) in float32, 8 threads a row (part of the backward:
// its main kernel reads delta through the TMA ring).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ delta) {
  const size_t row = static_cast<size_t>(blockIdx.x) * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < D / 64; ++u) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + row * D) + part + 8 * u);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(dout + row * D) + part + 8 * u);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
      sum += fx.x * fy.x + fx.y * fy.y;
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (part == 0) delta[row] = sum;
}

constexpr int kBwdKeys = 128;  // keys of a bf16 work item: 64 per consumer warpgroup
constexpr int kBwdRows = 64;   // query rows of a ring tile
constexpr int kDqWriters = 96;  // warps 9-11, each taking every third pair's dQ partial
constexpr int kBwdThreads = kConsumers + 32 + kDqWriters;  // 384: three warpgroups
constexpr int kDqStride = kChunk + 8;  // floats per row of a staged dQ partial (fewer bank conflicts)
constexpr int kBwdStages = 4;  // D = 64: ring stages
constexpr int kDqSlots = 4;    // D = 64: staged dQ partials

// D = 64 (D = 128 has BwdSmem128)
struct BwdSmem {
  bf16 k[kBwdKeys * 64];
  bf16 v[kBwdKeys * 64];
  bf16 dst[2][kBwdKeys * kBwdRows];  // dS^T of the last two pairs: [key][query], swizzled
  bf16 q[kBwdStages][kBwdRows * 64];
  bf16 dout[kBwdStages][kBwdRows * 64];
  float lse[kBwdStages][kBwdRows];
  float delta[kBwdStages][kBwdRows];
  float dqs[kDqSlots][kBwdRows * kDqStride];  // 64 x 64 dQ partials for the writers
  uint64_t full[kBwdStages], empty[kBwdStages], kv_full, kv_empty, dq_full[kDqSlots],
      dq_empty[kDqSlots];
  int item;
};

constexpr int kBwdSmemBytes = sizeof(BwdSmem) + 1024;

// D = 128: K and V of the item's 128 keys (all 128 columns), dS^T of the
// last two pairs ([key][query]: each consumer warpgroup writes its 64 keys'
// rows and reads all 128), 2 ring stages of Q, dO, LSE and delta, and 2 dQ
// staging slots, each a 64 x 128 float32 running sum in TMA's layout
// (dq_slot_offset): 225 KB.
constexpr int kBwd128Stages = 2, kBwd128Slots = 2;
constexpr int kBwd128Writers = 2;  // warps 9 and 10, one a slot
struct BwdSmem128 {
  bf16 k[kBwdKeys * 128];
  bf16 v[kBwdKeys * 128];
  bf16 dst[2][kBwdKeys * kBwdRows];
  bf16 q[kBwd128Stages][kBwdRows * 128];
  bf16 dout[kBwd128Stages][kBwdRows * 128];
  float dqs[kBwd128Slots][kBwdRows * 128];
  float lse[kBwd128Stages][kBwdRows];
  float delta[kBwd128Stages][kBwdRows];
  uint64_t full[kBwd128Stages], empty[kBwd128Stages], kv_full, kv_empty,
      dq_loaded[kBwd128Slots], dq_full[kBwd128Slots];
  int item;
  int second[2];  // a split item's consumer warpgroup finished after its other half's
};
constexpr int kBwd128SmemBytes = sizeof(BwdSmem128) + 1024;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The work items' geometry. Item n is key tile j = n / (B Hkv) of (batch,
// KV head) n % (B Hkv): j-major, so the longest items (small j under a
// causal mask) come first and every item comes after the items it waits on
// (the same (batch, KV head) at smaller j). Keys: the keys of a work item.
template <int Keys>
struct BwdGeom {
  int batch_kv, group, seq, window, n_items;  // batch_kv = B Hkv, group = H / Hkv
  __device__ int j(int item) const { return item / batch_kv; }
  __device__ int bg(int item) const { return item % batch_kv; }
  __device__ int q_tiles() const { return seq / kBwdRows; }
  // query tiles [i_lo, i_hi] that see a key of tile j
  __device__ int i_lo(int j) const { return j * Keys / kBwdRows; }
  __device__ int i_hi(int j) const {
    return min(q_tiles() - 1, (j * Keys + Keys - 1 + window - 1) / kBwdRows);
  }
  // key tiles [j_lo, j_hi] that query tile i sees: the dQ contributors
  __device__ int j_lo(int i) const { return max(0, i * kBwdRows - window + 1) / Keys; }
  __device__ int j_hi(int i) const { return (i * kBwdRows + kBwdRows - 1) / Keys; }
};

// flash_bwd_wgmma_d128's items. When the key tiles alone give too few items
// to fill the card (Qwen2.5-7B at B=4, T=1024: 128 items of up to 112
// pairs for 132 SMs), each item of the first split_j key tiles (the longest
// under a causal mask) takes half of its group's query heads: item n <
// n_split() is (j, bg, half n % 2); the rest are whole groups, j-major as
// before. The two halves' dK and dV meet in float32 (bwd_d128_combine).
// Split when the longest item holds more than 1.5 times an SM's share of
// the pairs (bwd_bf16).
struct BwdGeom128 : BwdGeom<kBwdKeys> {
  int split_j;
  __device__ int n_split() const { return split_j * batch_kv * 2; }
  __device__ int j(int item) const {
    return item < n_split() ? item / (2 * batch_kv) : split_j + (item - n_split()) / batch_kv;
  }
  __device__ int bg(int item) const {
    return item < n_split() ? item % (2 * batch_kv) / 2 : (item - n_split()) % batch_kv;
  }
  __device__ int half(int item) const { return item < n_split() ? item % 2 : -1; }
  // the item's query heads: [h_lo, h_lo + heads) of the group
  __device__ int h_lo(int item) const { return half(item) == 1 ? (group + 1) / 2 : 0; }
  __device__ int heads(int item) const {
    const int h = half(item);
    return h < 0 ? group : h == 0 ? (group + 1) / 2 : group / 2;
  }
};

// Offset (floats) of element (r, c) of an unpadded 64 x 64 float32 tile
// whose 8-float chunks are XORed with r % 8 (spreads a column's rows over
// the banks).
__device__ __forceinline__ int dqs_offset(int r, int c) { return r * kChunk + (c ^ ((r & 7) << 3)); }

// The dQ writers of the backward (Writers warps from warp 9). Writer warp wk
// takes pairs wk, wk + Writers, ... of the block's sequence, so Writers
// (b, h, i) tiles are in flight at once. For each it waits for its turn,
// adds the staged partial to the float32 workspace (or, as the last
// contributor, writes dq), and releases the next turn. Returns when the
// block's items are done. Slots >= Writers: a writer's last pair must be
// no older than the last use of the buffer it waits on, or its parity wait
// could pass on that use's phase.
// Halves == 1: a staged partial is one padded 64 x 64 tile (bf16).
// Halves == 2: two unpadded 64 x 64 halves (float32; one per consumer
// warpgroup, each over its 64 keys; dqs_offset), added half 0 then half 1.
template <int Slots, int Writers, int Halves, int D, typename Smem, typename Geo, typename Out>
__device__ __forceinline__ void write_dq(Smem& sm, const Geo& geo, Out* __restrict__ dq,
                                         float* __restrict__ dq_acc, int* __restrict__ turns) {
  static_assert(D == 64, "head dim 128 has write_dq128 and write_dq_f32_d128");
  constexpr int Cols = 64;  // columns of a staged partial
  const int seq = geo.seq, group = geo.group;
  const int wk = (threadIdx.x - (kConsumers + 32)) / 32, lane = threadIdx.x % 32;
  int slot = 0;
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_wait(&sm.kv_full, kv_phase);
    const int item = sm.item;
    mbar_arrive(&sm.kv_empty);  // the writers read nothing else of the item's buffers
    if (item >= geo.n_items) return;
    const int j = geo.j(item), h0 = geo.bg(item) * group;
    const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
    for (int p = 0; p < n_pairs; ++p, ++slot) {
      if (slot % Writers != wk) continue;
      const int h = h0 + p % group, i = i_hi - p / group, b = slot % Slots;
      // this item's turn for (b, h, i) is j - j_lo(i), in key-tile order
      const int turn = j - geo.j_lo(i);
      const bool last = j == geo.j_hi(i);
      int* counter = turns + static_cast<size_t>(h) * geo.q_tiles() + i;
      K6_WRITER_MARK(0);
      if (lane == 0) {
        const long long t0 = clock64();
        while (ld_acquire(counter) < turn)
          if (clock64() - t0 > kHangCycles) __trap();
      }
      __syncwarp();
      K6_WRITER_MARK(1);
      mbar_wait(&sm.dq_full[b], (slot / Slots) & 1);
      K6_WRITER_MARK(2);
      const size_t base = (static_cast<size_t>(h) * seq + i * kBwdRows) * D;
      constexpr int kUnroll = 8, kVecs = kBwdRows * Cols / 4;  // float4s a lane, a tile
#pragma unroll 1
      for (int c0 = 0; c0 < kVecs; c0 += 32 * kUnroll) {
        float4 x[kUnroll];
#pragma unroll
        for (int n = 0; n < kUnroll; ++n) {
          const int idx = c0 + n * 32 + lane, r = idx / (Cols / 4), c = (idx % (Cols / 4)) * 4;
          if constexpr (Halves == 1) {
            x[n] = *reinterpret_cast<const float4*>(&sm.dqs[b][r * kDqStride + c]);
          } else {
            const float4 u = *reinterpret_cast<const float4*>(&sm.dqs[b][0][dqs_offset(r, c)]);
            const float4 w = *reinterpret_cast<const float4*>(&sm.dqs[b][1][dqs_offset(r, c)]);
            x[n] = make_float4(u.x + w.x, u.y + w.y, u.z + w.z, u.w + w.w);
          }
          if (turn > 0) {
            const float4 y =
                __ldcg(reinterpret_cast<const float4*>(dq_acc + base + r * D + c));
            x[n] = make_float4(y.x + x[n].x, y.y + x[n].y, y.z + x[n].z, y.w + x[n].w);
          }
        }
#pragma unroll
        for (int n = 0; n < kUnroll; ++n) {
          const int idx = c0 + n * 32 + lane;
          const size_t off = base + (idx / (Cols / 4)) * D + (idx % (Cols / 4)) * 4;
          if (last) {
            store2(dq + off, x[n].x, x[n].y);
            store2(dq + off + 2, x[n].z, x[n].w);
          } else {
            __stcg(reinterpret_cast<float4*>(dq_acc + off), x[n]);
          }
        }
      }
      mbar_arrive(&sm.dq_empty[b]);
      K6_WRITER_MARK(3);
      __syncwarp();
      if (lane == 0) add_release(counter, 1);
    }
  }
}

// Persistent: each block takes work items from `work` until none are left.
// An item (batch b, KV head g, key tile j) keeps K and V of its 128 keys in
// shared memory and visits every (query head h of the group, query tile i)
// pair that sees them: query tiles from the last down, the group's heads
// inside. Under a causal mask that puts (h, i) at the same place in every
// item that contributes to it, so the dQ turns of consecutive items follow
// each other one handoff apart instead of piling up at the items' ends.
// Warps 0-7 (two consumer warpgroups, 64 keys each) run the products; warp
// 8 streams each pair's Q, dO, LSE and delta through a ring of kBwdStages
// stages; warps 9-11 take the pairs' dQ partials from shared memory and add
// them, in turn, into the float32 workspace, so the consumers never wait on
// that global round trip. This is D = 64's kernel; D = 128 has its own,
// flash_bwd_wgmma_d128, below.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                float* __restrict__ dq_acc, int* __restrict__ turns, int* __restrict__ work,
                BwdGeom<kBwdKeys> geo) {
  static_assert(D == 64, "head dim 128 is flash_bwd_wgmma_d128");
  constexpr int NC = D / kChunk, Stages = kBwdStages, Slots = kDqSlots;
  extern __shared__ unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(align1024(smem_raw));
  const int seq = geo.seq, group = geo.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumers + kDqWriters);
    for (int b = 0; b < Slots; ++b) {
      mbar_init(&sm.dq_full[b], kConsumers);
      mbar_init(&sm.dq_empty[b], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // warpgroup 2: the producer warp and the dQ writers
    regs_dec<80>();
    if (threadIdx.x >= kConsumers + 32) {  // dQ writers
      write_dq<Slots, kDqWriters / 32, 1, D>(sm, geo, dq, dq_acc, turns);
      return;
    }

    // producer warp
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
      const int item = atomicAdd(work, 1);
      if (item >= geo.n_items) {
        mbar_wait(&sm.kv_empty, kv_phase ^ 1);
        sm.item = item;
        mbar_arrive(&sm.kv_full);  // no loads: the block stops
        return;
      }
      const int j = geo.j(item), bg = geo.bg(item);
      const int h0 = bg * group;  // (b, g) -> the group's first query head, b H + g group
      const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
      bool kv_loaded = false;
      for (int p = 0; p < n_pairs; ++p, ++slot) {
        const int s = slot % Stages;
        const int row = (h0 + p % group) * seq + (i_hi - p / group) * kBwdRows;
        mbar_wait(&sm.empty[s], ((slot / Stages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kBwdRows * D * 2 + 2 * kBwdRows * 4);
        tma_tile<D, kBwdRows>(sm.q[s], &tq, &sm.full[s], row);
        tma_tile<D, kBwdRows>(sm.dout[s], &tdo, &sm.full[s], row);
        bulk_load(sm.lse[s], lse + row, kBwdRows * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + row, kBwdRows * 4, &sm.full[s]);
        // K and V once the ring holds the item's first pairs (the buffers
        // free up only when the previous item is done)
        if (!kv_loaded && (p == Stages - 1 || p == n_pairs - 1)) {
          mbar_wait(&sm.kv_empty, kv_phase ^ 1);
          sm.item = item;
          mbar_expect_tx(&sm.kv_full, 2 * kBwdKeys * D * 2);
          tma_tile<D, kBwdKeys>(sm.k, &tk, &sm.kv_full, bg * seq + j * kBwdKeys);
          tma_tile<D, kBwdKeys>(sm.v, &tv, &sm.kv_full, bg * seq + j * kBwdKeys);
          kv_loaded = true;
        }
      }
    }
  }
  regs_inc<208>();

  const int wg = threadIdx.x / 128;
  int slot = 0;
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_wait(&sm.kv_full, kv_phase);
    const int item = sm.item;
    if (item >= geo.n_items) return;
    const int j = geo.j(item), bg = geo.bg(item);
    const int k0 = j * kBwdKeys + wg * 64;  // this warpgroup's first key
    const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;
    // this warpgroup's 64 rows of K and V (chunk 0; chunk c is c 128 64 on)
    const bf16* const k_rows = sm.k + wg * 64 * kChunk;
    const bf16* const v_rows = sm.v + wg * 64 * kChunk;

    for (int p = 0; p < n_pairs; ++p, ++slot) {
      const int s = slot % Stages;
      const int q0 = (i_hi - p / group) * kBwdRows;
      mbar_wait(&sm.full[s], (slot / Stages) & 1);
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t d_k = desc_k(k_rows + c * kBwdKeys * kChunk);
        const uint64_t d_v = desc_k(v_rows + c * kBwdKeys * kChunk);
        const uint64_t d_q = desc_k(sm.q[s] + c * kBwdRows * kChunk);
        const uint64_t d_do = desc_k(sm.dout[s] + c * kBwdRows * kChunk);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          wgmma_ss_n64<0, 0>(st, desc_add(d_k, 32 * kk), desc_add(d_q, 32 * kk), c + kk > 0);
          wgmma_ss_n64<0, 0>(dpt, desc_add(d_v, 32 * kk), desc_add(d_do, 32 * kk), c + kk > 0);
        }
      }
      wg_commit();
      wg_wait0();
      fence_regs(st);
      fence_regs(dpt);
      // P^T = exp2(S^T log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta);
      // columns are queries: a thread's 16 columns' lse and delta, once
      float lse2[16], dlt[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = acc_col(2 * (c / 2) * 2 + (c & 1));
        lse2[c] = sm.lse[s][col] * kLog2e;
        dlt[c] = sm.delta[s][col];
      }
      if (k0 + 63 > q0 || q0 + kBwdRows - 1 - k0 >= geo.window) {  // masked tile
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = (e >> 2) * 2 + (e & 1);
          const float pv = sees(q0 + acc_col(e), k0 + acc_row(e), geo.window)
                               ? fast_exp2(fmaf(st[e], kLog2e, -lse2[c])) : 0.f;
          st[e] = pv;
          dpt[e] = pv * (dpt[e] - dlt[c]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = (e >> 2) * 2 + (e & 1);
          const float pv = fast_exp2(fmaf(st[e], kLog2e, -lse2[c]));
          st[e] = pv;
          dpt[e] = pv * (dpt[e] - dlt[c]);
        }
      }
      uint32_t a_p[4][4], a_ds[4][4];
      acc_to_a<32>(a_p, st);
      acc_to_a<32>(a_ds, dpt);
      // dS^T into this warpgroup's 64 rows of shared memory, for dQ (two
      // buffers: the other warpgroup may still read the last pair's)
      bf16* dst = sm.dst[slot & 1];
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dst) +
                                     swizzle_offset(wg * 64 + acc_row(e), acc_col(e))) =
            a_ds[e / 8][(e % 8) / 2];
      // dV += P^T dO, dK += dS^T Q: the group's sum, in registers
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(a_p);
      fence_regs(a_ds);
      wg_fence();
      const uint64_t m_do = desc_mn(sm.dout[s]);
      const uint64_t m_q = desc_mn(sm.q[s]);
#pragma unroll
      for (int kk = 0; kk < kBwdRows / 16; ++kk) {
        wgmma_rs_n64<1>(dv_acc, a_p[kk], desc_add(m_do, kk * 16 * kRowBytes));
        wgmma_rs_n64<1>(dk_acc, a_ds[kk], desc_add(m_q, kk * 16 * kRowBytes));
      }
      wg_commit();
      // dS^T to the async proxy and to the other warpgroup; then this
      // warpgroup's half of the dQ partial (64 queries x 32 columns) over
      // all 128 keys: dS K[:, 32 wg : + 32]
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1, kConsumers);
      float dqp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dqp[e] = 0.f;
      fence_regs(dqp);
      wg_fence();
      const uint64_t m_ds = desc_mn(dst);
      const uint64_t m_k = desc_add(desc_mn(sm.k), wg * 64);
#pragma unroll
      for (int kk = 0; kk < kBwdKeys / 16; ++kk)
        wgmma_ss_n32<1, 1>(dqp, desc_add(m_ds, kk * 16 * kRowBytes),
                           desc_add(m_k, kk * 16 * kRowBytes), kk > 0);
      wg_commit();
      wg_wait0();
      fence_regs(dqp);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(a_p);
      fence_regs(a_ds);
      mbar_arrive(&sm.empty[s]);
      // the partial to its writer warp, through one of the staging slots
      const int b = slot % Slots;
      mbar_wait(&sm.dq_empty[b], ((slot / Slots) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 16; e += 2)
        *reinterpret_cast<float2*>(&sm.dqs[b][acc_row(e) * kDqStride + wg * 32 + acc_col(e)]) =
            make_float2(dqp[e], dqp[e + 1]);
      mbar_arrive(&sm.dq_full[b]);
    }
    // dK, dV of this warpgroup's 64 keys, at the KV head's rows
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const size_t off = (static_cast<size_t>(bg) * seq + k0 + acc_row(e)) * D + acc_col(e);
      store2(dk + off, dk_acc[e], dk_acc[e + 1]);
      store2(dv + off, dv_acc[e], dv_acc[e + 1]);
    }
    mbar_arrive(&sm.kv_empty);
  }
}

// TMA: a box of a 2-D tensor map at (col, row) from shared memory back to
// global memory, in the thread's bulk async-group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int row,
                                          int col) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(col), "r"(row)
               : "memory");
}
// Until the thread's bulk async-groups have completed (their writes done).
__device__ __forceinline__ void bulk_commit_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;" ::: "memory");
}
// TMA: a box of a 2-D float32 tensor map at (col, row) added from shared
// memory onto global memory, element by element, in the thread's bulk
// async-group.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, const void* src, int row,
                                               int col) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

// Offset (floats) of element (r, c) of a 64 x 128 float32 tile as TMA lays
// out four [64, 32] boxes with the 128-byte swizzle (box c / 32; the 16-byte
// chunk index XORed with r % 8).
__device__ __forceinline__ int dq_slot_offset(int r, int c) {
  return (c >> 5) * (kBwdRows * 32) + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The dQ writers of flash_bwd_wgmma_d128 (warps 9 and 10). Writer w owns
// staging slot w and takes the block's pairs w, w + 2, ... For each, once
// the pair's (b, h, i) turn has come (acquire), lane 0 loads the running
// float32 sum of dQ from dq_acc into the slot by TMA (at turn 0 there is
// none: the consumers start from zero), completing dq_loaded; the consumers
// add their partials onto it in the slot (each warpgroup its 64 columns)
// and signal dq_full; then lane 0 stores the slot to dq_acc
// by TMA and releases the next turn, or, at the last turn, the warp writes
// the sum to dq in bf16. The slot is free again once dq_loaded has been
// signalled for its next pair, so the consumers never wait on a global
// round trip unless a turn is late.
__device__ __forceinline__ void write_dq128(BwdSmem128& sm, const BwdGeom128& geo,
                                            const CUtensorMap* tdq, bf16* __restrict__ dq,
                                            int* __restrict__ turns) {
  const int seq = geo.seq, group = geo.group;
  const int w = (threadIdx.x - (kConsumers + 32)) / 32, lane = threadIdx.x % 32;
  float* const sum = sm.dqs[w];
  int slot = 0;
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_wait(&sm.kv_full, kv_phase);
    const int item = sm.item;
    mbar_arrive(&sm.kv_empty);  // the writers read nothing else of the item's buffers
    if (item >= geo.n_items) return;
    const int j = geo.j(item), h0 = geo.bg(item) * group + geo.h_lo(item), nh = geo.heads(item);
    const int i_hi = geo.i_hi(j), n_pairs = nh * (i_hi - geo.i_lo(j) + 1);
    for (int p = 0; p < n_pairs; ++p, ++slot) {
      if (slot % kBwd128Slots != w) continue;
      const int h = h0 + p % nh, i = i_hi - p / nh;
      const int turn = j - geo.j_lo(i);  // key-tile order
      const bool last = j == geo.j_hi(i);
      const int row = h * seq + i * kBwdRows;
      int* counter = turns + static_cast<size_t>(h) * geo.q_tiles() + i;
      K6_WRITER_MARK(0);
      if (lane == 0) {
        if (turn > 0) {
          const long long t0 = clock64();
          while (ld_acquire(counter) < turn)
            if (clock64() - t0 > kHangCycles) __trap();
          asm volatile("fence.proxy.async.global;" ::: "memory");
          mbar_expect_tx(&sm.dq_loaded[w], kBwdRows * 128 * 4);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            tma_load(sum + c * kBwdRows * 32, tdq, &sm.dq_loaded[w], row, 32 * c);
        } else {
          mbar_arrive(&sm.dq_loaded[w]);
        }
      }
      K6_WRITER_MARK(1);
      mbar_wait(&sm.dq_full[w], (slot / kBwd128Slots) & 1);
      K6_WRITER_MARK(2);
      if (last) {  // the sum in bf16, a row's 32 16-byte chunks a step
#pragma unroll 4
        for (int r = 0; r < kBwdRows; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(sum + dq_slot_offset(r, 4 * lane));
          bf16* out = dq + (static_cast<size_t>(row) + r) * 128 + 4 * lane;
          store2(out, x.x, x.y);
          store2(out + 2, x.z, x.w);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before the next TMA load
        __syncwarp();
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) tma_store(tdq, sum + c * kBwdRows * 32, row, 32 * c);
        bulk_commit_wait();
        asm volatile("fence.proxy.async.global;" ::: "memory");
        add_release(counter, 1);
      }
      __syncwarp();
      K6_WRITER_MARK(3);
    }
  }
}

// The two halves of a split item (BwdGeom128) meet in float32, each
// consumer warpgroup's 64 keys apart: the half that finishes first (an
// atomic count) stores its dK and dV sums (64 keys x 128 columns each) and
// releases a flag; the second waits for that flag, which the first raises
// without waiting on anything, adds the two sums (a + b: the order does
// not matter) and returns true: it writes dK and dV. The float32 sums of
// pair k = j B Hkv + b Hkv + g go where dQ never does: rows 0-127 of
// flattened query heads 2k and 2k + 1 of the dQ workspace (query tiles 0
// and 1 have one dQ contributor, key tile 0, which writes dq itself);
// split_j <= group / 2 keeps 2k + 1 < B H.
__device__ __forceinline__ bool bwd_d128_combine(BwdSmem128& sm, float (&dk_acc)[2][32],
                                                 float (&dv_acc)[2][32],
                                                 float* __restrict__ halves,
                                                 int* __restrict__ flags, int k, int wg,
                                                 int seq) {
  float* const dk_sum = halves + static_cast<size_t>(2 * k) * seq * 128;
  float* const dv_sum = halves + static_cast<size_t>(2 * k + 1) * seq * 128;
  int* const arrivals = flags + 4 * k + 2 * wg;
  int* const ready = arrivals + 1;
  if (threadIdx.x % 128 == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;" : "=r"(old) : "l"(arrivals) : "memory");
    sm.second[wg] = old;
    if (old == 1)
      while (ld_acquire(ready) == 0) {
      }
  }
  named_sync(2 + wg, 128);
  const bool second = sm.second[wg] == 1;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const size_t off = static_cast<size_t>(wg * 64 + acc_row(e)) * 128 + c * kChunk + acc_col(e);
      if (!second) {
        __stcg(reinterpret_cast<float2*>(dk_sum + off), make_float2(dk_acc[c][e], dk_acc[c][e + 1]));
        __stcg(reinterpret_cast<float2*>(dv_sum + off), make_float2(dv_acc[c][e], dv_acc[c][e + 1]));
      } else {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(dk_sum + off));
        const float2 y = __ldcg(reinterpret_cast<const float2*>(dv_sum + off));
        dk_acc[c][e] += x.x;
        dk_acc[c][e + 1] += x.y;
        dv_acc[c][e] += y.x;
        dv_acc[c][e + 1] += y.y;
      }
    }
  if (!second) {
    __threadfence();
    named_sync(2 + wg, 128);
    if (threadIdx.x % 128 == 0) add_release(ready, 1);
  }
  return second;
}

// Head dim 128 (header, "At head dim 128"). An item is (batch b, KV head g,
// key tile j of 128 keys) with all 128 columns, as at D = 64: each consumer
// warpgroup owns 64 of the keys and, per (head, query tile) pair, computes
// S^T and dP^T (64 keys x 64 queries, over all 128 columns) once, then
// dV += P^T dO and dK += dS^T Q over all 128 columns (two 64 x 128
// accumulators: 128 registers a thread) and its 64 columns of the dQ
// partial over the item's 128 keys, dS K[:, 64 wg : + 64], which it adds
// onto the running sum in a staging slot. dQ reads both warpgroups' rows of
// dS^T, so the two meet at a named barrier once a pair. The consumers run
// at 240 registers a thread (setmaxnreg: the launch gives 168), warpgroup 2
// at 24: the producer thread and two dQ writer warps (write_dq128), which
// move the sums by TMA.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma_d128(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int* __restrict__ turns,
                     int* __restrict__ work, float* __restrict__ halves,
                     int* __restrict__ half_flags, BwdGeom128 geo) {
  constexpr int D = 128, NC = 2, Stages = kBwd128Stages, Slots = kBwd128Slots;
  extern __shared__ unsigned char smem_raw[];
  BwdSmem128& sm = *reinterpret_cast<BwdSmem128*>(align1024(smem_raw));
  const int seq = geo.seq, group = geo.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumers + 32 * kBwd128Writers);
    for (int b = 0; b < Slots; ++b) {
      mbar_init(&sm.dq_loaded[b], 1);
      mbar_init(&sm.dq_full[b], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  K6_SPAN_MARK(0);

  if (threadIdx.x >= kConsumers) {  // warpgroup 2: the producer warp and the dQ writers
    regs_dec<24>();
    if (threadIdx.x >= kConsumers + 32) {
      if (threadIdx.x < kConsumers + 32 + 32 * kBwd128Writers)
        write_dq128(sm, geo, &tdq, dq, turns);
      return;
    }
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
      const int item = atomicAdd(work, 1);
      if (item >= geo.n_items) {
        mbar_wait(&sm.kv_empty, kv_phase ^ 1);
        sm.item = item;
        mbar_arrive(&sm.kv_full);  // no loads: the block stops
        return;
      }
      const int j = geo.j(item), bg = geo.bg(item);
      const int h0 = bg * group + geo.h_lo(item), nh = geo.heads(item);
      const int i_hi = geo.i_hi(j), n_pairs = nh * (i_hi - geo.i_lo(j) + 1);
      bool kv_loaded = false;
      for (int p = 0; p < n_pairs; ++p, ++slot) {
        const int s = slot % Stages;
        const int row = (h0 + p % nh) * seq + (i_hi - p / nh) * kBwdRows;
        mbar_wait(&sm.empty[s], ((slot / Stages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kBwdRows * D * 2 + 2 * kBwdRows * 4);
        tma_tile<D, kBwdRows>(sm.q[s], &tq, &sm.full[s], row);
        tma_tile<D, kBwdRows>(sm.dout[s], &tdo, &sm.full[s], row);
        bulk_load(sm.lse[s], lse + row, kBwdRows * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + row, kBwdRows * 4, &sm.full[s]);
        // K and V once the ring holds the item's first pairs
        if (!kv_loaded && (p == Stages - 1 || p == n_pairs - 1)) {
          mbar_wait(&sm.kv_empty, kv_phase ^ 1);
          sm.item = item;
          mbar_expect_tx(&sm.kv_full, 2 * kBwdKeys * D * 2);
          tma_tile<D, kBwdKeys>(sm.k, &tk, &sm.kv_full, bg * seq + j * kBwdKeys);
          tma_tile<D, kBwdKeys>(sm.v, &tv, &sm.kv_full, bg * seq + j * kBwdKeys);
          kv_loaded = true;
        }
      }
    }
  }
  regs_inc<240>();

  const int wg = threadIdx.x / 128;
  // this warpgroup's 64 rows of K and V (chunk 0; chunk c is c 128 64 on)
  const bf16* const k_rows = sm.k + wg * 64 * kChunk;
  const bf16* const v_rows = sm.v + wg * 64 * kChunk;
  int slot = 0;
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_spin(&sm.kv_full, kv_phase);
    const int item = sm.item;
    if (item >= geo.n_items) {
      K6_SPAN_MARK(1);
      return;
    }
    const int j = geo.j(item), bg = geo.bg(item), nh = geo.heads(item);
    const int k0 = j * kBwdKeys + wg * 64;  // this warpgroup's first key
    const int i_hi = geo.i_hi(j), n_pairs = nh * (i_hi - geo.i_lo(j) + 1);
    float dk_acc[2][32], dv_acc[2][32];  // [column chunk][D = 64's accumulator]
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

    for (int p = 0; p < n_pairs; ++p, ++slot) {
      const int s = slot % Stages, b = slot % Slots;
      const int i = i_hi - p / nh, q0 = i * kBwdRows;
      K6_MARK(0);
      mbar_spin(&sm.full[s], (slot / Stages) & 1);
      K6_MARK(1);
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, over 128 columns),
      // two commit groups: P^T is formed while dP^T is still on the tensor cores
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
      {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint64_t d_k = desc_k(k_rows + c * kBwdKeys * kChunk);
          const uint64_t d_q = desc_k(sm.q[s] + c * kBwdRows * kChunk);
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk)
            wgmma_ss_n64<0, 0>(st, desc_add(d_k, 32 * kk), desc_add(d_q, 32 * kk), c + kk > 0);
        }
        wg_commit();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint64_t d_v = desc_k(v_rows + c * kBwdKeys * kChunk);
          const uint64_t d_do = desc_k(sm.dout[s] + c * kBwdRows * kChunk);
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk)
            wgmma_ss_n64<0, 0>(dpt, desc_add(d_v, 32 * kk), desc_add(d_do, 32 * kk), c + kk > 0);
        }
        wg_commit();
      }
      wg_wait1();
      fence_regs(st);
      K6_MARK(2);
      // P^T = exp2(S^T log2(e) - lse log2(e)), as at D = 64; columns are
      // queries: column c's lse, read for its two elements
      const bool masked = k0 + 63 > q0 || q0 + kBwdRows - 1 - k0 >= geo.window;
#pragma unroll
      for (int c = 0; c < 16; c += 2) {  // columns c and c + 1 are adjacent
        const int e0 = (c >> 1) * 4, col = acc_col(e0);
        const float2 l = *reinterpret_cast<const float2*>(&sm.lse[s][col]);
        const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
        for (int e = e0; e < e0 + 4; ++e)
          st[e] = !masked || sees(q0 + col + (e & 1), k0 + acc_row(e), geo.window)
                      ? fast_exp2(fmaf(st[e], kLog2e, -l2[e & 1])) : 0.f;
      }
      // dV += P^T dO over all 128 columns (P^T from registers; dO an
      // MN-major B operand of 128 columns, its two chunks kMnLbo apart),
      // on the tensor cores while dS^T is formed
      uint32_t a_p[4][4];
      acc_to_a<32>(a_p, st);
      fence_regs(dv_acc[0]);
      fence_regs(dv_acc[1]);
      fence_regs(a_p);
      wg_fence();
      {
        const uint64_t m_do = desc_mn(sm.dout[s]);
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk)
          wgmma_rs_n128<1>(dv_acc, a_p[kk], desc_add(m_do, kk * 16 * kRowBytes));
      }
      wg_commit();
      wg_wait1();  // dP^T
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta), into this warpgroup's rows of shared
      // memory, for dK (a K-major A operand) and both warpgroups' dQ
      // (MN-major); two buffers: the other warpgroup may still read the last
      // pair's
      bf16* const dst = sm.dst[slot & 1] + wg * 64 * kChunk;
#pragma unroll
      for (int c = 0; c < 16; c += 2) {
        const int e0 = (c >> 1) * 4;
        const float2 d = *reinterpret_cast<const float2*>(&sm.delta[s][acc_col(e0)]);
#pragma unroll
        for (int e = e0; e < e0 + 4; ++e) dpt[e] = st[e] * (dpt[e] - ((e & 1) ? d.y : d.x));
      }
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dst) +
                                     swizzle_offset(acc_row(e), acc_col(e))) =
            pack_bf16(dpt[e], dpt[e + 1]);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // to the async proxy
      named_sync(2 + wg, 128);  // this warpgroup's rows are in
      K6_MARK(3);
      // dK += dS^T Q over all 128 columns (its own rows of dS^T): with dV,
      // the group's sums, in registers
      fence_regs(dk_acc[0]);
      fence_regs(dk_acc[1]);
      wg_fence();
      {
        const uint64_t m_q = desc_mn(sm.q[s]), a_ds = desc_k(dst);
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk)
          wgmma_ss_n128<0, 1>(dk_acc, desc_add(a_ds, 32 * kk),
                              desc_add(m_q, kk * 16 * kRowBytes), 1);
      }
      wg_commit();
      named_sync(1, kConsumers);  // both warpgroups' rows are in, for dQ
      // dQ: this warpgroup's 64 columns of the partial over the item's 128
      // keys, dS K[:, 64 wg : + 64], onto the slot's running sum, once the
      // writer has loaded it or, at the pair's first turn, freed the slot
      mbar_spin(&sm.dq_loaded[b], (slot / Slots) & 1);
      K6_MARK(4);
      float* const sum = sm.dqs[b];
      float dqp[32];
      const bool zero = j == geo.j_lo(i);  // the slot holds no sum yet
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float2 x = zero ? make_float2(0.f, 0.f)
                              : *reinterpret_cast<const float2*>(
                                    sum + dq_slot_offset(acc_row(e), wg * kChunk + acc_col(e)));
        dqp[e] = x.x;
        dqp[e + 1] = x.y;
      }
      fence_regs(dqp);
      wg_fence();
      {
        const uint64_t m_ds = desc_mn(sm.dst[slot & 1]);
        const uint64_t m_k = desc_mn(sm.k + wg * kBwdKeys * kChunk);
#pragma unroll
        for (int kk = 0; kk < kBwdKeys / 16; ++kk)
          wgmma_ss_n64<1, 1>(dqp, desc_add(m_ds, kk * 16 * kRowBytes),
                             desc_add(m_k, kk * 16 * kRowBytes), 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(dqp);
      fence_regs(dv_acc[0]);
      fence_regs(dv_acc[1]);
      fence_regs(dk_acc[0]);
      fence_regs(dk_acc[1]);
      fence_regs(a_p);
      mbar_arrive(&sm.empty[s]);
      K6_MARK(5);
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<float2*>(sum + dq_slot_offset(acc_row(e), wg * kChunk + acc_col(e))) =
            make_float2(dqp[e], dqp[e + 1]);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // to the writer's TMA store
      K6_MARK(6);
      mbar_arrive(&sm.dq_full[b]);
      K6_MARK(7);
    }
    // dK, dV of this warpgroup's 64 keys, all 128 columns, at the KV head's
    // rows; a half item's through its other half first
    if (geo.half(item) < 0 ||
        bwd_d128_combine(sm, dk_acc, dv_acc, halves, half_flags, j * geo.batch_kv + bg, wg, seq)) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const size_t off =
              (static_cast<size_t>(bg) * seq + k0 + acc_row(e)) * D + c * kChunk + acc_col(e);
          store2(dk + off, dk_acc[c][e], dk_acc[c][e + 1]);
          store2(dv + off, dv_acc[c][e], dv_acc[c][e + 1]);
        }
    }
    mbar_arrive(&sm.kv_empty);
  }
}

// ---- float32: split-bf16 operands --------------------------------------------

// (x, y) as bf16 pairs: hi = bf16(x) to nearest, lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Eight consecutive floats at src as bf16 hi and lo at hi[0..8), lo[0..8).
__device__ __forceinline__ void split8(const float* __restrict__ src, bf16* __restrict__ hi,
                                       bf16* __restrict__ lo) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  uint4 h, l;
  split_pair(a.x, a.y, h.x, l.x);
  split_pair(a.z, a.w, h.y, l.y);
  split_pair(b.x, b.y, h.z, l.z);
  split_pair(b.z, b.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// (x, y) as bf16 pairs: hi = x cut to bf16 (its upper 16 bits), lo =
// bf16(x - hi), with one conversion for the pair.
__device__ __forceinline__ void split_pair_cut(float x, float y, uint32_t& hi, uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __uint_as_float(xb & 0xFFFF0000u),
                                                 y - __uint_as_float(yb & 0xFFFF0000u));
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// A operands (k16 steps) from a 64 x N float32 accumulator, split
// (split_pair_cut).
template <int R>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[R / 8][4], uint32_t (&lo)[R / 8][4],
                                               const float (&d)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair_cut(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
}

// A warpgroup's 64 x 64 block of a row-major float32 matrix at p whose rows
// are Stride floats apart, as the A operands of four k16 steps over the 64
// columns: pair i of step kk holds row r + 8 (i & 1), columns
// 16 kk + 8 (i >> 1) + c, c + 1.
template <int Stride = kChunk>
__device__ __forceinline__ void load_a_f32(float2 (&x)[4][4], const float* __restrict__ p) {
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[kk][i] = __ldg(reinterpret_cast<const float2*>(
          p + (r + 8 * (i & 1)) * Stride + 16 * kk + 8 * (i >> 1) + c));
}
__device__ __forceinline__ void split_a(uint32_t (*hi)[4], uint32_t (*lo)[4],
                                        const float2 (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) split_pair(x[kk][i].x, x[kk][i].y, hi[kk][i], lo[kk][i]);
}
// The forward's pre-pass: k and v ([n] floats each) into the planes
// [k hi, k lo, v hi, v lo] of n bf16 each, 8 elements a thread.
__global__ void __launch_bounds__(256)
flash_split_f32(const float* __restrict__ k, const float* __restrict__ v,
                bf16* __restrict__ planes, long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const long long j = is_v ? i - n : i;
  bf16* hi = planes + (is_v ? 2 * n : 0) + j;
  split8((is_v ? v : k) + j, hi, hi + n);
}

constexpr int kF32Keys = 64;   // keys of a float32 K/V tile

// Stages of K's and V's planes, 32 KB a stage at D = 64 and 64 KB at
// D = 128: 192 KB either way. Q takes none: it is split in each consumer's
// registers.
template <int D>
struct FwdSmemF32 {
  static constexpr int Stages = D == 64 ? 6 : 3;
  bf16 k[Stages][2][kF32Keys * D];  // [stage][hi, lo]
  bf16 v[Stages][2][kF32Keys * D];
  uint64_t k_full[Stages], k_empty[Stages], v_full[Stages], v_empty[Stages];
};
template <int D>
constexpr int kFwdF32SmemBytes = sizeof(FwdSmemF32<D>) + 1024;

// A consumer's wait: with the trap (mbar_wait) within the launch's register
// share, trap-free (mbar_spin) above it.
template <bool Trap>
__device__ __forceinline__ void consumer_wait(uint64_t* bar, uint32_t parity) {
  if constexpr (Trap) mbar_wait(bar, parity);
  else mbar_spin(bar, parity);
}

// flash_fwd_wgmma's schedule on split operands (header, item 5). tkv maps
// the pre-pass's planes: K hi at row r, K lo at kv_rows + r, V hi at
// 2 kv_rows + r, V lo at 3 kv_rows + r. D = 128's consumers hold Q's
// parts over both column chunks (64 registers) at 240 registers a thread;
// their waits do not trap (each is in a cycle with a wait of the producer,
// which does).
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_f32(const float* __restrict__ q, const __grid_constant__ CUtensorMap tkv,
              float* __restrict__ o, float* __restrict__ lse, FwdWork<kF32Keys> wk,
              int kv_rows) {
  using Smem = FwdSmemF32<D>;
  constexpr int NC = D / kChunk, Stages = Smem::Stages;
  constexpr bool kTrap = D == 64;
  constexpr int kPlane = kF32Keys * kChunk;  // elements of a chunk of a K/V plane tile
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int seq = wk.seq;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup: one thread loads K and V
    regs_dec<D == 64 ? 40 : 24>();
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (int n = 0, w = wk.tile(0); w < wk.count(); w = wk.tile(++n)) {
      const int kv_row = (wk.bh(w) / wk.group) * seq, j_lo = wk.j_lo(w);
      for (int t = 0; t < wk.n_tiles(w); ++t, ++slot) {
        const int s = slot % Stages, row = kv_row + (j_lo + t) * kF32Keys;
        const uint32_t phase = ((slot / Stages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[s], phase);
        mbar_expect_tx(&sm.k_full[s], 2 * kF32Keys * D * 2);
        tma_tile<D, kF32Keys>(sm.k[s][0], &tkv, &sm.k_full[s], row);
        tma_tile<D, kF32Keys>(sm.k[s][1], &tkv, &sm.k_full[s], kv_rows + row);
        mbar_wait(&sm.v_empty[s], phase);
        mbar_expect_tx(&sm.v_full[s], 2 * kF32Keys * D * 2);
        tma_tile<D, kF32Keys>(sm.v[s][0], &tkv, &sm.v_full[s], 2 * kv_rows + row);
        tma_tile<D, kF32Keys>(sm.v[s][1], &tkv, &sm.v_full[s], 3 * kv_rows + row);
      }
    }
    return;
  }
  regs_inc<D == 64 ? 232 : 240>();

  const int wg = threadIdx.x / 128;
  int slot = 0;
  // a key tile that none of this warpgroup's rows sees: wait for it and
  // release it
  auto pass = [&]() {
    const int s = slot % Stages;
    const uint32_t parity = (slot / Stages) & 1;
    consumer_wait<kTrap>(&sm.k_full[s], parity);
    mbar_arrive(&sm.k_empty[s]);
    consumer_wait<kTrap>(&sm.v_full[s], parity);
    mbar_arrive(&sm.v_empty[s]);
    ++slot;
  };
  for (int n = 0, w = wk.tile(0); w < wk.count(); w = wk.tile(++n)) {
    const int bh = wk.bh(w), j_lo = wk.j_lo(w), j_end = j_lo + wk.n_tiles(w);
    const int row0 = wk.qt(w) * kFwdRows + wg * 64;  // this warpgroup's first query row
    // this warpgroup's key tiles [own_lo, own_hi]: the last holds its diagonal
    const int own_lo = max(0, row0 - wk.window + 1) / kF32Keys, own_hi = row0 / kF32Keys;
    auto masked = [&](int k0) { return k0 + kF32Keys - 1 > row0 || row0 + 63 - k0 >= wk.window; };
    float acc[NC][32], sc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    // Q's parts over the NC column chunks, k16 step kk of chunk c at 4 c + kk;
    // D = 64 splits the next tile's P into nh and nl while P V runs, D = 128
    // (Q's parts take 64 registers) once it is done
    uint32_t qh[4 * NC][4], ql[4 * NC][4], ph[4][4], pl[4][4], nh[4][4], nl[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float2 x[4][4];
      load_a_f32<D>(x, q + (static_cast<size_t>(bh) * seq + row0) * D + c * kChunk);
      split_a(qh + 4 * c, ql + 4 * c, x);
    }
    for (int j = j_lo; j < own_lo; ++j) pass();

    auto issue_s = [&](int s) {  // sc = Q K^T for the K tile in stage s
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      fence_regs(sc);
      fence_regs(qh);
      fence_regs(ql);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dkh = desc_k(sm.k[s][0] + c * kPlane), dkl = desc_k(sm.k[s][1] + c * kPlane);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          wgmma_rs_n64<0>(sc, qh[4 * c + kk], desc_add(dkh, 32 * kk));
          wgmma_rs_n64<0>(sc, qh[4 * c + kk], desc_add(dkl, 32 * kk));
          wgmma_rs_n64<0>(sc, ql[4 * c + kk], desc_add(dkh, 32 * kk));
        }
      }
      wg_commit();
    };
    auto issue_pv = [&](int s) {  // acc += P V for the V tile in stage s
      consumer_wait<kTrap>(&sm.v_full[s], (slot / Stages) & 1);
      fence_acc(acc);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dvh = desc_mn(sm.v[s][0] + c * kPlane), dvl = desc_mn(sm.v[s][1] + c * kPlane);
#pragma unroll
        for (int kk = 0; kk < kF32Keys / 16; ++kk) {
          wgmma_rs_n64<1>(acc[c], ph[kk], desc_add(dvh, kk * 16 * kRowBytes));
          wgmma_rs_n64<1>(acc[c], ph[kk], desc_add(dvl, kk * 16 * kRowBytes));
          wgmma_rs_n64<1>(acc[c], pl[kk], desc_add(dvh, kk * 16 * kRowBytes));
        }
      }
      wg_commit();
    };
    auto fence_q = [&]() {
      fence_regs(qh);
      fence_regs(ql);
    };

    {
      const int s = slot % Stages;
      consumer_wait<kTrap>(&sm.k_full[s], (slot / Stages) & 1);
      issue_s(s);
      wg_wait0();
      fence_regs(sc);
      fence_q();
      mbar_arrive(&sm.k_empty[s]);
      softmax_scores(sc, m, l, alpha, masked(own_lo * kF32Keys), row0, own_lo * kF32Keys,
                     wk.window);
      acc_to_a_split<32>(ph, pl, sc);
    }
    // as flash_fwd_wgmma: S of tile j + 1 ahead of P V of tile j
    for (int j = own_lo; j < own_hi; ++j, ++slot) {
      const int s = slot % Stages, s1 = (slot + 1) % Stages;
      consumer_wait<kTrap>(&sm.k_full[s1], ((slot + 1) / Stages) & 1);
      issue_s(s1);
      issue_pv(s);
      wg_wait1();
      fence_regs(sc);
      fence_q();
      mbar_arrive(&sm.k_empty[s1]);
      const int k1 = (j + 1) * kF32Keys;
      softmax_scores(sc, m, l, alpha, masked(k1), row0, k1, wk.window);
      if constexpr (NC == 1) acc_to_a_split<32>(nh, nl, sc);
      wg_wait0();
      fence_acc(acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(&sm.v_empty[s]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
      if constexpr (NC == 1) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ph[kk][i] = nh[kk][i];
            pl[kk][i] = nl[kk][i];
          }
      } else {
        acc_to_a_split<32>(ph, pl, sc);
      }
    }
    issue_pv(slot % Stages);
    wg_wait0();
    fence_acc(acc);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(&sm.v_empty[slot % Stages]);
    ++slot;
    for (int j = own_hi + 1; j < j_end; ++j) pass();
    store_o<D>(acc, m, l, o, lse, bh, seq, row0);
  }
}

// Four consecutive floats as bf16 hi and lo at hi[0..4), lo[0..4).
__device__ __forceinline__ void split4(const float4 a, bf16* __restrict__ hi,
                                       bf16* __restrict__ lo) {
  uint2 h, l;
  split_pair(a.x, a.y, h.x, l.x);
  split_pair(a.z, a.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// Rows of delta and of Q's and dO's planes a block of the backward's
// pre-pass: 8 threads a row at D = 64, a warp a row at D = 128 (each lane
// 16 bytes of a row: whole lines a warp; 8 threads a row of 128 columns
// read 64-byte runs and took 0.18 ms at Qwen2.5-7B's training shape, twice
// its bound).
template <int D>
constexpr int kPrepRows = D == 64 ? 32 : 8;

// The backward's pre-pass, one launch. Blocks [0, rows / kPrepRows<D>):
// delta = rowsum(dO * O) in float32 (a fixed order) and the planes of Q and
// dO; the rest: the planes of K and V. planes: [q hi, q lo, dO hi, dO lo]
// of rows x D bf16 each, then [k hi, k lo, v hi, v lo] of kv_rows x D.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_f32(const float* __restrict__ q, const float* __restrict__ o,
                   const float* __restrict__ dout, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ delta,
                   bf16* __restrict__ planes, long long rows, long long kv_rows) {
  const long long n = rows * D, kv_n = kv_rows * D;
  const long long row_blocks = rows / kPrepRows<D>;
  if (blockIdx.x < row_blocks) {
    if constexpr (D == 128) {
      const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
      const long long e = row * D + 4 * (threadIdx.x % 32);
      const float4 x = __ldg(reinterpret_cast<const float4*>(o + e));
      const float4 y = __ldg(reinterpret_cast<const float4*>(dout + e));
      float sum = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
#pragma unroll
      for (int m = 1; m < 32; m *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
      if (threadIdx.x % 32 == 0) delta[row] = sum;
      split4(__ldg(reinterpret_cast<const float4*>(q + e)), planes + e, planes + n + e);
      split4(y, planes + 2 * n + e, planes + 3 * n + e);
    } else {
      const long long row = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x / 8;
      const long long e = row * D + (threadIdx.x % 8) * (D / 8);
      const float4* a = reinterpret_cast<const float4*>(o + e);
      const float4* b = reinterpret_cast<const float4*>(dout + e);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const float4 x = __ldg(a + i), y = __ldg(b + i);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (threadIdx.x % 8 == 0) delta[row] = sum;
#pragma unroll
      for (int u = 0; u < D / 64; ++u) {
        split8(q + e + 8 * u, planes + e + 8 * u, planes + n + e + 8 * u);
        split8(dout + e + 8 * u, planes + 2 * n + e + 8 * u, planes + 3 * n + e + 8 * u);
      }
    }
    return;
  }
  const long long e = ((blockIdx.x - row_blocks) * 256 + threadIdx.x) * 8;
  if (e < kv_n) split8(k + e, planes + 4 * n + e, planes + 4 * n + kv_n + e);
  else if (e < 2 * kv_n)
    split8(v + e - kv_n, planes + 4 * n + kv_n + e, planes + 4 * n + 2 * kv_n + e);
}

constexpr int kF32DqWriters = 2;  // warps 9 and 10 (warp 11 only gives its registers away)
// Keys of a float32 backward item. D = 64 (flash_bwd_f32): 128, 64 a
// warpgroup, as flash_bwd_wgmma. D = 128 (flash_bwd_f32_d128): 64 keys with
// all 128 columns. K's and V's planes of 128 keys at D = 128 would take
// 128 KB and leave room for one ring stage and no dQ staging; at 64 keys
// they take 64 KB, beside two ring stages (128 KB) and a 32 KB exchange
// buffer that carries P^T, dS^T and then the dQ partial: 225 KB.
template <int D>
constexpr int kF32BwdKeys = D == 64 ? 128 : 64;

// D = 64 (flash_bwd_f32)
template <int D>
struct BwdSmemF32 {
  static constexpr int Stages = 2, Slots = 2;
  bf16 k[2][kF32BwdKeys<D> * D];                // hi, lo
  bf16 v[2][kF32BwdKeys<D> * D];
  bf16 dst[2][2 * 64 * kBwdRows];              // [hi, lo] of dS^T: [key][query], 64 keys a warpgroup
  bf16 q[Stages][2][kBwdRows * D];             // [stage][hi, lo]
  bf16 dout[Stages][2][kBwdRows * D];
  float lse[Stages][kBwdRows];
  float delta[Stages][kBwdRows];
  float dqs[Slots][2][kBwdRows * kChunk];      // dQ partials for the writers, a half a warpgroup
  uint64_t full[Stages], empty[Stages], kv_full, kv_empty, dq_full[Slots], dq_empty[Slots];
  int item;
};
template <int D>
constexpr int kBwdF32SmemBytes = sizeof(BwdSmemF32<D>) + 1024;

// flash_bwd_wgmma's items, pairs and dQ order on split operands (header,
// item 6). tq and tdo map the planes of Q and dO (lo at rows + r), tkv
// those of K and V (K lo at kv_rows + r, V hi at 2 kv_rows + r, V lo at
// 3 kv_rows + r).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_f32(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tkv, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv,
              float* __restrict__ dq_acc, int* __restrict__ turns, int* __restrict__ work,
              BwdGeom<kF32BwdKeys<D>> geo, int rows, int kv_rows) {
  static_assert(D == 64, "head dim 128 is flash_bwd_f32_d128");
  using Smem = BwdSmemF32<D>;
  constexpr int NC = D / kChunk, Keys = kF32BwdKeys<D>, Stages = Smem::Stages,
                Slots = Smem::Slots;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int seq = geo.seq, group = geo.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumers + 32 * kF32DqWriters);
    for (int b = 0; b < Slots; ++b) {
      mbar_init(&sm.dq_full[b], kConsumers);
      mbar_init(&sm.dq_empty[b], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  K6_SPAN_MARK(0);

  if (threadIdx.x >= kConsumers) {  // warpgroup 2: the producer warp and the dQ writers
    regs_dec<80>();
    if (threadIdx.x >= kConsumers + 32) {
      if (threadIdx.x < kConsumers + 32 + 32 * kF32DqWriters)
        write_dq<Slots, kF32DqWriters, 2, D>(sm, geo, dq, dq_acc, turns);
      return;
    }
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
      const int item = atomicAdd(work, 1);
      if (item >= geo.n_items) {
        mbar_wait(&sm.kv_empty, kv_phase ^ 1);
        sm.item = item;
        mbar_arrive(&sm.kv_full);  // no loads: the block stops
        return;
      }
      const int j = geo.j(item), bg = geo.bg(item);
      const int h0 = bg * group;
      const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
      bool kv_loaded = false;
      for (int p = 0; p < n_pairs; ++p, ++slot) {
        const int s = slot % Stages;
        const int row = (h0 + p % group) * seq + (i_hi - p / group) * kBwdRows;
        mbar_wait(&sm.empty[s], ((slot / Stages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 4 * kBwdRows * D * 2 + 2 * kBwdRows * 4);
        tma_tile<D, kBwdRows>(sm.q[s][0], &tq, &sm.full[s], row);
        tma_tile<D, kBwdRows>(sm.q[s][1], &tq, &sm.full[s], rows + row);
        tma_tile<D, kBwdRows>(sm.dout[s][0], &tdo, &sm.full[s], row);
        tma_tile<D, kBwdRows>(sm.dout[s][1], &tdo, &sm.full[s], rows + row);
        bulk_load(sm.lse[s], lse + row, kBwdRows * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + row, kBwdRows * 4, &sm.full[s]);
        // K's and V's planes once the ring holds the item's first pairs
        if (!kv_loaded && (p == Stages - 1 || p == n_pairs - 1)) {
          const int r = bg * seq + j * Keys;
          mbar_wait(&sm.kv_empty, kv_phase ^ 1);
          sm.item = item;
          mbar_expect_tx(&sm.kv_full, 4 * Keys * D * 2);
          tma_tile<D, Keys>(sm.k[0], &tkv, &sm.kv_full, r);
          tma_tile<D, Keys>(sm.k[1], &tkv, &sm.kv_full, kv_rows + r);
          tma_tile<D, Keys>(sm.v[0], &tkv, &sm.kv_full, 2 * kv_rows + r);
          tma_tile<D, Keys>(sm.v[1], &tkv, &sm.kv_full, 3 * kv_rows + r);
          kv_loaded = true;
        }
      }
    }
  }
  regs_inc<208>();

  // Each consumer warpgroup works on its own 64 keys (D = 64) or its own 64
  // columns (D = 128) from here on, with no barrier with the other: the two
  // meet only at the ring's empty barriers and the staged dQ halves, so
  // one's elementwise phase can run while the other's products do.
  const int wg = threadIdx.x / 128;
  const int kw = D == 64 ? wg * 64 : 0;  // this warpgroup's first key in the item
  const int cw = D == 64 ? 0 : wg;       // its chunk of dK, dV and dQ's columns
  bf16* const dst_h = sm.dst[0] + wg * 64 * kBwdRows;  // this warpgroup's rows of dS^T
  bf16* const dst_l = sm.dst[1] + wg * 64 * kBwdRows;
  int slot = 0;
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_wait(&sm.kv_full, kv_phase);
    const int item = sm.item;
    if (item >= geo.n_items) {
      K6_SPAN_MARK(1);
      return;
    }
    const int j = geo.j(item), bg = geo.bg(item);
    const int k0 = j * Keys + kw;  // this warpgroup's first key
    const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;

    for (int p = 0; p < n_pairs; ++p, ++slot) {
      const int s = slot % Stages;
      const int q0 = (i_hi - p / group) * kBwdRows;
      K6_MARK(0);
      mbar_wait(&sm.full[s], (slot / Stages) & 1);
      K6_MARK(1);
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), three products each
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int at = c * Keys * kChunk + kw * kChunk;  // this warpgroup's rows of chunk c
        const uint64_t d_kh = desc_k(sm.k[0] + at), d_kl = desc_k(sm.k[1] + at);
        const uint64_t d_vh = desc_k(sm.v[0] + at), d_vl = desc_k(sm.v[1] + at);
        const int aq = c * kBwdRows * kChunk;
        const uint64_t d_qh = desc_k(sm.q[s][0] + aq), d_ql = desc_k(sm.q[s][1] + aq);
        const uint64_t d_doh = desc_k(sm.dout[s][0] + aq), d_dol = desc_k(sm.dout[s][1] + aq);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          wgmma_ss_n64<0, 0>(st, desc_add(d_kh, 32 * kk), desc_add(d_qh, 32 * kk), 1);
          wgmma_ss_n64<0, 0>(st, desc_add(d_kh, 32 * kk), desc_add(d_ql, 32 * kk), 1);
          wgmma_ss_n64<0, 0>(st, desc_add(d_kl, 32 * kk), desc_add(d_qh, 32 * kk), 1);
          wgmma_ss_n64<0, 0>(dpt, desc_add(d_vh, 32 * kk), desc_add(d_doh, 32 * kk), 1);
          wgmma_ss_n64<0, 0>(dpt, desc_add(d_vh, 32 * kk), desc_add(d_dol, 32 * kk), 1);
          wgmma_ss_n64<0, 0>(dpt, desc_add(d_vl, 32 * kk), desc_add(d_doh, 32 * kk), 1);
        }
      }
      wg_commit();
      wg_wait0();
      fence_regs(st);
      fence_regs(dpt);
      K6_MARK(2);
      // P^T = exp2(S^T log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta);
      // columns are queries: column c's lse and delta, for its two elements
      const bool masked = k0 + 63 > q0 || q0 + kBwdRows - 1 - k0 >= geo.window;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int e0 = (c >> 1) * 4 + (c & 1), col = acc_col(e0);
        const float l2 = sm.lse[s][col] * kLog2e, dlt = sm.delta[s][col];
#pragma unroll
        for (int e = e0; e < e0 + 4; e += 2) {
          const float pv = !masked || sees(q0 + col, k0 + acc_row(e), geo.window)
                               ? fast_exp2(fmaf(st[e], kLog2e, -l2)) : 0.f;
          st[e] = pv;
          dpt[e] = pv * (dpt[e] - dlt);
        }
      }
      uint32_t ph[4][4], pl[4][4];
      acc_to_a_split<32>(ph, pl, st);
      K6_MARK(3);
      {
        // dS^T's parts into this warpgroup's rows (the last pair's dK and dQ
        // products, which read them, are done), for dK as a K-major A
        // operand and dQ = dS K as an MN-major one
        uint32_t dh[4][4], dl[4][4];
        acc_to_a_split<32>(dh, dl, dpt);
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const uint32_t off = swizzle_offset(acc_row(e), acc_col(e));
          *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dst_h) + off) =
              dh[e / 8][(e % 8) / 2];
          *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dst_l) + off) =
              dl[e / 8][(e % 8) / 2];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // to the async proxy
      named_sync(2 + wg, 128);  // the warpgroup's four warps have written theirs
      K6_MARK(4);
      // dV += P^T dO (P^T from registers), dK += dS^T Q: the group's sums;
      // this warpgroup's dQ partial dS K over its 64 keys (64 queries x 64)
      float dqp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dqp[e] = 0.f;
      fence_regs(dqp);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
      const int ac = cw * kBwdRows * kChunk;  // the warpgroup's chunk of Q and dO
      const uint64_t m_doh = desc_mn(sm.dout[s][0] + ac), m_dol = desc_mn(sm.dout[s][1] + ac);
      const uint64_t m_qh = desc_mn(sm.q[s][0] + ac), m_ql = desc_mn(sm.q[s][1] + ac);
      const uint64_t a_dsh = desc_k(dst_h), a_dsl = desc_k(dst_l);
      const uint64_t m_dsh = desc_mn(dst_h), m_dsl = desc_mn(dst_l);
      const int ak = cw * Keys * kChunk + kw * kChunk;  // its keys' rows of its chunk of K
      const uint64_t m_kh = desc_mn(sm.k[0] + ak), m_kl = desc_mn(sm.k[1] + ak);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t at = kk * 16 * kRowBytes;
        wgmma_rs_n64<1>(dv_acc, ph[kk], desc_add(m_doh, at));
        wgmma_rs_n64<1>(dv_acc, ph[kk], desc_add(m_dol, at));
        wgmma_rs_n64<1>(dv_acc, pl[kk], desc_add(m_doh, at));
        wgmma_ss_n64<0, 1>(dk_acc, desc_add(a_dsh, 32 * kk), desc_add(m_qh, at), 1);
        wgmma_ss_n64<0, 1>(dk_acc, desc_add(a_dsh, 32 * kk), desc_add(m_ql, at), 1);
        wgmma_ss_n64<0, 1>(dk_acc, desc_add(a_dsl, 32 * kk), desc_add(m_qh, at), 1);
        wgmma_ss_n64<1, 1>(dqp, desc_add(m_dsh, at), desc_add(m_kh, at), 1);
        wgmma_ss_n64<1, 1>(dqp, desc_add(m_dsh, at), desc_add(m_kl, at), 1);
        wgmma_ss_n64<1, 1>(dqp, desc_add(m_dsl, at), desc_add(m_kh, at), 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(dqp);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(&sm.empty[s]);
      K6_MARK(5);
      // the half partial to the writers, through one of the staging slots
      const int b = slot % Slots;
      mbar_wait(&sm.dq_empty[b], ((slot / Slots) & 1) ^ 1);
      K6_MARK(6);
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<float2*>(&sm.dqs[b][wg][dqs_offset(acc_row(e), acc_col(e))]) =
            make_float2(dqp[e], dqp[e + 1]);
      mbar_arrive(&sm.dq_full[b]);
      K6_MARK(7);
    }
    // dK, dV of this warpgroup's keys and columns, at the KV head's rows
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const size_t off =
          (static_cast<size_t>(bg) * seq + k0 + acc_row(e)) * D + cw * kChunk + acc_col(e);
      store2(dk + off, dk_acc[e], dk_acc[e + 1]);
      store2(dv + off, dv_acc[e], dv_acc[e + 1]);
    }
    mbar_arrive(&sm.kv_empty);
  }
}

// flash_bwd_f32_d128's shared memory (header, "At head dim 128"): K's and V's
// planes of the item's 64 keys (64 KB), two ring stages of Q's and dO's
// planes (64 KB a stage) with LSE and delta, and a 32 KB exchange buffer for
// P^T in float32 in the accumulator's thread order (16 KB, [e / 4][thread]
// float4s) and dS^T's planes (8 KB each, swizzled [key][query]). A pair's
// 64 x 128 float32 dQ partial goes, in TMA's layout (dq_slot_offset), where
// Q's planes were in its ring stage, once its products are done; the dQ
// writer frees the stage when its copy has read it. 225 KB.
struct BwdSmemF32D128 {
  static constexpr int Stages = 2;
  bf16 k[2][kF32Keys * 128];  // [hi, lo]
  bf16 v[2][kF32Keys * 128];
  bf16 q[Stages][2][kBwdRows * 128];  // [stage][hi, lo], then the stage's dQ partial
  bf16 dout[Stages][2][kBwdRows * 128];
  float xch[kBwdRows * 128];
  float lse[Stages][kBwdRows];
  float delta[Stages][kBwdRows];
  uint64_t full[Stages], empty[Stages], kv_full, kv_empty, dq_full[Stages];
  int item;
};
constexpr int kBwdF32D128SmemBytes = sizeof(BwdSmemF32D128) + 1024;

// flash_bwd_f32_d128's dQ writer (warp 9; lane 0 acts). For each pair of the
// block, in the block's order: once the pair's (b, h, i) turn has come
// (acquire) and the consumers have staged its dQ partial in its ring stage
// (dq_full), it moves the partial onto dq by TMA, stored at turn 0 and added
// after (a TMA reduction: float32 adds, element by element) in key-tile
// order; it frees the ring stage (empty) as soon as the copy has read it,
// and releases the next turn once the copy's writes are done. dq itself
// holds the running sum: no workspace, no last-turn conversion.
__device__ __forceinline__ void write_dq_f32_d128(BwdSmemF32D128& sm, const BwdGeom<kF32Keys>& geo,
                                                  const CUtensorMap* tdq, int* __restrict__ turns) {
  constexpr int Stages = BwdSmemF32D128::Stages;
  const int seq = geo.seq, group = geo.group, lane = threadIdx.x % 32;
  int slot = 0;
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_wait(&sm.kv_full, kv_phase);
    const int item = sm.item;
    mbar_arrive(&sm.kv_empty);  // the writer reads nothing else of the item's buffers
    if (item >= geo.n_items) return;
    const int j = geo.j(item), h0 = geo.bg(item) * group;
    const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
    for (int p = 0; p < n_pairs; ++p, ++slot) {
      if (lane == 0) {
        const int h = h0 + p % group, i = i_hi - p / group, s = slot % Stages;
        const int turn = j - geo.j_lo(i), row = h * seq + i * kBwdRows;
        int* counter = turns + static_cast<size_t>(h) * geo.q_tiles() + i;
        const float* const part = reinterpret_cast<const float*>(sm.q[s][0]);
        K6_WRITER_MARK(0);
        const long long t0 = clock64();
        while (ld_acquire(counter) < turn)
          if (clock64() - t0 > kHangCycles) __trap();
        asm volatile("fence.proxy.async.global;" ::: "memory");
        K6_WRITER_MARK(1);
        mbar_wait(&sm.dq_full[s], (slot / Stages) & 1);
        K6_WRITER_MARK(2);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (turn == 0) tma_store(tdq, part + c * kBwdRows * 32, row, 32 * c);
          else tma_reduce_add(tdq, part + c * kBwdRows * 32, row, 32 * c);
        }
        asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;" ::: "memory");
        mbar_arrive(&sm.empty[s]);
        K6_WRITER_MARK(3);
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
        asm volatile("fence.proxy.async.global;" ::: "memory");
        add_release(counter, 1);
      }
      __syncwarp();
    }
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Head dim 128, float32 (header, "At head dim 128"). An item is (batch b,
// KV head g, key tile j of 64 keys) with all 128 columns; both consumer
// warpgroups work on each (head, query tile) pair, split by product:
// warpgroup 0 forms S^T = K Q^T, P^T, dV += P^T dO and dK += dS^T Q,
// warpgroup 1 dP^T = V dO^T, dS^T (from warpgroup 0's P^T) and the dQ
// partial dS K over the item's 64 keys, which it stages for the writer. No
// product and no elementwise step runs twice. They meet at three named
// barriers a pair: P^T in (1), dS^T in (2), dV and dK done (3). Each issues
// the next pair's first product behind its last ones. The consumers run at
// 240 registers a thread (their waits do not trap; each is in a cycle with a
// wait of the producer or the writer, which trap), warpgroup 2 at 24: the
// producer thread and the dQ writer warp (write_dq_f32_d128). tq and tdo
// map the planes of Q and dO (lo at rows + r), tkv those of K and V (K lo
// at kv_rows + r, V hi at 2 kv_rows + r, V lo at 3 kv_rows + r), tdq dq in
// [64, 32] float32 boxes.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_f32_d128(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tkv, const __grid_constant__ CUtensorMap tdq,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int* __restrict__ turns,
                   int* __restrict__ work, BwdGeom<kF32Keys> geo, int rows, int kv_rows) {
  using Smem = BwdSmemF32D128;
  constexpr int D = 128, Keys = kF32Keys, Stages = Smem::Stages;
  constexpr int kPlane = 64 * kChunk;  // elements of a 64-row chunk of a plane tile
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024_shared(smem_raw));
  const int seq = geo.seq, group = geo.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 1);  // the writer, once its copy has read the stage's dQ partial
      mbar_init(&sm.dq_full[s], 128);  // warpgroup 1 stages the dQ partial
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumers + 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  K6_SPAN_MARK(0);

  if (threadIdx.x >= kConsumers) {  // warpgroup 2: the producer thread and the dQ writer warp
    regs_dec<24>();
    if (threadIdx.x >= kConsumers + 32) {
      if (threadIdx.x < kConsumers + 64) write_dq_f32_d128(sm, geo, &tdq, turns);
      return;
    }
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
      const int item = atomicAdd(work, 1);
      if (item >= geo.n_items) {
        mbar_wait(&sm.kv_empty, kv_phase ^ 1);
        sm.item = item;
        mbar_arrive(&sm.kv_full);  // no loads: the block stops
        return;
      }
      const int j = geo.j(item), bg = geo.bg(item), h0 = bg * group;
      const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
      bool kv_loaded = false;
      for (int p = 0; p < n_pairs; ++p, ++slot) {
        const int s = slot % Stages;
        const int row = (h0 + p % group) * seq + (i_hi - p / group) * kBwdRows;
        mbar_wait(&sm.empty[s], ((slot / Stages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 4 * kBwdRows * D * 2 + 2 * kBwdRows * 4);
        tma_tile<D, kBwdRows>(sm.q[s][0], &tq, &sm.full[s], row);
        tma_tile<D, kBwdRows>(sm.q[s][1], &tq, &sm.full[s], rows + row);
        tma_tile<D, kBwdRows>(sm.dout[s][0], &tdo, &sm.full[s], row);
        tma_tile<D, kBwdRows>(sm.dout[s][1], &tdo, &sm.full[s], rows + row);
        bulk_load(sm.lse[s], lse + row, kBwdRows * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + row, kBwdRows * 4, &sm.full[s]);
        // K's and V's planes once the ring holds the item's first pairs
        if (!kv_loaded && (p == Stages - 1 || p == n_pairs - 1)) {
          const int r = bg * seq + j * Keys;
          mbar_wait(&sm.kv_empty, kv_phase ^ 1);
          sm.item = item;
          mbar_expect_tx(&sm.kv_full, 4 * Keys * D * 2);
          tma_tile<D, Keys>(sm.k[0], &tkv, &sm.kv_full, r);
          tma_tile<D, Keys>(sm.k[1], &tkv, &sm.kv_full, kv_rows + r);
          tma_tile<D, Keys>(sm.v[0], &tkv, &sm.kv_full, 2 * kv_rows + r);
          tma_tile<D, Keys>(sm.v[1], &tkv, &sm.kv_full, 3 * kv_rows + r);
          kv_loaded = true;
        }
      }
    }
  }
  regs_inc<240>();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  float4* const pt = reinterpret_cast<float4*>(sm.xch);  // P^T: [e / 4][thread]
  bf16* const ds_h = reinterpret_cast<bf16*>(sm.xch + 64 * 64);  // dS^T's planes
  bf16* const ds_l = ds_h + 64 * 64;
  // this warpgroup's first product: S^T = K Q^T (0) or dP^T = V dO^T (1)
  const bf16* const a_h = wg == 0 ? sm.k[0] : sm.v[0];
  const bf16* const a_l = wg == 0 ? sm.k[1] : sm.v[1];
  float acc[32];  // S^T or dP^T (64 keys x 64 queries over all 128 columns)
  int slot = 0;
  auto issue_first = [&](int s) {  // three products a product, the pair in stage s
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    fence_regs(acc);
    wg_fence();
    const bf16* const b_h = wg == 0 ? sm.q[s][0] : sm.dout[s][0];
    const bf16* const b_l = wg == 0 ? sm.q[s][1] : sm.dout[s][1];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint64_t dah = desc_k(a_h + c * kPlane), dal = desc_k(a_l + c * kPlane);
      const uint64_t dbh = desc_k(b_h + c * kPlane), dbl = desc_k(b_l + c * kPlane);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        wgmma_ss_n64<0, 0>(acc, desc_add(dah, 32 * kk), desc_add(dbh, 32 * kk), 1);
        wgmma_ss_n64<0, 0>(acc, desc_add(dah, 32 * kk), desc_add(dbl, 32 * kk), 1);
        wgmma_ss_n64<0, 0>(acc, desc_add(dal, 32 * kk), desc_add(dbh, 32 * kk), 1);
      }
    }
    wg_commit();
  };
  // The next pair's first product goes to the tensor cores behind this
  // pair's last products, and is waited for at the pair's end: no wgmma is in
  // flight across pairs. Returns once this pair's products are done.
  auto issue_next_wait = [&](auto next) {
    if constexpr (decltype(next)::value) {
      const int s1 = (slot + 1) % Stages;
      mbar_spin(&sm.full[s1], ((slot + 1) / Stages) & 1);
      issue_first(s1);
      K6_MARK(4);
      wg_wait1();
    } else {
      K6_MARK(4);
      wg_wait0();
    }
  };
  for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
    mbar_spin(&sm.kv_full, kv_phase);
    const int item = sm.item;
    if (item >= geo.n_items) {
      K6_SPAN_MARK(1);
      return;
    }
    const int j = geo.j(item), bg = geo.bg(item), k0 = j * Keys;
    const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
    mbar_spin(&sm.full[slot % Stages], (slot / Stages) & 1);
    issue_first(slot % Stages);
    wg_wait0();
    fence_regs(acc);
    // dK (warpgroup 1) or dV (warpgroup 0) of the item's 64 keys over all 128
    // columns, at the KV head's rows
    auto store_item = [&](float* __restrict__ out, const float (&a)[2][32]) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const size_t off =
              (static_cast<size_t>(bg) * seq + k0 + acc_row(e)) * D + c * kChunk + acc_col(e);
          store2(out + off, a[c][e], a[c][e + 1]);
        }
    };
    if (wg == 0) {
      // P^T, dV += P^T dO and dK += dS^T Q, over 128 columns
      float dv_acc[2][32], dk_acc[2][32];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) dv_acc[c][e] = dk_acc[c][e] = 0.f;
      auto pair = [&](int p, auto next) {
        const int s = slot % Stages;
        const int q0 = (i_hi - p / group) * kBwdRows;
        K6_MARK(0);
        // P^T = exp2(S^T log2(e) - lse log2(e)); columns are queries: column
        // c's lse, for its two elements. Branch-free within a tile (a pair
        // not seen gets exp2(-inf) = 0): a branch an element kept each
        // exp2's latency apart, ~1400 cycles a pair.
        const bool masked = k0 + 63 > q0 || q0 + kBwdRows - 1 - k0 >= geo.window;
        float l2[16], pv[32];
#pragma unroll
        for (int c = 0; c < 16; ++c) l2[c] = sm.lse[s][acc_col((c >> 1) * 4 + (c & 1))] * kLog2e;
        if (masked) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const float x = fmaf(acc[e], kLog2e, -l2[(e >> 2) * 2 + (e & 1)]);
            pv[e] = fast_exp2(sees(q0 + acc_col(e), k0 + acc_row(e), geo.window) ? x : -INFINITY);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            pv[e] = fast_exp2(fmaf(acc[e], kLog2e, -l2[(e >> 2) * 2 + (e & 1)]));
        }
#pragma unroll
        for (int e = 0; e < 32; e += 4)
          pt[(e / 4) * 128 + t] = make_float4(pv[e], pv[e + 1], pv[e + 2], pv[e + 3]);
        named_arrive(1, kConsumers);  // P^T in, for warpgroup 1
        K6_MARK(1);
        // dV += P^T dO (P^T's parts from registers; dO an MN-major B operand
        // of 128 columns, its two chunks kMnLbo apart), while warpgroup 1
        // forms dS^T
        uint32_t ph[4][4], pl[4][4];
        acc_to_a_split<32>(ph, pl, pv);
        fence_regs(dv_acc[0]);
        fence_regs(dv_acc[1]);
        fence_regs(ph);
        fence_regs(pl);
        wg_fence();
        {
          const uint64_t m_doh = desc_mn(sm.dout[s][0]), m_dol = desc_mn(sm.dout[s][1]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t at = kk * 16 * kRowBytes;
            wgmma_rs_n128<1>(dv_acc, ph[kk], desc_add(m_doh, at));
            wgmma_rs_n128<1>(dv_acc, ph[kk], desc_add(m_dol, at));
            wgmma_rs_n128<1>(dv_acc, pl[kk], desc_add(m_doh, at));
          }
        }
        wg_commit();
        named_sync(2, kConsumers);  // dS^T's planes are in
        K6_MARK(2);
        // dK += dS^T Q (dS^T a K-major A operand from its planes, Q an
        // MN-major B operand of 128 columns)
        fence_regs(dk_acc[0]);
        fence_regs(dk_acc[1]);
        wg_fence();
        {
          const uint64_t a_dsh = desc_k(ds_h), a_dsl = desc_k(ds_l);
          const uint64_t m_qh = desc_mn(sm.q[s][0]), m_ql = desc_mn(sm.q[s][1]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t at = kk * 16 * kRowBytes;
            wgmma_ss_n128<0, 1>(dk_acc, desc_add(a_dsh, 32 * kk), desc_add(m_qh, at), 1);
            wgmma_ss_n128<0, 1>(dk_acc, desc_add(a_dsh, 32 * kk), desc_add(m_ql, at), 1);
            wgmma_ss_n128<0, 1>(dk_acc, desc_add(a_dsl, 32 * kk), desc_add(m_qh, at), 1);
          }
        }
        wg_commit();
        K6_MARK(3);
        issue_next_wait(next);
        fence_regs(dk_acc[0]);
        fence_regs(dk_acc[1]);
        fence_regs(dv_acc[0]);
        fence_regs(dv_acc[1]);
        fence_regs(ph);
        fence_regs(pl);
        K6_MARK(5);
        named_arrive(3, kConsumers);  // dV and dK have read the stage and dS^T
        K6_MARK(6);
        wg_wait0();  // the next pair's S^T
        fence_regs(acc);
        K6_MARK(7);
      };
      for (int p = 0; p + 1 < n_pairs; ++p, ++slot) pair(p, Flag<true>());
      pair(n_pairs - 1, Flag<false>());
      ++slot;
      store_item(dv, dv_acc);
      store_item(dk, dk_acc);
    } else {
      // dS^T and the dQ partial dS K over 128 columns, which it stages
      auto pair = [&](int p, auto next) {
        const int s = slot % Stages;
        K6_MARK(0);
        // dP^T - delta while warpgroup 0 forms P^T
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int e0 = (c >> 1) * 4 + (c & 1);
          const float dlt = sm.delta[s][acc_col(e0)];
          acc[e0] -= dlt;
          acc[e0 + 2] -= dlt;
        }
        named_sync(1, kConsumers);  // P^T is in
        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int e = 0; e < 32; e += 4) {
          const float4 x = pt[(e / 4) * 128 + t];
          acc[e] *= x.x;
          acc[e + 1] *= x.y;
          acc[e + 2] *= x.z;
          acc[e + 3] *= x.w;
        }
        K6_MARK(1);
        // its parts into the exchange buffer: dK's K-major A operand and
        // dQ's MN-major one
        {
          uint32_t dh[4][4], dl[4][4];
          acc_to_a_split<32>(dh, dl, acc);
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const uint32_t off = swizzle_offset(acc_row(e), acc_col(e));
            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(ds_h) + off) =
                dh[e / 8][(e % 8) / 2];
            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(ds_l) + off) =
                dl[e / 8][(e % 8) / 2];
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // to the async proxy
        named_sync(2, kConsumers);  // both warpgroups' dS^T rows are in
        K6_MARK(2);
        // the dQ partial dS K (K an MN-major B operand of 128 columns)
        float dq_acc[2][32];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) dq_acc[c][e] = 0.f;
        fence_regs(dq_acc[0]);
        fence_regs(dq_acc[1]);
        wg_fence();
        {
          const uint64_t m_dsh = desc_mn(ds_h), m_dsl = desc_mn(ds_l);
          const uint64_t m_kh = desc_mn(sm.k[0]), m_kl = desc_mn(sm.k[1]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t at = kk * 16 * kRowBytes;
            wgmma_ss_n128<1, 1>(dq_acc, desc_add(m_dsh, at), desc_add(m_kh, at), 1);
            wgmma_ss_n128<1, 1>(dq_acc, desc_add(m_dsh, at), desc_add(m_kl, at), 1);
            wgmma_ss_n128<1, 1>(dq_acc, desc_add(m_dsl, at), desc_add(m_kh, at), 1);
          }
        }
        wg_commit();
        K6_MARK(3);
        issue_next_wait(next);
        fence_regs(dq_acc[0]);
        fence_regs(dq_acc[1]);
        K6_MARK(5);
        named_sync(3, kConsumers);  // warpgroup 0's dV and dK have read the stage
        K6_MARK(6);
        // the dQ partial where Q's planes were, for the writer
        float* const part = reinterpret_cast<float*>(sm.q[s][0]);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 32; e += 2)
            *reinterpret_cast<float2*>(part + dq_slot_offset(acc_row(e), c * kChunk + acc_col(e))) =
                make_float2(dq_acc[c][e], dq_acc[c][e + 1]);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // to the writer's TMA
        mbar_arrive(&sm.dq_full[s]);
        wg_wait0();  // the next pair's dP^T
        fence_regs(acc);
        K6_MARK(7);
      };
      for (int p = 0; p + 1 < n_pairs; ++p, ++slot) pair(p, Flag<true>());
      pair(n_pairs - 1, Flag<false>());
      ++slot;
    }
    mbar_arrive(&sm.kv_empty);
  }
}

// ---- host ------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// cuTensorMapEncodeTiled lives in libcuda. The library looks it up through
// the CUDA runtime (cudaGetDriverEntryPointByVersion), so it links no
// libcuda itself.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
constexpr int kErrNoEncode = 10001;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10002;    // it refused a tensor map
constexpr int kErrHeadDim = 10003;   // a head dim other than 64 and 128

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [rows, D] bf16 tensor read in boxes of box_rows rows and 64 columns,
// 128-byte swizzle.
template <int D>
int make_map(CUtensorMap* map, const void* base, long long rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D * 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : kErrEncode;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <typename Work>
Work fwd_work(int batch, int heads, int kv_heads, int seq, int window) {
  Work wk;
  wk.bh_count = batch * heads;
  wk.n_qt = seq / kFwdRows;
  wk.seq = seq;
  wk.window = window;
  wk.group = heads / kv_heads;
  return wk;
}

template <typename Geo>
Geo bwd_geo(int batch, int heads, int kv_heads, int seq, int window, int keys) {
  Geo geo;
  geo.batch_kv = batch * kv_heads;
  geo.group = heads / kv_heads;
  geo.seq = seq;
  geo.window = window;
  geo.n_items = geo.batch_kv * (seq / keys);
  return geo;
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
             int heads, int kv_heads, int seq, int window, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const long long kv_rows = static_cast<long long>(batch) * kv_heads * seq;
  if (int err = make_map<D>(&tq, q, rows, kFwdRows)) return err;
  if (int err = make_map<D>(&tk, k, kv_rows, kFwdKeys<D>)) return err;
  if (int err = make_map<D>(&tv, v, kv_rows, kFwdKeys<D>)) return err;
  if (int err = set_smem(flash_fwd_wgmma<D>, kFwdSmemBytes<D>)) return err;
  const auto wk = fwd_work<FwdWork<kFwdKeys<D>>>(batch, heads, kv_heads, seq, window);
  flash_fwd_wgmma<D><<<min(wk.bh_count * wk.n_qt, sm_count()), kWsThreads, kFwdSmemBytes<D>, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, wk);
  return static_cast<int>(cudaGetLastError());
}

// dq_acc as float32 [rows, 128], read and written in boxes of [64, 32] with
// the 128-byte swizzle (flash_bwd_wgmma_d128's dQ slots).
int make_map_dq(CUtensorMap* map, float* base, long long rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {128, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {128 * 4};
  const cuuint32_t box[2] = {32, kBwdRows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : kErrEncode;
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, float* dq_acc,
             int* counters, int batch, int heads, int kv_heads, int seq, int window,
             cudaStream_t s) {
  using Geo = BwdGeom<kBwdKeys>;
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const long long kv_rows = static_cast<long long>(batch) * kv_heads * seq;
  flash_bwd_delta<D><<<static_cast<unsigned>(rows / 32), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  CUtensorMap tq, tdo, tk, tv;
  if (int err = make_map<D>(&tq, q, rows, kBwdRows)) return err;
  if (int err = make_map<D>(&tdo, dout, rows, kBwdRows)) return err;
  if (int err = make_map<D>(&tk, k, kv_rows, kBwdKeys)) return err;
  if (int err = make_map<D>(&tv, v, kv_rows, kBwdKeys)) return err;
  const Geo geo = bwd_geo<Geo>(batch, heads, kv_heads, seq, window, kBwdKeys);
  int* turns = counters;
  int* work = counters + static_cast<size_t>(batch) * heads * (seq / kBwdRows);
  const int blocks = min(geo.n_items, sm_count());
  if constexpr (D == 64) {
    if (int err = set_smem(flash_bwd_wgmma<D>, kBwdSmemBytes)) return err;
    flash_bwd_wgmma<D><<<blocks, kBwdThreads, kBwdSmemBytes, s>>>(
        tq, tdo, tk, tv, lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), dq_acc, turns, work, geo);
  } else {
    CUtensorMap tdq;
    if (int err = make_map_dq(&tdq, dq_acc, rows)) return err;
    if (int err = set_smem(flash_bwd_wgmma_d128, kBwd128SmemBytes)) return err;
    // split the first key tiles' items by heads when the longest item holds
    // more than 1.5 times an SM's share of the pairs
    BwdGeom128 geo128;
    static_cast<Geo&>(geo128) = geo;
    const int tiles = seq / kBwdKeys, group = heads / kv_heads, q_tiles = seq / kBwdRows;
    long long pairs = 0;
    for (int j = 0; j < tiles; ++j)
      pairs += min(q_tiles - 1, (j * kBwdKeys + kBwdKeys - 1 + window - 1) / kBwdRows) -
               j * kBwdKeys / kBwdRows + 1;
    const long long longest = min(q_tiles - 1, (kBwdKeys - 1 + window - 1) / kBwdRows) + 1;
    geo128.split_j = 2 * longest * sm_count() > 3 * pairs * geo.batch_kv ? min(group / 2, tiles) : 0;
    geo128.n_items = geo.batch_kv * (tiles + geo128.split_j);
    // the halves' flags after the work counter (the counters hold two a
    // query tile at head dim 128)
    flash_bwd_wgmma_d128<<<min(geo128.n_items, sm_count()), kBwdThreads, kBwd128SmemBytes, s>>>(
        tq, tdo, tk, tv, tdq, lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), turns, work, dq_acc, work + 1, geo128);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, bf16* planes,
            int batch, int heads, int kv_heads, int seq, int window, cudaStream_t s) {
  const long long kv_rows = static_cast<long long>(batch) * kv_heads * seq, n = kv_rows * D;
  flash_split_f32<<<static_cast<unsigned>((2 * n / 8 + 255) / 256), 256, 0, s>>>(k, v, planes, n);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  CUtensorMap tkv;
  if (int err = make_map<D>(&tkv, planes, 4 * kv_rows, kF32Keys)) return err;
  if (int err = set_smem(flash_fwd_f32<D>, kFwdF32SmemBytes<D>)) return err;
  const auto wk = fwd_work<FwdWork<kF32Keys>>(batch, heads, kv_heads, seq, window);
  flash_fwd_f32<D><<<min(wk.bh_count * wk.n_qt, sm_count()), kWsThreads, kFwdF32SmemBytes<D>,
                     s>>>(q, tkv, o, lse, wk, static_cast<int>(kv_rows));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_f32(const float* q, const float* k, const float* v, const float* o, const float* dout,
            const float* lse, float* delta, float* dq, float* dk, float* dv, float* dq_acc,
            int* counters, bf16* planes, int batch, int heads, int kv_heads, int seq, int window,
            cudaStream_t s) {
  using Geo = BwdGeom<kF32BwdKeys<D>>;
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const long long kv_rows = static_cast<long long>(batch) * kv_heads * seq;
  const long long blocks = rows / kPrepRows<D> + (2 * kv_rows * D / 8 + 255) / 256;
  flash_bwd_prep_f32<D><<<static_cast<unsigned>(blocks), 256, 0, s>>>(q, o, dout, k, v, delta,
                                                                      planes, rows, kv_rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  CUtensorMap tq, tdo, tkv;
  if (int err = make_map<D>(&tq, planes, 2 * rows, kBwdRows)) return err;
  if (int err = make_map<D>(&tdo, planes + 2 * rows * D, 2 * rows, kBwdRows)) return err;
  if (int err = make_map<D>(&tkv, planes + 4 * rows * D, 4 * kv_rows, kF32BwdKeys<D>)) return err;
  const Geo geo = bwd_geo<Geo>(batch, heads, kv_heads, seq, window, kF32BwdKeys<D>);
  int* turns = counters;
  int* work = counters + static_cast<size_t>(batch) * heads * (seq / kBwdRows);
  if constexpr (D == 128) {  // dq holds dQ's running sum: no dq_acc
    CUtensorMap tdq;
    if (int err = make_map_dq(&tdq, dq, rows)) return err;
    if (int err = set_smem(flash_bwd_f32_d128, kBwdF32D128SmemBytes)) return err;
    flash_bwd_f32_d128<<<min(geo.n_items, sm_count()), kBwdThreads, kBwdF32D128SmemBytes, s>>>(
        tq, tdo, tkv, tdq, lse, delta, dk, dv, turns, work, geo, static_cast<int>(rows),
        static_cast<int>(kv_rows));
  } else {
    if (int err = set_smem(flash_bwd_f32<D>, kBwdF32SmemBytes<D>)) return err;
    flash_bwd_f32<D><<<min(geo.n_items, sm_count()), kBwdThreads, kBwdF32SmemBytes<D>, s>>>(
        tq, tdo, tkv, lse, delta, dq, dk, dv, dq_acc, turns, work, geo, static_cast<int>(rows),
        static_cast<int>(kv_rows));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_any(const void* q, const void* k, const void* v, void* o, float* lse, void* planes,
            int batch, int heads, int kv_heads, int seq, int window, int is_f32, cudaStream_t s) {
  if (is_f32)
    return fwd_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), lse,
                      static_cast<bf16*>(planes), batch, heads, kv_heads, seq, window, s);
  return fwd_bf16<D>(q, k, v, o, lse, batch, heads, kv_heads, seq, window, s);
}

template <int D>
int bwd_any(const void* q, const void* k, const void* v, const void* o, const void* dout,
            const float* lse, float* delta, void* dq, void* dk, void* dv, float* dq_acc,
            int* counters, void* planes, int batch, int heads, int kv_heads, int seq, int window,
            int is_f32, cudaStream_t s) {
  if (is_f32)
    return bwd_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(o),
                      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv), dq_acc, counters,
                      static_cast<bf16*>(planes), batch, heads, kv_heads, seq, window, s);
  return bwd_bf16<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, dq_acc, counters, batch, heads,
                     kv_heads, seq, window, s);
}

}  // namespace

// Shapes (row-major, contiguous, 16-byte aligned): q, o, dout, dq
// [batch, heads, seq, head_dim]; k, v, dk, dv [batch, kv_heads, seq,
// head_dim], all bf16 (is_f32 == 0) or all float32; lse, delta
// [batch, heads, seq] float32. head_dim 64 or 128. q is pre-scaled; query
// head h reads KV head h / (heads / kv_heads). seq a multiple of 128,
// 1 <= window, heads a multiple of kv_heads. Each returns 0 or the first
// error: a cudaError_t after a launch, kErrNoEncode or kErrEncode from a
// tensor map, kErrHeadDim.

// float32: planes is bf16 scratch of 4 * batch * kv_heads * seq * head_dim
// elements (the split K and V); bf16 takes none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, void* planes, int batch, int heads, int kv_heads,
                                   int seq, int window, int head_dim, int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (head_dim == 64)
    return fwd_any<64>(q, k, v, o, l, planes, batch, heads, kv_heads, seq, window, is_f32, s);
  if (head_dim == 128)
    return fwd_any<128>(q, k, v, o, l, planes, batch, heads, kv_heads, seq, window, is_f32, s);
  return kErrHeadDim;
}

// Writes delta, dq, dk and dv. dq_acc is float32 scratch shaped like q
// (unread, and may be null, for float32 at head dim 128, whose dq holds the
// running sum), and counters int32 [batch * heads * seq / 64 * head_dim / 64
// + 1], all zero (the caller's torch.zeros). float32: planes is bf16 scratch of
// 4 * (heads + kv_heads) * batch * seq * head_dim elements (the split Q,
// dO, K and V); bf16 takes none.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* dq_acc, void* counters, void* planes,
                                   int batch, int heads, int kv_heads, int seq, int window,
                                   int head_dim, int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  int* c = static_cast<int*>(counters);
  if (head_dim == 64)
    return bwd_any<64>(q, k, v, o, dout, l, d, dq, dk, dv, acc, c, planes, batch, heads,
                       kv_heads, seq, window, is_f32, s);
  if (head_dim == 128)
    return bwd_any<128>(q, k, v, o, dout, l, d, dq, dk, dv, acc, c, planes, batch, heads,
                        kv_heads, seq, window, is_f32, s);
  return kErrHeadDim;
}

#ifdef RSTNET_K6_MARKS
// The phase marks of the last float32 backward (see k6_marks): consumer
// marks [132][2][160][8], writer marks [132][160][4], spans [132][4], int64.
extern "C" int k6_marks_copy(void* consumer, void* writer, void* span) {
  cudaMemcpyFromSymbol(consumer, k6_marks, sizeof(k6_marks));
  cudaMemcpyFromSymbol(writer, k6_writer_marks, sizeof(k6_writer_marks));
  return static_cast<int>(cudaMemcpyFromSymbol(span, k6_span_marks, sizeof(k6_span_marks)));
}
#endif
