// One depformer micro-step: every layer of the depth transformer plus the
// audio head for codebook `cb`, at batch 1, as ONE persistent device kernel.
//
// Replaces: rstnet_tpu/ops/pallas_depformer.py::depformer_step_pallas
// (kernel body _dep_step_kernel), both variants: bf16 weights
// (depformer_step) and int8 weights with an f32 scale per output row
// (depformer_step_int8, `scales` set), each element dequantized to
// bf16(float(q) * scale) before its product, as the Pallas `wload`. Same
// math: per layer, RMSNorm (f32) -> QKV GEMV on the (layer, cb) weight slice
// -> K/V row cb written into the per-frame [L, S, C] cache -> causal softmax
// over cache rows <= cb (the new row taken in f32) -> out-proj GEMV +
// residual -> RMSNorm -> gate/value GEMV with SiLU gating -> down GEMV +
// residual; then the head GEMV for codebook cb plus its bias. GEMV inputs
// are bf16 with f32 accumulation; norms, softmax and the residual stream are
// f32. Every output is summed by one warp in a fixed order: two calls give
// bit-identical results.
//
// What bounds it on the H100: in principle memory bandwidth. At Moshi 7B's
// depformer (C=1024, L=6, H=2816, card=2048) one micro-step reads about
// 158 MB of bf16 weights (25.7 MB per layer + 4 MB of head) at 2 FLOPs per
// weight: ~47 us at 3.35 TB/s; the int8 variant half the bytes, ~24 us. In
// practice the dependent chain sets it: 4L + 1 phases, each needing the whole
// previous phase's output, each hand-off a round trip through L2. The first
// port ran the phases as 1 + 5L + 1 launches of one-warp-per-row grids, each
// grid issuing its first weight load only after the previous one had drained
// (~0.23 ms a micro-step, bf16 and int8 alike).
//
// What the design does about it: one cooperative launch, one block per SM
// (the SM count read at run time; the launch fails, and the caller raises,
// if the grid cannot be co-resident), runs the whole micro-step. Each block
// owns a contiguous, balanced range of units in every phase (rows, or
// gate/value row pairs for the FFN input):
//   1. RMSNorm + QKV GEMV + cache-row write;
//   2. attention (every block computes all heads itself, over <= 32 cache
//      rows) + out-projection + residual;
//   3. RMSNorm (every block computes the RMS itself) + gate/value GEMV + SiLU;
//   4. down GEMV + residual;
// and after the last layer the head.
// Hand-offs: no grid barrier. Separated by 24 grid barriers (a counter, then
// per-block flags, release/acquire at GPU scope), the phases waited 2-3 us
// at each (PERF.md). Instead every activation the next phase reads (the
// residual xs, qkv, the hidden) is one 64-bit word, its f32 value and a tag
// naming (launch, phase), written with a relaxed store at GPU scope; a
// reader loads the words it needs with relaxed 64-bit loads and, in rounds
// of one round trip each, re-loads the words whose tag is not yet the one it
// expects. A 64-bit access is single-copy atomic, so a word's value and tag
// arrive together and need no fence; a word carries its own readiness, so
// nothing waits for a block it does not read from. A reader never finds a
// newer tag than it expects: a word is rewritten only by a phase that needs,
// through its own inputs, every block to have read the old value first (xs
// is rewritten by the down phase, which needs every block's hidden,
// computed after that block read xs; and so on round the layer). Tags cycle
// every 2^24 launches; the launch count lives in the scratch's first word,
// which block 0 bumps at its end (every block has read it before its first
// output). The 4L dependent hand-offs a micro-step (24 at L=6) are these
// waits.
// Weight addresses do not depend on activations, so one producer warp per
// block streams the block's row slices of every phase, layer after layer,
// through a ring of three 64 KB shared-memory stages with TMA bulk copies
// (cp.async.bulk) completing on mbarriers, and never waits on activations:
// the next phases' weights land while the 16 consumer warps wait for
// theirs. int8 row scales (and the head's bias) ride along in each stage.
// The block keeps its own rows of the residual (the out-projection and down
// phases give it the same C-rows) in shared memory. The GEMV input vector is
// staged once per phase in shared memory as bf16, and a stage's rows are
// dotted with it on the tensor cores (mma.sync, the vector as column 0 of
// B): a warp's dependent instruction chain, not the bytes, set the CUDA-core
// dots' time. int8 weights are widened without integer conversions (the
// byte in the mantissa of 2^23), then scaled and rounded to bf16 as the
// reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // plus one producer warp
constexpr int kStages = 3;
constexpr int kStageBytes = 65536;  // weight rows of one chunk
constexpr int kMaxChunkRows = 256;  // rows a chunk: 16 tiles of 16, a warp each at least
constexpr int kAuxFloats = 2 * kMaxChunkRows;  // a chunk's row scales / head bias: two halves
constexpr int kAuxHalf = kAuxFloats / 2;
constexpr int kMaxDim = 8192;  // largest C or H; a gate/value unit at C=8192 fills half a stage
constexpr int kMaxLayers = 63;  // a tag names (launch, phase): 4L + 1 phases < 256
constexpr int kMaxOwnRows = 256;  // residual rows a block owns: C / blocks
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a wait this long is a fault
constexpr int kPerThread = kMaxDim / kConsumers;  // a vector's values a consumer thread holds
constexpr int kSmemBytes = kStages * (kStageBytes + 4 * kAuxFloats)  // the ring
                           + 2 * kMaxDim                              // bf16 input vector
                           + 4 * 32 + 4 * kConsumerWarps * 32         // reductions, softmax
                           + 4 * kMaxOwnRows                          // residual rows
                           + 2 * 8 * kStages                          // mbarriers
                           + 16 * 5;                                  // phase kinds' ranges

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// mbarriers, TMA bulk copies, the consumers' named barrier

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
// Until the phase of this parity has completed (parity 1 on a fresh barrier
// returns at once: the producer's first pass over the ring). A wait of
// seconds can only be a fault: trap, so that the launch fails.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}
// TMA bulk copy of contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// The consumer warps only (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// Tagged activations: (tag << 32) | f32 bits, one 64-bit word each.

constexpr int kScratchHead = 16;  // words before the activations: the launch count, padding

__device__ __forceinline__ void st_tagged(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long w = (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long ld_tagged(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}
// The value of word `w` (loaded from p) once p carries `tag`: re-loads until
// it does; a wait of seconds can only be a fault, and traps.
__device__ __forceinline__ float tagged_value(unsigned long long w, const unsigned long long* p,
                                              unsigned tag) {
  if (static_cast<unsigned>(w >> 32) != tag) {
    const long long t0 = clock64();
    do {
      if (clock64() - t0 > kHangCycles) __trap();
      w = ld_tagged(p);
    } while (static_cast<unsigned>(w >> 32) != tag);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}
// The words at[j] (j < N; null: none) once each carries `tag`, as values.
// Every round re-loads all the stale words at once, so words that turn
// fresh together cost one round trip, not one each.
template <int N>
__device__ __forceinline__ void wait_tagged(float (&v)[N], const unsigned long long* (&at)[N],
                                            unsigned tag) {
  unsigned long long w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = at[j] != nullptr ? ld_tagged(at[j]) : 0ull;
  const long long t0 = clock64();
  for (;;) {
    bool stale = false;
#pragma unroll
    for (int j = 0; j < N; ++j) stale |= at[j] != nullptr && static_cast<unsigned>(w[j] >> 32) != tag;
    if (!stale) break;
    if (clock64() - t0 > kHangCycles) __trap();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (at[j] != nullptr && static_cast<unsigned>(w[j] >> 32) != tag) w[j] = ld_tagged(at[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __uint_as_float(static_cast<unsigned>(w[j]));
}

// v[j] = the value of src[threadIdx.x + j * kConsumers] (j < kPerThread, index
// < n) once tagged `tag`, else 0.
__device__ __forceinline__ void load_tagged(float (&v)[kPerThread], const unsigned long long* src,
                                            int n, unsigned tag) {
  const unsigned long long none = static_cast<unsigned long long>(tag) << 32;  // 0, fresh
  unsigned long long w[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * kConsumers;
    w[j] = i < n ? ld_tagged(src + i) : none;
  }
  const long long t0 = clock64();
  for (;;) {
    bool stale = false;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) stale |= static_cast<unsigned>(w[j] >> 32) != tag;
    if (!stale) break;
    if (clock64() - t0 > kHangCycles) __trap();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (static_cast<unsigned>(w[j] >> 32) != tag) w[j] = ld_tagged(src + threadIdx.x + j * kConsumers);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) v[j] = __uint_as_float(static_cast<unsigned>(w[j]));
}

// Phase marks (tools/k1_phase_marks.py builds a copy of this source with
// RSTNET_DEP_MARKS defined): thread 0 of each block writes the global timer
// (ns) at the start of each phase [0], when its input vector is ready [1],
// when all its warps are done [3], when its own tagged inputs had all
// arrived [4]; the time warp 0 waited for weights [2]; thread 0's clock64
// cycles in its row dots [5], in the syncs after them [6] and in the
// outputs' epilogue [7]; and the SM's clock64 at [0] and [3] in [8] and
// [9]; into [block][phase][10] int64 after the activations.
#ifdef RSTNET_DEP_MARKS
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DEP_MARK(slot, value)                                                            \
  do {                                                                                  \
    if (threadIdx.x == 0) {                                                             \
      reinterpret_cast<long long*>(marks)[(blockIdx.x * n_phases + ph) * 10 + (slot)] =  \
          (value);                                                                      \
    }                                                                                   \
  } while (0)
#else
#define DEP_MARK(slot, value) \
  do {                        \
  } while (0)
#endif
#ifdef RSTNET_DEP_MARKS
#define DEP_CYCLES cycles
#else
#define DEP_CYCLES nullptr
#endif

// ---------------------------------------------------------------------------
// GEMV rows from shared memory, on the tensor cores

// 8 int8 weights (two 32-bit words) dequantized to bf16(float(q) * scale),
// packed as bf16 pairs. float(q) without an integer conversion: the byte
// q + 128 placed in the low mantissa bits of 2^23 gives 2^23 + q + 128.
__device__ __forceinline__ uint4 dequant8(uint32_t lo, uint32_t hi, float scale) {
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = (h ? hi : lo) ^ 0x80808080u;  // q + 128 in each byte
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + 2 * k)) - 8388736.f;
      const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651 + 2 * k)) - 8388736.f;
      const __nv_bfloat162 b = __floats2bfloat162_rn(f0 * scale, f1 * scale);
      o[2 * h + k] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  return out;
}

// 8 weights of a staged row as 4 bf16-pair words (int8: dequantized).
__device__ __forceinline__ uint4 row8(const bf16* w, float /*scale*/) {
  return *reinterpret_cast<const uint4*>(w);
}
__device__ __forceinline__ uint4 row8(const int8_t* w, float scale) {
  const uint2 q = *reinterpret_cast<const uint2*>(w);
  return dequant8(q.x, q.y, scale);
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ysum[row] = staged weight row . vec (bf16 products, f32 sums) for the
// chunk's `rows` rows of k weights (`scale(row)`: a row's int8 scale), on
// the tensor cores: mma.sync m16n8k16 with 16 rows as A and the vector as
// column 0 of B. A dot on the CUDA cores costs a warp ~3 dependent
// instructions a weight (two bf16 unpacks and an FMA); an mma takes 16 x 16
// of them at once. Tiles of 16 rows, and slices of the k-blocks of 32 so
// that every warp gets one (tile, slice); lane (g, t) loads 8 values from
// column 8t of a k-block for rows g and g + 8 (and, in lanes g = 0, of the
// vector), which play k = {2t, 2t+1, 2t+8, 2t+9} of two k16 steps in both
// operands: the same products. The slices' sums are added in slice order.
// Releases the stage (`empty`) once its warp has read it; ends with every
// consumer synced and ysum written.
template <typename W, typename Scale>
__device__ void chunk_rows(const W* w, int rows, int k, Scale scale, const bf16* vec,
                           float* part, float* ysum, uint64_t* empty, long long* cycles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tiles = (rows + 15) / 16;  // <= kConsumerWarps: a stage holds <= 256 rows
  const int slices = min(kConsumerWarps / tiles, k / 32);
#ifdef RSTNET_DEP_MARKS
  const long long c0 = clock64();
#endif
  if (warp < tiles * slices) {
    const int tile = warp / slices, slice = warp % slices;
    const int r0 = min(16 * tile + g, rows - 1), r1 = min(16 * tile + g + 8, rows - 1);
    const float s0 = scale(r0), s1 = scale(r1);
    const W* w0 = w + static_cast<size_t>(r0) * k + 8 * t;
    const W* w1 = w + static_cast<size_t>(r1) * k + 8 * t;
    const bf16* v = vec + 8 * t;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // two chains of mma
    int kb = slice, j = 0;
    for (; kb < k / 32; kb += slices, j ^= 1) {
      const uint4 a0 = row8(w0 + 32 * kb, s0), a1 = row8(w1 + 32 * kb, s1);
      const uint4 b = g == 0 ? *reinterpret_cast<const uint4*>(v + 32 * kb)
                             : make_uint4(0u, 0u, 0u, 0u);
      if (j == 0) {
        mma16816(c[0], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
        mma16816(c[0], a0.z, a1.z, a0.w, a1.w, b.z, b.w);
      } else {
        mma16816(c[1], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
        mma16816(c[1], a0.z, a1.z, a0.w, a1.w, b.z, b.w);
      }
    }
    if (t == 0) {  // column 0: rows g and g + 8
      part[16 * warp + g] = c[0][0] + c[1][0];
      part[16 * warp + g + 8] = c[0][2] + c[1][2];
    }
  }
#ifdef RSTNET_DEP_MARKS
  const long long c1 = clock64();
  cycles[0] += c1 - c0;
#endif
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
  consumers_sync();
  if (threadIdx.x < rows) {
    const int row = threadIdx.x, base = 16 * (row / 16) * slices + row % 16;
    float p[kConsumerWarps];
#pragma unroll
    for (int s2 = 0; s2 < kConsumerWarps; ++s2) p[s2] = s2 < slices ? part[base + 16 * s2] : 0.f;
    float y = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kConsumerWarps; ++s2) y += p[s2];  // slice order
    ysum[row] = y;
  }
  consumers_sync();
#ifdef RSTNET_DEP_MARKS
  cycles[1] += clock64() - c1;
#endif
}

// ---------------------------------------------------------------------------
// The micro-step

template <typename CacheT, typename W>
struct Params {
  const bf16* x;  // [C]
  const float *norm1, *norm2;  // [L, C]
  const W *in_proj, *out_proj, *gin, *gout, *head;  // weight stacks
  const float *s_in, *s_out, *s_gin, *s_gout, *s_head;  // their row scales (int8), else null
  const float* head_b;  // [S, card]
  CacheT *kc, *vc;  // [L, S, C]
  float* logits;  // [card]
  // the launch count at [0], then the tagged activations: xs [C], qkv [3C],
  // hid [H] from word kScratchHead on
  unsigned long long* scratch;
  int L, S, C, H, card, heads, cb;
  float eps;
};

enum Kind { kQkv = 0, kOut = 1, kGin = 2, kGout = 3, kHead = 4 };

// One phase's weights: `units` units of `k` weights a row; a gate/value unit
// is row u and row u + pair (pair > 0), both with their scales.
template <typename W>
struct Phase {
  const W* w;
  const float* s;
  const float* bias;
  int kind, units, k, pair;
};

template <typename CacheT, typename W>
__device__ __forceinline__ Phase<W> phase_of(const Params<CacheT, W>& p, int ph) {
  const int C = p.C, H = p.H;
  const int kind = ph == 4 * p.L ? kHead : ph % 4;
  const size_t ls = static_cast<size_t>(ph / 4) * p.S + p.cb;  // (layer, step) slice
  const bool q = p.s_in != nullptr;
  switch (kind) {
    case kQkv:
      return {p.in_proj + ls * 3 * C * C, q ? p.s_in + ls * 3 * C : nullptr, nullptr, kind,
              3 * C, C, 0};
    case kOut:
      return {p.out_proj + ls * C * C, q ? p.s_out + ls * C : nullptr, nullptr, kind, C, C, 0};
    case kGin:
      return {p.gin + ls * 2 * H * C, q ? p.s_gin + ls * 2 * H : nullptr, nullptr, kind, H, C,
              H};
    case kGout:
      return {p.gout + ls * C * H, q ? p.s_gout + ls * C : nullptr, nullptr, kind, C, H, 0};
    default:
      return {p.head + static_cast<size_t>(p.cb) * p.card * C,
              q ? p.s_head + static_cast<size_t>(p.cb) * p.card : nullptr,
              p.head_b + static_cast<size_t>(p.cb) * p.card, kind, p.card, C, 0};
  }
}

// This block's units of a phase, [lo, hi): balanced within one unit
// (units x blocks < 2^31: units <= 3 x 8192 or the card).
__device__ __forceinline__ int2 block_units(int units) {
  return make_int2(units * static_cast<int>(blockIdx.x) / static_cast<int>(gridDim.x),
                   units * static_cast<int>(blockIdx.x + 1) / static_cast<int>(gridDim.x));
}

// Units a stage holds: whole rows (both rows of a gate/value unit).
template <typename W>
__device__ __forceinline__ int units_per_chunk(const Phase<W>& f) {
  const int unit_bytes = f.k * static_cast<int>(sizeof(W)) * (f.pair ? 2 : 1);
  return min(kStageBytes / unit_bytes, f.pair ? kMaxChunkRows / 2 : kMaxChunkRows);
}


// bf16(x[i] * (alpha[i] * rsqrt(eps + mean(x^2)))) into `vec`, as the Pallas
// _rms, for this thread's values v (kPerThread strided, zeros past n);
// every block computes the RMS itself, summing in a fixed order.
__device__ void rms_to_vec(const float (&v)[kPerThread], const float (&alpha)[kPerThread],
                           float eps, int n, bf16* vec, float* red) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) ss = fmaf(v[j], v[j], ss);
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
  consumers_sync();
  const float tot = warp_sum(threadIdx.x % 32 < kConsumerWarps ? red[threadIdx.x % 32] : 0.f);
  const float inv = rsqrtf(eps + tot / n);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * kConsumers;
    if (i < n) vec[i] = __float2bfloat16(v[j] * (alpha[j] * inv));
  }
}

// attn = softmax over cache rows s <= cb of (q . k_s) / sqrt(dh), times v_s,
// per head, into `vec` as bf16; one warp a head. q and row cb of k and v
// come from the tagged qkv (in f32), rows < cb from the cache.
// The common case of the attention (64-wide heads or narrower, 8 steps or
// fewer, a head a warp at most: Moshi's and the flagship's): a lane takes
// two columns of its warp's head.
__device__ __forceinline__ bool attention_fast(int C, int heads, int cb) {
  return C / heads <= 64 && cb < 8 && heads <= kConsumerWarps;
}

template <typename CacheT>
__device__ void attention_to_vec(const unsigned long long* qkv, unsigned tag, const CacheT* kc,
                                 const CacheT* vc, int C, int heads, int cb, bf16* vec,
                                 float* pbuf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int dh = C / heads;
  const float scale = rsqrtf(static_cast<float>(dh));
  if (attention_fast(C, heads, cb)) {
    // A lane loads its q, k and v values of every row at once.
    for (int hd = warp; hd < heads; hd += kConsumerWarps) {
      const int off = hd * dh;
      float k[8][2], v[8][2];
      const unsigned long long* at[6];  // q, k and v of this step for the lane's two columns
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = off + lane + 32 * i;
        const bool ok = lane + 32 * i < dh;
#pragma unroll
        for (int m = 0; m < 3; ++m) at[3 * i + m] = ok ? qkv + m * C + d : nullptr;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const size_t row = static_cast<size_t>(j) * C + d;
          k[j][i] = ok && j < cb ? load_f(kc + row) : 0.f;
          v[j][i] = ok && j < cb ? load_f(vc + row) : 0.f;
        }
      }
      float fresh[6];
      wait_tagged(fresh, at, tag);
      const float q[2] = {fresh[0], fresh[3]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j == cb) {
            k[j][i] = fresh[3 * i + 1];
            v[j][i] = fresh[3 * i + 2];
          }
        }
      }
      float mine = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sc = warp_sum(fmaf(q[1], k[j][1], q[0] * k[j][0])) * scale;
        if (lane == j) mine = sc;
      }
      const float m = warp_max(lane <= cb ? mine : -INFINITY);
      const float e = lane <= cb ? expf(mine - m) : 0.f;
      const float pr = e / warp_sum(e);
      float o[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        if (j <= cb) {
          o[0] = fmaf(pj, v[j][0], o[0]);
          o[1] = fmaf(pj, v[j][1], o[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (lane + 32 * i < dh) vec[off + lane + 32 * i] = __float2bfloat16(o[i]);
      }
    }
    return;
  }
  float* p = pbuf + warp * 32;
  for (int hd = warp; hd < heads; hd += kConsumerWarps) {
    const int off = hd * dh;
    float mine = -INFINITY;
    for (int s0 = 0; s0 <= cb; s0 += 8) {
      float part[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j] = 0.f;
      for (int d0 = 0; d0 < dh; d0 += 32) {
        const int d = d0 + lane;
        if (d < dh) {
          const float qd = tagged_value(ld_tagged(qkv + off + d), qkv + off + d, tag);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = s0 + j;
            if (s < cb) {
              part[j] = fmaf(qd, load_f(kc + static_cast<size_t>(s) * C + off + d), part[j]);
            } else if (s == cb) {
              const unsigned long long* at = qkv + C + off + d;
              part[j] = fmaf(qd, tagged_value(ld_tagged(at), at, tag), part[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sc = warp_sum(part[j]) * scale;
        if (lane == s0 + j) mine = sc;
      }
    }
    const float m = warp_max(lane <= cb ? mine : -INFINITY);
    const float e = lane <= cb ? expf(mine - m) : 0.f;
    p[lane] = e / warp_sum(e);
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float o = 0.f;
      for (int s = 0; s <= cb; ++s) {
        const unsigned long long* at = qkv + 2 * C + off + d;
        const float v = s == cb ? tagged_value(ld_tagged(at), at, tag)
                                : load_f(vc + static_cast<size_t>(s) * C + off + d);
        o = fmaf(p[s], v, o);
      }
      vec[off + d] = __float2bfloat16(o);
    }
    __syncwarp();
  }
}

template <typename CacheT, typename W>
__global__ void __launch_bounds__(kThreads, 1) dep_step_kernel(const Params<CacheT, W> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;
  float* aux_base = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  bf16* vec = reinterpret_cast<bf16*>(aux_base + kStages * kAuxFloats);
  float* red = reinterpret_cast<float*>(vec + kMaxDim);
  float* pbuf = red + 32;
  float* part = pbuf;                         // a chunk's partial row sums ...
  float* ysum = pbuf + 16 * kConsumerWarps;   // ... and its row sums
  float* resid = pbuf + kConsumerWarps * 32;  // this block's rows of the residual
  uint64_t* full = reinterpret_cast<uint64_t*>(resid + kMaxOwnRows);
  uint64_t* empty = full + kStages;
  int4* ranges = reinterpret_cast<int4*>(empty + kStages);  // a phase kind's (lo, hi, per)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);  // every producer lane arrives (its aux stores released)
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < 5) {  // the integer divisions, once
    const Phase<W> f = phase_of(p, threadIdx.x == kHead ? 4 * p.L : threadIdx.x);
    const int2 r = block_units(f.units);
    ranges[threadIdx.x] = make_int4(r.x, r.y, units_per_chunk(f), 0);
  }
  __syncthreads();
  const int n_phases = 4 * p.L + 1;

  if (warp == kConsumerWarps) {
    // Producer: every chunk of every phase, in the consumers' order.
    int chunk = 0;
    for (int ph = 0; ph < n_phases; ++ph) {
      const Phase<W> f = phase_of(p, ph);
      const int4 r = ranges[f.kind];
      const int per = r.z;
      const uint32_t row_bytes = f.k * sizeof(W);
      for (int u = r.x; u < r.y; u += per, ++chunk) {
        const int n = min(per, r.y - u);
        const int st = chunk % kStages;
        mbar_wait(&empty[st], ((chunk / kStages) & 1) ^ 1);
        float* aux = aux_base + st * kAuxFloats;
        for (int i = lane; i < n; i += 32) {
          if (f.s != nullptr) {
            aux[i] = f.s[u + i];
            if (f.pair) aux[kAuxHalf + i] = f.s[f.pair + u + i];
          }
          if (f.bias != nullptr) aux[kAuxHalf + i] = f.bias[u + i];
        }
        unsigned char* dst = stages + st * kStageBytes;
        const uint32_t bytes = n * row_bytes;
        if (lane == 0) {
          mbar_expect_tx(&full[st], f.pair ? 2 * bytes : bytes);
          bulk_load(dst, f.w + static_cast<size_t>(u) * f.k, bytes, &full[st]);
          if (f.pair) {
            bulk_load(dst + bytes, f.w + static_cast<size_t>(f.pair + u) * f.k, bytes, &full[st]);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // Consumers.
  const int C = p.C, H = p.H, cb = p.cb;
  unsigned long long* xs = p.scratch + kScratchHead;  // tagged [C]
  unsigned long long* qkv = xs + C;                    // tagged [3C]
  unsigned long long* hid = qkv + 3 * C;               // tagged [H]
#ifdef RSTNET_DEP_MARKS
  unsigned long long* marks = hid + H;
#endif
  const unsigned epoch = static_cast<unsigned>(p.scratch[0]);  // this launch's number
  for (int i = 32 * (blockIdx.x + gridDim.x * threadIdx.x); i < p.L * C;
       i += 32 * gridDim.x * kConsumers) {  // the norms into L2, a line a thread
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p.norm1 + i));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p.norm2 + i));
  }
  // The out-projection and down phases give this block the same rows of the
  // residual (both have C units): it keeps them here, from x on.
  const int4 own = ranges[kOut];
  for (int i = threadIdx.x; i < own.y - own.x; i += kConsumers) {
    resid[i] = __bfloat162float(p.x[own.x + i]);
  }
  int chunk = 0;
  for (int ph = 0; ph < n_phases; ++ph) {
#ifdef RSTNET_DEP_MARKS
    long long waited = 0, cycles[3] = {0, 0, 0};
    DEP_MARK(0, global_ns());
    DEP_MARK(8, clock64());
#endif
    const Phase<W> f = phase_of(p, ph);
    const int l = ph / 4;
    const unsigned tag_in = epoch * 256u + ph;  // what the previous phase wrote
    const unsigned tag_out = tag_in + 1;
    CacheT* kc_l = p.kc + static_cast<size_t>(l) * p.S * C;
    CacheT* vc_l = p.vc + static_cast<size_t>(l) * p.S * C;
    // The phase's input vector, from the previous phase's outputs.
    if (f.kind == kQkv || f.kind == kGin) {
      float v[kPerThread], alpha[kPerThread];  // the norm's weights load with the inputs
      const float* norm = (f.kind == kQkv ? p.norm1 : p.norm2) + static_cast<size_t>(l) * C;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = threadIdx.x + j * kConsumers;
        alpha[j] = i < C ? __ldg(norm + i) : 0.f;
      }
      if (ph == 0) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int i = threadIdx.x + j * kConsumers;
          v[j] = i < C ? __bfloat162float(p.x[i]) : 0.f;
        }
      } else {
        load_tagged(v, xs, C, tag_in);
      }
      DEP_MARK(4, global_ns());
      rms_to_vec(v, alpha, p.eps, C, vec, red);
    } else if (f.kind == kOut) {
      attention_to_vec(qkv, tag_in, kc_l, vc_l, C, p.heads, cb, vec, pbuf);
      DEP_MARK(4, global_ns());
    } else {
      const int n = f.kind == kGout ? H : C;
      float v[kPerThread];
      load_tagged(v, f.kind == kGout ? hid : xs, n, tag_in);
      DEP_MARK(4, global_ns());
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = threadIdx.x + j * kConsumers;
        if (i < n) vec[i] = __float2bfloat16(v[j]);
      }
    }
    consumers_sync();
    DEP_MARK(1, global_ns());
    if (f.kind == kQkv && cb > 0) {
      // warm L2 with the next phase's cache rows (written by earlier launches)
      constexpr int kLine = 128 / sizeof(CacheT);  // elements a 128-byte line
      for (int i = threadIdx.x * kLine; i < cb * C; i += kConsumers * kLine) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(kc_l + i));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(vc_l + i));
      }
    }

    const int4 r = ranges[f.kind];
    const int per = r.z;
    const int row = f.k;  // elements a row
    for (int u = r.x; u < r.y; u += per, ++chunk) {
      const int n = min(per, r.y - u);
      const int st = chunk % kStages;
#ifdef RSTNET_DEP_MARKS
      const long long t_wait = global_ns();
      mbar_wait(&full[st], (chunk / kStages) & 1);
      waited += global_ns() - t_wait;
#else
      mbar_wait(&full[st], (chunk / kStages) & 1);
#endif
      const W* w = reinterpret_cast<const W*>(stages + st * kStageBytes);
      const float* aux = aux_base + st * kAuxFloats;
      const bool q8 = f.s != nullptr;
      const int rows = f.pair ? 2 * n : n;  // gin: gate rows, then value rows
      chunk_rows(w, rows, row,
                 [&](int r) {
                   return !q8 ? 1.f : r < n ? aux[r] : aux[kAuxHalf + r - n];
                 },
                 vec, part, ysum, &empty[st], DEP_CYCLES);
#ifdef RSTNET_DEP_MARKS
      const long long c_epi = clock64();
#endif
      for (int i = threadIdx.x; i < n; i += kConsumers) {
        const int unit = u + i;
        const float y = ysum[i];
        if (f.kind == kGin) {
          const float val = ysum[n + i];
          st_tagged(hid + unit, y / (1.f + expf(-y)) * val, tag_out);
        } else if (f.kind == kQkv) {
          st_tagged(qkv + unit, y, tag_out);
          if (unit >= 2 * C) store_f(vc_l + static_cast<size_t>(cb) * C + (unit - 2 * C), y);
          else if (unit >= C) store_f(kc_l + static_cast<size_t>(cb) * C + (unit - C), y);
        } else if (f.kind == kHead) {
          p.logits[unit] = y + aux[kAuxHalf + i];
        } else {  // out-projection or down: the residual, this block's own row
          const float x_new = resid[unit - own.x] + y;
          resid[unit - own.x] = x_new;
          st_tagged(xs + unit, x_new, tag_out);
        }
      }
#ifdef RSTNET_DEP_MARKS
      cycles[2] += clock64() - c_epi;
#endif
    }
#ifdef RSTNET_DEP_MARKS
    consumers_sync();
    DEP_MARK(2, waited);
    DEP_MARK(3, global_ns());
    DEP_MARK(9, clock64());
    DEP_MARK(5, cycles[0]);
    DEP_MARK(6, cycles[1]);
    DEP_MARK(7, cycles[2]);
#endif
    consumers_sync();  // vec is rewritten by the next phase
  }
  // Every block read the launch number before its first output, and block 0
  // got here only through every block's outputs: the next launch's number.
  if (blockIdx.x == 0 && threadIdx.x == 0) p.scratch[0] = epoch + 1;
}

template <typename CacheT, typename W>
int launch(const Params<CacheT, W>& p, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto* kernel = dep_step_kernel<CacheT, W>;
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((p.C + sms - 1) / sms > kMaxOwnRows || p.L > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  void* args[] = {const_cast<Params<CacheT, W>*>(&p)};
  // Fails (cudaErrorCooperativeLaunchTooLarge) if the grid cannot be
  // co-resident; the caller raises.
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(sms),
                                  dim3(kThreads), args, kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

struct Raw {
  const void *x, *norm1, *norm2, *in_proj, *out_proj, *gin, *gout, *head_w, *head_b;
  const void *s_in, *s_out, *s_gin, *s_gout, *s_head;
  void *kc, *vc, *logits, *scratch;
};

template <typename CacheT, typename W>
int run(const Raw& a, int L, int S, int C, int H, int card, int heads, int cb, float eps,
        cudaStream_t s) {
  const Params<CacheT, W> p{
      static_cast<const bf16*>(a.x),       static_cast<const float*>(a.norm1),
      static_cast<const float*>(a.norm2),  static_cast<const W*>(a.in_proj),
      static_cast<const W*>(a.out_proj),   static_cast<const W*>(a.gin),
      static_cast<const W*>(a.gout),       static_cast<const W*>(a.head_w),
      static_cast<const float*>(a.s_in),   static_cast<const float*>(a.s_out),
      static_cast<const float*>(a.s_gin),  static_cast<const float*>(a.s_gout),
      static_cast<const float*>(a.s_head), static_cast<const float*>(a.head_b),
      static_cast<CacheT*>(a.kc),          static_cast<CacheT*>(a.vc),
      static_cast<float*>(a.logits),       static_cast<unsigned long long*>(a.scratch),
      L, S, C, H, card, heads, cb, eps};
  return launch(p, s);
}

template <typename W>
int dispatch(const Raw& a, int L, int S, int C, int H, int card, int heads, int cb,
             int cache_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_bf16) return run<bf16, W>(a, L, S, C, H, card, heads, cb, eps, s);
  return run<float, W>(a, L, S, C, H, card, heads, cb, eps, s);
}

}  // namespace

// Shapes (all row-major, contiguous, 16-byte aligned): x [1, C] bf16;
// norm1/norm2 [L, C] f32; in_proj [L, S*3C, C], out_proj [L, S*C, C],
// gin [L, S, 2H, C], gout [L, S, C, H], head_w [S, card, C] bf16; head_b
// [S, card] f32; kc/vc [L, S, C] f32 (cache_bf16 == 0) or bf16, updated at
// row cb in place; logits [card] f32 out; scratch: 16 + 4C + H u64 words,
// zeroed once when allocated and then left to the kernel (the launch count
// and the tagged activations; one buffer per stream: two launches in
// flight must not share it). C, H <= 8192 and multiples of 128 (so that
// every row is 16-byte aligned and a gate/value unit fits a stage); S <=
// 32; L <= 63. One cooperative launch. Returns its cudaError_t (non-zero,
// for one, when the grid of one block per SM cannot be co-resident).
extern "C" int depformer_step(const void* x, const void* norm1, const void* in_proj,
                              const void* out_proj, const void* norm2, const void* gin,
                              const void* gout, const void* head_w, const void* head_b,
                              void* kc, void* vc, void* logits, void* scratch, int L, int S,
                              int C, int H, int card, int heads, int cb, int cache_bf16,
                              float eps, void* stream) {
  const Raw a{x,       norm1,   norm2,   in_proj, out_proj, gin, gout, head_w, head_b,
              nullptr, nullptr, nullptr, nullptr, nullptr,  kc,  vc,   logits, scratch};
  return dispatch<bf16>(a, L, S, C, H, card, heads, cb, cache_bf16, eps, stream);
}

// The int8 variant: the five weight stacks as above but int8, with f32 row
// scales s_in [L, S*3C], s_out [L, S*C], s_gin [L, S, 2H], s_gout [L, S, C],
// s_head [S, card].
extern "C" int depformer_step_int8(const void* x, const void* norm1, const void* in_proj,
                                   const void* out_proj, const void* norm2, const void* gin,
                                   const void* gout, const void* head_w, const void* head_b,
                                   void* kc, void* vc, void* logits, void* scratch,
                                   const void* s_in, const void* s_out, const void* s_gin,
                                   const void* s_gout, const void* s_head, int L, int S, int C,
                                   int H, int card, int heads, int cb, int cache_bf16, float eps,
                                   void* stream) {
  const Raw a{x,    norm1, norm2, in_proj, out_proj, gin, gout, head_w, head_b,
              s_in, s_out, s_gin, s_gout,  s_head,   kc,  vc,   logits, scratch};
  return dispatch<int8_t>(a, L, S, C, H, card, heads, cb, cache_bf16, eps, stream);
}
