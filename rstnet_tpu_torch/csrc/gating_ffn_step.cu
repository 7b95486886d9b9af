// The per-step gated FFN of a depformer micro-step at batch B:
// out[b] = (silu(Wg . x[b]) * (Wv . x[b])) . Wo^T on one step's weight slice.
//
// Replaces: rstnet_tpu/ops/pallas_ffn.py::gating_ffn_pallas_step (kernel
// body _ffn_step_kernel). Same math: x and the weights widened to f32, f32
// accumulation, the hidden silu(gate) * val kept in f32 (not rounded to
// bf16), the output cast to x's dtype. The wrapper clamps the step and
// passes the step's slices: lin_in[s] = [gate rows; value rows] [2H, C] and
// lin_out[s] [C, H].
//
// What bounds it on the H100: memory bandwidth. At Moshi 7B's depformer
// (C=1024, H=2816, bf16) one call reads 17,301,504 bytes of weights and does
// 2*B FLOPs per weight, far below the ~295 FLOP/byte where the tensor cores
// would bind for every B the batcher uses: ~5.2 us at 3.35 TB/s. The first
// port dotted each weight row with each x row on the CUDA cores, reloading
// x for every 16 bytes of weights, so its time grew ~4.3 us per row of B.
//
// What the design does about it (bf16 weights, C and H multiples of 128,
// the routed envelope): each weight byte is read once from device memory and
// applied to all B rows by the tensor cores, with mma.sync m16n8k16 (bf16 in,
// f32 sums). The weight tile is the M side (rows of lin_in[s] / lin_out[s]
// are K-contiguous), x or the hidden the N side, N = B rounded up to 8, in
// chunks of up to 64 columns (32 for an f32 x), so any B works. Weight and
// N-operand tiles of 128 columns stream through a ring of cp.async stages
// (as many as fit 100 KB: two blocks an SM), rows padded so that a lane
// group's 16-byte reads hit distinct banks; 4 warps take one 32-wide k-block
// of each stage and add their sums in warp order at the end. Within one mma
// the K order is free, so each lane reads 16 contiguous bytes of a row (8
// values) and the matching 8 values of the N operand, and the two halves
// feed two k16 steps. mma.sync rather than wgmma: the work is memory-bound
// at every B (2B FLOPs a weight byte), and mma.sync takes N = 8 from
// registers, where wgmma wants a warpgroup of 64 weight rows and its N
// operand in a swizzled shared-memory layout. Precision: a bf16 x times a
// bf16 weight is exact in the f32 sum; an f32 x, and the f32 hidden, enter as
// hi + lo bf16 parts (hi = bf16(v), lo = bf16(v - hi)), two products into
// one f32 sum, leaving ~2^-17 of each value out: the Pallas kernel's f32
// arithmetic up to summation order and that remainder.
// 1. gate_value_mma: a block takes 16 hidden units, its gate tile and its
//    value tile, whose sums give silu(gate) * val in the same registers; H/16
//    blocks; hid [B, H] f32.
// 2. down_mma: the C = 1024 output rows are only 32 tiles of 32, so H is
//    split too, in whole 128-column chunks: block (r, s) takes rows
//    [32 r, 32 r + 32) over split s, two blocks an SM in all, and writes its
//    partial [B, 32] sums; sum_splits then adds the splits' partials in
//    split order (one split: no partials, no third launch). No
//    floating-point atomics: two calls give bit-identical results.
// 3. Groups of rows: the wrapper may share B among `groups` groups of blocks,
//    each a copy of both passes' grids over B / groups rows, so that a small
//    grid (the flagship codecformer's H = 768: 48 gate/value blocks) keeps
//    every SM streaming with narrower N tiles; each output is the same sum
//    whatever the groups.
// The three launches use programmatic dependent launch: each kernel starts
// while the one ahead of it runs, streams its first weight stages, and
// waits (griddepcontrol.wait) only before it reads what that kernel wrote.
// Float32 weights (not on the main path: the batched tick's LM state is
// bf16) and dims off the 128 grid keep the first port's CUDA-core kernels:
// a warp per hidden row, then a warp per output row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// CUDA-core kernels (f32 weights)

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;  // rows of x (pass 1) or hid (pass 2) per register pass

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// Elements [8i, 8i + 8) of a row, widened to f32 (16-byte loads through the
// read-only path; the row is 16-byte aligned).
__device__ __forceinline__ void load8(const bf16* __restrict__ row, int i, float* f) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(row) + i);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(a2[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ row, int i, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 2 * i + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float dot8(const float* a, const float* b, float acc) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc = fmaf(a[j], b[j], acc);
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// hid[b, h] = silu(Wg[h] . x[b]) * (Wv[h] . x[b]); w_in [2H, C].
template <typename X, typename W>
__global__ void __launch_bounds__(kThreads)
gate_value_kernel(const X* __restrict__ x, const W* __restrict__ w_in, float* __restrict__ hid,
                  int B, int C, int H) {
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x * kWarps + threadIdx.x / 32;
  if (h >= H) return;  // uniform across the warp
  const W* wg = w_in + static_cast<size_t>(h) * C;
  const W* wv = w_in + static_cast<size_t>(H + h) * C;
  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int nb = min(kChunk, B - b0);
    const X* xc = x + static_cast<size_t>(b0) * C;
    float g[kChunk], v[kChunk];
#pragma unroll
    for (int b = 0; b < kChunk; ++b) g[b] = v[b] = 0.f;
    for (int i = lane; i < C / 8; i += 32) {
      float fg[8], fv[8];
      load8(wg, i, fg);
      load8(wv, i, fv);
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        if (b < nb) {
          float xv[8];
          load8(xc + static_cast<size_t>(b) * C, i, xv);
          g[b] = dot8(fg, xv, g[b]);
          v[b] = dot8(fv, xv, v[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kChunk; ++b) {
      if (b < nb) {  // uniform across the warp
        const float gs = warp_sum(g[b]);
        const float vs = warp_sum(v[b]);
        if (lane == 0) hid[static_cast<size_t>(b0 + b) * H + h] = gs / (1.f + expf(-gs)) * vs;
      }
    }
  }
}

// out[b, c] = Wo[c] . hid[b]; w_out [C, H].
template <typename X, typename W>
__global__ void __launch_bounds__(kThreads)
down_kernel(const float* __restrict__ hid, const W* __restrict__ w_out, X* __restrict__ out,
            int B, int C, int H) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= C) return;  // uniform across the warp
  const W* wo = w_out + static_cast<size_t>(c) * H;
  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int nb = min(kChunk, B - b0);
    const float* hc = hid + static_cast<size_t>(b0) * H;
    float acc[kChunk];
#pragma unroll
    for (int b = 0; b < kChunk; ++b) acc[b] = 0.f;
    for (int i = lane; i < H / 8; i += 32) {
      float fw[8];
      load8(wo, i, fw);
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        if (b < nb) {
          float hv[8];
          load8(hc + static_cast<size_t>(b) * H, i, hv);
          acc[b] = dot8(fw, hv, acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kChunk; ++b) {
      if (b < nb) {
        const float sum = warp_sum(acc[b]);
        if (lane == 0) store(out + static_cast<size_t>(b0 + b) * C + c, sum);
      }
    }
  }
}

template <typename X, typename W>
int run(const void* x, const void* w_in, const void* w_out, float* hid, void* out, int B, int C,
        int H, cudaStream_t s) {
  gate_value_kernel<X, W><<<(H + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const X*>(x), static_cast<const W*>(w_in), hid, B, C, H);
  down_kernel<X, W><<<(C + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      hid, static_cast<const W*>(w_out), static_cast<X*>(out), B, C, H);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16 weights)

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRows = 32;        // weight rows a block: two 16-row tiles
constexpr int kKc = 128;         // K columns a stage: one 32-wide k-block a warp
constexpr int kRingBytes = 100 * 1024;  // the cp.async ring: two blocks an SM
constexpr int kPad = 64;         // row padding: lanes of one LDS phase hit distinct banks
constexpr int kAStride = kKc * 2 + kPad;  // bytes a staged weight row

template <typename X>
__host__ __device__ constexpr int b_stride() { return kKc * static_cast<int>(sizeof(X)) + kPad; }
template <int NT, typename X>
__host__ __device__ constexpr int stage_bytes() { return kRows * kAStride + 8 * NT * b_stride<X>(); }
// Stages in the ring: as many as fit kRingBytes, 2 to 8.
template <int NT, typename X>
__host__ __device__ constexpr int k_stages() {
  return kRingBytes / stage_bytes<NT, X>() < 2   ? 2
         : kRingBytes / stage_bytes<NT, X>() > 8 ? 8
                                                   : kRingBytes / stage_bytes<NT, X>();
}
// The ring, and after it is drained the warps' sums in the same bytes.
template <int NT, typename X>
__host__ __device__ constexpr int mma_smem_bytes() {
  return k_stages<NT, X>() * stage_bytes<NT, X>() > (kMmaWarps - 1) * 2 * NT * 4 * 32 * 4
             ? k_stages<NT, X>() * stage_bytes<NT, X>()
             : (kMmaWarps - 1) * 2 * NT * 4 * 32 * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 8 consecutive values of a row of the N operand as bf16 pairs: hi[4] and,
// for f32, lo[4] with lo = bf16(v - hi).
struct NFrag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void frag_n(NFrag& f, const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  f.hi[0] = v.x; f.hi[1] = v.y; f.hi[2] = v.z; f.hi[3] = v.w;
}

__device__ __forceinline__ void frag_n(NFrag& f, const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bf16 h0 = __float2bfloat16_rn(v[2 * j]), h1 = __float2bfloat16_rn(v[2 * j + 1]);
    f.hi[j] = pack_bf16(h0, h1);
    f.lo[j] = pack_bf16(__float2bfloat16_rn(v[2 * j] - __bfloat162float(h0)),
                        __float2bfloat16_rn(v[2 * j + 1] - __bfloat162float(h1)));
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One warp's share of a stage: k-block `kb` (32 columns) of the stage's two
// weight tiles against its NT n-tiles. Lane (g = lane / 4, t = lane % 4)
// reads 8 values from column 8t of weight rows g and g + 8 and of N rows
// 8n + g; they play k = {2t, 2t+1, 2t+8, 2t+9} of two k16 steps (words 0-1,
// then 2-3) in both operands, so the products are the same.
template <int NT, typename X>
__device__ __forceinline__ void mma_stage(float (&acc)[2][NT][4], const unsigned char* st, int kb) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const unsigned char* a = st + g * kAStride + (kb * 32 + 8 * t) * 2;
  uint4 ar[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    ar[m][0] = *reinterpret_cast<const uint4*>(a + (16 * m) * kAStride);
    ar[m][1] = *reinterpret_cast<const uint4*>(a + (16 * m + 8) * kAStride);
  }
  const unsigned char* b = st + kRows * kAStride + g * b_stride<X>() + (kb * 32 + 8 * t) * sizeof(X);
  constexpr bool kSplit = std::is_same<X, float>::value;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    NFrag f;
    frag_n(f, reinterpret_cast<const X*>(b + 8 * n * b_stride<X>()));
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t a0 = word(ar[m][0], 2 * s), a1 = word(ar[m][1], 2 * s);
        const uint32_t a2 = word(ar[m][0], 2 * s + 1), a3 = word(ar[m][1], 2 * s + 1);
        mma16816(acc[m][n], a0, a1, a2, a3, f.hi[2 * s], f.hi[2 * s + 1]);
        if (kSplit) mma16816(acc[m][n], a0, a1, a2, a3, f.lo[2 * s], f.lo[2 * s + 1]);
      }
    }
  }
}

// Programmatic dependent launch: the down pass may start while the
// gate/value pass runs, and each pass may start before the kernel ahead of
// it ends; a kernel touches nothing but its weights before dep_wait().
__device__ __forceinline__ void dep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void dep_launch() { asm volatile("griddepcontrol.launch_dependents;"); }

// Stage K columns [k0, k0 + 128) of weight rows t0[0..16) and t1[0..16)
// (row stride ld), with cp.async.
__device__ __forceinline__ void load_a(unsigned char* st, const bf16* t0, const bf16* t1,
                                       size_t ld, int k0) {
  for (int i = threadIdx.x; i < kRows * (kKc / 8); i += kMmaThreads) {
    const int r = i / (kKc / 8), c = i % (kKc / 8);
    const bf16* src = (r < 16 ? t0 + static_cast<size_t>(r) * ld : t1 + static_cast<size_t>(r - 16) * ld)
                      + k0 + 8 * c;
    cp_async16(st + r * kAStride + 16 * c, src, true);
  }
}

// Stage K columns [k0, k0 + 128) of N rows [n0, n0 + 8 NT) of xn (row
// stride ld; rows at or past B as zeros), with cp.async.
template <int NT, typename X>
__device__ __forceinline__ void load_b(unsigned char* st, const X* xn, size_t ld, int k0, int n0,
                                       int B) {
  constexpr int kPer = 16 / sizeof(X);  // values a 16-byte copy
  unsigned char* bs = st + kRows * kAStride;
  for (int i = threadIdx.x; i < 8 * NT * (kKc / kPer); i += kMmaThreads) {
    const int r = i / (kKc / kPer), c = i % (kKc / kPer);
    const bool valid = n0 + r < B;
    const X* src = xn + (valid ? static_cast<size_t>(n0 + r) * ld + k0 + kPer * c : 0);
    cp_async16(bs + r * b_stride<X>() + 16 * c, src, valid);
  }
}

// acc = the two weight tiles . N rows [n0, n0 + 8 NT) over K columns
// [k_lo, k_hi) (multiples of 128), through a ring of k_stages() stages; warp w
// takes k-block w of every stage, and warps 1..3 hand their sums to warp 0
// through `red`, which adds them in warp order. Only warp 0's acc is the sum.
template <int NT, typename X>
__device__ void block_tiles(float (&acc)[2][NT][4], unsigned char* smem, const bf16* t0,
                            const bf16* t1, const X* xn, size_t ld, int k_lo, int k_hi, int n0,
                            int B) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const int n_chunks = (k_hi - k_lo) / kKc;
  constexpr int kStage = stage_bytes<NT, X>();
  constexpr int kKStages = k_stages<NT, X>();
  // the first stages' weights go out before the wait for the kernel ahead
#pragma unroll
  for (int s = 0; s < kKStages - 1; ++s) {
    if (s < n_chunks) load_a(smem + s * kStage, t0, t1, ld, k_lo + s * kKc);
  }
  dep_wait();
#pragma unroll
  for (int s = 0; s < kKStages - 1; ++s) {
    if (s < n_chunks) load_b<NT>(smem + s * kStage, xn, ld, k_lo + s * kKc, n0, B);
    cp_commit();
  }
  const int warp = threadIdx.x / 32;
  for (int i = 0; i < n_chunks; ++i) {
    cp_wait<kKStages - 2>();
    __syncthreads();  // chunk i landed for every thread; stage (i - 1) % S is free
    const int next = i + kKStages - 1;
    if (next < n_chunks) {
      load_a(smem + (next % kKStages) * kStage, t0, t1, ld, k_lo + next * kKc);
      load_b<NT>(smem + (next % kKStages) * kStage, xn, ld, k_lo + next * kKc, n0, B);
    }
    cp_commit();
    mma_stage<NT, X>(acc, smem + (i % kKStages) * kStage, warp);
  }
  cp_wait<0>();
  float* red = reinterpret_cast<float*>(smem);  // over the drained ring
  const int lane = threadIdx.x % 32;
  __syncthreads();  // every warp is done with the ring
  if (warp > 0) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((((warp - 1) * 2 + m) * NT + n) * 4 + e) * 32 + lane] = acc[m][n][e];
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 0; w < kMmaWarps - 1; ++w)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += red[(((w * 2 + m) * NT + n) * 4 + e) * 32 + lane];
  }
  __syncthreads();  // red and the ring are reused by the caller's next chunk of N
}

// The accumulator element e of n-tile n: (tile row, N column).
__device__ __forceinline__ int acc_row(int e) { return (threadIdx.x % 32) / 4 + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int n, int e) {
  return 8 * n + 2 * (threadIdx.x % 4) + (e & 1);
}

// hid[b, h] = silu(Wg[h] . x[b]) * (Wv[h] . x[b]); w_in [2H, C]. Block (x, y):
// hidden units [16 x, 16 x + 16), its gate tile and its value tile, over
// the chunks of 8 NT rows of x numbered y, y + gridDim.y, ...
template <int NT, typename X>
__global__ void __launch_bounds__(kMmaThreads)
gate_value_mma(const X* __restrict__ x, const bf16* __restrict__ w_in, float* __restrict__ hid,
               int B, int C, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  dep_launch();  // the down pass may start streaming its weights
  const int h0 = blockIdx.x * 16;
  const bf16* wg = w_in + static_cast<size_t>(h0) * C;
  const bf16* wv = w_in + static_cast<size_t>(H + h0) * C;
  for (int n0 = 8 * NT * blockIdx.y; n0 < B; n0 += 8 * NT * gridDim.y) {
    float acc[2][NT][4];
    block_tiles<NT>(acc, smem, wg, wv, x, C, 0, C, n0, B);
    if (threadIdx.x >= 32) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = n0 + acc_col(n, e);
        const float gate = acc[0][n][e], val = acc[1][n][e];
        if (b < B) hid[static_cast<size_t>(b) * H + h0 + acc_row(e)] = gate / (1.f + expf(-gate)) * val;
      }
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// out[b, c] = Wo[c] . hid[b]; w_out [C, H]. Block (x, y, z): output rows
// [32 x, 32 x + 32) over split y of gridDim.y of H's 128-column chunks, for
// the chunks of 8 NT rows of hid numbered z, z + gridDim.z, ...; written to
// out (one split) or to partial [splits, B, C] f32.
template <int NT, typename X>
__global__ void __launch_bounds__(kMmaThreads)
down_mma(const float* __restrict__ hid, const bf16* __restrict__ w_out, X* __restrict__ out,
         float* __restrict__ partial, int B, int C, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  dep_launch();  // the split reduction may launch
  const int splits = gridDim.y, split = blockIdx.y;
  const int c0 = blockIdx.x * kRows;
  const int n_chunks = H / kKc;
  const int k_lo = kKc * (n_chunks * split / splits), k_hi = kKc * (n_chunks * (split + 1) / splits);
  const bf16* w0 = w_out + static_cast<size_t>(c0) * H;
  for (int n0 = 8 * NT * blockIdx.z; n0 < B; n0 += 8 * NT * gridDim.z) {
    float acc[2][NT][4];
    block_tiles<NT>(acc, smem, w0, w0 + static_cast<size_t>(16) * H, hid, H, k_lo, k_hi, n0, B);
    if (threadIdx.x >= 32) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = n0 + acc_col(n, e), c = c0 + 16 * m + acc_row(e);
          if (b >= B) continue;
          if (splits == 1) store_out(out + static_cast<size_t>(b) * C + c, acc[m][n][e]);
          else partial[(static_cast<size_t>(split) * B + b) * C + c] = acc[m][n][e];
        }
      }
    }
  }
}

// out[i] = sum of partial[s, i] over the splits s in order; n = B * C.
template <typename X>
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ partial, X* __restrict__ out, int splits, int n) {
  dep_wait();
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) sum += __ldcg(partial + static_cast<size_t>(s) * n + i);
  store_out(out + i, sum);
}

template <int NT, int NT2, typename X>
int run_mma(const void* x, const void* w_in, const void* w_out, float* hid, void* out,
            float* partial, int splits, int groups, int B, int C, int H, cudaStream_t s) {
  auto* gv = gate_value_mma<NT, X>;
  auto* down = down_mma<NT2, X>;
  constexpr int gv_smem = mma_smem_bytes<NT, X>(), down_smem = mma_smem_bytes<NT2, float>();
  cudaError_t e = cudaFuncSetAttribute(gv, cudaFuncAttributeMaxDynamicSharedMemorySize, gv_smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(down, cudaFuncAttributeMaxDynamicSharedMemorySize, down_smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kMmaThreads);
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(H / 16, groups);
  cfg.dynamicSmemBytes = gv_smem;
  e = cudaLaunchKernelEx(&cfg, gv, static_cast<const X*>(x), static_cast<const bf16*>(w_in), hid,
                         B, C, H);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(C / kRows, splits, groups);
  cfg.dynamicSmemBytes = down_smem;
  e = cudaLaunchKernelEx(&cfg, down, static_cast<const float*>(hid),
                         static_cast<const bf16*>(w_out), static_cast<X*>(out), partial, B, C, H);
  if (e == cudaSuccess && splits > 1) {
    cfg.gridDim = dim3((B * C + 255) / 256);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 0;
    e = cudaLaunchKernelEx(&cfg, sum_splits<X>, static_cast<const float*>(partial),
                           static_cast<X*>(out), splits, B * C);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// N columns a chunk: a group's share of B (B / groups, rounded up) rounded
// up to 8, at most 64 (32 for an f32 x, whose stages are twice as wide).
template <typename X>
int dispatch_mma(const void* x, const void* w_in, const void* w_out, float* hid, void* out,
                 float* partial, int splits, int groups, int B, int C, int H, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<X, float>::value;
  const int cols = (B + groups - 1) / groups;
  if (cols <= 8) {
    return run_mma<1, 1, X>(x, w_in, w_out, hid, out, partial, splits, groups, B, C, H, s);
  }
  if (cols <= 16) {
    return run_mma<2, 2, X>(x, w_in, w_out, hid, out, partial, splits, groups, B, C, H, s);
  }
  if (kF32 || cols <= 32) {
    return run_mma<4, 4, X>(x, w_in, w_out, hid, out, partial, splits, groups, B, C, H, s);
  }
  if constexpr (!kF32) {
    return run_mma<8, 8, X>(x, w_in, w_out, hid, out, partial, splits, groups, B, C, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);  // not reached
}

}  // namespace

// Shapes (row-major, contiguous, 16-byte aligned): x [B, C] and out [B, C],
// f32 (x_bf16 == 0) or bf16; w_in [2H, C] (gate rows, then value rows) and
// w_out [C, H], f32 (w_bf16 == 0) or bf16, the step's slices; hid [B, H] f32
// scratch. C and H multiples of 8. With bf16 weights and C, H multiples of
// 128 the tensor-core kernels run: `splits` (1 to H / 128) splits of H in
// the down pass and partial [splits, B, C] f32 scratch (unused when splits
// == 1); `groups` (1 to B) groups of blocks share B's rows, each group with
// a copy of both passes' grids over B / groups rows (rounded up). Returns the
// cudaGetLastError() status after the launches.
extern "C" int gating_ffn_step(const void* x, const void* w_in, const void* w_out, void* hid,
                               void* out, void* partial, int splits, int groups, int B, int C,
                               int H, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(hid);
  if (w_bf16 && C % 128 == 0 && H % 128 == 0) {
    if (groups < 1 || groups > B) return static_cast<int>(cudaErrorInvalidValue);
    float* pf = static_cast<float*>(partial);
    return x_bf16 ? dispatch_mma<bf16>(x, w_in, w_out, hf, out, pf, splits, groups, B, C, H, s)
                  : dispatch_mma<float>(x, w_in, w_out, hf, out, pf, splits, groups, B, C, H, s);
  }
  if (x_bf16) {
    return w_bf16 ? run<bf16, bf16>(x, w_in, w_out, hf, out, B, C, H, s)
                  : run<bf16, float>(x, w_in, w_out, hf, out, B, C, H, s);
  }
  return w_bf16 ? run<float, bf16>(x, w_in, w_out, hf, out, B, C, H, s)
                : run<float, float>(x, w_in, w_out, hf, out, B, C, H, s);
}
