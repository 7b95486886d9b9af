// K4 and K5: the backbone's LLaMAMLP at decode size, one fused gated FFN
// over N rows: out[n] = (silu(Wg . x[n]) * (Wv . x[n])) . Wo^T, with Wg and
// Wv [H, C] (the MLP's fc_1 and fc_2) and Wo [C, H] (its proj), read in
// place.
//
// Replaces: rstnet_tpu/ops/pallas_ffn.py::gating_ffn_pallas (K4, body
// _ffn_kernel) and ::gating_ffn_pallas_int8 (K5, body _ffn_int8_kernel).
// Same function: f32 sums, the hidden silu(gate) * val in f32, the output
// cast once to x's dtype. K5's weights are int8 with f32 row scales ([H]
// for gate and value, [C] for out).
//
// What bounds it on the H100: the weight bytes, at every N <= 64 the route
// sends. At Llama-3.2-1B's MLP (C=2048, H=8192) a call reads 3 * C * H
// weights, 100.7 MB in bf16 (30.0 us at 3.35 TB/s), 50.3 MB in int8 (15.0
// us) or 201.3 MB in f32 (60.1 us), and does 2N FLOPs a weight and x row:
// at N = 64, 64 FLOPs a bf16 byte and 128 an int8 byte (up to three times
// that where operands go in as bf16 parts, below), under the ~295
// FLOP/byte where the bf16 tensor cores would bind. The first port dotted
// each weight row with each x row on the CUDA cores (a warp a row), so its
// time grew ~20 us a row of N beyond the stream.
//
// What the design does about it (C and H multiples of 128: the route's
// envelope). Every weight byte is read from device memory once and applied
// to all N rows on the tensor cores (wgmma, bf16 in, f32 sums): the weights
// are the M side, x (or the hidden) the N side, N padded to 8, 16, 32 or 64
// columns, so 1 to 64 rows cost one weight stream. Three launches with
// programmatic dependent launch (a fourth, first, for an f32 x):
// 1. gate_value_tc: a block takes 64 hidden units over all of C: consumer
//    warpgroup 0 their 64 gate rows, warpgroup 1 their 64 value rows (as
//    many bytes of x read from L2 a stage as half its weight bytes at
//    N = 64); the value sums reach the gate's threads through shared memory
//    once, and silu(gate) * val goes out as hi + lo bf16 planes [2, N, H]
//    (hi = bf16(v), lo = bf16(v - hi)), the down pass's two-part operand.
//    H/64 blocks.
// 2. down_tc: the C output rows are C/128 tiles, too few for 132 SMs, so H
//    is split too: block (r, s) takes rows [128 r, 128 r + 128) (64 a
//    warpgroup) over the s-th of `splits` parts of H (whole 128-column
//    chunks) and writes its partial sums [splits, N, C]. Its first weight
//    stages stream in before it waits (griddepcontrol.wait) for the hidden:
//    Wo does not depend on it.
// 3. sum_down_splits: out = the partials added in split order (times K5's
//    row scale), cast to x's dtype (or kept in f32: out_f32, a
//    tensor-parallel rank's partial of the down product, which the ranks
//    sum in f32 before the one rounding). No float atomics: two calls give
//    bit-identical results.
// A block is one producer warp and two consumer warpgroups. The producer
// keeps a ring of stages full with TMA tensor copies completing on
// mbarriers: a stage is 128 weight rows x 128 bytes a box (64 bf16 or 128
// int8 columns, one box of 16 KB; 64 f32 columns, two boxes of 32) and the
// matching columns of the N operand, every box in the 128-byte swizzle
// that wgmma reads. bf16 and f32 weights: one deep ring an SM (200 KB, up
// to 8 stages); int8: two rings of 96 KB an SM, so that a down block's
// first stages stream beside a gate/value block. Precision: a bf16 x times
// a bf16 weight is exact in the f32 sum; an f32 x (split by split_rows) and
// the f32 hidden enter as hi + lo, two products into one sum, leaving
// ~2^-17 of each value out. K5: the int8 weights stream as int8 (half the
// bytes) and each warp widens its 16 rows into wgmma's register A
// fragments: byte q + 128 in the mantissa of 2^23, minus 2^23 + 128, is q
// in f32, exactly, whose upper half is bf16(q) (|q| <= 127: exact). That is
// one prmt and one add a weight and one prmt and one xor a pair, ~3
// instructions a weight on the CUDA cores beside the products, and a
// stage's widening waits for its products (the A registers are reused).
// The row scale multiplies the row's f32 sum once (gate and value in the
// gate/value epilogue, out in sum_down_splits), where the reference rounds
// float(q) * scale per element: one f32 rounding apart. K4 over f32
// weights: the weights stream as f32 (twice the bf16 bytes, never copied)
// and each warp splits its 16 rows in registers into A fragments hi =
// bf16(w) (round to nearest even: bit for bit torch's w.to(bfloat16)) and
// lo = bf16(w - hi), 8 bytes a lane a fragment register. Under a bf16 x
// only hi enters (the weights taken in x's dtype, as the reference does);
// under an f32 x, hi . x_hi + hi . x_lo + lo . x_hi, one sum (and hi . h_hi
// + hi . h_lo + lo . h_hi in the down pass), ~2^-17 of each operand left
// out. The split is in registers, not in a converter warpgroup writing
// bf16 planes: a stage's f32 box is read from shared memory once, by the
// warp that multiplies it, and nothing waits on a second hand-off; the
// ~6 instructions a weight pair sit beside the products, far under a
// stage's arrival time at the f32 stream rate.
// Measured on the H100 (tools/ffn_spans.py, PERF.md): the gate/value pass
// streams bf16 weights at 2.1-2.5 TB/s, and the down pass streams most of
// Wo after it (a 10-13 us tail): what keeps K4 above its bound. Over f32
// weights K4 takes 1.2-1.4x its bound from N = 1 to 64 (tools/k4_trees.py;
// two 96 KB rings an SM, as K5 keeps, measured slower at every N). C or H off
// the 128 grid keep the first port's CUDA-core kernels (core_*), with each
// int8 element dequantized as float(q) * scale there and f32 weights under
// a bf16 x rounded to bf16 as they are loaded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// out[i] = v: f32 when out_f32, else in x's dtype X
template <typename X>
__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    store(static_cast<X*>(out) + i, v);
}

// ---------------------------------------------------------------------------
// CUDA-core kernels (C or H off the 128 grid)

constexpr int kCoreWarps = 8;
constexpr int kCoreThreads = kCoreWarps * 32;
constexpr int kChunk = 256;  // columns a warp covers with one load a lane: 32 lanes x 8
constexpr int kStageBytes = 64 * 1024;  // the shared-memory tile a block aims for
// weight chunks a core_down lane keeps in flight: two, but one with 64 rows
// in registers, whose 512-column tiles would not fit kStageBytes
__host__ __device__ constexpr int steps_for(int nb) { return nb >= 64 ? 1 : 2; }

// Elements [8i, 8i + 8) of a weight row, widened to f32 (read-only path). The
// float rows ignore `scale`; an int8 row's elements are float(q) * scale.
__device__ __forceinline__ void load8(const bf16* __restrict__ row, int i, float, float* f) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(row) + i);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(a2[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ row, int i, float, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 2 * i + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* __restrict__ row, int i, float scale,
                                      float* f) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(row) + i);
  const int8_t* q = reinterpret_cast<const int8_t*>(&a);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = static_cast<float>(q[j]) * scale;
}

// load8, then each weight taken in x's dtype: f32 weights under a bf16 x as
// bf16(w) (bf16 and int8 rows are already exact in bf16).
template <typename X, typename W>
__device__ __forceinline__ void load8x(const W* __restrict__ row, int i, float scale, float* f) {
  load8(row, i, scale, f);
  if constexpr (std::is_same<X, bf16>::value && std::is_same<W, float>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(__float2bfloat16_rn(f[j]));
  }
}

// acc + a . (the 8 floats at s), s in shared memory
__device__ __forceinline__ float dot8(const float* a, const float* s, float acc) {
  const float4 u = reinterpret_cast<const float4*>(s)[0];
  const float4 v = reinterpret_cast<const float4*>(s)[1];
  acc = fmaf(a[0], u.x, acc);
  acc = fmaf(a[1], u.y, acc);
  acc = fmaf(a[2], u.z, acc);
  acc = fmaf(a[3], u.w, acc);
  acc = fmaf(a[4], v.x, acc);
  acc = fmaf(a[5], v.y, acc);
  acc = fmaf(a[6], v.z, acc);
  acc = fmaf(a[7], v.w, acc);
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, nb) and columns [c0, c0 + cols) of a row-major [*, width] matrix
// into tile[nb][cols] as f32; columns at or past `width` as 0. `cols` is a
// multiple of kCoreThreads: thread t stages columns t, t + kCoreThreads, ...
// of each row, and issues 8 loads before its first store, so their
// latencies overlap.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int width, int c0, int cols,
                                      int nb, float* tile) {
  const int m = cols / kCoreThreads, count = nb * m;  // a thread's elements
  int n = 0, k = 0;  // the row and column block of its next element
  for (int f0 = 0; f0 < count; f0 += 8) {
    float v[8];
    int at[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k * kCoreThreads + threadIdx.x;
      at[j] = n * cols + c;
      v[j] = f0 + j < count && c0 + c < width
                 ? to_f32(src[static_cast<size_t>(n) * width + c0 + c]) : 0.f;
      if (++k == m) {
        k = 0;
        ++n;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (f0 + j < count) tile[at[j]] = v[j];
    }
  }
}

// hid[n, h] = silu(Wg[h] . x[n]) * (Wv[h] . x[n]); gs/vs: int8 row scales or
// null; x staged `tile` columns at a time (a multiple of kChunk).
template <typename X, typename W, int NB>
__global__ void __launch_bounds__(kCoreThreads)
core_gate_value(const X* __restrict__ x, const W* __restrict__ wg, const W* __restrict__ wv,
                const float* __restrict__ gs, const float* __restrict__ vs,
                float* __restrict__ hid, int N, int C, int H, int tile) {
  extern __shared__ __align__(16) float xs[];  // [NB][tile]
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x * kCoreWarps + threadIdx.x / 32;
  const bool row = h < H;  // uniform across the warp; every warp joins the barriers
  const float sg = row && gs ? gs[h] : 1.f;
  const float sv = row && vs ? vs[h] : 1.f;
  const W* wgr = wg + static_cast<size_t>(row ? h : 0) * C;
  const W* wvr = wv + static_cast<size_t>(row ? h : 0) * C;
  for (int n0 = 0; n0 < N; n0 += NB) {
    const int nb = min(NB, N - n0);
    float g[NB], v[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) g[n] = v[n] = 0.f;
    float fg[8], fv[8];
    bool have = row && 8 * lane < C;
    if (have) {
      load8x<X>(wgr, lane, sg, fg);
      load8x<X>(wvr, lane, sv, fv);
    }
    for (int c0 = 0; c0 < C; c0 += tile) {
      __syncthreads();  // the previous tile is consumed
      stage(x + static_cast<size_t>(n0) * C, C, c0, tile, nb, xs);
      __syncthreads();
      for (int s = c0; s < min(c0 + tile, C); s += kChunk) {
        const int cn = s + kChunk + 8 * lane;
        const bool next = row && cn < C;
        float ng[8], nv[8];
        if (next) {  // the next columns' weights, in flight during these sums
          load8x<X>(wgr, cn / 8, sg, ng);
          load8x<X>(wvr, cn / 8, sv, nv);
        }
        if (have) {
          const float* xt = xs + (s - c0) + 8 * lane;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            if (n < nb) {
              g[n] = dot8(fg, xt + n * tile, g[n]);
              v[n] = dot8(fv, xt + n * tile, v[n]);
            }
          }
        }
        have = next;
        if (next) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            fg[j] = ng[j];
            fv[j] = nv[j];
          }
        }
      }
    }
    if (row) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n < nb) {
          const float gsum = warp_sum(g[n]);
          const float vsum = warp_sum(v[n]);
          if (lane == 0)
            hid[static_cast<size_t>(n0 + n) * H + h] = gsum / (1.f + expf(-gsum)) * vsum;
        }
      }
    }
  }
}

// out[n, c] = Wo[c] . hid[n]; os: int8 row scales or null; hid staged `tile`
// columns at a time (a multiple of steps_for(NB) * kChunk). A lane loads
// steps_for(NB) chunks of 8 columns, 256 apart, per step: that many loads
// in flight, each coalesced.
template <typename X, typename W, int NB>
__global__ void __launch_bounds__(kCoreThreads)
core_down(const float* __restrict__ hid, const W* __restrict__ wo, const float* __restrict__ os,
          void* __restrict__ out, int out_f32, int N, int C, int H, int tile) {
  extern __shared__ __align__(16) float hs[];  // [NB][tile]
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kCoreWarps + threadIdx.x / 32;
  const bool row = c < C;  // uniform across the warp; every warp joins the barriers
  const float so = row && os ? os[c] : 1.f;
  const W* wor = wo + static_cast<size_t>(row ? c : 0) * H;
  for (int n0 = 0; n0 < N; n0 += NB) {
    const int nb = min(NB, N - n0);
    float acc[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[n] = 0.f;
    constexpr int U = steps_for(NB);
    float fw[U][8];
    bool have[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      have[u] = row && u * kChunk + 8 * lane < H;
      if (have[u]) load8x<X>(wor, u * kChunk / 8 + lane, so, fw[u]);
    }
    for (int h0 = 0; h0 < H; h0 += tile) {
      __syncthreads();
      stage(hid + static_cast<size_t>(n0) * H, H, h0, tile, nb, hs);
      __syncthreads();
      for (int s = h0; s < min(h0 + tile, H); s += U * kChunk) {
        float nw[U][8];
        bool next[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int hn = s + (U + u) * kChunk + 8 * lane;
          next[u] = row && hn < H;
          if (next[u]) load8x<X>(wor, hn / 8, so, nw[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (have[u]) {
            const float* ht = hs + (s - h0) + u * kChunk + 8 * lane;
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              if (n < nb) acc[n] = dot8(fw[u], ht + n * tile, acc[n]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          have[u] = next[u];
          if (next[u]) {
#pragma unroll
            for (int j = 0; j < 8; ++j) fw[u][j] = nw[u][j];
          }
        }
      }
    }
    if (row) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n < nb) {
          const float sum = warp_sum(acc[n]);
          if (lane == 0) store_out<X>(out, static_cast<size_t>(n0 + n) * C + c, sum, out_f32);
        }
      }
    }
  }
}

// Columns a block stages at a time for nb rows: as many multiples of
// `step` as fit kStageBytes (at least one), no wider than the row.
int tile_columns(int width, int nb, int step) {
  const int fit = kStageBytes / (static_cast<int>(sizeof(float)) * nb) / step * step;
  const int whole = (width + step - 1) / step * step;
  return std::min(std::max(fit, step), whole);
}

template <int NB, typename X, typename W>
int core_launch(const void* x, const void* wg, const void* wv, const void* wo, const float* gs,
                const float* vs, const float* os, float* hid, void* out, int out_f32, int N,
                int C, int H, cudaStream_t s) {
  const int tile1 = tile_columns(C, NB, kChunk), tile2 = tile_columns(H, NB, steps_for(NB) * kChunk);
  const int smem1 = static_cast<int>(sizeof(float)) * NB * tile1;
  const int smem2 = static_cast<int>(sizeof(float)) * NB * tile2;
  cudaError_t e = cudaSuccess;
  if (smem1 > 48 * 1024)  // above the default limit only by opting in
    e = cudaFuncSetAttribute(core_gate_value<X, W, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess && smem2 > 48 * 1024)
    e = cudaFuncSetAttribute(core_down<X, W, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  core_gate_value<X, W, NB><<<(H + kCoreWarps - 1) / kCoreWarps, kCoreThreads, smem1, s>>>(
      static_cast<const X*>(x), static_cast<const W*>(wg), static_cast<const W*>(wv), gs, vs,
      hid, N, C, H, tile1);
  core_down<X, W, NB><<<(C + kCoreWarps - 1) / kCoreWarps, kCoreThreads, smem2, s>>>(
      hid, static_cast<const W*>(wo), os, out, out_f32, N, C, H, tile2);
  return static_cast<int>(cudaGetLastError());
}

// The register chunk for N rows: 1 (single-row decode), 16, or 64.
template <typename X, typename W>
int core_run(const void* x, const void* wg, const void* wv, const void* wo, const float* gs,
             const float* vs, const float* os, float* hid, void* out, int out_f32, int N, int C,
             int H, cudaStream_t s) {
  if (N == 1) return core_launch<1, X, W>(x, wg, wv, wo, gs, vs, os, hid, out, out_f32, N, C, H, s);
  if (N <= 16)
    return core_launch<16, X, W>(x, wg, wv, wo, gs, vs, os, hid, out, out_f32, N, C, H, s);
  return core_launch<64, X, W>(x, wg, wv, wo, gs, vs, os, hid, out, out_f32, N, C, H, s);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16 or int8 weights, C and H multiples of 128)

constexpr int kWarps = 8;                      // consumer warps: two warpgroups
constexpr int kTcThreads = 32 * kWarps + 32;   // plus the producer warp
constexpr int kRows = 16 * kWarps;             // weight rows a block: 64 a warpgroup
constexpr int kUnits = kRows / 2;              // hidden units a gate/value block: 64
constexpr int kRowBytes = 128;                 // a staged row: the 128-byte swizzle span
constexpr int kABytes = kRows * kRowBytes;     // one box of a stage's weights: 16 KB
constexpr int kMaxStages = 8;
constexpr int kMaxRows = 64;                   // x rows a launch chain: 8 n-tiles of 8
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a wait this long is a fault

// A weight box's K columns: one 128-byte row of W (the swizzle's span)
template <typename W>
__host__ __device__ constexpr int box_cols() { return kRowBytes / static_cast<int>(sizeof(W)); }
// Weight boxes a stage: f32 weights two (64 columns), so that a stage spans
// whole 64-column boxes of the bf16 N operand
template <typename W>
__host__ __device__ constexpr int w_boxes() { return sizeof(W) == 4 ? 2 : 1; }
// K columns a stage
template <typename W>
__host__ __device__ constexpr int k_cols() { return w_boxes<W>() * box_cols<W>(); }
// a stage's weight bytes: 16 KB, 32 KB for f32
template <typename W>
__host__ __device__ constexpr int a_bytes() { return w_boxes<W>() * kABytes; }
// the N operand's boxes a plane and stage: 64 bf16 columns each
template <typename W>
__host__ __device__ constexpr int b_boxes() { return k_cols<W>() / 64; }
template <typename W, int NT, int SB>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<W>() + SB * b_boxes<W>() * NT * 8 * kRowBytes;
}
// Blocks an SM and ring bytes a block: bf16 and f32 weights stream through
// one deep ring an SM; an int8 pass keeps two shallower rings an SM, so that a down
// block's first stages stream beside a gate/value block (its half-size
// pass gains more from that head start than from depth; measured on the
// H100, PERF.md).
template <typename W>
__host__ __device__ constexpr int blocks_per_sm() {
  return std::is_same<W, int8_t>::value ? 2 : 1;
}
template <typename W>
__host__ __device__ constexpr int ring_bytes() {
  return blocks_per_sm<W>() == 1 ? 200 * 1024 : 96 * 1024;
}
template <typename W, int NT, int SB>
__host__ __device__ constexpr int n_stages() {  // as many as fit the ring, 2 to kMaxStages
  return ring_bytes<W>() / stage_bytes<W, NT, SB>() < 2 ? 2
         : ring_bytes<W>() / stage_bytes<W, NT, SB>() > kMaxStages
             ? kMaxStages
             : ring_bytes<W>() / stage_bytes<W, NT, SB>();
}
template <typename W, int NT, int SB>
__host__ __device__ constexpr int tc_smem_bytes() {  // the ring, plus slack to align it
  return n_stages<W, NT, SB>() * stage_bytes<W, NT, SB>() + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The ring at the first 1024-byte boundary (the 128-byte swizzle's atom).
__device__ __forceinline__ unsigned char* align_ring(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
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
// TMA: the box at (c0, c1) of a 2-D tensor map, completing on `bar`.
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                      int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// TMA: the box at (c0, 0, plane) of a 3-D tensor map (columns, rows, planes).
__device__ __forceinline__ void tma3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                      int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(0), "r"(plane)
      : "memory");
}

// Programmatic dependent launch: each kernel may start while the one ahead
// of it in the stream runs; it touches nothing but its weights before
// dep_wait(), which returns once that kernel has finished and its writes
// are visible. So the weights must not be written by the kernel just ahead
// of the call (the wrappers copy no weights: f32 weights are read in place
// whatever x's dtype).
__device__ __forceinline__ void dep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void dep_launch() { asm volatile("griddepcontrol.launch_dependents;"); }

// wgmma shared-memory descriptor of a K-major tile whose rows are 128 bytes
// in the 128-byte swizzle, 8-row atoms 1024 bytes apart (the tile starts on
// a 1024-byte boundary); a k16 step advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) { return d + (bytes >> 4); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of registers that a wgmma reads
// or writes asynchronously across the wait for it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d += A B for a 64-row A tile and NT * 8 columns of B, k16 (f32 sums, bf16
// operands): ss with A and B from shared memory (descriptors), rs with A
// from registers (the m16n8k16 A fragment of the warp's 16 rows).
template <int NT>
struct Wgmma;

template <>
struct Wgmma<1> {
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<2> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<4> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 weights (the lower column first) as bf16 pairs hi = bf16(w),
// rounded to nearest even as torch's w.to(torch.bfloat16) is, and lo =
// bf16(w - hi) (w - hi is exact in f32).
__device__ __forceinline__ void split_pair(const unsigned char* p, uint32_t& hi, uint32_t& lo) {
  const float2 w = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn(w.x, w.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(w.x - hf.x, w.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Two int8 weights (bytes 2 hsel and 2 hsel + 1 of word w) as a bf16 pair,
// exactly: the byte q + 128 in the low mantissa bits of 2^23 is 2^23 + q +
// 128; less 2^23 + 128 it is float(q), whose upper half is bf16(q) (|q| <=
// 128 needs 8 bits).
__device__ __forceinline__ uint32_t widen_pair(uint32_t w, int hsel) {
  const uint32_t x = w ^ 0x80808080u;  // q + 128 in each byte
  const uint32_t sel = 0x7650 + 2 * hsel;
  const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, sel)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, sel + 1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The N operand of one stage: SB planes x b_boxes<W>() boxes of 64 columns
// from column k0, each NT * 8 rows (rows past the tensor's read as zeros).
template <typename W, int NT, int SB>
__device__ __forceinline__ void load_b(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                       int k0) {
  constexpr int kBox = NT * 8 * kRowBytes;
#pragma unroll
  for (int s = 0; s < SB; ++s)
#pragma unroll
    for (int b = 0; b < b_boxes<W>(); ++b) tma3d(dst + (s * b_boxes<W>() + b) * kBox, map, bar,
                                                  k0 + 64 * b, s);
}

// The ring's barriers, set up by thread 0 before the block's first sync.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);  // the producer's expect_tx
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer's loop: chunk i of n_chunks into stage i % S. The weights of
// the first S chunks go out before the wait for the kernel ahead (they do
// not depend on it); the N operand only after it. load_a(dst, bar, i) and
// load_b(dst, bar, i) issue the copies.
template <int kStage, int kA, int kStages, typename A, typename B>
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        int n_chunks, A load_a, B load_b) {
  const int pre = min(kStages, n_chunks);
  for (int i = 0; i < pre; ++i) {
    mbar_expect_tx(&full[i], kStage);
    load_a(ring + i * kStage, &full[i], i);
  }
  dep_wait();
  for (int i = 0; i < pre; ++i) load_b(ring + i * kStage + kA, &full[i], i);
  for (int i = pre; i < n_chunks; ++i) {
    const int s = i % kStages;
    mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    unsigned char* st = ring + s * kStage;
    mbar_expect_tx(&full[s], kStage);
    load_a(st, &full[s], i);
    load_b(st + kA, &full[s], i);
  }
}

// The consumer warps only (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kWarps) : "memory");
}

// A consumer warpgroup's loop: acc = its 64-row tile (at byte offset a_off
// of every weight box of a stage) times the stage's N operand (SB planes of
// NT * 8 rows, after the weights), summed over n_chunks chunks. acc element
// e of a thread: tile row 16 (warp % 4) + g + 8 ((e >> 1) & 1), column
// 8 (e >> 2) + 2t + (e & 1), g = lane / 4, t = lane % 4.
// bf16 weights: A and B by descriptor, 4 k16 steps a stage; a stage is
// released once its products are done (holding it until the next stage's
// were issued measured slower).
// int8 weights: each warp widens its 16 rows of the stage (8 k16 steps of
// 16 bytes; chunk j of row r at (j ^ (r % 8)) * 16, r % 8 == g) into A
// fragments: lane (g, t) needs bytes {2t, 2t+1} (a0 / a1 for rows g / g+8)
// and {2t+8, 2t+9} (a2 / a3) of each chunk, half t & 1 of words t >> 1 and
// 2 + (t >> 1).
// f32 weights: each warp splits its 16 rows of the stage's two boxes (4 k16
// steps of 64 bytes; chunk j of row r at (j ^ (r % 8)) * 16) into hi and lo
// A fragments: lane (g, t) needs columns {2t, 2t+1} and {2t+8, 2t+9} of a
// k16 step, 8 bytes at 8 (t & 1) in chunks 4 (k % 2) + (t >> 1) and 2 more.
// Products: hi with every plane of the N operand, and with kLo (an f32 x)
// lo with plane 0 (hi . hi + hi . lo + lo . hi), one sum.
template <typename W, int NT, int SB, int kStage, int kStages, bool kLo = false>
__device__ __forceinline__ void consume(float (&acc)[4 * NT], const unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int n_chunks,
                                        int a_off) {
  constexpr int kBox = NT * 8 * kRowBytes;  // one box of the N operand
  constexpr int kA = a_bytes<W>();          // the N operand's offset in a stage
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % kStages]);
  };
  if constexpr (std::is_same<W, bf16>::value) {
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const unsigned char* st = ring + s * kStage;
      const uint64_t da = desc_k(st + a_off);
      if (i == 0) wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int sb = 0; sb < SB; ++sb)
          Wgmma<NT>::ss(acc, desc_add(da, 32 * kk),
                        desc_add(desc_k(st + kA + sb * kBox), 32 * kk));
      wg_commit();
      wg_wait<0>();
      release(i);
    }
    fence_regs(acc);
  } else if constexpr (std::is_same<W, float>::value) {
    const int g = lane / 4, t = lane % 4;
    const int r0 = a_off + (16 * (threadIdx.x / 32 % 4) + g) * kRowBytes + 8 * (t & 1);
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const unsigned char* st = ring + s * kStage;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned char* row = st + (k / 2) * kABytes + r0;
        const int c0 = ((4 * (k % 2) + (t >> 1)) ^ g) << 4;
        const int c2 = ((4 * (k % 2) + 2 + (t >> 1)) ^ g) << 4;
        split_pair(row + c0, hi[k][0], lo[k][0]);
        split_pair(row + 8 * kRowBytes + c0, hi[k][1], lo[k][1]);
        split_pair(row + c2, hi[k][2], lo[k][2]);
        split_pair(row + 8 * kRowBytes + c2, hi[k][3], lo[k][3]);
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int sb = 0; sb < SB; ++sb)
          Wgmma<NT>::rs(acc, hi[k], desc_add(desc_k(st + kA + sb * kBox), 32 * k));
        if constexpr (kLo) Wgmma<NT>::rs(acc, lo[k], desc_add(desc_k(st + kA), 32 * k));
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(hi);
      if constexpr (kLo) fence_regs(lo);
      release(i);
    }
    fence_regs(acc);
  } else {
    const int g = lane / 4, t = lane % 4, hsel = t & 1;
    const int r0 = a_off + (16 * (threadIdx.x / 32 % 4) + g) * kRowBytes;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const unsigned char* st = ring + s * kStage;
      uint32_t a[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned char* c = st + r0 + ((j ^ g) << 4) + 4 * (t >> 1);
        a[j][0] = widen_pair(lds32(c), hsel);
        a[j][1] = widen_pair(lds32(c + 8 * kRowBytes), hsel);
        a[j][2] = widen_pair(lds32(c + 8), hsel);
        a[j][3] = widen_pair(lds32(c + 8 * kRowBytes + 8), hsel);
      }
      wg_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int sb = 0; sb < SB; ++sb)
          Wgmma<NT>::rs(acc, a[j],
                        desc_add(desc_k(st + kA + (2 * sb + j / 4) * kBox), 32 * (j % 4)));
      wg_commit();
      wg_wait<0>();
      fence_regs(a);
      release(i);
    }
    fence_regs(acc);
  }
}

// hid[p][n0 + n][h] (p = 0: hi, 1: lo; planes `plane` apart) of
// silu(Wg[h] . x[n]) * (Wv[h] . x[n]) for the block's 64 hidden units;
// gs/vs: int8 row scales or null. SB: 1 for a bf16 x, 2 for an f32 x's hi
// and lo planes (x_map: [SB, rows, C], the launch chain's rows). f32
// weights enter as hi + lo under an f32 x, as hi = bf16(w) under a bf16 x.
template <typename W, int NT, int SB>
__global__ void __launch_bounds__(kTcThreads, blocks_per_sm<W>())
gate_value_tc(const __grid_constant__ CUtensorMap wg_map,
              const __grid_constant__ CUtensorMap wv_map,
              const __grid_constant__ CUtensorMap x_map, const float* __restrict__ gs,
              const float* __restrict__ vs, bf16* __restrict__ hid, size_t plane, int rows, int C,
              int H) {
  constexpr int kStage = stage_bytes<W, NT, SB>(), kStages = n_stages<W, NT, SB>();
  constexpr bool kLo = std::is_same<W, float>::value && SB == 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  uint64_t *full = bars, *empty = bars + kMaxStages;
  unsigned char* ring = align_ring(smem_raw);
  dep_launch();  // the down pass may start streaming its weights
  init_ring(full, empty, kStages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.x * kUnits, n_chunks = C / k_cols<W>();
  if (warp == kWarps) {
    if (lane == 0) {
      const CUtensorMap *mg = &wg_map, *mv = &wv_map, *mx = &x_map;
      produce<kStage, a_bytes<W>(), kStages>(
          ring, full, empty, n_chunks,
          [=](unsigned char* dst, uint64_t* bar, int i) {
#pragma unroll
            for (int b = 0; b < w_boxes<W>(); ++b) {
              const int k = i * k_cols<W>() + b * box_cols<W>();
              tma2d(dst + b * kABytes, mg, bar, k, h0);
              tma2d(dst + b * kABytes + kABytes / 2, mv, bar, k, h0);
            }
          },
          [=](unsigned char* dst, uint64_t* bar, int i) {
            load_b<W, NT, SB>(dst, mx, bar, i * k_cols<W>());
          });
    }
    return;
  }
  // warpgroup 0 the gate rows (the first 8 KB of a stage), warpgroup 1 the
  // value rows; the value sums reach the gate's threads through the drained
  // ring, element for element
  const int wg = warp / 4, g = lane / 4, t = lane % 4, tw = threadIdx.x % 128;
  float acc[4 * NT];
  consume<W, NT, SB, kStage, kStages, kLo>(acc, ring, full, empty, n_chunks,
                                           wg * (kABytes / 2));
  float* vals = reinterpret_cast<float*>(ring);  // [4 NT][128]
  consumers_sync();  // every warp is done with the ring
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) vals[e * 128 + tw] = acc[e];
  }
  consumers_sync();
  if (wg == 1) return;
  dep_wait();  // hid may still be read by the kernel ahead
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) {
    const int h = h0 + 16 * warp + g + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * t + (e & 1);
    if (col >= rows) continue;
    const float gate = acc[e] * (gs != nullptr ? gs[h] : 1.f);
    const float val = vals[e * 128 + tw] * (vs != nullptr ? vs[h] : 1.f);
    const float v = gate / (1.f + expf(-gate)) * val;
    const bf16 hv = __float2bfloat16_rn(v);
    hid[static_cast<size_t>(col) * H + h] = hv;
    hid[plane + static_cast<size_t>(col) * H + h] = __float2bfloat16_rn(v - __bfloat162float(hv));
  }
}

// partial[split][n0 + n][c] = Wo[c] . hid[n] over the block's split of H,
// for the block's 128 output rows (hid_map: [2, rows, H], hi and lo). kLo:
// f32 weights under an f32 x, whose lo part enters too.
template <typename W, int NT, bool kLo>
__global__ void __launch_bounds__(kTcThreads, blocks_per_sm<W>())
down_tc(const __grid_constant__ CUtensorMap wo_map, const __grid_constant__ CUtensorMap hid_map,
        float* __restrict__ partial, int N, int n0, int rows, int C, int H) {
  constexpr int kStage = stage_bytes<W, NT, 2>(), kStages = n_stages<W, NT, 2>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  uint64_t *full = bars, *empty = bars + kMaxStages;
  unsigned char* ring = align_ring(smem_raw);
  dep_launch();  // the split sum may launch
  init_ring(full, empty, kStages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.y, splits = gridDim.y, c0 = blockIdx.x * kRows;
  const int n128 = H / 128;
  const int k_lo = 128 * (n128 * split / splits), k_hi = 128 * (n128 * (split + 1) / splits);
  const int n_chunks = (k_hi - k_lo) / k_cols<W>();
  if (warp == kWarps) {
    if (lane == 0) {
      const CUtensorMap *mo = &wo_map, *hm = &hid_map;
      produce<kStage, a_bytes<W>(), kStages>(
          ring, full, empty, n_chunks,
          [=](unsigned char* dst, uint64_t* bar, int i) {
#pragma unroll
            for (int b = 0; b < w_boxes<W>(); ++b)
              tma2d(dst + b * kABytes, mo, bar, k_lo + i * k_cols<W>() + b * box_cols<W>(), c0);
          },
          [=](unsigned char* dst, uint64_t* bar, int i) {
            load_b<W, NT, 2>(dst, hm, bar, k_lo + i * k_cols<W>());
          });
    }
    return;
  }
  // warpgroup wg: rows [64 wg, 64 wg + 64) of the block's 128
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  float acc[4 * NT];
  // Nothing to do before the gate/value pass has finished (its hidden is
  // the N operand): wait in hardware, not polling the ring beside a
  // gate/value block on the same SM. The partials, too, may be read until
  // then by the kernel ahead.
  dep_wait();
  consume<W, NT, 2, kStage, kStages, kLo>(acc, ring, full, empty, n_chunks, wg * (kABytes / 2));
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) {
    const int c = c0 + 16 * warp + g + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * t + (e & 1);
    if (col < rows) partial[(static_cast<size_t>(split) * N + n0 + col) * C + c] = acc[e];
  }
}

// out[i] = the sum of partial[s, i] over the splits s in order, times the
// output row's int8 scale (os, or null), in X (f32 with out_f32); i < N * C.
template <typename X>
__global__ void __launch_bounds__(256)
sum_down_splits(const float* __restrict__ partial, const float* __restrict__ os,
                void* __restrict__ out, int out_f32, int splits, int N, int C) {
  dep_wait();
  const int n = N * C, i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) sum += __ldcg(partial + static_cast<size_t>(s) * n + i);
  if (os != nullptr) sum *= os[i % C];
  store_out<X>(out, i, sum, out_f32);
}

// An f32 x as bf16 planes: hi[i] = bf16(x[i]), lo[i] = bf16(x[i] - hi[i]),
// hi at xs, lo at xs + n.
__global__ void __launch_bounds__(256) split_rows(const float* __restrict__ x,
                                                  bf16* __restrict__ xs, int n) {
  dep_launch();
  dep_wait();
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  const bf16 hi = __float2bfloat16_rn(v);
  xs[i] = hi;
  xs[n + i] = __float2bfloat16_rn(v - __bfloat162float(hi));
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

// A tensor map with the 128-byte swizzle over `rank` dims (dims[0] the
// contiguous one, `esize` bytes an element; strides[i] the bytes between
// steps of dims[i + 1]), read in boxes of `box`. Elements outside the
// tensor read as zeros.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
             const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : kErrEncode;
}

// [rows, cols] weights of W read in boxes of box_rows rows x one 128-byte row.
template <typename W>
int weight_map(CUtensorMap* map, const void* w, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(W)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols<W>()),
                             static_cast<cuuint32_t>(box_rows)};
  const CUtensorMapDataType type = std::is_same<W, bf16>::value  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : std::is_same<W, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                                   : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return make_map(map, type, 2, w, dims, strides, box);
}

// bf16 planes [planes][rows][cols] (planes plane_bytes apart) read in boxes
// of 64 columns x box_rows rows x one plane.
int plane_map(CUtensorMap* map, const bf16* base, int planes, int rows, int cols,
              size_t plane_bytes, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2, plane_bytes};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box);
}

// Launch `kernel` on `grid` with programmatic stream serialization.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                       cudaStream_t s, Args... args) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Opts `kernel` into `smem` bytes of dynamic shared memory, once a process
// and device (bit d of `done` for device d < 64), not on every call: the
// host calls the launch chain 16 times a frame.
template <auto kernel>
cudaError_t allow_smem(int smem) {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// One launch chain's two passes over rows [n0, n0 + rows) of N (rows <= 64,
// NT n-tiles of 8 columns): the N operand's maps cover those rows only.
template <typename W, int NT>
cudaError_t tc_chain(const CUtensorMap& wg_map, const CUtensorMap& wv_map,
                     const CUtensorMap& wo_map, const bf16* xb, bool x_split, const float* gs,
                     const float* vs, bf16* hid, float* partial, int splits, int N, int n0,
                     int rows, int C, int H, cudaStream_t s) {
  CUtensorMap x_map, hid_map;
  const int planes = x_split ? 2 : 1;
  const size_t x_plane = static_cast<size_t>(x_split ? N : rows) * C * 2;
  if (int err = plane_map(&x_map, xb + static_cast<size_t>(n0) * C, planes, rows, C, x_plane,
                          8 * NT))
    return static_cast<cudaError_t>(err);
  const size_t h_plane = static_cast<size_t>(N) * H;
  bf16* hid_rows = hid + static_cast<size_t>(n0) * H;
  if (int err = plane_map(&hid_map, hid_rows, 2, rows, H, 2 * h_plane, 8 * NT))
    return static_cast<cudaError_t>(err);
  // f32 weights under an f32 x: the down pass takes their lo part too
  constexpr bool kF32 = std::is_same<W, float>::value;
  auto* gv = x_split ? gate_value_tc<W, NT, 2> : gate_value_tc<W, NT, 1>;
  auto* down = x_split ? down_tc<W, NT, kF32> : down_tc<W, NT, false>;
  const int gv_smem = x_split ? tc_smem_bytes<W, NT, 2>() : tc_smem_bytes<W, NT, 1>();
  constexpr int down_smem = tc_smem_bytes<W, NT, 2>();
  cudaError_t e = x_split ? allow_smem<gate_value_tc<W, NT, 2>>(gv_smem)
                          : allow_smem<gate_value_tc<W, NT, 1>>(gv_smem);
  if (e == cudaSuccess)
    e = x_split ? allow_smem<down_tc<W, NT, kF32>>(down_smem)
                : allow_smem<down_tc<W, NT, false>>(down_smem);
  if (e == cudaSuccess)
    e = launch_pdl(gv, dim3(H / kUnits), kTcThreads, gv_smem, s, wg_map, wv_map, x_map, gs, vs,
                   hid_rows, h_plane, rows, C, H);
  if (e == cudaSuccess)
    e = launch_pdl(down, dim3(C / kRows, splits), kTcThreads, down_smem, s, wo_map, hid_map,
                   partial, N, n0, rows, C, H);
  return e;
}

// The tensor-core route. scratch (f32 words): hid [2, N, H] bf16 (N * H
// words), then the split x [2, N, C] bf16 (N * C), then partial [splits, N,
// C] f32.
template <typename X, typename W>
int tc_run(const void* x, const void* wg, const void* wv, const void* wo, const float* gs,
           const float* vs, const float* os, float* scratch, void* out, int out_f32, int N, int C,
           int H, int splits, cudaStream_t s) {
  bf16* hid = reinterpret_cast<bf16*>(scratch);
  bf16* xs = reinterpret_cast<bf16*>(scratch + static_cast<size_t>(N) * H);
  float* partial = scratch + static_cast<size_t>(N) * (H + C);
  CUtensorMap wg_map, wv_map, wo_map;
  if (int err = weight_map<W>(&wg_map, wg, H, C, kUnits)) return err;
  if (int err = weight_map<W>(&wv_map, wv, H, C, kUnits)) return err;
  if (int err = weight_map<W>(&wo_map, wo, C, H, kRows)) return err;
  splits = std::max(1, std::min(splits, H / 128));
  constexpr bool kSplitX = std::is_same<X, float>::value;
  cudaError_t e = cudaSuccess;
  if (kSplitX)
    e = launch_pdl(split_rows, dim3((N * C + 255) / 256), 256, 0, s,
                   static_cast<const float*>(x), xs, N * C);
  const bf16* xb = kSplitX ? xs : static_cast<const bf16*>(x);
  for (int n0 = 0; n0 < N && e == cudaSuccess; n0 += kMaxRows) {
    const int rows = std::min(kMaxRows, N - n0);
    const int nt = rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : 8;
    switch (nt) {
      case 1:
        e = tc_chain<W, 1>(wg_map, wv_map, wo_map, xb, kSplitX, gs, vs, hid, partial, splits, N,
                           n0, rows, C, H, s);
        break;
      case 2:
        e = tc_chain<W, 2>(wg_map, wv_map, wo_map, xb, kSplitX, gs, vs, hid, partial, splits, N,
                           n0, rows, C, H, s);
        break;
      case 4:
        e = tc_chain<W, 4>(wg_map, wv_map, wo_map, xb, kSplitX, gs, vs, hid, partial, splits, N,
                           n0, rows, C, H, s);
        break;
      default:
        e = tc_chain<W, 8>(wg_map, wv_map, wo_map, xb, kSplitX, gs, vs, hid, partial, splits, N,
                           n0, rows, C, H, s);
    }
  }
  if (e == cudaSuccess)
    e = launch_pdl(sum_down_splits<X>, dim3((N * C + 255) / 256), 256, 0, s,
                   static_cast<const float*>(partial), os, out, out_f32, splits, N, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool on_grid(int C, int H) { return C % 128 == 0 && H % 128 == 0; }

}  // namespace

// K4. Shapes (row-major, contiguous, 16-byte aligned): x [N, C] and out
// [N, C], f32 (x_bf16 == 0) or bf16; w_gate, w_val [H, C] and w_out [C, H],
// bf16 (w_bf16 == 1) or f32, read in place and taken in x's dtype (f32
// weights under a bf16 x as bf16(w)). C and H multiples of 8. scratch: N *
// (H + C + splits * C) f32 words; splits: the down pass's parts of H
// (clamped to [1, H / 128]; used with C, H multiples of 128, the
// tensor-core route). The first kernel starts streaming the weights before
// the kernel just ahead in the stream has finished: that kernel must not
// have written them. out_f32: out is f32 whatever x's dtype (a
// tensor-parallel rank's partial, summed over the ranks before it is
// rounded). Returns the cudaGetLastError() status after the launches (or a
// tensor-map error, above 10000).
extern "C" int gating_ffn(const void* x, const void* w_gate, const void* w_val, const void* w_out,
                          void* scratch, void* out, int N, int C, int H, int splits, int x_bf16,
                          int w_bf16, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(scratch);
  if (on_grid(C, H)) {
    if (w_bf16)
      return x_bf16 ? tc_run<bf16, bf16>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                         out, out_f32, N, C, H, splits, s)
                    : tc_run<float, bf16>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                          out, out_f32, N, C, H, splits, s);
    return x_bf16 ? tc_run<bf16, float>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                        out, out_f32, N, C, H, splits, s)
                  : tc_run<float, float>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                         out, out_f32, N, C, H, splits, s);
  }
  if (w_bf16)
    return x_bf16 ? core_run<bf16, bf16>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                         out, out_f32, N, C, H, s)
                  : core_run<float, bf16>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                          out, out_f32, N, C, H, s);
  return x_bf16 ? core_run<bf16, float>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                        out, out_f32, N, C, H, s)
                : core_run<float, float>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, sf,
                                         out, out_f32, N, C, H, s);
}

// K5. As K4 with int8 w_gate, w_val [H, C] and w_out [C, H] and their f32
// row scales gate_scale, val_scale [H] and out_scale [C] (the kernel just
// ahead in the stream must not have written them either).
extern "C" int gating_ffn_int8(const void* x, const void* w_gate, const void* gate_scale,
                               const void* w_val, const void* val_scale, const void* w_out,
                               const void* out_scale, void* scratch, void* out, int N, int C,
                               int H, int splits, int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gs = static_cast<const float*>(gate_scale);
  const float* vs = static_cast<const float*>(val_scale);
  const float* os = static_cast<const float*>(out_scale);
  float* sf = static_cast<float*>(scratch);
  if (on_grid(C, H)) {
    return x_bf16 ? tc_run<bf16, int8_t>(x, w_gate, w_val, w_out, gs, vs, os, sf, out, 0, N, C, H,
                                         splits, s)
                  : tc_run<float, int8_t>(x, w_gate, w_val, w_out, gs, vs, os, sf, out, 0, N, C, H,
                                          splits, s);
  }
  if (x_bf16) return core_run<bf16, int8_t>(x, w_gate, w_val, w_out, gs, vs, os, sf, out, 0, N, C, H, s);
  return core_run<float, int8_t>(x, w_gate, w_val, w_out, gs, vs, os, sf, out, 0, N, C, H, s);
}
