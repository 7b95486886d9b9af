// The backbone's LLaMAMLP at decode size, as one fused gated FFN over N rows:
// out[n] = (silu(Wg . x[n]) * (Wv . x[n])) . Wo^T, with Wg and Wv [H, C] (the
// MLP's fc_1 and fc_2) and Wo [C, H] (its proj), read in place.
//
// Replaces: rstnet_tpu/ops/pallas_ffn.py::gating_ffn_pallas (K4, body
// _ffn_kernel) and ::gating_ffn_pallas_int8 (K5, body _ffn_int8_kernel).
// Same math as the Pallas bodies: x and the weights widened to f32, f32 sums,
// the hidden silu(gate) * val kept in f32, the output cast once to x's
// dtype. K5's weights are int8 with f32 row scales ([H] for gate and value,
// [C] for out); each element is dequantized as float(q) * scale[row] in f32
// before its product, as the Pallas body does (the scale is not factored
// out of the row sums).
//
// What bounds it on the H100: memory bandwidth. At Llama-3.2-1B's MLP
// (C=2048, H=8192) one call reads 3 * C * H weights, 100.7 MB in bf16 (~30 us
// at 3.35 TB/s) or 50.3 MB in int8 (~15 us), and does 2 * N FLOPs per weight:
// far below the ~295 FLOP/byte where the tensor cores would bind, for every
// N <= 64 the route sends.
//
// What the design does about it: the TPU kernel walks blocks of H in order
// on one core and carries the [N, C] sum in VMEM. Blocks on the card run in
// parallel and in no order, so the reduction over H takes a second pass,
// deterministic and without atomics:
// 1. gate_value_kernel: one warp per hidden row h streams Wg[h] and Wv[h]
//    with 16-byte loads by consecutive lanes (8-byte for int8), 256 columns
//    at a time, against the same columns of all N rows of x, which the block
//    stages in shared memory as f32; it keeps the N gate and N value sums in
//    registers and writes hid[n, h] (f32) to a scratch [N, H].
// 2. down_kernel: one warp per output row c streams Wo[c], 512 columns a
//    step (256 with 64 rows in registers), against the same columns of hid,
//    staged the same way, with its N sums in registers.
// The staged tile is as wide as 64 KB of shared memory allows for the rows
// in registers (the whole row of x or hid at N = 1), so a warp crosses few
// barriers, and the staging issues 8 loads a thread at once. Each weight
// element is read from device memory once for N <= 64 (larger N runs in
// chunks of 64 rows); the next columns' weights are loaded while the
// current ones' sums run. Each output element is summed by one warp in a
// fixed order. For N > 1 the time grows by ~20 us a row (PERF.md), far
// beyond the weight bytes: every block stages all N rows of x or hid and
// every warp reads them all from shared memory; which of the two sets the
// time is not measured (no ncu on the card host). Tensor cores (one operand
// tile for many rows), TMA and one persistent launch are later work. The
// first version staged 256 columns at a time behind a barrier, with one
// load in flight a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;  // columns a warp covers with one load a lane: 32 lanes x 8
constexpr int kStageBytes = 64 * 1024;  // the shared-memory tile a block aims for
// weight chunks a down_kernel lane keeps in flight: two, but one with 64
// rows in registers, whose 512-column tiles would not fit kStageBytes
__host__ __device__ constexpr int steps_for(int nb) { return nb >= 64 ? 1 : 2; }

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

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
// multiple of kThreads: thread t stages columns t, t + kThreads, ... of each
// row, and issues 8 loads before its first store, so their latencies overlap.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int width, int c0, int cols,
                                      int nb, float* tile) {
  const int m = cols / kThreads, count = nb * m;  // a thread's elements
  int n = 0, k = 0;  // the row and column block of its next element
  for (int f0 = 0; f0 < count; f0 += 8) {
    float v[8];
    int at[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k * kThreads + threadIdx.x;
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
__global__ void __launch_bounds__(kThreads)
gate_value_kernel(const X* __restrict__ x, const W* __restrict__ wg, const W* __restrict__ wv,
                  const float* __restrict__ gs, const float* __restrict__ vs,
                  float* __restrict__ hid, int N, int C, int H, int tile) {
  extern __shared__ __align__(16) float xs[];  // [NB][tile]
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x * kWarps + threadIdx.x / 32;
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
      load8(wgr, lane, sg, fg);
      load8(wvr, lane, sv, fv);
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
          load8(wgr, cn / 8, sg, ng);
          load8(wvr, cn / 8, sv, nv);
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
__global__ void __launch_bounds__(kThreads)
down_kernel(const float* __restrict__ hid, const W* __restrict__ wo, const float* __restrict__ os,
            X* __restrict__ out, int N, int C, int H, int tile) {
  extern __shared__ __align__(16) float hs[];  // [NB][tile]
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
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
      if (have[u]) load8(wor, u * kChunk / 8 + lane, so, fw[u]);
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
          if (next[u]) load8(wor, hn / 8, so, nw[u]);
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
          if (lane == 0) store(out + static_cast<size_t>(n0 + n) * C + c, sum);
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
int launch(const void* x, const void* wg, const void* wv, const void* wo, const float* gs,
           const float* vs, const float* os, float* hid, void* out, int N, int C, int H,
           cudaStream_t s) {
  const int tile1 = tile_columns(C, NB, kChunk), tile2 = tile_columns(H, NB, steps_for(NB) * kChunk);
  const int smem1 = static_cast<int>(sizeof(float)) * NB * tile1;
  const int smem2 = static_cast<int>(sizeof(float)) * NB * tile2;
  cudaError_t e = cudaSuccess;
  if (smem1 > 48 * 1024)  // above the default limit only by opting in
    e = cudaFuncSetAttribute(gate_value_kernel<X, W, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess && smem2 > 48 * 1024)
    e = cudaFuncSetAttribute(down_kernel<X, W, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  gate_value_kernel<X, W, NB><<<(H + kWarps - 1) / kWarps, kThreads, smem1, s>>>(
      static_cast<const X*>(x), static_cast<const W*>(wg), static_cast<const W*>(wv), gs, vs,
      hid, N, C, H, tile1);
  down_kernel<X, W, NB><<<(C + kWarps - 1) / kWarps, kThreads, smem2, s>>>(
      hid, static_cast<const W*>(wo), os, static_cast<X*>(out), N, C, H, tile2);
  return static_cast<int>(cudaGetLastError());
}

// The register chunk for N rows: 1 (single-row decode), 16, or 64.
template <typename X, typename W>
int run(const void* x, const void* wg, const void* wv, const void* wo, const float* gs,
        const float* vs, const float* os, float* hid, void* out, int N, int C, int H,
        cudaStream_t s) {
  if (N == 1) return launch<1, X, W>(x, wg, wv, wo, gs, vs, os, hid, out, N, C, H, s);
  if (N <= 16) return launch<16, X, W>(x, wg, wv, wo, gs, vs, os, hid, out, N, C, H, s);
  return launch<64, X, W>(x, wg, wv, wo, gs, vs, os, hid, out, N, C, H, s);
}

}  // namespace

// K4. Shapes (row-major, contiguous, 16-byte aligned): x [N, C] and out
// [N, C], f32 (x_bf16 == 0) or bf16; w_gate, w_val [H, C] and w_out [C, H],
// bf16 (w_bf16 == 1) or f32, f32 weights only with f32 x (the wrapper takes
// the weights in x's dtype); hid [N, H] f32 scratch. C and H multiples of 8.
// Returns the cudaGetLastError() status after the launches.
extern "C" int gating_ffn(const void* x, const void* w_gate, const void* w_val, const void* w_out,
                          void* hid, void* out, int N, int C, int H, int x_bf16, int w_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(hid);
  if (x_bf16 && !w_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    return run<bf16, bf16>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, hf, out, N, C, H,
                           s);
  return w_bf16 ? run<float, bf16>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, hf, out, N,
                                   C, H, s)
                : run<float, float>(x, w_gate, w_val, w_out, nullptr, nullptr, nullptr, hf, out,
                                    N, C, H, s);
}

// K5. As K4 with int8 w_gate, w_val [H, C] and w_out [C, H] and their f32
// row scales gate_scale, val_scale [H] and out_scale [C].
extern "C" int gating_ffn_int8(const void* x, const void* w_gate, const void* gate_scale,
                               const void* w_val, const void* val_scale, const void* w_out,
                               const void* out_scale, void* hid, void* out, int N, int C, int H,
                               int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gs = static_cast<const float*>(gate_scale);
  const float* vs = static_cast<const float*>(val_scale);
  const float* os = static_cast<const float*>(out_scale);
  float* hf = static_cast<float*>(hid);
  if (x_bf16) return run<bf16, int8_t>(x, w_gate, w_val, w_out, gs, vs, os, hf, out, N, C, H, s);
  return run<float, int8_t>(x, w_gate, w_val, w_out, gs, vs, os, hf, out, N, C, H, s);
}
