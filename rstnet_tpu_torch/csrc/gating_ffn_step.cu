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
// would bind for every B the batcher uses: ~5.2 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel walks blocks of H in order on
// one core and carries the [B, C] sum in VMEM. Blocks on the card run in
// parallel and in no order, so the reduction over H takes a second pass,
// deterministic and without atomics:
// 1. gate_value_kernel: a grid over the H hidden rows, one warp per row h,
//    which streams gate row h and value row H+h with 16-byte loads by
//    consecutive lanes against kChunk rows of x at a time (x is small and
//    stays in L1/L2), and writes hid[b, h] (f32) to a scratch [B, H].
// 2. down_kernel: a grid over the C output rows, one warp per row c, each a
//    dot over H of Wo[c] with kChunk rows of hid at a time.
// Each output element is summed by one warp in a fixed order. The rows'
// accumulators live in registers, kChunk at a time, so any B works; for
// B > kChunk the weight rows are read again per chunk, from L2. The first
// version staged the x and hid chunks in shared memory, and its staging loop
// of dependent loads set its time (PERF.md). Tensor-core tiles for large B,
// TMA pipelining and weight reuse across the two passes are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;  // rows of x (pass 1) or hid (pass 2) per register pass

using bf16 = __nv_bfloat16;

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

}  // namespace

// Shapes (row-major, contiguous, 16-byte aligned): x [B, C] and out [B, C],
// f32 (x_bf16 == 0) or bf16; w_in [2H, C] (gate rows, then value rows) and
// w_out [C, H], f32 (w_bf16 == 0) or bf16, the step's slices; hid [B, H] f32
// scratch. C and H multiples of 8. Returns the cudaGetLastError() status
// after the launches.
extern "C" int gating_ffn_step(const void* x, const void* w_in, const void* w_out, void* hid,
                               void* out, int B, int C, int H, int x_bf16, int w_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(hid);
  if (x_bf16) {
    return w_bf16 ? run<bf16, bf16>(x, w_in, w_out, hf, out, B, C, H, s)
                  : run<bf16, float>(x, w_in, w_out, hf, out, B, C, H, s);
  }
  return w_bf16 ? run<float, bf16>(x, w_in, w_out, hf, out, B, C, H, s)
                : run<float, float>(x, w_in, w_out, hf, out, B, C, H, s);
}
