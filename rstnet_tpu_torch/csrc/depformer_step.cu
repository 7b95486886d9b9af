// One depformer micro-step: every layer of the depth transformer plus the
// audio head for codebook `cb`, at batch 1.
//
// Replaces: rstnet_tpu/ops/pallas_depformer.py::depformer_step_pallas
// (kernel body _dep_step_kernel), bf16 variant. Same math: per layer,
// RMSNorm (f32) -> QKV GEMV on the (layer, cb) weight slice -> K/V row cb
// written into the per-frame [L, S, C] cache -> causal softmax over cache
// rows <= cb (the new row taken in f32) -> out-proj GEMV + residual ->
// RMSNorm -> gate/value GEMV with SiLU gating -> down GEMV + residual; then
// the head GEMV for codebook cb plus its bias. GEMV inputs are bf16 with f32
// accumulation; norms, softmax and the residual stream are f32.
//
// What bounds it on the H100: memory bandwidth. At Moshi 7B's depformer
// (C=1024, L=6, H=2816, card=2048) one micro-step reads about 158 MB of bf16
// weights (25.7 MB per layer + 4 MB of head) and does 2 FLOPs per weight, far
// below the ~295 FLOP/byte where the tensor cores would bind. At 3.35 TB/s
// that is ~47 us per micro-step, 8 micro-steps per frame.
//
// What the design does about it: the TPU kernel walked the layers on one
// core with each (layer, step) slice staged in VMEM; an SM has 227 KB of
// shared memory, so here every GEMV is spread over all SMs instead: one warp
// per output row, 16-byte loads of the bf16 weight row by consecutive lanes,
// the (normalized) input vector staged once per block in shared memory as
// bf16, a warp-shuffle reduction. The micro-step is a chain of
// 1 + 5L + 1 launches on the caller's stream, which orders them:
// (RMSNorm + QKV GEMV + cache write), attention, (out-proj GEMV + residual),
// (RMSNorm + gate/value GEMV + SiLU), (down GEMV + residual), and finally
// the head. Each block recomputes the RMS of the C-wide residual itself,
// which costs a 4 KB read instead of a separate launch. A persistent kernel
// with grid barriers, cp.async/TMA weight pipelining and CUDA graphs are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 8192;  // largest C or H a block stages in shared memory
constexpr int kAttnThreads = 128;
constexpr int kMaxSteps = 32;

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

// Sum over the block; every thread gets the total. `scratch` holds 32 floats.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const float t = lane < static_cast<int>(blockDim.x / 32) ? scratch[lane] : 0.f;
  return warp_sum(t);
}

// dst[i] = bf16(x[i] * (alpha[i] * rsqrt(eps + mean(x^2)))), as the Pallas _rms.
__device__ void rms_norm_to_shared(const float* __restrict__ x, const float* __restrict__ alpha,
                                   float eps, int n, bf16* dst, float* scratch) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ss = fmaf(x[i], x[i], ss);
  const float inv = rsqrtf(eps + block_sum(ss, scratch) / n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __float2bfloat16(x[i] * (alpha[i] * inv));
  __syncthreads();
}

__device__ void to_shared_bf16(const float* __restrict__ x, int n, bf16* dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __float2bfloat16(x[i]);
  __syncthreads();
}

// Warp-cooperative dot of a bf16 weight row (n % 8 == 0, 16-byte aligned)
// with a bf16 vector in shared memory, accumulated in f32. All lanes return it.
__device__ __forceinline__ float warp_dot(const bf16* __restrict__ w, const bf16* v, int n) {
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  const uint4* v4 = reinterpret_cast<const uint4*>(v);
  float acc = 0.f;
  for (int i = threadIdx.x % 32; i < n / 8; i += 32) {
    const uint4 a = __ldg(w4 + i);
    const uint4 b = v4[i];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(a2[j]);
      const float2 fb = __bfloat1622float2(b2[j]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return warp_sum(acc);
}

__global__ void init_residual(const bf16* __restrict__ x, float* __restrict__ xs, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < C) xs[i] = __bfloat162float(x[i]);
}

// qkv = W_in[l, cb] . bf16(rms(xs)); K and V rows also go to cache row cb.
template <typename CacheT>
__global__ void __launch_bounds__(kThreads)
qkv_kernel(const float* __restrict__ xs, const float* __restrict__ alpha, float eps,
           const bf16* __restrict__ w, float* __restrict__ qkv, CacheT* __restrict__ kc_row,
           CacheT* __restrict__ vc_row, int C) {
  __shared__ __align__(16) bf16 h[kMaxDim];
  __shared__ float scratch[32];
  rms_norm_to_shared(xs, alpha, eps, C, h, scratch);
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= 3 * C) return;
  const float y = warp_dot(w + static_cast<size_t>(row) * C, h, C);
  if (threadIdx.x % 32 == 0) {
    qkv[row] = y;
    if (row >= 2 * C) store_f(vc_row + (row - 2 * C), y);
    else if (row >= C) store_f(kc_row + (row - C), y);
  }
}

// One block per head: scores over cache rows s <= cb (row cb from qkv in
// f32), softmax, and the weighted sum of values.
template <typename CacheT>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ qkv, const CacheT* __restrict__ kc,
                 const CacheT* __restrict__ vc, float* __restrict__ attn, int C, int dh,
                 int cb, float scale) {
  __shared__ float p[kMaxSteps];
  __shared__ float scratch[32];
  const int off = blockIdx.x * dh;
  const float* q = qkv + off;
  for (int s = 0; s <= cb; ++s) {
    float part = 0.f;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      const float k = s == cb ? qkv[C + off + d] : load_f(kc + static_cast<size_t>(s) * C + off + d);
      part = fmaf(q[d], k, part);
    }
    const float score = block_sum(part, scratch) * scale;
    if (threadIdx.x == 0) p[s] = score;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = p[0];
    for (int s = 1; s <= cb; ++s) m = fmaxf(m, p[s]);
    float sum = 0.f;
    for (int s = 0; s <= cb; ++s) {
      p[s] = expf(p[s] - m);
      sum += p[s];
    }
    for (int s = 0; s <= cb; ++s) p[s] /= sum;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s <= cb; ++s) {
      const float v = s == cb ? qkv[2 * C + off + d] : load_f(vc + static_cast<size_t>(s) * C + off + d);
      o = fmaf(p[s], v, o);
    }
    attn[off + d] = o;
  }
}

// xs[row] += W[row] . bf16(in)  (out-proj and down projection), W [rows, n].
__global__ void __launch_bounds__(kThreads)
gemv_residual_kernel(const float* __restrict__ in, int n, const bf16* __restrict__ w,
                     float* __restrict__ xs, int rows) {
  __shared__ __align__(16) bf16 v[kMaxDim];
  to_shared_bf16(in, n, v);
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const float y = warp_dot(w + static_cast<size_t>(row) * n, v, n);
  if (threadIdx.x % 32 == 0) xs[row] += y;
}

// hid[j] = silu(gate_j) * val_j with [gate; val] = W_in[l, cb] . bf16(rms(xs)).
__global__ void __launch_bounds__(kThreads)
gating_kernel(const float* __restrict__ xs, const float* __restrict__ alpha, float eps,
              const bf16* __restrict__ w, float* __restrict__ hid, int C, int H) {
  __shared__ __align__(16) bf16 h[kMaxDim];
  __shared__ float scratch[32];
  rms_norm_to_shared(xs, alpha, eps, C, h, scratch);
  const int j = blockIdx.x * kWarps + threadIdx.x / 32;
  if (j >= H) return;
  const float gate = warp_dot(w + static_cast<size_t>(j) * C, h, C);
  const float val = warp_dot(w + static_cast<size_t>(H + j) * C, h, C);
  if (threadIdx.x % 32 == 0) hid[j] = gate / (1.f + expf(-gate)) * val;
}

// logits[row] = W_head[cb, row] . bf16(xs) + b[cb, row].
__global__ void __launch_bounds__(kThreads)
head_kernel(const float* __restrict__ xs, const bf16* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ logits, int C, int card) {
  __shared__ __align__(16) bf16 v[kMaxDim];
  to_shared_bf16(xs, C, v);
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= card) return;
  const float y = warp_dot(w + static_cast<size_t>(row) * C, v, C);
  if (threadIdx.x % 32 == 0) logits[row] = y + bias[row];
}

inline int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

template <typename CacheT>
int run(const bf16* x, const float* norm1, const bf16* in_proj, const bf16* out_proj,
        const float* norm2, const bf16* gin, const bf16* gout, const bf16* head_w,
        const float* head_b, CacheT* kc, CacheT* vc, float* logits, float* xs, float* qkv,
        float* attn, float* hid, int L, int S, int C, int H, int card, int heads, int cb,
        float eps, cudaStream_t s) {
  const int dh = C / heads;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  init_residual<<<(C + 255) / 256, 256, 0, s>>>(x, xs, C);
  for (int l = 0; l < L; ++l) {
    const size_t ls = static_cast<size_t>(l) * S + cb;  // (layer, step) slice index
    CacheT* kc_l = kc + static_cast<size_t>(l) * S * C;
    CacheT* vc_l = vc + static_cast<size_t>(l) * S * C;
    qkv_kernel<CacheT><<<blocks_for(3 * C), kThreads, 0, s>>>(
        xs, norm1 + static_cast<size_t>(l) * C, eps, in_proj + ls * 3 * C * C, qkv,
        kc_l + static_cast<size_t>(cb) * C, vc_l + static_cast<size_t>(cb) * C, C);
    attention_kernel<CacheT><<<heads, kAttnThreads, 0, s>>>(qkv, kc_l, vc_l, attn, C, dh, cb,
                                                            scale);
    gemv_residual_kernel<<<blocks_for(C), kThreads, 0, s>>>(attn, C, out_proj + ls * C * C, xs, C);
    gating_kernel<<<blocks_for(H), kThreads, 0, s>>>(
        xs, norm2 + static_cast<size_t>(l) * C, eps, gin + ls * 2 * H * C, hid, C, H);
    gemv_residual_kernel<<<blocks_for(C), kThreads, 0, s>>>(hid, H, gout + ls * C * H, xs, C);
  }
  head_kernel<<<blocks_for(card), kThreads, 0, s>>>(
      xs, head_w + static_cast<size_t>(cb) * card * C, head_b + static_cast<size_t>(cb) * card,
      logits, C, card);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes (all row-major, contiguous, 16-byte aligned): x [1, C] bf16;
// norm1/norm2 [L, C] f32; in_proj [L, S*3C, C], out_proj [L, S*C, C],
// gin [L, S, 2H, C], gout [L, S, C, H], head_w [S, card, C] bf16; head_b
// [S, card] f32; kc/vc [L, S, C] f32 (cache_bf16 == 0) or bf16, updated at
// row cb in place; logits [card] f32 out; xs [C], qkv [3C], attn [C],
// hid [H] f32 scratch. C, H <= 8192 and multiples of 8; S <= 32.
// Returns the cudaGetLastError() status after the launches.
extern "C" int depformer_step(const void* x, const void* norm1, const void* in_proj,
                              const void* out_proj, const void* norm2, const void* gin,
                              const void* gout, const void* head_w, const void* head_b,
                              void* kc, void* vc, void* logits, void* xs, void* qkv, void* attn,
                              void* hid, int L, int S, int C, int H, int card, int heads, int cb,
                              int cache_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* n1 = static_cast<const float*>(norm1);
  const auto* wi = static_cast<const bf16*>(in_proj);
  const auto* wo = static_cast<const bf16*>(out_proj);
  const auto* n2 = static_cast<const float*>(norm2);
  const auto* gi = static_cast<const bf16*>(gin);
  const auto* go = static_cast<const bf16*>(gout);
  const auto* hw = static_cast<const bf16*>(head_w);
  const auto* hb = static_cast<const float*>(head_b);
  auto* lg = static_cast<float*>(logits);
  auto* xsf = static_cast<float*>(xs);
  auto* qf = static_cast<float*>(qkv);
  auto* af = static_cast<float*>(attn);
  auto* hf = static_cast<float*>(hid);
  if (cache_bf16) {
    return run<bf16>(xb, n1, wi, wo, n2, gi, go, hw, hb, static_cast<bf16*>(kc),
                     static_cast<bf16*>(vc), lg, xsf, qf, af, hf, L, S, C, H, card, heads, cb,
                     eps, s);
  }
  return run<float>(xb, n1, wi, wo, n2, gi, go, hw, hb, static_cast<float*>(kc),
                    static_cast<float*>(vc), lg, xsf, qf, af, hf, L, S, C, H, card, heads, cb,
                    eps, s);
}
