// Residual-VQ encode: nearest-codeword search over Q levels, with the
// residual update and the quantized sum.
//
// Replaces: rstnet_tpu/ops/pallas_rvq.py::rvq_encode_pallas (kernel body
// _rvq_encode_kernel). Same math: per level, dist = ||e||^2 - 2 r.e in true
// fp32 (FMA, never TF32), argmin with the lowest index winning ties, gather
// the winner, residual -= e, quant += e.
//
// What bounds it on the H100: at Mimi's shapes (D=256, K=2048, Q=7) a level
// is N*K*D fp32 FMAs against a 2 MB codebook. Large N is bound by fp32 FMA
// issue and shared-memory bandwidth. The streaming case (N=1, one 80 ms
// frame) is bound by how many SMs read the 2 MB of each level: one SM alone
// takes about 0.2 ms a level.
//
// What the design does about it, in two paths, chosen by the caller (the
// wrapper picks from N):
// - tiled (one launch): each block owns a tile of kRows
//   residual rows, kept in shared memory for the whole level sweep (with the
//   running quantized sum), so residuals never go back to device memory
//   between levels. Each level's codebook streams through shared memory in
//   tiles of kTileK codewords; a thread owns one codeword of the tile against
//   kRowsPerThread rows, so each codeword float4 read from shared memory feeds
//   kRowsPerThread FMAs x4. Row padding of 4 floats keeps the float4 reads of
//   a quarter-warp on distinct banks. ||e||^2 per codeword is a separate small
//   warp-per-codeword kernel.
// - split over K (2 launches a level, N <= kSplitMaxRows): for a few rows a
//   row tile cannot fill the card, so each level's codebook is split across
//   K/16 blocks (128 at Mimi's K), a warp per codeword with the lanes
//   splitting D, every row in shared memory, scored in register chunks of
//   kSmallRows rows. Each block writes its best (distance, index) per row; a
//   second kernel picks the winner across blocks and updates the residual
//   and the quantized sum in device memory for the next level.
// Both paths visit codewords in increasing order with a strict '<' and break
// equal distances by index wherever partial results merge, so the lowest
// index wins a tie. Later work: cp.async double-buffering of the tiled path,
// and one launch a level for the split path.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;          // residual rows per block
constexpr int kTileK = 64;         // codewords per shared-memory tile
constexpr int kRowsPerThread = 4;  // rows each thread scores per codeword
constexpr int kThreads = kTileK * (kRows / kRowsPerThread);  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;            // floats of padding per shared row

constexpr int kSmallRows = 8;      // rows the split path scores per register chunk
constexpr int kSplitMaxRows = 64;  // most rows the split path takes
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kCodesPerWarp = 2;
constexpr int kCodesPerBlock = kSplitWarps * kCodesPerWarp;  // 16

int split_blocks(int K) { return (K + kCodesPerBlock - 1) / kCodesPerBlock; }

__global__ void codeword_sq_norms(const float* __restrict__ cb, float* __restrict__ esq,
                                  int QK, int D) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= QK) return;  // uniform across the warp
  const float* e = cb + static_cast<size_t>(warp) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(e[d], e[d], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) esq[warp] = s;
}

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kThreads)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ esq, int* __restrict__ codes,
                  float* __restrict__ quant, int N, int D, int Q, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = D + kPad;       // floats per shared row (multiple of 4)
  const int D4 = D / 4;
  float* res = smem;                 // [kRows][stride] residual
  float* acc = res + kRows * stride; // [kRows][stride] quantized sum
  float* tile = acc + kRows * stride;  // [kTileK][stride] codewords
  __shared__ float red_d[kWarps][kRowsPerThread];
  __shared__ int red_i[kWarps][kRowsPerThread];
  __shared__ int best_idx[kRows];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * kRows;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < kRows * D4; i += kThreads) {
    const int r = i / D4, c = i % D4;
    float4 v = zero4;
    if (row0 + r < N) v = reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * D)[c];
    reinterpret_cast<float4*>(res + r * stride)[c] = v;
    reinterpret_cast<float4*>(acc + r * stride)[c] = zero4;
  }

  const int c_local = tid % kTileK;               // this thread's codeword in a tile
  const int r_base = (tid / kTileK) * kRowsPerThread;  // its first row
  const bool rows_active = row0 + r_base < N;

  for (int q = 0; q < Q; ++q) {
    const float* cbq = cb + static_cast<size_t>(q) * K * D;
    const float* esq_q = esq + static_cast<size_t>(q) * K;
    float best_d[kRowsPerThread];
    int best_i[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      best_d[j] = INFINITY;
      best_i[j] = K;
    }
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int nk = min(kTileK, K - k0);
      __syncthreads();  // the previous tile is consumed; residual updates are visible
      for (int i = tid; i < kTileK * D4; i += kThreads) {
        const int kk = i / D4, c = i % D4;
        float4 v = zero4;
        if (kk < nk) v = reinterpret_cast<const float4*>(cbq + static_cast<size_t>(k0 + kk) * D)[c];
        reinterpret_cast<float4*>(tile + kk * stride)[c] = v;
      }
      __syncthreads();
      if (rows_active && c_local < nk) {
        float dot[kRowsPerThread];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) dot[j] = 0.f;
        const float4* e4 = reinterpret_cast<const float4*>(tile + c_local * stride);
        for (int c = 0; c < D4; ++c) {
          const float4 e = e4[c];
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            const float4 r = reinterpret_cast<const float4*>(res + (r_base + j) * stride)[c];
            dot[j] = fmaf(r.x, e.x, dot[j]);
            dot[j] = fmaf(r.y, e.y, dot[j]);
            dot[j] = fmaf(r.z, e.z, dot[j]);
            dot[j] = fmaf(r.w, e.w, dot[j]);
          }
        }
        const int k = k0 + c_local;
        const float es = esq_q[k];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const float d = es - 2.0f * dot[j];
          if (d < best_d[j]) {
            best_d[j] = d;
            best_i[j] = k;
          }
        }
      }
    }
    // argmin across the threads that share rows: first within each warp ...
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      float d = best_d[j];
      int i = best_i[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, d, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (better(od, oi, d, i)) {
          d = od;
          i = oi;
        }
      }
      if (lane == 0) {
        red_d[warp][j] = d;
        red_i[warp][j] = i;
      }
    }
    __syncthreads();
    // ... then across the warps of one row group
    if (tid < kRows) {
      const int group = tid / kRowsPerThread, j = tid % kRowsPerThread;
      constexpr int kWarpsPerGroup = kTileK / 32;
      float d = red_d[group * kWarpsPerGroup][j];
      int i = red_i[group * kWarpsPerGroup][j];
      for (int w = 1; w < kWarpsPerGroup; ++w) {
        const float od = red_d[group * kWarpsPerGroup + w][j];
        const int oi = red_i[group * kWarpsPerGroup + w][j];
        if (better(od, oi, d, i)) {
          d = od;
          i = oi;
        }
      }
      if (i >= K) i = 0;  // every distance was NaN
      best_idx[tid] = i;
      if (row0 + tid < N) codes[static_cast<size_t>(row0 + tid) * Q + q] = i;
    }
    __syncthreads();
    for (int i = tid; i < kRows * D4; i += kThreads) {
      const int r = i / D4, c = i % D4;
      if (row0 + r >= N) continue;
      const float4 e = reinterpret_cast<const float4*>(cbq + static_cast<size_t>(best_idx[r]) * D)[c];
      float4* rp = reinterpret_cast<float4*>(res + r * stride) + c;
      float4* ap = reinterpret_cast<float4*>(acc + r * stride) + c;
      float4 rv = *rp, av = *ap;
      rv.x -= e.x; rv.y -= e.y; rv.z -= e.z; rv.w -= e.w;
      av.x += e.x; av.y += e.y; av.z += e.z; av.w += e.w;
      *rp = rv;
      *ap = av;
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * D4; i += kThreads) {
    const int r = i / D4, c = i % D4;
    if (row0 + r < N) {
      reinterpret_cast<float4*>(quant + static_cast<size_t>(row0 + r) * D)[c] =
          reinterpret_cast<const float4*>(acc + r * stride)[c];
    }
  }
}

// One level's search for N <= kSplitMaxRows rows, split over K. Block b
// scores codewords [b*kCodesPerBlock, (b+1)*kCodesPerBlock) against every row,
// a warp per codeword with the lanes splitting D, kSmallRows rows at a time,
// and writes its best (distance, index) per row to part_d/part_i
// [gridDim.x][N].
__global__ void __launch_bounds__(kSplitThreads)
rvq_search_split(const float* __restrict__ res, const float* __restrict__ cbq,
                 float* __restrict__ part_d, int* __restrict__ part_i, int N, int D, int K) {
  extern __shared__ float4 rows4[];  // [N][D/4] residual rows
  __shared__ float red_d[kSplitWarps][kSmallRows];
  __shared__ int red_i[kSplitWarps][kSmallRows];
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < N * D4; i += kSplitThreads) {
    rows4[i] = reinterpret_cast<const float4*>(res)[i];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int k_begin = blockIdx.x * kCodesPerBlock + warp * kCodesPerWarp;
  for (int r0 = 0; r0 < N; r0 += kSmallRows) {
    const int nr = min(kSmallRows, N - r0);
    const float4* rows = rows4 + r0 * D4;
    float best_d[kSmallRows];
    int best_i[kSmallRows];
#pragma unroll
    for (int j = 0; j < kSmallRows; ++j) {
      best_d[j] = INFINITY;
      best_i[j] = K;
    }
    for (int c = 0; c < kCodesPerWarp; ++c) {
      const int k = k_begin + c;
      if (k >= K) break;  // uniform across the warp
      const float4* e4 = reinterpret_cast<const float4*>(cbq + static_cast<size_t>(k) * D);
      float esq = 0.f;
      float dot[kSmallRows];
#pragma unroll
      for (int j = 0; j < kSmallRows; ++j) dot[j] = 0.f;
      for (int d = lane; d < D4; d += 32) {
        const float4 e = e4[d];
        esq = fmaf(e.x, e.x, esq);
        esq = fmaf(e.y, e.y, esq);
        esq = fmaf(e.z, e.z, esq);
        esq = fmaf(e.w, e.w, esq);
#pragma unroll
        for (int j = 0; j < kSmallRows; ++j) {
          if (j < nr) {
            const float4 r = rows[j * D4 + d];
            dot[j] = fmaf(r.x, e.x, dot[j]);
            dot[j] = fmaf(r.y, e.y, dot[j]);
            dot[j] = fmaf(r.z, e.z, dot[j]);
            dot[j] = fmaf(r.w, e.w, dot[j]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        esq += __shfl_xor_sync(0xffffffffu, esq, o);
#pragma unroll
        for (int j = 0; j < kSmallRows; ++j) dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
      }
#pragma unroll
      for (int j = 0; j < kSmallRows; ++j) {
        const float dist = esq - 2.0f * dot[j];
        if (j < nr && dist < best_d[j]) {
          best_d[j] = dist;
          best_i[j] = k;
        }
      }
    }
    if (lane == 0) {  // after the butterfly every lane holds the same values
#pragma unroll
      for (int j = 0; j < kSmallRows; ++j) {
        red_d[warp][j] = best_d[j];
        red_i[warp][j] = best_i[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      const int j = threadIdx.x;
      float d = red_d[0][j];
      int i = red_i[0][j];
      for (int w = 1; w < kSplitWarps; ++w) {
        if (better(red_d[w][j], red_i[w][j], d, i)) {
          d = red_d[w][j];
          i = red_i[w][j];
        }
      }
      part_d[blockIdx.x * N + r0 + j] = d;
      part_i[blockIdx.x * N + r0 + j] = i;
    }
    __syncthreads();  // red_d/red_i are reused by the next chunk
  }
}

// Level q's winner for one row (block = row) across the split blocks'
// partials, then res_out = res_in - e and quant (+)= e. res_in is x at the
// first level and res_out otherwise, so no copy of x is needed.
__global__ void __launch_bounds__(kSplitThreads)
rvq_pick_update(const float* __restrict__ part_d, const int* __restrict__ part_i, int splits,
                const float* __restrict__ cbq, const float* res_in, float* res_out,
                float* __restrict__ quant, int* __restrict__ codes, int N, int D, int Q, int K,
                int q) {
  __shared__ float red_d[kSplitWarps];
  __shared__ int red_i[kSplitWarps];
  __shared__ int pick;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float d = INFINITY;
  int i = K;
  for (int s = threadIdx.x; s < splits; s += kSplitThreads) {
    const float od = part_d[s * N + row];
    const int oi = part_i[s * N + row];
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
  if (lane == 0) {
    red_d[warp] = d;
    red_i[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSplitWarps; ++w) {
      if (better(red_d[w], red_i[w], d, i)) {
        d = red_d[w];
        i = red_i[w];
      }
    }
    if (i >= K) i = 0;  // every distance was NaN
    pick = i;
    codes[static_cast<size_t>(row) * Q + q] = i;
  }
  __syncthreads();
  const float* e = cbq + static_cast<size_t>(pick) * D;
  const size_t base = static_cast<size_t>(row) * D;
  for (int c = threadIdx.x; c < D; c += kSplitThreads) {
    const float ev = e[c];
    res_out[base + c] = res_in[base + c] - ev;
    quant[base + c] = q == 0 ? ev : quant[base + c] + ev;
  }
}

}  // namespace

// Floats of scratch that rvq_encode needs for these sizes and path.
extern "C" long long rvq_encode_scratch_floats(int N, int D, int Q, int K, int split) {
  if (split) return static_cast<long long>(N) * D + 2LL * split_blocks(K) * N;
  return static_cast<long long>(Q) * K;
}

// x [N, D] f32, codebooks [Q, K, D] f32 -> codes [N, Q] int32, quant [N, D]
// f32; scratch holds rvq_encode_scratch_floats(N, D, Q, K, split) floats.
// split != 0 takes the split-over-K path (N <= kSplitMaxRows), else the tiled
// one. N >= 1, D % 4 == 0, D <= 512; all pointers 16-byte aligned. Returns
// the cudaGetLastError() status.
extern "C" int rvq_encode(const void* x, const void* codebooks, void* codes, void* quant,
                          void* scratch, int N, int D, int Q, int K, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cb = static_cast<const float*>(codebooks);
  float* work = static_cast<float*>(scratch);
  if (split) {
    if (N > kSplitMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    const int splits = split_blocks(K);
    float* res = work;  // [N, D]
    float* part_d = res + static_cast<size_t>(N) * D;  // [splits, N]
    int* part_i = reinterpret_cast<int*>(part_d + static_cast<size_t>(splits) * N);
    const size_t smem = static_cast<size_t>(N) * D * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          rvq_search_split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int q = 0; q < Q; ++q) {
      const float* cbq = cb + static_cast<size_t>(q) * K * D;
      const float* res_in = q == 0 ? xf : res;
      rvq_search_split<<<splits, kSplitThreads, smem, s>>>(res_in, cbq, part_d, part_i, N, D, K);
      rvq_pick_update<<<N, kSplitThreads, 0, s>>>(part_d, part_i, splits, cbq, res_in, res,
                                                 static_cast<float*>(quant),
                                                 static_cast<int*>(codes), N, D, Q, K, q);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int QK = Q * K;
  codeword_sq_norms<<<(QK + 7) / 8, 256, 0, s>>>(cb, work, QK, D);
  const size_t smem = static_cast<size_t>(2 * kRows + kTileK) * (D + kPad) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rvq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rvq_encode_kernel<<<(N + kRows - 1) / kRows, kThreads, smem, s>>>(
      xf, cb, work, static_cast<int*>(codes), static_cast<float*>(quant), N, D, Q, K);
  return static_cast<int>(cudaGetLastError());
}
