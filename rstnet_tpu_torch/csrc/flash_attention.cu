// Flash attention for the backbone's training forwards, forward and backward
// (K6): causal or local-window softmax attention over one head at a time,
// O = softmax(mask(Q K^T)) V, with the per-row log-sum-exp kept for the
// backward.
//
// Replaces: rstnet_tpu/ops/flash_attention.py::flash_attention, which calls
// jax's Pallas splash kernel (make_splash_mha, CausalMask or LocalMask with
// window (context - 1, 0)) and its custom VJP, whose backward is two Pallas
// kernels of its own (dQ, and dK/dV). Same contract: Q arrives pre-scaled in
// its own dtype (the wrapper does q * scale), K/V arrive with their GQA
// groups already repeated to the query heads, and key j is visible to query
// i iff 0 <= i - j < window (window = context if context < T, else T).
//
// Kernels (one block of 4 warps per 64-row tile of one (batch, head); T a
// multiple of 64, head dim 64):
// 1. flash_fwd_kernel: one block per query tile. It streams the key tiles
//    that the mask leaves non-empty (tiles wholly outside the causal band or
//    the window are never read, as splash skips its empty blocks), keeps an
//    online float32 softmax, and writes O in Q's dtype and LSE in float32.
// 2. flash_bwd_dq_kernel: one block per query tile, iterating over key tiles.
//    It first computes delta = rowsum(dO * O) for its rows (written out for
//    kernel 3), then dQ = sum_j dS K with P = exp(S - LSE) and
//    dS = P * (dP - delta), dP = dO V^T.
// 3. flash_bwd_dkv_kernel: one block per key tile, iterating over query
//    tiles: dV = sum_i P^T dO, dK = sum_i dS^T Q.
// Every output element is summed by one warp in a fixed order: the backward
// is deterministic and uses no atomics (splash's split of the backward).
//
// Tensor cores: every product is mma.sync.m16n8k16 with bf16 operands and
// float32 accumulation, each warp owning 16 rows of its block's tile. The
// probability and dS tiles go from the accumulator registers straight into
// the A operand of the next product (the C and A fragment layouts line up).
// float32 inputs (the f32 trainer) run the same kernels with every operand
// split in two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), and three
// products per tile (hi.hi + hi.lo + lo.hi): about float32 accuracy.
//
// What bounds it on the H100: operations. At the training shapes (T=1024,
// D=64, causal) the forward does ~4 * D FLOPs per visible (query, key) pair
// against 8 bytes per row of Q, K, V and O. This first version is simple:
// tiles are staged through shared memory with plain loads and read by
// scalar shared-memory loads, one tile at a time, so latency, not the tensor
// cores, sets its time (PERF.md). wgmma, TMA pipelining, warp
// specialisation and GQA inside the kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kWarps = 4;       // 16 tile rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kD + 8; // bf16 elements per shared-memory row (no bank conflicts)
constexpr float kNegInf = -INFINITY;

// A [kTile][kStride] bf16 tile; P = 2 parts (hi, lo) for float32 inputs.
using Tile = bf16[kTile][kStride];
constexpr int kTileBytes = kTile * kStride * 2;

template <typename T> struct Parts { static constexpr int value = 1; };
template <> struct Parts<float> { static constexpr int value = 2; };

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (x0, x1) as bf16 pairs: part 0 the rounded values, part 1 (P == 2) the
// rounding remainders.
template <int P>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&r)[P]) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  r[0] = pack2(h0, h1);
  if constexpr (P == 2) {
    r[1] = pack2(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b over the parts: hi.hi, then hi.lo and lo.hi for split operands.
template <int P>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[P][4],
                                    const uint32_t (&b)[P][2]) {
  mma_bf16(c, a[0], b[0]);
  if constexpr (P == 2) {
    mma_bf16(c, a[0], b[1]);
    mma_bf16(c, a[1], b[0]);
  }
}

__device__ __forceinline__ uint32_t lds32(const Tile& t, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(&t[r][c]);
}

// A operand (16 x 16, row-major) from tile rows [r0, r0 + 16), columns
// [c0, c0 + 16).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[P][4], const Tile* t, int r0, int c0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p][0] = lds32(t[p], r0 + g, c0 + 2 * tig);
    a[p][1] = lds32(t[p], r0 + g + 8, c0 + 2 * tig);
    a[p][2] = lds32(t[p], r0 + g, c0 + 2 * tig + 8);
    a[p][3] = lds32(t[p], r0 + g + 8, c0 + 2 * tig + 8);
  }
}

// B operand (16 x 8) with B[k][n] = tile[n0 + n][k0 + k]: a product with the
// tile's transpose (Q K^T, dO V^T, K Q^T, V dO^T).
template <int P>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[P][2], const Tile* t, int n0, int k0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b[p][0] = lds32(t[p], n0 + g, k0 + 2 * tig);
    b[p][1] = lds32(t[p], n0 + g, k0 + 2 * tig + 8);
  }
}

// B operand (16 x 8) with B[k][n] = tile[k0 + k][n0 + n]: a product with the
// tile itself (P V, dS K, P^T dO, dS^T Q).
template <int P>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[P][2], const Tile* t, int k0, int n0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b[p][0] = pack2(t[p][k0 + 2 * tig][n0 + g], t[p][k0 + 2 * tig + 1][n0 + g]);
    b[p][1] = pack2(t[p][k0 + 2 * tig + 8][n0 + g], t[p][k0 + 2 * tig + 9][n0 + g]);
  }
}

// A operand for k-step kk from a 16 x 64 accumulator tile held as 8
// n-tiles of 16 x 8 (the mma C layout): n-tiles 2kk and 2kk + 1.
template <int P>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[P][4], const float (&c)[8][4], int kk) {
  uint32_t r[P];
  split2<P>(c[2 * kk][0], c[2 * kk][1], r);
#pragma unroll
  for (int p = 0; p < P; ++p) a[p][0] = r[p];
  split2<P>(c[2 * kk][2], c[2 * kk][3], r);
#pragma unroll
  for (int p = 0; p < P; ++p) a[p][1] = r[p];
  split2<P>(c[2 * kk + 1][0], c[2 * kk + 1][1], r);
#pragma unroll
  for (int p = 0; p < P; ++p) a[p][2] = r[p];
  split2<P>(c[2 * kk + 1][2], c[2 * kk + 1][3], r);
#pragma unroll
  for (int p = 0; p < P; ++p) a[p][3] = r[p];
}

// Rows [0, kTile) x [0, kD) of a row-major [*, kD] matrix into a tile.
__device__ __forceinline__ void load_tile(Tile* t, const bf16* __restrict__ src) {
  for (int i = threadIdx.x; i < kTile * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(&t[0][r][c]) =
        __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kD + c));
  }
}

__device__ __forceinline__ void load_tile(Tile* t, const float* __restrict__ src) {
  for (int i = threadIdx.x; i < kTile * kD / 4; i += kThreads) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    const float4 x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * kD + c));
    uint32_t xy[2], zw[2];  // [0] rounded pair, [1] remainder pair
    split2<2>(x.x, x.y, xy);
    split2<2>(x.z, x.w, zw);
    *reinterpret_cast<uint2*>(&t[0][r][c]) = make_uint2(xy[0], zw[0]);
    *reinterpret_cast<uint2*>(&t[1][r][c]) = make_uint2(xy[1], zw[1]);
  }
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

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

__device__ __forceinline__ bool visible(int i, int j, int window) {
  const int d = i - j;
  return d >= 0 && d < window;
}

// First key tile that any row of the query tile at q0 can see.
__device__ __forceinline__ int first_key_tile(int q0, int window) {
  const int lo = q0 - window + 1;
  return lo <= 0 ? 0 : (lo / kTile) * kTile;
}

// Column of accumulator element e (0..3) of n-tile nt; elements 0, 1 are in
// the warp's row g, elements 2, 3 in row g + 8.
__device__ __forceinline__ int acc_col(int nt, int e) { return nt * 8 + 2 * (threadIdx.x % 4) + (e & 1); }

// S (16 x 64 per warp) = A-tile rows [r0, r0 + 16) times B-tile rows^T.
template <int P>
__device__ __forceinline__ void tile_product_t(float (&s)[8][4], const Tile* a_tile, int r0,
                                               const Tile* b_tile) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[P][4];
    load_a<P>(a, a_tile, r0, kk * 16);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[P][2];
      load_b_rows<P>(b, b_tile, nt * 8, kk * 16);
      mma<P>(s[nt], a, b);
    }
  }
}

// acc (16 x 64) += c (16 x 64, registers) times B-tile (64 x 64).
template <int P>
__device__ __forceinline__ void acc_product(float (&acc)[8][4], const float (&c)[8][4],
                                            const Tile* b_tile) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[P][4];
    acc_to_a<P>(a, c, kk);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[P][2];
      load_b_cols<P>(b, b_tile, kk * 16, nt * 8);
      mma<P>(acc[nt], a, b);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq, int window) {
  constexpr int P = Parts<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* sQ = reinterpret_cast<Tile*>(smem);
  Tile* sK = sQ + P;
  Tile* sV = sK + P;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile(sQ, q + base + static_cast<size_t>(q0) * kD);
  float acc[8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = first_key_tile(q0, window); k0 <= q0; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sK, k + base + static_cast<size_t>(k0) * kD);
    load_tile(sV, v + base + static_cast<size_t>(k0) * kD);
    __syncthreads();
    float s[8][4];
    tile_product_t<P>(s, sQ, warp * 16, sK);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!visible(rows[e >> 1], k0 + acc_col(nt, e), window)) s[nt][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float base_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      base_m[r] = m_new == kNegInf ? 0.f : m_new;  // a row with nothing visible yet
      const float alpha = expf(m[r] - base_m[r]);
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - base_m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    acc_product<P>(acc, s, sV);
  }

  const int tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(l[r]);
    const float inv = 1.f / total;
    T* orow = o + base + static_cast<size_t>(rows[r]) * kD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) store2(orow + nt * 8 + 2 * tig, acc[nt][2 * r] * inv,
                                          acc[nt][2 * r + 1] * inv);
    if (tig == 0) lse[static_cast<size_t>(blockIdx.y) * seq + rows[r]] = m[r] + logf(total);
  }
}

// Shared memory of the backward kernels: four tiles, then two float vectors
// (LSE and delta of the current query tile).
template <int P>
constexpr int bwd_smem_bytes() { return 4 * P * kTileBytes + 2 * kTile * 4; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int seq, int window) {
  constexpr int P = Parts<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* sQ = reinterpret_cast<Tile*>(smem);
  Tile* sdO = sQ + P;
  Tile* sK = sdO + P;
  Tile* sV = sK + P;
  float* sLse = reinterpret_cast<float*>(sV + P);
  float* sDelta = sLse + kTile;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kD;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;

  load_tile(sQ, q + base + static_cast<size_t>(q0) * kD);
  load_tile(sdO, dout + base + static_cast<size_t>(q0) * kD);
  // delta = rowsum(dO * O) in float32 from the stored values, a warp a row
  for (int r = warp; r < kTile; r += kWarps) {
    const size_t off = base + static_cast<size_t>(q0 + r) * kD;
    float sum = 0.f;
    for (int c = lane; c < kD; c += 32) sum += to_f32(dout[off + c]) * to_f32(o[off + c]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (lane == 0) {
      sDelta[r] = sum;
      delta[rbase + q0 + r] = sum;
      sLse[r] = lse[rbase + q0 + r];
    }
  }
  __syncthreads();
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = first_key_tile(q0, window); k0 <= q0; k0 += kTile) {
    __syncthreads();
    load_tile(sK, k + base + static_cast<size_t>(k0) * kD);
    load_tile(sV, v + base + static_cast<size_t>(k0) * kD);
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_product_t<P>(s, sQ, warp * 16, sK);
    tile_product_t<P>(dp, sdO, warp * 16, sV);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = lrow[e >> 1];
        const float p = visible(q0 + lr, k0 + acc_col(nt, e), window)
                            ? expf(s[nt][e] - sLse[lr]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - sDelta[lr]);  // dS
      }
    acc_product<P>(acc, s, sK);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = dq + base + static_cast<size_t>(q0 + lrow[r]) * kD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) store2(row + nt * 8 + 2 * tig, acc[nt][2 * r],
                                          acc[nt][2 * r + 1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq, int window) {
  constexpr int P = Parts<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* sK = reinterpret_cast<Tile*>(smem);
  Tile* sV = sK + P;
  Tile* sQ = sV + P;
  Tile* sdO = sQ + P;
  float* sLse = reinterpret_cast<float*>(sdO + P);
  float* sDelta = sLse + kTile;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kD;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile(sK, k + base + static_cast<size_t>(k0) * kD);
  load_tile(sV, v + base + static_cast<size_t>(k0) * kD);
  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;

  // last query tile that sees a key of this tile: i <= k0 + kTile - 1 + window - 1
  const int q_last = min(seq - kTile, ((k0 + kTile + window - 2) / kTile) * kTile);
  for (int q0 = k0; q0 <= q_last; q0 += kTile) {
    __syncthreads();
    load_tile(sQ, q + base + static_cast<size_t>(q0) * kD);
    load_tile(sdO, dout + base + static_cast<size_t>(q0) * kD);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      sLse[i] = lse[rbase + q0 + i];
      sDelta[i] = delta[rbase + q0 + i];
    }
    __syncthreads();
    // transposed tiles: rows are this warp's keys, columns the tile's queries
    float s[8][4], dp[8][4];
    tile_product_t<P>(s, sK, warp * 16, sQ);
    tile_product_t<P>(dp, sV, warp * 16, sdO);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = acc_col(nt, e);
        const float p = visible(q0 + qc, krow[e >> 1], window)
                            ? expf(s[nt][e] - sLse[qc]) : 0.f;
        s[nt][e] = p;                             // P^T
        dp[nt][e] = p * (dp[nt][e] - sDelta[qc]);  // dS^T
      }
    acc_product<P>(acc_v, s, sdO);
    acc_product<P>(acc_k, dp, sQ);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = base + static_cast<size_t>(krow[r]) * kD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      store2(dk + off + nt * 8 + 2 * tig, acc_k[nt][2 * r], acc_k[nt][2 * r + 1]);
      store2(dv + off + nt * 8 + 2 * tig, acc_v[nt][2 * r], acc_v[nt][2 * r + 1]);
    }
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int seq,
        int window, cudaStream_t s) {
  constexpr int bytes = 3 * Parts<T>::value * kTileBytes;
  if (int err = set_smem(flash_fwd_kernel<T>, bytes)) return err;
  flash_fwd_kernel<T><<<dim3(seq / kTile, bh), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int bh, int seq, int window,
           cudaStream_t s) {
  constexpr int bytes = bwd_smem_bytes<Parts<T>::value>();
  if (int err = set_smem(flash_bwd_dq_kernel<T>, bytes)) return err;
  flash_bwd_dq_kernel<T><<<dim3(seq / kTile, bh), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      seq, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, int bh, int seq, int window,
            cudaStream_t s) {
  constexpr int bytes = bwd_smem_bytes<Parts<T>::value>();
  if (int err = set_smem(flash_bwd_dkv_kernel<T>, bytes)) return err;
  flash_bwd_dkv_kernel<T><<<dim3(seq / kTile, bh), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes (row-major, contiguous, 16-byte aligned): q, k, v, o, dout, dq, dk,
// dv [bh, seq, 64] in bf16 (is_f32 == 0) or float32; lse and delta
// [bh, seq] float32. q is pre-scaled; k and v have q's head count. seq a
// multiple of 64, 1 <= window. Each returns the cudaGetLastError() status
// after its one launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int seq, int window, int is_f32,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_f32 ? fwd<float>(q, k, v, o, l, bh, seq, window, s)
                : fwd<bf16>(q, k, v, o, l, bh, seq, window, s);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* delta, void* dq,
                                      int bh, int seq, int window, int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  return is_f32 ? bwd_dq<float>(q, k, v, o, dout, l, d, dq, bh, seq, window, s)
                : bwd_dq<bf16>(q, k, v, o, dout, l, d, dq, bh, seq, window, s);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int seq, int window,
                                       int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  return is_f32 ? bwd_dkv<float>(q, k, v, dout, l, d, dk, dv, bh, seq, window, s)
                : bwd_dkv<bf16>(q, k, v, dout, l, d, dk, dv, bh, seq, window, s);
}
