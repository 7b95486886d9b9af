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
// come out at the KV heads, summed over each group inside the kernel.
//
// What bounds it on the H100: operations. At the training shape (B=4, 32
// query heads over 8 KV heads, T=1024, D=64, causal) there are 67.2 M
// visible (query, key) pairs per call. The forward needs 4 D FLOPs a pair
// (Q K^T and P V): 17.2 GFLOP, 0.0174 ms at the bf16 dense peak, against
// ~21 MB of inputs and outputs (0.006 ms at 3.35 TB/s). The backward needs
// 10 D a pair (the five products S, dP, dV, dK, dQ): 0.0435 ms.
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
//    last contributor writes dq in bf16. Items are handed out j-major, so
//    the longest items start first and an item only ever waits on items
//    that were handed out before it: progress does not rest on launch order
//    or residency. Every sum runs in a fixed order, so the results are
//    bit-identical from call to call.
// Measured at the training shape (PERF.md): the forward within 1.1x of
// SDPA, the backward ~5x its bound, set by the elementwise phase between
// the products (both consumer warpgroups run it at once) and the dQ
// handoffs.
// Waits that last seconds can only be faults; they trap instead of hanging.
//
// float32 inputs (the float32 trainer and small slices) run the mma.sync
// kernels below: one block of 4 warps per 64-row tile, every operand split
// into two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), and three products
// per tile (hi.hi + hi.lo + lo.hi): about float32 accuracy. flash_fwd_kernel
// is the forward; flash_bwd_dq_kernel (dQ and delta, over the key tiles) and
// flash_bwd_dkv_kernel (dK and dV, a block per KV head's key tile, over the
// group's query heads and their query tiles) the backward. Tiles are staged
// through shared memory with plain loads, so latency, not the tensor cores,
// sets their time (PERF.md).

#include <cuda.h>
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

// Rows [0, kTile) x [0, kD) of a row-major float32 [*, kD] matrix into a
// split tile.
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
                 T* __restrict__ o, float* __restrict__ lse, int seq, int window, int group) {
  constexpr int P = Parts<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* sQ = reinterpret_cast<Tile*>(smem);
  Tile* sK = sQ + P;
  Tile* sV = sK + P;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kD;
  const size_t kv_base = static_cast<size_t>(blockIdx.y / group) * seq * kD;
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
    load_tile(sK, k + kv_base + static_cast<size_t>(k0) * kD);
    load_tile(sV, v + kv_base + static_cast<size_t>(k0) * kD);
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
                    T* __restrict__ dq, int seq, int window, int group) {
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
  const size_t kv_base = static_cast<size_t>(blockIdx.y / group) * seq * kD;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;

  load_tile(sQ, q + base + static_cast<size_t>(q0) * kD);
  load_tile(sdO, dout + base + static_cast<size_t>(q0) * kD);
  // delta = rowsum(dO * O) in float32 from the stored values, a warp a row
  for (int r = warp; r < kTile; r += kWarps) {
    const size_t off = base + static_cast<size_t>(q0 + r) * kD;
    float sum = 0.f;
    for (int c = lane; c < kD; c += 32) sum += dout[off + c] * o[off + c];
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
    load_tile(sK, k + kv_base + static_cast<size_t>(k0) * kD);
    load_tile(sV, v + kv_base + static_cast<size_t>(k0) * kD);
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
                     int seq, int window, int group) {
  constexpr int P = Parts<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* sK = reinterpret_cast<Tile*>(smem);
  Tile* sV = sK + P;
  Tile* sQ = sV + P;
  Tile* sdO = sQ + P;
  float* sLse = reinterpret_cast<float*>(sdO + P);
  float* sDelta = sLse + kTile;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kD;  // this KV head's rows
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
  // the group's query heads, one after another: dK and dV sum over them here
  for (int qh = 0; qh < group; ++qh)
  for (int q0 = k0; q0 <= q_last; q0 += kTile) {
    const size_t rbase = (static_cast<size_t>(blockIdx.y) * group + qh) * seq;
    const size_t qbase = rbase * kD;
    __syncthreads();
    load_tile(sQ, q + qbase + static_cast<size_t>(q0) * kD);
    load_tile(sdO, dout + qbase + static_cast<size_t>(q0) * kD);
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


// ---------------------------------------------------------------------------
// Hopper kernels (bf16): TMA, mbarriers and wgmma.
// ---------------------------------------------------------------------------

constexpr int kRowBytes = kD * 2;       // one 64-wide bf16 row: 128 B, one 128-byte swizzle row
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

// TMA: a [rows, 64] box of a 2-D bf16 tensor map at (0, row) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row)
      : "memory");
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
constexpr int kFwdKeys = 128;   // keys of a K/V tile
constexpr int kFwdStages = 4;

struct FwdSmem {
  bf16 q[2][kFwdRows * kD];  // double-buffered: the next tile's Q loads during this one
  bf16 k[kFwdStages][kFwdKeys * kD];
  bf16 v[kFwdStages][kFwdKeys * kD];
  // K and V are separate rings: S needs only K, and K's slot frees up as
  // soon as S is done
  uint64_t q_full[2], q_empty[2], k_full[kFwdStages], k_empty[kFwdStages], v_full[kFwdStages],
      v_empty[kFwdStages];
};
constexpr int kFwdSmemBytes = sizeof(FwdSmem) + 1024;  // + alignment slack

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023);
  return reinterpret_cast<unsigned char*>(a);
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// The forward's work tiles, longest first: tile w is query tile
// n_qt - 1 - w / bh_count of batch x head w % bh_count. Block b takes the
// tiles of rounds r = 0, 1, ... at r G + b, snaking (G - 1 - b on odd
// rounds) so that the long and the short tiles of each round even out.
struct FwdWork {
  int bh_count, n_qt, seq, window, group;
  __device__ int count() const { return bh_count * n_qt; }
  __device__ int tile(int round) const {
    const int g = gridDim.x, b = blockIdx.x;
    return round * g + ((round & 1) ? g - 1 - b : b);
  }
  __device__ int qt(int w) const { return n_qt - 1 - w / bh_count; }
  __device__ int bh(int w) const { return w % bh_count; }
  __device__ int j_lo(int w) const { return max(0, qt(w) * kFwdRows - window + 1) / kFwdKeys; }
  // the key tiles a work tile sees; the last holds the diagonal
  __device__ int n_tiles(int w) const { return qt(w) - j_lo(w) + 1; }
};

// One step of the online softmax over a 64 x 128 score tile, in base 2 (q
// is pre-scaled, so log2(e) is the only factor): masks when asked, updates
// the running max m and sum l, returns each row's rescale factor for O in
// alpha, and P as bf16 A operands.
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&p)[8][4], bool masked,
                                             int row0, int k0, int window) {
  if (masked) {
#pragma unroll
    for (int e = 0; e < 64; ++e)
      if (!sees(row0 + acc_row(e), k0 + acc_col(e), window)) sc[e] = -INFINITY;
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx) * kLog2e);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
    alpha[r] = fast_exp2(m[r] - base[r]);
    l[r] *= alpha[r];
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    sc[e] = fast_exp2(fmaf(sc[e], kLog2e, -base[(e >> 1) & 1]));
    l[(e >> 1) & 1] += sc[e];
  }
  acc_to_a<64>(p, sc);
}

// Persistent, one block per SM. Warps 0-7: two consumer warpgroups, 64
// query rows of the work tile each (232 registers a thread); warp 8: the
// producer, one thread of which issues every TMA load (Q per work tile, K/V
// per key tile); warps 9-11 only give their registers away.
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, FwdWork wk) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align1024(smem_raw));
  const int seq = wk.seq;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.q_full[b], 1);
      mbar_init(&sm.q_empty[b], kConsumers);
    }
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup: one thread loads
    regs_dec<40>();
    if (threadIdx.x != kConsumers) return;
    int slot = 0;
    for (int n = 0, w = wk.tile(0); w < wk.count(); w = wk.tile(++n)) {
      const int qb = n & 1, bh = wk.bh(w), kv_row = (bh / wk.group) * seq, j_lo = wk.j_lo(w);
      mbar_wait(&sm.q_empty[qb], ((n >> 1) & 1) ^ 1);
      mbar_expect_tx(&sm.q_full[qb], kFwdRows * kRowBytes);
      tma_load(sm.q[qb], &tq, &sm.q_full[qb], bh * seq + wk.qt(w) * kFwdRows);
      for (int t = 0; t < wk.n_tiles(w); ++t, ++slot) {
        const int s = slot % kFwdStages, row = kv_row + (j_lo + t) * kFwdKeys;
        const uint32_t phase = ((slot / kFwdStages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[s], phase);
        mbar_expect_tx(&sm.k_full[s], kFwdKeys * kRowBytes);
        tma_load(sm.k[s], &tk, &sm.k_full[s], row);
        mbar_wait(&sm.v_empty[s], phase);
        mbar_expect_tx(&sm.v_full[s], kFwdKeys * kRowBytes);
        tma_load(sm.v[s], &tv, &sm.v_full[s], row);
      }
    }
    return;
  }
  regs_inc<232>();

  const int wg = threadIdx.x / 128;
  int slot = 0;
  for (int n = 0, w = wk.tile(0); w < wk.count(); w = wk.tile(++n)) {
    const int qb = n & 1, bh = wk.bh(w), j_lo = wk.j_lo(w), n_tiles = wk.n_tiles(w);
    const int row0 = wk.qt(w) * kFwdRows + wg * 64;  // this warpgroup's first query row
    // only the diagonal tile and the window's edge tile are masked
    auto masked = [&](int k0) { return k0 + kFwdKeys - 1 > row0 || row0 + 63 - k0 >= wk.window; };
    float acc[32], sc[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[8][4], pn[8][4];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    mbar_wait(&sm.q_full[qb], (n >> 1) & 1);
    const uint64_t dq = desc_k(sm.q[qb] + wg * 64 * kD);
    auto issue_s = [&](int s) {  // sc = Q K^T for the K tile in stage s
#pragma unroll
      for (int e = 0; e < 64; ++e) sc[e] = 0.f;
      fence_regs(sc);
      wg_fence();
      const uint64_t dk = desc_k(sm.k[s]);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n128<0, 0>(sc, desc_add(dq, 32 * kk), desc_add(dk, 32 * kk), kk > 0);
      wg_commit();
    };

    mbar_wait(&sm.k_full[slot % kFwdStages], (slot / kFwdStages) & 1);
    issue_s(slot % kFwdStages);
    wg_wait0();
    fence_regs(sc);
    mbar_arrive(&sm.k_empty[slot % kFwdStages]);
    softmax_step(sc, m, l, alpha, p, masked(j_lo * kFwdKeys), row0, j_lo * kFwdKeys, wk.window);
    // Tile t: S of tile t + 1 goes to the tensor cores ahead of P V of tile
    // t, and its softmax runs while P V does; O is rescaled once P V is done.
    // The last tile's P V follows the loop, so the loop body has no branch
    // (ptxas then sees that the wait of one group retires S).
    auto issue_pv = [&](int s) {  // acc += P V for the V tile in stage s
      mbar_wait(&sm.v_full[s], (slot / kFwdStages) & 1);
      fence_regs(acc);
      fence_regs(p);
      wg_fence();
      const uint64_t dv = desc_mn(sm.v[s]);
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs_n64<1>(acc, p[kk], desc_add(dv, kk * 16 * kRowBytes));
      wg_commit();
    };
    for (int t = 0; t + 1 < n_tiles; ++t, ++slot) {
      const int s = slot % kFwdStages, s1 = (slot + 1) % kFwdStages;
      mbar_wait(&sm.k_full[s1], ((slot + 1) / kFwdStages) & 1);
      issue_s(s1);
      issue_pv(s);
      wg_wait1();
      fence_regs(sc);
      mbar_arrive(&sm.k_empty[s1]);
      const int k1 = (j_lo + t + 1) * kFwdKeys;
      softmax_step(sc, m, l, alpha, pn, masked(k1), row0, k1, wk.window);
      wg_wait0();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(&sm.v_empty[s]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[kk][i] = pn[kk][i];
    }
    issue_pv(slot % kFwdStages);
    wg_wait0();
    fence_regs(acc);
    fence_regs(p);
    mbar_arrive(&sm.v_empty[slot % kFwdStages]);
    ++slot;
    mbar_arrive(&sm.q_empty[qb]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float total = quad_sum(l[r]);
      const float inv = 1.f / total;
      const int row = row0 + acc_row(2 * r);
      bf16* orow = o + (static_cast<size_t>(bh) * seq + row) * kD;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store2(orow + acc_col(4 * c), acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
      if (threadIdx.x % 4 == 0)
        lse[static_cast<size_t>(bh) * seq + row] = (m[r] + log2f(total)) * kLn2;
    }
  }
}

// ---- backward -------------------------------------------------------------

// delta = rowsum(dO * O) in float32, 8 threads a row (part of the backward:
// its main kernel reads delta through the TMA ring).
__global__ void __launch_bounds__(256)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ delta) {
  const size_t row = static_cast<size_t>(blockIdx.x) * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + row * kD) + part);
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(dout + row * kD) + part);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    sum += fx.x * fy.x + fx.y * fy.y;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (part == 0) delta[row] = sum;
}

constexpr int kBwdKeys = 128;  // keys of a work item: 64 per consumer warpgroup
constexpr int kBwdRows = 64;   // query rows of a ring tile
constexpr int kBwdStages = 4;
constexpr int kDqWriters = 96;  // warps 9-11, each taking every third pair's dQ partial
constexpr int kDqSlots = 4;     // dQ partials staged between the consumers and the writers
constexpr int kBwdThreads = kConsumers + 32 + kDqWriters;  // 384: three warpgroups
constexpr int kDqStride = kD + 8;  // floats per row of a staged dQ partial (fewer bank conflicts)

struct BwdSmem {
  bf16 k[kBwdKeys * kD];
  bf16 v[kBwdKeys * kD];
  bf16 dst[2][kBwdKeys * kD];  // dS^T of the last two pairs: [key][query], swizzled
  bf16 q[kBwdStages][kBwdRows * kD];
  bf16 dout[kBwdStages][kBwdRows * kD];
  float lse[kBwdStages][kBwdRows];
  float delta[kBwdStages][kBwdRows];
  float dqs[kDqSlots][kBwdRows * kDqStride];  // 64 x 64 dQ partials for the writers
  uint64_t full[kBwdStages], empty[kBwdStages], kv_full, kv_empty, dq_full[kDqSlots],
      dq_empty[kDqSlots];
  int item;
};
constexpr int kBwdSmemBytes = sizeof(BwdSmem) + 1024;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The work items' geometry. Item n is key tile j = n / (B Hkv) of
// (batch, KV head) n % (B Hkv): j-major, so the longest items (small j
// under a causal mask) come first and every item comes after the items it
// waits on (the same (batch, KV head) at smaller j).
struct BwdGeom {
  int batch_kv, group, seq, window, n_items;  // batch_kv = B Hkv, group = H / Hkv
  __device__ int q_tiles() const { return seq / kBwdRows; }
  // query tiles [i_lo, i_hi] that see a key of tile j
  __device__ int i_lo(int j) const { return j * kBwdKeys / kBwdRows; }
  __device__ int i_hi(int j) const {
    return min(q_tiles() - 1, (j * kBwdKeys + kBwdKeys - 1 + window - 1) / kBwdRows);
  }
  // key tiles [j_lo, j_hi] that query tile i sees: the dQ contributors
  __device__ int j_lo(int i) const { return max(0, i * kBwdRows - window + 1) / kBwdKeys; }
  __device__ int j_hi(int i) const { return (i * kBwdRows + kBwdRows - 1) / kBwdKeys; }
};

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
// that global round trip.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                float* __restrict__ dq_acc, int* __restrict__ turns, int* __restrict__ work,
                BwdGeom geo) {
  extern __shared__ unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(align1024(smem_raw));
  const int seq = geo.seq, group = geo.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumers + kDqWriters);
    for (int b = 0; b < kDqSlots; ++b) {
      mbar_init(&sm.dq_full[b], kConsumers);
      mbar_init(&sm.dq_empty[b], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // warpgroup 2: the producer warp and the dQ writers
    regs_dec<80>();
    if (threadIdx.x >= kConsumers + 32) {  // dQ writers
      // Writer warp wk takes pairs wk, wk + 3, ... of the block's sequence, so
      // three (b, h, i) tiles are in flight at once. For each it waits for its
      // turn, adds the staged partial to the float32 workspace (or, as the
      // last contributor, writes dq), and releases the next turn.
      const int wk = (threadIdx.x - (kConsumers + 32)) / 32, lane = threadIdx.x % 32;
      int slot = 0;
      for (uint32_t kv_phase = 0;; kv_phase ^= 1) {
        mbar_wait(&sm.kv_full, kv_phase);
        const int item = sm.item;
        mbar_arrive(&sm.kv_empty);  // the writers read nothing else of the item's buffers
        if (item >= geo.n_items) return;
        const int j = item / geo.batch_kv, h0 = (item % geo.batch_kv) * group;
        const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
        for (int p = 0; p < n_pairs; ++p, ++slot) {
          if (slot % (kDqWriters / 32) != wk) continue;
          const int h = h0 + p % group, i = i_hi - p / group, b = slot % kDqSlots;
          // this item's turn for (b, h, i) is j - j_lo(i), in key-tile order
          const int turn = j - geo.j_lo(i);
          const bool last = j == geo.j_hi(i);
          int* counter = turns + static_cast<size_t>(h) * geo.q_tiles() + i;
          if (lane == 0) {
            const long long t0 = clock64();
            while (ld_acquire(counter) < turn)
              if (clock64() - t0 > kHangCycles) __trap();
          }
          __syncwarp();
          mbar_wait(&sm.dq_full[b], (slot / kDqSlots) & 1);
          const size_t base = (static_cast<size_t>(h) * seq + i * kBwdRows) * kD;
          constexpr int kChunk = 8, kVecs = kBwdRows * kD / 4;  // float4s a lane, a tile
#pragma unroll 1
          for (int c0 = 0; c0 < kVecs; c0 += 32 * kChunk) {
            float4 x[kChunk];
#pragma unroll
            for (int n = 0; n < kChunk; ++n) {
              const int idx = c0 + n * 32 + lane, r = idx / (kD / 4), c = (idx % (kD / 4)) * 4;
              x[n] = *reinterpret_cast<const float4*>(&sm.dqs[b][r * kDqStride + c]);
              if (turn > 0) {
                const float4 y =
                    __ldcg(reinterpret_cast<const float4*>(dq_acc + base + r * kD + c));
                x[n] = make_float4(y.x + x[n].x, y.y + x[n].y, y.z + x[n].z, y.w + x[n].w);
              }
            }
#pragma unroll
            for (int n = 0; n < kChunk; ++n) {
              const int idx = c0 + n * 32 + lane;
              const size_t off = base + (idx / (kD / 4)) * kD + (idx % (kD / 4)) * 4;
              if (last) {
                store2(dq + off, x[n].x, x[n].y);
                store2(dq + off + 2, x[n].z, x[n].w);
              } else {
                __stcg(reinterpret_cast<float4*>(dq_acc + off), x[n]);
              }
            }
          }
          mbar_arrive(&sm.dq_empty[b]);
          __syncwarp();
          if (lane == 0) add_release(counter, 1);
        }
      }
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
      const int j = item / geo.batch_kv, bg = item % geo.batch_kv;
      const int h0 = bg * group;  // (b, g) -> the group's first query head, b H + g group
      const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
      bool kv_loaded = false;
      for (int p = 0; p < n_pairs; ++p, ++slot) {
        const int s = slot % kBwdStages;
        const int row = (h0 + p % group) * seq + (i_hi - p / group) * kBwdRows;
        mbar_wait(&sm.empty[s], ((slot / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kBwdRows * kRowBytes + 2 * kBwdRows * 4);
        tma_load(sm.q[s], &tq, &sm.full[s], row);
        tma_load(sm.dout[s], &tdo, &sm.full[s], row);
        bulk_load(sm.lse[s], lse + row, kBwdRows * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + row, kBwdRows * 4, &sm.full[s]);
        // K and V once the ring holds the item's first pairs (the buffers
        // free up only when the previous item is done)
        if (!kv_loaded && (p == kBwdStages - 1 || p == n_pairs - 1)) {
          mbar_wait(&sm.kv_empty, kv_phase ^ 1);
          sm.item = item;
          mbar_expect_tx(&sm.kv_full, 2 * kBwdKeys * kRowBytes);
          tma_load(sm.k, &tk, &sm.kv_full, bg * seq + j * kBwdKeys);
          tma_load(sm.v, &tv, &sm.kv_full, bg * seq + j * kBwdKeys);
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
    const int j = item / geo.batch_kv, bg = item % geo.batch_kv;
    const int k0 = j * kBwdKeys + wg * 64;  // this warpgroup's first key
    const int i_hi = geo.i_hi(j), n_pairs = group * (i_hi - geo.i_lo(j) + 1);
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;
    const uint64_t d_k = desc_k(sm.k + wg * 64 * kD), d_v = desc_k(sm.v + wg * 64 * kD);

    for (int p = 0; p < n_pairs; ++p, ++slot) {
      const int s = slot % kBwdStages;
      const int q0 = (i_hi - p / group) * kBwdRows;
      mbar_wait(&sm.full[s], (slot / kBwdStages) & 1);
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
      const uint64_t d_q = desc_k(sm.q[s]), d_do = desc_k(sm.dout[s]);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64<0, 0>(st, desc_add(d_k, 32 * kk), desc_add(d_q, 32 * kk), kk > 0);
        wgmma_ss_n64<0, 0>(dpt, desc_add(d_v, 32 * kk), desc_add(d_do, 32 * kk), kk > 0);
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
      const uint64_t m_do = desc_mn(sm.dout[s]), m_q = desc_mn(sm.q[s]);
#pragma unroll
      for (int kk = 0; kk < kBwdRows / 16; ++kk) {
        wgmma_rs_n64<1>(dv_acc, a_p[kk], desc_add(m_do, kk * 16 * kRowBytes));
        wgmma_rs_n64<1>(dk_acc, a_ds[kk], desc_add(m_q, kk * 16 * kRowBytes));
      }
      wg_commit();
      // dS^T to the async proxy and to the other warpgroup; then this
      // warpgroup's half of the dQ partial (64 queries x 32 of the head dim)
      // over all 128 keys: dS K[:, 32 wg : 32 wg + 32]
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1, kConsumers);
      float dqp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dqp[e] = 0.f;
      fence_regs(dqp);
      wg_fence();
      const uint64_t m_ds = desc_mn(dst), m_k = desc_add(desc_mn(sm.k), wg * 64);
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
      // the partial to its writer warp, through one of kDqSlots buffers
      const int b = slot % kDqSlots;
      mbar_wait(&sm.dq_empty[b], ((slot / kDqSlots) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 16; e += 2)
        *reinterpret_cast<float2*>(&sm.dqs[b][acc_row(e) * kDqStride + wg * 32 + acc_col(e)]) =
            make_float2(dqp[e], dqp[e + 1]);
      mbar_arrive(&sm.dq_full[b]);
    }
    // dK, dV of this warpgroup's 64 keys, at the KV head's rows
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const size_t off = (static_cast<size_t>(bg) * seq + k0 + acc_row(e)) * kD + acc_col(e);
      store2(dk + off, dk_acc[e], dk_acc[e + 1]);
      store2(dv + off, dv_acc[e], dv_acc[e + 1]);
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

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int seq,
        int window, int group, cudaStream_t s) {
  constexpr int bytes = 3 * Parts<T>::value * kTileBytes;
  if (int err = set_smem(flash_fwd_kernel<T>, bytes)) return err;
  flash_fwd_kernel<T><<<dim3(seq / kTile, bh), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, window, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int seq,
        int window, int group, cudaStream_t s) {
  constexpr int bytes = bwd_smem_bytes<Parts<T>::value>();
  if (int err = set_smem(flash_bwd_dq_kernel<T>, bytes)) return err;
  if (int err = set_smem(flash_bwd_dkv_kernel<T>, bytes)) return err;
  flash_bwd_dq_kernel<T><<<dim3(seq / kTile, bh), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      seq, window, group);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  flash_bwd_dkv_kernel<T><<<dim3(seq / kTile, bh / group), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq,
      window, group);
  return static_cast<int>(cudaGetLastError());
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

// A [rows, 64] bf16 tensor read in boxes of box_rows rows, 128-byte swizzle.
int make_map(CUtensorMap* map, const void* base, long long rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kRowBytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(box_rows)};
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

int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
             int heads, int kv_heads, int seq, int window, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const long long kv_rows = static_cast<long long>(batch) * kv_heads * seq;
  if (int err = make_map(&tq, q, rows, kFwdRows)) return err;
  if (int err = make_map(&tk, k, kv_rows, kFwdKeys)) return err;
  if (int err = make_map(&tv, v, kv_rows, kFwdKeys)) return err;
  if (int err = set_smem(flash_fwd_wgmma, kFwdSmemBytes)) return err;
  FwdWork wk;
  wk.bh_count = batch * heads;
  wk.n_qt = seq / kFwdRows;
  wk.seq = seq;
  wk.window = window;
  wk.group = heads / kv_heads;
  flash_fwd_wgmma<<<min(wk.bh_count * wk.n_qt, sm_count()), kWsThreads, kFwdSmemBytes, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, wk);
  return static_cast<int>(cudaGetLastError());
}

int bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, float* dq_acc,
             int* counters, int batch, int heads, int kv_heads, int seq, int window,
             cudaStream_t s) {
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const long long kv_rows = static_cast<long long>(batch) * kv_heads * seq;
  flash_bwd_delta<<<static_cast<unsigned>(rows / 32), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  CUtensorMap tq, tdo, tk, tv;
  if (int err = make_map(&tq, q, rows, kBwdRows)) return err;
  if (int err = make_map(&tdo, dout, rows, kBwdRows)) return err;
  if (int err = make_map(&tk, k, kv_rows, kBwdKeys)) return err;
  if (int err = make_map(&tv, v, kv_rows, kBwdKeys)) return err;
  if (int err = set_smem(flash_bwd_wgmma, kBwdSmemBytes)) return err;
  BwdGeom geo;
  geo.batch_kv = batch * kv_heads;
  geo.group = heads / kv_heads;
  geo.seq = seq;
  geo.window = window;
  geo.n_items = geo.batch_kv * (seq / kBwdKeys);
  int* turns = counters;
  int* work = counters + static_cast<size_t>(batch) * heads * (seq / kBwdRows);
  flash_bwd_wgmma<<<min(geo.n_items, sm_count()), kBwdThreads, kBwdSmemBytes, s>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dq_acc, turns, work, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes (row-major, contiguous, 16-byte aligned): q, o, dout, dq
// [batch, heads, seq, 64]; k, v, dk, dv [batch, kv_heads, seq, 64], all bf16
// (is_f32 == 0) or all float32; lse, delta [batch, heads, seq] float32. q is
// pre-scaled; query head h reads KV head h / (heads / kv_heads). seq a
// multiple of 128, 1 <= window, heads a multiple of kv_heads. Each returns 0
// or the first error: a cudaError_t after a launch, kErrNoEncode or
// kErrEncode from a tensor map.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int heads, int kv_heads, int seq,
                                   int window, int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_f32 ? fwd<float>(q, k, v, o, l, batch * heads, seq, window, heads / kv_heads, s)
                : fwd_bf16(q, k, v, o, l, batch, heads, kv_heads, seq, window, s);
}

// Writes delta, dq, dk and dv. bf16: dq_acc is float32 scratch shaped like
// q, and counters int32 [batch * heads * seq / 64 + 1], all zero (the
// caller's torch.zeros). float32 (the mma.sync kernels) uses neither.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* dq_acc, void* counters, int batch,
                                   int heads, int kv_heads, int seq, int window, int is_f32,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  return is_f32 ? bwd<float>(q, k, v, o, dout, l, d, dq, dk, dv, batch * heads, seq, window,
                             heads / kv_heads, s)
                : bwd_bf16(q, k, v, o, dout, l, d, dq, dk, dv, static_cast<float*>(dq_acc),
                           static_cast<int*>(counters), batch, heads, kv_heads, seq, window, s);
}
