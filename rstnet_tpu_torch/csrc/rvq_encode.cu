// Residual-VQ encode: nearest-codeword search over Q levels, with the
// residual update and the quantized sum.
//
// Replaces: rstnet_tpu/ops/pallas_rvq.py::rvq_encode_pallas (kernel body
// _rvq_encode_kernel). Same math: per level, dist = ||e||^2 - 2 r.e in
// float32, argmin with the lowest index winning ties, gather the winner,
// residual -= e; quant is the chosen codewords added in level order from
// zero. A row whose distances are all NaN gets code 0.
//
// Ties and NaN: where partial results merge, each candidate is one 64-bit
// key, (the distance's bits mapped so that unsigned order is float order,
// -0 taken as +0, any NaN as 0xFFFFFFFF so that it loses to every number)
// << 32 | index, and the argmin is the integer minimum of the keys: equal
// distances fall to the lower index whatever the order of arrival, so two
// calls give bit-identical codes and sums.
//
// What bounds it on the H100, at Mimi's shapes (D=256, K=2048; Q=1 for the
// semantic quantizer, Q=7 for the acoustic one): for the few rows of a
// serving frame or tick (N <= 64) the codebooks' bytes, 2 MB a level, once
// at 3.35 TB/s (4.4 us at Q=7), behind a chain of Q dependent levels, each
// a grid-wide argmin; for the thousands of rows of an offline encode, the
// 2 N K D products a level.
//
// Split path (N <= kSplitMaxRows: every serving frame and tick) - ONE
// cooperative launch of one block per SM; block b owns a fixed slice of the
// K codewords in every level (16 of 2048 over 128 blocks).
// - Loads: a warp issues TMA bulk copies (cp.async.bulk on mbarriers) of
//   the block's slices of the first kSplitStages levels into a ring of
//   shared-memory slots, and of the N rows of x; a slot is refilled with the
//   level kSplitStages later as soon as the block has scored it, so the
//   codebooks stream once, behind the work. ||e||^2 of a level's slice is
//   computed while the grid merges the level before.
// - Scoring without cross-lane reductions: a lane owns 4 codewords x 8
//   rows and keeps the 32 dots in registers over a range of D (the lanes
//   split D into up to 16 ranges so that small N still uses the block); the
//   ranges' sums are added in a fixed order through shared memory. Rows and
//   codewords sit 4 mod 32 floats apart, so a quarter-warp's 16-byte reads
//   fall on distinct banks.
// - Merge: each block's best key per row goes to a 64-bit atomicMin on the
//   level's word for that row; thread 0 then releases an arrival counter
//   (the block's atomicMins ordered before it by the barrier), and every
//   block waits (acquire) for all arrivals, reads the N winners, gathers
//   their codewords from L2 (a few instructions a row, loads batched) and
//   updates its own copy of the residual; the block that owns a row (row %
//   blocks) writes its code and its running quantized sum. The last block
//   out restores the counter and the key words, so a launch needs no reset:
//   one device kernel a call.
// Measured per level (tools/k3_phase_marks.py): ~0.8 us of dots at N <= 16,
// ~2.2 at N = 64 (shared-memory reads); ~0.5 forming keys; ~0.6-1.4
// arriving (the release waits for the block's atomics); ~0.7-1.0 merging;
// ~0.9-2.2 updating. Tried and dropped: tagged per-block partial keys read
// by every block (slower: the polls contend), 8 key words a row (slower),
// a fence before the release (slower).
//
// Tiled path (larger N: offline encode, tokenization) - tensor cores. A
// block takes 64 residual rows, kept in shared memory for the whole level
// sweep, against 1/ranks of the codewords: the ranks (2, or up to 8 while
// the grid stays within one wave) of a thread-block cluster take the parts
// of K for the same rows, so N = 4096 runs 128 blocks rather than 64, and
// push their per-row best keys into each other's shared memory (DSMEM
// stores, then a remote mbarrier arrive) each level; then every rank
// updates its residual. Codebook tiles of 128 codewords x 64 of D, with
// their ||e||^2 (a first small kernel), stream through a ring of cp.async
// stages issued by all threads S - 1 tiles ahead, across level boundaries.
// Eight warps take 32 rows x 32 codewords each with mma.sync m16n8k8 in
// TF32, at float32 accuracy by 3xTF32: each operand is split in registers
// into hi (rounded to TF32 with integer operations) and lo = v - hi (exact,
// cut to TF32 by the tensor core), and the f32 accumulators take lo.hi +
// hi.lo + hi.hi, leaving out ~2^-21 of each product. 3xTF32 rather than a
// TF32 screen plus an fp32 re-score: no data-dependent second pass; rather
// than split bf16 (~2^-16 left out, visible to a 1e-5 near-tie rule).
// mma.sync rather than wgmma: the split happens in registers from one f32
// tile (wgmma would need hi and lo planes of both operands in swizzled
// shared memory), and each lane reads 16 contiguous bytes of a row or a
// codeword a k16 step (within one mma the k order is free: the same
// permutation on both sides). The epilogue keeps a running (distance,
// index) per row in registers, visiting codewords in increasing order with
// a strict '<'. A producer warp feeding the ring (1-D TMA rows of 256
// bytes, or its own cp.async) was slower: small bulk copies starve the
// ring, and one warp's copies contend with the products' shared-memory
// reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a wait this long is a fault
constexpr unsigned long long kNoKey = ~0ull;

// Phase marks (tools/k3_phase_marks.py builds a copy of this source with
// RSTNET_RVQ_MARKS defined) into rvq_marks[block][9][8] int64. Split path:
// thread 0 of each block writes its SM's clock64 at points of level
// min(q, 7): [0] the level's slice has landed, [5] its own dots done, [6]
// the block's best keys formed, [7] its atomicMins issued, [1] arrived (and,
// for the other warps, the next level's norms done), [2] the winners read,
// [3] its residual updated, [4] synced; at [8][1] the kernel's start and at
// [8][0] its end, with the global timer (ns) beside them at [8][2], [8][3].
// Tiled path: thread 0 sums clock64 spans by kind into [block][0][0..3]:
// waiting for a stage, issuing the next tile's copies, products, the rest
// (epilogues, level ends).
#ifdef RSTNET_RVQ_MARKS
constexpr int kMarkBlocks = 160;
__device__ long long rvq_marks[kMarkBlocks * 9 * 8];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define RVQ_MARK(level, slot)                                                        \
  do {                                                                              \
    if (threadIdx.x == 0 && blockIdx.x < kMarkBlocks) {                             \
      rvq_marks[(blockIdx.x * 9 + (level)) * 8 + (slot)] = clock64();               \
      if ((level) == 8) rvq_marks[(blockIdx.x * 9 + 8) * 8 + 3 - (slot)] = global_ns(); \
    }                                                                               \
  } while (0)
#define TILED_T(k)                                      \
  do {                                                  \
    if (threadIdx.x == 0) {                             \
      const long long now_ = clock64();                 \
      t_span_[k] += now_ - t_last_;                     \
      t_last_ = now_;                                   \
    }                                                   \
  } while (0)
#define TILED_DUMP()                                                                 \
  do {                                                                               \
    if (threadIdx.x == 0 && blockIdx.x < kMarkBlocks) {                              \
      for (int k_ = 0; k_ < 4; ++k_) rvq_marks[blockIdx.x * 72 + k_] = t_span_[k_];  \
    }                                                                                \
  } while (0)
#else
#define RVQ_MARK(level, slot) \
  do {                        \
  } while (0)
#define TILED_T(k) \
  do {             \
  } while (0)
#define TILED_DUMP() \
  do {               \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// Keys

__device__ __forceinline__ unsigned long long dist_key(float d, int k) {
  unsigned u;
  if (d != d) {
    u = 0xFFFFFFFFu;  // NaN of either sign: loses to every number
  } else {
    u = __float_as_uint(__fadd_rn(d, 0.0f));  // -0 -> +0
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(k);
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// mbarriers, TMA bulk copies, cp.async, GPU-scope atomics

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
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
// Until the phase of this parity has completed; a wait of seconds is a
// fault: trap, so that the launch fails.
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
// 16 (or 4) bytes global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Until at most n (0, 1 or 2) of this thread's groups are pending.
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  }
}
__device__ __forceinline__ unsigned long long atom_add_acq_rel(unsigned long long* p,
                                                               unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], %2;" : "=l"(old) : "l"(p), "l"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ void red_add_release(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// ||e||^2 of Q*K codewords (the tiled path's first kernel): a warp each.

__global__ void codeword_sq_norms(const float* __restrict__ cb, float* __restrict__ esq,
                                  int QK, int D) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= QK) return;  // uniform across the warp
  const float4* e = reinterpret_cast<const float4*>(cb + static_cast<size_t>(warp) * D);
  float s = 0.f;
  for (int d = lane; d < D / 4; d += 32) {
    const float4 v = e[d];
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  s = warp_sum(s);
  if (lane == 0) esq[warp] = s;
}

// ---------------------------------------------------------------------------
// Split path

constexpr int kSplitMaxRows = 64;
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kPassCodes = 16;  // codewords a pass: 4 lane groups x 4
constexpr int kSplitStages = 3;  // level slots in flight
constexpr int kMaxParts = 16;   // ranges of D the lanes split a pass into, at most
// Partial dots [parts][rows][16 codewords], parts x rows <= 512: a part takes
// rows x 16 + 4 floats and a row's 4-codeword chunks are swizzled (chunk c
// at c ^ (row / 2 % 4)), so that neither the lanes' stores nor the float4
// reads of the sums meet in a bank.
constexpr int kPartFloats = 8192 + 4 * kMaxParts;
__device__ __forceinline__ int part_at(int part, int rows_pad, int row, int chunk) {
  return part * (rows_pad * kPassCodes + 4) + row * kPassCodes + 4 * (chunk ^ ((row >> 1) & 3));
}

// Floats a shared row takes: >= D, = 4 mod 32 (16-byte reads of rows or
// codewords 2 apart land on distinct banks).
int split_dp(int D) { return D + ((4 - D % 32) + 32) % 32; }
// Groups of 8 rows (1, 2, 4 or 8) the lanes take; the lanes left over split D.
int split_row_blocks(int N) { return N <= 8 ? 1 : N <= 16 ? 2 : N <= 32 ? 4 : 8; }

struct SplitParams {
  const float* x;
  const float* cb;
  int* codes;
  float* quant;
  unsigned long long* sync;  // [0] arrival counter, then the key words [Q][N]
  int N, D, Q, K, slice, stages, dp, nrb;
};

// Warp `warp` of a `nw`-warp team: ||e||^2 of a level's slice, landed.
__device__ void slice_norms(const float* slot, float* esq, int n_local, int D4, int dp,
                            int warp, int nw) {
  const int lane = threadIdx.x % 32;
  for (int c = warp; c < n_local; c += nw) {
    const float4* e = reinterpret_cast<const float4*>(slot + static_cast<size_t>(c) * dp);
    float s = 0.f;
    for (int d = lane; d < D4; d += 32) {
      const float4 v = e[d];
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    s = warp_sum(s);
    if (lane == 0) esq[c] = s;
  }
}

// After level q, with thread t on column c = t % D4 of rows t / D4 + j step
// (step = threads / D4; threads past step * D4 idle): rows[r] -= cbq[pick[r]]
// (if `residual`) and quant[r] (+)= the same codeword where bit j of `own`
// is set; pick(r) gives row r's winner. The codewords come from L2; a thread
// issues the loads of 8 rows before it uses any, so each 8 rows cost one
// round trip (two where pick(r) itself loads). No division: the update is
// a few instructions a row.
template <typename Pick>
__device__ __forceinline__ void update_rows(const float* cbq, Pick pick, float* rows,
                                            int stride, float* quant, int n, int D4, int q,
                                            bool residual, uint32_t own, int threads) {
  constexpr int kBatch = 8;
  const int step = threads / D4, c = threadIdx.x % D4, r0 = threadIdx.x / D4;
  if (r0 >= step) return;
  const float4* cb4 = reinterpret_cast<const float4*>(cbq) + c;
  float4* quant4 = reinterpret_cast<float4*>(quant) + c;
  float4* rows4 = reinterpret_cast<float4*>(rows) + c;
  const int stride4 = stride / 4;
  for (int jb = 0; r0 + jb * step < n; jb += kBatch) {
    float4 e[kBatch], a[kBatch];
    int idx[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // the winners first, then their codewords
      const int r = r0 + (jb + j) * step;
      idx[j] = r < n && (residual || ((own >> (jb + j)) & 1u)) ? pick(r) : -1;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (idx[j] >= 0) e[j] = __ldg(cb4 + static_cast<size_t>(idx[j]) * D4);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + (jb + j) * step;
      if (r < n && ((own >> (jb + j)) & 1u)) {
        a[j] = q == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : quant4[r * D4];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + (jb + j) * step;
      if (r < n) {
        if (residual) {
          float4 v = rows4[r * stride4];
          v.x -= e[j].x; v.y -= e[j].y; v.z -= e[j].z; v.w -= e[j].w;
          rows4[r * stride4] = v;
        }
        if ((own >> (jb + j)) & 1u) {
          a[j].x += e[j].x; a[j].y += e[j].y; a[j].z += e[j].z; a[j].w += e[j].w;
          quant4[r * D4] = a[j];
        }
      }
    }
  }
}

// Bit j set where row threadIdx.x / D4 + j (threads / D4) of update_rows is
// below n and r % owners == owner.
__device__ __forceinline__ uint32_t owned_rows(int n, int D4, int owners, int owner,
                                               int threads) {
  const int step = threads / D4, r0 = threadIdx.x / D4;
  uint32_t own = 0;
#pragma unroll 1
  for (int j = 0; j < 32; ++j) {
    const int r = r0 + j * step;
    if (r < n && r % owners == owner) own |= 1u << j;
  }
  return own;
}

__global__ void __launch_bounds__(kSplitThreads, 1) rvq_split_kernel(const SplitParams p) {
  extern __shared__ float4 smem4[];
  const int N = p.N, D = p.D, D4 = D / 4, dp = p.dp, Q = p.Q, K = p.K, S = p.stages;
  const int slice_pad = (p.slice + kPassCodes - 1) / kPassCodes * kPassCodes;
  const int rows_pad = 8 * p.nrb;
  float* rows = reinterpret_cast<float*>(smem4);                      // [rows_pad][dp]
  float* slots = rows + rows_pad * dp;                                 // [S][slice_pad][dp]
  float* esq = slots + static_cast<size_t>(S) * slice_pad * dp;        // [S][slice_pad]
  float* part = esq + S * slice_pad;                                   // [dparts][rows_pad][16]
  int* pick = reinterpret_cast<int*>(part + kPartFloats);              // [64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(pick + kSplitMaxRows);   // [S + 1]
  int* last = reinterpret_cast<int*>(bar + S + 1);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k0 = blockIdx.x * p.slice;
  const int n_local = min(p.slice, K - k0);  // >= 1: the grid has no empty block
  const int G = gridDim.x;
  unsigned long long* counter = p.sync;
  unsigned long long* keys = p.sync + 1;

  // Warp-wide: level q's slice into its slot.
  auto issue = [&](int q) {
    const int s = q % S;
    if (lane == 0) mbar_expect_tx(&bar[s], static_cast<uint32_t>(n_local) * D * 4);
    __syncwarp();
    const float* src = p.cb + (static_cast<size_t>(q) * K + k0) * D;
    float* dst = slots + static_cast<size_t>(s) * slice_pad * dp;
    for (int c = lane; c < n_local; c += 32) {
      bulk_load(dst + static_cast<size_t>(c) * dp, src + static_cast<size_t>(c) * D, D * 4,
                &bar[s]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    for (int q = 0; q < S; ++q) issue(q);
  } else if (warp == 1) {  // the rows of x, on bar[S]
    if (lane == 0) mbar_expect_tx(&bar[S], static_cast<uint32_t>(N) * D * 4);
    __syncwarp();
    for (int r = lane; r < N; r += 32) {
      bulk_load(rows + r * dp, p.x + static_cast<size_t>(r) * D, D * 4, &bar[S]);
    }
  }
  RVQ_MARK(8, 1);
  for (int i = N * dp + tid; i < rows_pad * dp; i += kSplitThreads) rows[i] = 0.f;

  // scoring layout: lane group lg = tid % (4 nrb) owns codewords cg + 4j
  // (j < 4) of a pass and rows rg + nrb i (i < 8), cg = lg % 4, rg = lg / 4,
  // over the range dpart = tid / (4 nrb) of D (threads past `dparts` ranges
  // idle). Codewords and rows 1 apart are dp = 4 mod 32 floats apart: a
  // quarter-warp's 16-byte reads fall on distinct banks.
  const int nrb = p.nrb, groups = 4 * nrb;
  const int dparts = min(kMaxParts, kSplitThreads / groups);
  const int lg = tid % groups, dpart = tid / groups;
  const int cg = lg % 4, rg = lg / 4;
  const int d_lo = dpart * D4 / dparts, d_hi = dpart < dparts ? (dpart + 1) * D4 / dparts : d_lo;
  // reduction layout: thread t < 4 rows_pad takes row t/4, codewords 4(t%4)..+3
  const int red_row = tid / 4, red_q = tid % 4;
  const uint32_t own = owned_rows(N, D4, G, blockIdx.x, kSplitThreads);

  for (int q = 0; q < Q; ++q) {
    const int s = q % S;
    const float* slot = slots + static_cast<size_t>(s) * slice_pad * dp;
    float* esq_s = esq + s * slice_pad;
    mbar_wait(&bar[s], (q / S) & 1);
    if (q == 0) mbar_wait(&bar[S], 0);
    RVQ_MARK(min(q, 7), 0);
    if (q == 0 || S == 1) {
      slice_norms(slot, esq_s, n_local, D4, dp, warp, kSplitWarps);
      __syncthreads();
    }
    unsigned long long best = kNoKey;
    for (int c0 = 0; c0 < n_local; c0 += kPassCodes) {
      if (dpart < dparts) {
        const float* e = slot + static_cast<size_t>(c0 + cg) * dp;
        const float* rr = rows + rg * dp;
        float acc[4][8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
        }
#pragma unroll 1
        for (int d = d_lo; d < d_hi; ++d) {
          float4 ev[4], rv[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) ev[j] = reinterpret_cast<const float4*>(e + 4 * j * dp)[d];
#pragma unroll
          for (int i = 0; i < 8; ++i) rv[i] = reinterpret_cast<const float4*>(rr + i * nrb * dp)[d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[j][i] = fmaf(rv[i].x, ev[j].x, acc[j][i]);
              acc[j][i] = fmaf(rv[i].y, ev[j].y, acc[j][i]);
              acc[j][i] = fmaf(rv[i].z, ev[j].z, acc[j][i]);
              acc[j][i] = fmaf(rv[i].w, ev[j].w, acc[j][i]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // codeword cg + 4j: chunk j, element cg
#pragma unroll
          for (int i = 0; i < 8; ++i) part[part_at(dpart, rows_pad, rg + nrb * i, j) + cg] = acc[j][i];
        }
      }
      RVQ_MARK(min(q, 7), 5);
      __syncthreads();
      if (red_row < N) {
        // the 4 codewords' sums in part order, 4 loads in flight a step

        float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t0 = 0; t0 < dparts; t0 += 8) {  // 8 loads in flight, then the sums in order
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            v[u] = t0 + u < dparts
                       ? *reinterpret_cast<const float4*>(part + part_at(t0 + u, rows_pad, red_row, red_q))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            dot.x += v[u].x; dot.y += v[u].y; dot.z += v[u].z; dot.w += v[u].w;
          }
        }
        const float dots[4] = {dot.x, dot.y, dot.z, dot.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * red_q + j;
          if (c0 + c < n_local) {
            const float dist = fmaf(-2.0f, dots[j], esq_s[c0 + c]);
            best = key_min(best, dist_key(dist, k0 + c0 + c));
          }
        }
      }
      __syncthreads();  // part is rewritten by the next pass
    }
    RVQ_MARK(min(q, 7), 6);
    best = key_min(best, __shfl_xor_sync(0xffffffffu, best, 1));
    best = key_min(best, __shfl_xor_sync(0xffffffffu, best, 2));
    if (red_q == 0 && red_row < N) atomicMin(keys + q * N + red_row, best);
    RVQ_MARK(min(q, 7), 7);
    __syncthreads();
    if (tid == 0) {  // arrive: a release, cumulative over the block's atomicMins (bar.sync)
      red_add_release(counter, 1ull);
    }
    if (warp == 1 && q + S < Q) {  // level q's slot is free: refill it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(q + S);
    }
    if (S >= 2 && q + 1 < Q && warp >= 1) {  // the next level's norms while the grid merges
      const int sn = (q + 1) % S;
      mbar_wait(&bar[sn], ((q + 1) / S) & 1);
      slice_norms(slots + static_cast<size_t>(sn) * slice_pad * dp, esq + sn * slice_pad,
                  n_local, D4, dp, warp - 1, kSplitWarps - 1);
    }
    RVQ_MARK(min(q, 7), 1);
    if (tid == 0) {
      const unsigned long long target = static_cast<unsigned long long>(G) * (q + 1);
      if (ld_acquire(counter) < target) {
        const long long t0 = clock64();
        while (ld_acquire(counter) < target) {
          if (clock64() - t0 > kHangCycles) __trap();
        }
      }
    }
    __syncthreads();
    if (tid < N) {
      const int idx = static_cast<int>(ld_relaxed(keys + q * N + tid) & 0xFFFFFFFFull);
      pick[tid] = idx;
      if (tid % G == static_cast<int>(blockIdx.x)) p.codes[static_cast<size_t>(tid) * Q + q] = idx;
    }
    __syncthreads();
    RVQ_MARK(min(q, 7), 2);
    update_rows(p.cb + static_cast<size_t>(q) * K * D, [&](int r) { return pick[r]; }, rows, dp,
                p.quant, N, D4, q, q + 1 < Q, own, kSplitThreads);
    RVQ_MARK(min(q, 7), 3);
    __syncthreads();
    RVQ_MARK(min(q, 7), 4);
  }
  RVQ_MARK(8, 0);
  // The last block out resets the counter and the key words for the next
  // launch: every block has read its last winners before it arrives here.
  if (tid == 0) {
    __threadfence();
    *last = atom_add_acq_rel(counter, 1ull) == static_cast<unsigned long long>(G) * (Q + 1) - 1;
  }
  __syncthreads();
  if (*last) {
    for (int i = tid; i < Q * N; i += kSplitThreads) keys[i] = kNoKey;
    if (tid == 0) *counter = 0;
  }
}

struct SplitShape {
  int slice, blocks, stages, dp, nrb;
  size_t smem;
};

int split_shape(int N, int D, int Q, int K, int sms, SplitShape* sh) {
  if (N < 1 || N > kSplitMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  sh->slice = (K + sms - 1) / sms;
  sh->blocks = (K + sh->slice - 1) / sh->slice;
  sh->dp = split_dp(D);
  sh->nrb = split_row_blocks(N);
  const size_t slice_pad = (sh->slice + kPassCodes - 1) / kPassCodes * kPassCodes;
  const size_t fixed = 4 * (static_cast<size_t>(8 * sh->nrb) * sh->dp + kPartFloats +
                            kSplitMaxRows) + 32;
  const size_t per_stage = 4 * slice_pad * (sh->dp + 1) + 8;
  if (fixed + per_stage > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);  // one level's slice does not fit
  }
  sh->stages = static_cast<int>(std::min<size_t>(std::min(Q, kSplitStages),
                                                 (kSmemLimit - fixed) / per_stage));
  sh->smem = fixed + sh->stages * per_stage;
  return 0;
}

// ---------------------------------------------------------------------------
// Tiled path

constexpr int kTileRows = 64;
constexpr int kTileCodes = 128;
constexpr int kChunk = 64;                  // columns of D a stage
constexpr int kStageStride = kChunk + 16;   // floats a staged codeword: 16 mod 32
constexpr int kStageFloats = kTileCodes * kStageStride + kTileCodes;  // + the tile's ||e||^2
constexpr int kTiledThreads = 256;
constexpr int kMaxStages = 4;

// Floats a shared residual row takes: D rounded up to whole chunks, + 16
// (16 mod 32: the 16-byte reads of rows g and g+1 fall on distinct banks).
int tiled_dr(int D) { return (D + kChunk - 1) / kChunk * kChunk + 16; }
constexpr int kMaxRanks = 8;  // the largest portable cluster
// Codewords a cluster rank takes: K / ranks, in whole tiles.
int tiled_part(int K, int ranks) {
  return ((K + ranks - 1) / ranks + kTileCodes - 1) / kTileCodes * kTileCodes;
}
// Blocks a row tile: 2, or more (up to 8) while the grid stays within one
// wave of the SMs, so that a few row tiles still fill the card.
int tiled_ranks(int tiles, int sms) {
  int ranks = 2;
  while (ranks < kMaxRanks && tiles * ranks * 2 <= sms) ranks *= 2;
  return ranks;
}

struct TiledParams {
  const float* x;
  const float* cb;
  const float* esq;  // [Q][K]
  int* codes;
  float* quant;
  int N, D, Q, K, part, ranks, stages, dr;
};

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits, ties away from
// zero) with integer operations, lo = v - hi exactly (|lo| <= 2^-11 |v|),
// left for the tensor core to cut to TF32 (a further <= 2^-10 |lo|).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
// The 64-bit word at `p` (this block's shared memory) in cluster block `rank`
// := v.
__device__ __forceinline__ void st_peer(void* p, uint32_t rank, unsigned long long v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(peer_addr(p, rank)), "l"(v) : "memory");
}
// Arrive on the mbarrier at `bar` (this block's layout) in cluster block
// `rank`, releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void arrive_peer(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(peer_addr(bar, rank)) : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__global__ void __launch_bounds__(kTiledThreads, 1) rvq_tiled_kernel(const TiledParams p) {
  extern __shared__ float4 smem4[];
  const int N = p.N, D = p.D, D4 = D / 4, Q = p.Q, K = p.K, S = p.stages, dr = p.dr;
  const int ranks = p.ranks;
  float* rows = reinterpret_cast<float*>(smem4);                        // [64][dr]
  float* stages = rows + kTileRows * dr;                                // [S][kStageFloats]
  unsigned long long* red = reinterpret_cast<unsigned long long*>(stages + S * kStageFloats);
  unsigned long long* inbox = red + 4 * kTileRows;                      // [2][kMaxRanks][64]
  int* pick = reinterpret_cast<int*>(inbox + 2 * kMaxRanks * kTileRows);  // [64]
  uint64_t* inbar = reinterpret_cast<uint64_t*>(pick + kTileRows);      // [2]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const uint32_t rank = cluster_rank();
  const int row0 = (blockIdx.x / ranks) * kTileRows;
  const int k_begin = rank * p.part;
  const int k_end = min(K, k_begin + p.part);
  const int n_codes = max(0, k_end - k_begin);
  const int n_tiles = (n_codes + kTileCodes - 1) / kTileCodes;
  const int KC = (D + kChunk - 1) / kChunk;
  const int per_level = n_tiles * KC;
  const int n_rows = min(kTileRows, N - row0);

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(&inbar[b], kTileRows * (ranks - 1));  // peers' keys
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int dr4 = dr / 4;
  for (int i = tid; i < kTileRows * dr4; i += kTiledThreads) {
    const int r = i / dr4, c = i % dr4;
    float4 v = zero4;
    if (r < n_rows && c < D4) v = reinterpret_cast<const float4*>(p.x)[(row0 + r) * static_cast<size_t>(D4) + c];
    reinterpret_cast<float4*>(rows + r * dr)[c] = v;
  }
  __syncthreads();
  cluster_sync();  // every block's barriers are initialized before a peer arrives on them

  // The copy ring: tile (q, nt, kc) of this block's sequence (level,
  // codeword tile, chunk of D) into stage t % S, S - 1 tiles ahead of the
  // products, issued by all threads as 16-byte copies (zeros past the tile's
  // codewords or past D) plus the codewords' ||e||^2.
  int lq = 0, lnt = 0, lkc = 0, lt = 0;  // the next tile to load
  const int T = Q * per_level;
  auto load_next = [&]() {
    if (lt < T) {
      const int kt = k_begin + lnt * kTileCodes, n_valid = min(kTileCodes, k_end - kt);
      const int col0 = lkc * kChunk, ncol = min(kChunk, D - col0);
      const float* base = p.cb + static_cast<size_t>(lq) * K * D;
      float* dst = stages + (lt % S) * kStageFloats;
#pragma unroll
      for (int j = 0; j < kTileCodes * (kChunk / 4) / kTiledThreads; ++j) {
        const int i = tid + j * kTiledThreads;
        const int r = i / (kChunk / 4), c = i % (kChunk / 4);
        const bool valid = r < n_valid && 4 * c < ncol;
        cp_async16(dst + r * kStageStride + 4 * c,
                   valid ? base + static_cast<size_t>(kt + r) * D + col0 + 4 * c : p.cb, valid);
      }
      if (tid < kTileCodes) {
        const bool valid = tid < n_valid;
        cp_async4(dst + kTileCodes * kStageStride + tid,
                  valid ? p.esq + static_cast<size_t>(lq) * K + kt + tid : p.esq, valid);
      }
      ++lt;
      if (++lkc == KC) {
        lkc = 0;
        if (++lnt == n_tiles) {
          lnt = 0;
          ++lq;
        }
      }
    }
    cp_commit();
  };
  for (int st = 0; st < S - 1; ++st) load_next();

  // Consumers: warp tile rows 32 wr .. +32 (two m16 tiles) x codewords
  // 32 wc .. +32 of a codeword tile (four n8 tiles)
  const uint32_t own = rank == 0 ? owned_rows(n_rows, D4, 1, 0, kTiledThreads) : 0u;
  const int wr = warp & 1, wc = warp >> 1;
  const int g = lane / 4, tig = lane % 4;
  float acc[2][4][4];
  // the running best of each of the thread's 4 rows: a thread sees its
  // codewords in increasing index order, so a strict '<' keeps the lowest
  // index on ties; NaN never wins; bi < 0: none yet
  float bd[2][2];
  int bi[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
    }
    bd[mi][0] = bd[mi][1] = INFINITY;
    bi[mi][0] = bi[mi][1] = -1;
  }
#ifdef RSTNET_RVQ_MARKS
  long long t_span_[4] = {0, 0, 0, 0}, t_last_ = clock64();
#endif
  int t = 0;
  for (int q = 0; q < Q; ++q) {
    for (int i = 0; i < per_level; ++i, ++t) {
      TILED_T(3);
      const int st_i = t % S;
      cp_wait(S - 2);
      __syncthreads();  // tile t landed for all; stage (t - 1) % S is free
      TILED_T(0);
      load_next();
      const int nt = i / KC, kc = i % KC;
      TILED_T(1);
      const float* st = stages + st_i * kStageFloats;
#pragma unroll 1
      for (int j = 0; j < kChunk / 16; ++j) {  // not unrolled: the body stays in the i-cache
        float4 av[2][2], bv[4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* rp = rows + (32 * wr + 16 * mi + g) * dr + kc * kChunk + 16 * j + 4 * tig;
          av[mi][0] = *reinterpret_cast<const float4*>(rp);
          av[mi][1] = *reinterpret_cast<const float4*>(rp + 8 * dr);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bv[ni] = *reinterpret_cast<const float4*>(st + (32 * wc + 8 * ni + g) * kStageStride +
                                                    16 * j + 4 * tig);
        }
        // k8 step 0 takes .x/.y, step 1 .z/.w: logical k tig <-> 4 tig + 2s,
        // tig + 4 <-> 4 tig + 2s + 1, the same on both sides
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float4 u = av[mi][0], w = av[mi][1];
            split_tf32(s ? u.z : u.x, ahi[mi][0], alo[mi][0]);
            split_tf32(s ? w.z : w.x, ahi[mi][1], alo[mi][1]);
            split_tf32(s ? u.w : u.y, ahi[mi][2], alo[mi][2]);
            split_tf32(s ? w.w : w.y, ahi[mi][3], alo[mi][3]);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            split_tf32(s ? bv[ni].z : bv[ni].x, bhi[ni][0], blo[ni][0]);
            split_tf32(s ? bv[ni].w : bv[ni].y, bhi[ni][1], blo[ni][1]);
          }
          // term by term over the 8 tiles, small terms first
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], alo[mi], bhi[ni][0], bhi[ni][1]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ahi[mi], blo[ni][0], blo[ni][1]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ahi[mi], bhi[ni][0], bhi[ni][1]);
          }
        }
      }
      TILED_T(2);
      if (kc == KC - 1) {  // the tile's dots are complete: keys, running minimum
        const float* es = st + kTileCodes * kStageStride;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {  // codewords in increasing order
                const int c = 2 * hh + cc;
                const int cl = 32 * wc + 8 * ni + 2 * tig + cc;
                const int k = k_begin + nt * kTileCodes + cl;
                const float dist = fmaf(-2.0f, acc[mi][ni][c], es[cl]);
                if (k < k_end && (dist < bd[mi][hh] || (bi[mi][hh] < 0 && dist == dist))) {
                  bd[mi][hh] = dist;
                  bi[mi][hh] = k;
                }
                acc[mi][ni][c] = 0.f;
              }
            }
          }
        }
      }
    }
    // level q: the block's best per row, then the cluster's: each block
    // pushes its keys into every peer's inbox and arrives on its barrier
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned long long b = bi[mi][hh] < 0 ? kNoKey : dist_key(bd[mi][hh], bi[mi][hh]);
        b = key_min(b, __shfl_xor_sync(0xffffffffu, b, 1));
        b = key_min(b, __shfl_xor_sync(0xffffffffu, b, 2));
        if (tig == 0) red[wc * kTileRows + 32 * wr + 16 * mi + 8 * hh + g] = b;
        bd[mi][hh] = INFINITY;
        bi[mi][hh] = -1;
      }
    }
    __syncthreads();
    if (tid < kTileRows) {
      unsigned long long k = kNoKey;
#pragma unroll
      for (int w = 0; w < 4; ++w) k = key_min(k, red[w * kTileRows + tid]);
      unsigned long long* box = inbox + ((q & 1) * kMaxRanks + rank) * kTileRows + tid;
      for (int j = 1; j < ranks; ++j) {
        const uint32_t peer = (rank + j) % ranks;
        st_peer(box, peer, k);
        arrive_peer(&inbar[q & 1], peer);
      }
      mbar_wait_cluster(&inbar[q & 1], (q >> 1) & 1);
      for (int j = 1; j < ranks; ++j) {
        const uint32_t src = (rank + j) % ranks;
        k = key_min(k, inbox[((q & 1) * kMaxRanks + src) * kTileRows + tid]);
      }
      const int idx = k == kNoKey ? 0 : static_cast<int>(k & 0xFFFFFFFFull);  // all NaN: 0
      pick[tid] = idx;
      if (rank == 0 && tid < n_rows) p.codes[static_cast<size_t>(row0 + tid) * Q + q] = idx;
    }
    __syncthreads();
    // every rank updates its residual; rank 0 owns the quantized sums
    update_rows(p.cb + static_cast<size_t>(q) * K * D, [&](int r) { return pick[r]; }, rows, dr,
                p.quant + static_cast<size_t>(row0) * D, n_rows, D4, q, q + 1 < Q, own,
                kTiledThreads);
    __syncthreads();
  }
  TILED_T(3);
  TILED_DUMP();
  cp_wait(0);
}

size_t tiled_smem(int dr, int stages) {
  return 4 * (static_cast<size_t>(kTileRows) * dr + static_cast<size_t>(stages) * kStageFloats) +
         8 * (4 * kTileRows + 2 * kMaxRanks * kTileRows) + 4 * kTileRows + 8 * 2;
}

int tiled_stages(int D) {
  const int dr = tiled_dr(D);
  int s = kMaxStages;
  while (s >= 2 && tiled_smem(dr, s) > static_cast<size_t>(kSmemLimit)) --s;
  return s;  // < 2: does not fit
}

// The SM count of the current device, and its opt-in to kSmemLimit bytes of
// dynamic shared memory for both kernels, once a process and device.
int device_setup(int* sms) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(rvq_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(rvq_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) cached[dev] = *sms;
  return 0;
}

}  // namespace

#ifdef RSTNET_RVQ_MARKS
// The phase marks of the last split-path launch: [160 blocks][9][8] int64.
extern "C" int rvq_marks_copy(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, rvq_marks, sizeof(rvq_marks)));
}
#endif

// Bytes of scratch that rvq_encode takes for these sizes and path: split,
// 8 (1 + Q N) (an arrival counter and a key word a level and row; the caller keeps one
// buffer per stream, sets the counter to 0 and every key word to all ones
// once, and each launch leaves it so); tiled, 4 Q K (the codewords'
// ||e||^2, written by the call).
extern "C" long long rvq_encode_scratch_bytes(int N, int D, int Q, int K, int split) {
  (void)D;
  if (split) return 8LL * (1 + static_cast<long long>(Q) * N);
  return 4LL * Q * K;
}

// x [N, D] f32, codebooks [Q, K, D] f32 -> codes [N, Q] int32, quant [N, D]
// f32. split != 0 takes the split path (one cooperative launch; N <=
// kSplitMaxRows), else the tiled one (two launches: the norms, then clusters of 2-8 blocks a row
// tile). N >= 1, D % 4 == 0, D <= 512, K, Q >= 1; all pointers 16-byte
// aligned. Returns the first failing cudaError_t (a shape the path cannot
// take: cudaErrorInvalidValue; a refused cooperative launch:
// cudaErrorCooperativeLaunchTooLarge), else cudaGetLastError().
extern "C" int rvq_encode(const void* x, const void* codebooks, void* codes, void* quant,
                          void* scratch, int N, int D, int Q, int K, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || D % 4 != 0 || D > 512 || Q < 1 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  int err = device_setup(&sms);
  if (err != 0) return err;
  if (split) {
    SplitShape sh;
    err = split_shape(N, D, Q, K, sms, &sh);
    if (err != 0) return err;
    SplitParams p{static_cast<const float*>(x), static_cast<const float*>(codebooks),
                  static_cast<int*>(codes), static_cast<float*>(quant),
                  static_cast<unsigned long long*>(scratch), N, D, Q, K, sh.slice, sh.stages,
                  sh.dp, sh.nrb};
    void* args[] = {&p};
    cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rvq_split_kernel),
                                                dim3(sh.blocks), dim3(kSplitThreads), args,
                                                sh.smem, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const int stages = tiled_stages(D);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  float* esq = static_cast<float*>(scratch);
  const int QK = Q * K;
  codeword_sq_norms<<<(QK + 7) / 8, 256, 0, s>>>(static_cast<const float*>(codebooks), esq, QK,
                                                 D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int dr = tiled_dr(D);
  const int tiles = (N + kTileRows - 1) / kTileRows;
  const int ranks = tiled_ranks(tiles, sms);
  TiledParams p{static_cast<const float*>(x), static_cast<const float*>(codebooks), esq,
                static_cast<int*>(codes), static_cast<float*>(quant), N, D, Q, K,
                tiled_part(K, ranks), ranks, stages, dr};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * tiles);
  cfg.blockDim = dim3(kTiledThreads);
  cfg.dynamicSmemBytes = tiled_smem(dr, stages);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, rvq_tiled_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
