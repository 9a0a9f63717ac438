// K9: fused scores + segment maxima of the flat index search, for Hopper
// (sm_90a). It replaces the Pallas `kernel` of
// `FlatIndex._pallas_scores_segmax` (gritlm_tpu/index/flat.py); the plain
// version is in gritlm_tpu_torch/ops/scores_segmax.py.
//
// What bounds it at the search's shape (a 256-query block against 2^20
// corpus rows of 4096): the bytes, one read of the 8.6 GB corpus and the
// 1.07 GB fp32 score write, and close behind them the 2.2 TFLOP of the
// product. So the corpus is read from device memory once per query block,
// every product is a wgmma, and the scores go from the accumulator
// registers straight to device memory:
// - a block holds the whole query block (up to 256 rows) against one
//   corpus tile of 128 columns, one segment. Two consumer warpgroups own
//   128 query rows each, as two 64-row wgmmas with their 2 x 64 fp32
//   accumulators in registers;
// - a producer warp, whose warpgroup's registers go to the consumers
//   (setmaxnreg), drives a ring of STAGES stages by TMA: a stage holds a
//   64-deep slice of the query block (32 KB, from L2 after its first read)
//   and of the corpus tile (16 KB), signalled by full and empty mbarriers;
// - the grid is persistent, one block an SM walking the tiles (query block
//   fastest, so the blocks that share a corpus tile run side by side), so
//   the producer loads the next tile while the consumers write this one;
// - the epilogue sets columns >= n_docs to -inf, writes the fp32 scores
//   (each quad of threads a 32-byte piece of a row), and takes each row's
//   segment maximum as the thread's columns' maximum and then the quad's,
//   written into the transposed [ceil(N/128), Q] layout; a partial last
//   segment's maximum is over its real columns. Tiles wholly at or past
//   n_docs load nothing and write -inf.
// A query row tile (64 rows) wholly past Q issues no product, so Q = 4 (the
// RAG path) costs the corpus read and one wgmma row tile.
//
// An fp32 corpus (the retrieval eval's index) goes to a second kernel,
// `f32::scores_segmax_f32_kernel` below: exact fp32 FMAs on the SIMT pipes,
// with the same outputs.
#include "common.cuh"
#include "sm90.cuh"

using gritlm::bf16;

namespace {

constexpr int SEG = 128;                        // corpus columns of a tile (= the segment)
constexpr int QB = 256;                         // query rows of a block
constexpr int KC = 64;                          // depth of a ring stage
constexpr int WG = 128;                         // threads of a warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups a block
constexpr int NTHREADS = WG * (CONSUMERS + 1);  // and the producer's warpgroup
constexpr int WG_ROWS = QB / CONSUMERS;         // query rows of a consumer
constexpr int STAGES = 4;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WG * PRODUCER_REGS + WG * CONSUMERS * CONSUMER_REGS <= 65536, "register split");

// A stage: the query slice (QB rows x 128 bytes, 128-byte swizzle), then the
// corpus slice (SEG rows x 128 bytes); the barriers after the ring.
constexpr uint32_t Q_SLICE = QB * 128;
constexpr uint32_t E_SLICE = SEG * 128;
constexpr uint32_t STAGE_BYTES = Q_SLICE + E_SLICE;
constexpr uint32_t OFF_BAR = STAGES * STAGE_BYTES;
constexpr uint32_t SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "shared memory of one block");

__device__ __forceinline__ uint64_t kmajor(uint32_t rows) {
  return sm90::desc_sw128(rows, 16, 1024);
}

// acc[rt] (+)= Q rows [64 rt, 64 rt + 64) of the warpgroup . E^T over the
// stage's 64-deep slice: 4 k-steps of 16, each 32 bytes along the rows.
template <int RT>
__device__ __forceinline__ void slice_steps(float (&acc)[64], uint64_t dq, uint64_t de, int first) {
  sm90::wgmma_m64n128k16_ss<RT * 64 * 128, 0>(acc, dq, de, !first);
  sm90::wgmma_m64n128k16_ss<RT * 64 * 128 + 32, 32>(acc, dq, de, 1);
  sm90::wgmma_m64n128k16_ss<RT * 64 * 128 + 64, 64>(acc, dq, de, 1);
  sm90::wgmma_m64n128k16_ss<RT * 64 * 128 + 96, 96>(acc, dq, de, 1);
}

// Scores and segment maxima of a 64-row accumulator tile (rows row0 and
// row0 + 8 of the thread, columns n0 + 8 j + c2 + e).
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* __restrict__ scores,
                                           float* __restrict__ segmax, int row0, int n0, int seg,
                                           int c2, int lane, int Q, int N, int n_docs) {
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + 8 * ri;
    float* dst = scores + (long long)row * N;
    float mx = neg_inf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + c2;
      const float v0 = col < n_docs ? acc[4 * j + 2 * ri] : neg_inf;
      const float v1 = col + 1 < n_docs ? acc[4 * j + 2 * ri + 1] : neg_inf;
      mx = fmaxf(mx, fmaxf(v0, v1));
      if (row < Q) {
        if ((N & 1) == 0) {
          if (col < N) *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
        } else {
          if (col < N) dst[col] = v0;
          if (col + 1 < N) dst[col + 1] = v1;
        }
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(gritlm::FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(gritlm::FULL, mx, 2));
    if (lane % 4 == 0 && row < Q) segmax[(long long)seg * Q + row] = mx;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
scores_segmax_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap te, float* __restrict__ scores,
                     float* __restrict__ segmax, int Q, int N, int D, int n_docs, int n_qb,
                     int n_tiles, uint32_t stage_tx) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + OFF_BAR, empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, WG * CONSUMERS);  // every consumer thread arrives
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int nk = (D + KC - 1) / KC;  // slices a tile; depth past D reads as zeros

  if (tid >= CONSUMERS * WG) {
    // ------------------------------------------------------------ producer
    sm90::regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * WG) {  // one thread drives the ring
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int seg = t / n_qb, qb = t - seg * n_qb;
        if (seg * SEG >= n_docs) continue;  // a wholly masked tile loads nothing
        for (int c = 0; c < nk; ++c) {
          sm90::mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t fb = full + 8 * stage, st = base + stage * STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(fb, stage_tx);
          sm90::tma_load_2d(st, &tq, fb, c * KC, qb * QB);
          sm90::tma_load_2d(st + Q_SLICE, &te, fb, c * KC, seg * SEG);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // -------------------------------------------------------------- consumers
    sm90::regs_inc<CONSUMER_REGS>();
    const int w = __shfl_sync(gritlm::FULL, tid / WG, 0);
    const int warp = (tid % WG) / 32, lane = tid % 32, c2 = 2 * (lane % 4);
    float acc0[64], acc1[64];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int seg = t / n_qb, qb = t - seg * n_qb;
      const int n0 = seg * SEG;
      const int qr0 = qb * QB + w * WG_ROWS;  // the warpgroup's first query row
      const bool live0 = qr0 < Q, live1 = qr0 + 64 < Q;
      if (n0 >= n_docs) {  // every column masked: -inf, nothing loaded
        const float neg_inf = __int_as_float(0xff800000);
        for (int i = tid % WG; i < WG_ROWS * SEG; i += WG) {
          const int row = qr0 + i / SEG;
          const int col = n0 + i % SEG;
          if (row < Q && col < N) scores[(long long)row * N + col] = neg_inf;
        }
        if (qr0 + tid % WG < Q) segmax[(long long)seg * Q + qr0 + tid % WG] = neg_inf;
        continue;
      }
      for (int c = 0; c < nk; ++c) {
        sm90::mbar_wait(full + 8 * stage, phase);
        const uint32_t st = base + stage * STAGE_BYTES;
        const uint64_t dq = kmajor(st + w * WG_ROWS * 128), de = kmajor(st + Q_SLICE);
        sm90::wgmma_fence();
        if (live0) slice_steps<0>(acc0, dq, de, c == 0);
        if (live1) slice_steps<1>(acc1, dq, de, c == 0);
        sm90::wgmma_commit();
        // the previous slice's products are done: release its stage
        sm90::wgmma_wait<1>();
        if (c > 0) sm90::mbar_arrive(empty + 8 * (stage == 0 ? STAGES - 1 : stage - 1));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      sm90::mbar_arrive(empty + 8 * (stage == 0 ? STAGES - 1 : stage - 1));
      const int row0 = qr0 + warp * 16 + lane / 4;
      if (live0) store_tile(acc0, scores, segmax, row0, n0, seg, c2, lane, Q, N, n_docs);
      if (live1) store_tile(acc1, scores, segmax, row0 + 64, n0, seg, c2, lane, Q, N, n_docs);
    }
  }
}

// ------------------------------------------------------------------ fp32
// K9 on an fp32 corpus, as the JAX retrieval eval builds its index
// (gritlm_tpu/eval/retrieval.py: FlatIndex(..., dtype=np.float32)); the
// Pallas kernel then takes fp32 operands with fp32 sums. Same function and
// outputs as the bf16 kernel above. The products are exact fp32 FMAs:
// single-pass TF32 tensor cores round each operand to a 10-bit mantissa and
// compute another function. So this kernel is bound by the fp32 FMA rate
// (2 x 132 SMs x 128 lanes x the clock, about 67 TFLOP/s at 1.98 GHz), far
// above the bytes (a 256-query block against 2^18 rows of 4096: 8.2 ms of
// FMAs, 1.4 ms of reads). Its design keeps the FMA pipes fed from shared
// memory:
// - a block owns 64 query rows x one 128-column segment; 256 threads, each
//   an 8 x 4 register tile of sums (rows 8 w .. 8 w + 7 of warp w, columns
//   lane + 32 j), so a warp holds whole rows of the segment;
// - 16-byte cp.async copies stage 32-deep slices of the query rows and the
//   corpus tile through two shared-memory buffers (rows padded to 36
//   floats: a warp's reads of 32 corpus rows hit every bank once per 8
//   lanes, and its reads of a query row are one broadcast);
// - the blocks that share a corpus tile have neighbouring indices, so the
//   corpus is read from device memory about once per query block;
// - the epilogue masks columns >= n_docs to -inf, writes the scores (a warp
//   writes 128 contiguous bytes a row and column group) and reduces each
//   row's segment maximum by warp shuffles, so the scores are never read
//   back. Tiles wholly at or past n_docs load nothing and write -inf.
namespace f32 {

constexpr int ROWS = 64;       // query rows of a block
constexpr int KD = 32;         // depth of a stage
constexpr int LD = KD + 4;     // row stride in shared memory, in floats
constexpr int THREADS = 256;
constexpr int TR = 8, TC = 4;  // a thread's rows and columns
static_assert(THREADS / 32 * TR == ROWS && 32 * TC == SEG, "thread tiles cover the block");
constexpr int Q_FLOATS = ROWS * LD;
constexpr int STAGE_FLOATS = (ROWS + SEG) * LD;
constexpr uint32_t SMEM = 2 * STAGE_FLOATS * sizeof(float);

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Rows [r0, r0 + rows) of x [n, D], depth [k0, k0 + KD), into dst (stride
// LD); rows past n and depth past D are zero-filled.
template <int ROWS_>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ x, int r0,
                                           int n, int D, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS_ * (KD / 4) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (KD / 4), kk = c % (KD / 4) * 4;
    const bool in = r0 + r < n && k0 + kk < D;
    gritlm::cp_async16(dst + r * LD + kk, in ? x + (long long)(r0 + r) * D + k0 + kk : x,
                       in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
scores_segmax_f32_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                         float* __restrict__ scores, float* __restrict__ segmax, int Q, int N,
                         int D, int n_docs, int n_qb) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qb = blockIdx.x % n_qb, seg = blockIdx.x / n_qb;  // query block fastest
  const int r0 = qb * ROWS, n0 = seg * SEG;
  const float neg_inf = __int_as_float(0xff800000);
  if (n0 >= n_docs) {  // every column masked: -inf, nothing loaded
    for (int i = tid; i < ROWS * SEG; i += THREADS) {
      const int row = r0 + i / SEG, col = n0 + i % SEG;
      if (row < Q && col < N) scores[(long long)row * N + col] = neg_inf;
    }
    if (tid < ROWS && r0 + tid < Q) segmax[(long long)seg * Q + r0 + tid] = neg_inf;
    return;
  }
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  const int nk = (D + KD - 1) / KD;
  stage_rows<ROWS>(sm, q, r0, Q, D, 0, tid);
  stage_rows<SEG>(sm + Q_FLOATS, emb, n0, N, D, 0, tid);
  commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) {  // the next slice into the other buffer
      float* nxt = sm + ((c + 1) & 1) * STAGE_FLOATS;
      stage_rows<ROWS>(nxt, q, r0, Q, D, (c + 1) * KD, tid);
      stage_rows<SEG>(nxt + Q_FLOATS, emb, n0, N, D, (c + 1) * KD, tid);
    }
    commit();  // an empty group on the last slice keeps the count
    wait_prev();
    __syncthreads();
    const float* sq = sm + (c & 1) * STAGE_FLOATS + warp * TR * LD;
    const float* se = sm + (c & 1) * STAGE_FLOATS + Q_FLOATS + lane * LD;
#pragma unroll
    for (int k = 0; k < KD; k += 4) {
      float4 b[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = *reinterpret_cast<const float4*>(se + j * 32 * LD + k);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(sq + i * LD + k);
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the buffer is read before the next slice's copy overwrites it
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = r0 + warp * TR + i;
    float mx = neg_inf;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = n0 + lane + 32 * j;
      const float v = col < n_docs ? acc[i][j] : neg_inf;
      mx = fmaxf(mx, v);
      if (row < Q && col < N) scores[(long long)row * N + col] = v;
    }
    mx = gritlm::warp_max(mx);
    if (lane == i && row < Q) segmax[(long long)seg * Q + row] = mx;
  }
}

}  // namespace f32

}  // namespace

extern "C" int gritlm_scores_segmax(const void* q, const void* emb, void* scores,
                                    void* segmax, int Q, int N, int D, int n_docs,
                                    void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        scores_segmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // A query slice of Q <= 256 rows is loaded as the 64-row tiles that hold
  // them: a box reaching far past the matrix is slow to fill with zeros (on
  // an H100 80GB HBM3 at 700 W, Q = 4 against 2^20 rows took 5.11 ms with a
  // 256-row box and 2.96 ms with a 64-row one).
  const int q_box = Q >= QB ? QB : (Q + 63) / 64 * 64;
  const int n_qb = (Q + QB - 1) / QB;
  const long long n_tiles = ((long long)N + SEG - 1) / SEG * n_qb;
  if (n_tiles == 0) return 0;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, te;
  int rc = sm90::make_map_2d(&tq, q, Q, D, q_box);
  if (!rc) rc = sm90::make_map_2d(&te, emb, N, D, SEG);
  if (rc) return rc;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  scores_segmax_kernel<<<grid, NTHREADS, SMEM, (cudaStream_t)stream>>>(
      tq, te, (float*)scores, (float*)segmax, Q, N, D, n_docs, n_qb, (int)n_tiles,
      (uint32_t)q_box * 128 + E_SLICE);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of K9 takes, in bytes (for reports).
extern "C" int gritlm_scores_segmax_smem() { return (int)SMEM; }

// K9 on fp32 operands: the same arguments and outputs as
// gritlm_scores_segmax, for q [Q, D] and emb [N, D] in fp32 (D % 4 == 0,
// 16-byte aligned rows).
extern "C" int gritlm_scores_segmax_f32(const void* q, const void* emb, void* scores,
                                        void* segmax, int Q, int N, int D, int n_docs,
                                        void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(f32::scores_segmax_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)f32::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_qb = (Q + f32::ROWS - 1) / f32::ROWS;
  const long long blocks = ((long long)N + SEG - 1) / SEG * n_qb;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32::scores_segmax_f32_kernel<<<(unsigned)blocks, f32::THREADS, f32::SMEM,
                                  (cudaStream_t)stream>>>(
      (const float*)q, (const float*)emb, (float*)scores, (float*)segmax, Q, N, D, n_docs, n_qb);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of the fp32 kernel takes, in bytes.
extern "C" int gritlm_scores_segmax_f32_smem() { return (int)f32::SMEM; }
