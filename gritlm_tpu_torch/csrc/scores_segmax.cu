// K9: fused scores + segment maxima of the flat index search, for Hopper
// (sm_90a). The design note and the plain version are in
// gritlm_tpu_torch/ops/scores_segmax.py.
//
// One block of 8 warps per (128 query rows, one 128-column segment of the
// corpus). The block walks the depth D in chunks of 64, double-buffered in
// shared memory with cp.async; each warp forms a 32 x 64 piece of the
// 128 x 128 score tile with bf16 tensor-core MMAs (wmma) and fp32
// accumulators in registers. The epilogue stages the tile in shared memory,
// masks columns >= n_docs to -inf, writes the fp32 scores (one warp per row,
// 32 consecutive columns per store) and reduces each row's maximum over the
// segment's real columns, so no reduction crosses blocks. Blocks are ordered
// query tile fastest, so the query tiles of one segment run side by side and
// a corpus tile re-read by the second query tile comes from L2.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using gritlm::bf16;

namespace {

constexpr int SEG = 128;        // corpus columns per block (= the segment)
constexpr int BQ = 128;         // query rows per block
constexpr int BK = 64;          // depth per pipeline stage
constexpr int NWARP = 8;        // 4 (rows) x 2 (columns) warps
constexpr int NTHREADS = NWARP * 32;
constexpr int WM = 32, WN = 64; // warp tile
constexpr int LDT = BK + 8;     // bf16 row stride of the staged tiles
constexpr int LDS = SEG + 4;    // fp32 row stride of the epilogue tile

constexpr size_t STAGE_ELEMS = size_t(BQ + SEG) * LDT;
constexpr size_t PIPE_BYTES = 2 * STAGE_ELEMS * sizeof(bf16);
constexpr size_t EPI_BYTES = size_t(BQ) * LDS * sizeof(float);
constexpr size_t SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage q[q0:q0+BQ, k0:k0+BK] and emb[n0:n0+SEG, k0:k0+BK]; rows past Q or N
// and depth past D are zero-filled (D % 8 == 0, so a 16-byte piece is
// either wholly inside or wholly outside).
__device__ __forceinline__ void load_stage(bf16* sq, bf16* se, const bf16* __restrict__ q,
                                           const bf16* __restrict__ emb, int Q, int N, int D,
                                           int q0, long long n0, int k0, int tid) {
  constexpr int PIECES = BK / 8;
  for (int i = tid; i < BQ * PIECES; i += NTHREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const bool in = q0 + r < Q && k0 + c < D;
    gritlm::cp_async16(sq + r * LDT + c, in ? q + (long long)(q0 + r) * D + k0 + c : q,
                       in ? 16 : 0);
  }
  for (int i = tid; i < SEG * PIECES; i += NTHREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const bool in = n0 + r < N && k0 + c < D;
    gritlm::cp_async16(se + r * LDT + c, in ? emb + (n0 + r) * D + k0 + c : emb,
                       in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
scores_segmax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ emb,
                     float* __restrict__ scores, float* __restrict__ segmax, int Q, int N,
                     int D, int n_docs, int n_qtiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  float* tile = reinterpret_cast<float*>(smem);  // the epilogue reuses the stages

  const int qt = blockIdx.x % n_qtiles;
  const long long seg = blockIdx.x / n_qtiles;
  const int q0 = qt * BQ;
  const long long n0 = seg * SEG;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (D + BK - 1) / BK;
  load_stage(stage, stage + BQ * LDT, q, emb, Q, N, D, q0, n0, 0, tid);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      bf16* nxt = stage + ((t + 1) & 1) * STAGE_ELEMS;
      load_stage(nxt, nxt + BQ * LDT, q, emb, Q, N, D, q0, n0, (t + 1) * BK, tid);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = stage t
    cp_async_wait_one();
    __syncthreads();
    const bf16* sq = stage + (t & 1) * STAGE_ELEMS;
    const bf16* se = sq + BQ * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[WM / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], sq + (wr * WM + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        // B = emb^T: element (k, n) of the tile sits at n * LDT + k
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, se + (wc * WN + j * 16) * LDT + kk, LDT);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // this stage is overwritten by the load two steps on
  }

#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j)
      wmma::store_matrix_sync(tile + (wr * WM + i * 16) * LDS + wc * WN + j * 16, acc[i][j],
                              LDS, wmma::mem_row_major);
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  for (int r = warp; r < BQ && q0 + r < Q; r += NWARP) {
    const long long row = q0 + r;
    float m = neg_inf;
#pragma unroll
    for (int t = 0; t < SEG / 32; ++t) {
      const int c = lane + 32 * t;
      const long long col = n0 + c;
      if (col < N) {
        const float s = col < n_docs ? tile[r * LDS + c] : neg_inf;
        scores[row * N + col] = s;
        m = fmaxf(m, s);
      }
    }
    m = gritlm::warp_max(m);
    if (lane == 0) segmax[seg * Q + row] = m;
  }
}

}  // namespace

extern "C" int gritlm_scores_segmax(const void* q, const void* emb, void* scores,
                                    void* segmax, int Q, int N, int D, int n_docs,
                                    void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        scores_segmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_qtiles = (Q + BQ - 1) / BQ;
  const long long n_seg = ((long long)N + SEG - 1) / SEG;
  const long long blocks = n_seg * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  scores_segmax_kernel<<<(unsigned)blocks, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)emb, (float*)scores, (float*)segmax, Q, N, D, n_docs,
      n_qtiles);
  return (int)cudaGetLastError();
}
