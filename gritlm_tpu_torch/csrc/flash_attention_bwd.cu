// K4 and K5: the flash attention backward for Hopper (sm_90a), bf16 in, fp32
// accumulation. The design note and the plain version are in
// gritlm_tpu_torch/ops/flash_attention.py.
//
// Both kernels rebuild the probabilities from the forward's log-sum-exp,
//   P = exp(S * scale - lse)   under the forward's keep mask, else 0
//   dP = dO V^T,  dS = P * (dP - delta) * scale,  delta = rowsum(dO * O)
// and never hold more than one 64 x 64 tile of P in shared memory.
//
// K4 (dQ): one block of 4 warps per (q-tile of 64 rows, query head, batch
// row); each warp owns 16 query rows and keeps its dQ rows in wmma
// accumulators over the loop of 64-key tiles (dQ += dS K).
//
// K5 (dK, dV): one block of 4 warps per (k-tile of 64 keys, kv head, batch
// row); each warp owns 16 keys. The block loops over the GQA group's query
// heads and their q-tiles and accumulates dV += P^T dO and dK += dS^T Q in
// fp32 in shared memory, so the group's sum happens inside the block and
// dK/dV come out [B, Sk, Hkv, Dh] directly.
//
// Masking follows K1 (flash_attention.cu) exactly, so P agrees with the
// forward: padding, causal with `offset`, the sliding window (causal only);
// tiles above the causal diagonal, below the window or with no valid key
// are skipped. A row whose keys are all masked has lse == NEG_INF and gets
// zero gradients: every P and dS is selected, never multiplied, to 0.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using gritlm::bf16;
using gritlm::NEG_INF;

namespace {

constexpr int DH = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARP = 4;
constexpr int NTHREADS = NWARP * 32;
constexpr int LDQK = DH + 8;  // bf16 row stride of the Q/dO/K/V tiles
constexpr int LDS = 64 + 4;   // fp32 row stride of the 64 x 64 score tiles
constexpr int LDP = 64 + 8;   // bf16 row stride of the 64 x 64 P / dS tiles
constexpr int LDO = DH + 4;   // fp32 row stride of the dQ / dK / dV rows

constexpr size_t TILE16 = size_t(64) * LDQK * 2;  // one bf16 64 x 128 tile
constexpr size_t TILE32 = size_t(64) * LDS * 4;   // one fp32 64 x 64 tile
constexpr size_t TILEP = size_t(64) * LDP * 2;    // one bf16 64 x 64 tile
constexpr size_t ACC = size_t(64) * LDO * 4;      // one fp32 64 x 128 tile

// K4 layout: Q, dO, K, V | S, dP | dS | lse, delta, key mask.
// The final dQ rows are staged in the K/V region.
constexpr size_t DQ_OFF_DO = TILE16;
constexpr size_t DQ_OFF_K = 2 * TILE16;
constexpr size_t DQ_OFF_V = 3 * TILE16;
constexpr size_t DQ_OFF_S = 4 * TILE16;
constexpr size_t DQ_OFF_DP = DQ_OFF_S + TILE32;
constexpr size_t DQ_OFF_DS = DQ_OFF_DP + TILE32;
constexpr size_t DQ_OFF_LSE = DQ_OFF_DS + TILEP;
constexpr size_t DQ_OFF_DELTA = DQ_OFF_LSE + BQ * 4;
constexpr size_t DQ_OFF_MASK = DQ_OFF_DELTA + BQ * 4;
constexpr size_t DQ_SMEM = DQ_OFF_MASK + BK * 4;
static_assert(2 * TILE16 >= ACC, "dQ staging must fit the K/V region");

// K5 layout: K, V, Q, dO | S^T, dP^T | P^T, dS^T | dK, dV | lse, delta, mask.
constexpr size_t KV_OFF_V = TILE16;
constexpr size_t KV_OFF_Q = 2 * TILE16;
constexpr size_t KV_OFF_DO = 3 * TILE16;
constexpr size_t KV_OFF_S = 4 * TILE16;
constexpr size_t KV_OFF_DP = KV_OFF_S + TILE32;
constexpr size_t KV_OFF_P = KV_OFF_DP + TILE32;
constexpr size_t KV_OFF_DS = KV_OFF_P + TILEP;
constexpr size_t KV_OFF_DK = KV_OFF_DS + TILEP;
constexpr size_t KV_OFF_DV = KV_OFF_DK + ACC;
constexpr size_t KV_OFF_LSE = KV_OFF_DV + ACC;
constexpr size_t KV_OFF_DELTA = KV_OFF_LSE + BQ * 4;
constexpr size_t KV_OFF_MASK = KV_OFF_DELTA + BQ * 4;
constexpr size_t KV_SMEM = KV_OFF_MASK + BK * 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;

// Copy a 64 x 128 bf16 tile (rows at `row_stride` elements from `base`,
// row r holding position p0 + r) into shared memory; rows at or past `n`
// are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int p0, int n, int tid) {
  for (int i = tid; i < 64 * DH / 8; i += NTHREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const bool in = p0 + r < n;
    gritlm::cp_async16(dst + r * LDQK + c, in ? base + (p0 + r) * row_stride + c : base,
                       in ? 16 : 0);
  }
}

// out[16 x 64] (fp32, ld LDS) = A[16 x 128] . B[64 x 128]^T, both bf16 with
// row stride LDQK: one warp's rows of a score-shaped product.
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a, const bf16* b) {
  Acc acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int d = 0; d < DH; d += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + d, LDQK);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBt fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LDQK + d, LDQK);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// acc[16 x 128] (fp32 rows in shared memory, ld LDO) += A[16 x 64] . B[64 x 128],
// A bf16 with row stride LDP, B bf16 with row stride LDQK.
__device__ __forceinline__ void accumulate_rows(float* acc_rows, const bf16* a, const bf16* b) {
  Acc acc[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n)
    wmma::load_matrix_sync(acc[n], acc_rows + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDP);
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * LDQK + n * 16, LDQK);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < DH / 16; ++n)
    wmma::store_matrix_sync(acc_rows + n * 16, acc[n], LDO, wmma::mem_row_major);
}

__device__ __forceinline__ bool keeps(int kp, int qpos, int causal, int window) {
  bool kk = true;
  if (causal) kk = kp <= qpos;
  if (window > 0) kk = kk && kp > qpos - window;
  return kk;
}

// ---------------------------------------------------------------------- K4

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ mask,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
                    int H, int group, long long q_sb, long long q_ss, long long k_sb,
                    long long k_ss, long long v_sb, long long v_ss, long long m_sb,
                    long long do_sb, long long do_ss, int causal, int window, int offset,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = reinterpret_cast<bf16*>(smem + DQ_OFF_DO);
  bf16* sk = reinterpret_cast<bf16*>(smem + DQ_OFF_K);
  bf16* sv = reinterpret_cast<bf16*>(smem + DQ_OFF_V);
  float* ss = reinterpret_cast<float*>(smem + DQ_OFF_S);
  float* sdp = reinterpret_cast<float*>(smem + DQ_OFF_DP);
  bf16* sds = reinterpret_cast<bf16*>(smem + DQ_OFF_DS);
  float* slse = reinterpret_cast<float*>(smem + DQ_OFF_LSE);
  float* sdelta = reinterpret_cast<float*>(smem + DQ_OFF_DELTA);
  int* smask = reinterpret_cast<int*>(smem + DQ_OFF_MASK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bf16* kb = k + b * k_sb + (long long)hk * DH;
  const bf16* vb = v + b * v_sb + (long long)hk * DH;
  const int* mb = mask + b * m_sb;

  load_tile(sq, q + b * q_sb + (long long)h * DH, q_ss, q0, Sq, tid);
  load_tile(sdo, dout + b * do_sb + (long long)h * DH, do_ss, q0, Sq, tid);
  if (tid < BQ) {
    const bool in = q0 + tid < Sq;
    const long long row = ((long long)b * H + h) * Sq + q0 + tid;
    slse[tid] = in ? lse[row] : 0.f;
    sdelta[tid] = in ? delta[row] : 0.f;
  }

  Acc dqacc[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(dqacc[n], 0.f);

  // the same visited key range as the forward
  const int q_last = offset + min(q0 + BQ, Sq) - 1;
  int kend = Sk, kbeg = 0;
  if (causal) kend = min(Sk, q_last + 1);
  if (window > 0) kbeg = max(0, offset + q0 - window + 1) / BK * BK;
  gritlm::cp_async_wait_all();
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    int any = 0;
    if (tid < BK) {
      const int kp = k0 + tid;
      smask[tid] = kp < Sk ? mb[kp] : 0;
      any = smask[tid] != 0;
    }
    if (!__syncthreads_or(any)) continue;  // tile holds no valid key
    load_tile(sk, kb, k_ss, k0, Sk, tid);
    load_tile(sv, vb, v_ss, k0, Sk, tid);
    gritlm::cp_async_wait_all();
    __syncthreads();

    rows_times_tile_t(ss + warp * 16 * LDS, sq + warp * 16 * LDQK, sk);    // S = Q K^T
    rows_times_tile_t(sdp + warp * 16 * LDS, sdo + warp * 16 * LDQK, sv);  // dP = dO V^T
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qpos = offset + q0 + r;
      const bool row_in = q0 + r < Sq;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const bool kk = row_in && smask[c] != 0 && keeps(k0 + c, qpos, causal, window);
        const float p = kk ? expf(ss[r * LDS + c] * scale - slse[r]) : 0.f;
        const float ds = kk ? p * (sdp[r * LDS + c] - sdelta[r]) * scale : 0.f;
        sds[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's 16 rows
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, sds + warp * 16 * LDP + kk, LDP);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        FragB fb;
        wmma::load_matrix_sync(fb, sk + kk * LDQK + n * 16, LDQK);
        wmma::mma_sync(dqacc[n], fa, fb, dqacc[n]);
      }
    }
    __syncthreads();  // K/V/mask tiles are overwritten next
  }

  // stage the fp32 rows in the K/V region, then write bf16
  float* sacc = reinterpret_cast<float*>(smem + DQ_OFF_K);
#pragma unroll
  for (int n = 0; n < DH / 16; ++n)
    wmma::store_matrix_sync(sacc + warp * 16 * LDO + n * 16, dqacc[n], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BQ * DH / 8; i += NTHREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    if (q0 + r >= Sq) continue;
    __align__(16) bf16 o8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(sacc[r * LDO + c + e]);
    bf16* dst = dq + (((long long)b * Sq + q0 + r) * H + h) * DH + c;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o8);
  }
}

// ---------------------------------------------------------------------- K5

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ mask,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int group,
                     long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                     long long v_sb, long long v_ss, long long m_sb, long long do_sb,
                     long long do_ss, int causal, int window, int offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + KV_OFF_V);
  bf16* sq = reinterpret_cast<bf16*>(smem + KV_OFF_Q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + KV_OFF_DO);
  float* sst = reinterpret_cast<float*>(smem + KV_OFF_S);
  float* sdpt = reinterpret_cast<float*>(smem + KV_OFF_DP);
  bf16* spt = reinterpret_cast<bf16*>(smem + KV_OFF_P);
  bf16* sdst = reinterpret_cast<bf16*>(smem + KV_OFF_DS);
  float* sdk = reinterpret_cast<float*>(smem + KV_OFF_DK);
  float* sdv = reinterpret_cast<float*>(smem + KV_OFF_DV);
  float* slse = reinterpret_cast<float*>(smem + KV_OFF_LSE);
  float* sdelta = reinterpret_cast<float*>(smem + KV_OFF_DELTA);
  int* smask = reinterpret_cast<int*>(smem + KV_OFF_MASK);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int any = 0;
  if (tid < BK) {
    const int kp = k0 + tid;
    smask[tid] = kp < Sk ? mask[b * m_sb + kp] : 0;
    any = smask[tid] != 0;
  }
  for (int i = tid; i < BK * LDO; i += NTHREADS) {
    sdk[i] = 0.f;
    sdv[i] = 0.f;
  }
  // the q rows that can see this tile: causal rows at or after its first
  // key, window rows before its last key + window
  const int k_last = min(k0 + BK, Sk) - 1;
  int qbeg = 0, qend = Sq;
  if (causal) qbeg = max(0, k0 - offset);
  if (window > 0) qend = min(Sq, k_last + window - offset);
  if (__syncthreads_or(any) && qbeg < qend) {
    load_tile(sk, k + b * k_sb + (long long)hk * DH, k_ss, k0, Sk, tid);
    load_tile(sv, v + b * v_sb + (long long)hk * DH, v_ss, k0, Sk, tid);
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const bf16* qb = q + b * q_sb + (long long)h * DH;
      const bf16* dob = dout + b * do_sb + (long long)h * DH;
      const long long row0 = ((long long)b * H + h) * Sq;
      for (int q0 = qbeg / BQ * BQ; q0 < qend; q0 += BQ) {
        __syncthreads();  // the previous q-tile is consumed
        load_tile(sq, qb, q_ss, q0, Sq, tid);
        load_tile(sdo, dob, do_ss, q0, Sq, tid);
        if (tid < BQ) {
          const bool in = q0 + tid < Sq;
          slse[tid] = in ? lse[row0 + q0 + tid] : 0.f;
          sdelta[tid] = in ? delta[row0 + q0 + tid] : 0.f;
        }
        gritlm::cp_async_wait_all();
        __syncthreads();

        rows_times_tile_t(sst + warp * 16 * LDS, sk + warp * 16 * LDQK, sq);    // S^T = K Q^T
        rows_times_tile_t(sdpt + warp * 16 * LDS, sv + warp * 16 * LDQK, sdo);  // dP^T = V dO^T
        __syncwarp();

        for (int rr = 0; rr < 16; ++rr) {
          const int r = warp * 16 + rr;  // this warp's key
          const bool key_in = smask[r] != 0;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int c = lane + 32 * t;  // query row of the tile
            const bool kk = key_in && q0 + c < Sq &&
                            keeps(k0 + r, offset + q0 + c, causal, window);
            const float p = kk ? expf(sst[r * LDS + c] * scale - slse[c]) : 0.f;
            const float ds = kk ? p * (sdpt[r * LDS + c] - sdelta[c]) * scale : 0.f;
            spt[r * LDP + c] = __float2bfloat16(p);
            sdst[r * LDP + c] = __float2bfloat16(ds);
          }
        }
        __syncwarp();

        accumulate_rows(sdv + warp * 16 * LDO, spt + warp * 16 * LDP, sdo);  // dV += P^T dO
        accumulate_rows(sdk + warp * 16 * LDO, sdst + warp * 16 * LDP, sq);  // dK += dS^T Q
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < BK * DH / 8; i += NTHREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    if (k0 + r >= Sk) continue;
    __align__(16) bf16 k8[8];
    __align__(16) bf16 v8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      k8[e] = __float2bfloat16(sdk[r * LDO + c + e]);
      v8[e] = __float2bfloat16(sdv[r * LDO + c + e]);
    }
    const long long off = (((long long)b * Sk + k0 + r) * Hkv + hk) * DH + c;
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(k8);
    *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(v8);
  }
}

template <typename K>
int configure(K kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

}  // namespace

extern "C" int gritlm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* mask, const void* dout, const void* lse,
                                   const void* delta, void* dq, int B, int Sq, int Sk, int H,
                                   int Hkv, long long q_sb, long long q_ss, long long k_sb,
                                   long long k_ss, long long v_sb, long long v_ss,
                                   long long m_sb, long long do_sb, long long do_ss,
                                   int causal, int window, int offset, float scale,
                                   void* stream) {
  static bool configured = false;
  int rc = configure(flash_bwd_dq_kernel, DQ_SMEM, &configured);
  if (rc) return rc;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)mask, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, Sq, Sk, H, H / Hkv, q_sb, q_ss, k_sb,
      k_ss, v_sb, v_ss, m_sb, do_sb, do_ss, causal, window, offset, scale);
  return (int)cudaGetLastError();
}

extern "C" int gritlm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* mask, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int B, int Sq,
                                    int Sk, int H, int Hkv, long long q_sb, long long q_ss,
                                    long long k_sb, long long k_ss, long long v_sb,
                                    long long v_ss, long long m_sb, long long do_sb,
                                    long long do_ss, int causal, int window, int offset,
                                    float scale, void* stream) {
  static bool configured = false;
  int rc = configure(flash_bwd_dkv_kernel, KV_SMEM, &configured);
  if (rc) return rc;
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, KV_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)mask, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H, Hkv, H / Hkv,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, m_sb, do_sb, do_ss, causal, window, offset, scale);
  return (int)cudaGetLastError();
}
