// K1: flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax and
// accumulation. The design note and the plain version are in
// gritlm_tpu_torch/ops/flash_attention.py.
//
// One block of 4 warps per (q-tile of 64 rows, query head, batch row). Each
// warp owns 16 query rows. Per 64-key tile: the block stages K/V (and the key
// mask) in shared memory; each warp forms its 16x64 score tile with bf16
// tensor-core MMAs (wmma), runs the online softmax on it in shared memory,
// and adds P.V into its fp32 output rows, also kept in shared memory. With
// an `lse` pointer it also writes each row's log-sum-exp of the scaled
// scores (fp32 [B, H, Sq]; NEG_INF for a row with no valid key), which the
// backward kernels (flash_attention_bwd.cu) rebuild P from.
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
constexpr int LDQK = DH + 8;  // bf16 row stride of the Q/K/V tiles
constexpr int LDS = BK + 4;   // fp32 row stride of the score tile
constexpr int LDP = BK + 8;   // bf16 row stride of the probability tile
constexpr int LDO = DH + 4;   // fp32 row stride of the output rows

constexpr size_t OFF_K = size_t(BQ) * LDQK * 2;
constexpr size_t OFF_V = OFF_K + size_t(BK) * LDQK * 2;
constexpr size_t OFF_S = OFF_V + size_t(BK) * LDQK * 2;
constexpr size_t OFF_P = OFF_S + size_t(BQ) * LDS * 4;
constexpr size_t OFF_O = OFF_P + size_t(BQ) * LDP * 2;
constexpr size_t OFF_M = OFF_O + size_t(BQ) * LDO * 4;
constexpr size_t OFF_L = OFF_M + size_t(BQ) * 4;
constexpr size_t OFF_MASK = OFF_L + size_t(BQ) * 4;
constexpr size_t SMEM_BYTES = OFF_MASK + size_t(BK) * 4;

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk,
                 int H, int group,
                 long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, long long m_sb, int causal,
                 int window, int offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* sv = reinterpret_cast<bf16*>(smem + OFF_V);
  float* ss = reinterpret_cast<float*>(smem + OFF_S);
  bf16* sp = reinterpret_cast<bf16*>(smem + OFF_P);
  float* so = reinterpret_cast<float*>(smem + OFF_O);
  float* sm = reinterpret_cast<float*>(smem + OFF_M);
  float* sl = reinterpret_cast<float*>(smem + OFF_L);
  int* smask = reinterpret_cast<int*>(smem + OFF_MASK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bf16* qb = q + b * q_sb + (long long)h * DH;
  const bf16* kb = k + b * k_sb + (long long)hk * DH;
  const bf16* vb = v + b * v_sb + (long long)hk * DH;
  const int* mb = mask + b * m_sb;

  for (int i = tid; i < BQ * DH / 8; i += NTHREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_ss + c);
    *reinterpret_cast<uint4*>(sq + r * LDQK + c) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NTHREADS) so[i] = 0.f;
  if (tid < BQ) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }

  // keys this q-tile can see: causal tiles above the diagonal and tiles
  // below the sliding window are never visited
  const int q_last = offset + min(q0 + BQ, Sq) - 1;
  int kend = Sk, kbeg = 0;
  if (causal) kend = min(Sk, q_last + 1);
  if (window > 0) kbeg = max(0, offset + q0 - window + 1) / BK * BK;
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    int any = 0;
    if (tid < BK) {
      const int kp = k0 + tid;
      smask[tid] = kp < Sk ? mb[kp] : 0;
      any = smask[tid] != 0;
    }
    if (!__syncthreads_or(any)) continue;  // tile holds no valid key
    for (int i = tid; i < BK * DH / 8; i += NTHREADS) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      const int kp = k0 + r;
      const bool in = kp < Sk;
      gritlm::cp_async16(sk + r * LDQK + c, in ? kb + kp * k_ss + c : kb, in ? 16 : 0);
      gritlm::cp_async16(sv + r * LDQK + c, in ? vb + kp * v_ss + c : vb, in ? 16 : 0);
    }
    gritlm::cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int d = 0; d < DH; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sq + warp * 16 * LDQK + d, LDQK);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, sk + j * 16 * LDQK + d, LDQK);
          wmma::mma_sync(sacc[j], a, bt, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(ss + warp * 16 * LDS + j * 16, sacc[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, two keys per lane, one row at a time
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qpos = offset + q0 + r;
      float x[2];
      bool keep[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int kp = k0 + c;
        bool kk = smask[c] != 0;
        if (causal) kk = kk && kp <= qpos;
        if (window > 0) kk = kk && kp > qpos - window;
        keep[t] = kk;
        x[t] = kk ? ss[r * LDS + c] * scale : NEG_INF;
      }
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, gritlm::warp_max(fmaxf(x[0], x[1])));
      const float p0 = keep[0] ? expf(x[0] - m_new) : 0.f;
      const float p1 = keep[1] ? expf(x[1] - m_new) : 0.f;
      const float psum = gritlm::warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      sp[r * LDP + lane] = __float2bfloat16(p0);
      sp[r * LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < DH; c += 32) so[r * LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sm[r] = m_new;
        sl[r] = sl[r] * alpha + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DH / 16];
#pragma unroll
      for (int n = 0; n < DH / 16; ++n)
        wmma::load_matrix_sync(oacc[n], so + warp * 16 * LDO + n * 16, LDO,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::load_matrix_sync(pa, sp + warp * 16 * LDP + kk, LDP);
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, sv + kk * LDQK + n * 16, LDQK);
          wmma::mma_sync(oacc[n], pa, vf, oacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < DH / 16; ++n)
        wmma::store_matrix_sync(so + warp * 16 * LDO + n * 16, oacc[n], LDO,
                                wmma::mem_row_major);
    }
    __syncthreads();  // K/V/mask tiles are overwritten next
  }
  __syncthreads();

  // out = O / l; rows whose every key was masked have l == 0 and output 0
  for (int i = tid; i < BQ * DH / 8; i += NTHREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    if (q0 + r >= Sq) continue;
    const float l = sl[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __align__(16) bf16 o8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(so[r * LDO + c + e] * inv);
    bf16* dst = out + (((long long)b * Sq + q0 + r) * H + h) * DH + c;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o8);
  }
  if (lse != nullptr && tid < BQ && q0 + tid < Sq) {
    const float l = sl[tid];
    lse[((long long)b * H + h) * Sq + q0 + tid] = l > 0.f ? sm[tid] + logf(l) : NEG_INF;
  }
}

}  // namespace

extern "C" int gritlm_flash_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int B, int Sq,
                                int Sk, int H, int Hkv, long long q_sb, long long q_ss,
                                long long k_sb, long long k_ss, long long v_sb,
                                long long v_ss, long long m_sb, int causal, int window,
                                int offset, float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)mask, (bf16*)out,
      (float*)lse, Sq, Sk, H, H / Hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, m_sb, causal,
      window, offset, scale);
  return (int)cudaGetLastError();
}
