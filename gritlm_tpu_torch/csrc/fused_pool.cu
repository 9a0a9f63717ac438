// K2: fused final RMSNorm + masked (weighted) mean pool + L2 normalize for
// Hopper (sm_90a). The design note and the plain version are in
// gritlm_tpu_torch/ops/fused_pool.py.
//
// Pass 1: one block per (chunk of sequence rows, batch row). For each row
// whose pooling mask is set, the block reads the bf16 hidden row once,
// reduces its sum of squares, and adds weight * rsqrt(mean(x^2) + eps) * x to
// fp32 partial sums held in registers; masked rows are never read. The
// weightedmean weight is the running count of mask tokens, so each block
// first counts the mask tokens before its chunk. Pass 2: one block per batch
// row sums the chunk partials, applies gamma and the denominator, and
// L2-normalizes.
#include "common.cuh"

using gritlm::bf16;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                 // bf16 per 16-byte load
constexpr int MAX_SLOTS = 4;           // D <= THREADS * VEC * MAX_SLOTS = 8192
constexpr int NW = THREADS / 32;

__device__ float block_sum(float x, float* red) {
  x = gritlm::warp_sum(x);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[w] = x;
  __syncthreads();
  float t = lane < NW ? red[lane] : 0.f;
  return gritlm::warp_sum(t);
}

__global__ void __launch_bounds__(THREADS)
pool_partial_kernel(const bf16* __restrict__ hidden, const int* __restrict__ mask,
                    float* __restrict__ part, float* __restrict__ part_w, int B, int S,
                    int D, int chunk, long long h_sb, long long h_ss, long long m_sb,
                    int weighted, float eps) {
  __shared__ float red[NW];
  const int c = blockIdx.x, b = blockIdx.y;
  const int s0 = c * chunk, s1 = min(S, s0 + chunk);
  const int* mb = mask + b * m_sb;

  float cnt = 0.f;  // mask tokens before this chunk (weightedmean weights)
  if (weighted) {
    float local = 0.f;
    for (int s = threadIdx.x; s < s0; s += THREADS) local += mb[s] != 0 ? 1.f : 0.f;
    cnt = block_sum(local, red);
  }

  float acc[MAX_SLOTS][VEC];
#pragma unroll
  for (int j = 0; j < MAX_SLOTS; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  float wsum = 0.f;

  for (int s = s0; s < s1; ++s) {
    if (mb[s] == 0) continue;  // uniform across the block
    cnt += 1.f;
    const float w = weighted ? cnt : 1.f;
    const bf16* row = hidden + b * h_sb + s * h_ss;
    float x[MAX_SLOTS][VEC];
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SLOTS; ++j) {
      const int d = (j * THREADS + threadIdx.x) * VEC;
      if (d < D) {
        gritlm::bf16x8_to_float(*reinterpret_cast<const uint4*>(row + d), x[j]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) sq += x[j][e] * x[j][e];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[j][e] = 0.f;
      }
    }
    const float rstd = rsqrtf(block_sum(sq, red) / D + eps);
    const float f = w * rstd;
#pragma unroll
    for (int j = 0; j < MAX_SLOTS; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] += f * x[j][e];
    wsum += w;
  }

  float* dst = part + ((long long)c * B + b) * D;
#pragma unroll
  for (int j = 0; j < MAX_SLOTS; ++j) {
    const int d = (j * THREADS + threadIdx.x) * VEC;
    if (d < D) {
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      *reinterpret_cast<float4*>(dst + d + 4) =
          make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    }
  }
  if (threadIdx.x == 0) part_w[(long long)c * B + b] = wsum;
}

__global__ void __launch_bounds__(THREADS)
pool_finish_kernel(const float* __restrict__ part, const float* __restrict__ part_w,
                   const bf16* __restrict__ gamma, float* __restrict__ out, int B, int D,
                   int n_chunks, int normalized) {
  __shared__ float red[NW];
  const int b = blockIdx.x;
  float denom = 0.f;
  for (int c = 0; c < n_chunks; ++c) denom += part_w[(long long)c * B + b];
  denom = denom > 0.f ? denom : 1.f;  // an empty mask row stays finite
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += part[((long long)c * B + b) * D + d];
    const float p = s * __bfloat162float(gamma[d]) / denom;
    out[(long long)b * D + d] = p;
    ss += p * p;
  }
  if (!normalized) return;
  const float inv = 1.f / fmaxf(sqrtf(block_sum(ss, red)), 1e-12f);
  for (int d = threadIdx.x; d < D; d += THREADS) out[(long long)b * D + d] *= inv;
}

}  // namespace

extern "C" int gritlm_fused_pool(const void* hidden, const void* gamma, const void* mask,
                                 void* part, void* part_w, void* out, int B, int S, int D,
                                 int chunk, long long h_sb, long long h_ss, long long m_sb,
                                 int weighted, int normalized, float eps, void* stream) {
  const int n_chunks = (S + chunk - 1) / chunk;
  cudaStream_t st = (cudaStream_t)stream;
  pool_partial_kernel<<<dim3(n_chunks, B), THREADS, 0, st>>>(
      (const bf16*)hidden, (const int*)mask, (float*)part, (float*)part_w, B, S, D, chunk,
      h_sb, h_ss, m_sb, weighted, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pool_finish_kernel<<<B, THREADS, 0, st>>>((const float*)part, (const float*)part_w,
                                            (const bf16*)gamma, (float*)out, B, D, n_chunks,
                                            normalized);
  return (int)cudaGetLastError();
}
