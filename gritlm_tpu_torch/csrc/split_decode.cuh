// Split-KV decode attention pieces of K8 (paged_attention.cu: a page pool
// [L, P, page, Kv*Dh] read through a page table), K3's design before it
// moved to tensor cores (decode_mma.cuh). The design note is in
// gritlm_tpu_torch/ops/paged_attention.py.
//
// The unit of work is one warp, owning RW query rows of one (batch row, kv
// head) over one split of the slots. A query row is (sq, g): position sq of
// the step, member g of the kv head's GQA group, so the group's shared K/V is
// read once per split. Per 32-slot tile the caller reads the slot mask and
// skips tiles with no valid key; attend_tile copies only the valid slots'
// K/V rows into shared memory (cp.async; masked slots are zero-filled, not
// read) and folds the tile into the warp's online softmax. Each split writes
// its partial (max, sum, unnormalised output); combine_kernel merges them.
#pragma once

#include "common.cuh"

namespace gritlm {
namespace split {

constexpr int DH = 128;
constexpr int TK = 32;  // slots per tile: one per lane
constexpr int RW = 4;   // query rows per warp
constexpr int WARPS = 4;
// Shared rows are padded by 16 bytes (272 bf16 / 144 int8 bytes a row) so
// that the per-slot 16-byte reads of 8 neighbouring lanes hit distinct banks.
template <typename T>
struct Tile {
  static constexpr int LD = DH + 16 / sizeof(T);
  static constexpr int CHUNKS = DH * sizeof(T) / 16;  // 16-byte copies per row
};

template <typename T>
struct WarpSmem {
  T k[TK * Tile<T>::LD];
  T v[TK * Tile<T>::LD];
  float q[RW * DH];
  float p[RW * TK];
};

// 8 consecutive cache values as floats
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
}
// 4 consecutive cache values as floats
__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(v2[0]), c = __bfloat1622float2(v2[1]);
  f[0] = a.x; f[1] = a.y; f[2] = c.x; f[3] = c.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}

// One warp's query rows and running softmax state (registers).
struct Rows {
  int qpos[RW];    // slot of each row's query (for the causal bound)
  bool valid[RW];  // the row exists (the last quad of a group may be short)
  float m[RW], l[RW], acc[RW][DH / 32];  // a lane owns 4 consecutive dims
};

// The warp's query rows -> shared memory (fp32, pre-scaled); positions and
// an empty softmax state -> registers. pos0: the slot of query position 0.
template <typename T>
__device__ __forceinline__ void load_queries(WarpSmem<T>& sh, Rows& r, const bf16* q, int b,
                                             int Sq, int H, int Kv, int kvh, int quad,
                                             int lane, int pos0, float scale) {
  const int group = H / Kv;
  const int R = Sq * group;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = quad * RW + i;
    r.valid[i] = row < R;
    const int sq = r.valid[i] ? row / group : 0;
    const int h = kvh * group + (r.valid[i] ? row % group : 0);
    r.qpos[i] = pos0 + sq;
    const bf16* qr = q + (((long long)b * Sq + sq) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < DH / 32; ++e) {
      const int d = lane * (DH / 32) + e;
      sh.q[i * DH + d] = r.valid[i] ? __bfloat162float(qr[d]) * scale : 0.f;
    }
    r.m[i] = NEG_INF;
    r.l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DH / 32; ++e) r.acc[i][e] = 0.f;
  }
  __syncwarp();
}

// Fold one 32-slot tile into the warp's rows. kt/vt: the tile's first K/V
// row for this kv head (rows are KD elements apart); live: the ballot of
// valid slots; key/mv: this lane's slot and its mask value; ks/vs: this
// lane's int8 scales (1 for bf16); window 0 = none.
template <typename T>
__device__ __forceinline__ void attend_tile(WarpSmem<T>& sh, Rows& r, const T* kt, const T* vt,
                                            int KD, unsigned live, int lane, int key, int mv,
                                            float ks, float vs, int causal, int window) {
  constexpr int LDK = Tile<T>::LD;
  constexpr int CH = Tile<T>::CHUNKS, EPC = 16 / sizeof(T);
  // copy the valid slots' rows, 16 bytes at a time
#pragma unroll
  for (int it = 0; it < TK * CH / 32; ++it) {
    const int idx = lane + 32 * it;
    const int row = idx / CH, c = (idx % CH) * EPC;
    const bool in = (live >> row) & 1u;
    const long long off = (long long)row * KD + c;
    cp_async16(sh.k + row * LDK + c, in ? kt + off : kt, in ? 16 : 0);
    cp_async16(sh.v + row * LDK + c, in ? vt + off : vt, in ? 16 : 0);
  }
  cp_async_wait_all();
  __syncwarp();

  // scores: lane = slot, RW rows
  float s[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) s[i] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DH; c += 8) {
    float kf[8];
    load8(sh.k + lane * LDK + c, kf);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(sh.q + i * DH + c);
      const float4 qb = *reinterpret_cast<const float4*>(sh.q + i * DH + c + 4);
      s[i] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
              qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    bool keep = mv != 0 && r.valid[i];
    if (causal) keep = keep && key <= r.qpos[i];
    if (window > 0) keep = keep && key > r.qpos[i] - window;
    const float x = keep ? s[i] * ks : NEG_INF;
    const float m_new = fmaxf(r.m[i], warp_max(x));
    const float p = keep ? expf(x - m_new) : 0.f;
    const float alpha = expf(r.m[i] - m_new);
    r.l[i] = r.l[i] * alpha + warp_sum(p);
    r.m[i] = m_new;
    sh.p[i * TK + lane] = p * vs;  // int8: vs dequantizes V through P
#pragma unroll
    for (int e = 0; e < DH / 32; ++e) r.acc[i][e] *= alpha;
  }
  __syncwarp();

  // acc += P V: lane owns DH/32 = 4 consecutive dims
#pragma unroll 4
  for (int j = 0; j < TK; ++j) {
    float vf[4];
    load4(sh.v + j * LDK + lane * 4, vf);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float p = sh.p[i * TK + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) r.acc[i][e] += p * vf[e];
    }
  }
  __syncwarp();  // the next tile overwrites K/V/P
}

// The split's partial (max, sum) and unnormalised output rows.
__device__ __forceinline__ void store_partial(const Rows& r, float2* part_ml, float* part_acc,
                                              int split, int b, int kvh, int quad, int B,
                                              int Kv, int n_quad, int lane) {
  const long long base = (((long long)split * B + b) * Kv + kvh) * (n_quad * RW) + quad * RW;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (lane == 0) part_ml[base + i] = make_float2(r.m[i], r.l[i]);
    float4 o = make_float4(r.acc[i][0], r.acc[i][1], r.acc[i][2], r.acc[i][3]);
    *reinterpret_cast<float4*>(part_acc + (base + i) * DH + lane * 4) = o;
  }
}

// One block per output row (b, sq, h); thread = head dim.
__global__ void __launch_bounds__(DH)
combine_kernel(const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
               bf16* __restrict__ out, int B, int Sq, int H, int Kv, int n_split, int n_quad) {
  const int o = blockIdx.x;  // (b * Sq + sq) * H + h
  const int h = o % H;
  const int sq = (o / H) % Sq;
  const int b = o / (H * Sq);
  const int group = H / Kv;
  const int kvh = h / group;
  const int r = sq * group + h % group;
  const long long stride = (long long)B * Kv * n_quad * RW;
  const long long row = ((long long)b * Kv + kvh) * (n_quad * RW) + r;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[s * stride + row].x);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 ml = part_ml[s * stride + row];
    const float w = expf(ml.x - M);
    L += ml.y * w;
    acc += part_acc[(s * stride + row) * DH + threadIdx.x] * w;
  }
  out[(long long)o * DH + threadIdx.x] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
}

// Dynamic shared memory of a split kernel above 48 KB: set once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  configured = e == cudaSuccess;
  return e;
}

}  // namespace split
}  // namespace gritlm
