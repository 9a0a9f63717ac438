// K3: flash decode for Hopper (sm_90a): few-query attention against one layer
// of the full KV cache [L, B, Smax, Kv*Dh], read in place: bf16, or int8 with
// bf16 scales [L, B, Kv, Smax] dequantized in the kernel (template flag). The design
// note and the plain version are in gritlm_tpu_torch/ops/decode_attention.py.
//
// Split-KV (flash-decoding): the unit of work is one warp, owning 4 query
// rows of one (batch row, kv head) over one contiguous split of the slots.
// A query row is (sq, g): position sq of the step, member g of the kv head's
// GQA group, so the group's shared K/V is read once per split. Per 32-slot
// tile the warp reads the slot mask first and skips the tile when it holds no
// valid key; otherwise it copies only the valid slots' K/V rows into shared
// memory (cp.async; masked slots are zero-filled, not read). Each split
// writes its partial (max, sum, unnormalised output); a second kernel
// combines the splits.
#include "common.cuh"

using gritlm::bf16;
using gritlm::NEG_INF;

namespace {

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
  gritlm::bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
decode_split_kernel(const bf16* __restrict__ q, const T* __restrict__ k_all,
                    const T* __restrict__ v_all, const bf16* __restrict__ k_scale,
                    const bf16* __restrict__ v_scale, const int* __restrict__ mask,
                    float2* __restrict__ part_ml, float* __restrict__ part_acc, int B,
                    int Sq, int H, int Kv, int Smax, int layer, int n_split,
                    int split_len, int n_quad, int causal, int window, int offset,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * WARPS + warp;
  const long long total = (long long)n_split * n_quad * Kv * B;
  if (wid >= total) return;  // no block-wide barrier below
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int LDK = Tile<T>::LD;
  WarpSmem<T>& sh = reinterpret_cast<WarpSmem<T>*>(smem_raw)[warp];

  const int split = wid % n_split;
  long long t = wid / n_split;
  const int quad = t % n_quad;
  t /= n_quad;
  const int kvh = t % Kv;
  const int b = t / Kv;
  const int group = H / Kv;
  const int R = Sq * group;
  const int KD = Kv * DH;

  // this warp's query rows -> smem (fp32), absolute positions in registers
  int qpos[RW];
  bool rvalid[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = quad * RW + i;
    rvalid[i] = r < R;
    const int sq = rvalid[i] ? r / group : 0;
    const int h = kvh * group + (rvalid[i] ? r % group : 0);
    qpos[i] = offset + sq;
    const bf16* qr = q + (((long long)b * Sq + sq) * H + h) * DH;
#pragma unroll
    for (int e = 0; e < DH / 32; ++e) {
      const int d = lane * (DH / 32) + e;
      sh.q[i * DH + d] = rvalid[i] ? __bfloat162float(qr[d]) * scale : 0.f;
    }
  }

  int s_lo = split * split_len;
  int s_hi = min(Smax, s_lo + split_len);
  const int first = quad * RW;
  const int last = min(R - 1, quad * RW + RW - 1);
  if (causal) s_hi = min(s_hi, offset + last / group + 1);
  if (window > 0) s_lo = max(s_lo, offset + first / group - window + 1);

  float m[RW], l[RW], acc[RW][DH / 32];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DH / 32; ++e) acc[i][e] = 0.f;
  }
  __syncwarp();

  const long long row_base = ((long long)layer * B + b) * Smax;
  const T* kb = k_all + row_base * KD + (long long)kvh * DH;
  const T* vb = v_all + row_base * KD + (long long)kvh * DH;
  const int* mb = mask + (long long)b * Smax;
  // int8 scales are slot-minor: [L, B, Kv, Smax]
  const long long sc_base = (((long long)layer * B + b) * Kv + kvh) * Smax;

  for (int k0 = s_lo; k0 < s_hi; k0 += TK) {
    const int key = k0 + lane;
    const int mv = key < s_hi ? mb[key] : 0;
    const unsigned live = __ballot_sync(gritlm::FULL, mv != 0);
    if (!live) continue;
    float ks = 1.f, vs = 1.f;
    if (QUANT && mv != 0) {
      ks = __bfloat162float(k_scale[sc_base + key]);
      vs = __bfloat162float(v_scale[sc_base + key]);
    }
    // copy the valid slots' rows, 16 bytes at a time
    constexpr int CH = Tile<T>::CHUNKS, EPC = 16 / sizeof(T);
#pragma unroll
    for (int it = 0; it < TK * CH / 32; ++it) {
      const int idx = lane + 32 * it;
      const int row = idx / CH, c = (idx % CH) * EPC;
      const bool in = (live >> row) & 1u;
      const long long off = (long long)(k0 + row) * KD + c;
      gritlm::cp_async16(sh.k + row * LDK + c, in ? kb + off : kb, in ? 16 : 0);
      gritlm::cp_async16(sh.v + row * LDK + c, in ? vb + off : vb, in ? 16 : 0);
    }
    gritlm::cp_async_wait_all();
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
      bool keep = mv != 0 && rvalid[i];
      if (causal) keep = keep && key <= qpos[i];
      if (window > 0) keep = keep && key > qpos[i] - window;
      const float x = keep ? s[i] * ks : NEG_INF;
      const float m_new = fmaxf(m[i], gritlm::warp_max(x));
      const float p = keep ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + gritlm::warp_sum(p);
      m[i] = m_new;
      sh.p[i * TK + lane] = p * vs;  // int8: vs dequantizes V through P
#pragma unroll
      for (int e = 0; e < DH / 32; ++e) acc[i][e] *= alpha;
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
        for (int e = 0; e < 4; ++e) acc[i][e] += p * vf[e];
      }
    }
    __syncwarp();  // the next tile overwrites K/V/P
  }

  const long long base = (((long long)split * B + b) * Kv + kvh) * (n_quad * RW) + quad * RW;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (lane == 0) part_ml[base + i] = make_float2(m[i], l[i]);
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(part_acc + (base + i) * DH + lane * 4) = o;
  }
}

// One block per output row (b, sq, h); thread = head dim.
__global__ void __launch_bounds__(DH)
decode_combine_kernel(const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
                      bf16* __restrict__ out, int B, int Sq, int H, int Kv, int n_split,
                      int n_quad) {
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

template <typename T>
int launch(const void* q, const void* k_all, const void* v_all, const void* k_scale,
           const void* v_scale, const void* mask, void* part_ml, void* part_acc, void* out,
           int B, int Sq, int H, int Kv, int Smax, int layer, int n_split, int split_len,
           int causal, int window, int offset, float scale, cudaStream_t st) {
  static bool configured = false;
  constexpr size_t smem = sizeof(WarpSmem<T>) * WARPS;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_quad = (Sq * (H / Kv) + RW - 1) / RW;
  const long long warps = (long long)n_split * n_quad * Kv * B;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  decode_split_kernel<T><<<blocks, WARPS * 32, smem, st>>>(
      (const bf16*)q, (const T*)k_all, (const T*)v_all, (const bf16*)k_scale,
      (const bf16*)v_scale, (const int*)mask, (float2*)part_ml, (float*)part_acc, B, Sq, H,
      Kv, Smax, layer, n_split, split_len, n_quad, causal, window, offset, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<<<B * Sq * H, DH, 0, st>>>((const float2*)part_ml,
                                                   (const float*)part_acc, (bf16*)out, B,
                                                   Sq, H, Kv, n_split, n_quad);
  return (int)cudaGetLastError();
}

}  // namespace

// k_scale/v_scale null: bf16 cache; else int8 cache with bf16 scales.
extern "C" int gritlm_flash_decode(const void* q, const void* k_all, const void* v_all,
                                   const void* k_scale, const void* v_scale,
                                   const void* mask, void* part_ml, void* part_acc,
                                   void* out, int B, int Sq, int H, int Kv, int Smax,
                                   int layer, int n_split, int split_len, int causal,
                                   int window, int offset, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k_scale != nullptr)
    return launch<int8_t>(q, k_all, v_all, k_scale, v_scale, mask, part_ml, part_acc, out,
                          B, Sq, H, Kv, Smax, layer, n_split, split_len, causal, window,
                          offset, scale, st);
  return launch<bf16>(q, k_all, v_all, k_scale, v_scale, mask, part_ml, part_acc, out, B,
                      Sq, H, Kv, Smax, layer, n_split, split_len, causal, window, offset,
                      scale, st);
}
