// K3: flash decode for Hopper (sm_90a): few-query attention against one layer
// of the full KV cache [L, B, Smax, Kv*Dh], read in place: bf16, or int8 with
// bf16 scales [L, B, Kv, Smax] dequantized in the kernel (template flag). The design
// note and the plain version are in gritlm_tpu_torch/ops/decode_attention.py;
// the split-KV pieces it shares with K8 are in split_decode.cuh.
//
// Split-KV (flash-decoding): one warp owns 4 query rows of one (batch row,
// kv head) over one contiguous split of the slots; a second kernel combines
// the splits.
#include "split_decode.cuh"

using gritlm::bf16;
using namespace gritlm::split;

namespace {

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

  Rows r;
  load_queries(sh, r, q, b, Sq, H, Kv, kvh, quad, lane, offset, scale);

  int s_lo = split * split_len;
  int s_hi = min(Smax, s_lo + split_len);
  const int first = quad * RW;
  const int last = min(R - 1, quad * RW + RW - 1);
  if (causal) s_hi = min(s_hi, offset + last / group + 1);
  if (window > 0) s_lo = max(s_lo, offset + first / group - window + 1);

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
    attend_tile(sh, r, kb + (long long)k0 * KD, vb + (long long)k0 * KD, KD, live, lane, key,
                mv, ks, vs, causal, window);
  }
  store_partial(r, part_ml, part_acc, split, b, kvh, quad, B, Kv, n_quad, lane);
}

template <typename T>
int launch(const void* q, const void* k_all, const void* v_all, const void* k_scale,
           const void* v_scale, const void* mask, void* part_ml, void* part_acc, void* out,
           int B, int Sq, int H, int Kv, int Smax, int layer, int n_split, int split_len,
           int causal, int window, int offset, float scale, cudaStream_t st) {
  static bool configured = false;
  constexpr size_t smem = sizeof(WarpSmem<T>) * WARPS;
  cudaError_t e = allow_smem(decode_split_kernel<T>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  const int n_quad = (Sq * (H / Kv) + RW - 1) / RW;
  const long long warps = (long long)n_split * n_quad * Kv * B;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  decode_split_kernel<T><<<blocks, WARPS * 32, smem, st>>>(
      (const bf16*)q, (const T*)k_all, (const T*)v_all, (const bf16*)k_scale,
      (const bf16*)v_scale, (const int*)mask, (float2*)part_ml, (float*)part_acc, B, Sq, H,
      Kv, Smax, layer, n_split, split_len, n_quad, causal, window, offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<B * Sq * H, DH, 0, st>>>((const float2*)part_ml, (const float*)part_acc,
                                            (bf16*)out, B, Sq, H, Kv, n_split, n_quad);
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
