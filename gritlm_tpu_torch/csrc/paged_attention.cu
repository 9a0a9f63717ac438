// K8: paged decode attention for Hopper (sm_90a): few-query attention against
// one layer of a shared page pool [L, P, page, Kv*Dh], read in place through a
// page table [B, maxp]: bf16 pages, or int8 pages with bf16 scales
// [L, P, Kv, page] (template flag). The design note and the plain version are
// in gritlm_tpu_torch/ops/paged_attention.py; its split-KV pieces are in
// split_decode.cuh.
//
// Three kernels on the caller's stream: row_bound_kernel reduces each row's
// logical mask to its page count (capped by the causal bound), on the device;
// paged_split_kernel runs the split-KV design with each 32-slot tile read
// from page page_table[b, slot / page], and a split past its row's page count
// exits at once; combine_kernel merges the splits.
#include "split_decode.cuh"

using gritlm::bf16;
using namespace gritlm::split;

namespace {

constexpr int BOUND_THREADS = 256;

// n_valid[b]: pages up to and including row b's last valid slot (0 for an
// empty row); with `causal`, at most (offset[b] + Sq - 1) / page + 1.
__global__ void __launch_bounds__(BOUND_THREADS)
row_bound_kernel(const int* __restrict__ mask, const int* __restrict__ offsets,
                 int* __restrict__ n_valid, int Smax, int page, int Sq, int causal) {
  __shared__ int warp_last[BOUND_THREADS / 32];
  const int b = blockIdx.x;
  const int* mb = mask + (long long)b * Smax;
  int last = -1;
  for (int s = threadIdx.x; s < Smax; s += BOUND_THREADS)
    if (mb[s] != 0) last = s;  // s grows: the thread's last valid slot
  last = __reduce_max_sync(gritlm::FULL, last);
  if (threadIdx.x % 32 == 0) warp_last[threadIdx.x / 32] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < BOUND_THREADS / 32; ++w) last = max(last, warp_last[w]);
    int n = last < 0 ? 0 : last / page + 1;
    if (causal) n = min(n, (offsets[b] + Sq - 1) / page + 1);
    n_valid[b] = n;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
paged_split_kernel(const bf16* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const bf16* __restrict__ k_scale,
                   const bf16* __restrict__ v_scale, const int* __restrict__ page_table,
                   const int* __restrict__ mask, const int* __restrict__ offsets,
                   const int* __restrict__ n_valid, float2* __restrict__ part_ml,
                   float* __restrict__ part_acc, int B, int Sq, int H, int Kv, int P, int page,
                   int maxp, int layer, int n_split, int split_len, int n_quad, int causal,
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
  const int Smax = maxp * page;
  const int offset = causal ? offsets[b] : 0;

  Rows r;
  load_queries(sh, r, q, b, Sq, H, Kv, kvh, quad, lane, offset, scale);

  const int s_lo = split * split_len;
  int s_hi = min(min(Smax, s_lo + split_len), n_valid[b] * page);
  if (causal) s_hi = min(s_hi, offset + min(R - 1, quad * RW + RW - 1) / group + 1);

  const int* pt = page_table + (long long)b * maxp;
  const int* mb = mask + (long long)b * Smax;
  for (int k0 = s_lo; k0 < s_hi; k0 += TK) {
    const int key = k0 + lane;
    const int mv = key < s_hi ? mb[key] : 0;
    const unsigned live = __ballot_sync(gritlm::FULL, mv != 0);
    if (!live) continue;
    // a tile never straddles a page (page % TK == 0, k0 % TK == 0)
    const int pid = min(max(pt[k0 / page], 0), P - 1);
    const int in_page = k0 % page;
    const long long row0 = ((long long)layer * P + pid) * page + in_page;
    float ks = 1.f, vs = 1.f;
    if (QUANT && mv != 0) {  // scales are slot-minor: [L, P, Kv, page]
      const long long sc = (((long long)layer * P + pid) * Kv + kvh) * page + in_page + lane;
      ks = __bfloat162float(k_scale[sc]);
      vs = __bfloat162float(v_scale[sc]);
    }
    attend_tile(sh, r, k_pages + row0 * KD + (long long)kvh * DH,
                v_pages + row0 * KD + (long long)kvh * DH, KD, live, lane, key, mv, ks, vs,
                causal, 0);
  }
  store_partial(r, part_ml, part_acc, split, b, kvh, quad, B, Kv, n_quad, lane);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
           const void* v_scale, const void* page_table, const void* mask, const void* offsets,
           void* n_valid, void* part_ml, void* part_acc, void* out, int B, int Sq, int H,
           int Kv, int P, int page, int maxp, int layer, int n_split, int split_len,
           int causal, float scale, cudaStream_t st) {
  static bool configured = false;
  constexpr size_t smem = sizeof(WarpSmem<T>) * WARPS;
  cudaError_t e = allow_smem(paged_split_kernel<T>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  row_bound_kernel<<<B, BOUND_THREADS, 0, st>>>((const int*)mask, (const int*)offsets,
                                                (int*)n_valid, maxp * page, page, Sq, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_quad = (Sq * (H / Kv) + RW - 1) / RW;
  const long long warps = (long long)n_split * n_quad * Kv * B;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  paged_split_kernel<T><<<blocks, WARPS * 32, smem, st>>>(
      (const bf16*)q, (const T*)k_pages, (const T*)v_pages, (const bf16*)k_scale,
      (const bf16*)v_scale, (const int*)page_table, (const int*)mask, (const int*)offsets,
      (const int*)n_valid, (float2*)part_ml, (float*)part_acc, B, Sq, H, Kv, P, page, maxp,
      layer, n_split, split_len, n_quad, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<B * Sq * H, DH, 0, st>>>((const float2*)part_ml, (const float*)part_acc,
                                            (bf16*)out, B, Sq, H, Kv, n_split, n_quad);
  return (int)cudaGetLastError();
}

}  // namespace

// k_scale/v_scale null: bf16 pages; else int8 pages with bf16 scales.
extern "C" int gritlm_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* mask,
                                   const void* offsets, void* n_valid, void* part_ml,
                                   void* part_acc, void* out, int B, int Sq, int H, int Kv,
                                   int P, int page, int maxp, int layer, int n_split,
                                   int split_len, int causal, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k_scale != nullptr)
    return launch<int8_t>(q, k_pages, v_pages, k_scale, v_scale, page_table, mask, offsets,
                          n_valid, part_ml, part_acc, out, B, Sq, H, Kv, P, page, maxp,
                          layer, n_split, split_len, causal, scale, st);
  return launch<bf16>(q, k_pages, v_pages, k_scale, v_scale, page_table, mask, offsets,
                      n_valid, part_ml, part_acc, out, B, Sq, H, Kv, P, page, maxp, layer,
                      n_split, split_len, causal, scale, st);
}
