// K3: flash decode for Hopper (sm_90a): few-query attention against one layer
// of the full KV cache [L, B, Smax, Kv*Dh], read in place: bf16, or int8 with
// bf16 scales [L, B, Kv, Smax] (template type), at head dim 64, 96 or 128
// (template constant). The design note and the plain
// version are in gritlm_tpu_torch/ops/decode_attention.py; the kernel body
// (one launch a call: mask scan, tensor-core fold, block and split merges),
// shared with K8, is in decode_mma.cuh, here with dense addressing: tile tt
// of row b is slots 16 tt .. 16 tt + 15 of that row's cache.
#include "decode_mma.cuh"

using namespace gritlm::mma_decode;

// k_scale/v_scale null: bf16 cache; else int8 cache with bf16 scales. mask
// null: every slot valid. offsets null: `offset` for every row, else row b's
// query row 0 sits at slot offsets[b] (the causal bound and the window follow
// it). Dh: 64, 96 or 128 (another returns cudaErrorInvalidValue). B * Kv *
// n_rg units of n_split blocks each.
extern "C" int gritlm_flash_decode(const void* q, const void* k_all, const void* v_all,
                                   const void* k_scale, const void* v_scale, const void* mask,
                                   const void* offsets, void* part_ml, void* part_o,
                                   void* counters, void* out, int B, int Sq, int H, int Kv,
                                   int Dh, int Smax, int layer, int n_split, int n_rg,
                                   int causal, int window, int offset, float scale,
                                   void* stream) {
  Args a{(const gritlm::bf16*)q, k_all, v_all, (const gritlm::bf16*)k_scale,
         (const gritlm::bf16*)v_scale, (const int*)mask, nullptr, (const int*)offsets,
         (float2*)part_ml, (float*)part_o, (int*)counters, (gritlm::bf16*)out, B, Sq, H, Kv,
         Smax, layer, n_split, n_rg, causal, window, offset, 0, 0, scale};
  return launch_dh<false>(a, Dh, k_scale != nullptr, (cudaStream_t)stream);
}
