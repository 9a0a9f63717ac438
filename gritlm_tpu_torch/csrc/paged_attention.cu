// K8: paged decode attention for Hopper (sm_90a): few-query attention against
// one layer of a shared page pool [L, P, page, Kv*Dh], read in place through a
// page table [B, maxp]: bf16 pages, or int8 pages with bf16 scales
// [L, P, Kv, page] (template type), at head dim 64, 96 or 128 (template
// constant). The design note and the plain version are
// in gritlm_tpu_torch/ops/paged_attention.py.
//
// One launch a call: K3's kernel body (decode_mma.cuh) with paged
// addressing. Tile tt of row b (logical slots 16 tt .. 16 tt + 15) lies in
// page page_table[b, 16 tt / page] at slot 16 tt % page, since page % 16 ==
// 0; one page-table read gives the tile's K/V rows and its int8 scales. The
// block scans the row's logical mask itself, so a row's own valid slots, not
// the pool's width, set the tiles read and the splits used; with `causal`,
// query j of row b sees slots <= offsets[b] + j.
#include "decode_mma.cuh"

using namespace gritlm::mma_decode;

// k_scale/v_scale null: bf16 pages; else int8 pages with bf16 scales.
// offsets null: `offset` for every row. Dh: 64, 96 or 128 (another returns
// cudaErrorInvalidValue). B * Kv * n_rg units of n_split blocks each; maxp
// pages a row, so the logical width is maxp * page.
extern "C" int gritlm_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* mask,
                                   const void* offsets, void* part_ml, void* part_o,
                                   void* counters, void* out, int B, int Sq, int H, int Kv,
                                   int Dh, int P, int page, int maxp, int layer, int n_split,
                                   int n_rg, int causal, int offset, float scale,
                                   void* stream) {
  Args a{(const gritlm::bf16*)q, k_pages, v_pages, (const gritlm::bf16*)k_scale,
         (const gritlm::bf16*)v_scale, (const int*)mask, (const int*)page_table,
         (const int*)offsets, (float2*)part_ml, (float*)part_o, (int*)counters,
         (gritlm::bf16*)out, B, Sq, H, Kv, maxp * page, layer, n_split, n_rg, causal, 0,
         offset, P, page, scale};
  return launch_dh<true>(a, Dh, k_scale != nullptr, (cudaStream_t)stream);
}
