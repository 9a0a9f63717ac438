// K3: flash decode for Hopper (sm_90a): few-query attention against one layer
// of the full KV cache [L, B, Smax, Kv*Dh], read in place: bf16, or int8 with
// bf16 scales [L, B, Kv, Smax] (template type). The design note and the plain
// version are in gritlm_tpu_torch/ops/decode_attention.py; the tile pieces
// (tensor-core fold, block merge, mask scan) are in decode_mma.cuh.
//
// One launch a call. Block unit * n_split + split: a unit is (batch row, kv
// head, group of 8 query rows). The block first scans its row's mask over the slots any
// of its rows can see (the causal bound, the window) into tile bits in shared
// memory, and takes the first and last valid slot as the unit's range; the
// unit's tiles are cut into as many of its n_split parts as give each warp
// MIN_TILES or more (the blocks of parts not needed exit at once), and the
// block's part into 4 contiguous runs, one a warp. A warp streams the valid tiles of its run
// (tiles with no valid slot are never copied, masked rows are zero-filled)
// through a private cp.async ring of 3 stages and folds each into its state
// on tensor cores; the block merges its warps in shared memory. One split
// writes the output rows; otherwise each split writes its partial (max, sum,
// output) and the block that finishes the unit last merges them in split
// order (a counter per unit, reset by that block), so reruns are bit-equal.
#include "decode_mma.cuh"

using gritlm::bf16;
using namespace gritlm::mma_decode;

namespace {

struct Args {
  const bf16* q;          // [B, Sq, H, DH]
  const void* k;          // [L, B, Smax, Kv*DH] bf16 or int8
  const void* v;
  const bf16* k_scale;    // [L, B, Kv, Smax] (int8)
  const bf16* v_scale;
  const int* mask;        // [B, Smax], nullptr: every slot valid
  float2* part_ml;        // [n_split, units, ROWS] (n_split > 1)
  float* part_o;          // [n_split, units, ROWS, DH]
  int* counters;          // [units], 0 between launches (n_split > 1)
  bf16* out;              // [B, Sq, H, DH]
  int B, Sq, H, Kv, Smax, layer, n_split, n_rg, causal, window, offset;
  float scale;
};

// Tile tt's K and V rows into stage `st`: only the live slots' rows are read
// (16 bytes a copy); the others are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_tile(unsigned char* st, const T* kb, const T* vb, int KD,
                                          int tt, unsigned live, int lane) {
  using Tl = Tile<T>;
  constexpr int EPC = 16 / (int)sizeof(T);
#pragma unroll
  for (int j = 0; j < TK * Tl::CHUNKS / 32; ++j) {
    const int i = lane + 32 * j, r = i / Tl::CHUNKS, c = i % Tl::CHUNKS;
    const bool in = (live >> r) & 1u;
    const long long off = (long long)(tt * TK + r) * KD + c * EPC;
    gritlm::cp_async16(st + r * Tl::LD + 16 * c, in ? kb + off : kb, in ? 16 : 0);
    gritlm::cp_async16(st + Tl::KV + r * Tl::LD + 16 * c, in ? vb + off : vb, in ? 16 : 0);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) flash_decode_kernel(Args a) {
  using Tl = Tile<T>;
  constexpr bool QUANT = sizeof(T) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x % a.n_split, unit = blockIdx.x / a.n_split;
  const int rg = unit % a.n_rg, kvh = (unit / a.n_rg) % a.Kv, b = unit / (a.n_rg * a.Kv);
  const int group = a.H / a.Kv, R = a.Sq * group;
  const int row0 = rg * ROWS, row1 = min(R, row0 + ROWS) - 1;
  // the slots some row of the group can see
  const int hi = a.causal ? min(a.Smax, a.offset + row1 / group + 1) : a.Smax;
  const int lo = a.window > 0 ? max(0, a.offset + row0 / group - a.window + 1) : 0;
  uint16_t* bits = reinterpret_cast<uint16_t*>(smem + WARPS * Tl::RING);
  int first, last;
  scan_mask(a.mask == nullptr ? nullptr : a.mask + (long long)b * a.Smax, lo, hi, bits, first,
            last);
  const int tbase = lo / TK;
  const int T0 = last >= first ? first / TK : 0;
  const int nt = last >= first ? last / TK + 1 - T0 : 0;  // the unit's tiles
  const int n_used = used_splits(nt, a.n_split);
  if (split >= n_used) return;  // a split the unit's valid range does not need
  const int ta = T0 + part_begin(nt, split, n_used), tb = T0 + part_begin(nt, split + 1, n_used);
  const int wa = ta + part_begin(tb - ta, warp, WARPS), wb = ta + part_begin(tb - ta, warp + 1, WARPS);

  // the lane's query row g (Q^T fragment) and rows 2t, 2t+1 (softmax)
  Warp w;
  {
    const int row = row0 + g;
    const bf16* qrow = row <= row1 ? a.q + (((long long)b * a.Sq + row / group) * a.H +
                                            kvh * group + row % group) * DH
                                   : nullptr;
    int qpos[2];
    bool valid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 2 * t + i;
      valid[i] = r <= row1;
      qpos[i] = a.offset + r / group;
    }
    init_warp(w, qrow, t, qpos, valid);
  }

  const int KD = a.Kv * DH;
  const long long row_base = ((long long)a.layer * a.B + b) * a.Smax;
  const T* kb = reinterpret_cast<const T*>(a.k) + row_base * KD + (long long)kvh * DH;
  const T* vb = reinterpret_cast<const T*>(a.v) + row_base * KD + (long long)kvh * DH;
  const long long sc_base = (((long long)a.layer * a.B + b) * a.Kv + kvh) * a.Smax;
  unsigned char* ring = smem + warp * Tl::RING;
  const float sl2 = a.scale * LOG2E;
  auto next_live = [&](int tt) {
    while (tt < wb && bits[tt - tbase] == 0) ++tt;
    return tt;
  };
  // int8: the lane's scales of slots 16 tt + g, + 8 (K on the scores, V on P)
  auto scales_of = [&](int tt, float* ks, float* vs) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = tt * TK + g + 8 * j;
      const bool in = tt < wb && slot < a.Smax;
      ks[j] = in ? __bfloat162float(a.k_scale[sc_base + slot]) : 0.f;
      vs[j] = in ? __bfloat162float(a.v_scale[sc_base + slot]) : 0.f;
    }
  };

  int fetch = next_live(wa);
  int cur = fetch;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fetch < wb) {
      copy_tile<T>(ring + s * Tl::STAGE, kb, vb, KD, fetch, bits[fetch - tbase], lane);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }
  float ks[2] = {1.f, 1.f}, vs[2] = {1.f, 1.f}, ks_n[2], vs_n[2];
  if (QUANT) scales_of(cur, ks_n, vs_n);
  for (int i = 0; cur < wb; ++i) {
    if (fetch < wb) {  // into the slot tile i - 1 left
      copy_tile<T>(ring + ((i + STAGES - 1) % STAGES) * Tl::STAGE, kb, vb, KD, fetch,
                   bits[fetch - tbase], lane);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest STAGES-1" = tile i
    const int nxt = next_live(cur + 1);
    if (QUANT) {  // this tile's scales were loaded a tile ahead
      ks[0] = ks_n[0]; ks[1] = ks_n[1]; vs[0] = vs_n[0]; vs[1] = vs_n[1];
      scales_of(nxt, ks_n, vs_n);
    }
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the other lanes' copies are visible
    fold_tile<T>(w, ring + (i % STAGES) * Tl::STAGE, cur * TK, bits[cur - tbase], ks, vs,
                 a.causal, a.window, sl2, lane);
    __syncwarp();  // every lane has read the slot before it is refilled
    cur = nxt;
  }
  gritlm::cp_async_wait_all();
  __syncwarp();
  store_warp<T>(w, *reinterpret_cast<WarpOut*>(ring), lane);
  __syncthreads();

  float M, L, o[8];
  merge_warps(smem, Tl::RING, M, L, o);
  const int r = tid >> 4, d0 = (tid & 15) * 8, row = row0 + r;
  const int units = gridDim.x / a.n_split;
  bf16* dst = a.out + (((long long)b * a.Sq + row / group) * a.H + kvh * group + row % group) * DH + d0;
  auto write_out = [&]() {
    if (row > row1) return;
    __align__(16) bf16 y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __float2bfloat16(L > 0.f ? o[j] / L : 0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(y);
  };
  if (n_used == 1) {
    write_out();
    return;
  }
  {  // every used split has tiles: it leaves its partial
    const long long p = ((long long)split * units + unit) * ROWS + r;
    if ((tid & 15) == 0) a.part_ml[p] = make_float2(M, L);
    float4* po = reinterpret_cast<float4*>(a.part_o + p * DH + d0);
    po[0] = make_float4(o[0], o[1], o[2], o[3]);
    po[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
  __shared__ bool last_block;
  __threadfence();  // the partials, visible to the block that merges them
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(a.counters + unit, 1) == n_used - 1;
    if (last_block) a.counters[unit] = 0;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // the splits' partials merged in split order, 8 splits' loads in flight at once
  M = gritlm::NEG_INF;
  L = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = 0.f;
  for (int s0 = 0; s0 < n_used; s0 += 8) {
    float2 ml[8];
    float4 x[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + j;
      ml[j] = make_float2(gritlm::NEG_INF, 0.f);
      x[j][0] = x[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < n_used) {
        const long long p = ((long long)s * units + unit) * ROWS + r;
        const float4* po = reinterpret_cast<const float4*>(a.part_o + p * DH + d0);
        ml[j] = __ldcg(a.part_ml + p);
        x[j][0] = __ldcg(po);
        x[j][1] = __ldcg(po + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // an absent split: max NEG_INF, sum 0, output 0
      const float m_new = fmaxf(M, ml[j].x);
      const float alpha = ex2(M - m_new), e = ex2(ml[j].x - m_new);
      L = L * alpha + ml[j].y * e;
      o[0] = o[0] * alpha + x[j][0].x * e; o[1] = o[1] * alpha + x[j][0].y * e;
      o[2] = o[2] * alpha + x[j][0].z * e; o[3] = o[3] * alpha + x[j][0].w * e;
      o[4] = o[4] * alpha + x[j][1].x * e; o[5] = o[5] * alpha + x[j][1].y * e;
      o[6] = o[6] * alpha + x[j][1].z * e; o[7] = o[7] * alpha + x[j][1].w * e;
      M = m_new;
    }
  }
  write_out();
}

template <typename T>
int launch(const Args& a, int units, cudaStream_t st) {
  static int configured = 0;  // dynamic shared memory allowed so far
  const int smem = smem_bytes<T>(a.Smax);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  flash_decode_kernel<T><<<units * a.n_split, WARPS * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// k_scale/v_scale null: bf16 cache; else int8 cache with bf16 scales. mask
// null: every slot valid. B * Kv * n_rg units of n_split blocks each.
extern "C" int gritlm_flash_decode(const void* q, const void* k_all, const void* v_all,
                                   const void* k_scale, const void* v_scale, const void* mask,
                                   void* part_ml, void* part_o, void* counters, void* out, int B,
                                   int Sq, int H, int Kv, int Smax, int layer, int n_split,
                                   int n_rg, int causal, int window, int offset, float scale,
                                   void* stream) {
  Args a{(const bf16*)q, k_all, v_all, (const bf16*)k_scale, (const bf16*)v_scale,
         (const int*)mask, (float2*)part_ml, (float*)part_o, (int*)counters, (bf16*)out,
         B, Sq, H, Kv, Smax, layer, n_split, n_rg, causal, window, offset, scale};
  const int units = B * Kv * n_rg;
  cudaStream_t st = (cudaStream_t)stream;
  return k_scale != nullptr ? launch<int8_t>(a, units, st) : launch<bf16>(a, units, st);
}

