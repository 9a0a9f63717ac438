// Flash-decode pieces on tensor cores (mma.sync) for Hopper, used by K3
// (decode_attention.cu: a dense cache [L, B, Smax, Kv*Dh]). They know
// nothing of where a tile's K/V rows live, so a paged cache can feed them
// the same way. The design note is in gritlm_tpu_torch/ops/decode_attention.py.
//
// A warp owns up to 8 query rows of one (batch row, kv head): the GQA group
// members of one or more query positions, so the group's K/V is read once.
// Per 16-slot tile, with the slots on the MMA's 16-row side and the query
// rows on its 8-wide side:
//   S^T [16 slots, 8 rows] = K [16, Dh] . Q^T      (8 mma.m16n8k16)
//   online softmax over the slots, in registers (base 2)
//   O^T [Dh, 8 rows] += V^T [Dh, 16] . P^T [16, 8]  (8 mma.m16n8k16)
// Q^T stays in registers as B fragments for the whole run. P^T's B
// fragment is S^T's C fragment transposed by movmatrix. The bf16 cache's
// V^T comes from ldmatrix.trans; the int8 cache's K and V become bf16 in
// registers, exactly (|q| <= 127), with K's per-slot scale on the scores
// and V's on P.
//
// Fragment maps (lane = 4 g + t):
//   Q^T / K, k-chunk c = 4 hh + cc of Dh: k slots 2t, 2t+1, 2t+8, 2t+9 hold
//   d = 64 hh + 16 t + 4 cc + {0, 1, 2, 3}, so a lane reads 16 contiguous
//   dims of a K row per hh;
//   O^T, M-tile mt: row g / g + 8 of the tile is d = 16 mt + g / + 8 (bf16,
//   as ldmatrix.trans gives it) or d = 16 g + 2 mt / + 1 (int8, so a lane
//   converts 16 contiguous bytes of a V row).
#pragma once

#include <climits>

#include "common.cuh"

namespace gritlm {
namespace mma_decode {

constexpr int DH = 128;
constexpr int TK = 16;     // slots a tile: the MMA's 16-row side
constexpr int ROWS = 8;    // query rows a warp: the MMA's 8-wide side
constexpr int WARPS = 4;   // a block walks its split's tiles in 4 contiguous runs
constexpr int STAGES = 3;  // ring depth of each warp
constexpr int SCAN = 32;   // mask loads a thread keeps in flight in the scan (one a lane's ballot)
constexpr int MIN_TILES = 4;  // a split's least tiles a warp: fewer splits than n_split below that
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Tile {
  static constexpr int LD = DH * (int)sizeof(T) + 16;  // bytes a slot row (padded: banks)
  static constexpr int KV = TK * LD;                   // K rows, then V rows
  static constexpr int STAGE = 2 * KV;
  static constexpr int RING = STAGES * STAGE;          // one warp's ring
  static constexpr int CHUNKS = DH * (int)sizeof(T) / 16;  // 16-byte copies a row
};

// A warp's final state, written over its ring for the block's merge.
constexpr int LDO = DH + 4;
struct WarpOut {
  float o[ROWS][LDO];  // unnormalised output rows
  float2 ml[ROWS];     // (max, sum) in base 2
};
static_assert(sizeof(WarpOut) <= Tile<int8_t>::RING, "WarpOut overlays a ring");

// Dynamic shared memory of a block: the rings, then the tile bits of the
// slot range (one 16-bit word a tile, two spare).
template <typename T>
inline int smem_bytes(int Smax) {
  return WARPS * Tile<T>::RING + ((2 * ((Smax + TK - 1) / TK + 2) + 15) / 16) * 16;
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// An 8x8 b16 matrix in fragment layout, transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for NEG_INF - finite
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Signed byte k of w (w ^ 0x80808080 given) as the bits of an exact float
// (2^23 + q + 128 by a byte permute, then one add); its upper half is the
// bf16 of q, exactly.
__device__ __forceinline__ uint32_t i8_bits(uint32_t wx, int k) {
  return __float_as_uint(__uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540u + k)) -
                         8388736.0f);  // 2^23 + 128
}

// bf16x2 of two exact floats' upper halves (a low, b high).
__device__ __forceinline__ uint32_t upper2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632u);
}

// The 8 bf16x2 words of dims 64 hh + 16 t .. + 15 of one K row.
template <typename T>
__device__ __forceinline__ void k_words(const unsigned char* row, int hh, int t, uint32_t* w);
template <>
__device__ __forceinline__ void k_words<bf16>(const unsigned char* row, int hh, int t,
                                              uint32_t* w) {
  const uint4 a = *reinterpret_cast<const uint4*>(row + (64 * hh + 16 * t) * 2);
  const uint4 b = *reinterpret_cast<const uint4*>(row + (64 * hh + 16 * t) * 2 + 16);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
template <>
__device__ __forceinline__ void k_words<int8_t>(const unsigned char* row, int hh, int t,
                                                uint32_t* w) {
  const uint4 a = *reinterpret_cast<const uint4*>(row + 64 * hh + 16 * t);
  const uint32_t x[4] = {a.x ^ 0x80808080u, a.y ^ 0x80808080u, a.z ^ 0x80808080u,
                         a.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = upper2(i8_bits(x[j], 0), i8_bits(x[j], 1));
    w[2 * j + 1] = upper2(i8_bits(x[j], 2), i8_bits(x[j], 3));
  }
}

// Dim of O^T's C row g (h = 0) or g + 8 (h = 1) in M-tile mt.
template <typename T>
__device__ __forceinline__ int o_dim(int mt, int g, int h) {
  return sizeof(T) == 2 ? 16 * mt + g + 8 * h : 16 * g + 2 * mt + h;
}

// One warp's rows and running state (registers).
struct Warp {
  uint32_t qf[8][2];  // Q^T B fragments, k-chunk c
  float o[8][4];      // O^T C fragments, M-tile mt
  float m[2], l[2];   // the lane's rows 2t, 2t+1: max (base 2), sum over the lane's slots
  int qpos[2];        // their query's slot (causal bound, window)
  bool valid[2];
};

// Q^T fragments of query row `qrow` (lane's row g; nullptr: past the rows,
// zeros) and an empty state for rows 2t, 2t+1 at slots qpos.
__device__ __forceinline__ void init_warp(Warp& w, const bf16* qrow, int t, const int* qpos,
                                          const bool* valid) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (qrow != nullptr) {
      a = *reinterpret_cast<const uint4*>(qrow + 64 * hh + 16 * t);
      b = *reinterpret_cast<const uint4*>(qrow + 64 * hh + 16 * t + 8);
    }
    const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      w.qf[4 * hh + cc][0] = x[2 * cc];
      w.qf[4 * hh + cc][1] = x[2 * cc + 1];
    }
  }
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[mt][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    w.m[i] = NEG_INF;
    w.l[i] = 0.f;
    w.qpos[i] = qpos[i];
    w.valid[i] = valid[i];
  }
}

// Fold one tile (K rows at st, V rows at st + KV; slots k0 .. k0 + 15, live
// bit j = slot k0 + j may hold a key) into the warp's state. ks / vs: the
// int8 scales of the lane's slots k0 + g, k0 + g + 8 (1 for bf16). sl2: the
// softmax scale times log2(e).
template <typename T>
__device__ __forceinline__ void fold_tile(Warp& w, const unsigned char* st, int k0, unsigned live,
                                          const float* ks, const float* vs, int causal, int window,
                                          float sl2, int lane) {
  using Tl = Tile<T>;
  const int g = lane >> 2, t = lane & 3;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    uint32_t ka[8], kb[8];
    k_words<T>(st + g * Tl::LD, hh, t, ka);
    k_words<T>(st + (g + 8) * Tl::LD, hh, t, kb);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      mma16816(s, ka[2 * cc], kb[2 * cc], ka[2 * cc + 1], kb[2 * cc + 1], w.qf[4 * hh + cc][0],
               w.qf[4 * hh + cc][1]);
  }
  // s[0], s[1]: slot k0 + g, rows 2t, 2t+1; s[2], s[3]: slot k0 + g + 8
  const int sa = k0 + g, sb = k0 + g + 8;
  const bool la = (live >> g) & 1u, lb = (live >> (g + 8)) & 1u;
  float p[2][2], alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bool kpa = la && w.valid[i], kpb = lb && w.valid[i];
    if (causal) {
      kpa = kpa && sa <= w.qpos[i];
      kpb = kpb && sb <= w.qpos[i];
    }
    if (window > 0) {
      kpa = kpa && sa > w.qpos[i] - window;
      kpb = kpb && sb > w.qpos[i] - window;
    }
    const float xa = kpa ? s[i] * sl2 * ks[0] : NEG_INF;
    const float xb = kpb ? s[2 + i] * sl2 * ks[1] : NEG_INF;
    float mx = fmaxf(xa, xb);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
    const float m_new = fmaxf(w.m[i], mx);
    alpha[i] = ex2(w.m[i] - m_new);
    const float pa = kpa ? ex2(xa - m_new) : 0.f;  // never 2^0 for a masked slot
    const float pb = kpb ? ex2(xb - m_new) : 0.f;
    w.l[i] = w.l[i] * alpha[i] + pa + pb;
    w.m[i] = m_new;
    p[0][i] = pa * vs[0];
    p[1][i] = pb * vs[1];
  }
  if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {  // some row's max moved
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      w.o[mt][0] *= alpha[0];
      w.o[mt][1] *= alpha[1];
      w.o[mt][2] *= alpha[0];
      w.o[mt][3] *= alpha[1];
    }
  }
  // P^T B fragments: (slots 2t, 2t+1; row g) and (slots 2t+8, 2t+9; row g)
  const uint32_t b0 = movmatrix_t(pack_bf16x2(p[0][0], p[0][1]));
  const uint32_t b1 = movmatrix_t(pack_bf16x2(p[1][0], p[1][1]));
  const unsigned char* sv = st + Tl::KV;
  if constexpr (sizeof(T) == 2) {
    // lane -> row of one of the four 8x8 matrices: slots 0-7 / 8-15, dims +0 / +8
    const unsigned char* base =
        sv + ((lane & 7) + ((lane >> 4) << 3)) * Tl::LD + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_t(a, base + 32 * mt);
      mma16816(w.o[mt], a[0], a[1], a[2], a[3], b0, b1);
    }
  } else {
    // bytes 16 g .. 16 g + 15 of slots 2t, 2t+1, 2t+8, 2t+9
    uint32_t v[4][4];
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 u = *reinterpret_cast<const uint4*>(sv + rows[j] * Tl::LD + 16 * g);
      v[j][0] = u.x ^ 0x80808080u; v[j][1] = u.y ^ 0x80808080u;
      v[j][2] = u.z ^ 0x80808080u; v[j][3] = u.w ^ 0x80808080u;
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {  // dims 16 g + 2 mt (A row g), + 1 (A row g + 8)
      const int wd = mt >> 1, by = 2 * (mt & 1);
      const uint32_t a0 = upper2(i8_bits(v[0][wd], by), i8_bits(v[1][wd], by));
      const uint32_t a1 = upper2(i8_bits(v[0][wd], by + 1), i8_bits(v[1][wd], by + 1));
      const uint32_t a2 = upper2(i8_bits(v[2][wd], by), i8_bits(v[3][wd], by));
      const uint32_t a3 = upper2(i8_bits(v[2][wd], by + 1), i8_bits(v[3][wd], by + 1));
      mma16816(w.o[mt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// The warp's state into `out` (its ring, once its copies have landed).
template <typename T>
__device__ __forceinline__ void store_warp(const Warp& w, WarpOut& out, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = w.l[i];
    l += __shfl_xor_sync(FULL, l, 4);
    l += __shfl_xor_sync(FULL, l, 8);
    l += __shfl_xor_sync(FULL, l, 16);
    if (g == 0) out.ml[2 * t + i] = make_float2(w.m[i], l);
  }
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    const int d0 = o_dim<T>(mt, g, 0), d1 = o_dim<T>(mt, g, 1);
    out.o[2 * t][d0] = w.o[mt][0];
    out.o[2 * t + 1][d0] = w.o[mt][1];
    out.o[2 * t][d1] = w.o[mt][2];
    out.o[2 * t + 1][d1] = w.o[mt][3];
  }
}

// The block's 4 warps merged in warp order: thread tid holds row tid / 16,
// dims (tid % 16) * 8 .. + 7: (max, sum) and the unnormalised output.
__device__ __forceinline__ void merge_warps(const unsigned char* rings, int ring_bytes,
                                            float& M, float& L, float* o) {
  const int r = threadIdx.x >> 4, d0 = (threadIdx.x & 15) * 8;
  M = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    M = fmaxf(M, reinterpret_cast<const WarpOut*>(rings + w * ring_bytes)->ml[r].x);
  L = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const WarpOut& wo = *reinterpret_cast<const WarpOut*>(rings + w * ring_bytes);
    const float e = ex2(wo.ml[r].x - M);  // an empty warp: l = 0, o = 0
    L += wo.ml[r].y * e;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] += wo.o[r][d0 + j] * e;
  }
}

// Tile bits of the slots [lo, hi) of a mask row (nullptr: every slot
// valid): bits[i] bit j = slot 16 (lo / 16 + i) + j is valid and in range.
// Returns the first and last such slot (first > last when there is none).
// The whole block calls it; a round's SCAN loads a thread are in flight together.
__device__ __forceinline__ void scan_mask(const int* __restrict__ mrow, int lo, int hi,
                                          uint16_t* bits, int& first, int& last) {
  __shared__ int first_w[WARPS], last_w[WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = (lo / TK) * TK;
  int f = INT_MAX, l = -1;
  for (int c0 = base; c0 < hi; c0 += WARPS * 32 * SCAN) {
    // unconditional loads at clamped slots, all in flight before the first
    // ballot (a load under a short-circuit && went out one at a time)
    int val[SCAN];
    if (mrow != nullptr) {
#pragma unroll
      for (int j = 0; j < SCAN; ++j) val[j] = __ldg(mrow + min(c0 + WARPS * 32 * j + tid, hi - 1));
    } else {
#pragma unroll
      for (int j = 0; j < SCAN; ++j) val[j] = 1;
    }
    unsigned mine = 0;  // lane j keeps ballot j: slots c0 + 128 j + 32 warp .. + 31
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int slot = c0 + WARPS * 32 * j + tid;
      const unsigned word = __ballot_sync(FULL, slot >= lo && slot < hi && val[j] != 0);
      if (lane == j) mine = word;
    }
    const int s0 = c0 + WARPS * 32 * lane + 32 * warp;  // a multiple of 16
    if (s0 < hi) {
      const int rel = (s0 - base) / TK;
      bits[rel] = (uint16_t)(mine & 0xFFFFu);
      bits[rel + 1] = (uint16_t)(mine >> 16);
      if (mine) {
        f = min(f, s0 + __ffs(mine) - 1);
        l = max(l, s0 + 31 - __clz(mine));
      }
    }
  }
  f = __reduce_min_sync(FULL, f);
  l = __reduce_max_sync(FULL, l);
  if (lane == 0) {
    first_w[warp] = f;
    last_w[warp] = l;
  }
  __syncthreads();
  first = INT_MAX;
  last = -1;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    first = min(first, first_w[w]);
    last = max(last, last_w[w]);
  }
}

// Tiles [begin, end) of part s of n tiles cut into `parts` (the wrappers'
// plans mirror this: ops/decode_attention.split_tiles).
__device__ __forceinline__ int part_begin(int n, int s, int parts) {
  return (int)((long long)n * s / parts);
}

// The splits a unit of nt valid tiles uses, of the n_split it was launched
// with: each gets at least MIN_TILES a warp (ops/decode_attention.used_splits).
__device__ __forceinline__ int used_splits(int nt, int n_split) {
  return max(1, min(n_split, nt / (WARPS * MIN_TILES)));
}

}  // namespace mma_decode
}  // namespace gritlm
