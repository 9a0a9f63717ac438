// Flash decode on tensor cores (mma.sync) for Hopper: the one kernel body of
// K3 (decode_attention.cu: a dense cache [L, B, Smax, Kv*Dh]) and K8
// (paged_attention.cu: a page pool [L, P, page, Kv*Dh] read through a page
// table), templated on how a tile's rows are addressed and on the head dim
// Dh (64, 96 or 128: one instance each). The design notes are in
// gritlm_tpu_torch/ops/decode_attention.py and ops/paged_attention.py.
//
// What bounds both: the bytes of the valid K/V slots (about one multiply-add
// per cache byte at Sq 1), and at serving shapes, where a call reads a few
// MB, latency: finding the valid slots, the first bytes' round trip and the
// merge of the splits. So a call is one launch, each block finds its row's
// valid tiles itself (no host sync, no row-bound pass), copies only valid
// rows, and uses only as many splits as the valid tiles pay for.
//
// A warp owns up to 8 query rows of one (batch row, kv head): the GQA group
// members of one or more query positions, so the group's K/V is read once.
// Per 16-slot tile, with the slots on the MMA's 16-row side and the query
// rows on its 8-wide side:
//   S^T [16 slots, 8 rows] = K [16, Dh] . Q^T      (Dh / 16 mma.m16n8k16)
//   online softmax over the slots, in registers (base 2)
//   O^T [Dh, 8 rows] += V^T [Dh, 16] . P^T [16, 8]  (Dh / 16 mma.m16n8k16)
// Q^T stays in registers as B fragments for the whole run. P^T's B
// fragment is S^T's C fragment transposed by movmatrix. The bf16 cache's
// V^T comes from ldmatrix.trans; the int8 cache's K and V become bf16 in
// registers, exactly (|q| <= 127), with K's per-slot scale on the scores
// and V's on P. A tile never straddles a page (page % 16 == 0), so a paged
// tile's rows come from one page-table read.
//
// Fragment maps (lane = 4 g + t):
//   Q^T / K: Dh is cut into groups of 64 dims (and, at Dh 96, one of 32);
//   k-chunk c = 4 hh + cc of 64-dim group hh: k slots 2t, 2t+1, 2t+8, 2t+9
//   hold d = 64 hh + 16 t + 4 cc + {0, 1, 2, 3}, so a lane reads 16
//   contiguous dims of a K row per group; the 32-dim group at d0 = 64:
//   k-chunk 4 + cc holds d = d0 + 8 t + 4 cc + {0, 1, 2, 3} (8 contiguous
//   dims a lane);
//   O^T, M-tile mt (Dh / 16 of them): row g / g + 8 of the tile is
//   d = 16 mt + g / + 8 (bf16, as ldmatrix.trans gives it) or
//   d = (Dh / 8) g + 2 mt / + 1 (int8, so a lane converts Dh / 8 contiguous
//   bytes of a V row).
#pragma once

#include <climits>

#include "common.cuh"

namespace gritlm {
namespace mma_decode {

constexpr int TK = 16;     // slots a tile: the MMA's 16-row side
constexpr int ROWS = 8;    // query rows a warp: the MMA's 8-wide side
constexpr int WARPS = 4;   // a block walks its split's tiles in 4 contiguous runs
constexpr int STAGES = 3;  // ring depth of each warp
constexpr int SCAN = 32;   // mask loads a thread keeps in flight in the scan (one a lane's ballot)
constexpr int MIN_TILES = 4;  // a split's least tiles a warp: fewer splits than n_split below that
constexpr float LOG2E = 1.4426950408889634f;

// The shapes that follow from the head dim DH.
template <int DH>
struct Dims {
  static_assert(DH == 64 || DH == 96 || DH == 128, "head dims 64, 96 and 128");
  static constexpr int G64 = DH / 64;          // 64-dim groups of the k-chunks
  static constexpr int TAIL = DH % 64 != 0;    // and one 32-dim group (Dh 96)
  static constexpr int STEPS = DH / 16;        // k-chunks of S^T, M-tiles of O^T
  static constexpr int DPT = DH / 16;          // output dims a thread in the merges
  static constexpr int VW = DH / 32;           // 32-bit words of an int8 V row a lane
};

template <typename T, int DH>
struct Tile {
  // bytes a slot row, padded by 16 so the 8 rows an ldmatrix (or a lane
  // group's loads) reads fall in different banks: 272, 208, 144 (bf16),
  // 144, 112, 80 (int8) bytes
  static constexpr int LD = DH * (int)sizeof(T) + 16;
  static constexpr int KV = TK * LD;                   // K rows, then V rows
  static constexpr int STAGE = 2 * KV;
  static constexpr int RING = STAGES * STAGE;          // one warp's ring
  static constexpr int CHUNKS = DH * (int)sizeof(T) / 16;  // 16-byte copies a row
  static_assert(TK * CHUNKS % 32 == 0, "a tile's copies are whole rounds of a warp");
};

// A warp's final state, written over its ring for the block's merge.
template <int DH>
struct WarpOut {
  float o[ROWS][DH + 4];  // unnormalised output rows
  float2 ml[ROWS];        // (max, sum) in base 2
};
static_assert(sizeof(WarpOut<64>) <= Tile<int8_t, 64>::RING, "WarpOut overlays a ring");
static_assert(sizeof(WarpOut<96>) <= Tile<int8_t, 96>::RING, "WarpOut overlays a ring");
static_assert(sizeof(WarpOut<128>) <= Tile<int8_t, 128>::RING, "WarpOut overlays a ring");

// Dynamic shared memory of a block: the rings, then the tile bits of the
// slot range (one 16-bit word a tile, two spare).
template <typename T, int DH>
inline int smem_bytes(int Smax) {
  return WARPS * Tile<T, DH>::RING + ((2 * ((Smax + TK - 1) / TK + 2) + 15) / 16) * 16;
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

// The 4 bf16x2 words of dims d0 .. d0 + 7 of one K row (the 32-dim group).
template <typename T>
__device__ __forceinline__ void k_words8(const unsigned char* row, int d0, uint32_t* w);
template <>
__device__ __forceinline__ void k_words8<bf16>(const unsigned char* row, int d0, uint32_t* w) {
  const uint4 a = *reinterpret_cast<const uint4*>(row + d0 * 2);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}
template <>
__device__ __forceinline__ void k_words8<int8_t>(const unsigned char* row, int d0, uint32_t* w) {
  const uint2 a = *reinterpret_cast<const uint2*>(row + d0);
  const uint32_t x[2] = {a.x ^ 0x80808080u, a.y ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    w[2 * j] = upper2(i8_bits(x[j], 0), i8_bits(x[j], 1));
    w[2 * j + 1] = upper2(i8_bits(x[j], 2), i8_bits(x[j], 3));
  }
}

// N 32-bit words from p (N = 4: 16-byte aligned, 2: 8-byte, 3: 4-byte).
template <int N>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t* w) {
  if constexpr (N == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (N == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
}

// N fp32 values to / from p (a multiple of 4: float4s, 16-byte aligned;
// else float2s, 8-byte aligned); the loads bypass L1 (another block wrote p).
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                                    x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(x[2 * i], x[2 * i + 1]);
  }
}
template <int N>
__device__ __forceinline__ void load_f32_cg(const float* p, float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = u.x; x[4 * i + 1] = u.y; x[4 * i + 2] = u.z; x[4 * i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 u = __ldcg(reinterpret_cast<const float2*>(p) + i);
      x[2 * i] = u.x; x[2 * i + 1] = u.y;
    }
  }
}

// N bf16 of x to p (N = 8: one 16-byte store, 4: 8-byte, 6: three 4-byte).
template <int N>
__device__ __forceinline__ void store_bf16(bf16* p, const float* x) {
  __align__(16) bf16 y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = __float2bfloat16(x[j]);
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(y);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(y);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<uint32_t*>(p)[i] = reinterpret_cast<const uint32_t*>(y)[i];
  }
}

// Dim of O^T's C row g (h = 0) or g + 8 (h = 1) in M-tile mt.
template <typename T, int DH>
__device__ __forceinline__ int o_dim(int mt, int g, int h) {
  return sizeof(T) == 2 ? 16 * mt + g + 8 * h : (DH / 8) * g + 2 * mt + h;
}

// One warp's rows and running state (registers).
template <int DH>
struct Warp {
  uint32_t qf[Dims<DH>::STEPS][2];  // Q^T B fragments, k-chunk c
  float o[Dims<DH>::STEPS][4];      // O^T C fragments, M-tile mt
  float m[2], l[2];   // the lane's rows 2t, 2t+1: max (base 2), sum over the lane's slots
  int qpos[2];        // their query's slot (causal bound, window)
  bool valid[2];
};

// Q^T fragments of query row `qrow` (lane's row g; nullptr: past the rows,
// zeros) and an empty state for rows 2t, 2t+1 at slots qpos.
template <int DH>
__device__ __forceinline__ void init_warp(Warp<DH>& w, const bf16* qrow, int t, const int* qpos,
                                          const bool* valid) {
  using D = Dims<DH>;
#pragma unroll
  for (int hh = 0; hh < D::G64; ++hh) {
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
  if constexpr (D::TAIL) {  // the 32-dim group: dims 64 G64 + 8 t .. + 7
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    if (qrow != nullptr) a = *reinterpret_cast<const uint4*>(qrow + 64 * D::G64 + 8 * t);
    const uint32_t x[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      w.qf[4 * D::G64 + cc][0] = x[2 * cc];
      w.qf[4 * D::G64 + cc][1] = x[2 * cc + 1];
    }
  }
#pragma unroll
  for (int mt = 0; mt < D::STEPS; ++mt)
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
template <typename T, int DH>
__device__ __forceinline__ void fold_tile(Warp<DH>& w, const unsigned char* st, int k0,
                                          unsigned live, const float* ks, const float* vs,
                                          int causal, int window, float sl2, int lane) {
  using Tl = Tile<T, DH>;
  using D = Dims<DH>;
  const int g = lane >> 2, t = lane & 3;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < D::G64; ++hh) {
    uint32_t ka[8], kb[8];
    k_words<T>(st + g * Tl::LD, hh, t, ka);
    k_words<T>(st + (g + 8) * Tl::LD, hh, t, kb);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      mma16816(s, ka[2 * cc], kb[2 * cc], ka[2 * cc + 1], kb[2 * cc + 1], w.qf[4 * hh + cc][0],
               w.qf[4 * hh + cc][1]);
  }
  if constexpr (D::TAIL) {
    uint32_t ka[4], kb[4];
    k_words8<T>(st + g * Tl::LD, 64 * D::G64 + 8 * t, ka);
    k_words8<T>(st + (g + 8) * Tl::LD, 64 * D::G64 + 8 * t, kb);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
      mma16816(s, ka[2 * cc], kb[2 * cc], ka[2 * cc + 1], kb[2 * cc + 1],
               w.qf[4 * D::G64 + cc][0], w.qf[4 * D::G64 + cc][1]);
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
    for (int mt = 0; mt < D::STEPS; ++mt) {
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
    for (int mt = 0; mt < D::STEPS; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_t(a, base + 32 * mt);
      mma16816(w.o[mt], a[0], a[1], a[2], a[3], b0, b1);
    }
  } else {
    // bytes (Dh / 8) g .. + Dh / 8 - 1 of slots 2t, 2t+1, 2t+8, 2t+9
    uint32_t v[4][D::VW];
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      load_words<D::VW>(sv + rows[j] * Tl::LD + (DH / 8) * g, v[j]);
#pragma unroll
      for (int i = 0; i < D::VW; ++i) v[j][i] ^= 0x80808080u;
    }
#pragma unroll
    for (int mt = 0; mt < D::STEPS; ++mt) {  // dims (Dh/8) g + 2 mt (A row g), + 1 (A row g + 8)
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
template <typename T, int DH>
__device__ __forceinline__ void store_warp(const Warp<DH>& w, WarpOut<DH>& out, int lane) {
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
  for (int mt = 0; mt < Dims<DH>::STEPS; ++mt) {
    const int d0 = o_dim<T, DH>(mt, g, 0), d1 = o_dim<T, DH>(mt, g, 1);
    out.o[2 * t][d0] = w.o[mt][0];
    out.o[2 * t + 1][d0] = w.o[mt][1];
    out.o[2 * t][d1] = w.o[mt][2];
    out.o[2 * t + 1][d1] = w.o[mt][3];
  }
}

// The block's 4 warps merged in warp order: thread tid holds row tid / 16,
// dims (tid % 16) * DPT .. + DPT - 1 (DPT = Dh / 16): (max, sum) and the
// unnormalised output.
template <int DH>
__device__ __forceinline__ void merge_warps(const unsigned char* rings, int ring_bytes,
                                            float& M, float& L, float* o) {
  constexpr int DPT = Dims<DH>::DPT;
  const int r = threadIdx.x >> 4, d0 = (threadIdx.x & 15) * DPT;
  M = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    M = fmaxf(M, reinterpret_cast<const WarpOut<DH>*>(rings + w * ring_bytes)->ml[r].x);
  L = 0.f;
#pragma unroll
  for (int j = 0; j < DPT; ++j) o[j] = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const WarpOut<DH>& wo = *reinterpret_cast<const WarpOut<DH>*>(rings + w * ring_bytes);
    const float e = ex2(wo.ml[r].x - M);  // an empty warp: l = 0, o = 0
    L += wo.ml[r].y * e;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[j] += wo.o[r][d0 + j] * e;
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

// Tiles [begin, end) of part s of n tiles cut into `parts` (the wrapper's
// plan mirrors this: ops/decode_attention.split_tiles).
__device__ __forceinline__ int part_begin(int n, int s, int parts) {
  return (int)((long long)n * s / parts);
}

// The splits a unit of nt valid tiles uses, of the n_split it was launched
// with: each gets at least MIN_TILES a warp (ops/decode_attention.used_splits).
__device__ __forceinline__ int used_splits(int nt, int n_split) {
  return max(1, min(n_split, nt / (WARPS * MIN_TILES)));
}


// The arguments of a launch, dense (K3) or paged (K8).
struct Args {
  const bf16* q;          // [B, Sq, H, Dh]
  const void* k;          // dense [L, B, Smax, Kv*Dh], paged [L, P, page, Kv*Dh]; bf16 or int8
  const void* v;
  const bf16* k_scale;    // int8: dense [L, B, Kv, Smax], paged [L, P, Kv, page]
  const bf16* v_scale;
  const int* mask;        // [B, Smax], nullptr: every slot valid
  const int* page_table;  // paged: [B, Smax / page]
  const int* offsets;     // [B] per-row offsets; nullptr: `offset` for every row
  float2* part_ml;        // [n_split, units, ROWS] (n_split > 1)
  float* part_o;          // [n_split, units, ROWS, Dh]
  int* counters;          // [units], 0 between launches (n_split > 1)
  bf16* out;              // [B, Sq, H, Dh]
  int B, Sq, H, Kv, Smax, layer, n_split, n_rg, causal, window, offset;
  int P, page;            // paged: pages in the pool, slots a page
  float scale;
};

// Tile tt's K and V rows (kt, vt: its first slot's rows) into stage `st`:
// only the live slots' rows are read (16 bytes a copy); the others are
// zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void copy_tile(unsigned char* st, const T* kt, const T* vt, int KD,
                                          unsigned live, int lane) {
  using Tl = Tile<T, DH>;
  constexpr int EPC = 16 / (int)sizeof(T);
#pragma unroll
  for (int j = 0; j < TK * Tl::CHUNKS / 32; ++j) {
    const int i = lane + 32 * j, r = i / Tl::CHUNKS, c = i % Tl::CHUNKS;
    const bool in = (live >> r) & 1u;
    const int off = r * KD + c * EPC;
    cp_async16(st + r * Tl::LD + 16 * c, in ? kt + off : kt, in ? 16 : 0);
    cp_async16(st + Tl::KV + r * Tl::LD + 16 * c, in ? vt + off : vt, in ? 16 : 0);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One launch a call. Block unit * n_split + split: a unit is (batch row, kv
// head, group of 8 query rows). The block first scans its row's mask over
// the slots any of its rows can see (the causal bound, the window) into tile
// bits in shared memory, and takes the first and last valid slot as the
// unit's range; the unit's tiles are cut into as many of its n_split parts
// as give each warp MIN_TILES or more (the blocks of parts not needed exit at
// once), and the block's part into 4 contiguous runs, one a warp. A warp
// streams the valid tiles of its run (tiles with no valid slot are never
// copied, masked rows are zero-filled) through a private cp.async ring of 3
// stages and folds each into its state on tensor cores; the block merges its
// warps in shared memory. One split writes the output rows; otherwise each
// split writes its partial (max, sum, output) and the block that finishes
// the unit last merges them in split order (a counter per unit, reset by
// that block), so reruns are bit-equal.
//
// Below Dh 128 the launch bound also names 1 block an SM: without it ptxas
// held the bf16 Dh-96 instance to 96 registers and spilled; with it the
// Dh-64/96 instances take 104-125 and spill nothing (H100, CUDA 12.8). A
// minimum of 0 leaves the Dh-128 instances' code as it was, byte for byte.
template <typename T, bool PAGED, int DH>
__global__ void __launch_bounds__(WARPS * 32, DH == 128 ? 0 : 1) flash_decode_kernel(Args a) {
  using Tl = Tile<T, DH>;
  constexpr int DPT = Dims<DH>::DPT;
  constexpr bool QUANT = sizeof(T) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x % a.n_split, unit = blockIdx.x / a.n_split;
  const int rg = unit % a.n_rg, kvh = (unit / a.n_rg) % a.Kv, b = unit / (a.n_rg * a.Kv);
  const int group = a.H / a.Kv, R = a.Sq * group;
  const int row0 = rg * ROWS, row1 = min(R, row0 + ROWS) - 1;
  const int offset = a.offsets != nullptr ? a.offsets[b] : a.offset;
  // the slots some row of the group can see
  const int hi = a.causal ? min(a.Smax, offset + row1 / group + 1) : a.Smax;
  const int lo = a.window > 0 ? max(0, offset + row0 / group - a.window + 1) : 0;
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
  Warp<DH> w;
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
      qpos[i] = offset + r / group;
    }
    init_warp(w, qrow, t, qpos, valid);
  }

  const int KD = a.Kv * DH;
  const T* kb = reinterpret_cast<const T*>(a.k) + kvh * DH;
  const T* vb = reinterpret_cast<const T*>(a.v) + kvh * DH;
  // tile tt's first slot: its K/V row (elements from kb, vb) and the index
  // of its int8 scales. Dense: row b of layer `layer`; paged: the page that
  // page_table[b, 16 tt / page] names, at slot 16 tt % page.
  const long long row_base = ((long long)a.layer * a.B + b) * a.Smax;
  const long long sc_base = (((long long)a.layer * a.B + b) * a.Kv + kvh) * a.Smax;
  const int* pt = PAGED ? a.page_table + (long long)b * (a.Smax / a.page) : nullptr;
  auto tile_row = [&](int tt, long long& sc) -> long long {
    const int s0 = tt * TK;
    if constexpr (PAGED) {
      const int pi = s0 / a.page, in_page = s0 - pi * a.page;
      const long long page0 = (long long)a.layer * a.P + min(max(__ldg(pt + pi), 0), a.P - 1);
      sc = (page0 * a.Kv + kvh) * a.page + in_page;
      return (page0 * a.page + in_page) * KD;
    } else {
      sc = sc_base + s0;
      return (row_base + s0) * KD;
    }
  };
  unsigned char* ring = smem + warp * Tl::RING;
  const float sl2 = a.scale * LOG2E;
  auto next_live = [&](int tt) {
    while (tt < wb && bits[tt - tbase] == 0) ++tt;
    return tt;
  };
  auto fetch_tile = [&](unsigned char* st, int tt) {
    long long sc;
    const long long row = tile_row(tt, sc);
    copy_tile<T, DH>(st, kb + row, vb + row, KD, bits[tt - tbase], lane);
  };
  // int8: the lane's scales of slots 16 tt + g, + 8 (K on the scores, V on P)
  auto scales_of = [&](int tt, float* ks, float* vs) {
    long long sc = 0;
    if (tt < wb) tile_row(tt, sc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = tt < wb && tt * TK + g + 8 * j < a.Smax;
      ks[j] = in ? __bfloat162float(a.k_scale[sc + g + 8 * j]) : 0.f;
      vs[j] = in ? __bfloat162float(a.v_scale[sc + g + 8 * j]) : 0.f;
    }
  };

  int fetch = next_live(wa);
  int cur = fetch;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fetch < wb) {
      fetch_tile(ring + s * Tl::STAGE, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }
  float ks[2] = {1.f, 1.f}, vs[2] = {1.f, 1.f}, ks_n[2], vs_n[2];
  if (QUANT) scales_of(cur, ks_n, vs_n);
  for (int i = 0; cur < wb; ++i) {
    if (fetch < wb) {  // into the slot tile i - 1 left
      fetch_tile(ring + ((i + STAGES - 1) % STAGES) * Tl::STAGE, fetch);
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
    fold_tile<T, DH>(w, ring + (i % STAGES) * Tl::STAGE, cur * TK, bits[cur - tbase], ks, vs,
                     a.causal, a.window, sl2, lane);
    __syncwarp();  // every lane has read the slot before it is refilled
    cur = nxt;
  }
  cp_async_wait_all();
  __syncwarp();
  store_warp<T, DH>(w, *reinterpret_cast<WarpOut<DH>*>(ring), lane);
  __syncthreads();

  float M, L, o[DPT];
  merge_warps<DH>(smem, Tl::RING, M, L, o);
  const int r = tid >> 4, d0 = (tid & 15) * DPT, row = row0 + r;
  const int units = gridDim.x / a.n_split;
  bf16* dst = a.out + (((long long)b * a.Sq + row / group) * a.H + kvh * group + row % group) * DH + d0;
  auto write_out = [&]() {
    if (row > row1) return;
    float y[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) y[j] = L > 0.f ? o[j] / L : 0.f;
    store_bf16<DPT>(dst, y);
  };
  if (n_used == 1) {
    write_out();
    return;
  }
  {  // every used split has tiles: it leaves its partial
    const long long p = ((long long)split * units + unit) * ROWS + r;
    if ((tid & 15) == 0) a.part_ml[p] = make_float2(M, L);
    store_f32<DPT>(a.part_o + p * DH + d0, o);
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
  M = NEG_INF;
  L = 0.f;
#pragma unroll
  for (int j = 0; j < DPT; ++j) o[j] = 0.f;
  for (int s0 = 0; s0 < n_used; s0 += 8) {
    float2 ml[8];
    float x[8][DPT];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + j;
      ml[j] = make_float2(NEG_INF, 0.f);
#pragma unroll
      for (int i = 0; i < DPT; ++i) x[j][i] = 0.f;
      if (s < n_used) {
        const long long p = ((long long)s * units + unit) * ROWS + r;
        ml[j] = __ldcg(a.part_ml + p);
        load_f32_cg<DPT>(a.part_o + p * DH + d0, x[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // an absent split: max NEG_INF, sum 0, output 0
      const float m_new = fmaxf(M, ml[j].x);
      const float alpha = ex2(M - m_new), e = ex2(ml[j].x - m_new);
      L = L * alpha + ml[j].y * e;
#pragma unroll
      for (int i = 0; i < DPT; ++i) o[i] = o[i] * alpha + x[j][i] * e;
      M = m_new;
    }
  }
  write_out();
}

// Launch B * Kv * n_rg units of n_split blocks on `st`; cudaGetLastError.
template <typename T, bool PAGED, int DH>
int launch(const Args& a, cudaStream_t st) {
  static int configured = 0;  // dynamic shared memory allowed so far
  const int smem = smem_bytes<T, DH>(a.Smax);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T, PAGED, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const int units = a.B * a.Kv * a.n_rg;
  flash_decode_kernel<T, PAGED, DH><<<units * a.n_split, WARPS * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The instance of the call's head dim and cache type (bf16, or int8 with
// scales); cudaErrorInvalidValue for a head dim with no instance.
template <bool PAGED>
int launch_dh(const Args& a, int Dh, bool quant, cudaStream_t st) {
  switch (Dh) {
    case 64:
      return quant ? launch<int8_t, PAGED, 64>(a, st) : launch<bf16, PAGED, 64>(a, st);
    case 96:
      return quant ? launch<int8_t, PAGED, 96>(a, st) : launch<bf16, PAGED, 96>(a, st);
    case 128:
      return quant ? launch<int8_t, PAGED, 128>(a, st) : launch<bf16, PAGED, 128>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The fp32 form of K3 and K8: fp32 q over an fp32 cache, or over an int8
// cache with bf16 scales, with fp32 products summed in fp32 (what the Pallas
// kernels compute on fp32 inputs). mma.m16n8k16, movmatrix and ldmatrix.trans
// are 16-bit only, and one TF32 pass would round every operand to a 10-bit
// mantissa, so the fold runs on the SIMT pipes; the rest of the body (the
// mask scan, the split plan, the per-warp cp.async rings of 16-slot tiles,
// the warp and split merges) is the bf16 form's. What bounds it: the bytes
// of the valid K/V slots, now 4 a value (1 for int8); a tile's FMAs (2 x 16
// x 8 x Dh a warp) cost less than its bytes at 128 FMA lanes an SM.
// In a tile, lane = 16 hh + s: S^T's slot s for the query rows 4 hh .. + 3
// (each score one FMA chain in depth order over the block's Q rows, staged
// once in shared memory), and O's dims lane + 32 j of all 8 rows; P^T goes
// from the one layout to the other through a warp-private [16][PT_LD] tile.
// The arguments are Args with q and out pointing to fp32 rows.
constexpr int PT_LD = 12;  // floats a slot row of a warp's P^T tile (8 rows + 4: distinct banks)

// Dynamic shared memory of a block: the rings, the unit's query rows (fp32
// [ROWS][DH]), a P^T tile a warp, then the tile bits of the slot range.
template <typename T, int DH>
struct F32Smem {
  static constexpr int Q = WARPS * Tile<T, DH>::RING;
  static constexpr int P = Q + ROWS * DH * (int)sizeof(float);
  static constexpr int BITS = P + WARPS * TK * PT_LD * (int)sizeof(float);
};

template <typename T, int DH>
inline int f32_smem_bytes(int Smax) {
  return F32Smem<T, DH>::BITS + ((2 * ((Smax + TK - 1) / TK + 2) + 15) / 16) * 16;
}

// One warp's running state: O rows at dims lane + 32 j, and the (max, sum)
// of the lane's score rows 4 hh + i (the sum over the lane's slot only).
template <int DH>
struct WarpF32 {
  float o[ROWS][DH / 32];
  float m[4], l[4];
  int qpos[4];
  bool valid[4];
};

// Four consecutive values of a K row (from dim d) as floats.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// Fold one tile (K rows at st, V rows at st + KV; slots k0 .. k0 + 15, live
// bit j = slot k0 + j may hold a key) into the warp's state. qs: the unit's
// query rows; pt: the warp's P^T tile; ks / vs: the int8 scales of the
// lane's slot (1 for fp32); sl2: the softmax scale times log2(e).
template <typename T, int DH>
__device__ __forceinline__ void fold_tile_f32(WarpF32<DH>& w, const unsigned char* st,
                                              const float* qs, float* pt, int k0, unsigned live,
                                              float ks, float vs, int causal, int window,
                                              float sl2, int lane) {
  using Tl = Tile<T, DH>;
  const int sl = lane & 15, hh = lane >> 4;
  const T* krow = reinterpret_cast<const T*>(st + sl * Tl::LD);
  const float* q4 = qs + 4 * hh * DH;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < DH; d += 4) {
    const float4 kv = load4(krow + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(q4 + i * DH + d);
      acc[i] = fmaf(qv.x, kv.x, acc[i]);
      acc[i] = fmaf(qv.y, kv.y, acc[i]);
      acc[i] = fmaf(qv.z, kv.z, acc[i]);
      acc[i] = fmaf(qv.w, kv.w, acc[i]);
    }
  }
  const int slot = k0 + sl;
  const bool live_s = (live >> sl) & 1u;
  float p[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool kp = live_s && w.valid[i];
    if (causal) kp = kp && slot <= w.qpos[i];
    if (window > 0) kp = kp && slot > w.qpos[i] - window;
    const float x = kp ? acc[i] * sl2 * ks : NEG_INF;
    float mx = x;
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
    const float m_new = fmaxf(w.m[i], mx);
    alpha[i] = ex2(w.m[i] - m_new);
    p[i] = kp ? ex2(x - m_new) : 0.f;  // never 2^0 for a masked slot
    w.l[i] = w.l[i] * alpha[i] + p[i];
    w.m[i] = m_new;
  }
  *reinterpret_cast<float4*>(pt + sl * PT_LD + 4 * hh) =
      make_float4(p[0] * vs, p[1] * vs, p[2] * vs, p[3] * vs);
  // every row's rescale, from the lanes that hold it (rows i: lane 0, 4 + i: lane 16)
  float ar[ROWS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ar[i] = __shfl_sync(FULL, alpha[i], 0);
    ar[4 + i] = __shfl_sync(FULL, alpha[i], 16);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) w.o[r][j] *= ar[r];
  __syncwarp();  // the P^T tile is written
#pragma unroll 4
  for (int t = 0; t < TK; ++t) {
    const float4 pa = *reinterpret_cast<const float4*>(pt + t * PT_LD);
    const float4 pb = *reinterpret_cast<const float4*>(pt + t * PT_LD + 4);
    const float pr[ROWS] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    const T* vt = reinterpret_cast<const T*>(st + Tl::KV + t * Tl::LD);
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      const float vv = (float)vt[lane + 32 * j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) w.o[r][j] = fmaf(pr[r], vv, w.o[r][j]);
    }
  }
}

// The warp's state into `out` (its ring, once its copies have landed).
template <int DH>
__device__ __forceinline__ void store_warp_f32(const WarpF32<DH>& w, WarpOut<DH>& out, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = w.l[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    l += __shfl_xor_sync(FULL, l, 4);
    l += __shfl_xor_sync(FULL, l, 8);
    if ((lane & 15) == 0) out.ml[4 * (lane >> 4) + i] = make_float2(w.m[i], l);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) out.o[r][lane + 32 * j] = w.o[r][j];
}

// The kernel: the bf16 form's body (flash_decode_kernel above) with the fp32
// fold, the unit's query rows staged in shared memory and fp32 output.
// The launch bound names 1 block an SM: without it ptxas held the fp32
// instances at Dh 64 and 96 to 96 registers and spilled (H100, CUDA 12.8).
template <typename T, bool PAGED, int DH>
__global__ void __launch_bounds__(WARPS * 32, 1) flash_decode_f32_kernel(Args a) {
  using Tl = Tile<T, DH>;
  using Sm = F32Smem<T, DH>;
  constexpr int DPT = Dims<DH>::DPT;
  constexpr bool QUANT = sizeof(T) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x % a.n_split, unit = blockIdx.x / a.n_split;
  const int rg = unit % a.n_rg, kvh = (unit / a.n_rg) % a.Kv, b = unit / (a.n_rg * a.Kv);
  const int group = a.H / a.Kv, R = a.Sq * group;
  const int row0 = rg * ROWS, row1 = min(R, row0 + ROWS) - 1;
  const int offset = a.offsets != nullptr ? a.offsets[b] : a.offset;
  const float* q = reinterpret_cast<const float*>(a.q);
  float* out = reinterpret_cast<float*>(a.out);
  // the slots some row of the group can see
  const int hi = a.causal ? min(a.Smax, offset + row1 / group + 1) : a.Smax;
  const int lo = a.window > 0 ? max(0, offset + row0 / group - a.window + 1) : 0;
  uint16_t* bits = reinterpret_cast<uint16_t*>(smem + Sm::BITS);
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

  // the unit's query rows into shared memory (zeros past the last row)
  float* qs = reinterpret_cast<float*>(smem + Sm::Q);
  for (int i = tid; i < ROWS * DH / 4; i += WARPS * 32) {
    const int r = i / (DH / 4), row = row0 + r, c = i % (DH / 4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row <= row1)
      x = *reinterpret_cast<const float4*>(
          q + (((long long)b * a.Sq + row / group) * a.H + kvh * group + row % group) * DH + c);
    *reinterpret_cast<float4*>(qs + r * DH + c) = x;
  }
  __syncthreads();

  WarpF32<DH> w;
  {
    const int hh = lane >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * hh + i;
      w.valid[i] = r <= row1;
      w.qpos[i] = offset + r / group;
      w.m[i] = NEG_INF;
      w.l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < DH / 32; ++j) w.o[r][j] = 0.f;
  }

  const int KD = a.Kv * DH;
  const T* kb = reinterpret_cast<const T*>(a.k) + kvh * DH;
  const T* vb = reinterpret_cast<const T*>(a.v) + kvh * DH;
  const long long row_base = ((long long)a.layer * a.B + b) * a.Smax;
  const long long sc_base = (((long long)a.layer * a.B + b) * a.Kv + kvh) * a.Smax;
  const int* pt_row = PAGED ? a.page_table + (long long)b * (a.Smax / a.page) : nullptr;
  auto tile_row = [&](int tt, long long& sc) -> long long {
    const int s0 = tt * TK;
    if constexpr (PAGED) {
      const int pi = s0 / a.page, in_page = s0 - pi * a.page;
      const long long page0 = (long long)a.layer * a.P + min(max(__ldg(pt_row + pi), 0), a.P - 1);
      sc = (page0 * a.Kv + kvh) * a.page + in_page;
      return (page0 * a.page + in_page) * KD;
    } else {
      sc = sc_base + s0;
      return (row_base + s0) * KD;
    }
  };
  unsigned char* ring = smem + warp * Tl::RING;
  float* ptile = reinterpret_cast<float*>(smem + Sm::P) + warp * TK * PT_LD;
  const float sl2 = a.scale * LOG2E;
  auto next_live = [&](int tt) {
    while (tt < wb && bits[tt - tbase] == 0) ++tt;
    return tt;
  };
  auto fetch_tile = [&](unsigned char* st, int tt) {
    long long sc;
    const long long row = tile_row(tt, sc);
    copy_tile<T, DH>(st, kb + row, vb + row, KD, bits[tt - tbase], lane);
  };

  int fetch = next_live(wa);
  int cur = fetch;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fetch < wb) {
      fetch_tile(ring + s * Tl::STAGE, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }
  for (int i = 0; cur < wb; ++i) {
    if (fetch < wb) {  // into the slot tile i - 1 left
      fetch_tile(ring + ((i + STAGES - 1) % STAGES) * Tl::STAGE, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest STAGES-1" = tile i
    float ks = 1.f, vs = 1.f;
    if (QUANT) {  // the lane's slot's scales (K on the scores, V on P)
      long long sc;
      tile_row(cur, sc);
      const bool in = cur * TK + (lane & 15) < a.Smax;
      ks = in ? __bfloat162float(a.k_scale[sc + (lane & 15)]) : 0.f;
      vs = in ? __bfloat162float(a.v_scale[sc + (lane & 15)]) : 0.f;
    }
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the other lanes' copies are visible
    fold_tile_f32<T, DH>(w, ring + (i % STAGES) * Tl::STAGE, qs, ptile, cur * TK,
                         bits[cur - tbase], ks, vs, a.causal, a.window, sl2, lane);
    __syncwarp();  // every lane has read the slot and the P^T tile before they are refilled
    cur = next_live(cur + 1);
  }
  cp_async_wait_all();
  __syncwarp();
  store_warp_f32<DH>(w, *reinterpret_cast<WarpOut<DH>*>(ring), lane);
  __syncthreads();

  float M, L, o[DPT];
  merge_warps<DH>(smem, Tl::RING, M, L, o);
  const int r = tid >> 4, d0 = (tid & 15) * DPT, row = row0 + r;
  const int units = gridDim.x / a.n_split;
  float* dst = out + (((long long)b * a.Sq + row / group) * a.H + kvh * group + row % group) * DH + d0;
  auto write_out = [&]() {
    if (row > row1) return;
    float y[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) y[j] = L > 0.f ? o[j] / L : 0.f;
    store_f32<DPT>(dst, y);
  };
  if (n_used == 1) {
    write_out();
    return;
  }
  {  // every used split has tiles: it leaves its partial
    const long long p = ((long long)split * units + unit) * ROWS + r;
    if ((tid & 15) == 0) a.part_ml[p] = make_float2(M, L);
    store_f32<DPT>(a.part_o + p * DH + d0, o);
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
  M = NEG_INF;
  L = 0.f;
#pragma unroll
  for (int j = 0; j < DPT; ++j) o[j] = 0.f;
  for (int s0 = 0; s0 < n_used; s0 += 8) {
    float2 ml[8];
    float x[8][DPT];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + j;
      ml[j] = make_float2(NEG_INF, 0.f);
#pragma unroll
      for (int i = 0; i < DPT; ++i) x[j][i] = 0.f;
      if (s < n_used) {
        const long long p = ((long long)s * units + unit) * ROWS + r;
        ml[j] = __ldcg(a.part_ml + p);
        load_f32_cg<DPT>(a.part_o + p * DH + d0, x[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // an absent split: max NEG_INF, sum 0, output 0
      const float m_new = fmaxf(M, ml[j].x);
      const float alpha = ex2(M - m_new), e = ex2(ml[j].x - m_new);
      L = L * alpha + ml[j].y * e;
#pragma unroll
      for (int i = 0; i < DPT; ++i) o[i] = o[i] * alpha + x[j][i] * e;
      M = m_new;
    }
  }
  write_out();
}

// Launch the fp32 form: B * Kv * n_rg units of n_split blocks on `st`.
template <typename T, bool PAGED, int DH>
int launch_f32(const Args& a, cudaStream_t st) {
  static int configured = 0;  // dynamic shared memory allowed so far
  const int smem = f32_smem_bytes<T, DH>(a.Smax);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_f32_kernel<T, PAGED, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const int units = a.B * a.Kv * a.n_rg;
  flash_decode_f32_kernel<T, PAGED, DH><<<units * a.n_split, WARPS * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The fp32 form's instance of the call's head dim and cache type (fp32, or
// int8 with bf16 scales); cudaErrorInvalidValue for a head dim with none.
template <bool PAGED>
int launch_dh_f32(const Args& a, int Dh, bool quant, cudaStream_t st) {
  switch (Dh) {
    case 64:
      return quant ? launch_f32<int8_t, PAGED, 64>(a, st) : launch_f32<float, PAGED, 64>(a, st);
    case 96:
      return quant ? launch_f32<int8_t, PAGED, 96>(a, st) : launch_f32<float, PAGED, 96>(a, st);
    case 128:
      return quant ? launch_f32<int8_t, PAGED, 128>(a, st)
                   : launch_f32<float, PAGED, 128>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mma_decode
}  // namespace gritlm
