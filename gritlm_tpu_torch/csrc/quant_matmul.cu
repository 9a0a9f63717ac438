// K6 (w8a16) and K7 (w4a16): matrix products against quantized weights,
// for Hopper (sm_90a). The design note, the routing and the plain versions
// are in gritlm_tpu_torch/ops/quant_matmul.py.
//
// One kernel template for both. A block of 4 warps computes a BM x 128 tile
// of y = x @ W over a range of the contracting axis (split-K), 128
// contracting rows a stage:
//   - x [BM, 128] bf16 and the stage's raw weight bytes (int8 [128, 128], or
//     packed uint8 [64, 128] plus its fp32 group scales) are copied to shared
//     memory with cp.async, in a ring of 3 stages (BM 16) or 2 (BM 64);
//   - the block turns the raw bytes into a bf16 tile [128, 128] in shared
//     memory: int8 -> bf16 exactly (|q| <= 127); int4 -> (nibble - 8) *
//     group scale in fp32, rounded to bf16 (the reference's rounding), with
//     byte permutes and fp32 adds in place of the slow conversion
//     instructions, and each group's scales held in registers. The
//     low nibbles of packed row r form tile row r (contracting row k0 + r),
//     the high nibbles tile row 64 + r (contracting row K/2 + k0 + r); the x
//     tile takes its columns from the two halves of x to match;
//   - bf16 wmma 16x16x16 products accumulate in fp32 registers.
// One split (large M) writes y directly: (acc * scale) for K6, acc for K7,
// rounded to bf16. Several splits write fp32 partial sums [splits, M, N];
// the block that finishes a tile last (a counter per tile) sums them in
// split order, scales (K6) and rounds, so a call is one launch.
// K6's per-channel scale commutes out of the contracting sum, so it is
// applied once at the end; K7's group scales do not, so they are applied
// to each weight before the product.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using gritlm::bf16;

namespace {

constexpr int BN = 128;        // output columns per block
constexpr int DK = 128;        // contracting rows per stage (unpacked)
constexpr int HK = DK / 2;     // packed int4 rows per stage
constexpr int NTHREADS = 128;  // 4 warps
constexpr int RSTEP = NTHREADS / 8;  // tile rows a dequantization pass covers
constexpr int LDA = DK + 8;    // bf16 row stride of the staged x tile
constexpr int LDB = BN + 8;    // bf16 row stride of the dequantized weight tile
constexpr int LDC = BN + 4;    // fp32 row stride of the epilogue tile
constexpr int MAX_GS = 4;      // int4 scale rows per half-stage (group >= 16)

constexpr int round32(int b) { return (b + 31) / 32 * 32; }

template <int BM, bool INT4>
struct Layout {
  static constexpr int X_BYTES = round32(BM * LDA * 2);
  static constexpr int W_BYTES = INT4 ? HK * BN : DK * BN;
  static constexpr int S_BYTES = INT4 ? 2 * MAX_GS * BN * 4 : 0;
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int STAGES = BM <= 16 ? 3 : 2;
  static constexpr int B_BYTES = DK * LDB * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int TAIL = B_BYTES > C_BYTES ? B_BYTES : C_BYTES;
  static constexpr int TOTAL = STAGES * STAGE + TAIL;
};

struct Args {
  const bf16* x;          // [M, K]
  const uint8_t* w;       // int8 [K, N] (K6) or packed uint8 [K/2, N] (K7)
  const float* scale;     // [1, N] (K6) or [K/g, N] (K7)
  bf16* out;              // [M, N]
  float* part;            // [splits, M, N] fp32 partial sums (splits > 1)
  int* counters;          // one per output tile, 0 between launches (splits > 1)
  int M, K, N;
  int g;                  // K7's group (contracting rows per scale row)
  int nk;                 // stages over the whole contracting axis
  int kper;               // stages per split
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage t of the contracting axis into `st`: the x tile, the raw weight rows
// and (K7) the group-scale rows of both halves. Rows past M, the contracting
// axis or N are zero-filled (a zero x column cancels whatever weight it meets).
template <int BM, bool INT4>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& a, int m0, int n0,
                                           int t, int tid) {
  using Lt = Layout<BM, INT4>;
  bf16* sx = reinterpret_cast<bf16*>(st);
  unsigned char* sw = st + Lt::X_BYTES;
  constexpr int XP = DK / 8;  // 16-byte pieces of an x tile row
  for (int i = tid; i < BM * XP; i += NTHREADS) {
    const int r = i / XP, c = (i % XP) * 8;
    int col;
    bool in;
    if (INT4) {  // tile columns [0, 64): x[:, k0 + c]; [64, 128): x[:, K/2 + k0 + c - 64]
      const int kp = a.K / 2, kk = t * HK + c % HK;
      in = m0 + r < a.M && kk < kp;
      col = (c / HK) * kp + kk;
    } else {
      col = t * DK + c;
      in = m0 + r < a.M && col < a.K;
    }
    gritlm::cp_async16(sx + r * LDA + c, in ? a.x + (long long)(m0 + r) * a.K + col : a.x,
                       in ? 16 : 0);
  }
  constexpr int ROWS = INT4 ? HK : DK;
  constexpr int WP = BN / 16;  // 16-byte pieces of a weight tile row
  const int krows = INT4 ? a.K / 2 : a.K;
  for (int i = tid; i < ROWS * WP; i += NTHREADS) {
    const int r = i / WP, c = (i % WP) * 16;
    const int kr = t * ROWS + r;
    const bool in = kr < krows && n0 + c < a.N;
    gritlm::cp_async16(sw + r * BN + c, in ? a.w + (long long)kr * a.N + n0 + c : a.w,
                       in ? 16 : 0);
  }
  if (INT4) {
    float* ss = reinterpret_cast<float*>(sw + Lt::W_BYTES);
    const int G = a.K / a.g;
    const int gs = a.g >= HK ? 1 : HK / a.g;  // scale rows a half-stage spans
    const int glo = t * HK / a.g, ghi = (a.K / 2) / a.g + glo;
    constexpr int SP = BN / 4;  // 16-byte pieces of a scale row
    for (int i = tid; i < 2 * gs * SP; i += NTHREADS) {
      const int r = i / SP, c = (i % SP) * 4;
      const int grow = r < gs ? glo + r : ghi + r - gs;
      const int slot = r < gs ? r : MAX_GS + r - gs;
      const bool in = grow < G && n0 + c < a.N;
      gritlm::cp_async16(ss + slot * BN + c, in ? a.scale + (long long)grow * a.N + n0 + c
                                                : a.scale, in ? 16 : 0);
    }
  }
}

// Conversions without the type-conversion unit (I2F, F2F run at a fraction
// of the ALU rate and were what bounded the first version at decode): a
// byte u becomes the float 2^23 + u by placing it under the exponent bits
// 0x4B (PRMT), and an add removes the offset exactly.
__device__ __forceinline__ float magic_float(uint32_t bytes, uint32_t k) {
  return __uint_as_float(__byte_perm(bytes, 0x4B000000u, 0x7540u + k));
}

// Two floats whose values bf16 holds exactly -> one bf16x2 word (the upper
// halves; element 0 in the low half).
__device__ __forceinline__ uint32_t pack_upper(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

// fp32 -> bf16 round to nearest even, in the upper 16 bits (finite values;
// the same rule as PyTorch's and __float2bfloat16_rn).
__device__ __forceinline__ uint32_t rne_upper(float f) {
  const uint32_t u = __float_as_uint(f);
  return u + 0x7FFFu + ((u >> 16) & 1u);
}

// The stage's raw weight bytes -> the bf16 tile sb [DK][LDB]. Thread t
// converts the 16 columns (t % 8) * 16 of rows t / 8 + RSTEP j.
template <int BM, bool INT4>
__device__ __forceinline__ void dequant_stage(const unsigned char* st, bf16* sb, const Args& a,
                                              int tid) {
  using Lt = Layout<BM, INT4>;
  const unsigned char* sw = st + Lt::X_BYTES;
  const int c = (tid % 8) * 16, r0 = tid / 8;
  if (INT4) {
    // (nibble - 8) * scale in fp32, rounded to bf16: the reference's weight
    const float* ss = reinterpret_cast<const float*>(sw + Lt::W_BYTES);
    float slo[16], shi[16];
    int loaded = -1;
#pragma unroll
    for (int j = 0; j < HK / RSTEP; ++j) {
      const int r = r0 + RSTEP * j;
      const int gr = a.g >= HK ? 0 : r / a.g;
      if (gr != loaded) {  // rows of one group share their scales
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 l4 = *reinterpret_cast<const float4*>(ss + gr * BN + c + 4 * q);
          const float4 h4 = *reinterpret_cast<const float4*>(ss + (MAX_GS + gr) * BN + c + 4 * q);
          slo[4 * q] = l4.x; slo[4 * q + 1] = l4.y; slo[4 * q + 2] = l4.z; slo[4 * q + 3] = l4.w;
          shi[4 * q] = h4.x; shi[4 * q + 1] = h4.y; shi[4 * q + 2] = h4.z; shi[4 * q + 3] = h4.w;
        }
        loaded = gr;
      }
      const uint4 raw = *reinterpret_cast<const uint4*>(sw + r * BN + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t nl = words[q] & 0x0F0F0F0Fu, nh = (words[q] >> 4) & 0x0F0F0F0Fu;
        float vl[4], vh[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          vl[k] = (magic_float(nl, k) - 8388616.0f) * slo[4 * q + k];  // 2^23 + 8
          vh[k] = (magic_float(nh, k) - 8388616.0f) * shi[4 * q + k];
        }
        lo[2 * q] = __byte_perm(rne_upper(vl[0]), rne_upper(vl[1]), 0x7632u);
        lo[2 * q + 1] = __byte_perm(rne_upper(vl[2]), rne_upper(vl[3]), 0x7632u);
        hi[2 * q] = __byte_perm(rne_upper(vh[0]), rne_upper(vh[1]), 0x7632u);
        hi[2 * q + 1] = __byte_perm(rne_upper(vh[2]), rne_upper(vh[3]), 0x7632u);
      }
      uint4* dlo = reinterpret_cast<uint4*>(sb + r * LDB + c);
      uint4* dhi = reinterpret_cast<uint4*>(sb + (HK + r) * LDB + c);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  } else {
    // int8 q -> bf16, exactly: byte ^ 0x80 is q + 128, and an integer of at
    // most 8 significant bits is its own bf16 (the float's upper half)
#pragma unroll
    for (int j = 0; j < DK / RSTEP; ++j) {
      const int r = r0 + RSTEP * j;
      const uint4 raw = *reinterpret_cast<const uint4*>(sw + r * BN + c);
      const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                 raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = magic_float(words[q], k) - 8388736.0f;  // 2^23 + 128
        w[2 * q] = pack_upper(v[0], v[1]);
        w[2 * q + 1] = pack_upper(v[2], v[3]);
      }
      uint4* d = reinterpret_cast<uint4*>(sb + r * LDB + c);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// y[m, n:n+8] = bf16(v) (* scale[n:n+8] first for K6).
template <bool INT4>
__device__ __forceinline__ void store_out(const Args& a, int m, int n, float4 lo, float4 hi) {
  float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (!INT4) {
    const float4* s4 = reinterpret_cast<const float4*>(a.scale + n);
    const float4 s0 = s4[0], s1 = s4[1];
    v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
    v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
  }
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(a.out + (long long)m * a.N + n) = *reinterpret_cast<const uint4*>(o);
}

template <int BM, bool INT4>
__global__ void __launch_bounds__(NTHREADS) quant_matmul_kernel(Args a) {
  using Lt = Layout<BM, INT4>;
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = NTHREADS / 32 / WARPS_M;
  constexpr int FM = BM / 16 / WARPS_M;  // 16-row fragments a warp holds
  constexpr int FN = BN / 16 / WARPS_N;  // 16-column fragments a warp holds
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* tail = smem + Lt::STAGES * Lt::STAGE;
  bf16* sb = reinterpret_cast<bf16*>(tail);    // the dequantized weight tile
  float* sc = reinterpret_cast<float*>(tail);  // the epilogue reuses it

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int t0 = blockIdx.z * a.kper;
  const int nt = min(a.nk, t0 + a.kper) - t0;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < Lt::STAGES - 1; ++s) {
    if (s < nt) load_stage<BM, INT4>(smem + s * Lt::STAGE, a, m0, n0, t0 + s, tid);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    const int nxt = i + Lt::STAGES - 1;  // its slot was last read in step i - 1
    if (nxt < nt) load_stage<BM, INT4>(smem + (nxt % Lt::STAGES) * Lt::STAGE, a, m0, n0,
                                       t0 + nxt, tid);
    cp_async_commit();  // possibly empty: keeps "all but the newest STAGES-1" = stage i
    cp_async_wait<Lt::STAGES - 1>();
    __syncthreads();
    const unsigned char* st = smem + (i % Lt::STAGES) * Lt::STAGE;
    dequant_stage<BM, INT4>(st, sb, a, tid);
    __syncthreads();
    const bf16* sx = reinterpret_cast<const bf16*>(st);
#pragma unroll
    for (int kk = 0; kk < DK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int f = 0; f < FM; ++f)
        wmma::load_matrix_sync(af[f], sx + ((wm * FM + f) * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, sb + kk * LDB + (wn * FN + j) * 16, LDB);
#pragma unroll
        for (int f = 0; f < FM; ++f) wmma::mma_sync(acc[f][j], af[f], bfr, acc[f][j]);
      }
    }
    __syncthreads();  // sb and this stage's slot are written again next step
  }
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(sc + ((wm * FM + f) * 16) * LDC + (wn * FN + j) * 16, acc[f][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  const bool direct = gridDim.z == 1;
  constexpr int CP = BN / 8;  // 8-column pieces of an output row
  for (int i = tid; i < BM * CP; i += NTHREADS) {
    const int r = i / CP, c = (i % CP) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;  // N % 16 == 0: a piece is wholly in or out
    const float4* src = reinterpret_cast<const float4*>(sc + r * LDC + c);
    if (direct) {
      store_out<INT4>(a, m, n, src[0], src[1]);
    } else {
      float4* dst = reinterpret_cast<float4*>(a.part + ((long long)blockIdx.z * a.M + m) * a.N + n);
      dst[0] = src[0];
      dst[1] = src[1];
    }
  }
  if (direct) return;

  // Split-K fix-up: the block that finishes a tile last sums its splits'
  // partials, in split order (the same sums whichever block is last), and
  // leaves the tile's counter at 0 for the next launch on the stream.
  __shared__ bool last;
  __threadfence();  // this block's partials, visible to the block that sums them
  __syncthreads();
  if (tid == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(a.counters + tile, 1) == (int)gridDim.z - 1;
    if (last) a.counters[tile] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < BM * CP; i += NTHREADS) {
    const int r = i / CP, c = (i % CP) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    for (int p = 0; p < (int)gridDim.z; ++p) {  // L2 loads: other SMs wrote these
      const float4* src = reinterpret_cast<const float4*>(a.part + ((long long)p * a.M + m) * a.N + n);
      const float4 l = __ldcg(src), h = __ldcg(src + 1);
      lo.x += l.x; lo.y += l.y; lo.z += l.z; lo.w += l.w;
      hi.x += h.x; hi.y += h.y; hi.z += h.z; hi.w += h.w;
    }
    store_out<INT4>(a, m, n, lo, hi);
  }
}

template <int BM, bool INT4>
int launch(const Args& a, int splits, cudaStream_t stream) {
  using Lt = Layout<BM, INT4>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(quant_matmul_kernel<BM, INT4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::TOTAL);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, splits);
  quant_matmul_kernel<BM, INT4><<<grid, NTHREADS, Lt::TOTAL, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool INT4>
int dispatch(const Args& a, int bm, int splits, cudaStream_t stream) {
  if (bm == 16) return launch<16, INT4>(a, splits, stream);
  if (bm == 64) return launch<64, INT4>(a, splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K6: out [M, N] bf16 = (x [M, K] bf16 @ q8 [K, N] int8) * scale [1, N] fp32.
extern "C" int gritlm_w8a16_matmul(const void* x, const void* q8, const void* scale, void* out,
                                   void* part, void* counters, int M, int K, int N, int bm,
                                   int splits, int kper, void* stream) {
  Args a{(const bf16*)x, (const uint8_t*)q8, (const float*)scale, (bf16*)out, (float*)part,
         (int*)counters, M, K, N, 0, (K + DK - 1) / DK, kper};
  return dispatch<false>(a, bm, splits, (cudaStream_t)stream);
}

// K7: out [M, N] bf16 = x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi) for packed
// q4 [K/2, N] uint8 and group scales [K/g, N] fp32.
extern "C" int gritlm_w4a16_matmul(const void* x, const void* q4, const void* scale, void* out,
                                   void* part, void* counters, int M, int K, int N, int g,
                                   int bm, int splits, int kper, void* stream) {
  Args a{(const bf16*)x, (const uint8_t*)q4, (const float*)scale, (bf16*)out, (float*)part,
         (int*)counters, M, K, N, g, (K / 2 + HK - 1) / HK, kper};
  return dispatch<true>(a, bm, splits, (cudaStream_t)stream);
}
