// K6 (w8a16) and K7 (w4a16): matrix products against quantized weights,
// for Hopper (sm_90a). The design notes, the routing and the plain versions
// are in gritlm_tpu_torch/ops/quant_matmul.py.
//
// What bounds both at decode rows (M <= 16): the weight's bytes (1 a weight
// for K6, 0.5 plus scales for K7), read once; and, since each weight is
// turned into a bf16 operand in registers, the instructions spent on each
// weight. So the rows kernels keep the weight stream flowing on every SM
// with no block barrier in the main loop, and spend a few ALU instructions
// a weight.
//
// The rows kernels, K7's `w4_rows_kernel` and K6's `w8_rows_kernel`:
// y^T = W^T x^T with mma.sync.m16n8k16, the dequantized weight as the A
// operand (16 output columns on the MMA's 16-row side) and x as the B
// operand (8 rows on its 8-wide side), so decode rows fill the product with
// no padding; a block takes 8 or 16 rows (more rows: more blocks along x's
// rows). A block of 4 warps owns 128 output columns; each warp walks its
// own contiguous run of the block's contracting stages (32 contracting rows
// a stage) through a private cp.async ring of 4 raw-byte stages. Each lane
// reads whole 16-byte runs of weight rows (16 columns each) and turns them
// in registers into the A fragments of 8 MMAs, whose k slots 2t, 2t+1,
// 2t+8, 2t+9 are the contracting rows the lane read, so x's B fragment is
// two bf16 pairs read as they lie in memory:
//   K7: packed rows r, r+1; their low nibbles are k slots 2t, 2t+1 and
//   their high nibbles k slots 2t+8, 2t+9 (contracting rows K/2 + r, + 1);
//   each weight is (nibble - 8) * scale in fp32 rounded to bf16 by
//   cvt.rn.bf16x2 (the plain version's rounding); the group's scales sit in
//   registers and are read once a group.
//   K6: int8 rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row k-step; each byte
//   becomes bf16 exactly (|q| <= 127 has at most 7 significant bits) by a
//   byte permute under the exponent of 2^23 and one fp32 add, and two
//   floats' upper halves make a bf16x2 by a second permute; the
//   per-channel scale commutes out of the contracting sum and multiplies
//   each column once, in the epilogue.
// The block sums its warps' partial tiles in shared memory.
//
// K6 above the rows kernel's range, `quant_matmul_kernel`: a block of 4
// warps computes a 64 x 128 tile of y = x @ W over a range of the
// contracting axis, 128 contracting rows a stage: x [64, 128] bf16 and the
// stage's raw int8 weight bytes [128, 128] are copied to shared memory with
// cp.async in a ring of 2 stages; the block turns the raw bytes into a bf16
// tile [128, 128] in shared memory by the same permutes; bf16 wmma 16x16x16
// products accumulate in fp32 registers; the scale is applied at the end.
// It reads and converts the weight once for 64 rows, where the rows kernel
// does so (from L2) for every 16, so it is the faster of the two above the
// rows kernel's range (ops/quant_matmul.W8_ROWS_MAX, measured).
//
// All: one split writes y directly. Several splits write fp32 partial sums
// [splits, M, N]; the block that finishes a tile last (a counter per tile)
// sums them in split order, scales (K6) and rounds, so a call is one launch
// and reruns are bit-equal.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using gritlm::bf16;

namespace {

constexpr int BN = 128;        // output columns per block
constexpr int DK = 128;        // contracting rows per stage
constexpr int NTHREADS = 128;  // 4 warps
constexpr int RSTEP = NTHREADS / 8;  // tile rows a dequantization pass covers
constexpr int LDA = DK + 8;    // bf16 row stride of the staged x tile
constexpr int LDB = BN + 8;    // bf16 row stride of the dequantized weight tile
constexpr int LDC = BN + 4;    // fp32 row stride of the epilogue tile

constexpr int round32(int b) { return (b + 31) / 32 * 32; }

template <int BM>
struct Layout {
  static constexpr int X_BYTES = round32(BM * LDA * 2);
  static constexpr int W_BYTES = DK * BN;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES = 2;
  static constexpr int B_BYTES = DK * LDB * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int TAIL = B_BYTES > C_BYTES ? B_BYTES : C_BYTES;
  static constexpr int TOTAL = STAGES * STAGE + TAIL;
};

struct Args {  // of all kernels
  const bf16* x;          // [M, K]
  const uint8_t* w;       // int8 [K, N] (K6) or packed uint8 [K/2, N] (K7)
  const float* scale;     // [1, N] (K6) or [K/g, N] (K7)
  bf16* out;              // [M, N]
  float* part;            // [splits, M, N] fp32 partial sums (splits > 1)
  int* counters;          // one per output tile, 0 between launches (splits > 1)
  int M, K, N;
  int g;                  // K7's group (contracting rows per scale row)
  int nk;                 // stages over the whole contracting axis (rounded up)
  int kper;               // stages per split
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K6's stage t of the contracting axis into `st`: the x tile and the raw
// weight rows. Rows past M, the contracting axis or N are zero-filled (a
// zero x column cancels whatever weight it meets).
template <int BM>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& a, int m0, int n0,
                                           int t, int tid) {
  using Lt = Layout<BM>;
  bf16* sx = reinterpret_cast<bf16*>(st);
  unsigned char* sw = st + Lt::X_BYTES;
  constexpr int XP = DK / 8;  // 16-byte pieces of an x tile row
  for (int i = tid; i < BM * XP; i += NTHREADS) {
    const int r = i / XP, c = (i % XP) * 8;
    const int col = t * DK + c;
    const bool in = m0 + r < a.M && col < a.K;
    gritlm::cp_async16(sx + r * LDA + c, in ? a.x + (long long)(m0 + r) * a.K + col : a.x,
                       in ? 16 : 0);
  }
  constexpr int WP = BN / 16;  // 16-byte pieces of a weight tile row
  for (int i = tid; i < DK * WP; i += NTHREADS) {
    const int r = i / WP, c = (i % WP) * 16;
    const int kr = t * DK + r;
    const bool in = kr < a.K && n0 + c < a.N;
    gritlm::cp_async16(sw + r * BN + c, in ? a.w + (long long)kr * a.N + n0 + c : a.w,
                       in ? 16 : 0);
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

// K6's stage of raw int8 weights -> the bf16 tile sb [DK][LDB], exactly:
// byte ^ 0x80 is q + 128, and an integer of at most 8 significant bits is
// its own bf16 (the float's upper half). Thread t converts the 16 columns
// (t % 8) * 16 of rows t / 8 + RSTEP j.
template <int BM>
__device__ __forceinline__ void dequant_stage(const unsigned char* st, bf16* sb, int tid) {
  const unsigned char* sw = st + Layout<BM>::X_BYTES;
  const int c = (tid % 8) * 16, r0 = tid / 8;
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

// y[m, n:n+8] = bf16(v * scale[n:n+8]) (K6's per-channel scale).
__device__ __forceinline__ void store_out(const Args& a, int m, int n, float4 lo, float4 hi) {
  float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const float4* s4 = reinterpret_cast<const float4*>(a.scale + n);
  const float4 s0 = s4[0], s1 = s4[1];
  v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
  v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(a.out + (long long)m * a.N + n) = *reinterpret_cast<const uint4*>(o);
}


template <int BM>
__global__ void __launch_bounds__(NTHREADS) quant_matmul_kernel(Args a) {
  using Lt = Layout<BM>;
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
    if (s < nt) load_stage<BM>(smem + s * Lt::STAGE, a, m0, n0, t0 + s, tid);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    const int nxt = i + Lt::STAGES - 1;  // its slot was last read in step i - 1
    if (nxt < nt) load_stage<BM>(smem + (nxt % Lt::STAGES) * Lt::STAGE, a, m0, n0,
                                       t0 + nxt, tid);
    cp_async_commit();  // possibly empty: keeps "all but the newest STAGES-1" = stage i
    cp_async_wait<Lt::STAGES - 1>();
    __syncthreads();
    const unsigned char* st = smem + (i % Lt::STAGES) * Lt::STAGE;
    dequant_stage<BM>(st, sb, tid);
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
      store_out(a, m, n, src[0], src[1]);
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
    store_out(a, m, n, lo, hi);
  }
}

template <int BM>
int launch(const Args& a, int splits, cudaStream_t stream) {
  using Lt = Layout<BM>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(quant_matmul_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::TOTAL);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, splits);
  quant_matmul_kernel<BM><<<grid, NTHREADS, Lt::TOTAL, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- rows kernels
namespace rows {

constexpr int WARPS = 4;
constexpr int STAGES = 4;  // ring depth of each warp

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// y[m, n:n+4] = bf16(v), times the per-channel scale (K6) or not (K7).
template <bool SCALED>
__device__ __forceinline__ void store4(const Args& a, int m, int n, float4 v) {
  if constexpr (SCALED) {
    const float4 s = *reinterpret_cast<const float4*>(a.scale + n);
    v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
  }
  __align__(8) bf16 o[4] = {__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y),
                            __float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w)};
  *reinterpret_cast<uint2*>(a.out + (long long)m * a.N + n) = *reinterpret_cast<const uint2*>(o);
}

// The end of a rows kernel, once every warp's copies have landed: lane
// (g, t)'s acc[mt][j] is the C fragment of MMA j, whose A row g is column
// n0 + 16 g + 2 j and row g + 8 column n0 + 16 g + 2 j + 1, at x rows
// m0 + 8 mt + 2 t, + 1. Each warp's partial tile goes over its own ring
// (WARP bytes, rows LDR floats apart), the block sums them in warp order,
// and one split stores y, or several leave partials that the last block of
// the tile sums in split order.
template <int MT, int WARP, int LDR, bool SCALED>
__device__ __forceinline__ void epilogue(const float (&acc)[MT][8][4], const Args& a,
                                         unsigned char* smem, int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* ring = smem + warp * WARP;
  // the warp's partial tile [8 MT rows][128 columns] over its own ring
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* dst = red + (8 * mt + 2 * t + rr) * LDR + 16 * g;
#pragma unroll
      for (int v = 0; v < 4; ++v)  // columns 16 g + 4 v .. + 3 = MMAs 2 v, 2 v + 1
        *reinterpret_cast<float4*>(dst + 4 * v) =
            make_float4(acc[mt][2 * v][rr], acc[mt][2 * v][2 + rr], acc[mt][2 * v + 1][rr],
                        acc[mt][2 * v + 1][2 + rr]);
    }
  __syncthreads();

  // the block's tile: the four warps' partials summed in warp order
  const bool direct = gridDim.z == 1;
  constexpr int CP = BN / 4;  // 4-column pieces of a row
#pragma unroll
  for (int k = 0; k < MT * 8 * CP / (WARPS * 32); ++k) {
    const int i = threadIdx.x + WARPS * 32 * k, r = i / CP, c = (i % CP) * 4;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(smem + w * WARP) + r * LDR + c);
      s4.x += v.x; s4.y += v.y; s4.z += v.z; s4.w += v.w;
    }
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;  // N % 16 == 0: a piece is wholly in or out
    if (direct) {
      store4<SCALED>(a, m, n, s4);
    } else {
      *reinterpret_cast<float4*>(a.part + ((long long)blockIdx.z * a.M + m) * a.N + n) = s4;
    }
  }
  if (direct) return;

  // Split-K fix-up: the block that finishes a tile last sums the splits'
  // partials in split order and resets the tile's counter to 0.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(a.counters + tile, 1) == (int)gridDim.z - 1;
    if (last) a.counters[tile] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int KI = MT * 8 * CP / (WARPS * 32);  // 4-column pieces a thread sums
  float4 s4[KI];
#pragma unroll
  for (int k = 0; k < KI; ++k) s4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < (int)gridDim.z; p0 += 8) {  // 8 splits' loads in flight at once
    float4 v[8][KI];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < KI; ++k) {
        const int i = threadIdx.x + WARPS * 32 * k, m = m0 + i / CP, n = n0 + (i % CP) * 4;
        const bool in = p0 + j < (int)gridDim.z && m < a.M && n < a.N;
        v[j][k] = in ? __ldcg(reinterpret_cast<const float4*>(  // other SMs wrote these
                           a.part + ((long long)(p0 + j) * a.M + m) * a.N + n))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)  // split order: the same sums whichever block is last
#pragma unroll
      for (int k = 0; k < KI; ++k) {
        s4[k].x += v[j][k].x; s4[k].y += v[j][k].y; s4[k].z += v[j][k].z; s4[k].w += v[j][k].w;
      }
  }
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    const int i = threadIdx.x + WARPS * 32 * k, m = m0 + i / CP, n = n0 + (i % CP) * 4;
    if (m < a.M && n < a.N) store4<SCALED>(a, m, n, s4[k]);
  }
}

}  // namespace rows

// ---------------------------------------------------------------- K7, rows
namespace w4 {

using rows::WARPS;
using rows::STAGES;
using rows::mma16816;
constexpr int SK = 16;      // packed rows a stage: 32 contracting rows
constexpr int W_BYTES = SK * BN;   // raw nibbles: 16 rows x 128 columns
constexpr int S_BYTES = 2 * BN * 4;  // the lo and hi halves' scale rows

template <int MT>  // MT 8-row tiles of x: up to 8 * MT rows a block
struct Ring {
  static constexpr int X_BYTES = MT * 8 * 2 * SK * 2;  // [8 MT][lo | hi][16] bf16
  static constexpr int STAGE = W_BYTES + S_BYTES + X_BYTES;
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int LDR = BN + 4;  // fp32 row stride of a warp's partial tile
  static constexpr int RED = MT * 8 * LDR * 4;
  static_assert(RED <= WARP, "a warp's partial tile overlays its ring");
  static constexpr int TOTAL = WARPS * WARP;
};

// Stage s (packed rows 16 s .. 16 s + 15) of a warp's run into `st`: the raw
// bytes (16 rows x 8 chunks of 16 columns; chunk c of row r lands at chunk
// c ^ (r & 6), so the lanes of a quarter warp read distinct banks), the two
// scale rows when the stage starts a group (or the warp's run), and x's
// rows m0 .. m0 + 8 MT - 1 at the stage's contracting rows of both halves
// (chunk c = half * 2 + k step of row m at c ^ ((m >> 1) & 3)). Columns past
// N and rows past M are zero-filled.
template <int MT>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& a, int m0, int n0,
                                           int s, bool scales, int lane) {
  const int Kp = a.K / 2;
#pragma unroll
  for (int j = 0; j < W_BYTES / 16 / 32; ++j) {
    const int i = lane + 32 * j, r = i / 8, c = i % 8;
    const bool in = n0 + 16 * c < a.N;
    gritlm::cp_async16(st + r * BN + 16 * (c ^ (r & 6)),
                       in ? a.w + (long long)(s * SK + r) * a.N + n0 + 16 * c : a.w,
                       in ? 16 : 0);
  }
  if (scales) {
    float* ss = reinterpret_cast<float*>(st + W_BYTES);
    const int glo = s * SK / a.g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane = 16-byte chunk of the row
      const int row = h ? Kp / a.g + glo : glo;
      const bool in = n0 + 4 * lane < a.N;
      gritlm::cp_async16(ss + h * BN + 4 * lane,
                         in ? a.scale + (long long)row * a.N + n0 + 4 * lane : a.scale,
                         in ? 16 : 0);
    }
  }
  bf16* sx = reinterpret_cast<bf16*>(st + W_BYTES + S_BYTES);
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int i = lane + 32 * j, m = i / 4, c = i % 4;
    const int col = (c / 2) * Kp + s * SK + (c % 2) * 8;
    const bool in = m0 + m < a.M;
    gritlm::cp_async16(sx + m * 32 + 8 * (c ^ ((m >> 1) & 3)),
                       in ? a.x + (long long)(m0 + m) * a.K + col : a.x, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// (nibble k of `nib` - 8) * s in fp32: the reference's weight before rounding
__device__ __forceinline__ float deq(uint32_t nib, int k, float s) {
  return __fmul_rn(__fadd_rn(magic_float(nib, k), -8388616.0f), s);  // 2^23 + 8
}

// Lane (g, t) of a warp: output columns n0 + 16 g .. 16 g + 15 and rows
// m0 + 8 mt + 2 t, + 1. acc[mt][j] is the C fragment of MMA j, whose A row
// g is column 16 g + 2 j and row g + 8 column 16 g + 2 j + 1.
template <int MT>
__global__ void __launch_bounds__(WARPS * 32, 3) w4_rows_kernel(Args a) {
  using Rg = Ring<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * 8 * MT, n0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * a.kper, ns = min(a.nk, s0 + a.kper) - s0;
  const int w0 = s0 + ns * warp / WARPS, nst = s0 + ns * (warp + 1) / WARPS - w0;
  unsigned char* ring = smem + warp * Rg::WARP;
  // a stage brings scale rows when it starts a group or the warp's run
  auto has_scales = [&](int s) { return s == w0 || (s * SK) % a.g == 0; };

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  float slo[16], shi[16];

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load_stage<MT>(ring + i * Rg::STAGE, a, m0, n0, w0 + i, has_scales(w0 + i), lane);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    const int nxt = i + STAGES - 1;  // its slot was last read in step i - 1
    if (nxt < nst)
      load_stage<MT>(ring + (nxt % STAGES) * Rg::STAGE, a, m0, n0, w0 + nxt,
                     has_scales(w0 + nxt), lane);
    cp_async_commit();  // possibly empty: keeps "all but the newest STAGES-1" = stage i
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the other lanes' copies are visible
    const unsigned char* st = ring + (i % STAGES) * Rg::STAGE;
    if (has_scales(w0 + i)) {
      const float* ss = reinterpret_cast<const float*>(st + W_BYTES);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 l4 = *reinterpret_cast<const float4*>(ss + 16 * g + 4 * v);
        const float4 h4 = *reinterpret_cast<const float4*>(ss + BN + 16 * g + 4 * v);
        slo[4 * v] = l4.x; slo[4 * v + 1] = l4.y; slo[4 * v + 2] = l4.z; slo[4 * v + 3] = l4.w;
        shi[4 * v] = h4.x; shi[4 * v + 1] = h4.y; shi[4 * v + 2] = h4.z; shi[4 * v + 3] = h4.w;
      }
    }
    const uint32_t* sx = reinterpret_cast<const uint32_t*>(st + W_BYTES + S_BYTES);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r0 = ks * 8 + 2 * t;  // packed rows r0, r0 + 1: (r & 6) == 2 t for both
      const uint4 q0 = *reinterpret_cast<const uint4*>(st + r0 * BN + 16 * (g ^ (2 * t)));
      const uint4 q1 = *reinterpret_cast<const uint4*>(st + (r0 + 1) * BN + 16 * (g ^ (2 * t)));
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g, sw = (m >> 1) & 3;
        b[mt][0] = sx[m * 16 + 4 * (ks ^ sw) + t];        // x[m, k0 + 8 ks + 2 t], + 1
        b[mt][1] = sx[m * 16 + 4 * ((2 + ks) ^ sw) + t];  // x[m, K/2 + k0 + 8 ks + 2 t], + 1
      }
      const uint32_t w0s[4] = {q0.x, q0.y, q0.z, q0.w}, w1s[4] = {q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: columns 16 g + 4 q .. + 3
        const uint32_t lo0 = w0s[q] & 0x0F0F0F0Fu, hi0 = (w0s[q] >> 4) & 0x0F0F0F0Fu;
        const uint32_t lo1 = w1s[q] & 0x0F0F0F0Fu, hi1 = (w1s[q] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ca = 4 * q + 2 * h, cb = ca + 1;  // A rows g and g + 8
          const uint32_t a0 = pack_bf16x2(deq(lo0, 2 * h, slo[ca]), deq(lo1, 2 * h, slo[ca]));
          const uint32_t a1 = pack_bf16x2(deq(lo0, 2 * h + 1, slo[cb]), deq(lo1, 2 * h + 1, slo[cb]));
          const uint32_t a2 = pack_bf16x2(deq(hi0, 2 * h, shi[ca]), deq(hi1, 2 * h, shi[ca]));
          const uint32_t a3 = pack_bf16x2(deq(hi0, 2 * h + 1, shi[cb]), deq(hi1, 2 * h + 1, shi[cb]));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][2 * q + h], a0, a1, a2, a3, b[mt][0], b[mt][1]);
        }
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
  }
  cp_async_wait<0>();
  __syncwarp();

  rows::epilogue<MT, Rg::WARP, Rg::LDR, false>(acc, a, smem, m0, n0);
}

template <int MT>
int launch(const Args& a, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(w4_rows_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<MT>::TOTAL);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.M + 8 * MT - 1) / (8 * MT), (a.N + BN - 1) / BN, splits);
  w4_rows_kernel<MT><<<grid, WARPS * 32, Ring<MT>::TOTAL, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace w4

// ---------------------------------------------------------------- K6, rows
namespace w8 {

using rows::WARPS;
using rows::STAGES;
using rows::mma16816;
constexpr int SK = 32;             // contracting rows a stage: two k-steps of 16
constexpr int W_BYTES = SK * BN;   // raw int8: 32 rows x 128 columns

template <int MT>  // MT 8-row tiles of x: up to 8 * MT rows a block
struct Ring {
  static constexpr int X_BYTES = MT * 8 * SK * 2;  // [8 MT][32] bf16
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int LDR = BN + 4;  // fp32 row stride of a warp's partial tile
  static constexpr int RED = MT * 8 * LDR * 4;
  static_assert(RED <= WARP, "a warp's partial tile overlays its ring");
  static constexpr int TOTAL = WARPS * WARP;
};

// Stage s (contracting rows 32 s .. 32 s + 31) of a warp's run into `st`:
// the raw bytes (32 rows x 8 chunks of 16 columns; chunk c of row r lands at
// chunk c ^ (r & 6), so the 8 lanes of a quarter warp, which read rows
// 2t + {0, 1, 8, 9} at chunk g, hit distinct banks), and x's rows m0 ..
// m0 + 8 MT - 1 at the stage's contracting rows (chunk c = 8 of them, of row
// m at c ^ ((m >> 1) & 3)). Rows past M or K and columns past N are
// zero-filled (a zero x column cancels whatever weight it meets).
template <int MT>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& a, int m0, int n0,
                                           int s, int lane) {
#pragma unroll
  for (int j = 0; j < W_BYTES / 16 / 32; ++j) {
    const int i = lane + 32 * j, r = i / 8, c = i % 8;
    const int kr = s * SK + r;
    const bool in = kr < a.K && n0 + 16 * c < a.N;
    gritlm::cp_async16(st + r * BN + 16 * (c ^ (r & 6)),
                       in ? a.w + (long long)kr * a.N + n0 + 16 * c : a.w, in ? 16 : 0);
  }
  bf16* sx = reinterpret_cast<bf16*>(st + W_BYTES);
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int i = lane + 32 * j, m = i / 4, c = i % 4;
    const int col = s * SK + 8 * c;
    const bool in = m0 + m < a.M && col < a.K;
    gritlm::cp_async16(sx + m * SK + 8 * (c ^ ((m >> 1) & 3)),
                       in ? a.x + (long long)(m0 + m) * a.K + col : a.x, in ? 16 : 0);
  }
}

// Byte k of four signed weights (w ^ 0x80808080 given) as an exact float q.
__device__ __forceinline__ float i8(uint32_t wx, int k) {
  return magic_float(wx, k) - 8388736.0f;  // 2^23 + 128
}

// Lane (g, t) of a warp: output columns n0 + 16 g .. 16 g + 15 and rows
// m0 + 8 mt + 2 t, + 1 (rows::epilogue's fragment map). In a 16-row k-step
// the lane reads rows 2t, 2t+1, 2t+8, 2t+9, the k slots of its A fragments.
template <int MT>
__global__ void __launch_bounds__(WARPS * 32, 3) w8_rows_kernel(Args a) {
  using Rg = Ring<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * 8 * MT, n0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * a.kper, ns = min(a.nk, s0 + a.kper) - s0;
  const int w0 = s0 + ns * warp / WARPS, nst = s0 + ns * (warp + 1) / WARPS - w0;
  unsigned char* ring = smem + warp * Rg::WARP;

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) w8::load_stage<MT>(ring + i * Rg::STAGE, a, m0, n0, w0 + i, lane);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    const int nxt = i + STAGES - 1;  // its slot was last read in step i - 1
    if (nxt < nst)  // qualified: the staged template's load_stage has the same parameters
      w8::load_stage<MT>(ring + (nxt % STAGES) * Rg::STAGE, a, m0, n0, w0 + nxt, lane);
    cp_async_commit();  // possibly empty: keeps "all but the newest STAGES-1" = stage i
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the other lanes' copies are visible
    const unsigned char* st = ring + (i % STAGES) * Rg::STAGE;
    const uint32_t* sx = reinterpret_cast<const uint32_t*>(st + W_BYTES);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // rows 16 ks + 2t, + 1, + 8, + 9: (r & 6) == 2 t for all four
      const unsigned char* wr = st + (16 * ks + 2 * t) * BN + 16 * (g ^ (2 * t));
      const uint4 q0 = *reinterpret_cast<const uint4*>(wr);
      const uint4 q1 = *reinterpret_cast<const uint4*>(wr + BN);
      const uint4 q2 = *reinterpret_cast<const uint4*>(wr + 8 * BN);
      const uint4 q3 = *reinterpret_cast<const uint4*>(wr + 9 * BN);
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g, sw = (m >> 1) & 3;
        b[mt][0] = sx[m * 16 + 4 * ((2 * ks) ^ sw) + t];      // x[m, k0 + 16 ks + 2 t], + 1
        b[mt][1] = sx[m * 16 + 4 * ((2 * ks + 1) ^ sw) + t];  // x[m, k0 + 16 ks + 2 t + 8], + 9
      }
      const uint32_t r0[4] = {q0.x, q0.y, q0.z, q0.w}, r1[4] = {q1.x, q1.y, q1.z, q1.w};
      const uint32_t r2[4] = {q2.x, q2.y, q2.z, q2.w}, r3[4] = {q3.x, q3.y, q3.z, q3.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: columns 16 g + 4 q .. + 3
        const uint32_t x0 = r0[q] ^ 0x80808080u, x1 = r1[q] ^ 0x80808080u;
        const uint32_t x2 = r2[q] ^ 0x80808080u, x3 = r3[q] ^ 0x80808080u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // MMA 2 q + h: A rows g, g + 8 = bytes 2 h, 2 h + 1
          const uint32_t a0 = pack_upper(i8(x0, 2 * h), i8(x1, 2 * h));
          const uint32_t a1 = pack_upper(i8(x0, 2 * h + 1), i8(x1, 2 * h + 1));
          const uint32_t a2 = pack_upper(i8(x2, 2 * h), i8(x3, 2 * h));
          const uint32_t a3 = pack_upper(i8(x2, 2 * h + 1), i8(x3, 2 * h + 1));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][2 * q + h], a0, a1, a2, a3, b[mt][0], b[mt][1]);
        }
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
  }
  cp_async_wait<0>();
  __syncwarp();

  rows::epilogue<MT, Rg::WARP, Rg::LDR, true>(acc, a, smem, m0, n0);
}

template <int MT>
int launch(const Args& a, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(w8_rows_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<MT>::TOTAL);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.M + 8 * MT - 1) / (8 * MT), (a.N + BN - 1) / BN, splits);
  w8_rows_kernel<MT><<<grid, WARPS * 32, Ring<MT>::TOTAL, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace w8

}  // namespace

// K6: out [M, N] bf16 = (x [M, K] bf16 @ q8 [K, N] int8) * scale [1, N] fp32;
// bm 8 (M <= 8) or 16 rows a block of the rows kernel, kper in stages of 32
// contracting rows, or bm 64 for the staged template, kper in stages of 128.
extern "C" int gritlm_w8a16_matmul(const void* x, const void* q8, const void* scale, void* out,
                                   void* part, void* counters, int M, int K, int N, int bm,
                                   int splits, int kper, void* stream) {
  const int sk = bm == 64 ? DK : w8::SK;
  Args a{(const bf16*)x, (const uint8_t*)q8, (const float*)scale, (bf16*)out, (float*)part,
         (int*)counters, M, K, N, 0, (K + sk - 1) / sk, kper};
  cudaStream_t st = (cudaStream_t)stream;
  if (bm == 8) return w8::launch<1>(a, splits, st);
  if (bm == 16) return w8::launch<2>(a, splits, st);
  if (bm == 64) return launch<64>(a, splits, st);
  return (int)cudaErrorInvalidValue;
}

// K7: out [M, N] bf16 = x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi) for packed
// q4 [K/2, N] uint8 and group scales [K/g, N] fp32; bm 8 (M <= 8) or 16 rows a
// block, kper in stages of 16 packed rows.
extern "C" int gritlm_w4a16_matmul(const void* x, const void* q4, const void* scale, void* out,
                                   void* part, void* counters, int M, int K, int N, int g,
                                   int bm, int splits, int kper, void* stream) {
  Args a{(const bf16*)x, (const uint8_t*)q4, (const float*)scale, (bf16*)out, (float*)part,
         (int*)counters, M, K, N, g, (K / 2) / w4::SK, kper};
  if (bm == 8) return w4::launch<1>(a, splits, (cudaStream_t)stream);
  if (bm == 16) return w4::launch<2>(a, splits, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
