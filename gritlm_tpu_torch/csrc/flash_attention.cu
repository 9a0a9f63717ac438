// K1: the flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax
// and accumulation. It replaces the Pallas `_fwd_kernel` and
// `_fwd_kernel_single` of gritlm_tpu/ops/flash_attention.py; the plain
// version is in gritlm_tpu_torch/ops/flash_attention.py.
//
// What bounds it at the encode and training shapes: its operations, two
// products of 2 x Sq x Sk x Dh a head over the visited (query, key) pairs,
// and beside them one exponential a pair on the SM's special function
// units. So both products are wgmma, and neither the scores, the
// probabilities nor the output touch shared memory:
// - one block per (128 query rows, query head, batch row): two consumer
//   warpgroups of 64 rows each and a producer warp, whose warpgroup's
//   registers go to the consumers (setmaxnreg);
// - Q (the block's 128 rows) is loaded once by TMA and stays in shared
//   memory; K and V stream through a ring of STAGES tiles of BK keys,
//   loaded by TMA in the visit order and signalled by full and empty
//   mbarriers. Tiles above the causal diagonal, below the sliding window or
//   with no valid key are never loaded;
// - per tile a warpgroup issues S = Q K^T (wgmma, both operands in shared
//   memory, the accumulators in registers), runs the online softmax on the
//   accumulators (the row maximum and sum over the quad of threads that
//   share a row, exp2 with scale x log2(e) folded in), re-packs P as bf16
//   A fragments and issues O += P V (A from registers, V read transposed
//   from the ring tile). O stays in registers until the epilogue. The next
//   tile's S is issued before this tile's O += P V, so the softmax of one
//   tile runs while the tensor cores work on the other product;
// - interior tiles take a path with no per-element mask; diagonal,
//   window-edge and padded tiles apply the keep rule per element. A masked
//   score is -inf before the maximum and exp2 of it is 0, so a row with no
//   kept key so far keeps its maximum at -inf and its sum at 0: it never
//   turns into exp(0) = 1;
// - the epilogue writes O / l as bf16 and, with an `lse` pointer, each
//   row's log-sum-exp m + log(l) of the scaled scores (natural log, fp32
//   [B, H, Sq]), which K4 and K5 (flash_attention_bwd.cu) rebuild P from; a
//   row with l == 0 gets output 0 and lse NEG_INF.
// No sum crosses blocks: the same inputs give the same bits.
//
// Two instances, by the head dim DH: 128, and 64 (Llama-3.2-1B, Qwen2-0.5B),
// whose Q and ring tiles are one 64-column half instead of two, S = Q K^T 4
// k-steps instead of 8, and O += P V an m64n64k16 wgmma (32 accumulators a
// thread instead of 64), on the same schedule. The wrapper zero-pads any
// other head dim below 128 to 128 (ops/flash_attention.py) and passes the
// true Dh^-0.5 as `scale`.
#include <utility>

#include "common.cuh"
#include "sm90.cuh"

using gritlm::bf16;
using gritlm::NEG_INF;

namespace {

constexpr int WG = 128;                         // threads of a warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups a block
constexpr int NTHREADS = WG * (CONSUMERS + 1);  // and the producer's warpgroup
constexpr int ROWS = 64;                        // query rows of a consumer
constexpr int BLOCK_ROWS = ROWS * CONSUMERS;    // query rows of a block
constexpr int BK = 128;                         // keys of a ring tile
constexpr int STAGES = 3;                       // ring depth
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WG * PRODUCER_REGS + WG * CONSUMERS * CONSUMER_REGS <= 65536, "register split");
constexpr int MASK_WORDS = BK / 32;  // valid-key bits of a tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INFINITY = -__builtin_huge_valf();

// Shared memory, from a 1024-byte aligned base: Q (the 64-column halves of
// the block's rows: two at DH 128, one at 64), the ring (a stage: K's
// halves, then V's), each stage's tile metadata (first key, valid-key bits)
// and the barriers.
constexpr uint32_t HALF_Q = BLOCK_ROWS * 128;
constexpr uint32_t HALF_T = BK * 128;

template <int DH>
struct Layout {
  static_assert(DH == 64 || DH == 128, "head dims 64 and 128");
  static constexpr int HALVES = DH / 64;
  static constexpr uint32_t Q_BYTES = HALVES * HALF_Q;
  static constexpr uint32_t STAGE_BYTES = 2 * HALVES * HALF_T;
  static constexpr uint32_t OFF_RING = Q_BYTES;
  static constexpr uint32_t OFF_META = OFF_RING + STAGES * STAGE_BYTES;  // 8 ints a stage
  static constexpr uint32_t OFF_BAR = OFF_META + STAGES * 32;
  static constexpr uint32_t SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// tile x (0: K, 1: V) of stage s
template <int DH>
__device__ __forceinline__ uint32_t ring_tile(uint32_t base, int s, int x) {
  using C = Layout<DH>;
  return base + C::OFF_RING + s * C::STAGE_BYTES + x * C::HALVES * HALF_T;
}

__device__ __forceinline__ uint64_t kmajor(uint32_t rows) {
  return sm90::desc_sw128(rows, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile) {
  return sm90::desc_sw128(tile, HALF_T, 1024);
}

// S[64 x BK] = Q[64 x DH] K^T: DH / 16 k-steps of 16 features, each 32
// bytes further along the row, the second 4 (DH 128) in the tiles' other
// halves.
template <int... KK>
__device__ __forceinline__ void score_steps(float (&s)[BK / 2], uint64_t dq, uint64_t dk,
                                            std::integer_sequence<int, KK...>) {
  (sm90::wgmma_m64n128k16_ss<(KK / 4) * HALF_Q + (KK % 4) * 32,
                             (KK / 4) * HALF_T + (KK % 4) * 32>(s, dq, dk, KK > 0),
   ...);
}

// O[64 x DH] += P[64 x BK] V[BK x DH]: k-steps of 16 keys, P as packed A
// fragments (four a k-step), V MN-major.
template <int... KK>
__device__ __forceinline__ void pv_steps(float (&o)[64], const uint32_t (&p)[BK / 4], uint64_t dv,
                                         std::integer_sequence<int, KK...>) {
  (sm90::wgmma_m64n128k16_rs_tb<KK * 16 * 128>(o, p[4 * KK], p[4 * KK + 1], p[4 * KK + 2],
                                                p[4 * KK + 3], dv, 1),
   ...);
}
template <int... KK>
__device__ __forceinline__ void pv_steps(float (&o)[32], const uint32_t (&p)[BK / 4], uint64_t dv,
                                         std::integer_sequence<int, KK...>) {
  (sm90::wgmma_m64n64k16_rs_tb<KK * 16 * 128>(o, p[4 * KK], p[4 * KK + 1], p[4 * KK + 2],
                                               p[4 * KK + 3], dv, 1),
   ...);
}

template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N], const uint32_t (&p)[BK / 4],
                                         uint32_t v_tile) {
  pv_steps(o, p, mnmajor(v_tile), std::make_integer_sequence<int, BK / 16>());
  sm90::wgmma_commit();
}

// The keep rule of (key position, query row) besides the key mask; rows
// past Sq are never written, so they need none.
struct Keep {
  int causal, window, offset;
  __device__ __forceinline__ bool operator()(int key, int q) const {
    const int qpos = offset + q;
    return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
  }
};

// The online softmax over one tile: the thread's scores s of rows row0 and
// row0 + 8 (accumulator i is row (i % 4) / 2, column 8 (i / 4) + c2 + i % 2)
// become P; m (raw score units) and l (this thread's part of the row sums)
// move on, alpha is the factor the rows' O must take.
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int row0,
                                             int kt, const unsigned (&bits)[MASK_WORDS], int c2,
                                             const Keep& keep) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int ri = (i % 4) / 2;
    if (EDGE) {
      const int col = 8 * (i / 4) + c2 + i % 2;
      const bool kv = (bits[i / 16] >> (8 * ((i / 4) % 4) + c2 + i % 2)) & 1u;
      if (!(kv && keep(kt + col, row0 + 8 * ri))) s[i] = NEG_INFINITY;
    }
    mx[ri] = fmaxf(mx[ri], s[i]);
  }
  float msc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(gritlm::FULL, mx[ri], 1));
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(gritlm::FULL, mx[ri], 2));
    // no kept key yet: every exponent below is -inf, and 0 keeps them so
    msc[ri] = mx[ri] == NEG_INFINITY ? 0.f : mx[ri] * scale_log2;
    alpha[ri] = sm90::ex2(fmaf(m[ri], scale_log2, -msc[ri]));
    m[ri] = mx[ri];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int ri = (i % 4) / 2;
    s[i] = sm90::ex2(fmaf(s[i], scale_log2, -msc[ri]));
    rs[ri] += s[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// One block per (128 query rows, query head, batch row), the q-tiles in
// reverse order (a causal block with more keys starts first).
template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const int* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                 int group, long long m_sb, int causal, int window, int offset, float scale) {
  using C = Layout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* meta = reinterpret_cast<int*>(smem_raw + (base - raw) + C::OFF_META);
  const uint32_t full = base + C::OFF_BAR, empty = full + 8 * STAGES, res = empty + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_ROWS;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, WG * CONSUMERS);  // every consumer thread arrives
    }
    sm90::mbar_init(res, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // keys the block can see: causal tiles above the diagonal and tiles below
  // the sliding window are never visited
  const int q_last = offset + min(q0 + BLOCK_ROWS, Sq) - 1;
  int kend = Sk, kbeg = 0;
  if (causal) kend = min(Sk, q_last + 1);
  if (window > 0) kbeg = max(0, offset + q0 - window + 1) / BK * BK;

  if (tid >= CONSUMERS * WG) {
    // ------------------------------------------------------------ producer
    sm90::regs_dec<PRODUCER_REGS>();
    if (tid < CONSUMERS * WG + 32) {  // one warp drives the ring
      const int lane = tid % 32;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(res, C::Q_BYTES);
        for (int c = 0; c < C::HALVES; ++c)
          sm90::tma_load_4d(base + c * HALF_Q, &tq, res, 64 * c, h, q0, b);
      }
      const int* mb = mask + b * m_sb;
      int stage = 0;
      uint32_t phase = 0;
      // the key mask of the next tile is read while this one waits for a stage
      int mk[MASK_WORDS];
#pragma unroll
      for (int j = 0; j < MASK_WORDS; ++j) {
        const int kp = kbeg + 32 * j + lane;
        mk[j] = kp < kend ? mb[kp] : 0;
      }
      for (int kt = kbeg; kt < kend; kt += BK) {
        unsigned bits[MASK_WORDS], any = 0;
#pragma unroll
        for (int j = 0; j < MASK_WORDS; ++j) {
          bits[j] = __ballot_sync(gritlm::FULL, mk[j] != 0);  // keys past kend read as 0
          any |= bits[j];
          const int kp = kt + BK + 32 * j + lane;
          mk[j] = kp < kend ? mb[kp] : 0;
        }
        if (any == 0) continue;  // the tile holds no valid key
        sm90::mbar_wait(empty + 8 * stage, phase ^ 1);
        if (lane == 0) {
          int* mt = meta + 8 * stage;
          mt[0] = kt;
#pragma unroll
          for (int j = 0; j < MASK_WORDS; ++j) mt[1 + j] = (int)bits[j];
          const uint32_t fb = full + 8 * stage;
          sm90::mbar_arrive_expect_tx(fb, C::STAGE_BYTES);
          for (int c = 0; c < C::HALVES; ++c) {
            sm90::tma_load_4d(ring_tile<DH>(base, stage, 0) + c * HALF_T, &tk, fb, 64 * c, hk, kt,
                              b);
            sm90::tma_load_4d(ring_tile<DH>(base, stage, 1) + c * HALF_T, &tv, fb, 64 * c, hk, kt,
                              b);
          }
        }
        __syncwarp();
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::mbar_wait(empty + 8 * stage, phase ^ 1);
      if (lane == 0) {
        meta[8 * stage] = -1;  // end of the sequence
        sm90::mbar_arrive(full + 8 * stage);
      }
    }
  } else {
    // -------------------------------------------------------------- consumers
    sm90::regs_inc<CONSUMER_REGS>();
    // the warpgroup index broadcast from lane 0: the compiler then treats it as
    // uniform and keeps the descriptor arithmetic in uniform registers
    const int w = __shfl_sync(gritlm::FULL, tid / WG, 0);
    const int warp = (tid % WG) / 32, lane = tid % 32, c2 = 2 * (lane % 4);
    const int qw0 = q0 + w * ROWS;
    const int row0 = qw0 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
    const Keep keep{causal, window, offset};
    const float scale_log2 = scale * LOG2E;
    const uint64_t dq = kmajor(base + w * ROWS * 128);

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INFINITY, NEG_INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[BK / 4];  // P of stage `prev`, whose O += P V is not yet issued
    int prev = 0;  // set with p
    bool pending = false;  // an O += P V is owed for stage prev
    int stage = 0;
    uint32_t phase = 0;
    const auto advance = [&]() {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    const auto skipped = [&](int kt) {
      return qw0 >= Sq || (causal && kt > offset + qw0 + ROWS - 1) ||
             (window > 0 && kt + BK - 1 <= offset + qw0 - window);
    };
    // S of the tile in `stage`, issued; then (after the caller's wait) the
    // softmax in place, picking the masked or the mask-free path
    const auto issue_s = [&](float (&s)[BK / 2]) {
      sm90::wgmma_fence();
      score_steps(s, dq, kmajor(ring_tile<DH>(base, stage, 0)),
                  std::make_integer_sequence<int, DH / 16>());
      sm90::wgmma_commit();
    };
    const auto softmax = [&](float (&s)[BK / 2], const int* mt) {
      const int kt = mt[0];
      unsigned bits[MASK_WORDS];
      bool all = true;
#pragma unroll
      for (int j = 0; j < MASK_WORDS; ++j) {
        bits[j] = (unsigned)mt[1 + j];
        all = all && bits[j] == gritlm::FULL;
      }
      const bool edge = !all || (causal && kt + BK - 1 > offset + qw0) ||
                        (window > 0 && kt <= offset + qw0 + ROWS - 1 - window);
      if (edge)
        softmax_tile<true>(s, m, l, alpha, scale_log2, row0, kt, bits, c2, keep);
      else
        softmax_tile<false>(s, m, l, alpha, scale_log2, row0, kt, bits, c2, keep);
    };
    // O = alpha O, then O += P V for stage `prev`, issued
    const auto issue_pv_prev = [&]() {
      // once the row maxima settle, most tiles move none of a warp's rows
      if (__any_sync(gritlm::FULL, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i % 4) / 2];
      sm90::wgmma_fence();
      issue_pv(o, p, ring_tile<DH>(base, prev, 1));
    };
    const auto release_prev = [&]() {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      sm90::mbar_arrive(empty + 8 * prev);
    };

    sm90::mbar_wait(res, 0);
    bool done = false;
    while (!done) {
      // no product pending: skip tiles until one this warpgroup sees
      const int* mt;
      for (;;) {
        sm90::mbar_wait(full + 8 * stage, phase);
        mt = meta + 8 * stage;
        if (mt[0] < 0) {
          done = true;
          break;
        }
        if (!skipped(mt[0])) break;
        sm90::mbar_arrive(empty + 8 * stage);
        advance();
      }
      if (done) break;
      {
        float s[BK / 2];
        issue_s(s);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        softmax(s, mt);
#pragma unroll
        for (int i = 0; i < BK / 4; ++i) p[i] = sm90::pack_bf16(s[2 * i], s[2 * i + 1]);
        prev = stage;
        pending = true;
        advance();
      }
      // the steady state: this tile's S and the last tile's O += P V in
      // flight together, the softmax between their waits
      for (;;) {
        sm90::mbar_wait(full + 8 * stage, phase);
        mt = meta + 8 * stage;
        if (mt[0] < 0) {
          done = true;
          break;
        }
        if (skipped(mt[0])) {
          issue_pv_prev();
          release_prev();
          pending = false;
          sm90::mbar_arrive(empty + 8 * stage);
          advance();
          break;
        }
        float s[BK / 2];
        issue_s(s);
        issue_pv_prev();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        softmax(s, mt);
        release_prev();
#pragma unroll
        for (int i = 0; i < BK / 4; ++i) p[i] = sm90::pack_bf16(s[2 * i], s[2 * i + 1]);
        prev = stage;
        advance();
      }
    }
    // the O += P V still owed
    if (pending) {
      issue_pv_prev();
      release_prev();
    }
    // out = O / l; a row whose every key was masked has l == 0 and output 0
    float inv[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      l[ri] += __shfl_xor_sync(gritlm::FULL, l[ri], 1);
      l[ri] += __shfl_xor_sync(gritlm::FULL, l[ri], 2);
      inv[ri] = l[ri] > 0.f ? 1.f / l[ri] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DH / 2; i += 2) {
      const int ri = (i % 4) / 2, r = row0 + 8 * ri;
      if (r < Sq) {
        bf16* dst = out + (((long long)b * Sq + r) * H + h) * DH + 8 * (i / 4) + c2;
        *reinterpret_cast<uint32_t*>(dst) = sm90::pack_bf16(o[i] * inv[ri], o[i + 1] * inv[ri]);
      }
    }
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int r = row0 + 8 * ri;
        if (r < Sq)
          lse[((long long)b * H + h) * Sq + r] = l[ri] > 0.f ? m[ri] * scale + logf(l[ri]) : NEG_INF;
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
           int B, int Sq, int Sk, int H, int Hkv, long long q_sb, long long q_ss,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long m_sb,
           int causal, int window, int offset, float scale, cudaStream_t stream) {
  constexpr int smem = (int)Layout<DH>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = sm90::make_map_bshd(&tq, q, B, Sq, H, 2 * q_sb, 2 * q_ss, BLOCK_ROWS, DH);
  if (!rc) rc = sm90::make_map_bshd(&tk, k, B, Sk, Hkv, 2 * k_sb, 2 * k_ss, BK, DH);
  if (!rc) rc = sm90::make_map_bshd(&tv, v, B, Sk, Hkv, 2 * v_sb, 2 * v_ss, BK, DH);
  if (rc) return rc;
  dim3 grid((Sq + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  flash_fwd_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, (const int*)mask, (bf16*)out, (float*)lse, Sq, Sk, H, H / Hkv, m_sb, causal,
      window, offset, scale);
  return (int)cudaGetLastError();
}


// K1 on fp32 q, k and v: the same function with fp32 products summed in fp32,
// what the Pallas kernel computes on fp32 inputs. One TF32 tensor-core pass
// would round every operand to a 10-bit mantissa, and the bf16 kernel's tiles
// at 4 bytes (128 query rows, a 3-stage ring of 128-key tiles) would need
// about 448 KB of shared memory, so the fp32 form is a kernel of its own, on
// the SIMT pipes. What bounds it: the FMAs, 2 x 2 x Sq x Sk x Dh a head over
// the visited pairs at 128 fp32 lanes an SM. The design:
// - one block of 128 threads per (64 query rows, query head, batch row); Q
//   stays in shared memory, K and V stream through two buffers of 32-key
//   tiles by cp.async, the next tile's copy in flight during this tile;
// - a warp owns 16 query rows and a thread 4 of them (rows 4 ty .. + 3 of
//   its warp's): 4 keys of a tile in S = Q K^T (keys tx + 8 j) and Dh / 8
//   columns in O += P V (32 c + 4 tx .. + 3), so a row's maximum, sum and
//   rescale stay within the 8 threads of its row group; each score is one
//   FMA chain in depth order;
// - P passes from the S layout to the O layout through a warp-private P^T
//   tile in shared memory (key rows of PT_LD floats, so a quarter warp's
//   16-byte stores hit distinct banks);
// - the online softmax runs in base 2 with scale x log2(e) folded in; a
//   masked score is NEG_INF and its probability is selected as 0, never
//   computed; the epilogue writes O / l and, with `lse`, (m + log2 l) ln 2.
// Tiles above the causal bound and below the window are never visited. No
// sum crosses threads in a data-dependent order: reruns are bit-equal.
namespace f32 {

constexpr int BQ = 64;      // query rows of a block
constexpr int BK = 32;      // keys of a tile
constexpr int THREADS = 128;
constexpr int PT_LD = 20;   // floats a key row of a warp's P^T tile (16 rows + 4)
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory of a block, in floats: Q [BQ][LD], K and V two
// buffers each of [BK][LD], then a P^T tile [BK][PT_LD] a warp.
template <int DH>
struct Smem {
  static constexpr int LD = DH + 4;  // floats a row: a quarter warp's rows in distinct banks
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LD;
  static constexpr int V = K + 2 * BK * LD;
  static constexpr int P = V + 2 * BK * LD;
  static constexpr int FLOATS = P + THREADS / 32 * BK * PT_LD;
  static constexpr uint32_t BYTES = FLOATS * sizeof(float);
  static_assert(BQ * DH / 4 % THREADS == 0 && BK * DH / 4 % THREADS == 0, "whole copy rounds");
};

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Rows [r0, r0 + N) of one head (row r at x + r * ss) into dst, LD floats a
// row; rows at or past n are zero-filled.
template <int DH, int N>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ x, long long ss,
                                      int r0, int n, int tid) {
  constexpr int CH = DH / 4;  // 16-byte copies a row
#pragma unroll
  for (int i = 0; i < N * CH / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / CH, kk = c % CH * 4;
    const bool in = r0 + r < n;
    gritlm::cp_async16(dst + r * Smem<DH>::LD + kk, in ? x + (r0 + r) * ss + kk : x,
                       in ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                     int group, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                     long long v_sb, long long v_ss, long long m_sb, int causal, int window,
                     int offset, float scale) {
  using L = Smem<DH>;
  constexpr int NC = DH / 32;  // 4-column groups of a thread's output rows
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ty = lane / 8, tx = lane % 8;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int rw = 16 * warp + 4 * ty;  // the thread's first row in the block
  const float* kh = k + b * k_sb + (long long)(h / group) * DH;
  const float* vh = v + b * v_sb + (long long)(h / group) * DH;
  const int* mrow = mask + b * m_sb;
  // the keys some row of the block can see: the causal bound, the window
  const int hi = causal ? min(Sk, offset + min(Sq, q0 + BQ)) : Sk;
  const int lo = window > 0 ? max(0, offset + q0 - window + 1) : 0;
  const int t0 = lo / BK, t1 = hi > lo ? (hi + BK - 1) / BK : t0;

  float o[4][4 * NC], m[4], l[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = offset + q0 + rw + i;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;
  }
  stage<DH, BQ>(sm + L::Q, q + b * q_sb + (long long)h * DH, q_ss, q0, Sq, tid);
  if (t0 < t1) {
    stage<DH, BK>(sm + L::K, kh, k_ss, t0 * BK, Sk, tid);
    stage<DH, BK>(sm + L::V, vh, v_ss, t0 * BK, Sk, tid);
  }
  commit();
  const float sl2 = scale * LOG2E;
  const float* qs = sm + L::Q + rw * L::LD;
  float* pt = sm + L::P + warp * BK * PT_LD;
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {  // the next tile into the other buffer
      stage<DH, BK>(sm + L::K + (buf ^ 1) * BK * L::LD, kh, k_ss, (t + 1) * BK, Sk, tid);
      stage<DH, BK>(sm + L::V + (buf ^ 1) * BK * L::LD, vh, v_ss, (t + 1) * BK, Sk, tid);
    }
    commit();  // an empty group on the last tile keeps the count
    wait_prev();
    __syncthreads();
    const float* ks = sm + L::K + buf * BK * L::LD;
    const float* vs = sm + L::V + buf * BK * L::LD;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * L::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + i * L::LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    bool kin[4];  // the key exists and its mask bit is set
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = t * BK + tx + 8 * j;
      kin[j] = key < Sk && __ldg(mrow + min(key, Sk - 1)) != 0;
    }
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool keep[4];
      float x[4], mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * BK + tx + 8 * j;
        keep[j] = kin[j] && (!causal || key <= qpos[i]) && (window <= 0 || key > qpos[i] - window);
        x[j] = keep[j] ? s[i][j] * sl2 : NEG_INF;
        mx = fmaxf(mx, x[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(gritlm::FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(gritlm::FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(gritlm::FULL, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = sm90::ex2(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = keep[j] ? sm90::ex2(x[j] - m_new) : 0.f;
      l[i] = l[i] * alpha + ((p[i][0] + p[i][1]) + (p[i][2] + p[i][3]));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 8 * j) * PT_LD + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + kk * PT_LD + 4 * ty);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + kk * L::LD + 32 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * c] = fmaf(pr[i], vv.x, o[i][4 * c]);
          o[i][4 * c + 1] = fmaf(pr[i], vv.y, o[i][4 * c + 1]);
          o[i][4 * c + 2] = fmaf(pr[i], vv.z, o[i][4 * c + 2]);
          o[i][4 * c + 3] = fmaf(pr[i], vv.w, o[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // K, V and P^T read before the next copies and stores
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(gritlm::FULL, l[i], 1);
    l[i] += __shfl_xor_sync(gritlm::FULL, l[i], 2);
    l[i] += __shfl_xor_sync(gritlm::FULL, l[i], 4);
    const int row = q0 + rw + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* dst = out + (((long long)b * Sq + row) * H + h) * DH + 4 * tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(dst + 32 * c) =
          make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv,
                      o[i][4 * c + 3] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + row] = l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : NEG_INF;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* lse, int B, int Sq, int Sk, int H, int Hkv, long long q_sb, long long q_ss,
               long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long m_sb,
               int causal, int window, int offset, float scale, cudaStream_t stream) {
  constexpr int smem = (int)Smem<DH>::BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (Sq == 0 || Sk == 0 || B == 0) return 0;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)mask, (float*)out,
      (float*)lse, Sq, Sk, H, H / Hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, m_sb, causal, window,
      offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Strides are in elements, as the tensors give them; the tensor maps take
// them in bytes (the wrapper checks that they are multiples of 8). Dh: 128
// or 64 (another returns cudaErrorInvalidValue); `scale` is the softmax
// scale, Dh^-0.5 of the model's head dim.
extern "C" int gritlm_flash_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int B, int Sq,
                                int Sk, int H, int Hkv, int Dh, long long q_sb, long long q_ss,
                                long long k_sb, long long k_ss, long long v_sb,
                                long long v_ss, long long m_sb, int causal, int window,
                                int offset, float scale, void* stream) {
  if (Dh == 128)
    return launch<128>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, q_sb, q_ss, k_sb, k_ss, v_sb,
                       v_ss, m_sb, causal, window, offset, scale, (cudaStream_t)stream);
  if (Dh == 64)
    return launch<64>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, q_sb, q_ss, k_sb, k_ss, v_sb,
                      v_ss, m_sb, causal, window, offset, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block of K1 takes at Dh 128, in bytes (for
// reports).
extern "C" int gritlm_flash_fwd_smem() { return (int)Layout<128>::SMEM; }

// K1 on fp32 q, k, v (out fp32): the same arguments as gritlm_flash_fwd;
// strides in elements, multiples of 4 (16-byte rows). Dh: 128 or 64.
extern "C" int gritlm_flash_fwd_f32(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse, int B, int Sq,
                                    int Sk, int H, int Hkv, int Dh, long long q_sb,
                                    long long q_ss, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss, long long m_sb, int causal,
                                    int window, int offset, float scale, void* stream) {
  if (Dh == 128)
    return f32::launch_f32<128>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, q_sb, q_ss, k_sb,
                                k_ss, v_sb, v_ss, m_sb, causal, window, offset, scale,
                                (cudaStream_t)stream);
  if (Dh == 64)
    return f32::launch_f32<64>(q, k, v, mask, out, lse, B, Sq, Sk, H, Hkv, q_sb, q_ss, k_sb,
                               k_ss, v_sb, v_ss, m_sb, causal, window, offset, scale,
                               (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block of the fp32 form takes at Dh 128, in
// bytes (for reports).
extern "C" int gritlm_flash_fwd_f32_smem() { return (int)f32::Smem<128>::BYTES; }
