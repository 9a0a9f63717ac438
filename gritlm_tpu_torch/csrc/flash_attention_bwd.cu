// K4 and K5: the flash attention backward for Hopper (sm_90a), bf16 in, fp32
// accumulation. They replace the Pallas `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` of gritlm_tpu/ops/flash_attention.py; the plain versions
// are in gritlm_tpu_torch/ops/flash_attention.py.
//
// Both kernels rebuild the probabilities from the forward's log-sum-exp,
//   P = exp(S * scale - lse)   under the forward's keep mask, else 0
//   dP = dO V^T,  dS = P * (dP - delta) * scale,  delta = rowsum(dO * O)
// What bounds them at training shapes: their operations (K4 three and K5
// four products over every visited (query, key) pair), so every product is
// a wgmma and nothing of P, dS or the gradients touches shared memory.
//
// The design (building blocks in sm90.cuh):
// - a block keeps its own 128 rows in shared memory for its whole life
//   (K4: Q and dO of 128 query rows; K5: K and V of 128 keys) and streams
//   the other side through a ring of STAGES shared-memory stages, 64 rows a
//   tile, loaded by TMA and signalled by mbarriers, in the visit order of K1
//   (flash_attention.cu);
// - two consumer warpgroups each own 64 of the block's rows. Per ring tile
//   a warpgroup issues S (or S^T) and dP (or dP^T) as wgmma with both
//   operands in shared memory, forms P and dS in registers from the
//   accumulators, re-packs them as bf16 A fragments (the accumulator layout
//   is the A layout) and issues dQ += dS K (K4) or dV += P^T dO and
//   dK += dS^T Q (K5) as wgmma with A from registers and B read transposed
//   from the ring tile. The dQ (K4) or dK and dV (K5) accumulators stay in
//   registers until the epilogue writes them as bf16;
// - K4 adds a producer warpgroup whose one warp drives the ring and whose
//   registers go to the consumers (setmaxnreg); K5, whose consumers hold
//   128 accumulators a thread, has no producer (see its kernel);
// - K5 streams the GQA group's query heads x their visible q-tiles as one
//   sequence, so the group's sum stays inside the block: no atomics, and
//   the same inputs give the same bits.
//
// Masking follows K1 exactly, so P agrees with the forward: padding, causal
// with `offset`, the sliding window (causal only). Tiles above the causal
// diagonal, below the window or with no valid key are never loaded (K4) or
// skipped by the warpgroup they miss; interior tiles take a path with no
// per-element mask. A row whose keys are all masked has lse == NEG_INF and
// gets zero gradients: every P and dS is selected, never multiplied, to 0.
//
// Two instances of each kernel, by the head dim DH: 128, and 64 (Llama-3.2-1B,
// Qwen2-0.5B), on the same schedule. At 64 every resident and ring tile is
// one 64-column half instead of two, S (S^T) and dP (dP^T) take 4 k-steps
// instead of 8, and the gradient updates are m64n64k16 register-A wgmmas
// (32 accumulators a thread for each gradient instead of 64). The wrapper
// zero-pads any other head dim below 128 to 128 (ops/flash_attention.py)
// and passes the true Dh^-0.5 as `scale`, as it does for K1.
#include <utility>

#include "common.cuh"
#include "sm90.cuh"

using gritlm::bf16;

namespace {

constexpr int WG = 128;                      // threads of a warpgroup
constexpr int CONSUMERS = 2;                 // consumer warpgroups a block
constexpr int NTHREADS = WG * (CONSUMERS + 1);  // K4; K5 has no producer
constexpr int STAGES = 3;                    // ring depth
// K4's registers a thread after setmaxnreg: the producer warpgroup's go to
// the consumers (the SM's 65536 hold 128 x 40 + 256 x 232)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WG * PRODUCER_REGS + WG * CONSUMERS * CONSUMER_REGS <= 65536, "register split");
constexpr int TILE = 64;                     // rows a consumer owns; rows a ring tile carries
constexpr int BLOCK_ROWS = TILE * CONSUMERS; // the block's resident rows
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: the resident tiles, the
// ring, then small per-stage data (K4's tile metadata, K5's release
// counts), the key mask (K5) and the barriers.
// A 64-column half of a tile is rows x 128 bytes (see sm90.cuh); a tile of
// DH columns is DH / 64 halves.
constexpr uint32_t HALF_T = TILE * 128;          // half of a 64-row ring tile
constexpr uint32_t HALF_R = BLOCK_ROWS * 128;    // half of a resident tile

template <int DH>
struct Layout {
  static_assert(DH == 64 || DH == 128, "head dims 64 and 128");
  static constexpr int HALVES = DH / 64;
  static constexpr uint32_t RES_BYTES = 2 * HALVES * HALF_R;    // two resident tiles
  static constexpr uint32_t STAGE_BYTES = 2 * HALVES * HALF_T;  // two ring tiles
  static constexpr uint32_t OFF_RING = RES_BYTES;
  static constexpr uint32_t OFF_STATS = OFF_RING + STAGES * STAGE_BYTES;  // 512 bytes a stage
  static constexpr uint32_t OFF_MASK = OFF_STATS + STAGES * 128 * 4;
  static constexpr uint32_t OFF_BAR = OFF_MASK + BLOCK_ROWS * 4;
  static constexpr uint32_t SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// byte address of half c of resident tile x / of ring tile x in stage s
template <int DH>
__device__ __forceinline__ uint32_t res_half(uint32_t base, int x, int c) {
  return base + (Layout<DH>::HALVES * x + c) * HALF_R;
}
template <int DH>
__device__ __forceinline__ uint32_t ring_half(uint32_t base, int s, int x, int c) {
  using C = Layout<DH>;
  return base + C::OFF_RING + s * C::STAGE_BYTES + (C::HALVES * x + c) * HALF_T;
}

// Descriptors of a tile's first k-step: K-major (the reduction runs along
// the DH features of a row) and MN-major (it runs down the rows; LBO, the
// step to the second 64-column half, is unused at DH 64); the k-steps'
// offsets are compile-time (sm90.cuh).
__device__ __forceinline__ uint64_t kmajor(uint32_t rows) {
  return sm90::desc_sw128(rows, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile) {
  return sm90::desc_sw128(tile, HALF_T, 1024);
}

// The forward's keep rule for (key position, query row).
struct Keep {
  int Sq, causal, window, offset;
  __device__ __forceinline__ bool operator()(int key, int q) const {
    const int qpos = offset + q;
    return q < Sq && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
  }
};

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty, uint32_t res,
                                          uint32_t full_count) {
  for (int s = 0; s < STAGES; ++s) {
    sm90::mbar_init(full + 8 * s, full_count);
    sm90::mbar_init(empty + 8 * s, WG * CONSUMERS);  // every consumer thread arrives
  }
  sm90::mbar_init(res, 1);
  sm90::mbar_fence_init();
}

// One 64 x N product reduced over the DH features (N = 2 x the
// accumulators a thread holds): DH / 16 k-steps of 16, each 32 bytes
// further along the row, the second 4 (DH 128) in the tile's other half.
template <uint32_t A_HALF, uint32_t A_OFF, uint32_t B_OFF, int NREG, int... KK>
__device__ __forceinline__ void feature_steps(float (&d)[NREG], uint64_t da, uint64_t db,
                                              std::integer_sequence<int, KK...>) {
  if constexpr (NREG == 32)
    (sm90::wgmma_m64n64k16_ss<A_OFF + (KK / 4) * A_HALF + (KK % 4) * 32,
                              B_OFF + (KK / 4) * HALF_T + (KK % 4) * 32>(d, da, db, KK > 0),
     ...);
  else
    (sm90::wgmma_m64n32k16_ss<A_OFF + (KK / 4) * A_HALF + (KK % 4) * 32,
                              B_OFF + (KK / 4) * HALF_T + (KK % 4) * 32>(d, da, db, KK > 0),
     ...);
}

// S (or S^T) and dP (or dP^T) of one warpgroup, 64 x N each: `a` is the
// warpgroup's first row of the first resident tile (the second lies
// DH / 64 HALF_R on), the ring tile of S starts B_OFF bytes past `b` (dP's
// lies DH / 64 HALF_T further). Leaves two groups in flight: S first.
template <int DH, uint32_t B_OFF, int NREG>
__device__ __forceinline__ void issue_scores(float (&s)[NREG], float (&dp)[NREG], uint32_t a,
                                             uint32_t b) {
  constexpr uint32_t HALVES = Layout<DH>::HALVES;
  const uint64_t da = kmajor(a), db = kmajor(b);
  constexpr auto steps = std::make_integer_sequence<int, DH / 16>();
  sm90::wgmma_fence();
  feature_steps<HALF_R, 0, B_OFF>(s, da, db, steps);
  sm90::wgmma_commit();
  feature_steps<HALF_R, HALVES * HALF_R, B_OFF + HALVES * HALF_T>(dp, da, db, steps);
  sm90::wgmma_commit();
}

// An fp32 accumulator re-packed as bf16 A fragments, four a k-step of 16
// columns: the accumulator layout is the A layout (sm90.cuh).
template <int NA>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NA], const float (&x)[2 * NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) a[i] = sm90::pack_bf16(x[2 * i], x[2 * i + 1]);
}

// acc[64 x DH] += X[64 x K] . tile[K x DH], X as packed A fragments (K =
// 4 x their count), the tile MN-major in the ring TILE_OFF bytes past
// `tile_desc`'s: k-steps of 16 rows (DH = 2 x the accumulators a thread
// holds: m64n128k16 at 128, m64n64k16 at 64). Issued, not waited for; the
// caller fences the fragments and issues wgmma_fence first.
template <uint32_t TILE_OFF, int NA, int... KK>
__device__ __forceinline__ void row_steps(float (&acc)[64], const uint32_t (&a)[NA],
                                          uint64_t tile_desc, std::integer_sequence<int, KK...>) {
  (sm90::wgmma_m64n128k16_rs_tb<TILE_OFF + KK * 16 * 128>(acc, a[4 * KK], a[4 * KK + 1],
                                                          a[4 * KK + 2], a[4 * KK + 3],
                                                          tile_desc, 1),
   ...);
}
template <uint32_t TILE_OFF, int NA, int... KK>
__device__ __forceinline__ void row_steps(float (&acc)[32], const uint32_t (&a)[NA],
                                          uint64_t tile_desc, std::integer_sequence<int, KK...>) {
  (sm90::wgmma_m64n64k16_rs_tb<TILE_OFF + KK * 16 * 128>(acc, a[4 * KK], a[4 * KK + 1],
                                                         a[4 * KK + 2], a[4 * KK + 3],
                                                         tile_desc, 1),
   ...);
}
template <uint32_t TILE_OFF, int NACC, int NA>
__device__ __forceinline__ void issue_update(float (&acc)[NACC], const uint32_t (&a)[NA],
                                             uint64_t tile_desc) {
  row_steps<TILE_OFF>(acc, a, tile_desc, std::make_integer_sequence<int, NA / 4>());
}

// Write a warpgroup's 64 x DH fp32 accumulator (NACC = DH / 2 a thread) as
// bf16 rows: row r of the thread (r0 or r0 + 8) goes to out + row_off(r)
// when valid.
template <int NACC, typename RowOff>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NACC], int r0,
                                           int n_rows, int lane, RowOff row_off) {
#pragma unroll
  for (int i = 0; i < NACC; i += 2) {
    const int r = r0 + 8 * ((i % 4) / 2);
    if (r < n_rows) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(out + row_off(r) + col) = sm90::pack_bf16(acc[i], acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------- K4

// One ring tile (64 keys from kt) for one warpgroup: P and dS of its 64
// rows (row0 and row0 + 8 for this thread), then dQ += dS K.
template <int DH, bool EDGE>
__device__ __forceinline__ void dq_tile(float (&dq)[DH / 2], uint32_t a_q, uint32_t k_tile,
                                        const float (&lse2)[2], const float (&dl)[2], int row0,
                                        int kt, unsigned lo, unsigned hi, int lane, float scale,
                                        const Keep& keep) {
  float s[32], dp[32];
  issue_scores<DH, 0>(s, dp, a_q, k_tile);
  const float scale_log2 = scale * LOG2E;
  const int c2 = 2 * (lane % 4);
  sm90::wgmma_wait<1>();
  sm90::fence_regs(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ri = (i % 4) / 2, col = 8 * (i / 4) + c2 + i % 2;
    float p = sm90::ex2(s[i] * scale_log2 - lse2[ri]);
    if (EDGE) {
      const bool kv = (((i / 4) < 4 ? lo : hi) >> (col % 32)) & 1u;
      p = kv && keep(kt + col, row0 + 8 * ri) ? p : 0.f;
    }
    s[i] = p;
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ri = (i % 4) / 2, col = 8 * (i / 4) + c2 + i % 2;
    float ds = s[i] * (dp[i] - dl[ri]) * scale;
    if (EDGE) {
      const bool kv = (((i / 4) < 4 ? lo : hi) >> (col % 32)) & 1u;
      ds = kv && keep(kt + col, row0 + 8 * ri) ? ds : 0.f;
    }
    dp[i] = ds;
  }
  uint32_t a[16];
  pack_a(a, dp);
  sm90::fence_regs(a);
  sm90::wgmma_fence();
  issue_update<0>(dq, a, mnmajor(k_tile));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dq);
}

// One block per (128 query rows, query head, batch row). Ring tiles: K and
// V of 64 keys, with the tile's first key and valid-key bits (keys at or
// past kend count as invalid: causal masks them anyway).
template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const int* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Sk, int H, int group, long long m_sb,
                    int causal, int window, int offset, float scale) {
  using C = Layout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* meta = reinterpret_cast<int*>(smem_raw + (base - raw) + C::OFF_STATS);
  const uint32_t full = base + C::OFF_BAR, empty = full + 8 * STAGES, res = empty + 8 * STAGES;

  const int q0 = blockIdx.x * BLOCK_ROWS;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int tid = threadIdx.x;
  if (tid == 0) init_ring(full, empty, res, 1);
  __syncthreads();

  // the same visited key range as the forward
  const int q_last = offset + min(q0 + BLOCK_ROWS, Sq) - 1;
  int kend = Sk, kbeg = 0;
  if (causal) kend = min(Sk, q_last + 1);
  if (window > 0) kbeg = max(0, offset + q0 - window + 1) / TILE * TILE;

  if (tid >= CONSUMERS * WG) {
    // ------------------------------------------------------------ producer
    sm90::regs_dec<PRODUCER_REGS>();
    if (tid < CONSUMERS * WG + 32) {  // one warp drives the ring
      const int lane = tid % 32;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(res, C::RES_BYTES);
        for (int c = 0; c < C::HALVES; ++c) {
          sm90::tma_load_4d(res_half<DH>(base, 0, c), &tq, res, 64 * c, h, q0, b);
          sm90::tma_load_4d(res_half<DH>(base, 1, c), &tdo, res, 64 * c, h, q0, b);
        }
      }
      const int* mb = mask + b * m_sb;
      int stage = 0;
      uint32_t phase = 0;
      // the key mask of the next tile is loaded while this one waits for a stage
      int m0 = kbeg + lane < kend ? mb[kbeg + lane] : 0;
      int m1 = kbeg + 32 + lane < kend ? mb[kbeg + 32 + lane] : 0;
      for (int kt = kbeg; kt < kend; kt += TILE) {
        const unsigned lo = __ballot_sync(gritlm::FULL, m0 != 0);  // keys past kend read as 0
        const unsigned hi = __ballot_sync(gritlm::FULL, m1 != 0);
        const int kn = kt + TILE;
        m0 = kn + lane < kend ? mb[kn + lane] : 0;
        m1 = kn + 32 + lane < kend ? mb[kn + 32 + lane] : 0;
        if ((lo | hi) == 0) continue;  // the tile holds no valid key
        sm90::mbar_wait(empty + 8 * stage, phase ^ 1);
        if (lane == 0) {
          int* m = meta + 128 * stage;
          m[0] = kt;
          m[1] = (int)lo;
          m[2] = (int)hi;
          const uint32_t fb = full + 8 * stage;
          sm90::mbar_arrive_expect_tx(fb, C::STAGE_BYTES);
          for (int c = 0; c < C::HALVES; ++c) {
            sm90::tma_load_4d(ring_half<DH>(base, stage, 0, c), &tk, fb, 64 * c, hk, kt, b);
            sm90::tma_load_4d(ring_half<DH>(base, stage, 1, c), &tv, fb, 64 * c, hk, kt, b);
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
        meta[128 * stage] = -1;  // end of the sequence
        sm90::mbar_arrive(full + 8 * stage);
      }
    }
  } else {
    // -------------------------------------------------------------- consumers
    sm90::regs_inc<CONSUMER_REGS>();
    // the warpgroup index broadcast from lane 0: the compiler then treats it as
    // uniform and keeps the descriptor arithmetic in uniform registers
    const int w = __shfl_sync(gritlm::FULL, tid / WG, 0);
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const int qw0 = q0 + w * TILE;
    const int row0 = qw0 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
    const long long rows = ((long long)b * H + h) * Sq;
    float lse2[2], dl[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = row0 + 8 * ri;
      lse2[ri] = r < Sq ? lse[rows + r] * LOG2E : 0.f;
      dl[ri] = r < Sq ? delta[rows + r] : 0.f;
    }
    const Keep keep{Sq, causal, window, offset};
    const uint32_t a_q = res_half<DH>(base, 0, 0) + w * TILE * 128;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    sm90::mbar_wait(res, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      sm90::mbar_wait(full + 8 * stage, phase);
      const int* m = meta + 128 * stage;
      const int kt = m[0];
      if (kt < 0) break;
      const unsigned lo = (unsigned)m[1], hi = (unsigned)m[2];
      const bool skip = qw0 >= Sq || (causal && kt > offset + qw0 + TILE - 1) ||
                        (window > 0 && kt + TILE - 1 <= offset + qw0 - window);
      if (!skip) {
        const bool edge = (lo & hi) != gritlm::FULL || qw0 + TILE > Sq ||
                          (causal && kt + TILE - 1 > offset + qw0) ||
                          (window > 0 && kt <= offset + qw0 + TILE - 1 - window);
        const uint32_t k_tile = ring_half<DH>(base, stage, 0, 0);
        if (edge)
          dq_tile<DH, true>(acc, a_q, k_tile, lse2, dl, row0, kt, lo, hi, lane, scale, keep);
        else
          dq_tile<DH, false>(acc, a_q, k_tile, lse2, dl, row0, kt, lo, hi, lane, scale, keep);
      }
      sm90::mbar_arrive(empty + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows(dq, acc, row0, Sq, lane,
               [&](int r) { return (((long long)b * Sq + r) * H + h) * DH; });
  }
}

// ---------------------------------------------------------------------- K5

// P^T (in place of S^T) for 32 query rows: the thread's keys key[0],
// key[1] (valid as kval) against query rows q0 + 8 j + c2 + (0, 1), whose
// lse * log2(e) are l2[2 j], l2[2 j + 1].
template <bool EDGE>
__device__ __forceinline__ void probs_t(float (&s)[16], const float (&l2)[8], const int (&key)[2],
                                        const bool (&kval)[2], int q0, int c2, float scale_log2,
                                        const Keep& keep) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = i / 4, e = i % 2, ri = (i % 4) / 2;
    const float p = sm90::ex2(s[i] * scale_log2 - l2[2 * j + e]);
    s[i] = !EDGE || (kval[ri] && keep(key[ri], q0 + 8 * j + c2 + e)) ? p : 0.f;
  }
}

// dS^T = P^T (dP^T - delta) * scale in place of dP^T.
template <bool EDGE>
__device__ __forceinline__ void dsoft_t(float (&dp)[16], const float (&p)[16],
                                        const float (&dl)[8], const int (&key)[2],
                                        const bool (&kval)[2], int q0, int c2, float scale,
                                        const Keep& keep) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = i / 4, e = i % 2, ri = (i % 4) / 2;
    const float ds = p[i] * (dp[i] - dl[2 * j + e]) * scale;
    dp[i] = !EDGE || (kval[ri] && keep(key[ri], q0 + 8 * j + c2 + e)) ? ds : 0.f;
  }
}

// Half H (query rows q0 + 32 H .. + 31) of a ring tile for one warpgroup:
// P^T and dS^T of its 64 keys against those 32 rows, then dV += P^T dO and
// dK += dS^T Q, issued and left in flight. Halves keep P^T and dP^T at 16
// accumulators a thread beside the DH of dK and dV, and let half 1's S^T
// and dP^T overlap half 0's updates. `lrow`/`drow` are the head's lse and
// delta rows: the thread loads the 16 values it needs first, so the loads
// run under the products.
template <int DH, int H>
__device__ __forceinline__ void dkv_half(float (&dk)[DH / 2], float (&dv)[DH / 2], uint32_t a_k,
                                         uint32_t q_tile, const float* lrow, const float* drow,
                                         const int (&key)[2], const bool (&kval)[2], int q0,
                                         int lane, float scale, const Keep& keep, bool edge) {
  constexpr uint32_t ROWS = H * 32 * 128;  // byte offset of the half's rows in a tile half
  const int c2 = 2 * (lane % 4);
  q0 += 32 * H;
  float l2[8], dl[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = q0 + 8 * (k / 2) + c2 + k % 2;
    l2[k] = q < keep.Sq ? __ldg(lrow + q) * LOG2E : 0.f;
    dl[k] = q < keep.Sq ? __ldg(drow + q) : 0.f;
  }
  float s[16], dp[16];
  issue_scores<DH, ROWS>(s, dp, a_k, q_tile);
  sm90::wgmma_wait<1>();  // S^T (and the other half's updates)
  sm90::fence_regs(s);
  if (edge)
    probs_t<true>(s, l2, key, kval, q0, c2, scale * LOG2E, keep);
  else
    probs_t<false>(s, l2, key, kval, q0, c2, scale * LOG2E, keep);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dp);
  if (edge)
    dsoft_t<true>(dp, s, dl, key, kval, q0, c2, scale, keep);
  else
    dsoft_t<false>(dp, s, dl, key, kval, q0, c2, scale, keep);
  uint32_t pa[8], da[8];
  pack_a(pa, s);
  pack_a(da, dp);
  sm90::fence_regs(pa);
  sm90::fence_regs(da);
  sm90::wgmma_fence();
  const uint64_t ring = mnmajor(q_tile);
  issue_update<Layout<DH>::HALVES * HALF_T + ROWS>(dv, pa, ring);  // dV += P^T dO
  issue_update<ROWS>(dk, da, ring);                                 // dK += dS^T Q
  sm90::wgmma_commit();
}

// Both halves of a ring tile, then their updates settled.
template <int DH>
__device__ __forceinline__ void dkv_tile(float (&dk)[DH / 2], float (&dv)[DH / 2], uint32_t a_k,
                                         uint32_t q_tile, const float* lrow, const float* drow,
                                         const int (&key)[2], const bool (&kval)[2], int q0,
                                         int lane, float scale, const Keep& keep, bool edge) {
  dkv_half<DH, 0>(dk, dv, a_k, q_tile, lrow, drow, key, kval, q0, lane, scale, keep, edge);
  dkv_half<DH, 1>(dk, dv, a_k, q_tile, lrow, drow, key, kval, q0, lane, scale, keep, edge);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dv);
  sm90::fence_regs(dk);
}

// One block per (128 keys, kv head, batch row): the two consumer warpgroups
// and no producer warp. The dK and dV accumulators (128 a thread at DH 128)
// with the products' need more registers than ptxas gave a consumer region
// after setmaxnreg (it spilled and serialised every wgmma with 232 granted),
// while a 256-thread block has 255 a thread by itself. Thread 0 loads the first
// STAGES tiles; after that the warpgroup that releases a stage last refills
// it. The sequence: the GQA group's query heads x their visible q-tiles,
// tile i in stage i % STAGES.
template <int DH>
__global__ void __launch_bounds__(WG * CONSUMERS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const int* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                     int Hkv, int group, long long m_sb, int causal, int window, int offset,
                     float scale) {
  using C = Layout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* smask = reinterpret_cast<int*>(smem_raw + (base - raw) + C::OFF_MASK);
  // a stage's release count
  int* released = reinterpret_cast<int*>(smem_raw + (base - raw) + C::OFF_STATS);
  const uint32_t full = base + C::OFF_BAR, empty = full + 8 * STAGES, res = empty + 8 * STAGES;

  const int k0 = blockIdx.x * BLOCK_ROWS;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  int valid = 0;
  if (tid < BLOCK_ROWS) {
    const int kp = k0 + tid;
    valid = kp < Sk && mask[b * m_sb + kp] != 0;
    smask[tid] = valid;
  }
  if (tid < STAGES) released[tid] = 0;
  if (tid == 0) init_ring(full, empty, res, 1);
  // which consumer warpgroups hold a valid key, and which only valid keys
  // (broadcast from lane 0, so that the compiler sees block-uniform values)
  unsigned any_bits = 0, all_bits = 0;
#pragma unroll
  for (int w = 0; w < CONSUMERS; ++w) {
    const bool mine = tid >= w * TILE && tid < (w + 1) * TILE;
    any_bits |= (unsigned)__syncthreads_or(mine && valid) << w;
    all_bits |= (unsigned)__syncthreads_and(!mine || valid) << w;
  }
  any_bits = __shfl_sync(gritlm::FULL, any_bits, 0);
  all_bits = __shfl_sync(gritlm::FULL, all_bits, 0);

  // the q rows that can see this block's keys: causal rows at or after its
  // first key, window rows before its last key + window
  const int k_last = min(k0 + BLOCK_ROWS, Sk) - 1;
  int qbeg = 0, qend = Sq;
  if (causal) qbeg = max(0, k0 - offset);
  if (window > 0) qend = min(Sq, k_last + window - offset);
  const int qfirst = qbeg / TILE * TILE;
  const int per_head = qend > qfirst ? (qend - qfirst + TILE - 1) / TILE : 0;
  const int n = any_bits ? group * per_head : 0;  // ring tiles in the sequence

  const auto issue = [&](int i) {  // tile i of the sequence into stage i % STAGES
    const int s = i % STAGES, h = hk * group + i / per_head;
    const int q0 = qfirst + (i % per_head) * TILE;
    const uint32_t fb = full + 8 * s;
    sm90::mbar_arrive_expect_tx(fb, C::STAGE_BYTES);
    for (int c = 0; c < C::HALVES; ++c) {
      sm90::tma_load_4d(ring_half<DH>(base, s, 0, c), &tq, fb, 64 * c, h, q0, b);
      sm90::tma_load_4d(ring_half<DH>(base, s, 1, c), &tdo, fb, 64 * c, h, q0, b);
    }
  };
  if (tid == 0 && n > 0) {
    sm90::mbar_arrive_expect_tx(res, C::RES_BYTES);
    for (int c = 0; c < C::HALVES; ++c) {
      sm90::tma_load_4d(res_half<DH>(base, 0, c), &tk, res, 64 * c, hk, k0, b);
      sm90::tma_load_4d(res_half<DH>(base, 1, c), &tv, res, 64 * c, hk, k0, b);
    }
    for (int i = 0; i < min(n, STAGES); ++i) issue(i);
  }

  const int w = __shfl_sync(gritlm::FULL, tid / WG, 0);
  const int warp = (tid % WG) / 32, lane = tid % 32;
  const int kw0 = k0 + w * TILE;
  const int r_lo = warp * 16 + lane / 4;
  const int key[2] = {kw0 + r_lo, kw0 + r_lo + 8};  // the thread's keys
  const bool kval[2] = {smask[w * TILE + r_lo] != 0, smask[w * TILE + r_lo + 8] != 0};
  const bool any_w = (any_bits >> w) & 1u, all_w = (all_bits >> w) & 1u;
  const Keep keep{Sq, causal, window, offset};
  const uint32_t a_k = res_half<DH>(base, 0, 0) + w * TILE * 128;

  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  if (n > 0) {
    sm90::mbar_wait(res, 0);
    for (int i = 0; i < n; ++i) {
      const int stage = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      const int g = i / per_head, q0 = qfirst + (i - g * per_head) * TILE;
      sm90::mbar_wait(full + 8 * stage, phase);
      const bool skip = !any_w || (causal && kw0 > offset + q0 + TILE - 1) ||
                        (window > 0 && kw0 + TILE - 1 <= offset + q0 - window);
      if (!skip) {
        const bool edge = !all_w || q0 + TILE > Sq || (causal && kw0 + TILE - 1 > offset + q0) ||
                          (window > 0 && kw0 <= offset + q0 + TILE - 1 - window);
        const long long row = ((long long)b * H + hk * group + g) * Sq;
        const uint32_t q_tile = ring_half<DH>(base, stage, 0, 0);
        if (edge)  // two copies of the tile code: interior tiles carry no mask
          dkv_tile<DH>(dka, dva, a_k, q_tile, lse + row, delta + row, key, kval, q0, lane,
                       scale, keep, true);
        else
          dkv_tile<DH>(dka, dva, a_k, q_tile, lse + row, delta + row, key, kval, q0, lane,
                       scale, keep, false);
      }
      // release: after wgmma.wait_group the warpgroup's reads of the stage
      // are done and all four warps have waited for it (a wgmma needs all
      // four); a skipped tile syncs them instead. The warpgroup that
      // releases last refills the stage, so neither waits for the other.
      if (skip) asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(WG) : "memory");
      if (tid % WG == 0 && atomicAdd(&released[stage], 1) == CONSUMERS - 1) {
        released[stage] = 0;
        if (i + STAGES < n) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(i + STAGES);
        }
      }
    }
  }
  const auto row_off = [&](int r) { return (((long long)b * Sk + r) * Hkv + hk) * DH; };
  store_rows(dk, dka, key[0], Sk, lane, row_off);
  store_rows(dv, dva, key[0], Sk, lane, row_off);
}

// Each instance sets its shared-memory limit once, at its first launch.
template <typename K>
int configure(K kernel, uint32_t smem, bool* done) {
  if (*done) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* mask, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq, int Sk, int H,
              int Hkv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, long long m_sb, long long do_sb, long long do_ss,
              int causal, int window, int offset, float scale, cudaStream_t stream) {
  constexpr uint32_t smem = Layout<DH>::SMEM;
  static bool configured = false;
  int rc = configure(flash_bwd_dq_kernel<DH>, smem, &configured);
  CUtensorMap tq, tk, tv, tdo;
  if (!rc) rc = sm90::make_map_bshd(&tq, q, B, Sq, H, 2 * q_sb, 2 * q_ss, BLOCK_ROWS, DH);
  if (!rc) rc = sm90::make_map_bshd(&tdo, dout, B, Sq, H, 2 * do_sb, 2 * do_ss, BLOCK_ROWS, DH);
  if (!rc) rc = sm90::make_map_bshd(&tk, k, B, Sk, Hkv, 2 * k_sb, 2 * k_ss, TILE, DH);
  if (!rc) rc = sm90::make_map_bshd(&tv, v, B, Sk, Hkv, 2 * v_sb, 2 * v_ss, TILE, DH);
  if (rc) return rc;
  dim3 grid((Sq + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  flash_bwd_dq_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, tdo, (const int*)mask, (const float*)lse, (const float*)delta, (bf16*)dq, Sq,
      Sk, H, H / Hkv, m_sb, causal, window, offset, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* mask, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Sq, int Sk,
               int H, int Hkv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, long long m_sb, long long do_sb,
               long long do_ss, int causal, int window, int offset, float scale,
               cudaStream_t stream) {
  constexpr uint32_t smem = Layout<DH>::SMEM;
  static bool configured = false;
  int rc = configure(flash_bwd_dkv_kernel<DH>, smem, &configured);
  CUtensorMap tq, tk, tv, tdo;
  if (!rc) rc = sm90::make_map_bshd(&tq, q, B, Sq, H, 2 * q_sb, 2 * q_ss, TILE, DH);
  if (!rc) rc = sm90::make_map_bshd(&tdo, dout, B, Sq, H, 2 * do_sb, 2 * do_ss, TILE, DH);
  if (!rc) rc = sm90::make_map_bshd(&tk, k, B, Sk, Hkv, 2 * k_sb, 2 * k_ss, BLOCK_ROWS, DH);
  if (!rc) rc = sm90::make_map_bshd(&tv, v, B, Sk, Hkv, 2 * v_sb, 2 * v_ss, BLOCK_ROWS, DH);
  if (rc) return rc;
  dim3 grid((Sk + BLOCK_ROWS - 1) / BLOCK_ROWS, Hkv, B);
  flash_bwd_dkv_kernel<DH><<<grid, WG * CONSUMERS, smem, stream>>>(
      tq, tk, tv, tdo, (const int*)mask, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, Sq, Sk, H, Hkv, H / Hkv, m_sb, causal, window, offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, as the tensors give them; the tensor maps take
// them in bytes (the wrapper checks that they are multiples of 8). Dh: 128
// or 64 (another returns cudaErrorInvalidValue); `scale` is the softmax
// scale the forward used, Dh^-0.5 of the model's head dim.
extern "C" int gritlm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* mask, const void* dout, const void* lse,
                                   const void* delta, void* dq, int B, int Sq, int Sk, int H,
                                   int Hkv, int Dh, long long q_sb, long long q_ss,
                                   long long k_sb, long long k_ss, long long v_sb,
                                   long long v_ss, long long m_sb, long long do_sb,
                                   long long do_ss, int causal, int window, int offset,
                                   float scale, void* stream) {
  if (Dh == 128)
    return launch_dq<128>(q, k, v, mask, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, q_sb, q_ss,
                          k_sb, k_ss, v_sb, v_ss, m_sb, do_sb, do_ss, causal, window, offset,
                          scale, (cudaStream_t)stream);
  if (Dh == 64)
    return launch_dq<64>(q, k, v, mask, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, q_sb, q_ss,
                         k_sb, k_ss, v_sb, v_ss, m_sb, do_sb, do_ss, causal, window, offset,
                         scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gritlm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* mask, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int B, int Sq,
                                    int Sk, int H, int Hkv, int Dh, long long q_sb,
                                    long long q_ss, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss, long long m_sb,
                                    long long do_sb, long long do_ss, int causal, int window,
                                    int offset, float scale, void* stream) {
  if (Dh == 128)
    return launch_dkv<128>(q, k, v, mask, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, q_sb,
                           q_ss, k_sb, k_ss, v_sb, v_ss, m_sb, do_sb, do_ss, causal, window,
                           offset, scale, (cudaStream_t)stream);
  if (Dh == 64)
    return launch_dkv<64>(q, k, v, mask, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, q_sb,
                          q_ss, k_sb, k_ss, v_sb, v_ss, m_sb, do_sb, do_ss, causal, window,
                          offset, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
