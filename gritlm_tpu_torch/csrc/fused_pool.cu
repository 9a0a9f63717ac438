// K2: fused final RMSNorm + masked (weighted) mean pool + L2 normalize, the
// encode epilogue, for Hopper (sm_90a). It replaces the Pallas `_kernel` of
// gritlm_tpu/ops/fused_pool.py; the plain version is in
// gritlm_tpu_torch/ops/fused_pool.py.
//
// What bounds it: bytes, one read of the masked-in bf16 hidden rows (a few
// operations an element). At the encode shape (B 8, S 512, D 4096) those are
// about 26 MB, 8 us at 3.35 TB/s, so launch, latency and the cross-block
// merge are what a design for this card has to hide. One launch a call:
// - grid: K clusters of CL blocks (ops/fused_pool.py `pool_plan`: about two
//   blocks an SM, one wave of clusters). Every row gets `need` clusters and
//   the rest go to the rows in proportion to their masked-in rows, counted
//   by every block from the whole mask while it is small (`balanced`), else
//   in equal shares, so no block carries a full row's share beside a padded
//   one's;
// - mask before data: a block reads the mask first (all loads in flight,
//   one ballot a 32-position word into shared memory), ranks the masked-in
//   positions (a block scan over the words, then one lane a position), and
//   block c of its row's C_b takes the ranks [R c / C_b, R (c + 1) / C_b) of
//   the row's R masked-in rows. A row's weightedmean weight is its rank + 1
//   (the running count of mask tokens), the denominator R or R (R + 1) / 2;
//   nothing else is counted;
// - then a producer warp streams the block's rows into a ring of shared-
//   memory stages, one row a stage, by 1-D bulk copies that complete on the
//   stage's `full` mbarrier, and refills a stage when its `empty` mbarrier
//   says the eight consumer warps are past it. No block barrier in the
//   stream: row j's sum of squares is one warp's (j % 8) reduction, done
//   `ahead` rows early and published with its weight * rsqrt(mean(x^2) +
//   eps) through the stage's `ready` mbarrier; every consumer thread adds
//   each row into its own D / 256 columns' fp32 accumulators in registers;
// - merge in the same launch, in a fixed order (bit-equal reruns, no float
//   atomics): the cluster sums its blocks' partials through distributed
//   shared memory (block r of the cluster sums vector slice r over the
//   cluster's blocks in rank order). A cluster that has its row alone
//   finishes it there (gamma, the denominator, the norm summed over the
//   blocks through distributed shared memory). Else each writes one fp32
//   partial (0.5 MB in all at the encode shape), and the row's last block to
//   arrive (a counter a batch row in _build.counters, which it resets) sums
//   the row's cluster partials in cluster order, applies gamma and the
//   denominator, and L2-normalizes. Both merges issue their loads together
//   before they add.
// An empty mask row gives zeros (the denominator and the norm clamp keep it
// finite), as the plain version does.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;
using gritlm::bf16;

namespace {

constexpr int CONSUMERS = 256;           // threads that own columns
constexpr int NW = CONSUMERS / 32;       // consumer warps
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int VEC = 8;                   // bf16 a 16-byte vector
constexpr int MAX_SLOTS = 4;             // D <= CONSUMERS * VEC * MAX_SLOTS = 8192
constexpr int MAX_LIST = 1024;           // masked-in rows a block takes (pool_plan keeps to it)
constexpr int MAX_STAGES = 32;
constexpr int MAX_AHEAD = 4;             // rows a sum of squares runs ahead of the adds
constexpr int MAX_CLUSTER = 8;           // the portable cluster size
constexpr int IN_FLIGHT = 8;             // partial loads a merging thread issues together
constexpr int HALF = 2;                  // a row's partials a round, for each of two vectors
constexpr int MASK_UNROLL = 16;          // mask loads a thread keeps in flight
constexpr uint32_t RING_BYTES = 64 * 1024;  // two or three blocks an SM

struct Args {
  const bf16* hidden;
  const bf16* gamma;
  const int* mask;
  float* part;    // [K, D] one partial a cluster, a row's clusters in a run
  int* counters;  // [B] arrivals of a batch row's blocks, 0 between launches
  float* out;     // [B, D]
  int B, S, D, need, stages, ahead;
  int balanced;   // clusters apportioned to rows by their masked-in rows
  long long h_sb, h_ss, m_sb;  // in elements
  int weighted, normalized;
  float eps;
};

// The first cluster of row b: every row gets `need` clusters (enough that no
// block takes more than MAX_LIST rows), the other K - B need go to the rows
// in proportion to the masked-in rows before them (P_b of R in all), or in
// equal shares when that is not counted (R == 0). Rounded the same way by
// every block, so the rows' clusters tile [0, K).
__device__ __forceinline__ int first_cluster(int b, int B, int need, int extra, int P_b, int R) {
  // extra < 2^16 clusters and P_b, b < 2^15 where counted: 32-bit products
  const unsigned share = R > 0 ? (unsigned)extra * (unsigned)P_b / (unsigned)R
                               : (unsigned)((long long)extra * b / B);
  return b * need + (int)share;
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = gritlm::warp_sum(x);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[w] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ void add8(float (&x)[VEC], const float4& lo, const float4& hi) {
  x[0] += lo.x; x[1] += lo.y; x[2] += lo.z; x[3] += lo.w;
  x[4] += hi.x; x[5] += hi.y; x[6] += hi.z; x[7] += hi.w;
}

// A merged vector of 8 columns: times gamma over the denominator, into dst
// (shared memory); returns its sum of squares.
__device__ __forceinline__ float finish(float (&x)[VEC], const uint4& graw, float denom,
                                        float* dst) {
  float g[VEC], ss = 0.f;
  gritlm::bf16x8_to_float(graw, g);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    x[e] = x[e] * g[e] / denom;
    ss += x[e] * x[e];
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
  return ss;
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS, 2) pool_kernel(const Args a) {
  // the mask bits and their prefix counts, then the ring, then the block's
  // partial and its result, in turn
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[MAX_STAGES], ready[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float fac[MAX_STAGES];  // weight * rstd of the stage's row
  __shared__ int list[MAX_LIST];
  __shared__ int scan[THREADS / 32];
  __shared__ float red[THREADS / 32];
  __shared__ int last;
  __shared__ float sumsq;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k = blockIdx.x / CL, K = gridDim.x / CL;
  const int B = a.B, S = a.S, D = a.D, nv = D / VEC, stages = a.stages;
  const int extra = K - B * a.need;
  const uint32_t row_bytes = (uint32_t)D * 2;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      sm90::mbar_init(sm90::smem_u32(&full[i]), 1);
      sm90::mbar_init(sm90::smem_u32(&ready[i]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[i]), NW);
    }
    sm90::mbar_fence_init();
  }

  // 1. the pooling mask as bits, one 32-position word a ballot: every row's
  // when the clusters are apportioned by the rows' counts, else the
  // block's row only (its equal share of the clusters is known already).
  // Each warp keeps MASK_UNROLL loads in flight (clamped addresses, so
  // every load is issued).
  const int nw = (S + 31) / 32;
  int b = 0;
  if (!a.balanced) {
    int lo = 0, hi = B - 1;  // the last row whose first cluster is <= k
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (first_cluster(mid, B, a.need, extra, 0, 0) <= k) lo = mid; else hi = mid - 1;
    }
    b = lo;
  }
  const int words = a.balanced ? B * nw : nw;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem);
  int* prefix = reinterpret_cast<int*>(smem) + words;  // words + 1 counts
  const int* mrow = a.mask + (a.balanced ? 0 : b * a.m_sb);
  const float inv_nw = 1.f / (float)nw;  // word -> (row, word of the row) without a division
  for (int w0 = warp; w0 < words; w0 += (THREADS / 32) * MASK_UNROLL) {
    int m[MASK_UNROLL], pos[MASK_UNROLL];
#pragma unroll
    for (int u = 0; u < MASK_UNROLL; ++u) {
      const int wi = min(w0 + u * (THREADS / 32), words - 1);
      const int r = a.balanced ? __float2int_rz(((float)wi + 0.5f) * inv_nw) : 0;
      pos[u] = (wi - r * nw) * 32 + lane;
      m[u] = mrow[r * a.m_sb + min(pos[u], S - 1)];
    }
#pragma unroll
    for (int u = 0; u < MASK_UNROLL; ++u) {
      const int wi = w0 + u * (THREADS / 32);
      const unsigned word = __ballot_sync(gritlm::FULL, m[u] != 0 && pos[u] < S);
      if (lane == 0 && wi < words) bits[wi] = word;
    }
  }
  __syncthreads();

  // 2. prefix counts of the words (a block scan; thread t takes words
  // [t * wpt, (t + 1) * wpt)), then the block's row, its clusters, and the
  // ranks [R c / C_b, R (c + 1) / C_b) of the row's R masked-in rows for
  // block c of the row's C_b
  const int wpt = (words + THREADS - 1) / THREADS;
  const int w_lo = min(tid * wpt, words), w_hi = min(w_lo + wpt, words);
  int cnt = 0;
  for (int w = w_lo; w < w_hi; ++w) cnt += __popc(bits[w]);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(gritlm::FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int base = incl - cnt;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) base += w < warp ? scan[w] : 0;
  for (int w = w_lo; w < w_hi; ++w) {
    prefix[w] = base;
    base += __popc(bits[w]);
  }
  if (tid == THREADS - 1) prefix[words] = base;  // the last thread's end is the total
  __syncthreads();
  int row0 = 0;  // the block's row's first word
  if (a.balanced) {
    const int R = prefix[words];
    int lo = 0, hi = B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (first_cluster(mid, B, a.need, extra, prefix[mid * nw], R) <= k) lo = mid; else hi = mid - 1;
    }
    b = lo;
    row0 = b * nw;
  }
  const int R = a.balanced ? prefix[words] : 0;
  const int k0 = first_cluster(b, B, a.need, extra, a.balanced ? prefix[row0] : 0, R);
  const int k1 = b + 1 < B ? first_cluster(b + 1, B, a.need, extra,
                                           a.balanced ? prefix[row0 + nw] : 0, R) : K;
  const int Cb = (k1 - k0) * CL, c = (k - k0) * CL + rank;
  const int off = prefix[row0], total = prefix[row0 + nw] - off;  // the row's masked-in rows
  const int r0 = (int)((long long)total * c / Cb), r1 = (int)((long long)total * (c + 1) / Cb);
  for (int w = warp; w < nw; w += THREADS / 32) {  // one lane a position
    const unsigned word = bits[row0 + w];
    const int p = prefix[row0 + w] - off;
    if (p >= r1 || p + __popc(word) <= r0) continue;  // the same for the whole warp
    const int r = p + __popc(word & ((1u << lane) - 1u));
    if ((word >> lane & 1u) && r >= r0 && r < r1) list[r - r0] = w * 32 + lane;
  }
  sm90::fence_proxy_async();  // the mask's bytes are the ring's next
  __syncthreads();

  // 3. stream the block's rows through the ring
  const int n = r1 - r0;
  const uint32_t ring = sm90::smem_u32(smem);
  const bf16* ring_p = reinterpret_cast<const bf16*>(smem);
  float acc[SLOTS][VEC];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[s][e] = 0.f;
  if (warp == NW) {  // the producer: one lane issues every row
    if (lane == 0) {
      const bf16* hb = a.hidden + b * a.h_sb;
      for (int j = 0; j < n; ++j) {
        const int st = j % stages;
        if (j >= stages) sm90::mbar_wait(sm90::smem_u32(&empty[st]), (j / stages - 1) & 1);
        const uint32_t bar = sm90::smem_u32(&full[st]);
        sm90::mbar_arrive_expect_tx(bar, row_bytes);
        sm90::bulk_load(ring + st * row_bytes, hb + list[j] * a.h_ss, row_bytes, bar);
      }
    }
  } else {
    const float inv_d = 1.f / (float)D;
    auto factor = [&](int j) {  // row j's weight * rstd, by warp j % NW
      const int st = j % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[st]), (j / stages) & 1);
      const bf16* row = ring_p + (long long)st * D;
      float sq[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) sq[e] = 0.f;
#pragma unroll 4
      for (int v = lane; v < nv; v += 32) {
        float x[VEC];
        gritlm::bf16x8_to_float(*reinterpret_cast<const uint4*>(row + v * VEC), x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) sq[e] = fmaf(x[e], x[e], sq[e]);
      }
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) t += sq[e];
      t = gritlm::warp_sum(t);
      if (lane == 0) {
        const float w = a.weighted ? (float)(r0 + j + 1) : 1.f;
        fac[st] = w * rsqrtf(t * inv_d + a.eps);
        sm90::mbar_arrive(sm90::smem_u32(&ready[st]));
      }
    };
    if (warp < min(a.ahead, n)) factor(warp);
    for (int j = 0; j < n; ++j) {
      const int ja = j + a.ahead;
      if (ja < n && ja % NW == warp) factor(ja);
      const int st = j % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[st]), (j / stages) & 1);
      sm90::mbar_wait(sm90::smem_u32(&ready[st]), (j / stages) & 1);
      const float f = fac[st];
      const bf16* row = ring_p + (long long)st * D;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int v = tid + s * CONSUMERS;
        if (v < nv) {
          float x[VEC];
          gritlm::bf16x8_to_float(*reinterpret_cast<const uint4*>(row + v * VEC), x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[s][e] = fmaf(f, x[e], acc[s][e]);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[st]));
    }
  }
  __syncthreads();  // every row read: the ring's bytes hold the block's partial next

  // 4. the cluster's partial: block r sums vector slice r over the
  // cluster's blocks in rank order, through distributed shared memory
  float* part_s = reinterpret_cast<float*>(smem);
  if (warp < NW)
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int v = tid + s * CONSUMERS;
      if (v < nv) {
        float4* p = reinterpret_cast<float4*>(part_s + v * VEC);
        p[0] = make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
        p[1] = make_float4(acc[s][4], acc[s][5], acc[s][6], acc[s][7]);
      }
    }
  cluster.sync();
  const int per = (nv + CL - 1) / CL;
  const int v0 = rank * per, v1 = min(nv, v0 + per);
  const float denom = total == 0 ? 1.f
                      : a.weighted ? 0.5f * (float)total * (float)(total + 1)
                                   : (float)total;
  // one cluster a row: the slice sums are the row's, finished in the cluster
  // (the result goes to the bytes past the partial, which peers still read)
  const int n_cl = k1 - k0;
  const bool whole = n_cl == 1;
  float* fin_s = part_s + D;
  float* gpart = a.part + (long long)k * D;
  float ss = 0.f;
  for (int v = v0 + tid; v < v1; v += THREADS) {
    float x[VEC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    uint4 graw = make_uint4(0u, 0u, 0u, 0u);
    if (whole) graw = *reinterpret_cast<const uint4*>(a.gamma + v * VEC);
    for (int q0 = 0; q0 < CL; q0 += IN_FLIGHT) {
      float4 lo[IN_FLIGHT], hi[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {  // clamped ranks: every load is issued
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part_s + v * VEC, min(q0 + u, CL - 1)));
        lo[u] = src[0];
        hi[u] = src[1];
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u)
        if (q0 + u < CL) add8(x, lo[u], hi[u]);
    }
    float4* dst = reinterpret_cast<float4*>((whole ? fin_s : gpart) + v * VEC);
    if (whole) {
      float g[VEC];
      gritlm::bf16x8_to_float(graw, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        x[e] = x[e] * g[e] / denom;
        ss += x[e] * x[e];
      }
    }
    dst[0] = make_float4(x[0], x[1], x[2], x[3]);
    dst[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  if (whole) {
    float inv = 1.f;
    if (a.normalized) {
      ss = block_sum(ss, red);
      if (tid == 0) sumsq = ss;
    }
    cluster.sync();  // the slices' sums of squares; every peer past its reads
    if (a.normalized) {
      float t = 0.f;
      for (int q = 0; q < CL; ++q) t += *cluster.map_shared_rank(&sumsq, q);
      inv = 1.f / fmaxf(sqrtf(t), 1e-12f);
      cluster.sync();  // no block leaves while a peer reads its sum
    }
    for (int v = v0 + tid; v < v1; v += THREADS) {
      const float4* src = reinterpret_cast<const float4*>(fin_s + v * VEC);
      float4* dst = reinterpret_cast<float4*>(a.out + (long long)b * D + v * VEC);
      const float4 lo = src[0], hi = src[1];
      dst[0] = make_float4(lo.x * inv, lo.y * inv, lo.z * inv, lo.w * inv);
      dst[1] = make_float4(hi.x * inv, hi.y * inv, hi.z * inv, hi.w * inv);
    }
    return;
  }
  __syncthreads();  // the block's slice stored
  if (tid == 0) {
    fence_acq_rel_gpu();  // the block's slice before its arrival
    const int ticket = atomicAdd(a.counters + b, 1);
    fence_acq_rel_gpu();
    last = ticket == Cb - 1;
    if (last) a.counters[b] = 0;  // ready for the next launch on the stream
  }
  cluster.sync();  // no block leaves while a peer reads its partial
  if (!last) return;

  // 5. the row's last block: the row's cluster partials summed in cluster
  // order, gamma and the denominator, the L2 normalize; two vectors a
  // thread at a time, all their loads issued before the adds
  const float* rp = a.part + (long long)k0 * D;
  for (int v = tid; v < nv; v += 2 * THREADS) {
    const bool two = v + THREADS < nv;
    const int v2 = two ? v + THREADS : v;
    const uint4 g1 = *reinterpret_cast<const uint4*>(a.gamma + v * VEC);
    const uint4 g2 = *reinterpret_cast<const uint4*>(a.gamma + v2 * VEC);
    float x1[VEC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float x2[VEC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < n_cl; q0 += HALF) {
      float4 l1[HALF], h1[HALF], l2[HALF], h2[HALF];
#pragma unroll
      for (int u = 0; u < HALF; ++u) {  // clamped: every load is issued
        const float* q = rp + (long long)min(q0 + u, n_cl - 1) * D;
        const float4* s1 = reinterpret_cast<const float4*>(q + v * VEC);
        const float4* s2 = reinterpret_cast<const float4*>(q + v2 * VEC);
        l1[u] = __ldcg(s1);
        h1[u] = __ldcg(s1 + 1);
        l2[u] = __ldcg(s2);
        h2[u] = __ldcg(s2 + 1);
      }
#pragma unroll
      for (int u = 0; u < HALF; ++u)
        if (q0 + u < n_cl) {
          add8(x1, l1[u], h1[u]);
          add8(x2, l2[u], h2[u]);
        }
    }
    ss += finish(x1, g1, denom, part_s + v * VEC);
    if (two) ss += finish(x2, g2, denom, part_s + v2 * VEC);
  }
  const float inv = a.normalized ? 1.f / fmaxf(sqrtf(block_sum(ss, red)), 1e-12f) : 1.f;
  for (int v = tid; v < nv; v += THREADS) {
    const float4* src = reinterpret_cast<const float4*>(part_s + v * VEC);
    float4* dst = reinterpret_cast<float4*>(a.out + (long long)b * D + v * VEC);
    const float4 lo = src[0], hi = src[1];
    dst[0] = make_float4(lo.x * inv, lo.y * inv, lo.z * inv, lo.w * inv);
    dst[1] = make_float4(hi.x * inv, hi.y * inv, hi.z * inv, hi.w * inv);
  }
}

// The ring and the shared memory of a call: one row a stage; a sum of
// squares runs `ahead` rows early, fewer than the stages; the mask's bits
// and prefix counts, and later the block's partial and its result (8 D
// bytes: stages >= 4), share the ring's bytes.
struct Geometry {
  int stages, ahead;
  uint32_t smem;
  Geometry(int B, int S, int D, int balanced) {
    stages = (int)(RING_BYTES / (2u * D));
    stages = stages < MAX_STAGES ? stages : MAX_STAGES;
    ahead = stages / 2 < MAX_AHEAD ? stages / 2 : MAX_AHEAD;
    const uint32_t ring = (uint32_t)stages * 2u * D;
    const uint32_t words = (uint32_t)((S + 31) / 32) * (balanced ? (uint32_t)B : 1u);
    const uint32_t mask = words * 8u + 4u;
    smem = ring > mask ? ring : mask;
  }
};

template <int SLOTS>
int configure(uint32_t smem) {
  static uint32_t configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(pool_kernel<SLOTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  return 0;
}

// Launch (a != nullptr) K clusters of CL blocks, or count the clusters of
// CL blocks that fit on the device at once (*fit).
template <int SLOTS>
int run(const Args* a, int K, int CL, uint32_t smem, cudaStream_t st, int* fit) {
  int rc = configure<SLOTS>(smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = a ? cudaLaunchKernelEx(&cfg, pool_kernel<SLOTS>, *a)
                    : cudaOccupancyMaxActiveClusters(fit, pool_kernel<SLOTS>, &cfg);
  return e != cudaSuccess ? (int)e : (a ? (int)cudaGetLastError() : 0);
}

int dispatch(const Args* a, int B, int S, int D, int K, int CL, int need, int balanced,
             cudaStream_t st, int* fit) {
  const int slots = (D / VEC + CONSUMERS - 1) / CONSUMERS;
  if (D % VEC || slots < 1 || slots > MAX_SLOTS || CL < 1 || CL > MAX_CLUSTER || need < 1 ||
      K < B * need || (long long)K * CL > 0x7fffffffLL ||
      (a && (long long)need * CL * MAX_LIST < S))
    return (int)cudaErrorInvalidValue;
  const uint32_t smem = Geometry(B, S, D, balanced).smem;
  switch (slots) {
    case 1: return run<1>(a, K, CL, smem, st, fit);
    case 2: return run<2>(a, K, CL, smem, st, fit);
    case 3: return run<3>(a, K, CL, smem, st, fit);
    default: return run<4>(a, K, CL, smem, st, fit);
  }
}

}  // namespace

// One launch: K clusters of CL blocks over the B rows, each row `need`
// clusters or more (need * CL * MAX_LIST >= S), the rest apportioned by the
// rows' masked-in counts when `balanced` (the whole mask read by every
// block), else in equal shares; part holds K * D floats, counters B zeros.
// Strides in elements.
extern "C" int gritlm_fused_pool(const void* hidden, const void* gamma, const void* mask,
                                 void* part, void* counters, void* out, int B, int S, int D,
                                 int K, int CL, int need, int balanced, long long h_sb,
                                 long long h_ss, long long m_sb, int weighted, int normalized,
                                 float eps, void* stream) {
  const Geometry g(B, S, D, balanced);
  const Args a{(const bf16*)hidden, (const bf16*)gamma, (const int*)mask, (float*)part,
               (int*)counters, (float*)out, B, S, D, need, g.stages, g.ahead, balanced,
               h_sb, h_ss, m_sb, weighted, normalized, eps};
  return dispatch(&a, B, S, D, K, CL, need, balanced, (cudaStream_t)stream, nullptr);
}

// The clusters of CL blocks that the device holds at once for a call at
// (B, S, D, balanced), into *fit (the plan keeps a call's grid to one such
// wave). Returns 0 or a CUDA error.
extern "C" int gritlm_fused_pool_fit(int B, int S, int D, int CL, int balanced, int* fit) {
  return dispatch(nullptr, B, S, D, B, CL, 1, balanced, nullptr, fit);
}
