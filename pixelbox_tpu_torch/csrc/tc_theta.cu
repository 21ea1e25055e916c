// The θ stage of the threshold scans on Hopper's int8 wgmma, in two
// launches: the θ estimate that replaces
// pixelbox_tpu/ops/pallas_scan.py:_pallas_sample_theta (:589; stage 1, the
// mini-sample, :629-639; stage 2 and its fallback, :641-659) for the u8
// "cosine", the int4 "cosine4a" / "cosine4" and the "hamming" kinds.
//
// What it computes, ops/fused_scan.py's sample_theta_plain bit for bit:
//   θ0    = min(j0-th smallest of {dist < md} over the valid mini rows (the
//           sample's rows 0, stride, 2·stride, ...), md);
//   count = the number of valid sample rows with dist < θ0;
//   θ     = the j-th smallest of those distances when j <= count <= cap,
//           else θ0.
// Only values are selected (a distance's f32 bits order like the value:
// dist >= +0), so row ids play no part.
//
// Design.  A block is one warpgroup (128 threads) and takes NQ queries
// (blockIdx.x) and a part of the rows (blockIdx.y); its row tiles of 64
// come by TMA into a ring, and each tile's product is K1a's / K4a's /
// K2a's on int8 wgmma (tc_operands.cuh: tile_product).  The last block of
// a query tile to finish (a ticket) makes the selects that need every
// part, one warp a query.
// - Launch A (θ0, tc_theta0_kernel): the mini rows come straight out of the
//   sample (a 2-D tensor map whose row pitch is stride × the row's
//   bytes).  Every (query, mini row) pair needs its exact distance: the
//   accumulators go branch-free to a shared stage, from which one warp a
//   query and a lane a row compute the distances (spec_dist, or the
//   Hamming diff × scale) into a shared table of the part's values, +inf
//   where the row is invalid or at or past md; each query's j0 smallest
//   of the part are published, and the last block takes the j0-th of the
//   parts' (θ0).
// - Launch B (stage 2, tc_theta_kernel): K1a's / K2a's collect over the
//   sample under θ0 — phase 1 branch-free on the accumulators (the key
//   bound of θ0 on the exact f32 centered dot, or the exact integer
//   Hamming threshold), phase 2 for its few survivors only (the dot again
//   from the shared tiles, the exact distance, the strict dist < θ0, an
//   append with an atomic count, which stays exact) — then the last block
//   takes the j-th of each query's buffer, or θ0.
// A warp's select (the k-th smallest of a query's values): one bit a step
// from the highest bit where the values differ, each step a count and a
// warp reduction over the values held in registers (up to 32 · 16; more
// from shared or device memory), two queries' steps interleaved.  No
// atomics and no histogram: a histogram's shared atomics serialize on the
// few bins that near-equal distances share.
// No torch op runs between the launches; launch B reads θ0 from launch A's
// output.  Bound: the sample's bytes read once (launch B; the mini rows
// are 1/16 of it), or the 2·Q·S·D int8 product at Q in the thousands.
//
// Plain C interface, bound with ctypes; the entry point returns
// cudaGetLastError() (or kTensorMapError + the driver's code).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_device.cuh"
#include "tc_device.cuh"
#include "tc_operands.cuh"
#include "wgmma_s8.cuh"

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr uint32_t kInfBits = 0x7f800000u;  // +inf: an excluded pair sorts last
constexpr uint32_t kTaken = 0xffffffffu;    // a value a select has taken out
// Pitch (ints) of launch A's stage rows (as the chunk top-k's).
constexpr int kStagePitch = kTileRows + 4;
// Bytes of the TMA ring: 4 tiles of u8 rows at D = 128, 8 of int4 rows, 16
// of hashes.
constexpr int kRingBytes = 32 * 1024;
// Values a launch-A block keeps in shared memory (NQ × its part's rows).
constexpr int kThetaVals = 8192;
constexpr int kThetaWarps = kTcThreads / 32;
// Values a warp of the last block stages in the ring for its selects.
constexpr int kSliceVals = kRingBytes / 4 / kThetaWarps;
// Values a lane holds in registers for a select (32 · 16 a warp).
constexpr int kPrefetch = 16;

__host__ __device__ constexpr int theta_row_bytes(int kind, int d) {
  return kind == kHamming ? kPhBytes : kind == kU8 ? d : kDim4 / 2;
}
__host__ __device__ constexpr int theta_query_bytes(int kind, int d) {
  return kind == kHamming ? kPhK + kPhBytes : kind == kU8 ? d : kDim4;  // Hamming: ±1 and packed
}
__host__ __device__ constexpr int theta_ring(int kind, int d) {
  return kRingBytes / (kTileRows * theta_row_bytes(kind, d));
}

// A query's constants in a block.
struct ThetaQuery {
  float th;    // the strict threshold: md (launch A) or θ0 (launch B)
  float u;     // cosine kinds: key_bound(th)
  float z;     // launch B, cosine kinds: the query's part of the phase-1 centered dot
  int thr;     // launch B, Hamming: the phase-1 threshold of the ±1 product
  float qr, qm2f;
  int qs;
};

// Shared-memory layout (byte offsets from a 1024-aligned base): the
// queries' B operand (Hamming: the ±1 tile, then the packed queries), the
// ring (after the row tiles, the last block's selects stage their values
// there: kSliceVals a warp), launch A's two stages [NQ][68] of products
// and value table [NQ][vals_rows], the queries' constants, the selects'
// results [NQ], the mbarriers and the ticket's flag.
struct ThetaSmem {
  int q, rows, stage, vals, qv, kth, bars, flag, total;
  __host__ __device__ ThetaSmem(int kind, int nq, int d, int vals_rows, bool staged)
      : q(0),
        rows(round_up(nq * theta_query_bytes(kind, d), 1024)),
        stage(rows + kRingBytes),
        vals(stage + (staged ? 2 * nq * kStagePitch * 4 : 0)),
        qv(vals + nq * vals_rows * 4),
        kth(qv + nq * static_cast<int>(sizeof(ThetaQuery))),
        bars(round_up(kth + nq * 4, 8)),
        flag(bars + (theta_ring(kind, d) + 1) * 8),
        total(flag + 8) {}
};

struct ThetaArgs {
  const uint8_t* q_bytes;  // Hamming: queries [Q, 32]
  const int* q_sum;        // cosine kinds: the queries' code sums, mag2, rsqrt [Q]
  const int* q_mag2;
  const float* qr;
  const int* meta;         // cosine kinds: the sample's meta [4, S]
  const uint8_t* row_ok;   // Hamming: the sample's row mask [S]
  int Q, S, D;
  int n, step;             // rows this launch scans (s0 or S), sample rows between two
  int limit, wrap;         // Hamming: the byte limit and the u8 wrap
  float scale;             // Hamming: f32(1 / (8 · limit))
  float md;
  float key_scale, saturation, key_loose;  // key_bound's constants
  int j0, j, cap;
  int parts, tpp;          // the launch's parts of the rows and row tiles a part
  int vals_rows;           // launch A: rows of the value table (tpp · 64)
  int* tickets;            // a query tile's finished blocks (zeroed)
  int* count;              // launch B: [Q] rows under θ0 (zeroed)
  uint32_t* part_vals;     // launch A: each part's j0 smallest [Q, parts, j0]
  uint32_t* cand;          // launch B: the distances under θ0 [Q, cap]
  float* theta0;           // launch A's output, launch B's input [Q]
  float* theta;            // launch B's output [Q]
};

// ---- A warp's select

// The k-th smallest (1 <= k <= n) of the n u32 values at v, by one warp:
// MSB first, one bit a step from the highest bit where the values differ,
// each step counting (one warp reduction) the values that match the bits
// decided so far and have a 0 at this bit.  kGlobal: v is device memory
// other blocks wrote (read through L2).
template <bool kGlobal>
__device__ uint32_t warp_kth_bits(const uint32_t* v, int n, int k) {
  const int lane = threadIdx.x & 31;
  auto at = [&](int i) -> uint32_t {
    if constexpr (kGlobal) return __ldcg(v + i);
    else return v[i];
  };
  uint32_t lo = 0xffffffffu, hi = 0u;
  for (int i = lane; i < n; i += 32) {
    const uint32_t x = at(i);
    lo = min(lo, x);
    hi = max(hi, x);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lo == hi) return lo;
  const int top = 31 - __clz(static_cast<int>(lo ^ hi));  // every value shares lo's bits above it
  uint32_t prefix = top == 31 ? 0u : lo & ~((2u << top) - 1u);
  int rank = k;
  for (int b = top; b >= 0; --b) {
    int c = 0;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) c += ((at(i) ^ prefix) >> b) == 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    if (c < rank) {
      rank -= c;
      prefix |= 1u << b;
    }
  }
  return prefix;
}

// The k-th smallest of each of G queries' values held in registers, M a
// lane (query g's value 32u + lane in x[g][u]; slots at or past n[g] hold
// kTaken, above every value), by one warp: warp_kth_bits without a memory
// access, the G queries' steps interleaved so that their reductions
// overlap (a lone warp on a scheduler otherwise waits out each step's
// latency).  t[g]: the k-th, or +inf bits where n[g] < k.
template <int G, int M>
__device__ void warp_kth_regs(const uint32_t (&x)[G][M], const int (&n)[G], int k, uint32_t (&t)[G]) {
  const int lane = threadIdx.x & 31;
  uint32_t lo[G], hi[G], prefix[G];
  int top[G], rank[G], b0 = -1;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lo[g] = 0xffffffffu;
    hi[g] = 0u;
#pragma unroll
    for (int u = 0; u < M; ++u) {
      lo[g] = min(lo[g], x[g][u]);
      if (32 * u + lane < n[g]) hi[g] = max(hi[g], x[g][u]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lo[g] = __reduce_min_sync(0xffffffffu, lo[g]);
    hi[g] = __reduce_max_sync(0xffffffffu, hi[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // Every value shares lo's bits above top; the steps start there.
    top[g] = n[g] < k || lo[g] == hi[g] ? -1 : 31 - __clz(static_cast<int>(lo[g] ^ hi[g]));
    prefix[g] = top[g] < 0 ? lo[g] : top[g] == 31 ? 0u : lo[g] & ~((2u << top[g]) - 1u);
    rank[g] = k;
    b0 = max(b0, top[g]);
  }
  for (int b = b0; b >= 0; --b) {
    int c[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c[g] = 0;
#pragma unroll
      for (int u = 0; u < M; ++u) c[g] += ((x[g][u] ^ prefix[g]) >> b) == 0u;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) c[g] = __reduce_add_sync(0xffffffffu, c[g]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (b <= top[g] && c[g] < rank[g]) {
        rank[g] -= c[g];
        prefix[g] |= 1u << b;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) t[g] = n[g] < k ? kInfBits : prefix[g];
}

// Query g's first 32 · M of n[g] values at v[g] into registers (kTaken past
// n[g]); kGlobal: device memory other blocks wrote (read through L2).
template <bool kGlobal, int G, int M>
__device__ void load_regs(const uint32_t* const (&v)[G], const int (&n)[G], uint32_t (&x)[G][M]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int i = 32 * u + lane;
      x[g][u] = kTaken;
      if (i < n[g]) {
        if constexpr (kGlobal) x[g][u] = __ldcg(v[g] + i);
        else x[g][u] = v[g][i];
      }
    }
  }
}

// The k-th smallest of each of G queries' n[g] values at v[g] (+inf bits
// where n[g] < k), by one warp: in registers, 4, 8 or 16 a lane as the
// larger n asks (the select's work follows the registers it scans); past
// 32 · kPrefetch values, one query at a time from memory (kGlobal: device
// memory other blocks wrote, staged through the warp's slice of shared
// memory, kSliceVals values, when it fits).
template <bool kGlobal, int G>
__device__ void select_group(const uint32_t* const (&v)[G], const int (&n)[G], int k, uint32_t* slice,
                             uint32_t (&t)[G]) {
  const int lane = threadIdx.x & 31;
  int most = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) most = max(most, n[g]);
  if (most <= 4 * 32) {
    uint32_t x[G][4];
    load_regs<kGlobal>(v, n, x);
    warp_kth_regs(x, n, k, t);
  } else if (most <= 8 * 32) {
    uint32_t x[G][8];
    load_regs<kGlobal>(v, n, x);
    warp_kth_regs(x, n, k, t);
  } else if (most <= kPrefetch * 32) {
    uint32_t x[G][kPrefetch];
    load_regs<kGlobal>(v, n, x);
    warp_kth_regs(x, n, k, t);
  } else {
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      t[g] = kInfBits;
      if (n[g] < k) continue;
      if (!kGlobal) {
        t[g] = warp_kth_bits<false>(v[g], n[g], k);
      } else if (n[g] <= kSliceVals) {
        for (int i = lane; i < n[g]; i += 32) slice[i] = __ldcg(v[g] + i);
        __syncwarp();
        t[g] = warp_kth_bits<false>(slice, n[g], k);
        __syncwarp();  // the slice is read before the next query's values go there
      } else {
        t[g] = warp_kth_bits<true>(v[g], n[g], k);
      }
    }
  }
}

// The last block's selects, one warp for queries c = warp, warp + 4, ..:
// the k-th smallest of query c's n(c) values at src(c) (device memory
// other blocks wrote, read through L2), or +inf bits where n(c) < k, into
// out[c].  The counts come first, all at once (into out); then two
// queries at a time (select_group).
template <int NQ, typename Src, typename Count>
__device__ void last_block_selects(int q0, int Q, int k, uint32_t* slice, Src src, Count count,
                                   uint32_t* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < NQ; c += kTcThreads) out[c] = q0 + c < Q ? count(c) : 0;
  __syncthreads();
  auto live = [&](int c) { return c < NQ && q0 + c < Q; };
  for (int c0 = warp; live(c0); c0 += 2 * kThetaWarps) {
    const int c1 = c0 + kThetaWarps;
    uint32_t t[2];
    if (live(c1)) {
      const uint32_t* v[2] = {src(c0), src(c1)};
      const int n[2] = {static_cast<int>(out[c0]), static_cast<int>(out[c1])};
      select_group<true>(v, n, k, slice, t);
    } else {
      const uint32_t* v[1] = {src(c0)};
      const int n[1] = {static_cast<int>(out[c0])};
      uint32_t t1[1];
      select_group<true>(v, n, k, slice, t1);
      t[0] = t1[0];
    }
    __syncwarp();  // every lane has read the counts before the results replace them
    if (lane == 0) {
      out[c0] = t[0];
      if (live(c1)) out[c1] = t[1];
    }
  }
}

// ---- The blocks' common parts

// The block's set-up: the mbarriers, the queries' B operand (Hamming:
// expanded to ±1 here, with a packed copy; the cosine kinds: by TMA), the
// first ring tiles, and each query's constants (th: md or θ0).
struct ThetaBlock {
  uint8_t* q_tile;
  uint8_t* rows;
  uint64_t* full;
  ThetaQuery* qv;
  int q0, tile0, nt, ring, rb;
};

template <int NQ, int KIND>
__device__ void issue_tile(const CUtensorMap* rows_map, const ThetaBlock& b, int t, int d) {
  const int s = t % b.ring;
  uint8_t* dst = b.rows + s * kTileRows * b.rb;
  mbar_expect_tx(b.full + s, kTileRows * b.rb);
  if constexpr (KIND == kU8) {
    const int cb = row_chunk(d);
    for (int c = 0; c < d / cb; ++c)
      tma_load_2d(dst + c * kTileRows * cb, rows_map, b.full + s, c * cb, (b.tile0 + t) * kTileRows);
  } else {
    tma_load_2d(dst, rows_map, b.full + s, 0, (b.tile0 + t) * kTileRows);
  }
}

template <int NQ, int KIND, bool kStage2>
__device__ void theta_setup(const CUtensorMap* rows_map, const CUtensorMap* q_map, const ThetaArgs& a,
                            const ThetaBlock& b) {
  constexpr bool kHam = KIND == kHamming;
  const int tid = threadIdx.x;
  uint64_t* qbar = b.full + b.ring;
  if (tid == 0) {
    for (int s = 0; s <= b.ring; ++s) mbar_init(b.full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (!kHam) {
      const int cb = row_chunk(a.D);
      mbar_expect_tx(qbar, NQ * a.D);
      for (int c = 0; c < a.D / cb; ++c) tma_load_2d(b.q_tile + c * NQ * cb, q_map, qbar, c * cb, b.q0);
    }
    for (int t = 0; t < min(b.ring, b.nt); ++t) issue_tile<NQ, KIND>(rows_map, b, t, a.D);
  }
  if constexpr (kHam) stage_pm1_queries<NQ>(a.q_bytes, b.q0, a.Q, a.limit, b.q_tile, b.q_tile + NQ * kPhK);
  for (int c = tid; c < NQ; c += kTcThreads) {
    const int q = b.q0 + c;
    // Padding queries: nothing passes (z = 0, u = +inf; thr below every product).
    ThetaQuery v{0.0f, __int_as_float(0x7f800000), 0.0f, kStage2 && kHam && !a.wrap ? 0x7fffffff : 0,
                 0.0f, 0.0f, 0};
    if (q < a.Q) {
      v.th = kStage2 ? a.theta0[q] : a.md;
      if constexpr (kHam) {
        // Launch B's exact integer filter (K2a's): T = #{d : fl(d · scale)
        // < θ0}; unwrapped diff < T ⟺ product > 8·limit − 2T, wrapped the
        // kernel compares (diff & 255) < T.
        const int bits = 8 * a.limit;
        const int t = hamming_pass_count(v.th, a.wrap ? min(bits, 255) : bits, a.scale);
        v.thr = a.wrap ? t : bits - 2 * t;
      } else {
        const int qs = a.q_sum[q];
        v.qr = a.qr[q];
        v.qm2f = __int2float_rn(a.q_mag2[q]);
        v.qs = qs;
        v.u = key_bound(v.th, v.qr, a.key_scale, a.saturation, a.key_loose);
        if constexpr (KIND == kU8)
          v.z = __fsub_rn(__int2float_rn(2 * qs + a.D), kMagic2);
        else if constexpr (KIND == kInt4Asym)
          v.z = __int_as_float(kMagic2Bits - 255 * qs - 255 * (a.D / 2));
        else
          v.z = __int_as_float(kMagic2Bits - 4335 * qs + 65025 * (a.D / 2));
      }
    }
    b.qv[c] = v;
  }
  if constexpr (kHam) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // ±1 tile -> wgmma
  __syncthreads();
  if constexpr (!kHam) mbar_wait(qbar, 0);
}

// The product of tile t of the ring (once it has landed) into acc, issued
// asynchronously: the caller waits for it (wgmma_wait0).
template <int NQ, int KIND>
__device__ __forceinline__ void theta_product(int (&acc)[NQ / 2], const ThetaBlock& b, int t, int r0, int tq,
                                              int d) {
  const int s = t % b.ring;
  mbar_wait(b.full + s, (t / b.ring) & 1);
  tile_product<NQ, KIND>(acc, b.rows + s * kTileRows * b.rb, r0, tq, smem_u32(b.q_tile), d);
}

// The ticket: true in the last block of the query tile to finish (every
// thread), after the block's writes are visible to it.
__device__ bool last_of_tile(int* tickets, int parts, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(tickets + blockIdx.x, 1) == parts - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ---- Launch A: θ0 over the mini rows

// A lane's two rows of a tile (32h + lane): validity and, for the cosine
// kinds, what the distance needs.
struct ThetaRows {
  bool ok[2];
  int rs[2];
  float rr[2], m2f[2];
};

template <int NQ, int KIND>
__global__ void __launch_bounds__(kTcThreads)
tc_theta0_kernel(const __grid_constant__ CUtensorMap rows_map, const __grid_constant__ CUtensorMap q_map,
                 const ThetaArgs a) {
  extern __shared__ uint8_t tc_smem_raw[];
  constexpr bool kHam = KIND == kHamming;
  const ThetaSmem L(KIND, NQ, a.D, a.vals_rows, true);
  uint8_t* sm = align_smem(tc_smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  ThetaBlock b{sm + L.q, sm + L.rows, reinterpret_cast<uint64_t*>(sm + L.bars),
               reinterpret_cast<ThetaQuery*>(sm + L.qv), static_cast<int>(blockIdx.x) * NQ,
               static_cast<int>(blockIdx.y) * a.tpp, 0, theta_ring(KIND, a.D), theta_row_bytes(KIND, a.D)};
  b.nt = max(0, min(a.tpp, tiles - b.tile0));
  int* stage = reinterpret_cast<int*>(sm + L.stage);
  uint32_t* vals = reinterpret_cast<uint32_t*>(sm + L.vals);
  theta_setup<NQ, KIND, false>(&rows_map, &q_map, a, b);

  // Rows 32h + lane of tile t (mini row r is sample row r · step).
  auto load_rows = [&](int t, ThetaRows& rv) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (b.tile0 + t) * kTileRows + 32 * h + lane;
      const bool in = t < b.nt && r < a.n;
      const size_t sr = static_cast<size_t>(in ? r : 0) * a.step;
      if constexpr (kHam) {
        rv.ok[h] = in && __ldg(a.row_ok + sr) != 0;
      } else {
        const int mag2 = in ? __ldg(a.meta + static_cast<size_t>(a.S) + sr) : 0;
        rv.ok[h] = mag2 > 0;
        rv.rs[h] = in ? __ldg(a.meta + sr) : 0;
        rv.rr[h] = in ? __int_as_float(__ldg(a.meta + 2 * static_cast<size_t>(a.S) + sr)) : 0.0f;
        rv.m2f[h] = __int2float_rn(mag2);
      }
    }
  };

  const int r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  const int bits = 8 * a.limit;
  int acc[NQ / 2];
  ThetaRows cur, nxt;
  load_rows(0, nxt);
  if (b.nt > 0) theta_product<NQ, KIND>(acc, b, 0, r0, tq, a.D);
  for (int t = 0; t < b.nt; ++t) {
    int* st = stage + (t & 1) * NQ * kStagePitch;  // two tiles' stages alternate
    cur = nxt;
    if (t + 1 < b.nt) load_rows(t + 1, nxt);
    // The accumulators, branch-free, to the stage (their only reader).
    wgmma_wait0();
    fence_regs(acc);
#pragma unroll
    for (int jj = 0; jj < NQ / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int h = 0; h < 2; ++h) st[(8 * jj + 2 * tq + e) * kStagePitch + r0 + 8 * h] = acc[4 * jj + 2 * h + e];
      }
    }
    // The tile is staged and its slot read: refill the slot; the next
    // tile's product runs on the tensor cores under this one's distances.
    __syncthreads();
    if (tid == 0 && t + b.ring < b.nt) issue_tile<NQ, KIND>(&rows_map, b, t + b.ring, a.D);
    if (t + 1 < b.nt) theta_product<NQ, KIND>(acc, b, t + 1, r0, tq, a.D);
    // Every pair's exact distance, one warp a query and a lane a row, into
    // the part's value table (+inf where the row is invalid or at/past md).
#pragma unroll
    for (int i = 0; i < NQ / kThetaWarps; ++i) {
      const int c = warp + kThetaWarps * i;
      const ThetaQuery v = b.qv[c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = st[c * kStagePitch + 32 * h + lane];
        float dist;
        if constexpr (kHam)
          dist = hamming_dist((bits - x) >> 1, a.wrap, a.scale);  // the ±1 product is bits − 2·diff
        else
          dist = spec_dist(centered_dot<KIND>(x, v.qs, cur.rs[h], a.D), v.qr, cur.rr[h], v.qm2f, cur.m2f[h]);
        vals[c * a.vals_rows + t * kTileRows + 32 * h + lane] =
            cur.ok[h] && dist < v.th ? __float_as_uint(dist) : kInfBits;
      }
    }
  }
  __syncthreads();

  // Each query's j0 smallest of the part (kk = min(j0, rows) of them, then
  // +inf up to j0), published for the last block.
  const int part_n = max(0, min(b.nt * kTileRows, a.n - b.tile0 * kTileRows));
  const int kk = min(a.j0, part_n);
  // The kk-th of two queries at a time (select_group), then each query's
  // values below it and the kk-th up to kk.
  auto publish = [&](int c, uint32_t T) {
    const uint32_t* v = vals + c * a.vals_rows;
    uint32_t* out = a.part_vals + (static_cast<size_t>(b.q0 + c) * a.parts + blockIdx.y) * a.j0;
    int m = 0;
    for (int i0 = 0; i0 < part_n; i0 += 32) {
      const int i = i0 + lane;
      const bool take = i < part_n && v[i] < T;
      const unsigned bal = __ballot_sync(0xffffffffu, take);
      if (take) out[m + __popc(bal & ((1u << lane) - 1u))] = v[i];
      m += __popc(bal);
    }
    for (int i = m + lane; i < kk; i += 32) out[i] = T;
    for (int i = kk + lane; i < a.j0; i += 32) out[i] = kInfBits;
  };
  uint32_t* slice = reinterpret_cast<uint32_t*>(b.rows) + warp * kSliceVals;  // the ring is free now
  for (int c0 = warp; c0 < NQ && b.q0 + c0 < a.Q; c0 += 2 * kThetaWarps) {
    const int c1 = c0 + kThetaWarps;
    if (c1 < NQ && b.q0 + c1 < a.Q) {
      const uint32_t* v[2] = {vals + c0 * a.vals_rows, vals + c1 * a.vals_rows};
      const int n[2] = {part_n, part_n};
      uint32_t T[2];
      select_group<false>(v, n, kk, nullptr, T);
      publish(c0, T[0]);
      publish(c1, T[1]);
    } else {
      const uint32_t* v[1] = {vals + c0 * a.vals_rows};
      const int n[1] = {part_n};
      uint32_t T[1];
      select_group<false>(v, n, kk, nullptr, T);
      publish(c0, T[0]);
    }
  }

  if (!last_of_tile(a.tickets, a.parts, reinterpret_cast<int*>(sm + L.flag))) return;
  uint32_t* kth = reinterpret_cast<uint32_t*>(sm + L.kth);
  const int n = a.parts * a.j0;
  last_block_selects<NQ>(
      b.q0, a.Q, a.j0, slice, [&](int c) { return a.part_vals + static_cast<size_t>(b.q0 + c) * n; },
      [&](int) { return n; }, kth);
  __syncthreads();
  for (int c = tid; c < NQ && b.q0 + c < a.Q; c += kTcThreads) {
    const float t = __uint_as_float(kth[c]);
    a.theta0[b.q0 + c] = t < a.md ? t : a.md;  // +inf (fewer than j0 under md) -> md
  }
}

// ---- Launch B: the sample's rows under θ0, and θ

template <int NQ, int KIND>
__global__ void __launch_bounds__(kTcThreads)
tc_theta_kernel(const __grid_constant__ CUtensorMap rows_map, const __grid_constant__ CUtensorMap q_map,
                const ThetaArgs a) {
  extern __shared__ uint8_t tc_smem_raw[];
  constexpr bool kHam = KIND == kHamming;
  const ThetaSmem L(KIND, NQ, a.D, 0, false);
  uint8_t* sm = align_smem(tc_smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  ThetaBlock b{sm + L.q, sm + L.rows, reinterpret_cast<uint64_t*>(sm + L.bars),
               reinterpret_cast<ThetaQuery*>(sm + L.qv), static_cast<int>(blockIdx.x) * NQ,
               static_cast<int>(blockIdx.y) * a.tpp, 0, theta_ring(KIND, a.D), theta_row_bytes(KIND, a.D)};
  b.nt = max(0, min(a.tpp, tiles - b.tile0));
  theta_setup<NQ, KIND, true>(&rows_map, &q_map, a, b);
  const int8_t* q_codes = reinterpret_cast<const int8_t*>(b.q_tile);
  const uint8_t* q_raw = b.q_tile + NQ * kPhK;  // Hamming: the packed queries [NQ][32]

  // This thread's accumulator rows r0 and r0 + 8 of a tile: K1a's meta
  // registers (row_sum, mag2, rr), or K2a's row mask, one tile ahead.
  const int r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  auto load_meta = [&](int t, int (&m)[2][3]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (b.tile0 + t) * kTileRows + r0 + 8 * h;
      const bool in = t < b.nt && row < a.n;
      if constexpr (kHam) {
        m[h][0] = in ? __ldg(a.row_ok + row) : 0;
        m[h][1] = m[h][2] = 0;
      } else {
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) m[h][jj] = in ? __ldg(a.meta + static_cast<size_t>(jj) * a.S + row) : 0;
      }
    }
  };
  int meta_next[2][3];
  load_meta(0, meta_next);
  const uint32_t q_addr = smem_u32(b.q_tile);
  const float nan = __int_as_float(0x7fc00000);
  const int bits = 8 * a.limit;
  int acc[NQ / 2];

  for (int t = 0; t < b.nt; ++t) {
    int rsum[2], rmag[2], rc[2];
    float rr[2], rr_key[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] = meta_next[h][0];
      rmag[h] = meta_next[h][1];
      rr[h] = __int_as_float(meta_next[h][2]);
      ok[h] = kHam ? meta_next[h][0] != 0 : rmag[h] > 0;
      rr_key[h] = rmag[h] > 0 ? rr[h] : nan;  // invalid rows and rows past n: every key test fails
      if constexpr (KIND == kU8)
        rc[h] = kMagic2Bits + rsum[h];
      else if constexpr (KIND == kInt4Asym)
        rc[h] = __float_as_int(__fsub_rn(__int2float_rn(34 * rsum[h]), kMagic2));
      else
        rc[h] = -4335 * rsum[h];
    }
    if (t + 1 < b.nt) load_meta(t + 1, meta_next);
    const int s = t % b.ring;
    const uint8_t* tile = b.rows + s * kTileRows * b.rb;
    mbar_wait(b.full + s, (t / b.ring) & 1);
    tile_product<NQ, KIND>(acc, tile, r0, tq, q_addr, a.D);
    wgmma_wait0();
    fence_regs(acc);

    // Phase 1, branch-free and the only reader of the accumulators: K1a's
    // key bound of θ0 on the exact f32 centered dot (tc_scan.cu's note),
    // or K2a's exact integer threshold, into a bit mask (bit p = pair p).
    uint32_t pass[(NQ + 31) / 32] = {};
#pragma unroll
    for (int jj = 0; jj < NQ / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const ThetaQuery& v = b.qv[8 * jj + 2 * tq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 4 * jj + 2 * h + e;
          bool hit;
          if constexpr (kHam) {
            hit = ok[h] && (a.wrap ? ((((bits - acc[p]) >> 1) & 255) < v.thr) : (acc[p] > v.thr));
          } else {
            float dc;
            if constexpr (KIND == kU8)
              dc = __fadd_rn(__int_as_float(2 * acc[p] + rc[h]), v.z);
            else if constexpr (KIND == kInt4Asym)
              dc = __fadd_rn(__int_as_float(34 * acc[p] + __float_as_int(v.z)), __int_as_float(rc[h]));
            else
              dc = __fadd_rn(__int_as_float(578 * acc[p] + __float_as_int(v.z) + rc[h]), -kMagic2);
            hit = __fmul_rn(dc, rr_key[h]) > v.u;
          }
          pass[p / 32] |= static_cast<uint32_t>(hit) << (p % 32);
        }
      }
    }
    // Phase 2, rare: each survivor's dot again from the shared tiles (exact
    // integers), its distance and the strict dist < θ0; an append to the
    // query's buffer (the slot claimed before the capacity check, so the
    // count stays exact).
#pragma unroll
    for (int pw = 0; pw < (NQ + 31) / 32; ++pw) {
      for (uint32_t m = pass[pw]; m != 0; m &= m - 1) {
        const int p = 32 * pw + __ffs(m) - 1;
        const int h = (p >> 1) & 1, c = 8 * (p >> 2) + 2 * tq + (p & 1), r = r0 + 8 * h;
        const ThetaQuery& v = b.qv[c];
        float dist;
        if constexpr (kHam) {
          int diff[1];
          row_popc<1>(tile + r * kPhBytes, q_raw + c * kPhBytes, kPhBytes, a.limit, diff);
          dist = hamming_dist(diff[0], a.wrap, a.scale);
        } else {
          int dot8;
          if constexpr (KIND == kU8)
            dot8 = tile_dot8(reinterpret_cast<const int8_t*>(tile), r, q_codes, NQ, c, a.D, row_chunk(a.D));
          else
            dot8 = tile_dot4(tile, r, q_codes, c);
          dist = spec_dist(centered_dot<KIND>(dot8, v.qs, rsum[h], a.D), v.qr, rr[h], v.qm2f,
                           __int2float_rn(rmag[h]));
        }
        if (dist < v.th) {
          const int q = b.q0 + c;
          const int slot = atomicAdd(a.count + q, 1);
          if (slot < a.cap) a.cand[static_cast<size_t>(q) * a.cap + slot] = __float_as_uint(dist);
        }
      }
    }
    // The slot is read (wgmma, phase 2): refill it.
    __syncthreads();
    if (tid == 0 && t + b.ring < b.nt) issue_tile<NQ, KIND>(&rows_map, b, t + b.ring, a.D);
  }

  if (!last_of_tile(a.tickets, a.parts, reinterpret_cast<int*>(sm + L.flag))) return;
  // θ needs the j-th only where j <= count <= cap (else it is θ0): a query
  // outside that selects nothing.
  uint32_t* kth = reinterpret_cast<uint32_t*>(sm + L.kth);
  last_block_selects<NQ>(
      b.q0, a.Q, a.j, reinterpret_cast<uint32_t*>(b.rows) + warp * kSliceVals,
      [&](int c) { return a.cand + static_cast<size_t>(b.q0 + c) * a.cap; },
      [&](int c) {
        const int cnt = __ldcg(a.count + b.q0 + c);
        return cnt <= a.cap ? cnt : 0;
      },
      kth);
  __syncthreads();
  for (int c = tid; c < NQ && b.q0 + c < a.Q; c += kTcThreads)
    a.theta[b.q0 + c] = kth[c] == kInfBits ? a.theta0[b.q0 + c] : __uint_as_float(kth[c]);
}

// ---- Host side

template <int NQ, int KIND, int STAGE>
int launch_theta(const CUtensorMap& rows, const CUtensorMap& qm, const ThetaArgs& a, int n_qt,
                 cudaStream_t stream) {
  auto kernel = STAGE == 0 ? tc_theta0_kernel<NQ, KIND> : tc_theta_kernel<NQ, KIND>;
  const int rc = allow_smem(kernel);
  if (rc != 0) return rc;
  const size_t smem = ThetaSmem(KIND, NQ, a.D, STAGE == 0 ? a.vals_rows : 0, STAGE == 0).total + 1024;
  kernel<<<dim3(n_qt, a.parts), kTcThreads, smem, stream>>>(rows, qm, a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_stage(int stage, int nq, const CUtensorMap& rows, const CUtensorMap& qm, const ThetaArgs& a,
                 cudaStream_t st) {
  const int n_qt = (a.Q + nq - 1) / nq;
  switch (stage * 1000 + nq) {
    case 8: return launch_theta<8, KIND, 0>(rows, qm, a, n_qt, st);
    case 32: return launch_theta<32, KIND, 0>(rows, qm, a, n_qt, st);
    case 1008: return launch_theta<8, KIND, 1>(rows, qm, a, n_qt, st);
    case 1016: return launch_theta<16, KIND, 1>(rows, qm, a, n_qt, st);
    case 1032: return launch_theta<32, KIND, 1>(rows, qm, a, n_qt, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_kind(int kind, int stage, int nq, const CUtensorMap& rows, const CUtensorMap& qm,
                const ThetaArgs& a, cudaStream_t st) {
  switch (kind) {
    case kU8: return launch_stage<kU8>(stage, nq, rows, qm, a, st);
    case kInt4Asym: return launch_stage<kInt4Asym>(stage, nq, rows, qm, a, st);
    case kInt4Sym: return launch_stage<kInt4Sym>(stage, nq, rows, qm, a, st);
    case kHamming: return launch_stage<kHamming>(stage, nq, rows, qm, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A launch's rows: n rows of the sample, `step` sample rows apart.
int encode_rows(CUtensorMap* map, int kind, const void* data, int d, int n, int step) {
  const int rb = theta_row_bytes(kind, d);
  if (kind == kU8) {
    const int cb = row_chunk(d);
    return encode_map(map, 2, data, d, n, static_cast<uint64_t>(step) * d, cb, kTileRows,
                      cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  return encode_map(map, 2, data, rb, n, static_cast<uint64_t>(step) * rb, rb, kTileRows,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

bool plan_ok(int n, int parts, int tpp) {
  const int tiles = (n + kTileRows - 1) / kTileRows;
  return parts >= 1 && tpp >= 1 && static_cast<long long>(parts - 1) * tpp < tiles &&
         static_cast<long long>(parts) * tpp >= tiles && parts <= 65535;
}

}  // namespace

// The θ stage: kind 0 (u8 rows int8 [S, D], D = 32, 64 or 128), 1 / 2 (int4
// asym / sym, packed rows uint8 [S, 64], D = 128), both with meta int32 [4,
// S] and queries int8 [Q, D] (16-byte aligned) with their q_sum, q_mag2
// and qr; or 3 (Hamming: rows uint8 [S, 32], meta the row mask uint8 [S],
// queries uint8 [Q, 32] as q_codes, limit <= 32).  The mini rows are rows
// 0, stride, .. of the sample (s0 of them); j0 and j the ranks, cap the
// stage-2 buffer.  Launch A takes query tiles of nq0 (8 or 32) × parts0
// parts of tpp0 tiles, launch B nq1 (8, 16 or 32) × parts1 of tpp1.  ws:
// int32 [ceil(Q / nq0) + ceil(Q / nq1) + Q], zeroed (the two launches'
// tickets, then the counts); part_vals u32 [Q, parts0, j0]; cand u32 [Q,
// cap]; theta0 and theta f32 [Q] (the outputs).
PX_EXPORT int px_tc_sample_theta(const void* q_codes, const void* q_sum, const void* q_mag2,
                                 const void* qr, const void* data, const void* meta, int Q, int S,
                                 int D, int kind, int stride, int s0, int j0, int j, int cap, float md,
                                 int limit, int wrap, float scale, float key_scale, float saturation,
                                 float key_loose, int nq0, int parts0, int tpp0, int nq1, int parts1,
                                 int tpp1, void* ws, void* part_vals, void* cand, void* theta0,
                                 void* theta, void* stream) {
  const bool kind_ok = kind == kU8 ? (D == 32 || D == 64 || D == 128)
                       : kind == kHamming ? D == kPhBytes && limit > 0 && limit <= kPhBytes
                                          : (kind == kInt4Asym || kind == kInt4Sym) && D == kDim4;
  if (!kind_ok || Q <= 0 || S <= 0 || stride < 1 || s0 < 1 || static_cast<long long>(s0 - 1) * stride >= S ||
      j0 < 1 || j < 1 || cap < 1 || !plan_ok(s0, parts0, tpp0) || !plan_ok(S, parts1, tpp1) || nq0 * tpp0 * kTileRows > kThetaVals)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap rows_a, rows_b, q_a, q_b;
  int rc = encode_rows(&rows_a, kind, data, D, s0, stride);
  if (rc == 0) rc = encode_rows(&rows_b, kind, data, D, S, 1);
  if (kind != kHamming) {
    const int cb = row_chunk(D);
    const CUtensorMapSwizzle sw = cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
    if (rc == 0) rc = encode_map(&q_a, 2, q_codes, D, Q, D, cb, nq0, sw);
    if (rc == 0) rc = encode_map(&q_b, 2, q_codes, D, Q, D, cb, nq1, sw);
  } else {
    q_a = rows_a;  // unused: the Hamming queries are expanded in the kernel
    q_b = rows_b;
  }
  if (rc != 0) return rc;
  const int n_qt0 = (Q + nq0 - 1) / nq0, n_qt1 = (Q + nq1 - 1) / nq1;
  int* w = static_cast<int*>(ws);
  ThetaArgs a{};
  a.q_bytes = kind == kHamming ? static_cast<const uint8_t*>(q_codes) : nullptr;
  a.q_sum = static_cast<const int*>(q_sum);
  a.q_mag2 = static_cast<const int*>(q_mag2);
  a.qr = static_cast<const float*>(qr);
  a.meta = kind == kHamming ? nullptr : static_cast<const int*>(meta);
  a.row_ok = kind == kHamming ? static_cast<const uint8_t*>(meta) : nullptr;
  a.Q = Q;
  a.S = S;
  a.D = D;
  a.limit = limit;
  a.wrap = wrap;
  a.scale = scale;
  a.md = md;
  a.key_scale = key_scale;
  a.saturation = saturation;
  a.key_loose = key_loose;
  a.j0 = j0;
  a.j = j;
  a.cap = cap;
  a.count = w + n_qt0 + n_qt1;
  a.part_vals = static_cast<uint32_t*>(part_vals);
  a.cand = static_cast<uint32_t*>(cand);
  a.theta0 = static_cast<float*>(theta0);
  a.theta = static_cast<float*>(theta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ThetaArgs b = a;
  a.n = s0;
  a.step = stride;
  a.parts = parts0;
  a.tpp = tpp0;
  a.vals_rows = tpp0 * kTileRows;
  a.tickets = w;
  rc = launch_kind(kind, 0, nq0, rows_a, q_a, a, st);
  if (rc != 0) return rc;
  b.n = S;
  b.step = 1;
  b.parts = parts1;
  b.tpp = tpp1;
  b.tickets = w + n_qt0;
  return launch_kind(kind, 1, nq1, rows_b, q_b, b, st);
}
