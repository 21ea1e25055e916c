// Hopper (sm_90a) tensor-core kernels on int8 wgmma: the collects K1a (u8
// cosine rows, selecting on the spec distance), K4a (packed int4 rows, the
// asymmetric and symmetric int4 metrics) and K2a (packed phash rows,
// Hamming), and the exact chunk top-k K1b (u8), K2b (Hamming) and K4b
// (int4), below.  The TMA, mbarrier and wgmma machinery is tc_device.cuh's.
//
// They replace pixelbox_tpu/ops/pallas_scan.py:_threshold_kernel with the
// buffer select (distances in _kind_dist_tile :119) for the u8 "cosine",
// the int4 "cosine4a" / "cosine4" and the "hamming" kinds, in the θ stage
// (_pallas_sample_theta :589) and the main pass
// (pallas_threshold_scan_topk_v2 :979, the buffer select :951,
// pixelbox_tpu/ops/int4.py:pallas_threshold4_scan_topk :376,
// pallas_hamming_threshold_scan_topk(_v2) :1012 / :1047).  The TPU kernel
// multiplied on its matrix unit; the first port (fused_scan.cu
// threshold_collect_kernel / hamming_collect_kernel, kept there as timing
// references and for the widths these kernels do not take) multiplied
// with __dp4a / __popc, one thread a row against 32 staged queries, and
// was bound by the integer ALU at ~35-42x its bound.
//
// Design (both kernels):
// - One warpgroup (128 threads) a block, a persistent grid of about the
//   blocks that fit on the SMs, each block walking row tiles of 64 (the
//   wgmma M) with stride gridDim.x.  Up to 256 queries (the wgmma N, Q
//   padded up to 8/32/64/128/256) are staged once per block in shared
//   memory; Q > 256 loops over query tiles inside the block, so the rows
//   are read from device memory once per 256 queries.
// - Row tiles arrive by TMA into a ring of shared-memory slots (kStages,
//   K2a kHamStages), each completing on its own mbarrier; thread 0 refills
//   a slot once the warpgroup is done with its tile, so the other slots'
//   tiles are in flight while the tensor cores and the epilogue work.
// - Integer products are exact, so the dot equals __dp4a's / __popc's and
//   the results are bit-identical to the first port and to the plain
//   PyTorch versions (ops/fused_scan.py).
// - The epilogue is split in two.  Phase 1 is branch-free and the only
//   reader of the accumulator registers: a cheap superset filter of
//   every (row, query) pair into a bit mask.  Phase 2 walks the mask's
//   few set bits: each survivor's dot again from its row and query in the
//   shared tiles (exact integers), the distance and the strict dist < θ;
//   the passing rows gather in shared memory and are appended (atomic
//   count, then the slot) a few hundred at a time, so the count stays exact
//   and no survivor waits on device memory.  A survivor path that read the
//   accumulators would make ptxas fence and serialize the wgmma in a
//   divergent branch and keep them alive (spilled) across the epilogue.
//
// K1a: the rows (u8 - 128 codes, 64 x D) are wgmma's A operand through a
// descriptor, laid out by TMA (D = 128: one 128-byte swizzle row; D = 32,
// 64: unswizzled 16-byte column chunks); the queries are B, staged the
// same way.  Meta rows 0-2 of a thread's two rows (row_sum, mag2, rr: 12 B
// a row) are read one tile ahead into registers.  Phase 1 builds the exact centered dot in
// f32 from the accumulator with one integer and one f32 add (magic-number
// conversion instead of the quarter-rate int-to-float convert) and tests
// fl(dot_c · rr) > u, a bound loosened past the rounding from the cos key
// of cos_key_threshold (key_bound, op for op fused_scan.py's), which
// dist < θ implies: dist is monotone non-increasing in cos and the key
// keeps a 1e-5 margin.  Bound: the int8
// product (2·Q·N·D at 1,979 TOP/s) at Q = 256 and up, the row bytes below;
// phase 1's ~5 operations a pair are the next cost.
//
// K4a: K1a over the packed int4 rows (64 rows x 64 B a tile by TMA, D =
// 128), whose nibbles wgmma cannot take from shared memory: each thread
// unpacks its A fragment in registers (K2a's route), the queries (u8 - 128
// codes, or 4-bit codes) staged as K1a's; phase 1 builds each kind's exact
// centered dot from the accumulator (the kernel's note) and tests K1a's
// key bound; phase 2 takes the survivors' dot again from the packed tile.
// Bound: the int8 product at Q = 256 and up (0.0347 ms over 1M rows), the
// row bytes (32 MB + meta) below.
//
// K2a: the ±1 form the TPU multiplied (_kind_dist_tile :134-140) on the
// published 32-byte hash: each packed row is read from device memory (32 B)
// and its 256 bits expanded in registers to ±1 int8 as wgmma's A fragment
// (k = 8·byte + bit, LSB first); the queries are expanded once per block
// to ±1 in a 128B-swizzled shared tile (64 KB for 256 queries), with the
// bytes at or past `limit` set to 0 so they add nothing.  dot = 8·limit −
// 2·diff, and dist = fl(diff · scale) is monotone in diff, so phase 1 is
// one integer compare of the accumulator against a per-query threshold
// (with the u8 wrap: of (diff & 255)), exact, not just a superset.
// Bound: the ±1 product (2·Q·N·256 at 1,979 TOP/s), 0.0694 ms at Q = 256
// over 1M rows; the byte floor (32 B a row) is 0.0106 ms.
//
// K1b, K2b and K4b replace the first port's chunk kernels (fused_scan.cu,
// kept as timing references and for the other widths) behind the exact
// scans: K1b replaces _threshold_kernel as pallas_cosine_scan_topk (:1074)
// launched it (θ = max_distance), K2b and K4b stand where the JAX package
// ran its XLA hamming_gemm_scan_topk / hamming_scan_topk and
// cosine4a_scan_topk / cosine4_scan_topk; their design is at their kernel.
//
// Plain C interface, bound with ctypes; every entry point returns
// cudaGetLastError() (or kTensorMapError + the driver's code when a TMA
// descriptor cannot be encoded) so the Python wrapper can raise.  The
// TMA descriptor encoder comes from cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_device.cuh"
#include "select_device.cuh"
#include "tc_device.cuh"
#include "tc_operands.cuh"
#include "wgmma_s8.cuh"

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kStages = 4;       // K1a's row tiles in the TMA ring (8 KB each at D = 128)
constexpr int kStages4 = 8;      // K4a's (4 KB each)
// Passing rows a block gathers in shared memory before it appends them to
// the buffers (one round of global atomics for many rows).
constexpr int kHits = 1024;

// Bytes of a row tile's row and slots of the TMA ring, by kind: u8 rows of
// D bytes (K1a), packed int4 rows of D/2 (K4a).
__host__ __device__ constexpr int row_bytes(int kind, int d) { return kind == kU8 ? d : d / 2; }
__host__ __device__ constexpr int ring_stages(int kind) { return kind == kU8 ? kStages : kStages4; }

// Shared-memory layouts (byte offsets from a 1024-aligned base).
struct CosineSmem {
  int q, rows, qk, qx, hits, bars, total;
  __host__ __device__ CosineSmem(int nq, int d, int kind)
      : q(0),
        rows(round_up(nq * d, 1024)),
        qk(rows + ring_stages(kind) * kTileRows * row_bytes(kind, d)),
        qx(qk + nq * 8),
        hits(qx + nq * 16),
        bars(hits + kHits * 12),
        total(bars + (ring_stages(kind) + 1) * 8 + 8) {}
};

struct HammingSmem {
  int q, raw, rows, ok, thr, th, hits, bars, total;
  __host__ __device__ explicit HammingSmem(int nq)
      : q(0),
        raw(nq * kPhK),
        rows(raw + nq * kPhBytes),
        ok(rows + kHamStages * kTileRows * kPhBytes),
        thr(ok + kHamStages * 128),
        th(thr + nq * 4),
        hits(th + nq * 4),
        bars(round_up(hits + kHits * 12, 8)),
        total(bars + kHamStages * 8 + 8) {}
};

// A passing (query, row) pair and its distance, gathered in shared memory.
struct Hit {
  int q, row;
  float dist;
};

// Appends a block's gathered hits: the slot is claimed before the capacity
// check, so count[q] stays exact when the buffer overflows.
__device__ __forceinline__ void append_hit(const Hit& h, int cap, int* count, float* cand_d,
                                           int* cand_i) {
  const int slot = atomicAdd(count + h.q, 1);
  if (slot < cap) {
    cand_d[static_cast<size_t>(h.q) * cap + slot] = h.dist;
    cand_i[static_cast<size_t>(h.q) * cap + slot] = h.row;
  }
}

// Gathers one hit (past kHits it appends straight away: floods only);
// returns its position in the list.
__device__ __forceinline__ int gather_hit(const Hit& h, Hit* hits, int* n_hits, int cap,
                                          int* count, float* cand_d, int* cand_i) {
  const int pos = atomicAdd(n_hits, 1);
  if (pos < kHits) hits[pos] = h;
  else append_hit(h, cap, count, cand_d, cand_i);
  return pos;
}

// All threads: append the gathered hits and empty the list (block-wide).
__device__ __forceinline__ void flush_hits(Hit* hits, int* n_hits, int cap, int* count,
                                           float* cand_d, int* cand_i) {
  const int n = min(*n_hits, kHits);
  for (int i = threadIdx.x; i < n; i += blockDim.x) append_hit(hits[i], cap, count, cand_d, cand_i);
  __syncthreads();
  if (threadIdx.x == 0) *n_hits = 0;
  __syncthreads();
}

// ---- K1a (KIND kU8) and K4a (kInt4Asym, kInt4Sym)

// Staged per query: (z, u) for the hot filter — z the query's part of
// the phase-1 centered dot (below), u the loosened bound of the key test
// (key_bound) — and (qr, f32(q_mag2), θ, q_sum bits) for the survivors'
// spec distance.
//
// Phase 1 builds the exact centered dot dot_c in f32 without the
// quarter-rate int-to-float convert: an int x with |x| < 2^22 added to the
// bits of kMagic2 = 1.5·2^24 gives the float kMagic2 + 2x exactly, and
// |dot_c| <= 255²·D < 2^24 at D <= 128, so one f32 add of an exact
// operand lands on dot_c exactly (the spec's f32(dot_c)).  Per kind:
//   u8:   x = 2·dot8 + row_sum, then + z = f32(2·q_sum + D) − kMagic2
//   asym: x = 34·dot8 − 255·q_sum − 255·D/2 (the query part in z's bits;
//         within [−4,194,240, 4,161,600] at D = 128), then + the row's
//         f32(34·row_sum) − kMagic2
//   sym:  x = dot_c / 2 = 578·dot8 − 4335·(q_sum + row_sum) + 65025·D/2
//         (dot_c is even: a sum of D odd products), then − kMagic2
// (fused_scan.py's tc_centered_f32 repeats these ops; the CPU tests hold
// them equal to f32(dot_c) at the extreme codes.)
//
// K4a builds its A operand in registers (nibble_fragments), as K2a does
// (pm1_fragments), and the queries stay in natural dim order.
template <int NQ, int KIND>
__global__ void __launch_bounds__(kTcThreads)
tc_cosine_collect_kernel(const __grid_constant__ CUtensorMap rows_map,
                         const __grid_constant__ CUtensorMap q_map,
                         const int8_t* __restrict__ q_codes, const int* __restrict__ q_sum,
                         const int* __restrict__ q_mag2, const float* __restrict__ qr,
                         const float* __restrict__ theta, const int8_t* __restrict__ data,
                         const int* __restrict__ meta, int Q, int N, int D, int cap,
                         float key_scale, float saturation, float key_loose,
                         int* __restrict__ count, float* __restrict__ cand_d,
                         int* __restrict__ cand_i) {
  extern __shared__ uint8_t tc_smem_raw[];
  constexpr int kRing = ring_stages(KIND);
  const CosineSmem L(NQ, D, KIND);
  const int rb = row_bytes(KIND, D);
  uint8_t* sm = align_smem(tc_smem_raw);
  int8_t* q_tile = reinterpret_cast<int8_t*>(sm + L.q);
  int8_t* rows = reinterpret_cast<int8_t*>(sm + L.rows);
  float2* qk = reinterpret_cast<float2*>(sm + L.qk);
  float4* qx = reinterpret_cast<float4*>(sm + L.qx);
  Hit* hits = reinterpret_cast<Hit*>(sm + L.hits);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* qbar = full + kRing;
  int* n_hits = reinterpret_cast<int*>(qbar + 1);

  const int tid = threadIdx.x;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_items = my_tiles * ((Q + NQ - 1) / NQ);
  const int cb = row_chunk(D);

  if (tid == 0) {
    for (int s = 0; s <= kRing; ++s) mbar_init(full + s, 1);
    *n_hits = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int s = it % kRing;
    const int tile = blockIdx.x + (it % my_tiles) * gridDim.x;
    mbar_expect_tx(full + s, kTileRows * rb);
    if constexpr (KIND == kU8) {
      for (int c = 0; c < D / cb; ++c)
        tma_load_2d(rows + s * kTileRows * D + c * kTileRows * cb, &rows_map, full + s, c * cb,
                    tile * kTileRows);
    } else {
      tma_load_2d(rows + s * kTileRows * rb, &rows_map, full + s, 0, tile * kTileRows);
    }
  };
  // Meta rows 0-2 (row_sum, mag2, rr) of this thread's two rows of a tile,
  // read one item ahead into registers (a TMA box of a meta row would start
  // at j·N + 64·tile, not 16-byte aligned for every N).
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);  // rows r0 and r0 + 8
  auto load_meta = [&](int it, int (&m)[2][3]) {
    const int tile = blockIdx.x + (it % my_tiles) * gridDim.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile * kTileRows + r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        m[h][j] = row < N ? __ldg(meta + static_cast<size_t>(j) * N + row) : 0;
    }
  };
  int meta_next[2][3];
  if (n_items > 0) load_meta(0, meta_next);
  if (tid == 0)
    for (int it = 0; it < min(kRing, n_items); ++it) issue(it);

  const int tq = tid & 3;
  const uint32_t layout = cb == 128 ? 1u : 0u;
  const uint32_t q_addr = smem_u32(q_tile), rows_addr = smem_u32(rows);
  const float nan = __int_as_float(0x7fc00000), inf = __int_as_float(0x7f800000);
  int acc[NQ / 2];

  for (int it = 0; it < n_items; ++it) {
    const int qt = it / my_tiles;
    const int tile = blockIdx.x + (it % my_tiles) * gridDim.x;
    if (it % my_tiles == 0) {  // a new query tile: its codes by TMA, its constants
      __syncthreads();
      if (tid == 0) {
        mbar_expect_tx(qbar, NQ * D);
        for (int c = 0; c < D / cb; ++c)
          tma_load_2d(q_tile + c * NQ * cb, &q_map, qbar, c * cb, qt * NQ);
      }
      for (int c = tid; c < NQ; c += kTcThreads) {
        const int q = qt * NQ + c;
        float2 k = make_float2(0.0f, inf);  // padding columns: nothing passes
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q < Q) {
          const int qs = q_sum[q];
          const float th = theta[q];
          if constexpr (KIND == kU8)
            k.x = __fsub_rn(__int2float_rn(2 * qs + D), kMagic2);
          else if constexpr (KIND == kInt4Asym)
            k.x = __int_as_float(kMagic2Bits - 255 * qs - 255 * (D / 2));
          else
            k.x = __int_as_float(kMagic2Bits - 4335 * qs + 65025 * (D / 2));
          k.y = key_bound(th, qr[q], key_scale, saturation, key_loose);
          x = make_float4(qr[q], __int2float_rn(q_mag2[q]), th, __int_as_float(qs));
        }
        qk[c] = k;
        qx[c] = x;
      }
      __syncthreads();
      mbar_wait(qbar, qt & 1);
    }
    int rsum[2], rmag[2], rc[2];
    float rr[2], rr_key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] = meta_next[h][0];
      rmag[h] = meta_next[h][1];
      rr[h] = __int_as_float(meta_next[h][2]);
      // NaN for padding / tombstones / rows past N: every key test fails.
      rr_key[h] = rmag[h] > 0 ? rr[h] : nan;
      // The row's part of the phase-1 centered dot (int bits or f32).
      if constexpr (KIND == kU8)
        rc[h] = kMagic2Bits + rsum[h];
      else if constexpr (KIND == kInt4Asym)
        rc[h] = __float_as_int(__fsub_rn(__int2float_rn(34 * rsum[h]), kMagic2));
      else
        rc[h] = -4335 * rsum[h];
    }
    if (it + 1 < n_items) load_meta(it + 1, meta_next);
    const int s = it % kRing;
    mbar_wait(full + s, (it / kRing) & 1);
    if constexpr (KIND == kU8) {
      wgmma_fence();
      const uint32_t a0 = rows_addr + s * kTileRows * D;
      for (int k = 0; k < D / 32; ++k) {
        const int c = 32 * k / cb, off = 32 * k % cb;  // k-step k: chunk c, byte off
        Wgmma<NQ>::ss(acc, smem_desc(a0 + c * kTileRows * cb + off, kTileRows * cb, 8 * cb, layout),
                      smem_desc(q_addr + c * NQ * cb + off, NQ * cb, 8 * cb, layout), k > 0);
      }
    } else {
      uint32_t a[4][4];
      nibble_fragments(reinterpret_cast<const uint8_t*>(rows) + s * kTileRows * rb, r0, tq, a);
      nibble_product<NQ>(acc, a, q_addr);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);

    // Phase 1, branch-free and the only reader of the accumulators: the
    // key test of every (row, query) pair into a bit mask (bit p = pair p),
    // on the exact centered dot (see the kernel's note).
    uint32_t pass[(NQ + 63) / 64] = {};
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 k = qk[8 * j + 2 * tq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 4 * j + 2 * h + e;
          float dc;
          if constexpr (KIND == kU8)
            dc = __fadd_rn(__int_as_float(2 * acc[p] + rc[h]), k.x);
          else if constexpr (KIND == kInt4Asym)
            dc = __fadd_rn(__int_as_float(34 * acc[p] + __float_as_int(k.x)), __int_as_float(rc[h]));
          else
            dc = __fadd_rn(__int_as_float(578 * acc[p] + __float_as_int(k.x) + rc[h]), -kMagic2);
          pass[p / 32] |= static_cast<uint32_t>(__fmul_rn(dc, rr_key[h]) > k.y) << (p % 32);
        }
      }
    }
    // Phase 2, rare: each survivor's dot again from the shared tiles
    // (exact integers), the spec distance and the strict θ; the passing
    // rows gather in shared memory.
    int last = -1;
#pragma unroll
    for (int pw = 0; pw < (NQ + 63) / 64; ++pw) {
      for (uint32_t m = pass[pw]; m != 0; m &= m - 1) {
        const int p = 32 * pw + __ffs(m) - 1;
        const int h = (p >> 1) & 1, c = 8 * (p >> 2) + 2 * tq + (p & 1);
        const float4 x = qx[c];
        int dot8;
        if constexpr (KIND == kU8)
          dot8 = tile_dot8(rows + s * kTileRows * D, r0 + 8 * h, q_tile, NQ, c, D, cb);
        else
          dot8 = tile_dot4(reinterpret_cast<const uint8_t*>(rows) + s * kTileRows * rb, r0 + 8 * h,
                           q_tile, c);
        const float dist =
            spec_dist(centered_dot<KIND>(dot8, __float_as_int(x.w), h ? rsum[1] : rsum[0], D),
                      x.x, h ? rr[1] : rr[0], x.y, __int2float_rn(h ? rmag[1] : rmag[0]));
        if (dist < x.z)
          last = gather_hit(Hit{qt * NQ + c, tile * kTileRows + r0 + 8 * h, dist}, hits, n_hits,
                            cap, count, cand_d, cand_i);
      }
    }
    // The slot is read (wgmma, phase 2): refill it.  Append the gathered
    // rows once the list is half full (a block-uniform vote).
    const bool full_list = __syncthreads_or(last >= kHits / 2 - 1);
    if (tid == 0 && it + kRing < n_items) issue(it + kRing);
    if (full_list) flush_hits(hits, n_hits, cap, count, cand_d, cand_i);
  }
  __syncthreads();
  flush_hits(hits, n_hits, cap, count, cand_d, cand_i);
}

// ---- K2a

template <int NQ, bool WRAP>
__global__ void __launch_bounds__(kTcThreads)
tc_hamming_collect_kernel(const __grid_constant__ CUtensorMap rows_map,
                          const __grid_constant__ CUtensorMap ok_map,
                          const uint8_t* __restrict__ q_bytes, const float* __restrict__ theta,
                          const uint8_t* __restrict__ data, int Q, int N, int limit, float scale,
                          int cap, int* __restrict__ count, float* __restrict__ cand_d,
                          int* __restrict__ cand_i) {
  extern __shared__ uint8_t tc_smem_raw[];
  const HammingSmem L(NQ);
  uint8_t* sm = align_smem(tc_smem_raw);
  uint8_t* q_pm1 = sm + L.q;  // [kPhK / 128][NQ][128], 128B-swizzled
  uint8_t* q_raw = sm + L.raw;  // [NQ][kPhBytes], the packed queries
  uint8_t* rows = sm + L.rows;
  uint8_t* ok_s = sm + L.ok;
  int* thr_s = reinterpret_cast<int*>(sm + L.thr);
  float* th_s = reinterpret_cast<float*>(sm + L.th);
  Hit* hits = reinterpret_cast<Hit*>(sm + L.hits);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  int* n_hits = reinterpret_cast<int*>(full + kHamStages);

  const int tid = threadIdx.x;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_items = my_tiles * ((Q + NQ - 1) / NQ);
  const int bits = 8 * limit;

  if (tid == 0) {
    for (int s = 0; s < kHamStages; ++s) mbar_init(full + s, 1);
    *n_hits = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int s = it % kHamStages;
    const int tile = blockIdx.x + (it % my_tiles) * gridDim.x;
    mbar_expect_tx(full + s, kTileRows * (kPhBytes + 1));
    tma_load_2d(rows + s * kTileRows * kPhBytes, &rows_map, full + s, 0, tile * kTileRows);
    tma_load_1d(ok_s + s * 128, &ok_map, full + s, tile * kTileRows);
  };
  if (tid == 0)
    for (int it = 0; it < min(kHamStages, n_items); ++it) issue(it);

  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int tq = tid & 3;
  const uint32_t q_addr = smem_u32(q_pm1);
  int acc[NQ / 2];

  for (int it = 0; it < n_items; ++it) {
    const int qt = it / my_tiles;
    const int tile = blockIdx.x + (it % my_tiles) * gridDim.x;
    if (it % my_tiles == 0) {  // a new query tile: expand it to ±1, and its thresholds
      __syncthreads();
      stage_pm1_queries<NQ>(q_bytes, qt * NQ, Q, limit, q_pm1, q_raw);
      // Per query: T = #{d in [0, dmax] : fl(d · scale) < θ} (monotone in d;
      // dmax = 8·limit, or 255 under the wrap; fused_scan.py's
      // hamming_pass_count counts the same predicate).  Unwrapped,
      // diff < T ⟺ dot > 8·limit − 2T; wrapped, the kernel compares
      // (diff & 255) < T.
      for (int n = tid; n < NQ; n += kTcThreads) {
        const int q = qt * NQ + n;
        int thr = WRAP ? 0 : 0x7fffffff;
        float th = 0.0f;
        if (q < Q) {
          th = theta[q];
          const int lo = hamming_pass_count(th, WRAP ? min(bits, 255) : bits, scale);
          thr = WRAP ? lo : bits - 2 * lo;
        }
        thr_s[n] = thr;
        th_s[n] = th;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // ±1 tile -> wgmma
      __syncthreads();
    }
    const int s = it % kHamStages;
    mbar_wait(full + s, (it / kHamStages) & 1);
    const uint8_t* rs = rows + s * kTileRows * kPhBytes;
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      ok[h] = ok_s[s * 128 + r] != 0 && tile * kTileRows + r < N;
    }
    uint32_t a[kPhK / 32][4];
    pm1_fragments(rs, r0, tq, a);
    pm1_product<NQ>(acc, a, q_addr);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);

    // Phase 1, branch-free and the only reader of the accumulators: the
    // integer filter of every pair into a bit mask (bit p = pair p).
    uint32_t pass[(NQ + 63) / 64] = {};
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int thr = thr_s[8 * j + 2 * tq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 4 * j + 2 * h + e;
          const bool hit = WRAP ? ((((bits - acc[p]) >> 1) & 255) < thr) : (acc[p] > thr);
          pass[p / 32] |= static_cast<uint32_t>(ok[h] && hit) << (p % 32);
        }
      }
    }
    // Phase 2, rare: each survivor's bits again from its packed row and
    // query in shared memory (row_popc), its distance and the strict θ; the
    // passing rows gather in shared memory.
    int last = -1;
#pragma unroll
    for (int pw = 0; pw < (NQ + 63) / 64; ++pw) {
      for (uint32_t m = pass[pw]; m != 0; m &= m - 1) {
        const int p = 32 * pw + __ffs(m) - 1;
        const int c = 8 * (p >> 2) + 2 * tq + (p & 1), r = r0 + 8 * ((p >> 1) & 1);
        int diff[1];
        row_popc<1>(rs + r * kPhBytes, q_raw + c * kPhBytes, kPhBytes, limit, diff);
        const float dist = hamming_dist(diff[0], WRAP, scale);
        if (dist < th_s[c])
          last = gather_hit(Hit{qt * NQ + c, tile * kTileRows + r, dist}, hits, n_hits, cap, count,
                            cand_d, cand_i);
      }
    }
    // The slot is read (rows, phase 2): refill it.  Append the gathered
    // rows once the list is half full (a block-uniform vote).
    const bool full_list = __syncthreads_or(last >= kHits / 2 - 1);
    if (tid == 0 && it + kHamStages < n_items) issue(it + kHamStages);
    if (full_list) flush_hits(hits, n_hits, cap, count, cand_d, cand_i);
  }
  __syncthreads();
  flush_hits(hits, n_hits, cap, count, cand_d, cand_i);
}

// ---- K1b, K2b and K4b: the exact chunk top-k
//
// Per (query, chunk of R rows) the first k by (dist, row id) of the valid
// rows with dist < max_distance, listed in row order (K1c, which finishes
// the [Q, n_chunks, k] partials, reads them in any order).  A block of two
// warpgroups takes NQ queries (8..64, as many as its buffers' shared
// memory allows) and a chunk, a tile pair at a time: each warpgroup's
// product of one tile on int8 wgmma through K1a's / K2a's / K4a's TMA ring
// and operand paths (the u8 rows K-major through a descriptor, the ±1
// product of the packed hash bits, or the unpacked int4 nibbles), issued
// a pair ahead so that it runs under the previous pair's selection.
// Phase 1 stores the accumulators branch-free into a shared stage.  Phase
// 2, one warp a query and a lane a row: a cheap filter on the integer
// product that passes every row able to enter (K2b: the diff against a
// per-query limit, exact; K1b and K4b: K1a's key bound of the k-th
// distance so far, on the centered dot), the exact spec distance and (dist, row) key of
// its survivors only, and a warp-ballot append, in row order, of the keys
// below τ to the query's buffer in shared memory.  A buffer that could
// overflow on the next pair keeps its k smallest — the radix select of
// select_device.cuh from the highest bit where its keys differ, the ties
// at the k-th taken in row order — and τ becomes the k-th: rows arrive in
// ascending order, so a later row enters only with a distance below it,
// and the filter tightens to that.  The block votes at each pair's
// barrier, and every buffer well past k prunes in the same pair: one
// warp's prune would hold the others at the next barrier, so the prunes
// are made to overlap.  Past the product the work follows the
// rows below the k-th and k, not the chunk's length; no slot is sorted.
//
// Few queries over many rows would leave SMs idle at a block a chunk: the
// launch plan then splits each chunk over up to 8 blocks, each publishes
// its k smallest, and the last of them to finish (a ticket a chunk)
// merges the parts in row order.  The chunk length (ops/fused_scan.py
// tc_chunk_rows) grows until K1c takes the partials in one launch.
//
// Bound: the product (2·Q·N·depth at 1,979 TOP/s) over the rows read once;
// what the kernel spends past it is the selection — the prunes' radix
// passes, one warp a query, and the exact distances of the rows that
// enter before τ tightens (PERF.md §6).

// Pitch (ints) of the stage's query rows: 64 + 4 puts the four query pairs
// of a warp's phase-1 store 8 banks apart.
constexpr int kStagePitch = kTileRows + 4;
// Shared memory a chunk block aims at: two blocks an SM.
constexpr int kChunkSmemTarget = 113 * 1024;
// A chunk block: two warpgroups, each the product of one tile of a pair.
constexpr int kChunkThreads = 256;
constexpr int kChunkWarps = kChunkThreads / 32;

// Bytes of a row of a chunk kind's tiles (u8: the row width d) and the
// slots of its TMA ring: three pairs ahead (four for the 2 KB hash tiles),
// so that a pair's rows have landed when its product is issued even at a
// query or two a block; with u8 tiles (8 KB at d = 128) two blocks still
// fit an SM with the buffers of k = 100.
__host__ __device__ constexpr int chunk_row_bytes(int kind, int d) {
  return kind == kHamming ? kPhBytes : kind == kU8 ? d : kDim4 / 2;
}
__host__ __device__ constexpr int chunk_stages(int kind) {
  return kind == kHamming ? kHamStages : 6;
}
// Bytes of a query's B operand: the ±1 bits, the u8 codes, or the int4
// kinds' 128 codes.
__host__ __device__ constexpr int chunk_query_bytes(int kind, int d) {
  return kind == kHamming ? kPhK : kind == kU8 ? d : kDim4;
}

// A query's state in a chunk block.
struct ChunkQuery {
  unsigned long long tau;  // a row enters the buffer when its key is below τ
  int n;                   // keys in the buffer
  int lim;                 // K2b: the largest diff the filter admits
  float u;                 // K1b, K4b: the filter's bound (key_bound)
  float qr, qm2f;          // K1b, K4b: the query's rsqrt and f32(mag2)
  int qs;                  // K1b, K4b: the query's code sum
};

// Shared-memory layout of a chunk block (byte offsets from a 1024-aligned
// base): the queries' B operand, the ring of row tiles, the stages
// [2][2][NQ][68] of two tile pairs' products, the queries' state, their buffers
// [NQ][cap] of 64-bit keys, and per warp a 256-bin histogram and select
// scalars; the mbarriers.
struct ChunkSmem {
  int q, rows, stage, qv, bufs, sel, bars, flag, total;
  __host__ __device__ ChunkSmem(int kind, int nq, int cap, int d)
      : q(0),
        rows(round_up(nq * chunk_query_bytes(kind, d), 1024)),
        stage(rows + chunk_stages(kind) * kTileRows * chunk_row_bytes(kind, d)),
        qv(stage + 4 * nq * kStagePitch * 4),
        bufs(qv + nq * static_cast<int>(sizeof(ChunkQuery))),
        sel(bufs + nq * cap * 8),
        bars(sel + kChunkWarps * (256 + 4) * 4),
        flag(bars + (chunk_stages(kind) + 1) * 8),
        total(flag + 8) {}
};

// Arguments of a chunk launch (the tensor maps go apart, as
// __grid_constant__ parameters).
struct ChunkArgs {
  const uint8_t* q_bytes;  // K2b: queries [Q, 32]
  const uint8_t* row_ok;   // K2b: row mask [N] (validity AND the width group)
  const int* q_sum;        // K1b, K4b: the queries' code sums, mag2 and rsqrt [Q]
  const int* q_mag2;
  const float* qr;
  const int* meta;         // K1b, K4b: row meta [4, N]
  float max_distance;
  int Q, N;
  int D;                   // K1b, K4b: the queries' width (u8 rows: their bytes)
  int limit, wrap;         // K2b: the byte limit and the u8 wrap
  float scale;             // K2b: f32(1 / (8 · limit))
  int R, k, cap, n_chunks;
  float key_scale, saturation, key_loose;  // K1b, K4b: key_bound's constants
  float* out_d;
  int* out_i;
  // A chunk split over `splits` blocks (splits > 1): each block's k
  // smallest [Q, n_chunks, splits, k] and their counts, and a ticket a
  // (query tile, chunk) that elects the last block to finish.
  int splits;
  unsigned long long* part_keys;
  int* part_n;
  int* tickets;
};

// A lane's rows of a tile pair (tile 2i + g, row 32h + lane): validity
// and, for K1b and K4b, what the distance needs.
struct ChunkRows {
  bool ok[2][2];
  int rs[2][2];
  float rr[2][2], m2f[2][2];
};

// A warpgroup's product of tile t of the ring (once it has landed) into
// acc, issued asynchronously: the caller waits for it (wgmma_wait0).
template <int NQ, int KIND>
__device__ __forceinline__ void chunk_product(int (&acc)[NQ / 2], const uint8_t* rows, uint64_t* full,
                                              int t, int r0, int tq, uint32_t q_addr, int d) {
  constexpr int kRing = chunk_stages(KIND);
  const int s = t % kRing;
  mbar_wait(full + s, (t / kRing) & 1);
  tile_product<NQ, KIND>(acc, rows + s * kTileRows * chunk_row_bytes(KIND, d), r0, tq, q_addr, d);
}

template <int NQ, int KIND>
__global__ void __launch_bounds__(kChunkThreads)
tc_chunk_topk_kernel(const __grid_constant__ CUtensorMap rows_map,
                     const __grid_constant__ CUtensorMap q_map, const ChunkArgs a) {
  extern __shared__ uint8_t tc_smem_raw[];
  constexpr bool kHam = KIND == kHamming;
  constexpr int kRing = chunk_stages(KIND);
  constexpr int kQW = NQ / kChunkWarps;  // queries a warp owns in phase 2
  const ChunkSmem L(KIND, NQ, a.cap, a.D);
  const int row_b = chunk_row_bytes(KIND, a.D);
  uint8_t* sm = align_smem(tc_smem_raw);
  uint8_t* q_tile = sm + L.q;
  uint8_t* rows = sm + L.rows;
  int* stage = reinterpret_cast<int*>(sm + L.stage);
  ChunkQuery* qv = reinterpret_cast<ChunkQuery*>(sm + L.qv);
  unsigned long long* bufs = reinterpret_cast<unsigned long long*>(sm + L.bufs);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* qbar = full + kRing;
  int* last = reinterpret_cast<int*>(sm + L.flag);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  int* hist = reinterpret_cast<int*>(sm + L.sel) + warp * (256 + 4);
  int* scal = hist + 256;
  const int q0 = blockIdx.x * NQ;
  const int chunk = blockIdx.y / a.splits, part = blockIdx.y % a.splits;
  const int part_rows = a.R / a.splits;  // a multiple of the 128-row tile pair
  const int row_begin = chunk * a.R + part * part_rows;
  const int tile0 = row_begin / kTileRows;
  const int nt = (max(0, min(part_rows, a.N - row_begin)) + kTileRows - 1) / kTileRows;
  const int bits = 8 * a.limit;

  if (tid == 0) {
    for (int s = 0; s <= kRing; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // A tile (and the queries) by TMA: u8 rows in K1a's column chunks of
  // cb bytes, the packed rows as one box.
  const int cb = row_chunk(a.D);
  auto issue = [&](int t) {
    const int s = t % kRing;
    uint8_t* dst = rows + s * kTileRows * row_b;
    mbar_expect_tx(full + s, kTileRows * row_b);
    if constexpr (KIND == kU8) {
      for (int c = 0; c < a.D / cb; ++c)
        tma_load_2d(dst + c * kTileRows * cb, &rows_map, full + s, c * cb, (tile0 + t) * kTileRows);
    } else {
      tma_load_2d(dst, &rows_map, full + s, 0, (tile0 + t) * kTileRows);
    }
  };
  if (tid == 0) {
    if constexpr (!kHam) {
      mbar_expect_tx(qbar, NQ * a.D);
      for (int c = 0; c < a.D / cb; ++c) tma_load_2d(q_tile + c * NQ * cb, &q_map, qbar, c * cb, q0);
    }
    for (int t = 0; t < min(kRing, nt); ++t) issue(t);
  }
  // The queries' B operand (K2b: expanded to ±1 here; K1b, K4b: by TMA)
  // and their state: empty buffers, no τ, the filter of dist < max_distance.
  if constexpr (kHam) stage_pm1_queries<NQ>(a.q_bytes, q0, a.Q, a.limit, q_tile, nullptr);
  for (int c = tid; c < NQ; c += kChunkThreads) {
    const int q = q0 + c;
    ChunkQuery v{kNoKey, 0, -1, 0.0f, 0.0f, 0.0f, 0};
    if (q < a.Q) {
      if constexpr (kHam) {
        v.lim = hamming_pass_count(a.max_distance, a.wrap ? min(bits, 255) : bits, a.scale) - 1;
      } else {
        v.qr = a.qr[q];
        v.qm2f = __int2float_rn(a.q_mag2[q]);
        v.qs = a.q_sum[q];
        v.u = key_bound(a.max_distance, v.qr, a.key_scale, a.saturation, a.key_loose);
      }
    }
    qv[c] = v;
  }
  if constexpr (kHam) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // ±1 tile -> wgmma
  __syncthreads();
  if constexpr (!kHam) mbar_wait(qbar, 0);

  auto load_rows = [&](int i, ChunkRows& rv) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (tile0 + 2 * i + g) * kTileRows + 32 * h + lane;
        const bool in = 2 * i + g < nt && row < a.N;
        if constexpr (kHam) {
          rv.ok[g][h] = in && __ldg(a.row_ok + row) != 0;
        } else {
          const int mag2 = in ? __ldg(a.meta + static_cast<size_t>(a.N) + row) : 0;
          rv.ok[g][h] = mag2 > 0;
          rv.rs[g][h] = in ? __ldg(a.meta + row) : 0;
          rv.rr[g][h] = in ? __int_as_float(__ldg(a.meta + 2 * static_cast<size_t>(a.N) + row)) : 0.0f;
          rv.m2f[g][h] = __int2float_rn(mag2);
        }
      }
    }
  };
  // Keeps the k smallest of query c's n > k buffered keys (one warp; the
  // buffer is in row order and stays so), sets τ to the k-th and tightens
  // the filter to its distance: the radix select decides the k-th's
  // distance bits, from the highest bit where the keys differ (their min
  // and max), and the ties at it are taken in row order.  Rows come in
  // ascending order, so a later row beats τ only with a smaller distance.
  auto prune = [&](int c, int n) {
    constexpr int kBatch = 4;
    ChunkQuery& v = qv[c];
    unsigned long long* buf = bufs + static_cast<size_t>(c) * a.cap;
    const unsigned below = (1u << lane) - 1u;
    unsigned long long lo = kNoKey, hi = 0;
    for (int i0 = 0; i0 < n; i0 += 32 * kBatch) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < n) {
          const unsigned long long key = buf[i];
          lo = min(lo, key);
          hi = max(hi, key);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    const int shift0 = max(32, (63 - __clzll(static_cast<long long>(lo ^ hi))) & ~7);
    RadixBin bin = radix_select<32>(buf, n, a.k, shift0, 32, hist, scal, nullptr);
    if (shift0 < 56) {  // the bits above the first digit, common to every key
      const unsigned long long common = ~((1ull << (shift0 + 8)) - 1ull);
      bin.prefix |= lo & common;
      bin.mask |= common;
    }
    const unsigned dk = static_cast<unsigned>(bin.prefix >> 32);
    const bool ties_in_order = !bin.whole_bin;
    int kept = 0, ties = 0;
    unsigned long long top = 0;
    for (int i0 = 0; i0 < n; i0 += 32 * kBatch) {  // in place: a batch writes below its end
      unsigned long long key[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u + lane;
        key[u] = i < n ? buf[i] : kNoKey;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u + lane;
        bool take = false, tie = false;
        if (i < n) {
          if (ties_in_order) {
            const unsigned khi = static_cast<unsigned>(key[u] >> 32);
            take = khi < dk, tie = khi == dk;
          } else {
            take = (key[u] & bin.mask) <= bin.prefix;
          }
        }
        const unsigned tm = __ballot_sync(0xffffffffu, tie);
        if (tie) take = ties + __popc(tm & below) < bin.rank;
        ties += __popc(tm);
        const unsigned km = __ballot_sync(0xffffffffu, take);
        if (take) {
          buf[kept + __popc(km & below)] = key[u];
          top = max(top, key[u]);
        }
        kept += __popc(km);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) top = max(top, __shfl_xor_sync(0xffffffffu, top, o));
    if (lane == 0) {
      v.n = kept;
      v.tau = top;
      const unsigned dist = static_cast<unsigned>(top >> 32);
      if constexpr (kHam) v.lim = min(v.lim, static_cast<int>(dist) - 1);
      else v.u = key_bound(__uint_as_float(dist), v.qr, a.key_scale, a.saturation, a.key_loose);
    }
    __syncwarp();
  };

  const int r0 = 16 * (warp & 3) + (lane >> 2), tq = lane & 3;
  const uint32_t q_addr = smem_u32(q_tile);
  int acc[NQ / 2];
  ChunkRows cur, nxt;
  load_rows(0, nxt);
  const int n_pairs = (nt + 1) / 2;
  if (wg < nt) chunk_product<NQ, KIND>(acc, rows, full, wg, r0, tq, q_addr, a.D);
  bool full_buf = false;  // one of this warp's buffers could overflow on the next pair
  for (int i = 0; i < n_pairs; ++i) {
    const int t = 2 * i + wg;  // this warpgroup's tile
    const int npt = min(2, nt - 2 * i);
    int* st_pair = stage + (i & 1) * 2 * NQ * kStagePitch;  // two pairs' stages alternate
    cur = nxt;
    if (i + 1 < n_pairs) load_rows(i + 1, nxt);
    // Phase 1, branch-free and the only reader of the accumulators.
    if (t < nt) {  // uniform over the warpgroup
      wgmma_wait0();
      fence_regs(acc);
      int* st = st_pair + wg * NQ * kStagePitch;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st[(8 * j + 2 * tq + e) * kStagePitch + r0 + 8 * h] = acc[4 * j + 2 * h + e];
        }
      }
    }
    // The pair's products are staged and its slots read: refill them.  A
    // buffer that could overflow prunes now, and then every buffer well past
    // k prunes with it: a prune holds the block at the next barrier, so the
    // warps' prunes overlap.
    const bool prune_round = __syncthreads_or(full_buf);
    if (tid == 0) {
      for (int g = 0; g < npt; ++g)
        if (2 * i + g + kRing < nt) issue(2 * i + g + kRing);
    }
    // The next pair's products run on the tensor cores under phase 2.
    if (t + 2 < nt) chunk_product<NQ, KIND>(acc, rows, full, t + 2, r0, tq, q_addr, a.D);
    if (prune_round) {
      for (int c = warp; c < NQ && q0 + c < a.Q; c += kChunkWarps)
        if (qv[c].n > min(a.k, a.cap - 4 * kTileRows) + 2 * kTileRows) prune(c, qv[c].n);
    }
    // Phase 2: one warp a query, a lane a row.  First the cheap filter of
    // every (query, row) the warp owns, all loads together; the keys only
    // where it passes.
    unsigned cheap = 0;  // bit 4j + 2g + h
    int val[kQW][4];     // K2b: the diff; K1b, K4b: the centered dot
#pragma unroll
    for (int j = 0; j < kQW; ++j) {
      const int c = warp + kChunkWarps * j;
      if (q0 + c < a.Q) {
        const ChunkQuery& v = qv[c];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bool pass = false;
            if (g < npt) {
              const int x = st_pair[(g * NQ + c) * kStagePitch + 32 * h + lane];
              if constexpr (kHam) {
                int diff = (bits - x) >> 1;  // the ±1 product is bits − 2·diff
                if (a.wrap) diff &= 255;
                val[j][2 * g + h] = diff;
                pass = cur.ok[g][h] && diff <= v.lim;
              } else {
                const int dot_c = centered_dot<KIND>(x, v.qs, cur.rs[g][h], a.D);
                val[j][2 * g + h] = dot_c;
                pass = cur.ok[g][h] && __fmul_rn(__int2float_rn(dot_c), cur.rr[g][h]) > v.u;
              }
            }
            cheap |= static_cast<unsigned>(pass) << (4 * j + 2 * g + h);
          }
        }
      }
    }
    if (__any_sync(0xffffffffu, cheap != 0)) {
#pragma unroll
      for (int j = 0; j < kQW; ++j) {
        const int c = warp + kChunkWarps * j;
        if (q0 + c >= a.Q) break;
        if (!__any_sync(0xffffffffu, ((cheap >> (4 * j)) & 15u) != 0)) continue;
        ChunkQuery& v = qv[c];
        unsigned long long* buf = bufs + static_cast<size_t>(c) * a.cap;
        int n = v.n;
        const unsigned long long tau = v.tau;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows in order: the buffer stays in row order
            const bool pre = (cheap >> (4 * j + 2 * g + h)) & 1u;
            if (!__any_sync(0xffffffffu, pre)) continue;
            const int row = (tile0 + 2 * i + g) * kTileRows + 32 * h + lane;
            bool pass = false;
            unsigned long long key = 0;
            if (pre) {
              if constexpr (kHam) {
                key = (static_cast<unsigned long long>(val[j][2 * g + h]) << 32) | static_cast<unsigned>(row);
                pass = key < tau;
              } else {
                const float dist = spec_dist(val[j][2 * g + h], v.qr, cur.rr[g][h], v.qm2f, cur.m2f[g][h]);
                key = make_key(dist, row);
                pass = dist < a.max_distance && key < tau;
              }
            }
            warp_append_owned(pass, key, buf, n);
          }
        }
        __syncwarp();
        if (lane == 0) v.n = n;
        __syncwarp();
      }
    }
    full_buf = false;
    for (int c = warp; c < NQ && q0 + c < a.Q; c += kChunkWarps)
      full_buf |= qv[c].n > a.cap - 2 * kTileRows;
  }

  // Each query's k smallest of the block's rows.  A chunk split over
  // several blocks: each publishes them, and the last to finish merges
  // every part's, in row order, into its buffers.
  for (int c = warp; c < NQ && q0 + c < a.Q; c += kChunkWarps)
    if (qv[c].n > a.k) prune(c, qv[c].n);
  if (a.splits > 1) {
    for (int c = warp; c < NQ && q0 + c < a.Q; c += kChunkWarps) {
      const size_t p = (static_cast<size_t>(q0 + c) * a.n_chunks + chunk) * a.splits + part;
      const int n = qv[c].n;
      const unsigned long long* buf = bufs + static_cast<size_t>(c) * a.cap;
      for (int i = lane; i < n; i += 32) a.part_keys[p * a.k + i] = buf[i];
      if (lane == 0) a.part_n[p] = n;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(a.tickets + blockIdx.x * a.n_chunks + chunk, 1) == a.splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int c = warp; c < NQ && q0 + c < a.Q; c += kChunkWarps) {
      ChunkQuery& v = qv[c];
      unsigned long long* buf = bufs + static_cast<size_t>(c) * a.cap;
      unsigned long long tau = kNoKey;
      int n = 0;
      for (int s = 0; s < a.splits; ++s) {
        const size_t p = (static_cast<size_t>(q0 + c) * a.n_chunks + chunk) * a.splits + s;
        const int m = __ldcg(a.part_n + p);
        for (int i0 = 0; i0 < m; i0 += 32) {
          const int i = i0 + lane;
          const unsigned long long key = i < m ? __ldcg(a.part_keys + p * a.k + i) : kNoKey;
          warp_append_owned(i < m && key < tau, key, buf, n);
        }
        __syncwarp();
        if (n > a.cap - a.k) {  // room for the next part's k
          prune(c, n);
          n = v.n;
          tau = v.tau;
        }
      }
      if (lane == 0) v.n = n;
      __syncwarp();
      if (n > a.k) prune(c, n);
    }
  }

  // The chunk's k smallest of each query, in row order, into [Q, n_chunks,
  // k] (missing entries +inf / -1 after them; K2b keys carry the diff, the
  // distance is fl(diff · scale)).  K1c, which finishes the partials,
  // reads them in any order.
  for (int c = warp; c < NQ && q0 + c < a.Q; c += kChunkWarps) {
    const int n = qv[c].n;
    const unsigned long long* buf = bufs + static_cast<size_t>(c) * a.cap;
    const size_t o = (static_cast<size_t>(q0 + c) * a.n_chunks + chunk) * a.k;
    for (int i = lane; i < a.k; i += 32) {
      const unsigned long long key = i < n ? buf[i] : kNoKey;
      float d = __int_as_float(0x7f800000);
      int id = -1;
      if (key != kNoKey) {
        const unsigned hi = static_cast<unsigned>(key >> 32);
        d = kHam ? __fmul_rn(__int2float_rn(static_cast<int>(hi)), a.scale) : __uint_as_float(hi);
        id = static_cast<int>(key & 0xffffffffu);
      }
      a.out_d[o + i] = d;
      a.out_i[o + i] = id;
    }
  }
}

// ---- Host side: TMA descriptors and launches

template <int NQ, int KIND>
int launch_tc_cosine(const CUtensorMap& rows, const CUtensorMap& qm, const void* q_codes,
                     const void* q_sum, const void* q_mag2, const void* qr, const void* theta,
                     const void* data, const void* meta, int Q, int N, int D, int cap,
                     float key_scale, float saturation, float key_loose, void* count,
                     void* cand_d, void* cand_i, cudaStream_t stream) {
  const size_t smem = CosineSmem(NQ, D, KIND).total + 1024;
  int grid = 0;
  const int rc = persistent_grid(tc_cosine_collect_kernel<NQ, KIND>, smem,
                                 (N + kTileRows - 1) / kTileRows, &grid);
  if (rc != 0) return rc;
  tc_cosine_collect_kernel<NQ, KIND><<<grid, kTcThreads, smem, stream>>>(
      rows, qm, static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
      static_cast<const int*>(q_mag2), static_cast<const float*>(qr),
      static_cast<const float*>(theta), static_cast<const int8_t*>(data),
      static_cast<const int*>(meta), Q, N, D, cap, key_scale, saturation, key_loose,
      static_cast<int*>(count), static_cast<float*>(cand_d), static_cast<int*>(cand_i));
  return static_cast<int>(cudaGetLastError());
}

template <int NQ, bool WRAP>
int launch_tc_hamming(const CUtensorMap& rows, const CUtensorMap& ok, const void* q_bytes,
                      const void* theta, const void* data, int Q, int N, int limit, float scale,
                      int cap, void* count, void* cand_d, void* cand_i, cudaStream_t stream) {
  const size_t smem = HammingSmem(NQ).total + 1024;
  int grid = 0;
  const int rc = persistent_grid(tc_hamming_collect_kernel<NQ, WRAP>, smem,
                                 (N + kTileRows - 1) / kTileRows, &grid);
  if (rc != 0) return rc;
  tc_hamming_collect_kernel<NQ, WRAP><<<grid, kTcThreads, smem, stream>>>(
      rows, ok, static_cast<const uint8_t*>(q_bytes), static_cast<const float*>(theta),
      static_cast<const uint8_t*>(data), Q, N, limit, scale, cap, static_cast<int*>(count),
      static_cast<float*>(cand_d), static_cast<int*>(cand_i));
  return static_cast<int>(cudaGetLastError());
}

// The query tile: Q padded up to a wgmma N of 8, 32, 64, 128 or 256.
int query_tile(int Q) { return Q <= 8 ? 8 : Q <= 32 ? 32 : Q <= 64 ? 64 : Q <= 128 ? 128 : 256; }

// A chunk buffer: past its k kept keys, room for a tile pair and, up to
// 2,048 keys, for k more (a merged part) and a pair.
int chunk_cap(int k) {
  return std::max(next_pow2(k + 2 * kTileRows), std::min(next_pow2(2 * k + 2 * kTileRows), 2048));
}

// The query tile of a chunk block: the widest of 8..64 (Q padded up) whose
// shared memory stays within kChunkSmemTarget, else 8.
int chunk_query_tile(int kind, int Q, int cap, int d) {
  int nq = Q <= 8 ? 8 : Q <= 16 ? 16 : Q <= 32 ? 32 : 64;
  while (nq > 8 && ChunkSmem(kind, nq, cap, d).total + 1024 > kChunkSmemTarget) nq /= 2;
  return nq;
}

// The blocks a chunk is split over: doubled (up to 8, parts of 1,024 rows
// or more) while the grid has fewer blocks than SMs.
int chunk_splits(int q_tiles, int n_chunks, int R) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  int splits = 1;
  while (splits < 8 && static_cast<long long>(q_tiles) * n_chunks * splits < sms &&
         R / (2 * splits) >= 1024)
    splits *= 2;
  return splits;
}

bool chunk_args_ok(int kind, const ChunkArgs& a, int nq) {
  return a.R > 0 && a.k >= 1 && a.k <= 1024 && a.n_chunks == (a.N + a.R - 1) / a.R &&
         (nq == 8 || nq == 16 || nq == 32 || nq == 64) &&
         (a.splits == 1 || a.splits == 2 || a.splits == 4 || a.splits == 8) &&
         a.R % (a.splits * 2 * kTileRows) == 0 &&
         (a.splits == 1 || (a.part_keys != nullptr && a.part_n != nullptr && a.tickets != nullptr)) &&
         ChunkSmem(kind, nq, a.cap, a.D).total + 1024 <= 227 * 1024;
}

template <int NQ, int KIND>
int launch_tc_chunk(const CUtensorMap& rows, const CUtensorMap& qm, const ChunkArgs& a, size_t smem,
                    cudaStream_t stream) {
  const int rc = allow_smem(tc_chunk_topk_kernel<NQ, KIND>);
  if (rc != 0) return rc;
  // A chunk's query tiles (and parts) run side by side, its rows hot in L2.
  const dim3 grid((a.Q + NQ - 1) / NQ, a.n_chunks * a.splits);
  tc_chunk_topk_kernel<NQ, KIND><<<grid, kChunkThreads, smem, stream>>>(rows, qm, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_chunk(int kind, int nq, const CUtensorMap& rows, const CUtensorMap& qm, const ChunkArgs& a,
                 void* stream) {
  if (!chunk_args_ok(kind, a, nq)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ChunkSmem(kind, nq, a.cap, a.D).total + 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nq * 4 + kind) {
#define PX_TC_CHUNK_KIND(n, kd) \
  case n * 4 + kd:              \
    return launch_tc_chunk<n, kd>(rows, qm, a, smem, st);
#define PX_TC_CHUNK(n)           \
  PX_TC_CHUNK_KIND(n, kU8)       \
  PX_TC_CHUNK_KIND(n, kInt4Asym) \
  PX_TC_CHUNK_KIND(n, kInt4Sym)  \
  PX_TC_CHUNK_KIND(n, kHamming)
    PX_TC_CHUNK(8)
    PX_TC_CHUNK(16)
    PX_TC_CHUNK(32)
    PX_TC_CHUNK(64)
#undef PX_TC_CHUNK
#undef PX_TC_CHUNK_KIND
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K1a (kind 0) on the tensor cores: rows int8 [N, D] (D = 32, 64 or 128;
// 16-byte aligned), meta int32 [4, N], queries int8 [Q, D] (16-byte
// aligned).  K4a (kind 1 asym, 2 sym): packed int4 rows uint8 [N, D/2]
// (D = 128), the queries as K1a's (u8 - 128 codes, or 4-bit codes).
PX_EXPORT int px_tc_cosine_collect(const void* q_codes, const void* q_sum, const void* q_mag2,
                                   const void* qr, const void* theta, const void* data,
                                   const void* meta, int Q, int N, int D, int kind, int cap,
                                   float key_scale, float saturation, float key_loose,
                                   void* count, void* cand_d, void* cand_i, void* stream) {
  const bool ok = kind == kU8 ? (D == 32 || D == 64 || D == 128)
                              : (kind == kInt4Asym || kind == kInt4Sym) && D == kDim4;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || Q <= 0) return 0;
  const int nq = query_tile(Q);
  const int cb = row_chunk(D);
  const CUtensorMapSwizzle sw = cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const int rb = row_bytes(kind, D);
  CUtensorMap rows, qm;
  int rc = kind == kU8
               ? encode_map(&rows, 2, data, D, N, D, cb, kTileRows, sw)
               : encode_map(&rows, 2, data, rb, N, rb, rb, kTileRows,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0) rc = encode_map(&qm, 2, q_codes, D, Q, D, cb, nq, sw);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nq * 4 + kind) {
#define PX_TC_COS_KIND(n, kd)                                                                     \
  case n * 4 + kd:                                                                                \
    return launch_tc_cosine<n, kd>(rows, qm, q_codes, q_sum, q_mag2, qr, theta, data, meta, Q, N, \
                                   D, cap, key_scale, saturation, key_loose, count, cand_d,       \
                                   cand_i, st);
#define PX_TC_COS(n)           \
  PX_TC_COS_KIND(n, kU8)       \
  PX_TC_COS_KIND(n, kInt4Asym) \
  PX_TC_COS_KIND(n, kInt4Sym)
    PX_TC_COS(8)
    PX_TC_COS(32)
    PX_TC_COS(64)
    PX_TC_COS(128)
    PX_TC_COS(256)
#undef PX_TC_COS
#undef PX_TC_COS_KIND
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2a on the tensor cores: packed rows uint8 [N, 32] (16-byte aligned),
// row_ok uint8 [N] (16-byte aligned), queries uint8 [Q, 32], limit <= 32.
PX_EXPORT int px_tc_hamming_collect(const void* q_bytes, const void* theta, const void* data,
                                    const void* row_ok, int Q, int N, int H, int limit, int wrap,
                                    float scale, int cap, void* count, void* cand_d, void* cand_i,
                                    void* stream) {
  if (H != kPhBytes || limit <= 0 || limit > kPhBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || Q <= 0) return 0;
  CUtensorMap rows, ok;
  int rc = encode_map(&rows, 2, data, kPhBytes, N, kPhBytes,
                      kPhBytes, kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = encode_map(&ok, 1, row_ok, N, 1, 16, kTileRows, 1,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (query_tile(Q) * 2 + (wrap ? 1 : 0)) {
#define PX_TC_HAM(n)                                                                              \
  case 2 * n:                                                                                     \
    return launch_tc_hamming<n, false>(rows, ok, q_bytes, theta, data, Q, N, limit, scale, cap,   \
                                       count, cand_d, cand_i, st);                                \
  case 2 * n + 1:                                                                                 \
    return launch_tc_hamming<n, true>(rows, ok, q_bytes, theta, data, Q, N, limit, scale, cap,    \
                                      count, cand_d, cand_i, st);
    PX_TC_HAM(8)
    PX_TC_HAM(32)
    PX_TC_HAM(64)
    PX_TC_HAM(128)
    PX_TC_HAM(256)
#undef PX_TC_HAM
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// The launch plan of a chunk top-k (kind 0: K1b, u8 rows of D bytes; 1 /
// 2: K4b asym / sym; 3: K2b) over N rows in chunks of R, for Q queries and
// k: plan[0] the query tile, plan[1] the blocks a chunk is split over (>
// 1: the caller passes the parts' buffers [Q, n_chunks, splits, k] keys
// and [Q, n_chunks, splits] counts, and zeroed tickets [ceil(Q / plan[0]),
// n_chunks]).
PX_EXPORT int px_tc_chunk_plan(int kind, int Q, int N, int D, int R, int k, int* plan) {
  if (kind < kU8 || kind > kHamming || (kind == kU8 && D != 32 && D != 64 && D != 128) || Q <= 0 ||
      N <= 0 || R <= 0 || k < 1 || k > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = chunk_query_tile(kind, Q, chunk_cap(k), D);
  plan[1] = chunk_splits((Q + plan[0] - 1) / plan[0], (N + R - 1) / R, R);
  return 0;
}

// K2b on the tensor cores: packed rows uint8 [N, 32] (16-byte aligned),
// row_ok uint8 [N], queries uint8 [Q, 32], limit <= 32; per chunk of R
// rows (a multiple of 128 · splits) the first k <= 1024 by (dist, row) of
// the rows with row_ok != 0 and dist < max_distance, into [Q, n_chunks,
// k]; nq, splits and the parts' buffers as px_tc_chunk_plan gives them.
PX_EXPORT int px_tc_hamming_chunk_topk(const void* q_bytes, float max_distance, const void* data,
                                       const void* row_ok, int Q, int N, int H, int limit, int wrap,
                                       float scale, int R, int k, int n_chunks, int nq, int splits,
                                       void* part_keys, void* part_n, void* tickets, void* out_d,
                                       void* out_i, void* stream) {
  if (H != kPhBytes || limit <= 0 || limit > kPhBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || Q <= 0) return 0;
  CUtensorMap rows;
  const int rc = encode_map(&rows, 2, data, kPhBytes, N, kPhBytes,
                            kPhBytes, kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  ChunkArgs a{};
  a.q_bytes = static_cast<const uint8_t*>(q_bytes);
  a.row_ok = static_cast<const uint8_t*>(row_ok);
  a.max_distance = max_distance;
  a.Q = Q;
  a.N = N;
  a.limit = limit;
  a.wrap = wrap;
  a.scale = scale;
  a.R = R;
  a.k = k;
  a.cap = chunk_cap(k);
  a.n_chunks = n_chunks;
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.splits = splits;
  a.part_keys = static_cast<unsigned long long*>(part_keys);
  a.part_n = static_cast<int*>(part_n);
  a.tickets = static_cast<int*>(tickets);
  return launch_chunk(kHamming, nq, rows, rows, a, stream);
}

// K1b and K4b on the tensor cores: kind 0 (K1b) u8 rows int8 [N, D] (D =
// 32, 64 or 128; 16-byte aligned), kind 1 / 2 (K4b asym / sym) packed int4
// rows uint8 [N, 64] (D = 128); meta int32 [4, N]; queries int8 [Q, D]
// (16-byte aligned; u8 - 128 codes, or 4-bit codes for kind 2); chunks,
// plan and outputs as px_tc_hamming_chunk_topk.
PX_EXPORT int px_tc_cosine_chunk_topk(const void* q_codes, const void* q_sum, const void* q_mag2,
                                      const void* qr, float max_distance, const void* data,
                                      const void* meta, int Q, int N, int D, int kind, int R,
                                      int k, int n_chunks, int nq, int splits, void* part_keys,
                                      void* part_n, void* tickets, float key_scale,
                                      float saturation, float key_loose, void* out_d, void* out_i,
                                      void* stream) {
  const bool ok = kind == kU8 ? (D == 32 || D == 64 || D == 128)
                              : (kind == kInt4Asym || kind == kInt4Sym) && D == kDim4;
  if (!ok || (nq != 8 && nq != 16 && nq != 32 && nq != 64)) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || Q <= 0) return 0;
  const int cb = row_chunk(D), rb = kind == kU8 ? D : D / 2;
  const CUtensorMapSwizzle sw = cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap rows, qm;
  int rc = kind == kU8 ? encode_map(&rows, 2, data, D, N, D, cb, kTileRows, sw)
                       : encode_map(&rows, 2, data, rb, N, rb, rb, kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0) rc = encode_map(&qm, 2, q_codes, D, Q, D, cb, nq, sw);
  if (rc != 0) return rc;
  ChunkArgs a{};
  a.q_sum = static_cast<const int*>(q_sum);
  a.q_mag2 = static_cast<const int*>(q_mag2);
  a.qr = static_cast<const float*>(qr);
  a.meta = static_cast<const int*>(meta);
  a.max_distance = max_distance;
  a.Q = Q;
  a.N = N;
  a.D = D;
  a.R = R;
  a.k = k;
  a.cap = chunk_cap(k);
  a.n_chunks = n_chunks;
  a.key_scale = key_scale;
  a.saturation = saturation;
  a.key_loose = key_loose;
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.splits = splits;
  a.part_keys = static_cast<unsigned long long*>(part_keys);
  a.part_n = static_cast<int*>(part_n);
  a.tickets = static_cast<int*>(tickets);
  return launch_chunk(kind, nq, rows, qm, a, stream);
}
