// The breakdown ladder on Hopper (sm_90a): K1a's stages one rung at a time.
//
// Replaces scripts/measure_breakdown.py:_ablate_kernel (launched at :127
// by run_ablation): a profiling kernel that runs the threshold kernel's
// work up to one stage and folds what it computed into a [Q, 128] f32
// output, so that differences between rungs time each stage.
//   gemm      the int8 product; lanes 0..127 of each tile's dots summed
//             over the tiles (and every dot summed into a [Q] int64, so
//             the whole product is live)
//   coskey    + the cos key -cos of K1d and its filter -cos < -0.5; lane 0
//             sums each tile's least key
//   epilogue  + the spec v2 distance of K1a and its filter dist < 0.02;
//             lane 0 sums each tile's least distance
//   chain     + the TPU's depth-2 lane-class summary: per lane and tile,
//             the least two (value, 128-row register) pairs and the count
//             of passing rows, folded into every lane
// The queries' rsqrt is the JAX stand-in 1e-3, and rr is meta row 2.
//
// tc_ladder_kernel, the ladder that ships, is built from the shipping
// K1a's product (tc_scan.cu, with tc_device.cuh's TMA ring and
// wgmma_s8.cuh's int8 wgmma): one warpgroup a block, rows of D = 128
// bytes K-major as wgmma's A by TMA (one 128-byte swizzle row), up to 256
// queries as B, the rungs computed from the
// accumulators in their fragment layout.  The chain needs each (query,
// lane)'s registers in order, so a 64-row sub-tile is one lane's 64
// registers of a tile (TILE = 8,192; L = 64 / regs lanes at smaller
// tiles), loaded by a 3-D TMA box (rows 128 apart): a thread's
// accumulator rows are then registers in order.  A block takes half the
// lanes of a tile (a persistent grid walks (query tile, tile, half)).
//   gemm      the sub-tiles' products accumulate in the tensor cores
//             (scale_d = 1), so the rung is the product alone; after each
//             sub-tile its register-0 row is stored, running (the sum
//             pass takes differences), and at the half's end the
//             accumulators, the sum of every dot, go to the [Q] int64
//   coskey /  per pair the exact f32 centered dot by K1a's magic-number
//   epilogue  add, then the key (a max of cos over the half: min(-cos) =
//             -max(cos), and its filter passes iff the max does) or the
//             spec distance on every pair (IEEE divide); a running max /
//             min per query in registers, atomicMin'd per tile at the end
//   chain     the values staged in shared memory [64 rows][Q], then each
//             (query, lane) scanned over its registers in order
// Invalid rows carry a NaN rsqrt, so that they pass no filter (a NaN cos
// clamps to 1e-6: a distance of ~1e6).
//
// breakdown_ladder_dp4a, the first port's ladder, kept as the timing
// reference: ladder_kernel, built from the first port's K1a device
// functions (scan_device.cuh: the staged-query __dp4a row dot,
// centered_dot, spec_cos, spec_dist) and its tiling (256 threads, one row
// each; 32 queries staged per block).  A block holds one tile's rows of a
// few lanes (every 128-row register of the tile), which keeps the chain's
// per-lane summary inside the block.  It is bound like that K1a by the
// D/4 __dp4a per (query, row).
//
// The TPU sums the tiles in grid order; blocks here run in no order.  So
// each block writes its tile's partials and a second pass adds them in
// tile order, op for op as the JAX kernel does, which makes the output
// bit-identical to the sequential sum.  Tile minima use an atomicMin on
// an order-preserving key (exact in any order); the int64 dot sums are
// exact in any order.
//
// What bounds the tensor-core ladder: the rows' bytes and the int8
// product (2·Q·N·D at 1,979 TOP/s) for gemm; past it the per-pair ALU
// work of the rung (a few operations for the key, an IEEE divide for the
// distance, the staged scan for the chain).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_device.cuh"
#include "tc_device.cuh"
#include "wgmma_s8.cuh"

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum : int { kGemm = 0, kCosKey = 1, kEpilogue = 2, kChain = 3 };

constexpr int kLanes = 128;           // the TPU output's lanes: out is [Q, 128]
constexpr float kQr = 1e-3f;          // the JAX stand-in for the query rsqrt
constexpr float kTheta = 0.02f;       // the epilogue rung's distance filter
constexpr float kKeyTheta = -0.5f;    // the coskey rung's key filter
constexpr unsigned kNoMin = 0xffffffffu;  // the min key of a tile with no value

// Order-preserving map of an f32 to an unsigned key (any sign), and back;
// kNoMin reads +inf.
__device__ __forceinline__ unsigned ordered_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  if (k == kNoMin) return __int_as_float(0x7f800000);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The value a rung keeps for one (query, row), +inf where the filter fails.
template <int RUNG>
__device__ __forceinline__ float rung_value(int dot_c, float rr, float q_mag2f,
                                            float row_mag2f) {
  const float inf = __int_as_float(0x7f800000);
  if constexpr (RUNG == kCosKey) {
    const float key = -spec_cos(dot_c, kQr, rr);
    return key < kKeyTheta ? key : inf;
  } else {
    const float dist = spec_dist(dot_c, kQr, rr, q_mag2f, row_mag2f);
    return dist < kTheta ? dist : inf;
  }
}

// Rung pass.  Grid (tiles * groups, ceil(Q / 32)); block b of a tile
// holds lanes [g * L, (g + 1) * L) of every 128-row register of the tile,
// L = 256 / (tile_rows / 128); thread t takes register t / L, lane
// g * L + t % L.
template <int RUNG>
__global__ void __launch_bounds__(kThreads)
ladder_kernel(const int8_t* __restrict__ q_codes, const int* __restrict__ q_sum,
              const float* __restrict__ q_mag2f,
              const int8_t* __restrict__ data, const int* __restrict__ meta,
              int Q, int N, int D, int tile_rows, int* __restrict__ part_dot,
              unsigned long long* __restrict__ part_sum,
              unsigned* __restrict__ part_min, float* __restrict__ part_lmin,
              float* __restrict__ part_l2min, int* __restrict__ part_meta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_sum[kCollectQueries];
  __shared__ unsigned s_min[kCollectQueries];
  int8_t* q_sh = reinterpret_cast<int8_t*>(smem);
  float* vbuf = reinterpret_cast<float*>(smem + ((kCollectQueries * D + 15) & ~15));

  const int regs = tile_rows / kLanes;
  const int lanes = kThreads / regs;
  const int groups = kLanes / lanes;
  const int tile = blockIdx.x / groups;
  const int group = blockIdx.x % groups;
  const int reg = threadIdx.x / lanes;
  const int lane = group * lanes + threadIdx.x % lanes;
  const int row = tile * tile_rows + reg * kLanes + lane;
  const int q0 = blockIdx.y * kCollectQueries;
  const int nq = min(kCollectQueries, Q - q0);
  if (threadIdx.x < kCollectQueries) {
    s_sum[threadIdx.x] = 0ull;
    s_min[threadIdx.x] = kNoMin;
  }
  stage_queries<kCollectQueries, int8_t>(q_codes, q0, nq, D, q_sh);
  __syncthreads();

  int acc[kCollectQueries];
  // The gemm rung multiplies every row, as the JAX kernel does; the
  // others skip tombstones and padding like K1a (their value is +inf).
  const int row_mag2 = RUNG == kGemm ? 1 : meta[N + row];
  const bool live = row_mag2 > 0;
  if (live) {
    kind_row_dot<kU8, kCollectQueries>(data, row, q_sh, D, acc);
  } else {
#pragma unroll
    for (int j = 0; j < kCollectQueries; ++j) acc[j] = 0;
  }
  const int wl = threadIdx.x & 31;

  if constexpr (RUNG == kGemm) {
    if (reg == 0) {
      for (int j = 0; j < nq; ++j)
        part_dot[(static_cast<size_t>(tile) * Q + q0 + j) * kLanes + lane] = acc[j];
    }
    // A warp's 32 dots of a query fit int32 (|dot| <= 128^2 * D each, and
    // the wrapper takes D <= 512), so the warp sums in 32 bits and the
    // block in 64.
#pragma unroll
    for (int j = 0; j < kCollectQueries; ++j) {
      int v = acc[j];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (wl == 0 && j < nq)
        atomicAdd(&s_sum[j], static_cast<unsigned long long>(static_cast<long long>(v)));
    }
    __syncthreads();
    if (threadIdx.x < nq)
      atomicAdd(&part_sum[static_cast<size_t>(tile) * Q + q0 + threadIdx.x],
                s_sum[threadIdx.x]);
    return;
  } else {
    const int row_sum = meta[row];
    const float rr = __int_as_float(meta[2 * N + row]);
    const float row_mag2f = __int2float_rn(row_mag2);
    const float inf = __int_as_float(0x7f800000);
    float v[kCollectQueries];
#pragma unroll
    for (int j = 0; j < kCollectQueries; ++j) {
      v[j] = inf;
      if (live && j < nq) {
        const int q = q0 + j;
        v[j] = rung_value<RUNG>(centered_dot<kU8>(acc[j], q_sum[q], row_sum, D), rr,
                                q_mag2f[q], row_mag2f);
      }
    }
    if constexpr (RUNG == kChain) {
#pragma unroll
      for (int j = 0; j < kCollectQueries; ++j) vbuf[j * kThreads + threadIdx.x] = v[j];
      __syncthreads();
      // The JAX chain, register by register in order: strict < keeps the
      // earliest register among equal values.
      for (int p = threadIdx.x; p < nq * lanes; p += kThreads) {
        const int j = p / lanes, li = p % lanes;
        float lmin = inf, l2min = inf;
        int lreg = 0, l2reg = 0, lcnt = 0;
        for (int r = 0; r < regs; ++r) {
          const float x = vbuf[j * kThreads + r * lanes + li];
          lcnt += x < inf;
          const bool upd1 = x < lmin;
          const float dval = upd1 ? lmin : x;
          const int dreg = upd1 ? lreg : r;
          if (upd1) {
            lmin = x;
            lreg = r;
          }
          if (dval < l2min) {
            l2min = dval;
            l2reg = dreg;
          }
        }
        const size_t o = (static_cast<size_t>(tile) * Q + q0 + j) * kLanes + group * lanes + li;
        part_lmin[o] = lmin;
        part_l2min[o] = l2min;
        part_meta[o] = lcnt | (lreg << 9) | (l2reg << 17);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCollectQueries; ++j) {
        unsigned m = ordered_key(v[j]);
        for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_down_sync(0xffffffffu, m, off));
        if (wl == 0 && j < nq) atomicMin(&s_min[j], m);
      }
      __syncthreads();
      if (threadIdx.x < nq)
        atomicMin(&part_min[static_cast<size_t>(tile) * Q + q0 + threadIdx.x], s_min[threadIdx.x]);
    }
  }
}

// Second pass: one thread per (query, lane) adds the tiles' partials in
// tile order, as the TPU's sequential grid does (every add correctly
// rounded, no contraction).  The partials are [T, Q, 128] (lane fastest)
// for the __dp4a ladder, [T, 128, Q] (query fastest) for the tensor-core
// one, whose gemm partials run over a half's sub-tiles of L lanes each:
// a lane's dot is its entry less the one L lanes before, within a half.
// The __dp4a gemm rung also totals the dot sums.
template <int RUNG, bool TC>
__global__ void __launch_bounds__(kThreads)
ladder_sum_kernel(int Q, int T, int L, const int* __restrict__ part_dot,
                  const unsigned long long* __restrict__ part_sum,
                  const unsigned* __restrict__ part_min,
                  const float* __restrict__ part_lmin,
                  const float* __restrict__ part_l2min,
                  const int* __restrict__ part_meta, float* __restrict__ out,
                  unsigned long long* __restrict__ dot_sum) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Q * kLanes) return;
  const int q = TC ? idx % Q : idx / kLanes, lane = TC ? idx / Q : idx % kLanes;
  auto at = [&](int t, int l) {
    return TC ? (static_cast<size_t>(t) * kLanes + l) * Q + q : (static_cast<size_t>(t) * Q + q) * kLanes + l;
  };
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t o = at(t, lane);
    if constexpr (RUNG == kGemm) {
      int dot = part_dot[o];
      if (TC && lane % 64 >= L) dot -= part_dot[at(t, lane - L)];
      acc = __fadd_rn(acc, __int2float_rn(dot));
    } else if constexpr (RUNG == kChain) {
      const int m = part_meta[o];
      acc = __fadd_rn(acc, part_lmin[o]);
      acc = __fadd_rn(acc, part_l2min[o]);
      acc = __fadd_rn(acc, __int2float_rn(m & 511));
      acc = __fadd_rn(acc, __int2float_rn((m >> 9) & 255));
      acc = __fadd_rn(acc, __int2float_rn((m >> 17) & 255));
    } else {
      acc = __fadd_rn(acc, lane == 0 ? key_value(part_min[static_cast<size_t>(t) * Q + q]) : 0.0f);
    }
  }
  out[static_cast<size_t>(q) * kLanes + lane] = acc;
  if constexpr (RUNG == kGemm && !TC) {
    if (lane == 0) {
      unsigned long long s = 0;
      for (int t = 0; t < T; ++t) s += part_sum[static_cast<size_t>(t) * Q + q];
      dot_sum[q] = s;
    }
  }
}

template <int RUNG, bool TC>
int launch_sum(int Q, int T, int L, void* part_dot, void* part_sum, void* part_min, void* part_lmin,
               void* part_l2min, void* part_meta, void* out, void* dot_sum, cudaStream_t s) {
  ladder_sum_kernel<RUNG, TC><<<(Q * kLanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      Q, T, L, static_cast<const int*>(part_dot),
      static_cast<const unsigned long long*>(part_sum),
      static_cast<const unsigned*>(part_min), static_cast<const float*>(part_lmin),
      static_cast<const float*>(part_l2min), static_cast<const int*>(part_meta),
      static_cast<float*>(out), static_cast<unsigned long long*>(dot_sum));
  return static_cast<int>(cudaGetLastError());
}

template <int RUNG>
int launch_ladder(const void* q_codes, const void* q_sum, const void* q_mag2f,
                  const void* data, const void* meta, int Q, int N, int D,
                  int tile_rows, void* part_dot, void* part_sum, void* part_min,
                  void* part_lmin, void* part_l2min, void* part_meta, void* out,
                  void* dot_sum, void* stream) {
  const int T = N / tile_rows;
  const int regs = tile_rows / kLanes;
  const int groups = kLanes / (kThreads / regs);
  const dim3 grid(T * groups, (Q + kCollectQueries - 1) / kCollectQueries);
  size_t smem = (static_cast<size_t>(kCollectQueries) * D + 15) & ~static_cast<size_t>(15);
  if (RUNG == kChain) smem += static_cast<size_t>(kCollectQueries) * kThreads * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ladder_kernel<RUNG><<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
      static_cast<const float*>(q_mag2f), static_cast<const int8_t*>(data),
      static_cast<const int*>(meta), Q, N, D, tile_rows,
      static_cast<int*>(part_dot), static_cast<unsigned long long*>(part_sum),
      static_cast<unsigned*>(part_min), static_cast<float*>(part_lmin),
      static_cast<float*>(part_l2min), static_cast<int*>(part_meta));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_sum<RUNG, false>(Q, T, 0, part_dot, part_sum, part_min, part_lmin, part_l2min,
                                 part_meta, out, dot_sum, s);
}

// ---- The tensor-core ladder

constexpr int kLadderRing = 4;  // row sub-tiles in the TMA ring (8 KB each at D = 128)
constexpr int kHalfLanes = kLanes / 2;  // a block item: half the lanes of a tile

// The chain's stage pitch (floats) of a row of kCols queries: a warp's
// float2 stores take the fewest shared-memory wavefronts.
__host__ __device__ constexpr int ladder_pitch(int cols) { return cols + 8; }

// The exact f32 centered dot from an accumulator (tc_scan.cu's K1a phase
// 1): 2·dot8 + row_sum added to kMagic2's bits (rc = kMagic2Bits +
// row_sum) is kMagic2 + 4·dot8 + 2·row_sum, then + z = f32(2·q_sum + D) −
// kMagic2 lands on f32(dot_c) exactly.
__device__ __forceinline__ float centered_f32(int acc, int rc, float z) {
  return __fadd_rn(__int_as_float(2 * acc + rc), z);
}

// spec_dist's epilogue from the exact f32 centered dot and its cos.
__device__ __forceinline__ float ladder_dist(float dot_f, float cosv, float q_mag2f, float row_mag2f) {
  float dist = __fsub_rn(__fdiv_rn(1.0f, fmaxf(cosv, 1e-6f)), 1.0f);
  dist = fmaxf(dist, 0.0f);
  if (dot_f == q_mag2f && q_mag2f == row_mag2f) dist = 0.0f;
  return dist;
}

// Shared-memory layout of a ladder block (byte offsets from a 1024-aligned
// base): the queries' B operand, the ring of row sub-tiles, per query
// (z, f32(q_mag2)), the chain's stage [64 rows][pitch] of up to 128
// queries, the warps' partials [4][nq] (8 bytes each), the mbarriers.
struct LadderSmem {
  int q, rows, qc, stage, red, bars, total;
  __host__ __device__ LadderSmem(int nq, int d, int rung)
      : q(0),
        rows(round_up(nq * d, 1024)),
        qc(rows + kLadderRing * kTileRows * d),
        stage(qc + nq * 8),
        red(stage + (rung == kChain ? kTileRows * ladder_pitch(nq < 128 ? nq : 128) * 4 : 0)),
        bars(red + 4 * nq * 8),
        total(bars + (kLadderRing + 1) * 8) {}
};

template <int NQ, int RUNG>
__global__ void __launch_bounds__(kTcThreads)
tc_ladder_kernel(const __grid_constant__ CUtensorMap rows_map,
                 const __grid_constant__ CUtensorMap q_map, const int* __restrict__ q_sum,
                 const float* __restrict__ q_mag2f, const int* __restrict__ meta, int Q, int N,
                 int D, int regs, int* __restrict__ part_dot, unsigned* __restrict__ part_min,
                 float* __restrict__ part_lmin, float* __restrict__ part_l2min,
                 int* __restrict__ part_meta, unsigned long long* __restrict__ dot_sum) {
  extern __shared__ uint8_t ladder_smem_raw[];
  constexpr bool kRun = RUNG == kCosKey || RUNG == kEpilogue;  // a running max / min per query
  const LadderSmem S(NQ, D, RUNG);
  uint8_t* sm = align_smem(ladder_smem_raw);
  int8_t* q_tile = reinterpret_cast<int8_t*>(sm + S.q);
  int8_t* rows = reinterpret_cast<int8_t*>(sm + S.rows);
  float2* qc = reinterpret_cast<float2*>(sm + S.qc);
  float* stage = reinterpret_cast<float*>(sm + S.stage);
  unsigned long long* red = reinterpret_cast<unsigned long long*>(sm + S.red);
  float* redf = reinterpret_cast<float*>(red);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S.bars);
  uint64_t* qbar = full + kLadderRing;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = kTileRows / regs;     // lanes a sub-tile holds, each with its `regs` registers
  const int per_qt = 2 * (N / (kLanes * regs));  // items (tile, half) of a query tile
  const int n_all = (Q + NQ - 1) / NQ * per_qt;
  const int my_items = (n_all - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_sub = my_items * regs;  // this block's sub-tiles (regs an item)
  const float inf = __int_as_float(0x7f800000), nan = __int_as_float(0x7fc00000);

  // Sub-tile it: its item (query tile, tile, half), its tile t and first lane.
  auto item_of = [&](int it) { return static_cast<int>(blockIdx.x) + it / regs * static_cast<int>(gridDim.x); };
  auto tile_of = [&](int item) { return (item % per_qt) >> 1; };
  auto lane0_of = [&](int item, int j) { return kHalfLanes * (item & 1) + j * L; };

  if (tid == 0) {
    for (int s = 0; s <= kLadderRing; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // A sub-tile by TMA: a box of L lanes x regs registers (local row reg·L +
  // l), one 128-byte swizzle row each.
  auto issue = [&](int it) {
    const int s = it % kLadderRing, item = item_of(it);
    mbar_expect_tx(full + s, kTileRows * D);
    tma_load_3d(rows + s * kTileRows * D, &rows_map, full + s, 0, lane0_of(item, it % regs),
                tile_of(item) * regs);
  };
  if (tid == 0)
    for (int it = 0; it < min(kLadderRing, n_sub); ++it) issue(it);

  // Meta rows 0-2 (row_sum, mag2, rr) of this thread's two rows of a
  // sub-tile (local rows r0 and r0 + 8), read one sub-tile ahead.
  const int r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  auto load_meta = [&](int it, int (&m)[2][3]) {
    const int item = item_of(it);
    const int base = tile_of(item) * kLanes * regs + lane0_of(item, it % regs);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rho = r0 + 8 * h, row = base + kLanes * (rho / L) + rho % L;
#pragma unroll
      for (int j = 0; j < 3; ++j) m[h][j] = __ldg(meta + static_cast<size_t>(j) * N + row);
    }
  };
  int meta_next[2][3] = {};
  if (RUNG != kGemm && n_sub > 0) load_meta(0, meta_next);

  const uint32_t q_addr = smem_u32(q_tile), rows_addr = smem_u32(rows);
  const float reset = RUNG == kCosKey ? -inf : inf;
  float run[kRun ? NQ / 4 : 1];
#pragma unroll
  for (int i = 0; i < (kRun ? NQ / 4 : 1); ++i) run[i] = reset;
  int acc[NQ / 2];
  int qt_cur = -1, q_loads = 0;

  for (int it = 0; it < n_sub; ++it) {
    const int item = item_of(it), j = it % regs;
    const int qt = item / per_qt, t = tile_of(item), lam0 = lane0_of(item, j);
    const int q0 = qt * NQ;
    if (qt != qt_cur) {  // a new query tile: its codes by TMA, its constants
      __syncthreads();
      if (tid == 0) {
        mbar_expect_tx(qbar, NQ * D);
        tma_load_2d(q_tile, &q_map, qbar, 0, q0);
      }
      for (int c = tid; c < NQ; c += kTcThreads) {
        const int q = q0 + c;
        // z = f32(2·q_sum + D) − kMagic2: the query's part of the exact
        // centered dot (tc_scan.cu's K1a phase 1)
        qc[c] = q < Q ? make_float2(__fsub_rn(__int2float_rn(2 * q_sum[q] + D), kMagic2), q_mag2f[q])
                      : make_float2(0.0f, 0.0f);
      }
      __syncthreads();
      mbar_wait(qbar, q_loads & 1);
      ++q_loads;
      qt_cur = qt;
    }
    int rc[2];
    float inv[2], rm2f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rc[h] = kMagic2Bits + meta_next[h][0];
      rm2f[h] = __int2float_rn(meta_next[h][1]);
      inv[h] = meta_next[h][1] > 0 ? __fmul_rn(kQr, __int_as_float(meta_next[h][2])) : nan;
    }
    if (RUNG != kGemm && it + 1 < n_sub) load_meta(it + 1, meta_next);

    // The product: K1a's descriptors; the gemm rung accumulates a half's
    // sub-tiles in the tensor cores.
    const int s = it % kLadderRing;
    mbar_wait(full + s, (it / kLadderRing) & 1);
    wgmma_fence();
    const uint32_t a0 = rows_addr + s * kTileRows * D;
    for (int k = 0; k < D / 32; ++k)  // the 128B-swizzled layout (1)
      Wgmma<NQ>::ss(acc, smem_desc(a0 + 32 * k, kTileRows * D, 8 * D, 1u),
                    smem_desc(q_addr + 32 * k, NQ * D, 8 * D, 1u), (RUNG == kGemm && j > 0) || k > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);

    if constexpr (RUNG == kGemm) {
      // A register-0 row (local row < L): its running dots, lane lam0 + row.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rho = r0 + 8 * h;
        if (rho < L) {
          int* o = part_dot + (static_cast<size_t>(t) * kLanes + lam0 + rho) * Q + q0;
#pragma unroll
          for (int j8 = 0; j8 < NQ / 8; ++j8) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j8 + 2 * tq + e;
              if (q0 + c < Q) o[c] = acc[4 * j8 + 2 * h + e];
            }
          }
        }
      }
    } else if constexpr (kRun) {
#pragma unroll
      for (int j8 = 0; j8 < NQ / 8; ++j8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 k = qc[8 * j8 + 2 * tq + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dot_f = centered_f32(acc[4 * j8 + 2 * h + e], rc[h], k.x);
            const float cosv = __fmul_rn(dot_f, inv[h]);
            if constexpr (RUNG == kCosKey)
              run[2 * j8 + e] = fmaxf(run[2 * j8 + e], cosv);
            else
              run[2 * j8 + e] = fminf(run[2 * j8 + e], ladder_dist(dot_f, cosv, k.y, rm2f[h]));
          }
        }
      }
    } else {
      // The chain: the values staged [64 rows][kCols] a pass of kCols
      // queries (two passes at 256, so that two blocks fit an SM), then
      // each (query, lane) of the sub-tile scanned over its registers in
      // order — the JAX chain (strict < keeps the earliest register among
      // equals).
      constexpr int kCols = NQ < 128 ? NQ : 128;
#pragma unroll
      for (int pass = 0; pass < NQ / kCols; ++pass) {
        if (pass > 0) __syncthreads();  // the previous pass has read the stage
#pragma unroll
        for (int j8 = pass * kCols / 8; j8 < (pass + 1) * kCols / 8; ++j8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float2 k = qc[8 * j8 + 2 * tq + e];
              const float dot_f = centered_f32(acc[4 * j8 + 2 * h + e], rc[h], k.x);
              const float dist = ladder_dist(dot_f, __fmul_rn(dot_f, inv[h]), k.y, rm2f[h]);
              v[e] = dist < kTheta ? dist : inf;
            }
            *reinterpret_cast<float2*>(stage + (r0 + 8 * h) * ladder_pitch(kCols) + 8 * j8 + 2 * tq -
                                       pass * kCols) = make_float2(v[0], v[1]);
          }
        }
        __syncthreads();
        for (int p = tid; p < kCols * L; p += kTcThreads) {
          const int c = p % kCols, l = p / kCols;
          float lmin = inf, l2min = inf;
          int lreg = 0, l2reg = 0, lcnt = 0;
#pragma unroll 8
          for (int r = 0; r < regs; ++r) {
            const float x = stage[(r * L + l) * ladder_pitch(kCols) + c];
            lcnt += x < inf;
            const bool upd1 = x < lmin;
            const float dval = upd1 ? lmin : x;
            const int dreg = upd1 ? lreg : r;
            if (upd1) {
              lmin = x;
              lreg = r;
            }
            if (dval < l2min) {
              l2min = dval;
              l2reg = dreg;
            }
          }
          const int q = q0 + pass * kCols + c;
          if (q < Q) {
            const size_t o = (static_cast<size_t>(t) * kLanes + lam0 + l) * Q + q;
            part_lmin[o] = lmin;
            part_l2min[o] = l2min;
            part_meta[o] = lcnt | (lreg << 9) | (l2reg << 17);
          }
        }
      }
    }
    // The slot (and the stage) are read: refill the slot.
    __syncthreads();
    if (tid == 0 && it + kLadderRing < n_sub) issue(it + kLadderRing);

    if (j == regs - 1) {  // the half's end: its partials, per query over the block
      if constexpr (RUNG == kGemm) {
        // The accumulators hold the half's dots summed per (row, query):
        // over the thread's two rows, the warp's 8 row groups, the warps.
#pragma unroll
        for (int j8 = 0; j8 < NQ / 8; ++j8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            long long x = static_cast<long long>(acc[4 * j8 + e]) + acc[4 * j8 + 2 + e];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
            if (lane < 4) red[warp * NQ + 8 * j8 + 2 * tq + e] = static_cast<unsigned long long>(x);
          }
        }
        __syncthreads();
        for (int c = tid; c < NQ; c += kTcThreads)
          if (q0 + c < Q) atomicAdd(dot_sum + q0 + c, red[c] + red[NQ + c] + red[2 * NQ + c] + red[3 * NQ + c]);
      } else if constexpr (kRun) {
#pragma unroll
        for (int i = 0; i < NQ / 4; ++i) {
          float m = run[i];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, m, o);
            m = RUNG == kCosKey ? fmaxf(m, y) : fminf(m, y);
          }
          if (lane < 4) redf[warp * NQ + 8 * (i >> 1) + 2 * tq + (i & 1)] = m;
          run[i] = reset;
        }
        __syncthreads();
        for (int c = tid; c < NQ; c += kTcThreads) {
          if (q0 + c >= Q) continue;
          float m = redf[c];
          for (int w = 1; w < 4; ++w) m = RUNG == kCosKey ? fmaxf(m, redf[w * NQ + c]) : fminf(m, redf[w * NQ + c]);
          // min(-cos) over the kept = -max(cos) when it passes -cos < -0.5;
          // the least distance when it passes dist < 0.02; else +inf
          const float v = RUNG == kCosKey ? (m > -kKeyTheta ? -m : inf) : (m < kTheta ? m : inf);
          atomicMin(part_min + static_cast<size_t>(t) * Q + q0 + c, ordered_key(v));
        }
      }
    }
  }
}

template <int NQ, int RUNG>
int launch_tc_ladder(const CUtensorMap& rows, const CUtensorMap& qm, const void* q_sum,
                     const void* q_mag2f, const void* meta, int Q, int N, int D, int regs,
                     void* part_dot, void* part_min, void* part_lmin, void* part_l2min,
                     void* part_meta, void* out, void* dot_sum, cudaStream_t s) {
  const size_t smem = LadderSmem(NQ, D, RUNG).total + 1024;
  const int T = N / (kLanes * regs);
  int grid = 0;
  int rc = persistent_grid(tc_ladder_kernel<NQ, RUNG>, smem, (Q + NQ - 1) / NQ * 2 * T, &grid);
  if (rc != 0) return rc;
  tc_ladder_kernel<NQ, RUNG><<<grid, kTcThreads, smem, s>>>(
      rows, qm, static_cast<const int*>(q_sum), static_cast<const float*>(q_mag2f),
      static_cast<const int*>(meta), Q, N, D, regs, static_cast<int*>(part_dot),
      static_cast<unsigned*>(part_min), static_cast<float*>(part_lmin),
      static_cast<float*>(part_l2min), static_cast<int*>(part_meta),
      static_cast<unsigned long long*>(dot_sum));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_sum<RUNG, true>(Q, T, kTileRows / regs, part_dot, nullptr, part_min, part_lmin,
                                part_l2min, part_meta, out, dot_sum, s);
}

}  // namespace

// One rung of the __dp4a ladder (0 gemm, 1 coskey, 2 epilogue, 3 chain)
// over int8 rows [N, D] and their [4, N] meta; N a multiple of tile_rows, tile_rows / 128 a
// power of two from 2 to 256.  part_* are the caller's scratch: part_dot
// i32 [T, Q, 128] and part_sum u64 [T, Q] (zeroed) for gemm, part_min u32
// [T, Q] (all ones) for coskey and epilogue, part_lmin / part_l2min f32
// and part_meta i32 [T, Q, 128] for chain; out [Q, 128] f32, dot_sum [Q]
// i64 (gemm).
PX_EXPORT int px_ladder(int rung, const void* q_codes, const void* q_sum,
                        const void* q_mag2f, const void* data, const void* meta,
                        int Q, int N, int D, int tile_rows, void* part_dot,
                        void* part_sum, void* part_min, void* part_lmin,
                        void* part_l2min, void* part_meta, void* out,
                        void* dot_sum, void* stream) {
  switch (rung) {
    case kGemm:
      return launch_ladder<kGemm>(q_codes, q_sum, q_mag2f, data, meta, Q, N, D,
                                  tile_rows, part_dot, part_sum, part_min,
                                  part_lmin, part_l2min, part_meta, out,
                                  dot_sum, stream);
    case kCosKey:
      return launch_ladder<kCosKey>(q_codes, q_sum, q_mag2f, data, meta, Q, N,
                                    D, tile_rows, part_dot, part_sum, part_min,
                                    part_lmin, part_l2min, part_meta, out,
                                    dot_sum, stream);
    case kEpilogue:
      return launch_ladder<kEpilogue>(q_codes, q_sum, q_mag2f, data, meta, Q,
                                      N, D, tile_rows, part_dot, part_sum,
                                      part_min, part_lmin, part_l2min,
                                      part_meta, out, dot_sum, stream);
    case kChain:
      return launch_ladder<kChain>(q_codes, q_sum, q_mag2f, data, meta, Q, N,
                                   D, tile_rows, part_dot, part_sum, part_min,
                                   part_lmin, part_l2min, part_meta, out,
                                   dot_sum, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One rung of the tensor-core ladder (0 gemm, 1 coskey, 2 epilogue, 3
// chain) over int8 rows [N, D] (D = 128; 16-byte aligned) and
// their [4, N] meta, queries int8 [Q, D] (16-byte aligned); N a multiple
// of tile_rows, tile_rows / 128 a power of two from 2 to 64.  part_* are
// the caller's scratch: part_dot i32 [T, 128, Q] for gemm, part_min u32
// [T, Q] (all ones) for coskey and epilogue, part_lmin / part_l2min f32
// and part_meta i32 [T, 128, Q] for chain; out [Q, 128] f32, dot_sum [Q]
// i64 (zeroed; gemm).
PX_EXPORT int px_tc_ladder(int rung, const void* q_codes, const void* q_sum, const void* q_mag2f,
                           const void* data, const void* meta, int Q, int N, int D, int tile_rows,
                           void* part_dot, void* part_min, void* part_lmin, void* part_l2min,
                           void* part_meta, void* out, void* dot_sum, void* stream) {
  const int regs = tile_rows / kLanes;
  if (D != 128 || tile_rows % kLanes != 0 || regs < 2 || regs > kTileRows ||
      (regs & (regs - 1)) != 0 || N % tile_rows != 0 || rung < kGemm || rung > kChain)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || Q <= 0) return 0;
  const int nq = Q <= 64 ? 64 : 256;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // The rows as [N / 128 registers][128 lanes][D]: a box of one lane
  // group's registers.
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(kLanes),
                              static_cast<cuuint64_t>(N / kLanes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(kLanes) * D};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(kTileRows / regs),
                             static_cast<cuuint32_t>(regs)};
  CUtensorMap rows, qm;
  int rc = encode_tiled(&rows, 3, data, dims, strides, box, sw);
  if (rc == 0) rc = encode_map(&qm, 2, q_codes, D, Q, D, D, nq, sw);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nq * 4 + rung) {
#define PX_TC_LADDER(n, r)                                                                         \
  case n * 4 + r:                                                                                  \
    return launch_tc_ladder<n, r>(rows, qm, q_sum, q_mag2f, meta, Q, N, D, regs, part_dot,         \
                                  part_min, part_lmin, part_l2min, part_meta, out, dot_sum, s);
    PX_TC_LADDER(64, kGemm)
    PX_TC_LADDER(64, kCosKey)
    PX_TC_LADDER(64, kEpilogue)
    PX_TC_LADDER(64, kChain)
    PX_TC_LADDER(256, kGemm)
    PX_TC_LADDER(256, kCosKey)
    PX_TC_LADDER(256, kEpilogue)
    PX_TC_LADDER(256, kChain)
#undef PX_TC_LADDER
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
