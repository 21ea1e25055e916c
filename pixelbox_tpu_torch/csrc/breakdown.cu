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
// It is built from K1a's own device functions (scan_device.cuh: the
// staged-query __dp4a row dot, centered_dot, spec_cos, spec_dist) and its
// tiling (256 threads, one row each; 32 queries staged per block), so a
// rung's time is K1a's time up to that stage.  A block holds one tile's
// rows of a few lanes (every 128-row register of the tile), which keeps
// the chain's per-lane summary inside the block.
//
// The TPU sums the tiles in grid order; blocks here run in no order.  So
// each block writes its tile's partials and a second pass adds them in
// tile order, op for op as the JAX kernel does, which makes the output
// bit-identical to the sequential sum.  Tile minima use an atomicMin on
// an order-preserving key (exact in any order); the int64 dot sums are
// exact in any order.
//
// What bounds it: like K1a, the D/4 __dp4a per (query, row) at Q >= 32;
// the chain rung also writes 12 bytes of partials per (tile, query, lane)
// and reads them back in the second pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_device.cuh"

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
// rounded, no contraction).  The gemm rung also totals the dot sums.
template <int RUNG>
__global__ void __launch_bounds__(kThreads)
ladder_sum_kernel(int Q, int T, const int* __restrict__ part_dot,
                  const unsigned long long* __restrict__ part_sum,
                  const unsigned* __restrict__ part_min,
                  const float* __restrict__ part_lmin,
                  const float* __restrict__ part_l2min,
                  const int* __restrict__ part_meta, float* __restrict__ out,
                  unsigned long long* __restrict__ dot_sum) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Q * kLanes) return;
  const int q = idx / kLanes, lane = idx % kLanes;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t o = (static_cast<size_t>(t) * Q + q) * kLanes + lane;
    if constexpr (RUNG == kGemm) {
      acc = __fadd_rn(acc, __int2float_rn(part_dot[o]));
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
  out[idx] = acc;
  if constexpr (RUNG == kGemm) {
    if (lane == 0) {
      unsigned long long s = 0;
      for (int t = 0; t < T; ++t) s += part_sum[static_cast<size_t>(t) * Q + q];
      dot_sum[q] = s;
    }
  }
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
  ladder_sum_kernel<RUNG><<<(Q * kLanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      Q, T, static_cast<const int*>(part_dot),
      static_cast<const unsigned long long*>(part_sum),
      static_cast<const unsigned*>(part_min), static_cast<const float*>(part_lmin),
      static_cast<const float*>(part_l2min), static_cast<const int*>(part_meta),
      static_cast<float*>(out), static_cast<unsigned long long*>(dot_sum));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One rung (0 gemm, 1 coskey, 2 epilogue, 3 chain) over int8 rows [N, D]
// and their [4, N] meta; N a multiple of tile_rows, tile_rows / 128 a
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
