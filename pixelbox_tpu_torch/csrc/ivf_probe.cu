// K5: the IVF probe's exact distances (Hopper, sm_90a), and its gathered
// mode, the exact-u8 rescore of per-query candidate rows.
//
// The JAX package has no Pallas kernel here: its probe
// (pixelbox_tpu/ops/ivf.py:_ivf_probe_topk, :498) is XLA — a gather of
// the probed buckets into a [Q, nprobe, cap, D] copy, an einsum, the spec
// epilogue, a per-bucket top-k and a tree merge — and its device rescore
// (ops/ivf_build.py:_rerank_device) the same over gathered rows.  This
// file computes the same function up to the selection; K1c
// (fused_scan.cu, lex_topk) then takes the top k by (dist, row id), which
// equals the per-bucket top-k and the merge because a row sits in one
// bucket.
//
// ivf_probe_kernel: one block a (probed bucket, query).  The block stages
// the query's codes in shared memory and reads the bucket's cap slots IN
// PLACE from bucket_data / bucket_sum / bucket_mag2 (no gather copy), a
// thread a slot: the code dot on __dp4a (row_dot / row_dot4 of
// scan_device.cuh: the u8 rows, or the int4 nibbles unpacked in
// registers), the kind's integer affine fix (centered_dot), the row's
// reciprocal square root rsqrt_spec (the square root in f64, rounded
// once, an IEEE divide — the port's ops/distances.rsqrt_spec) and the
// spec v2 epilogue (spec_dist).  It writes (dist, row id) where the slot
// is valid and dist < max_distance, and (+inf, 2^31 - 1) elsewhere, into
// [Q, nprobe * cap].
//
// ivf_gathered_kernel: a thread a (query, candidate); the candidate's u8
// row is read from the row array [N, D] and its moments are computed in
// the kernel from the bytes (u - 128 = u ^ 0x80 per byte: the code dot,
// the code sum and the sum of squares on __dp4a; mag2 = 4·Σv² + 4·Σv + D
// for v = u - 128), then the u8 kind's fix and epilogue.  Ids outside
// [0, N) are empty.
//
// What bounds them on this card: the probe reads each probed bucket's
// rows and meta once per query (a bucket probed by several queries is
// read by several blocks, mostly from L2) and does D/4 __dp4a a slot: at
// the main shapes it is bound by those reads.  A design on the tensor
// cores (buckets shared by the queries that probe them as wgmma's
// operand, fed by TMA) is later work (ROADMAP.md).
//
// Every f32 op is correctly rounded (explicit __fmul_rn / __fdiv_rn in
// scan_device.cuh, -fmad=false), so the outputs are bit-identical to the
// plain PyTorch versions in ops/ivf.py and ops/ivf_build.py.
//
// Plain C interface, bound with ctypes; every entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_device.cuh"

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kNoRow = 0x7fffffff;

// rsqrt_spec of an integer magnitude: fl(1 / fl(sqrt(f32(m)))), the root
// taken in f64 and rounded once (correctly rounded for any f32 input).
__device__ __forceinline__ float rsqrt_spec_dev(int mag2) {
  const float m = __int2float_rn(mag2);
  const float s = __double2float_rn(__dsqrt_rn(static_cast<double>(m)));
  return __fdiv_rn(1.0f, s);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
ivf_probe_kernel(const int8_t* __restrict__ q_codes, const int* __restrict__ q_sum,
                 const int* __restrict__ q_mag2, const float* __restrict__ qr, float md,
                 const int* __restrict__ bids, const int8_t* __restrict__ bdata,
                 const int* __restrict__ bsum, const int* __restrict__ bmag2,
                 const int* __restrict__ brows, const uint8_t* __restrict__ bvalid, int P,
                 int C, int cap, int D, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) int8_t q_sh[];
  const int p = blockIdx.x, q = blockIdx.y;
  for (int t = threadIdx.x; t < D; t += blockDim.x) q_sh[t] = q_codes[static_cast<size_t>(q) * D + t];
  __syncthreads();
  const int b = bids[static_cast<size_t>(q) * P + p];
  const bool bucket_ok = b >= 0 && b < C;
  const int qs = q_sum[q];
  const int qm = q_mag2[q];
  const float qrr = qr[q];
  const float qmf = __int2float_rn(qm);
  const size_t out0 = (static_cast<size_t>(q) * P + p) * cap;
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    float dist = __int_as_float(0x7f800000);
    int id = kNoRow;
    const int slot = b * cap + s;
    if (bucket_ok && bvalid[slot]) {
      int acc[1];
      kind_row_dot<KIND, 1>(bdata, slot, q_sh, D, acc);
      const int m2 = bmag2[slot];
      const float d = spec_dist(centered_dot<KIND>(acc[0], qs, bsum[slot], D), qrr,
                                rsqrt_spec_dev(m2), qmf, __int2float_rn(m2));
      if (d < md) {
        dist = d;
        id = brows[slot];
      }
    }
    out_d[out0 + s] = dist;
    out_i[out0 + s] = id;
  }
}

__global__ void __launch_bounds__(kThreads)
ivf_gathered_kernel(const int8_t* __restrict__ q_codes, const int* __restrict__ q_sum,
                    const int* __restrict__ q_mag2, const float* __restrict__ qr, float md,
                    const int* __restrict__ cand, const uint8_t* __restrict__ rows, int N, int M,
                    int D, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) int8_t q_sh[];
  const int q = blockIdx.y;
  for (int t = threadIdx.x; t < D; t += blockDim.x) q_sh[t] = q_codes[static_cast<size_t>(q) * D + t];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M) return;
  const size_t o = static_cast<size_t>(q) * M + c;
  const int id = cand[o];
  float dist = __int_as_float(0x7f800000);
  int out_id = kNoRow;
  if (id >= 0 && id < N) {
    const uint8_t* row = rows + static_cast<size_t>(id) * D;
    int dot = 0, sv = 0, sv2 = 0;
    if ((D & 3) == 0) {
      for (int i = 0; i < D; i += 4) {
        const int v = static_cast<int>(*reinterpret_cast<const unsigned*>(row + i) ^ 0x80808080u);
        dot = __dp4a(v, *reinterpret_cast<const int*>(q_sh + i), dot);
        sv = __dp4a(v, 0x01010101, sv);
        sv2 = __dp4a(v, v, sv2);
      }
    } else {
      for (int i = 0; i < D; ++i) {
        const int v = static_cast<int>(row[i]) - 128;
        dot += v * static_cast<int>(q_sh[i]);
        sv += v;
        sv2 += v * v;
      }
    }
    const int m2 = 4 * sv2 + 4 * sv + D;
    const float d = spec_dist(centered_dot<kU8>(dot, q_sum[q], sv, D), qr[q], rsqrt_spec_dev(m2),
                              __int2float_rn(q_mag2[q]), __int2float_rn(m2));
    if (d < md) {
      dist = d;
      out_id = id;
    }
  }
  out_d[o] = dist;
  out_i[o] = out_id;
}

}  // namespace

// K5: kind 0 (int8 buckets [C, cap, D], u8 queries) or 1 (packed int4
// buckets [C, cap, D/2], u8 queries: cosine4a).  bids int32 [Q, P];
// bucket_valid uint8 [C, cap]; out [Q, P * cap].
PX_EXPORT int px_ivf_probe_collect(const void* q_codes, const void* q_sum, const void* q_mag2,
                                   const void* qr, float md, const void* bids,
                                   const void* bdata, const void* bsum, const void* bmag2,
                                   const void* brows, const void* bvalid, int Q, int P, int C,
                                   int cap, int D, int kind, void* out_d, void* out_i,
                                   void* stream) {
  if (Q < 0 || P < 1 || C < 1 || cap < 1 || D < 1 || D > 48 * 1024 || Q > 65535 ||
      (kind != kU8 && kind != kInt4Asym) || (kind == kInt4Asym && (D & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const dim3 grid(P, Q);
  const size_t smem = static_cast<size_t>((D + 15) & ~15);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PX_IVF_ARGS                                                                           \
  static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),                        \
      static_cast<const int*>(q_mag2), static_cast<const float*>(qr), md,                     \
      static_cast<const int*>(bids), static_cast<const int8_t*>(bdata),                       \
      static_cast<const int*>(bsum), static_cast<const int*>(bmag2),                          \
      static_cast<const int*>(brows), static_cast<const uint8_t*>(bvalid), P, C, cap, D,      \
      static_cast<float*>(out_d), static_cast<int*>(out_i)
  if (kind == kU8)
    ivf_probe_kernel<kU8><<<grid, kThreads, smem, st>>>(PX_IVF_ARGS);
  else
    ivf_probe_kernel<kInt4Asym><<<grid, kThreads, smem, st>>>(PX_IVF_ARGS);
#undef PX_IVF_ARGS
  return static_cast<int>(cudaGetLastError());
}

// K5's gathered mode: per query M candidate ids (int32 [Q, M]) into u8
// rows [N, D]; out [Q, M].
PX_EXPORT int px_ivf_gathered_collect(const void* q_codes, const void* q_sum, const void* q_mag2,
                                      const void* qr, float md, const void* cand,
                                      const void* rows, int Q, int N, int M, int D, void* out_d,
                                      void* out_i, void* stream) {
  if (Q < 0 || M < 1 || D < 1 || D > 48 * 1024 || Q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const dim3 grid((M + kThreads - 1) / kThreads, Q);
  const size_t smem = static_cast<size_t>((D + 15) & ~15);
  ivf_gathered_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
      static_cast<const int*>(q_mag2), static_cast<const float*>(qr), md,
      static_cast<const int*>(cand), static_cast<const uint8_t*>(rows), N, M, D,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
