// Hopper (sm_90a) kernels for the guaranteed-exact cosine scan.
//
// They replace the one Pallas TPU kernel on the main path,
// pixelbox_tpu/ops/pallas_scan.py:_threshold_kernel (launched by
// _call_threshold_kernel, distance maths in _kind_dist_tile), in its three
// uses by ops/scan.py:cosine_scan_topk_auto:
//   - the θ-estimate stage 2 (_pallas_sample_theta)      -> K1a + K1c
//   - the main pass (pallas_threshold_scan_topk_v2)      -> K1a + K1c
//   - the exact repair (pallas_cosine_scan_topk)         -> K1b + K1c
//
// The contract is ported, not the loop shape: output (dist [Q,k] f32,
// idx [Q,k] i32) with missing entries +inf / -1, the strict dist < θ
// filter, ties in ascending row id, and a sound per-query exact proof.
// The TPU kernel's lane-class extraction chain, 128-lane counts and
// round-bound poisoning exist because a TPU vreg has 128 lanes and Mosaic
// has no sort; a GPU block sorts in shared memory instead.
//
// Distances follow the canonical spec v2 (ops/distances.py) op for op,
// every f32 op correctly rounded (explicit __fmul_rn / __fdiv_rn, and the
// library is built without --use_fast_math and with -fmad=false), so the
// results are bit-identical to the plain PyTorch versions and the numpy
// oracle.
//
// Plain C interface, bound with ctypes (pointers and the stream as
// void*); every entry point returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int kCollectQueries = 32;  // K1a: queries per block
constexpr int kChunkQueries = 4;     // K1b: queries per block
constexpr unsigned long long kNoKey = ~0ull;

// Exact int8 dot of one index row against QT staged queries.  The row is
// read once (16-byte loads where the width allows) and multiplied into
// every query with __dp4a; the staged query words are the same address
// for every thread of a warp, so shared-memory reads broadcast.
template <int QT>
__device__ __forceinline__ void row_dot(const int8_t* __restrict__ row,
                                        const int8_t* q_sh, int D,
                                        int (&acc)[QT]) {
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = 0;
  if ((D & 15) == 0) {
    for (int c = 0; c < D; c += 16) {
      const int4 r = *reinterpret_cast<const int4*>(row + c);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const int4 q = *reinterpret_cast<const int4*>(q_sh + j * D + c);
        int a = acc[j];
        a = __dp4a(r.x, q.x, a);
        a = __dp4a(r.y, q.y, a);
        a = __dp4a(r.z, q.z, a);
        a = __dp4a(r.w, q.w, a);
        acc[j] = a;
      }
    }
  } else if ((D & 3) == 0) {
    for (int c = 0; c < D; c += 4) {
      const int r = *reinterpret_cast<const int*>(row + c);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        acc[j] = __dp4a(r, *reinterpret_cast<const int*>(q_sh + j * D + c),
                        acc[j]);
      }
    }
  } else {
    for (int c = 0; c < D; ++c) {
      const int r = row[c];
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] += r * static_cast<int>(q_sh[j * D + c]);
    }
  }
}

// Canonical spec v2 epilogue, exactly _kind_dist_tile (kind="cosine"):
//   dot_c = 4*dot8 + 2*(q_sum + row_sum) + D          (exact int32)
//   cos   = fl(dot_c * fl(qr * rr))
//   dist  = fl(fl(1 / max(cos, 1e-6)) - 1), clamped to >= 0
//   identical vectors (dot == m2q == m2r on the f32 copies) pinned to 0.
__device__ __forceinline__ float spec_dist(int dot8, int q_sum, int row_sum,
                                           int D, float qr, float rr,
                                           float q_mag2f, float row_mag2f) {
  const int dot_c = 4 * dot8 + 2 * (q_sum + row_sum) + D;
  const float dot_f = __int2float_rn(dot_c);
  const float cosv = __fmul_rn(dot_f, __fmul_rn(qr, rr));
  float dist = __fsub_rn(__fdiv_rn(1.0f, fmaxf(cosv, 1e-6f)), 1.0f);
  dist = fmaxf(dist, 0.0f);
  if (dot_f == q_mag2f && q_mag2f == row_mag2f) dist = 0.0f;
  return dist;
}

// (dist, row) as one 64-bit key: dist >= +0 or +inf, so its bits order
// like the value and the row id breaks ties ascending.
__device__ __forceinline__ unsigned long long make_key(float dist, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(dist)) << 32) |
         static_cast<unsigned int>(row);
}

// Stage QT query rows (zero-padded past nq) into shared memory.
template <int QT>
__device__ __forceinline__ void stage_queries(const int8_t* __restrict__ q_codes,
                                              int q0, int nq, int D,
                                              int8_t* q_sh) {
  for (int t = threadIdx.x; t < QT * D; t += blockDim.x) {
    const int j = t / D;
    q_sh[t] = (j < nq) ? q_codes[static_cast<size_t>(q0 + j) * D + (t - j * D)]
                       : static_cast<int8_t>(0);
  }
}

// Sort every `seg`-long segment of keys[0:total] ascending (bitonic; seg
// and total powers of two with seg | total).
__device__ void bitonic_sort_segments(unsigned long long* keys, int total,
                                      int seg) {
  for (int size = 2; size <= seg; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < total / 2; t += blockDim.x) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const bool asc = (size == seg) || ((i & size) == 0);
        const unsigned long long a = keys[i];
        const unsigned long long b = keys[j];
        if ((a > b) == asc) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// K1a: append every valid row with dist < theta[q] to query q's buffer.
// count[q] is exact whether or not the buffer overflows (the slot is
// claimed before the capacity check), so the wrapper's proof
// count <= cap && (count >= k || unbound) is sound.
template <int QT>
__global__ void __launch_bounds__(kThreads)
threshold_collect_kernel(const int8_t* __restrict__ q_codes,
                         const int* __restrict__ q_sum,
                         const float* __restrict__ q_mag2f,
                         const float* __restrict__ qr,
                         const float* __restrict__ theta,
                         const int8_t* __restrict__ data,
                         const int* __restrict__ meta, int Q, int N, int D,
                         int cap, int* __restrict__ count,
                         float* __restrict__ cand_d, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) int8_t q_sh[];
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  stage_queries<QT>(q_codes, q0, nq, D, q_sh);
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const int row_mag2 = meta[N + row];
  if (row_mag2 <= 0) return;  // padding / tombstone
  int acc[QT];
  row_dot<QT>(data + static_cast<size_t>(row) * D, q_sh, D, acc);
  const int row_sum = meta[row];
  const float rr = __int_as_float(meta[2 * N + row]);
  const float row_mag2f = __int2float_rn(row_mag2);
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (j < nq) {
      const int q = q0 + j;
      const float dist =
          spec_dist(acc[j], q_sum[q], row_sum, D, qr[q], rr, q_mag2f[q], row_mag2f);
      if (dist < theta[q]) {
        const int slot = atomicAdd(count + q, 1);
        if (slot < cap) {
          cand_d[static_cast<size_t>(q) * cap + slot] = dist;
          cand_i[static_cast<size_t>(q) * cap + slot] = row;
        }
      }
    }
  }
}

// K1b: per (row chunk, query tile), the chunk's exact top-k of
// {valid rows with dist < max_distance} by (dist, row id).  Distances go
// to shared memory as keys, a bitonic sort orders each query's chunk, and
// the first k land in the [Q, n_chunks, k] partial (finished by K1c).
template <int QB>
__global__ void __launch_bounds__(kThreads)
chunk_topk_kernel(const int8_t* __restrict__ q_codes,
                  const int* __restrict__ q_sum,
                  const float* __restrict__ q_mag2f,
                  const float* __restrict__ qr, float max_distance,
                  const int8_t* __restrict__ data, const int* __restrict__ meta,
                  int Q, int N, int D, int R, int k, int n_chunks,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  int8_t* q_sh = reinterpret_cast<int8_t*>(keys + QB * R);
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, Q - q0);
  stage_queries<QB>(q_codes, q0, nq, D, q_sh);
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int row = chunk * R + r;
    int acc[QB];
    bool ok = false;
    int row_sum = 0;
    float rr = 0.0f, row_mag2f = 0.0f;
    if (row < N) {
      const int row_mag2 = meta[N + row];
      ok = row_mag2 > 0;
      if (ok) {
        row_dot<QB>(data + static_cast<size_t>(row) * D, q_sh, D, acc);
        row_sum = meta[row];
        rr = __int_as_float(meta[2 * N + row]);
        row_mag2f = __int2float_rn(row_mag2);
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      unsigned long long key = kNoKey;
      if (ok && j < nq) {
        const int q = q0 + j;
        const float dist = spec_dist(acc[j], q_sum[q], row_sum, D, qr[q], rr,
                                     q_mag2f[q], row_mag2f);
        if (dist < max_distance) key = make_key(dist, row);
      }
      keys[j * R + r] = key;
    }
  }
  __syncthreads();
  bitonic_sort_segments(keys, QB * R, R);
  for (int t = threadIdx.x; t < nq * k; t += blockDim.x) {
    const int j = t / k;
    const int s = t - j * k;
    const unsigned long long key = keys[j * R + s];
    const size_t o = (static_cast<size_t>(q0 + j) * n_chunks + chunk) * k + s;
    out_d[o] = key == kNoKey ? __int_as_float(0x7f800000)
                             : __uint_as_float(static_cast<unsigned>(key >> 32));
    out_i[o] = key == kNoKey ? -1 : static_cast<int>(key & 0xffffffffu);
  }
}

// K1c: per (query, segment of S candidates), the segment's first k by
// (dist, id).  Entries at or past lens[q] (when given), non-finite or with
// a negative id are empty.  Sorting on the id as the second key makes the
// result independent of K1a's atomic append order.
__global__ void __launch_bounds__(kThreads)
lex_topk_segments_kernel(const float* __restrict__ in_d,
                         const int* __restrict__ in_i,
                         const int* __restrict__ lens, int M, int S, int k,
                         int n_seg, float* __restrict__ out_d,
                         int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned long long seg_keys[];
  const int seg = blockIdx.x;
  const int q = blockIdx.y;
  const int len = lens ? min(lens[q], M) : M;
  const int base = seg * S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const int p = base + t;
    unsigned long long key = kNoKey;
    if (p < len) {
      const float d = in_d[static_cast<size_t>(q) * M + p];
      const int id = in_i[static_cast<size_t>(q) * M + p];
      if (id >= 0 && d < __int_as_float(0x7f800000)) key = make_key(d, id);
    }
    seg_keys[t] = key;
  }
  __syncthreads();
  bitonic_sort_segments(seg_keys, S, S);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const unsigned long long key = seg_keys[t];
    const size_t o = (static_cast<size_t>(q) * n_seg + seg) * k + t;
    out_d[o] = key == kNoKey ? __int_as_float(0x7f800000)
                             : __uint_as_float(static_cast<unsigned>(key >> 32));
    out_i[o] = key == kNoKey ? -1 : static_cast<int>(key & 0xffffffffu);
  }
}

}  // namespace

PX_EXPORT int px_threshold_collect(const void* q_codes, const void* q_sum,
                                   const void* q_mag2f, const void* qr,
                                   const void* theta, const void* data,
                                   const void* meta, int Q, int N, int D,
                                   int cap, void* count, void* cand_d,
                                   void* cand_i, void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (Q + kCollectQueries - 1) / kCollectQueries);
  const size_t smem = static_cast<size_t>(kCollectQueries) * D;
  threshold_collect_kernel<kCollectQueries>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
          static_cast<const float*>(q_mag2f), static_cast<const float*>(qr),
          static_cast<const float*>(theta), static_cast<const int8_t*>(data),
          static_cast<const int*>(meta), Q, N, D, cap,
          static_cast<int*>(count), static_cast<float*>(cand_d),
          static_cast<int*>(cand_i));
  return static_cast<int>(cudaGetLastError());
}

PX_EXPORT int px_chunk_topk(const void* q_codes, const void* q_sum,
                            const void* q_mag2f, const void* qr,
                            float max_distance, const void* data,
                            const void* meta, int Q, int N, int D, int R,
                            int k, int n_chunks, void* out_d, void* out_i,
                            void* stream) {
  const dim3 grid(n_chunks, (Q + kChunkQueries - 1) / kChunkQueries);
  const size_t smem = static_cast<size_t>(kChunkQueries) * R * 8 +
                      static_cast<size_t>(kChunkQueries) * D;
  chunk_topk_kernel<kChunkQueries>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
          static_cast<const float*>(q_mag2f), static_cast<const float*>(qr),
          max_distance, static_cast<const int8_t*>(data),
          static_cast<const int*>(meta), Q, N, D, R, k, n_chunks,
          static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

PX_EXPORT int px_lex_topk_segments(const void* in_d, const void* in_i,
                                   const void* lens, int Q, int M, int S,
                                   int k, int n_seg, void* out_d, void* out_i,
                                   void* stream) {
  const dim3 grid(n_seg, Q);
  const size_t smem = static_cast<size_t>(S) * 8;
  lex_topk_segments_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_d), static_cast<const int*>(in_i),
      static_cast<const int*>(lens), M, S, k, n_seg,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
