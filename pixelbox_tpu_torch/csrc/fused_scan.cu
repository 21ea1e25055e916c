// Hopper (sm_90a) kernels for the guaranteed-exact cosine and Hamming scans.
//
// They replace the one Pallas TPU kernel family of the repo,
// pixelbox_tpu/ops/pallas_scan.py:_threshold_kernel (launched by
// _call_threshold_kernel, distance maths in _kind_dist_tile), in its uses
// by ops/scan.py:cosine_scan_topk_auto and ops/hamming_gemm.py:
//   - the θ-estimate stage 2 (_pallas_sample_theta)      -> K1a/K2a + K1c
//   - the cosine main pass (pallas_threshold_scan_topk_v2, and the
//     buffer-select pallas_threshold_scan_topk for Q > 1024) -> K1a + K1c
//   - the exact cosine repair (pallas_cosine_scan_topk)  -> K1b + K1c
//   - the Hamming main pass
//     (pallas_hamming_threshold_scan_topk(_v2))          -> K2a + K1c
//   - the exact Hamming scan and repair (where the JAX package ran its
//     XLA hamming_gemm_scan_topk / hamming_scan_topk)     -> K2b + K1c
//   - the int4 main pass (ops/int4.py:pallas_threshold4_scan_topk,
//     kinds cosine4a / cosine4)                          -> K4a + K1c
//   - the exact int4 scan and repair (the JAX package's XLA
//     cosine4a_scan_topk / cosine4_scan_topk)            -> K4b + K1c
//   - the cos-key main pass (epilogue="cos": _kind_dist_tile
//     :171-174 and _cos_key_threshold, kinds cosine /
//     cosine4a / cosine4)                                -> K1d/K4d
//   - its exact finish (_exact_dist_gathered,
//     _coskey_candidate_postpass)                        -> K1e + K1c
//
// K1a, K2a, K4a, K2b and K4b run on the tensor cores (tc_scan.cu) at the
// main path's widths; their kernels here serve the other widths and are
// the timing references of the tensor-core ones.  K1b, and the K2b / K4b
// here, sort every slot of each 1,024-row chunk (bitonic, 4 queries a
// block): bound by that sort, not by the rows or the product.
//
// K1c (lex_topk_select_kernel) is the selection half of _threshold_kernel
// (its sorted carry insertion) and the buffer wrapper's final top-k: the
// first k of a query's candidates by (dist, id), in one launch for up to
// 16,384 of them.  It reads only the filled slots and radix-selects the
// k-th key in shared memory (select_device.cuh, shared with tc_scan.cu's
// chunk top-k), so it is bound by a launch and the filled entries' bytes,
// not by the buffer's size.  The first port's segmented
// bitonic sort (lex_topk_segments_kernel, re-launched until one segment
// was left) stays as its timing reference.
//
// The Hamming kernels here read the packed u8 phash rows and count
// differing bits with xor + __popc; the TPU kernel multiplied a ±1
// bit-unpacked int8 copy on its matrix unit (which tc_scan.cu's K2a does
// in registers), and both give the same integer.
//
// The contract is ported, not the loop shape: output (dist [Q,k] f32,
// idx [Q,k] i32) with missing entries +inf / -1, the strict dist < θ
// filter, ties in ascending row id, and a sound per-query exact proof.
// The TPU kernel's lane-class extraction chain, 128-lane counts and
// round-bound poisoning exist because a TPU vreg has 128 lanes and Mosaic
// has no sort; a GPU block sorts in shared memory instead.
//
// The __dp4a K4a and K4b (widths other than tc_scan.cu's) are K1a/K1b
// instantiated for the packed int4 rows (two 4-bit codes a byte,
// column-blocked: byte c holds dim c in its low nibble and dim c + D/2 in
// its high one, ops/int4.py).  They read D/2 bytes a row instead of D and
// unpack each 32-bit word into two __dp4a operands with one mask and one
// shift+mask; only the row dot and the integer affine fix differ from the
// u8 kind.  Like the __dp4a K1a they are integer-ALU bound at Q >= 32
// (the same D/4 __dp4a per query and row, plus the unpack), HBM-read
// bound below; halving the row bytes matters only there.
//
// Distances follow the canonical spec v2 (ops/distances.py) op for op,
// every f32 op correctly rounded (explicit __fmul_rn / __fdiv_rn, and the
// library is built without --use_fast_math and with -fmad=false), so the
// results are bit-identical to the plain PyTorch versions and the numpy
// oracle.
//
// The staged-query row dots, the integer affine fix and the spec epilogue
// are in scan_device.cuh, shared with the breakdown ladder (breakdown.cu).
//
// Plain C interface, bound with ctypes (pointers and the stream as
// void*); every entry point returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "scan_device.cuh"
#include "select_device.cuh"

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

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

// What a collect kernel selects on (its epilogue).
enum : int {
  kEpiDist = 0,    // K1a/K4a: the spec distance, filter dist < theta[q]
  kEpiCosKey = 1,  // K1d/K4d: the key -cos, filter -cos < theta[q]
};

// K1a / K1d (KIND kU8) and K4a / K4d (kInt4Asym, kInt4Sym): append every
// valid row that passes query q's filter to its buffer.  count[q] is
// exact whether or not the buffer overflows (the slot is claimed before
// the capacity check), so the wrapper's proof is sound.
//
// EPI kEpiDist stores the spec distance and filters dist < theta[q].
// EPI kEpiCosKey (K1d/K4d, the JAX epilogue="cos") stores the key -cos and
// filters -cos < theta[q], theta the wrapper's key threshold: it skips the
// divide, the clamp and the identical-vector pin on every (query, row);
// K1e recomputes the exact distance for the collected rows only.
template <int QT, int KIND, int EPI>
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
  stage_queries<QT, int8_t>(q_codes, q0, nq, D, q_sh);
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const int row_mag2 = meta[N + row];
  if (row_mag2 <= 0) return;  // padding / tombstone
  int acc[QT];
  kind_row_dot<KIND, QT>(data, row, q_sh, D, acc);
  const int row_sum = meta[row];
  const float rr = __int_as_float(meta[2 * N + row]);
  const float row_mag2f = __int2float_rn(row_mag2);
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (j < nq) {
      const int q = q0 + j;
      const int dot_c = centered_dot<KIND>(acc[j], q_sum[q], row_sum, D);
      const float v = EPI == kEpiCosKey
                          ? -spec_cos(dot_c, qr[q], rr)
                          : spec_dist(dot_c, qr[q], rr, q_mag2f[q], row_mag2f);
      if (v < theta[q]) {
        const int slot = atomicAdd(count + q, 1);
        if (slot < cap) {
          cand_d[static_cast<size_t>(q) * cap + slot] = v;
          cand_i[static_cast<size_t>(q) * cap + slot] = row;
        }
      }
    }
  }
}

// K1e: the exact finish of a cos-key collect.  One thread per (query q,
// buffer slot); block (x, q) stages query q's codes.  Slots below lens[q]
// gather their row, take the same row dot, centered_dot and spec_dist as
// K1a (so the distance is bit-identical to K1a's) and keep it if it is
// < theta[q], the strict distance threshold; every other slot, and every
// slot at or past lens[q], reads +inf — K1c sorts those last and emits
// them as (+inf, -1).  Bound by the gathered rows (D or D/2 bytes and 12
// of meta per collected candidate) and the [Q, cap] output.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
coskey_rescore_kernel(const int8_t* __restrict__ q_codes,
                      const int* __restrict__ q_sum,
                      const float* __restrict__ q_mag2f,
                      const float* __restrict__ qr,
                      const float* __restrict__ theta,
                      const int8_t* __restrict__ data,
                      const int* __restrict__ meta, int N, int D, int cap,
                      const int* __restrict__ lens,
                      const int* __restrict__ cand_i,
                      float* __restrict__ out_d) {
  extern __shared__ __align__(16) int8_t q_sh[];
  const int q = blockIdx.y;
  const int len = min(lens[q], cap);
  const int s0 = blockIdx.x * blockDim.x;
  if (s0 < len) {  // uniform over the block
    stage_queries<1, int8_t>(q_codes, q, 1, D, q_sh);
    __syncthreads();
  }
  const int slot = s0 + threadIdx.x;
  if (slot >= cap) return;
  float out = __int_as_float(0x7f800000);
  if (slot < len) {
    const int row = cand_i[static_cast<size_t>(q) * cap + slot];
    int acc[1];
    kind_row_dot<KIND, 1>(data, row, q_sh, D, acc);
    const float dist =
        spec_dist(centered_dot<KIND>(acc[0], q_sum[q], meta[row], D), qr[q],
                  __int_as_float(meta[2 * N + row]), q_mag2f[q],
                  __int2float_rn(meta[N + row]));
    if (dist < theta[q]) out = dist;
  }
  out_d[static_cast<size_t>(q) * cap + slot] = out;
}

// K1b (KIND kU8) / the first port's K4b (kInt4Asym, kInt4Sym): per (row
// chunk, query tile), the chunk's exact top-k of {valid rows with dist <
// max_distance} by (dist, row id).  Distances go to shared memory as keys,
// a bitonic sort orders each query's chunk (55 barrier-separated stages,
// filled slots or not), and the first k land in the [Q, n_chunks, k]
// partial (finished by K1c).
template <int QB, int KIND>
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
  stage_queries<QB, int8_t>(q_codes, q0, nq, D, q_sh);
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
        kind_row_dot<KIND, QB>(data, row, q_sh, D, acc);
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
        const float dist =
            spec_dist(centered_dot<KIND>(acc[j], q_sum[q], row_sum, D), qr[q],
                      rr, q_mag2f[q], row_mag2f);
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

// K2a: K1a for the Hamming kind.  Every row with row_ok != 0 (validity
// AND the optional width-group mask, built by ops/fused_scan.py
// build_hamming_meta) and dist < theta[q] is appended to query q's
// buffer under an exact atomic count.  Bound on the card by __popc
// (limit/4 per query and row, 32 queries a block share one read of the
// row); the packed rows are read once per 32 queries.
template <int QT>
__global__ void __launch_bounds__(kThreads)
hamming_collect_kernel(const uint8_t* __restrict__ q_bytes,
                       const float* __restrict__ theta,
                       const uint8_t* __restrict__ data,
                       const uint8_t* __restrict__ row_ok, int Q, int N, int H,
                       int limit, int wrap, float scale, int cap,
                       int* __restrict__ count, float* __restrict__ cand_d,
                       int* __restrict__ cand_i) {
  extern __shared__ __align__(16) uint8_t hq_sh[];
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  stage_queries<QT, uint8_t>(q_bytes, q0, nq, H, hq_sh);
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N || row_ok[row] == 0) return;
  int acc[QT];
  row_popc<QT>(data + static_cast<size_t>(row) * H, hq_sh, H, limit, acc);
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (j < nq) {
      const int q = q0 + j;
      const float dist = hamming_dist(acc[j], wrap, scale);
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

// The first port's K2b: K1b for the Hamming kind — per (row chunk, query
// tile) the chunk's exact top-k of {row_ok rows with dist < max_distance}
// by (dist, row id), sorted in shared memory; K1c finishes the
// [Q, n_chunks, k] partials.
template <int QB>
__global__ void __launch_bounds__(kThreads)
hamming_chunk_topk_kernel(const uint8_t* __restrict__ q_bytes,
                          float max_distance, const uint8_t* __restrict__ data,
                          const uint8_t* __restrict__ row_ok, int Q, int N,
                          int H, int limit, int wrap, float scale, int R, int k,
                          int n_chunks, float* __restrict__ out_d,
                          int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char hsmem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(hsmem);
  uint8_t* q_sh = reinterpret_cast<uint8_t*>(keys + QB * R);
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, Q - q0);
  stage_queries<QB, uint8_t>(q_bytes, q0, nq, H, q_sh);
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int row = chunk * R + r;
    const bool ok = row < N && row_ok[row] != 0;
    int acc[QB];
    if (ok) row_popc<QB>(data + static_cast<size_t>(row) * H, q_sh, H, limit, acc);
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      unsigned long long key = kNoKey;
      if (ok && j < nq) {
        const float dist = hamming_dist(acc[j], wrap, scale);
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

// The first port's K1c (lex_topk_segments, kept as the timing reference
// of lex_topk_select_kernel below): per (query, segment of S candidates),
// the segment's first k by (dist, id), a bitonic sort of all S slots.
// Entries at or past lens[q] (when given), non-finite or with a negative
// id are empty.  Sorting on the id as the second key makes the result
// independent of K1a's atomic append order.
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

// ---- K1c: the top-k by (dist, id) in one launch (lex_topk_select)
//
// One block per (query, segment of at most kSelectSlots entries; the
// wrapper's lex_topk passes the whole row up to that, and cuts a longer
// one into slices whose top-k a second launch selects from).
// 1. The block reads only the positions below lens[q], coalesced, and
//    appends the valid entries' 64-bit keys to shared memory (one shared
//    atomic a warp): the work follows the filled slots, not the buffer.
// 2. More than k keys: radix select of the k-th smallest key, MSB first,
//    8-bit digits over a 256-bin shared histogram (one shared atomic a
//    key), each pass over the keys whose higher digits match the
//    prefix found so far.  dist >= 0, so its f32 bits order like it; a
//    tie plateau in dist carries the select into the id bits (up to 8
//    passes).  It stops once the k-th key's bin holds exactly the rest.
// 3. The keys at or below the k-th (k of them; a key repeated past k
//    fills the rest) are compacted and bitonic-sorted, next_pow2(k) <=
//    1,024 of them; at most k keys are sorted as they are.
// A k past 1,024 is selected in rounds (the wrapper's lex_topk): each
// round passes floor[q], the key of the last entry the round before took,
// and only keys strictly above it are valid.  Keys are unique (a row id
// appears once in a query's candidates), so the rounds' outputs laid end
// to end are the first k.

constexpr int kSelectThreads = 256;  // one thread a histogram bin
constexpr int kSelectSlots = 16384;  // entries a block holds in shared memory
constexpr int kSelectMaxK = 1024;

// Dynamic shared memory of a select block: the keys, the sorted top, the
// histogram, the warps' scan sums and a few block-wide scalars.
__host__ __device__ constexpr size_t select_smem(int slots, int k) {
  return static_cast<size_t>(slots + next_pow2(k)) * 8 + (256 + 8 + 8) * 4;
}

__global__ void __launch_bounds__(kSelectThreads)
lex_topk_select_kernel(const float* __restrict__ in_d,
                       const int* __restrict__ in_i,
                       const int* __restrict__ lens,
                       const unsigned long long* __restrict__ floor_key, int M,
                       int S, int k, int n_seg, float* __restrict__ out_d,
                       int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned long long sel_smem[];
  const int slots = min(S, M);
  unsigned long long* keys = sel_smem;
  unsigned long long* top = keys + slots;
  int* hist = reinterpret_cast<int*>(top + next_pow2(k));
  int* warp_sums = hist + 256;
  int* scal = warp_sums + 8;  // n, taken, bin, below the bin, in the bin
  const int tid = threadIdx.x;
  const int q = blockIdx.x, seg = blockIdx.y;
  const int len = lens ? min(lens[q], M) : M;
  const int lo = seg * S, hi = min(lo + S, len);
  const unsigned long long above = floor_key ? floor_key[q] : 0ull;
  if (tid < 2) scal[tid] = 0;
  __syncthreads();

  // 1. The valid keys below lens[q] into shared memory.
  const size_t row = static_cast<size_t>(q) * M;
  for (int p0 = lo; p0 < hi; p0 += kSelectThreads) {
    const int p = p0 + tid;
    bool ok = false;
    unsigned long long key = 0;
    if (p < hi) {
      const float d = in_d[row + p];
      const int id = in_i[row + p];
      key = make_key(d, id);
      ok = id >= 0 && fabsf(d) < __int_as_float(0x7f800000) && (!floor_key || key > above);
    }
    warp_append(ok, key, keys, scal);
  }
  __syncthreads();
  const int n = scal[0];

  // 2. Radix select of the k-th key (select_device.cuh).
  RadixBin bin{0, 0, k, true};
  if (n > k) bin = radix_select<kSelectThreads>(keys, n, k, 56, 0, hist, scal + 2, warp_sums);

  // 3. The top keys compacted, a repeated k-th key filling the rest, and
  // sorted.
  const int total = min(n, k);
  for (int i0 = 0; i0 < n; i0 += kSelectThreads) {
    const int i = i0 + tid;
    bool take = false;
    unsigned long long key = 0;
    if (i < n) {
      key = keys[i];
      take = n <= k || (bin.whole_bin ? (key & bin.mask) <= bin.prefix : key < bin.prefix);
    }
    warp_append(take, key, top, scal + 1);
  }
  __syncthreads();
  const int sorted = next_pow2(max(total, 1));
  for (int t = scal[1] + tid; t < sorted; t += kSelectThreads) top[t] = t < total ? bin.prefix : kNoKey;
  __syncthreads();
  bitonic_sort_pow2<kSelectThreads>(top, sorted);
  for (int t = tid; t < k; t += kSelectThreads) {
    const unsigned long long key = t < total ? top[t] : kNoKey;
    const size_t o = (static_cast<size_t>(q) * n_seg + seg) * k + t;
    out_d[o] = key == kNoKey ? __int_as_float(0x7f800000)
                             : __uint_as_float(static_cast<unsigned>(key >> 32));
    out_i[o] = key == kNoKey ? -1 : static_cast<int>(key & 0xffffffffu);
  }
}

// Opts the select kernel into its largest dynamic shared memory once per
// device (above 48 KB a launch needs it).
int allow_select_smem() {
  static std::mutex mu;
  static std::vector<int> done;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  std::lock_guard<std::mutex> lock(mu);
  if (std::find(done.begin(), done.end(), dev) != done.end()) return 0;
  rc = cudaFuncSetAttribute(lex_topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(select_smem(kSelectSlots, kSelectMaxK)));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done.push_back(dev);
  return 0;
}

template <int KIND, int EPI = kEpiDist>
int launch_collect(const void* q_codes, const void* q_sum, const void* q_mag2f,
                   const void* qr, const void* theta, const void* data,
                   const void* meta, int Q, int N, int D, int cap, void* count,
                   void* cand_d, void* cand_i, void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (Q + kCollectQueries - 1) / kCollectQueries);
  const size_t smem = static_cast<size_t>(kCollectQueries) * D;
  threshold_collect_kernel<kCollectQueries, KIND, EPI>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
          static_cast<const float*>(q_mag2f), static_cast<const float*>(qr),
          static_cast<const float*>(theta), static_cast<const int8_t*>(data),
          static_cast<const int*>(meta), Q, N, D, cap,
          static_cast<int*>(count), static_cast<float*>(cand_d),
          static_cast<int*>(cand_i));
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_chunk_topk(const void* q_codes, const void* q_sum,
                      const void* q_mag2f, const void* qr, float max_distance,
                      const void* data, const void* meta, int Q, int N, int D,
                      int R, int k, int n_chunks, void* out_d, void* out_i,
                      void* stream) {
  const dim3 grid(n_chunks, (Q + kChunkQueries - 1) / kChunkQueries);
  const size_t smem = static_cast<size_t>(kChunkQueries) * R * 8 +
                      static_cast<size_t>(kChunkQueries) * D;
  chunk_topk_kernel<kChunkQueries, KIND>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
          static_cast<const float*>(q_mag2f), static_cast<const float*>(qr),
          max_distance, static_cast<const int8_t*>(data),
          static_cast<const int*>(meta), Q, N, D, R, k, n_chunks,
          static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_rescore(const void* q_codes, const void* q_sum, const void* q_mag2f,
                   const void* qr, const void* theta, const void* data,
                   const void* meta, int Q, int N, int D, int cap,
                   const void* lens, const void* cand_i, void* out_d,
                   void* stream) {
  const dim3 grid((cap + kThreads - 1) / kThreads, Q);
  coskey_rescore_kernel<KIND>
      <<<grid, kThreads, static_cast<size_t>(D), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q_codes), static_cast<const int*>(q_sum),
          static_cast<const float*>(q_mag2f), static_cast<const float*>(qr),
          static_cast<const float*>(theta), static_cast<const int8_t*>(data),
          static_cast<const int*>(meta), N, D, cap,
          static_cast<const int*>(lens), static_cast<const int*>(cand_i),
          static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PX_EXPORT int px_threshold_collect(const void* q_codes, const void* q_sum,
                                   const void* q_mag2f, const void* qr,
                                   const void* theta, const void* data,
                                   const void* meta, int Q, int N, int D,
                                   int cap, void* count, void* cand_d,
                                   void* cand_i, void* stream) {
  return launch_collect<kU8>(q_codes, q_sum, q_mag2f, qr, theta, data, meta,
                             Q, N, D, cap, count, cand_d, cand_i, stream);
}

PX_EXPORT int px_chunk_topk(const void* q_codes, const void* q_sum,
                            const void* q_mag2f, const void* qr,
                            float max_distance, const void* data,
                            const void* meta, int Q, int N, int D, int R,
                            int k, int n_chunks, void* out_d, void* out_i,
                            void* stream) {
  return launch_chunk_topk<kU8>(q_codes, q_sum, q_mag2f, qr, max_distance,
                                data, meta, Q, N, D, R, k, n_chunks, out_d,
                                out_i, stream);
}

// K4a over packed int4 rows [N, D/2]; sym selects the symmetric metric
// (4-bit queries) over the asymmetric one (u8 queries).
PX_EXPORT int px_cosine4_collect(const void* q_codes, const void* q_sum,
                                 const void* q_mag2f, const void* qr,
                                 const void* theta, const void* data,
                                 const void* meta, int Q, int N, int D,
                                 int sym, int cap, void* count, void* cand_d,
                                 void* cand_i, void* stream) {
  return sym ? launch_collect<kInt4Sym>(q_codes, q_sum, q_mag2f, qr, theta,
                                        data, meta, Q, N, D, cap, count,
                                        cand_d, cand_i, stream)
             : launch_collect<kInt4Asym>(q_codes, q_sum, q_mag2f, qr, theta,
                                         data, meta, Q, N, D, cap, count,
                                         cand_d, cand_i, stream);
}

// K4b over packed int4 rows [N, D/2].
PX_EXPORT int px_cosine4_chunk_topk(const void* q_codes, const void* q_sum,
                                    const void* q_mag2f, const void* qr,
                                    float max_distance, const void* data,
                                    const void* meta, int Q, int N, int D,
                                    int sym, int R, int k, int n_chunks,
                                    void* out_d, void* out_i, void* stream) {
  return sym ? launch_chunk_topk<kInt4Sym>(q_codes, q_sum, q_mag2f, qr,
                                           max_distance, data, meta, Q, N, D,
                                           R, k, n_chunks, out_d, out_i, stream)
             : launch_chunk_topk<kInt4Asym>(q_codes, q_sum, q_mag2f, qr,
                                            max_distance, data, meta, Q, N, D,
                                            R, k, n_chunks, out_d, out_i,
                                            stream);
}

// K1d: K1a selecting on the key -cos < key_theta[q] (u8 rows).
PX_EXPORT int px_coskey_collect(const void* q_codes, const void* q_sum,
                                const void* q_mag2f, const void* qr,
                                const void* key_theta, const void* data,
                                const void* meta, int Q, int N, int D, int cap,
                                void* count, void* cand_key, void* cand_i,
                                void* stream) {
  return launch_collect<kU8, kEpiCosKey>(q_codes, q_sum, q_mag2f, qr,
                                         key_theta, data, meta, Q, N, D, cap,
                                         count, cand_key, cand_i, stream);
}

// K4d: K1d over packed int4 rows [N, D/2] (sym as in px_cosine4_collect).
PX_EXPORT int px_cosine4_coskey_collect(const void* q_codes, const void* q_sum,
                                        const void* q_mag2f, const void* qr,
                                        const void* key_theta, const void* data,
                                        const void* meta, int Q, int N, int D,
                                        int sym, int cap, void* count,
                                        void* cand_key, void* cand_i,
                                        void* stream) {
  return sym ? launch_collect<kInt4Sym, kEpiCosKey>(
                   q_codes, q_sum, q_mag2f, qr, key_theta, data, meta, Q, N, D,
                   cap, count, cand_key, cand_i, stream)
             : launch_collect<kInt4Asym, kEpiCosKey>(
                   q_codes, q_sum, q_mag2f, qr, key_theta, data, meta, Q, N, D,
                   cap, count, cand_key, cand_i, stream);
}

// K1e for kind 0 (u8 rows), 1 (int4 asym) or 2 (int4 sym).
PX_EXPORT int px_coskey_rescore(const void* q_codes, const void* q_sum,
                                const void* q_mag2f, const void* qr,
                                const void* theta, const void* data,
                                const void* meta, int Q, int N, int D,
                                int kind, int cap, const void* lens,
                                const void* cand_i, void* out_d, void* stream) {
  switch (kind) {
    case kU8:
      return launch_rescore<kU8>(q_codes, q_sum, q_mag2f, qr, theta, data,
                                 meta, Q, N, D, cap, lens, cand_i, out_d,
                                 stream);
    case kInt4Asym:
      return launch_rescore<kInt4Asym>(q_codes, q_sum, q_mag2f, qr, theta,
                                       data, meta, Q, N, D, cap, lens, cand_i,
                                       out_d, stream);
    case kInt4Sym:
      return launch_rescore<kInt4Sym>(q_codes, q_sum, q_mag2f, qr, theta,
                                      data, meta, Q, N, D, cap, lens, cand_i,
                                      out_d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// K1c in one launch: per (query, segment of S <= kSelectSlots entries of
// its row), the first k <= kSelectMaxK by (dist, id) into [Q, n_seg, k];
// with floor_key (u64 [Q], nullable) only the keys above floor_key[q].
PX_EXPORT int px_lex_topk(const void* in_d, const void* in_i, const void* lens,
                          const void* floor_key, int Q, int M, int S, int k, int n_seg,
                          void* out_d, void* out_i, void* stream) {
  if (k < 1 || k > kSelectMaxK || S < 1 || S > kSelectSlots || n_seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q <= 0) return 0;
  const int rc = allow_select_smem();
  if (rc != 0) return rc;
  lex_topk_select_kernel<<<dim3(Q, n_seg), kSelectThreads, select_smem(min(S, M), k),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_d), static_cast<const int*>(in_i),
      static_cast<const int*>(lens), static_cast<const unsigned long long*>(floor_key), M, S,
      k, n_seg, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

PX_EXPORT int px_hamming_collect(const void* q_bytes, const void* theta,
                                 const void* data, const void* row_ok, int Q,
                                 int N, int H, int limit, int wrap, float scale,
                                 int cap, void* count, void* cand_d,
                                 void* cand_i, void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (Q + kCollectQueries - 1) / kCollectQueries);
  const size_t smem = static_cast<size_t>(kCollectQueries) * H;
  hamming_collect_kernel<kCollectQueries>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(q_bytes), static_cast<const float*>(theta),
          static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(row_ok),
          Q, N, H, limit, wrap, scale, cap, static_cast<int*>(count),
          static_cast<float*>(cand_d), static_cast<int*>(cand_i));
  return static_cast<int>(cudaGetLastError());
}

PX_EXPORT int px_hamming_chunk_topk(const void* q_bytes, float max_distance,
                                    const void* data, const void* row_ok, int Q,
                                    int N, int H, int limit, int wrap,
                                    float scale, int R, int k, int n_chunks,
                                    void* out_d, void* out_i, void* stream) {
  const dim3 grid(n_chunks, (Q + kChunkQueries - 1) / kChunkQueries);
  const size_t smem = static_cast<size_t>(kChunkQueries) * R * 8 +
                      static_cast<size_t>(kChunkQueries) * H;
  hamming_chunk_topk_kernel<kChunkQueries>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(q_bytes), max_distance,
          static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(row_ok),
          Q, N, H, limit, wrap, scale, R, k, n_chunks,
          static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
