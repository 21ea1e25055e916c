// Device functions shared by the scan kernels (fused_scan.cu) and the
// breakdown ladder (breakdown.cu): the staged-query int8 row dot of the
// cosine kinds, the integer affine fix, the spec v2 epilogue and the
// (dist, row) key.  The ladder is built from exactly these, so its rungs
// time K1a's own stages.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCollectQueries = 32;  // K1a: queries per block
constexpr int kChunkQueries = 4;     // K1b: queries per block
constexpr unsigned long long kNoKey = ~0ull;

// Row layouts / metrics of the cosine kernels (K1a/K1b and K4a/K4b).
enum : int {
  kU8 = 0,        // int8 rows [N, D] (u8 - 128), queries the same
  kInt4Asym = 1,  // packed int4 rows [N, D/2], u8 - 128 queries (cosine4a)
  kInt4Sym = 2,   // packed int4 rows [N, D/2], 4-bit queries (cosine4)
};

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

// Exact dot of one packed int4 row (D/2 bytes) against QT staged int8
// queries [QT, D].  A 32-bit word of the row holds dims c..c+3 in its low
// nibbles and c+D/2..c+D/2+3 in its high ones: w & 0x0F0F0F0F and
// (w >> 4) & 0x0F0F0F0F are four non-negative int8 codes each, and two
// __dp4a against the matching query words add them in.  16-byte row loads
// where D/2 % 16 == 0, words where D/2 % 4 == 0, else bytes.
template <int QT>
__device__ __forceinline__ void row_dot4(const uint8_t* __restrict__ row,
                                         const int8_t* q_sh, int D,
                                         int (&acc)[QT]) {
  constexpr unsigned kLo = 0x0F0F0F0Fu;
  const int H = D >> 1;
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = 0;
  if ((H & 15) == 0) {
    for (int c = 0; c < H; c += 16) {
      const uint4 r = *reinterpret_cast<const uint4*>(row + c);
      const int l0 = r.x & kLo, l1 = r.y & kLo, l2 = r.z & kLo, l3 = r.w & kLo;
      const int h0 = (r.x >> 4) & kLo, h1 = (r.y >> 4) & kLo;
      const int h2 = (r.z >> 4) & kLo, h3 = (r.w >> 4) & kLo;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const int4 qa = *reinterpret_cast<const int4*>(q_sh + j * D + c);
        const int4 qb = *reinterpret_cast<const int4*>(q_sh + j * D + c + H);
        int a = acc[j];
        a = __dp4a(l0, qa.x, a);
        a = __dp4a(l1, qa.y, a);
        a = __dp4a(l2, qa.z, a);
        a = __dp4a(l3, qa.w, a);
        a = __dp4a(h0, qb.x, a);
        a = __dp4a(h1, qb.y, a);
        a = __dp4a(h2, qb.z, a);
        a = __dp4a(h3, qb.w, a);
        acc[j] = a;
      }
    }
  } else if ((H & 3) == 0) {
    for (int c = 0; c < H; c += 4) {
      const unsigned w = *reinterpret_cast<const unsigned*>(row + c);
      const int lo = w & kLo, hi = (w >> 4) & kLo;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const int* q = reinterpret_cast<const int*>(q_sh + j * D);
        acc[j] = __dp4a(hi, q[(c + H) >> 2], __dp4a(lo, q[c >> 2], acc[j]));
      }
    }
  } else {
    for (int c = 0; c < H; ++c) {
      const int b = row[c];
#pragma unroll
      for (int j = 0; j < QT; ++j)
        acc[j] += (b & 15) * static_cast<int>(q_sh[j * D + c]) +
                  (b >> 4) * static_cast<int>(q_sh[j * D + c + H]);
    }
  }
}

// The row dot of a kind: `data` is the int8 [N, D] or packed [N, D/2] index.
template <int KIND, int QT>
__device__ __forceinline__ void kind_row_dot(const int8_t* __restrict__ data,
                                             int row, const int8_t* q_sh,
                                             int D, int (&acc)[QT]) {
  if constexpr (KIND == kU8) {
    row_dot<QT>(data + static_cast<size_t>(row) * D, q_sh, D, acc);
  } else {
    row_dot4<QT>(reinterpret_cast<const uint8_t*>(data) +
                     static_cast<size_t>(row) * (D >> 1),
                 q_sh, D, acc);
  }
}

// The exact centered dot Σ(a_c · b_c) from the code dot and the sums, the
// affine fix of _kind_dist_tile (exact int32 for D <= 2048):
//   u8:    centered 2u-255 both sides      4*dot8 + 2*(q_sum + row_sum) + D
//   asym:  2u-255 query, 34*v4-255 rows    68*dot8 + 34*row_sum - 510*q_sum - 255*D
//   sym:   34*v4-255 both sides            1156*dot8 - 8670*(q_sum + row_sum) + 65025*D
template <int KIND>
__device__ __forceinline__ int centered_dot(int dot8, int q_sum, int row_sum,
                                            int D) {
  if constexpr (KIND == kU8) {
    return 4 * dot8 + 2 * (q_sum + row_sum) + D;
  } else if constexpr (KIND == kInt4Asym) {
    return 68 * dot8 + 34 * row_sum - 510 * q_sum - 255 * D;
  } else {
    return 1156 * dot8 - 8670 * (q_sum + row_sum) + 65025 * D;
  }
}

// The spec v2 cosine of an exact centered dot: fl(dot_c * fl(qr * rr)).
__device__ __forceinline__ float spec_cos(int dot_c, float qr, float rr) {
  return __fmul_rn(__int2float_rn(dot_c), __fmul_rn(qr, rr));
}

// Canonical spec v2 epilogue, exactly _kind_dist_tile's, from dot_c:
//   cos   = fl(dot_c * fl(qr * rr))
//   dist  = fl(fl(1 / max(cos, 1e-6)) - 1), clamped to >= 0
//   identical vectors (dot == m2q == m2r on the f32 copies) pinned to 0.
__device__ __forceinline__ float spec_dist(int dot_c, float qr, float rr,
                                           float q_mag2f, float row_mag2f) {
  const float dot_f = __int2float_rn(dot_c);
  const float cosv = spec_cos(dot_c, qr, rr);
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
template <int QT, typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q_codes,
                                              int q0, int nq, int D, T* q_sh) {
  for (int t = threadIdx.x; t < QT * D; t += blockDim.x) {
    const int j = t / D;
    q_sh[t] = (j < nq) ? q_codes[static_cast<size_t>(q0 + j) * D + (t - j * D)]
                       : static_cast<T>(0);
  }
}

}  // namespace
