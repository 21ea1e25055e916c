// The operand paths and the hot filter shared by the tensor-core scan
// kernels (tc_scan.cu: the collects K1a, K4a, K2a and the chunk top-k K1b,
// K4b, K2b) and the θ stage (tc_theta.cu): the int4 rows unpacked into
// wgmma's A fragment, the ±1 form of the packed phash bits (rows in
// registers, queries staged once in a 128B-swizzled tile), and K1a's
// branch-free key bound.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_device.cuh"
#include "tc_device.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int kDim4 = 128;       // K4a's width: 64-byte packed rows, four k-steps
constexpr int kHamStages = 8;    // K2a's row tiles in the TMA ring (2 KB each)
constexpr int kPhBytes = 32;     // K2a's hash width (the published 16x16 phash)
constexpr int kPhK = 8 * kPhBytes;  // K2a's ±1 depth
constexpr int kHamming = 3;  // the Hamming kind of the chunk top-k (K2b) and the θ stage, beside kU8, kInt4Asym, kInt4Sym

// Four bits (the low nibble of x) to four ±1 int8 (bit 1 -> +1, 0 -> -1):
// spread the bits to the bytes' low bits, then 0 -> 0xFF, 1 -> 0x01.
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t x) {
  const uint32_t t = ((x & 0xFu) * 0x00204081u) & 0x01010101u;
  return ~(t * 0xFEu);
}

// K1a's hot filter, a superset of the cos key of cos_key_threshold
// (fused_scan.py: key = -fl(fl(1 / fl(1 + θ)) · key_scale), +inf from the
// saturation on) and so of dist < θ: a pair passes when fl(dot_c · rr) > u,
// u = fl(fl(c · key_loose) / qr), c = -key — op for op fused_scan.py's
// key_bound (IEEE divides; the constants come from there), which
// tests/test_torch_port_tc.py holds on the CPU.  The spec key is
// fl(dot_c · fl(qr · rr)) > c; the two sides differ by three roundings,
// far inside key_loose's 2^-16.  Computed once per query tile, outside the
// accumulator loop.  c <= 0 (θ past the saturation) admits every valid
// row; NaN none.
__device__ __forceinline__ float key_bound(float th, float qr, float key_scale, float saturation,
                                           float key_loose) {
  const float c = th >= saturation ? -__int_as_float(0x7f800000)
                                   : __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(1.0f, th)), key_scale);
  if (c != c) return c;
  if (c <= 0.0f) return -__int_as_float(0x7f800000);
  return __fdiv_rn(__fmul_rn(c, key_loose), qr);
}

// ---- Operand paths shared by the collects (K4a, K2a), the chunk top-k
// (K4b, K2b) and the θ stage

// The A fragments of the int4 product from a staged tile of packed rows
// (64 x 64 B, unswizzled): k-step t < 4 takes dims 32t..32t+31, the low
// nibbles of packed bytes 32(t % 2).. for t < 2 and the high nibbles of the
// same bytes for t >= 2, so words 8m + tq and 8m + 4 + tq of rows r0 and
// r0 + 8 give k-step m (masked) and m + 2 (shifted and masked).
__device__ __forceinline__ void nibble_fragments(const uint8_t* tile, int r0, int tq,
                                                 uint32_t (&a)[4][4]) {
  constexpr uint32_t kLo = 0x0F0F0F0Fu;
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(tile);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* w = rw + (r0 + 8 * h) * (kDim4 / 8) + 8 * m + tq;
      const uint32_t w0 = w[0], w1 = w[4];
      a[m][h] = w0 & kLo;
      a[m][2 + h] = w1 & kLo;
      a[m + 2][h] = (w0 >> 4) & kLo;
      a[m + 2][2 + h] = (w1 >> 4) & kLo;
    }
  }
}

// The int4 product of a row tile against NQ staged queries (int8 codes
// [NQ][128], 128B-swizzled, in natural dim order).
template <int NQ>
__device__ __forceinline__ void nibble_product(int (&acc)[NQ / 2], const uint32_t (&a)[4][4],
                                               uint32_t q_addr) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t)
    Wgmma<NQ>::rs(acc, a[t], smem_desc(q_addr + 32 * t, NQ * 128, 1024, 1), t > 0);
}

// The ±1 B operand of the Hamming product: queries q0.. of q_bytes
// [Q, 32] expanded once per block into a 128B-swizzled tile
// [kPhK / 128][NQ][128], 16 k values (two bytes) a 16-byte unit; the
// bytes at or past `limit`, and the queries past Q, are 0, so they add
// nothing.  q_raw (may be null): the packed copy [NQ][32] (zeros past Q).
template <int NQ>
__device__ void stage_pm1_queries(const uint8_t* __restrict__ q_bytes, int q0, int Q, int limit,
                                  uint8_t* q_pm1, uint8_t* q_raw) {
  for (int t = threadIdx.x; t < NQ * (kPhK / 16); t += blockDim.x) {
    const int n = t / (kPhK / 16), ch = t % (kPhK / 16);
    const int q = q0 + n;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q_raw != nullptr && ch < kPhBytes / 16) {
      const uint4* src = reinterpret_cast<const uint4*>(q_bytes + static_cast<size_t>(q) * kPhBytes);
      *reinterpret_cast<uint4*>(q_raw + n * kPhBytes + 16 * ch) = q < Q ? src[ch] : v;
    }
    if (q < Q) {
      const uint8_t* qb = q_bytes + static_cast<size_t>(q) * kPhBytes + 2 * ch;
      if (2 * ch < limit) {
        v.x = pm1_nibble(qb[0]);
        v.y = pm1_nibble(qb[0] >> 4);
      }
      if (2 * ch + 1 < limit) {
        v.z = pm1_nibble(qb[1]);
        v.w = pm1_nibble(qb[1] >> 4);
      }
    }
    const int blk = ch / 8, c8 = ch % 8;
    *reinterpret_cast<uint4*>(q_pm1 + (blk * NQ + n) * 128 + ((c8 ^ (n & 7)) << 4)) = v;
  }
}

// The A fragments of the ±1 product from a staged tile of packed 32-byte
// rows, each bit expanded in registers: k-step s (bits 32s..32s+31 = word
// s) for rows r0 and r0 + 8 at k = 4tq..4tq+3 and 16+4tq..16+4tq+3.
__device__ __forceinline__ void pm1_fragments(const uint8_t* tile, int r0, int tq,
                                              uint32_t (&a)[kPhK / 32][4]) {
  uint32_t w[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint8_t* row = tile + (r0 + 8 * h) * kPhBytes;
    const uint4 lo4 = *reinterpret_cast<const uint4*>(row);
    const uint4 hi4 = *reinterpret_cast<const uint4*>(row + 16);
    w[h][0] = lo4.x; w[h][1] = lo4.y; w[h][2] = lo4.z; w[h][3] = lo4.w;
    w[h][4] = hi4.x; w[h][5] = hi4.y; w[h][6] = hi4.z; w[h][7] = hi4.w;
  }
#pragma unroll
  for (int ks = 0; ks < kPhK / 32; ++ks) {
    a[ks][0] = pm1_nibble(w[0][ks] >> (4 * tq));
    a[ks][1] = pm1_nibble(w[1][ks] >> (4 * tq));
    a[ks][2] = pm1_nibble(w[0][ks] >> (16 + 4 * tq));
    a[ks][3] = pm1_nibble(w[1][ks] >> (16 + 4 * tq));
  }
}

// The ±1 product of a row tile against the staged ±1 queries: dot = 8·limit
// − 2·diff for each (row, query).
template <int NQ>
__device__ __forceinline__ void pm1_product(int (&acc)[NQ / 2], const uint32_t (&a)[kPhK / 32][4],
                                            uint32_t q_addr) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kPhK / 32; ++ks)
    Wgmma<NQ>::rs(acc, a[ks], smem_desc(q_addr + (ks / 4) * NQ * 128 + (ks % 4) * 32, NQ * 128, 1024, 1),
                  ks > 0);
}

// A warpgroup's product of a landed row tile against the staged queries
// (q_addr: their B operand), issued asynchronously and committed: the
// caller waits for it (wgmma_wait0).  u8 rows of d bytes (K1a's column
// chunks of row_chunk(d) bytes) through a descriptor; the packed int4 rows
// (nibble_fragments) and the packed hash bits (pm1_fragments, kind
// kHamming) in registers.
template <int NQ, int KIND>
__device__ __forceinline__ void tile_product(int (&acc)[NQ / 2], const uint8_t* tile, int r0, int tq,
                                             uint32_t q_addr, int d) {
  if constexpr (KIND == kU8) {
    const int cb = row_chunk(d);
    const uint32_t layout = cb == 128 ? 1u : 0u, a0 = smem_u32(tile);
    wgmma_fence();
    for (int k = 0; k < d / 32; ++k) {
      const int c = 32 * k / cb, off = 32 * k % cb;  // k-step k: chunk c, byte off
      Wgmma<NQ>::ss(acc, smem_desc(a0 + c * kTileRows * cb + off, kTileRows * cb, 8 * cb, layout),
                    smem_desc(q_addr + c * NQ * cb + off, NQ * cb, 8 * cb, layout), k > 0);
    }
  } else if constexpr (KIND == kHamming) {
    uint32_t af[kPhK / 32][4];
    pm1_fragments(tile, r0, tq, af);
    pm1_product<NQ>(acc, af, q_addr);
  } else {
    uint32_t af[4][4];
    nibble_fragments(tile, r0, tq, af);
    nibble_product<NQ>(acc, af, q_addr);
  }
  wgmma_commit();
}

// ---- The survivors' exact dot (phase 2 of the collects and the θ stage)

// The int8 dot of row r of a staged row tile and staged query c, from the
// shared tiles in their wgmma layout (K1a: chunks of cb bytes, a 128-byte
// chunk swizzled by row: 16-byte unit u of row r at u ^ (r % 8)).
__device__ __forceinline__ int tile_dot8(const int8_t* rows, int r, const int8_t* q, int nq, int c,
                                         int d, int cb) {
  int acc = 0;
  for (int k = 0; k < d; k += 16) {
    const int ch = k / cb, u = (k % cb) >> 4;
    const int su = cb == 128 ? u ^ (r & 7) : u, qu = cb == 128 ? u ^ (c & 7) : u;
    const int4 a = *reinterpret_cast<const int4*>(rows + (ch * kTileRows + r) * cb + 16 * su);
    const int4 b = *reinterpret_cast<const int4*>(q + (ch * nq + c) * cb + 16 * qu);
    acc = __dp4a(a.x, b.x, acc);
    acc = __dp4a(a.y, b.y, acc);
    acc = __dp4a(a.z, b.z, acc);
    acc = __dp4a(a.w, b.w, acc);
  }
  return acc;
}

// The int4 dot of packed row r of a staged K4a row tile (64 x 64 B,
// unswizzled) and staged query c (128 int8 codes, 128B-swizzled): bytes
// 16u..16u+15 hold dims 16u.. in their low nibbles and 64 + 16u.. in
// their high ones.
__device__ __forceinline__ int tile_dot4(const uint8_t* rows, int r, const int8_t* q, int c) {
  constexpr uint32_t kLo = 0x0F0F0F0Fu;
  const int8_t* qc = q + c * kDim4;
  int acc = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint4 w = *reinterpret_cast<const uint4*>(rows + r * (kDim4 / 2) + 16 * u);
    const int4 lo = *reinterpret_cast<const int4*>(qc + 16 * (u ^ (c & 7)));
    const int4 hi = *reinterpret_cast<const int4*>(qc + 16 * ((u + 4) ^ (c & 7)));
    acc = __dp4a(static_cast<int>(w.x & kLo), lo.x, acc);
    acc = __dp4a(static_cast<int>(w.y & kLo), lo.y, acc);
    acc = __dp4a(static_cast<int>(w.z & kLo), lo.z, acc);
    acc = __dp4a(static_cast<int>(w.w & kLo), lo.w, acc);
    acc = __dp4a(static_cast<int>((w.x >> 4) & kLo), hi.x, acc);
    acc = __dp4a(static_cast<int>((w.y >> 4) & kLo), hi.y, acc);
    acc = __dp4a(static_cast<int>((w.z >> 4) & kLo), hi.z, acc);
    acc = __dp4a(static_cast<int>((w.w >> 4) & kLo), hi.w, acc);
  }
  return acc;
}

// T = #{d in [0, dmax] : fl(d · scale) < th}: the distance is monotone in
// d, so dist < th ⟺ d < T (fused_scan.py's hamming_pass_count counts the
// same predicate).
__device__ __forceinline__ int hamming_pass_count(float th, int dmax, float scale) {
  int lo = 0, hi = dmax + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__fmul_rn(__int2float_rn(mid), scale) < th) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

}  // namespace
