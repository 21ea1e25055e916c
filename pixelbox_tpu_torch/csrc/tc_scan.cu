// Hopper (sm_90a) tensor-core collect kernels: K1a (u8 cosine rows,
// selecting on the spec distance), K4a (packed int4 rows, the asymmetric
// and symmetric int4 metrics) and K2a (packed phash rows, Hamming) on int8
// wgmma.
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
// Plain C interface, bound with ctypes; every entry point returns
// cudaGetLastError() (or kTensorMapError + the driver's code when a TMA
// descriptor cannot be encoded) so the Python wrapper can raise.  The
// TMA descriptor encoder comes from cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "scan_device.cuh"
#include "wgmma_s8.cuh"

#define PX_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kTileRows = 64;    // wgmma M: one warpgroup's rows
constexpr int kTcThreads = 128;  // one warpgroup a block
constexpr int kStages = 4;       // K1a's row tiles in the TMA ring (8 KB each at D = 128)
constexpr int kStages4 = 8;      // K4a's (4 KB each)
constexpr int kDim4 = 128;       // K4a's width: 64-byte packed rows, four k-steps
constexpr int kHamStages = 8;    // K2a's (2 KB each)
constexpr int kPhBytes = 32;     // K2a's hash width (the published 16x16 phash)
constexpr int kPhK = 8 * kPhBytes;  // K2a's ±1 depth
constexpr int kTensorMapError = 10000;
// 1.5 * 2^24 as f32 bits: in [2^24, 2^25) one ulp is 2, so adding an int i
// (|i| < 2^22) to these bits gives the float 25165824 + 2i exactly.
constexpr int kMagic2Bits = 0x4BC00000;
constexpr float kMagic2 = 25165824.0f;
// Passing rows a block gathers in shared memory before it appends them to
// the buffers (one round of global atomics for many rows).
constexpr int kHits = 1024;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// ---- PTX: shared addresses, mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
  __syncwarp();  // reconverge before the warpgroup-wide wgmma
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand stored as column
// chunks [K / chunk][rows][chunk]: start address, leading offset (between
// chunks along K; unused when one chunk is a whole swizzle span), stride
// between 8-row groups (8 x the chunk), swizzle mode (`layout`: 0 = none,
// 16-byte chunks of 8 x 16 B core matrices; 1 = 128 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// Bytes of one K-major column chunk of K1a's rows and queries: a row of
// 128 B is one 128-byte swizzle span; narrower rows (32, 64 B) go as
// unswizzled 16-byte chunks.
__host__ __device__ constexpr int row_chunk(int d) { return d == 128 ? 128 : 16; }

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
// K4a builds its A operand in registers, as K2a does: k-step t < 4 takes
// dims 32t..32t+31, the low nibbles of packed bytes 32(t % 2).. for t < 2
// and the high nibbles of the same bytes for t >= 2, so a thread's A
// fragment (rows r0, r0 + 8 at k = 4tq.. and 16 + 4tq..) is one mask, or
// one shift and mask, of four 32-bit words of each of its two rows, and
// the queries stay in natural dim order.
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
      // A fragments from the packed rows: words 8m + tq and 8m + 4 + tq of
      // rows r0 and r0 + 8 give k-step m (low nibbles) and m + 2 (high).
      constexpr uint32_t kLo = 0x0F0F0F0Fu;
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows + s * kTileRows * rb);
      uint32_t a[4][4];
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
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        Wgmma<NQ>::rs(acc, a[t], smem_desc(q_addr + 32 * t, NQ * 128, 1024, 1), t > 0);
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
      // 16 k values (two bytes) a chunk; bytes at or past the limit are 0.
      for (int t = tid; t < NQ * (kPhK / 16); t += kTcThreads) {
        const int n = t / (kPhK / 16), ch = t % (kPhK / 16);
        const int q = qt * NQ + n;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ch < kPhBytes / 16) {  // the packed copy, for the survivors' bit counts
          const uint4* src =
              reinterpret_cast<const uint4*>(q_bytes + static_cast<size_t>(q) * kPhBytes);
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
          int lo = 0, hi = (WRAP ? min(bits, 255) : bits) + 1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__fmul_rn(__int2float_rn(mid), scale) < th) lo = mid + 1;
            else hi = mid;
          }
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
    uint32_t w[2][8];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const uint4 lo4 = *reinterpret_cast<const uint4*>(rs + r * kPhBytes);
      const uint4 hi4 = *reinterpret_cast<const uint4*>(rs + r * kPhBytes + 16);
      w[h][0] = lo4.x; w[h][1] = lo4.y; w[h][2] = lo4.z; w[h][3] = lo4.w;
      w[h][4] = hi4.x; w[h][5] = hi4.y; w[h][6] = hi4.z; w[h][7] = hi4.w;
      ok[h] = ok_s[s * 128 + r] != 0 && tile * kTileRows + r < N;
    }

    // A fragment of k-step s (bits 32s..32s+31 = word s): rows r0, r0 + 8
    // at k = 4tq..4tq+3 and 16+4tq..16+4tq+3.
    uint32_t a[kPhK / 32][4];
#pragma unroll
    for (int ks = 0; ks < kPhK / 32; ++ks) {
      a[ks][0] = pm1_nibble(w[0][ks] >> (4 * tq));
      a[ks][1] = pm1_nibble(w[1][ks] >> (4 * tq));
      a[ks][2] = pm1_nibble(w[0][ks] >> (16 + 4 * tq));
      a[ks][3] = pm1_nibble(w[1][ks] >> (16 + 4 * tq));
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kPhK / 32; ++ks)
      Wgmma<NQ>::rs(acc, a[ks],
                    smem_desc(q_addr + (ks / 4) * NQ * 128 + (ks % 4) * 32, NQ * 128, 1024, 1),
                    ks > 0);
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

// ---- Host side: TMA descriptors and launches

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-1 or rank-2 map; zero fill out of bounds (padding rows, rows past
// N, query rows past Q).  Returns 0 or kTensorMapError + the driver's code.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
               uint64_t dim0, uint64_t dim1, uint64_t stride1, uint32_t box0, uint32_t box1,
               CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kTensorMapError;
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {stride1};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// Persistent grid: as many blocks as fit on the SMs, at most one a tile.
// The shared-memory opt-in and the occupancy query are host calls of some
// microseconds; each (kernel, device, bytes) asks once.
template <typename Kernel>
int persistent_grid(Kernel kernel, size_t smem, int n_tiles, int* grid) {
  struct Fit {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  auto it = std::find_if(fits.begin(), fits.end(), [&](const Fit& f) {
    return f.kernel == key && f.dev == dev && f.smem == smem;
  });
  if (it == fits.end()) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    it = fits.insert(fits.end(), Fit{key, dev, smem, std::max(1, per_sm) * sms});
  }
  *grid = std::min(n_tiles, it->blocks);
  return 0;
}

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
               ? encode_map(&rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, data, D, N, D, cb, kTileRows, sw)
               : encode_map(&rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, data, rb, N, rb, rb, kTileRows,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0) rc = encode_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q_codes, D, Q, D, cb, nq, sw);
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
  int rc = encode_map(&rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, data, kPhBytes, N, kPhBytes,
                      kPhBytes, kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = encode_map(&ok, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, row_ok, N, 1, 16, kTileRows, 1,
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
