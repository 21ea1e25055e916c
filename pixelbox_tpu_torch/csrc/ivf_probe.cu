// K5: the IVF probe (Hopper, sm_90a): per (query, probed bucket) the k'
// smallest (dist, row id) of the bucket's slots; its work list; the first
// port's probe; and the gathered mode, the exact-u8 rescore of per-query
// candidate rows.
//
// The JAX package has no Pallas kernel here: its probe
// (pixelbox_tpu/ops/ivf.py:_ivf_probe_topk, :498) is XLA — a gather of
// the probed buckets into a [Q, nprobe, cap, D] copy, an einsum, the spec
// epilogue, a per-bucket top-k (block_topk) and a tree merge — and its
// device rescore (ops/ivf_build.py:_rerank_device) the same over gathered
// rows.  ivf_probe_tc_kernel computes the per-bucket top-k; K1c
// (fused_scan.cu, lex_topk) then takes the top k of the [Q, nprobe · k']
// partials by (dist, row id), which equals the tree merge because a row
// sits in one bucket.
//
// ivf_invert_kernel (one block): the probe list inverted, bucket-major,
// where buckets are shared (Q · P > C; else each pair is its own item).
// Each probed bucket's (query, probe rank) pairs, cut into work items of
// at most kProbeNQ pairs: a counting sort of the pairs by bucket in shared
// memory (ids outside [0, C) group as one empty bucket, last), the table
// built there too where it fits.  Items come in bucket order; the pairs of
// a bucket are spread over its items in the order the atomics give (the
// probe's outputs do not depend on it).
//
// ivf_probe_tc_kernel: a persistent grid of one-warpgroup blocks, each
// walking work items with stride gridDim.x.  An item's bucket is read
// once, IN PLACE: 64-row tiles of bucket_data viewed as [C · cap, row
// bytes] arrive by TMA into a ring of shared-memory slots (tc_device.cuh),
// and the bucket's slot meta (sum, mag2, row id, valid) by cp.async into
// shared memory while the block selects the item before, its rsqrt_spec
// (the square root in f64, rounded once) then taken once a slot.  The rows
// are wgmma's A operand (u8 rows K-major through a descriptor, int4
// nibbles unpacked in registers: tc_operands.cuh tile_product) and the
// item's queries (their int8 codes gathered by index, K1a's layout) are B.
// The epilogue is the first port's, op for op: centered_dot, spec_dist,
// then the slot-valid and dist < max_distance filters.  Where k' < cap
// each (query, slot)'s (dist, row id) key (make_key; kNoKey where
// filtered) goes to a [NQ][cap] buffer in shared memory, and the passing
// keys' count and distance range to registers; after the bucket's last
// tile one warp a query (the whole block where there is no work list and
// an item is one query: select_block) finds its k'-th key (select_bins: a
// histogram over a window fitted to the bucket's distances, zoomed into
// while the k'-th's bin is full, then that bin's few keys ranked; many
// copies of one row: the radix select of select_device.cuh) and writes
// the k' smallest in slot order to [Q, P, k'] at (q, p), (+inf, 2^31 - 1)
// past them.
// Where k' = cap every slot is written in place, (+inf, 2^31 - 1) where
// filtered, as the first port's kernel writes it.  Where Q · P <= C (Q = 1
// always) each pair is its own item: the work list is the probe list
// itself (no inversion).
//
// What bounds it on this card: the distinct probed buckets' bytes (rows
// and slot meta) read once a batch, and the [Q, P, k'] it writes; the
// product is far below the int8 rate at N = 8.  Past the reads the cost is
// the epilogue's f64 root and IEEE divide a slot and the selection, one
// warp a (query, bucket) pair.
//
// ivf_probe_dp4a_kernel (the first port's K5, kept as the timing reference
// and for the widths the tensor-core kernel does not take): one block a
// (probed bucket, query), a thread a slot on __dp4a; a bucket probed by
// several queries is read once per query, and every slot is written.
//
// ivf_gathered_kernel: a thread a (query, candidate); the candidate's u8
// row is read from the row array [N, D] and its moments are computed in
// the kernel from the bytes (u - 128 = u ^ 0x80 per byte: the code dot,
// the code sum and the sum of squares on __dp4a; mag2 = 4·Σv² + 4·Σv + D
// for v = u - 128), then the u8 kind's fix and epilogue.  Ids outside
// [0, N) are empty.
//
// Every f32 op is correctly rounded (explicit __fmul_rn / __fdiv_rn in
// scan_device.cuh, -fmad=false), so the outputs are bit-identical to the
// plain PyTorch versions in ops/ivf.py and ops/ivf_build.py.
//
// Plain C interface, bound with ctypes; every entry returns
// cudaGetLastError() (or kTensorMapError + the encoder's CUresult when a TMA
// descriptor cannot be encoded).

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

constexpr int kNoRow = 0x7fffffff;
constexpr int kProbeNQ = 8;          // queries of a work item: the wgmma N
constexpr int kProbeStages = 3;      // row tiles in the TMA ring (three blocks an SM at cap 512)
constexpr int kItemInts = 1 + kProbeNQ;  // a work item: its bucket, then its pair ids (-1 past them)
constexpr int kSelectMaxCap = 2048;  // the largest cap whose [NQ][cap] keys the select holds
constexpr int kTcMaxCap = 8192;      // the largest cap whose slot meta the kernel holds
constexpr int kInvertThreads = 1024;
constexpr int kInvertBatch = 8;  // pairs a thread loads before it uses them
constexpr int kInvertSmemBuckets = 16384;  // buckets whose counters fit the inversion's shared memory
constexpr int kProbeWarps = kTcThreads / 32;
// A warp's select scratch (ints): 256 histogram bins, 4 scalars and the
// keys of the k'-th bin (kBinList: ranked pairwise, a key a
// lane; a fuller bin is zoomed into).
constexpr int kBinList = 32;
constexpr int kSelInts = 256 + 4 + 2 * kBinList;

// rsqrt_spec of an integer magnitude: fl(1 / fl(sqrt(f32(m)))), the root
// taken in f64 and rounded once (correctly rounded for any f32 input).
__device__ __forceinline__ float rsqrt_spec_dev(int mag2) {
  const float m = __int2float_rn(mag2);
  const float s = __double2float_rn(__dsqrt_rn(static_cast<double>(m)));
  return __fdiv_rn(1.0f, s);
}

// Asynchronous copies global -> shared (sm_80 cp.async), 16 or 4 bytes,
// completed by cp.async.wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// ---- The work list

__device__ __forceinline__ int bucket_slot(int b, int C) { return b >= 0 && b < C ? b : C; }

__global__ void __launch_bounds__(kInvertThreads)
ivf_invert_kernel(const int* __restrict__ bids, int M, int C, int* __restrict__ scratch,
                  int* __restrict__ work, int smem_ints) {
  // Dynamic shared memory only (allow_smem opts the kernel into all of
  // it): the scan's warp sums, the counters unless they take scratch, then
  // the table itself where it fits (one block's scattered stores to device
  // memory would be the kernel's time; it is copied out coalesced).
  extern __shared__ int inv_smem[];
  int* warp_sums = inv_smem;
  const int nb = C + 1;  // the buckets, then the empty probes
  int* cnt = scratch != nullptr ? scratch : inv_smem + kInvertThreads / 32;  // [nb] counts, later fill pointers
  int* off = cnt + nb;                                 // [nb] each bucket's first item
  int* staged = scratch != nullptr ? inv_smem + kInvertThreads / 32 : off + nb;
  const int tid = threadIdx.x;
  for (int i = tid; i < nb; i += kInvertThreads) cnt[i] = 0;
  __syncthreads();
  // The pairs' buckets, kInvertBatch a thread loaded before any is used
  // (one block: a load a pair in turn would be latency-bound).
  auto slots = [&](int j0, int (&sl)[kInvertBatch]) {
#pragma unroll
    for (int u = 0; u < kInvertBatch; ++u) {
      const int j = j0 + u * kInvertThreads;
      sl[u] = j < M ? bucket_slot(__ldg(bids + j), C) : -1;
    }
  };
  for (int j0 = tid; j0 < M; j0 += kInvertThreads * kInvertBatch) {
    int sl[kInvertBatch];
    slots(j0, sl);
#pragma unroll
    for (int u = 0; u < kInvertBatch; ++u)
      if (sl[u] >= 0) atomicAdd(cnt + sl[u], 1);
  }
  __syncthreads();
  // Items a bucket: ceil(count / NQ); their exclusive sum over the
  // buckets, each thread a contiguous run of buckets.
  const int per = (nb + kInvertThreads - 1) / kInvertThreads;
  const int lo = min(nb, tid * per), hi = min(nb, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += (cnt[i] + kProbeNQ - 1) / kProbeNQ;
  int before = team_exclusive_sum<kInvertThreads>(local, warp_sums);
  for (int i = lo; i < hi; ++i) {
    off[i] = before;
    before += (cnt[i] + kProbeNQ - 1) / kProbeNQ;
  }
  if (tid == kInvertThreads - 1) {
    work[0] = before;  // the items
    warp_sums[0] = before;
  }
  __syncthreads();
  const int n_items = warp_sums[0];
  const bool in_smem = static_cast<long long>(n_items) * kItemInts <= smem_ints - (staged - inv_smem);
  int* table = in_smem ? staged : work + 1;
  for (int i = tid; i < nb; i += kInvertThreads) {
    const int items = (cnt[i] + kProbeNQ - 1) / kProbeNQ;
    for (int t = 0; t < items; ++t) {
      int* rec = table + static_cast<size_t>(off[i] + t) * kItemInts;
      rec[0] = i < C ? i : -1;
      for (int c = 0; c < kProbeNQ; ++c) rec[1 + c] = -1;
    }
  }
  __syncthreads();
  for (int i = tid; i < nb; i += kInvertThreads) cnt[i] = 0;
  __syncthreads();
  for (int j0 = tid; j0 < M; j0 += kInvertThreads * kInvertBatch) {
    int sl[kInvertBatch], r[kInvertBatch];
    slots(j0, sl);
#pragma unroll
    for (int u = 0; u < kInvertBatch; ++u) r[u] = sl[u] >= 0 ? atomicAdd(cnt + sl[u], 1) : 0;
#pragma unroll
    for (int u = 0; u < kInvertBatch; ++u)
      if (sl[u] >= 0)
        table[static_cast<size_t>(off[sl[u]] + r[u] / kProbeNQ) * kItemInts + 1 + r[u] % kProbeNQ] =
            j0 + u * kInvertThreads;
  }
  if (in_smem) {
    __syncthreads();
    for (int x = tid; x < n_items * kItemInts; x += kInvertThreads) work[1 + x] = table[x];
  }
}

// ---- The tensor-core probe

__host__ __device__ constexpr int probe_row_bytes(int kind, int d) { return kind == kU8 ? d : d / 2; }

// Bytes of an item's slot meta in shared memory: sum, mag2, row id and
// rsqrt_spec (4 bytes each) and validity (a byte) a slot.
__host__ __device__ constexpr int meta_bytes(int cap) { return 16 * cap + round_up(cap, 16); }

// Shared-memory layout (byte offsets from a 1024-aligned base): the item's
// queries (B, [D / chunk][NQ][chunk], 128B-swizzled at D = 128), the TMA
// ring of row tiles, the item's slot meta, the [NQ][cap] keys (k' < cap
// only), per warp its select scratch (kSelInts), the item's pair ids, per
// (warp, query) the passing keys' count and distance-bit range, the
// mbarriers.
struct ProbeSmem {
  int q, rows, meta, keys, sel, pairs, stats, bars, total;
  __host__ __device__ ProbeSmem(int kind, int d, int cap, bool select)
      : q(0),
        rows(round_up(kProbeNQ * d, 1024)),
        meta(rows + kProbeStages * kTileRows * probe_row_bytes(kind, d)),
        keys(meta + meta_bytes(cap)),
        sel(keys + (select ? kProbeNQ * cap * 8 : 0)),
        pairs(sel + kProbeWarps * kSelInts * 4),
        stats(pairs + kProbeNQ * 4),
        bars(stats + kProbeWarps * kProbeNQ * 3 * 4),
        total(bars + kProbeStages * 8) {}
};

struct ProbeArgs {
  const int8_t* q_codes;  // [Q, D] u8 - 128 codes (16-byte aligned)
  const int* q_sum;       // [Q]
  const int* q_mag2;      // [Q]
  const float* qr;        // [Q]
  float md;
  const int* bids;        // [Q * P] the probe list (pair j = q * P + p)
  const int* work;        // the inverted list (ivf_invert_kernel), or null: item j = pair j
  const int* bsum;        // [C, cap]
  const int* bmag2;       // [C, cap]
  const int* brows;       // [C, cap]
  const uint8_t* bvalid;  // [C, cap]
  int M, P, C, cap, D, kp;
  float* out_d;           // [Q, P, kp]
  int* out_i;
};

// What a thread needs of one work item: its bucket, the pair ids of its
// query unit (staging) and of its two accumulator columns, then (fetched
// later, from those) the unit's 16 code bytes and the columns' moments.
struct ItemRegs {
  int b, pair_u, pair_c[2];
  int4 code;
  int qs[2];
  float qr[2], qm[2];
};

template <int KIND, bool SELECT>
__global__ void __launch_bounds__(kTcThreads)
ivf_probe_tc_kernel(const __grid_constant__ CUtensorMap rows_map, const ProbeArgs a) {
  extern __shared__ uint8_t tc_smem_raw[];
  constexpr int NQ = kProbeNQ;
  const ProbeSmem L(KIND, a.D, a.cap, SELECT);
  const int rb = probe_row_bytes(KIND, a.D);
  uint8_t* sm = align_smem(tc_smem_raw);
  uint8_t* q_tile = sm + L.q;
  uint8_t* rows = sm + L.rows;
  int* m_sum = reinterpret_cast<int*>(sm + L.meta);
  int* m_mag = m_sum + a.cap;
  int* m_row = m_mag + a.cap;
  float* m_rr = reinterpret_cast<float*>(m_row + a.cap);
  uint8_t* m_valid = reinterpret_cast<uint8_t*>(m_rr + a.cap);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(sm + L.keys);
  int* item_pairs = reinterpret_cast<int*>(sm + L.pairs);
  int* col_stats = reinterpret_cast<int*>(sm + L.stats);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* hist = reinterpret_cast<int*>(sm + L.sel) + warp * kSelInts;
  int* scal = hist + 256;
  unsigned long long* bin_list = reinterpret_cast<unsigned long long*>(scal + 4);

  const int n_items = a.work != nullptr ? __ldg(a.work) : a.M;
  const int n_my = static_cast<int>(blockIdx.x) < n_items
                       ? (n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nt = (a.cap + kTileRows - 1) / kTileRows;
  const int total = n_my * nt;
  const int cb = row_chunk(a.D);
  const int units = NQ * a.D / 16;  // 16-byte units of the query tile
  const int r0 = 16 * warp + (lane >> 2), tq = lane & 3;
  const int n_u = tid / (a.D / 16), v_u = tid % (a.D / 16);

  auto item_rec = [&](int jj) {
    return a.work + 1 + static_cast<size_t>(blockIdx.x + jj * gridDim.x) * kItemInts;
  };
  auto bucket_of = [&](int jj) {
    return a.work != nullptr ? __ldg(item_rec(jj)) : __ldg(a.bids + blockIdx.x + jj * gridDim.x);
  };
  auto pair_of = [&](int jj, int c) {
    if (a.work != nullptr) return __ldg(item_rec(jj) + 1 + c);
    return c == 0 ? static_cast<int>(blockIdx.x + jj * gridDim.x) : -1;
  };
  auto fetch_head = [&](int jj, ItemRegs& R) {
    R.b = bucket_of(jj);
    R.pair_u = tid < units ? pair_of(jj, n_u) : -1;
    R.pair_c[0] = pair_of(jj, 2 * tq);
    R.pair_c[1] = pair_of(jj, 2 * tq + 1);
  };
  auto fetch_body = [&](ItemRegs& R) {
    R.code = make_int4(0, 0, 0, 0);
    if (R.pair_u >= 0)
      R.code = __ldg(reinterpret_cast<const int4*>(a.q_codes + static_cast<size_t>(R.pair_u / a.P) * a.D) + v_u);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      R.qs[e] = 0, R.qr[e] = 0.0f, R.qm[e] = 0.0f;
      if (R.pair_c[e] >= 0) {
        const int q = R.pair_c[e] / a.P;
        R.qs[e] = __ldg(a.q_sum + q);
        R.qr[e] = __ldg(a.qr + q);
        R.qm[e] = __int2float_rn(__ldg(a.q_mag2 + q));
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kProbeStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 keeps the ring full: tile g is tile g % nt of item g / nt (an
  // empty probe's tiles read bucket 0, every slot masked), the next item's
  // bucket fetched one item ahead.
  int iss_item = -1, iss_b = 0, nxt_b = 0;
  auto issue = [&](int g) {
    const int jj = g / nt, t = g - jj * nt;
    if (jj != iss_item) {
      iss_item = jj;
      iss_b = nxt_b;
      nxt_b = jj + 1 < n_my ? bucket_of(jj + 1) : 0;
    }
    const int row = (iss_b >= 0 && iss_b < a.C ? iss_b : 0) * a.cap + t * kTileRows;
    const int s = g % kProbeStages;
    uint8_t* dst = rows + s * kTileRows * rb;
    mbar_expect_tx(full + s, kTileRows * rb);
    if constexpr (KIND == kU8) {
      for (int c = 0; c < a.D / cb; ++c)
        tma_load_2d(dst + c * kTileRows * cb, &rows_map, full + s, c * cb, row);
    } else {
      tma_load_2d(dst, &rows_map, full + s, 0, row);
    }
  };
  if (tid == 0 && total > 0) {
    nxt_b = bucket_of(0);
    for (int g = 0; g < min(kProbeStages, total); ++g) issue(g);
  }

  // An item's slot meta, copied into shared memory by cp.async (16 bytes a
  // copy: cap is a multiple of 4) while the block selects the item before,
  // then its rsqrt_spec a slot (the f64 root and a divide) taken once for
  // all of the item's queries.  Per-tile loads of a tile's meta paced the
  // tile loop at a device-memory round trip a tile.
  auto fetch_meta = [&](int b) {
    if (b >= 0 && b < a.C) {
      const size_t s0 = static_cast<size_t>(b) * a.cap;
      for (int i = tid; i < a.cap / 4; i += kTcThreads) {
        cp_async16(m_sum + 4 * i, a.bsum + s0 + 4 * i);
        cp_async16(m_mag + 4 * i, a.bmag2 + s0 + 4 * i);
        cp_async16(m_row + 4 * i, a.brows + s0 + 4 * i);
        cp_async4(m_valid + 4 * i, a.bvalid + s0 + 4 * i);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto land_meta = [&](int b) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const bool bucket_ok = b >= 0 && b < a.C;
    for (int i = tid; i < a.cap; i += kTcThreads) {
      const bool ok = bucket_ok && m_valid[i] != 0;
      if (!bucket_ok) m_valid[i] = 0;
      m_rr[i] = ok ? rsqrt_spec_dev(m_mag[i]) : 0.0f;
    }
  };

  // select_bins' path where more than kBinList keys share one distance
  // (copies of one row): the keys compacted in place in slot order, the
  // k'-th radix-selected (select_device.cuh, 64-bit keys: exact whatever
  // the slot order), then written as select_bins writes them.
  auto select_radix = [&](int c, int pair) {
    constexpr int kBatch = 4;
    unsigned long long* kb = keys + c * a.cap;
    const unsigned below = (1u << lane) - 1u;
    int n = 0;  // the passing keys, compacted in place in slot order
    for (int i0 = 0; i0 < a.cap; i0 += 32 * kBatch) {
      unsigned long long key[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u + lane;
        key[u] = i < a.cap ? kb[i] : kNoKey;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) warp_append_owned(key[u] != kNoKey, key[u], kb, n);
    }
    __syncwarp();
    unsigned long long lo = kNoKey, hi = 0;
    for (int i = lane; i < n; i += 32) {
      lo = min(lo, kb[i]);
      hi = max(hi, kb[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    // The keys are distinct (a row id a slot), so the bin ends as one key.
    const int shift0 = (63 - __clzll(static_cast<long long>(lo ^ hi))) & ~7;
    RadixBin bin = radix_select<32>(kb, n, a.kp, shift0, 0, hist, scal, nullptr);
    if (shift0 < 56) {  // the bits above the first digit, common to every key
      const unsigned long long common = ~((1ull << (shift0 + 8)) - 1ull);
      bin.prefix |= lo & common;
      bin.mask |= common;
    }
    const size_t o = static_cast<size_t>(pair) * a.kp;
    int w = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const unsigned long long key = i < n ? kb[i] : kNoKey;
      const bool take = i < n && (key & bin.mask) <= bin.prefix;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) {
        const int pos = w + __popc(m & below);
        a.out_d[o + pos] = __uint_as_float(static_cast<unsigned>(key >> 32));
        a.out_i[o + pos] = static_cast<int>(key & 0xffffffffu);
      }
      w += __popc(m);
    }
    __syncwarp();
  };

  // One warp: query column c's k' smallest (dist, row id) keys of the
  // bucket, in slot order, to the output at its pair; (+inf, 2^31 - 1)
  // past them.  The epilogue left the keys (kNoKey where the slot did not
  // pass) and the passing keys' count and range of distance bits
  // (non-negative floats order as their bits).  A 256-bin histogram of
  // (bits - base) >> sh, sh the shift that puts the window's top bit in
  // the digit's (a radix digit aligned to the range, not to 8 bits: the
  // keys spread over the bins), gives the bin of the k'-th and its rank
  // there; while that bin holds more than kBinList keys the window zooms
  // into it.  The bin's keys, a key a lane, are ranked by shuffles for
  // the k'-th key; then the keys up to it are written.  Every pass loads
  // kKeysPerLane keys a lane before it uses any.  Exact: a key below the
  // k'-th's bin is below every key of it.
  auto select_bins = [&](int c, int pair) {
    constexpr int kKeysPerLane = 16;
    constexpr int kChunk = 32 * kKeysPerLane;
    const unsigned long long* kb = keys + c * a.cap;
    const unsigned below = (1u << lane) - 1u;
    auto load = [&](int i0, unsigned long long (&key)[kKeysPerLane]) {
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int i = i0 + 32 * u + lane;
        key[u] = i < a.cap ? kb[i] : kNoKey;
      }
    };
    unsigned long long key[kKeysPerLane];
    int n = 0;
    unsigned lo = 0xffffffffu, hi = 0;
#pragma unroll
    for (int w = 0; w < kProbeWarps; ++w) {
      const int* st = col_stats + (w * NQ + c) * 3;
      n += st[0];
      lo = min(lo, static_cast<unsigned>(st[1]));
      hi = max(hi, static_cast<unsigned>(st[2]));
    }
    // The window [base, base + width) of distance bits (32 bits: they are
    // below 0x7f800000), its digit shift; the k'-th's bin kbin (256: every
    // key) and, unless the whole bin is taken, the k'-th key tau.
    unsigned base = lo, width = hi - lo + 1;
    int sh = max(0, 32 - __clz(width - 1) - 8);
    int kbin = 256;
    bool whole = true;
    unsigned long long tau = kNoKey;
    auto digit = [&](unsigned long long k) {  // -1 outside the window
      const unsigned bits = static_cast<unsigned>(k >> 32);
      return k != kNoKey && bits >= base && bits - base < width ? static_cast<int>((bits - base) >> sh) : -1;
    };
    if (n > a.kp) {
      int r = a.kp;  // the k'-th's rank within the window
      while (true) {
        for (int bb = lane; bb < 256; bb += 32) hist[bb] = 0;
        __syncwarp();
        for (int i0 = 0; i0 < a.cap; i0 += kChunk) {
          load(i0, key);
#pragma unroll
          for (int u = 0; u < kKeysPerLane; ++u) {
            const int dg = digit(key[u]);
            if (dg >= 0) atomicAdd(hist + dg, 1);
          }
        }
        __syncwarp();
        int h[8], local = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          h[j] = hist[8 * lane + j];
          local += h[j];
        }
        int before = team_exclusive_sum<32>(local, nullptr);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (before < r && r <= before + h[j]) {
            scal[0] = 8 * lane + j;
            scal[1] = r - before;  // the k'-th's rank in its bin
            scal[2] = h[j];
          }
          before += h[j];
        }
        __syncwarp();
        kbin = scal[0];
        r = scal[1];
        const int m = scal[2];
        if (r == m) break;  // the whole bin
        if (m <= kBinList) {
          whole = false;
          int cnt = 0;
          for (int i0 = 0; i0 < a.cap; i0 += kChunk) {
            load(i0, key);
#pragma unroll
            for (int u = 0; u < kKeysPerLane; ++u)
              warp_append_owned(digit(key[u]) == kbin, key[u], bin_list, cnt);
          }
          __syncwarp();
          // The keys are distinct (a row id a slot): one has rank r - 1.
          const unsigned long long x = lane < m ? bin_list[lane] : kNoKey;
          int rank = 0;
          for (int y = 0; y < m; ++y) rank += __shfl_sync(0xffffffffu, x, y) < x;
          tau = __shfl_sync(0xffffffffu, x, __ffs(__ballot_sync(0xffffffffu, lane < m && rank == r - 1)) - 1);
          break;
        }
        if (sh == 0) {  // more than kBinList keys of one distance: ties
          select_radix(c, pair);
          return;
        }
        base += static_cast<unsigned>(kbin) << sh;  // zoom into the bin
        width = 1u << sh;
        sh = max(0, sh - 8);
      }
    }
    const size_t o = static_cast<size_t>(pair) * a.kp;
    int w = 0;
    for (int i0 = 0; i0 < a.cap; i0 += kChunk) {
      load(i0, key);
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {  // slot order: u, then the lane
        bool take = key[u] != kNoKey;
        if (take && kbin < 256) {
          const int dg = digit(key[u]);
          take = static_cast<unsigned>(key[u] >> 32) < base || (dg >= 0 && dg < kbin) ||
                 (dg == kbin && (whole || key[u] <= tau));
        }
        const unsigned m = __ballot_sync(0xffffffffu, take);
        if (take) {
          const int pos = w + __popc(m & below);
          a.out_d[o + pos] = __uint_as_float(static_cast<unsigned>(key[u] >> 32));
          a.out_i[o + pos] = static_cast<int>(key[u] & 0xffffffffu);
        }
        w += __popc(m);
      }
    }
    for (int i = w + lane; i < a.kp; i += 32) {
      a.out_d[o + i] = __int_as_float(0x7f800000);
      a.out_i[o + i] = kNoRow;
    }
    __syncwarp();
  };

  // select_bins for an item of one query (column 0), by the whole block:
  // a key a thread a pass, the histogram shared, warp 0 finding the bin
  // and ranking its keys, the write compacted in slot order across the
  // four warps.  One warp alone would hold the item for its select (each
  // item of a probe without a work list, Q = 1 among them).
  auto select_block = [&](int pair) {
    int* bhist = reinterpret_cast<int*>(sm + L.sel);  // warp 0's scratch: bins, scalars, bin keys
    int* bscal = bhist + 256;
    unsigned long long* blist = reinterpret_cast<unsigned long long*>(bscal + 4);
    int* wcnt = bhist + kSelInts;                      // warp 1's: the warps' counts, a counter
    unsigned long long* btau = reinterpret_cast<unsigned long long*>(wcnt + 6);
    const unsigned long long* kb = keys;
    const unsigned below = (1u << lane) - 1u;
    int n = 0;
    unsigned lo = 0xffffffffu, hi = 0;
#pragma unroll
    for (int w = 0; w < kProbeWarps; ++w) {
      const int* st = col_stats + w * NQ * 3;
      n += st[0];
      lo = min(lo, static_cast<unsigned>(st[1]));
      hi = max(hi, static_cast<unsigned>(st[2]));
    }
    unsigned base = lo, width = hi - lo + 1;
    int sh = max(0, 32 - __clz(width - 1) - 8);
    int kbin = 256;
    bool whole = true;
    unsigned long long tau = kNoKey;
    auto digit = [&](unsigned long long k) {  // -1 outside the window
      const unsigned bits = static_cast<unsigned>(k >> 32);
      return k != kNoKey && bits >= base && bits - base < width ? static_cast<int>((bits - base) >> sh) : -1;
    };
    if (n > a.kp) {
      int r = a.kp;
      while (true) {
        for (int bb = tid; bb < 256; bb += kTcThreads) bhist[bb] = 0;
        if (tid == 0) wcnt[4] = 0;
        __syncthreads();
        for (int i0 = 0; i0 < a.cap; i0 += 4 * kTcThreads) {
          unsigned long long key[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kTcThreads + tid;
            key[u] = i < a.cap ? kb[i] : kNoKey;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int dg = digit(key[u]);
            if (dg >= 0) atomicAdd(bhist + dg, 1);
          }
        }
        __syncthreads();
        if (warp == 0) {
          int h[8], local = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            h[j] = bhist[8 * lane + j];
            local += h[j];
          }
          int before = team_exclusive_sum<32>(local, nullptr);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (before < r && r <= before + h[j]) {
              bscal[0] = 8 * lane + j;
              bscal[1] = r - before;
              bscal[2] = h[j];
            }
            before += h[j];
          }
        }
        __syncthreads();
        kbin = bscal[0];
        r = bscal[1];
        const int m = bscal[2];
        if (r == m) break;
        if (m <= kBinList) {
          whole = false;
          for (int i = tid; i < a.cap; i += kTcThreads) {
            const unsigned long long k = kb[i];
            if (digit(k) == kbin) blist[atomicAdd(wcnt + 4, 1)] = k;
          }
          __syncthreads();
          if (warp == 0) {  // the keys are distinct: one has rank r - 1
            const unsigned long long x = lane < m ? blist[lane] : kNoKey;
            int rank = 0;
            for (int y = 0; y < m; ++y) rank += __shfl_sync(0xffffffffu, x, y) < x;
            if (lane < m && rank == r - 1) *btau = x;
          }
          __syncthreads();
          tau = *btau;
          break;
        }
        if (sh == 0) {  // ties: warp 0's radix select
          if (warp == 0) select_radix(0, pair);
          return;
        }
        base += static_cast<unsigned>(kbin) << sh;
        width = 1u << sh;
        sh = max(0, sh - 8);
        __syncthreads();  // the bins are read: the next pass clears them
      }
    }
    const size_t o = static_cast<size_t>(pair) * a.kp;
    int w = 0;
    for (int i0 = 0; i0 < a.cap; i0 += kTcThreads) {  // slot order: a round of 128 slots
      const int i = i0 + tid;
      const unsigned long long key = i < a.cap ? kb[i] : kNoKey;
      bool take = key != kNoKey;
      if (take && kbin < 256) {
        const int dg = digit(key);
        take = static_cast<unsigned>(key >> 32) < base || (dg >= 0 && dg < kbin) ||
               (dg == kbin && (whole || key <= tau));
      }
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (lane == 0) wcnt[warp] = __popc(m);
      __syncthreads();
      int before = w, all = 0;
#pragma unroll
      for (int v = 0; v < kProbeWarps; ++v) {
        before += v < warp ? wcnt[v] : 0;
        all += wcnt[v];
      }
      if (take) {
        const int pos = before + __popc(m & below);
        a.out_d[o + pos] = __uint_as_float(static_cast<unsigned>(key >> 32));
        a.out_i[o + pos] = static_cast<int>(key & 0xffffffffu);
      }
      w += all;
      __syncthreads();  // the counts are read
    }
    for (int i = w + tid; i < a.kp; i += kTcThreads) {
      a.out_d[o + i] = __int_as_float(0x7f800000);
      a.out_i[o + i] = kNoRow;
    }
  };

  // An item's selects: the block where every item has one query (no work
  // list), else a warp a query (where blocks hold many items at once, the
  // block's syncs cost more than one warp's select).
  auto select_item = [&]() {
    if (a.work == nullptr) {
      select_block(item_pairs[0]);
      return;
    }
    for (int c = warp; c < NQ; c += kProbeWarps)
      if (item_pairs[c] >= 0) select_bins(c, item_pairs[c]);
  };

  // This thread's passing keys of its two query columns: their count and
  // distance-bit range, reduced over the column's 8 lanes a warp at the
  // item's end (col_stats) for select_bins.
  int st_n[2];
  unsigned st_lo[2], st_hi[2];
  auto reset_stats = [&]() {
#pragma unroll
    for (int e = 0; e < 2; ++e) st_n[e] = 0, st_lo[e] = 0xffffffffu, st_hi[e] = 0;
  };
  auto publish_stats = [&]() {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        st_n[e] += __shfl_xor_sync(0xffffffffu, st_n[e], o);
        st_lo[e] = min(st_lo[e], __shfl_xor_sync(0xffffffffu, st_lo[e], o));
        st_hi[e] = max(st_hi[e], __shfl_xor_sync(0xffffffffu, st_hi[e], o));
      }
      if (lane < 4) {
        int* st = col_stats + (warp * NQ + 2 * lane + e) * 3;
        st[0] = st_n[e];
        st[1] = static_cast<int>(st_lo[e]);
        st[2] = static_cast<int>(st_hi[e]);
      }
    }
  };

  const uint32_t q_addr = smem_u32(q_tile);
  const float inf = __int_as_float(0x7f800000);
  ItemRegs cur, nxt;
  if (total > 0) {
    fetch_head(0, nxt);
    fetch_body(nxt);
  }
  int acc[NQ / 2];

  for (int g = 0; g < total; ++g) {
    const int jj = g / nt, t = g - jj * nt;
    if (t == 0) {  // a new item: finish the last one's selection, stage the queries
      if constexpr (SELECT) publish_stats();
      __syncthreads();  // the last item's keys, stats and meta are complete
      fetch_meta(nxt.b);  // this item's meta lands under the last one's selects
      if constexpr (SELECT) {
        if (jj > 0) select_item();
        reset_stats();
      }
      __syncthreads();  // the query tile and the keys are free
      cur = nxt;
      if (jj + 1 < n_my) fetch_head(jj + 1, nxt);
      if (tid < units) {
        const int ch = 16 * v_u / cb, u = (16 * v_u % cb) >> 4;
        const int su = cb == 128 ? u ^ (n_u & 7) : u;
        *reinterpret_cast<int4*>(q_tile + (ch * NQ + n_u) * cb + 16 * su) = cur.code;
      }
      if (warp == 0 && lane < 4) {
        item_pairs[2 * lane] = cur.pair_c[0];
        item_pairs[2 * lane + 1] = cur.pair_c[1];
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the query tile -> wgmma
      land_meta(cur.b);
      __syncthreads();
    }
    if (t == nt - 1 && jj + 1 < n_my) fetch_body(nxt);
    int m_rsum[2], m_mag2[2], m_id[2];
    bool m_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = min(t * kTileRows + r0 + 8 * h, a.cap - 1);
      m_ok[h] = t * kTileRows + r0 + 8 * h < a.cap && m_valid[slot] != 0;
      m_rsum[h] = m_sum[slot];
      m_mag2[h] = m_mag[slot];
      m_id[h] = m_row[slot];
    }
    const int s = g % kProbeStages;
    mbar_wait(full + s, (g / kProbeStages) & 1);
    tile_product<NQ, KIND>(acc, rows + s * kTileRows * rb, r0, tq, q_addr, a.D);
    wgmma_wait0();
    fence_regs(acc);
    // The exact centered dots, branch-free: the only read of the accumulators.
    int dc[NQ / 2];
#pragma unroll
    for (int p = 0; p < NQ / 2; ++p)
      dc[p] = centered_dot<KIND>(acc[p], cur.qs[p & 1], m_rsum[(p >> 1) & 1], a.D);
    __syncthreads();  // every warp's product has read the slot: refill it
    if (tid == 0 && g + kProbeStages < total) issue(g + kProbeStages);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = t * kTileRows + r0 + 8 * h;
      if (slot >= a.cap) continue;
      const float rr = m_rr[slot];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * tq + e;
        if (cur.pair_c[e] < 0) continue;
        float dist = inf;
        bool pass = false;
        if (m_ok[h]) {
          dist = spec_dist(dc[2 * h + e], cur.qr[e], rr, cur.qm[e], __int2float_rn(m_mag2[h]));
          pass = dist < a.md;
        }
        if constexpr (SELECT) {
          keys[c * a.cap + slot] = pass ? make_key(dist, m_id[h]) : kNoKey;
          if (pass) {
            const unsigned bits = __float_as_uint(dist);
            ++st_n[e];
            st_lo[e] = min(st_lo[e], bits);
            st_hi[e] = max(st_hi[e], bits);
          }
        } else {
          const size_t o = static_cast<size_t>(cur.pair_c[e]) * a.cap + slot;
          a.out_d[o] = pass ? dist : inf;
          a.out_i[o] = pass ? m_id[h] : kNoRow;
        }
      }
    }
  }
  if constexpr (SELECT) {
    if (total > 0) {
      publish_stats();
      __syncthreads();
      select_item();
    }
  }
}

template <int KIND, bool SELECT>
int launch_probe(const CUtensorMap& rows, const ProbeArgs& a, cudaStream_t stream) {
  const size_t smem = ProbeSmem(KIND, a.D, a.cap, SELECT).total + 1024;
  int grid = 0;
  const int rc = persistent_grid(ivf_probe_tc_kernel<KIND, SELECT>, smem, a.M, &grid);
  if (rc != 0) return rc;
  ivf_probe_tc_kernel<KIND, SELECT><<<grid, kTcThreads, smem, stream>>>(rows, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- The first port's probe and the gathered mode

template <int KIND>
__global__ void __launch_bounds__(kThreads)
ivf_probe_dp4a_kernel(const int8_t* __restrict__ q_codes, const int* __restrict__ q_sum,
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

// The work list of a probe: bids int32 [M] (M = Q · P pairs, pair j = q · P
// + p) over C buckets into work int32 [1 + M · (1 + kProbeNQ)]: work[0] the
// items, then per item its bucket (-1: ids outside [0, C)) and its pair ids
// (-1 past them), grouped by bucket in bucket order.  scratch (may be
// null up to 16,383 buckets): int32 [2 (C + 1)].
PX_EXPORT int px_ivf_invert(const void* bids, int M, int C, void* scratch, void* work, void* stream) {
  if (M < 1 || C < 1 || C > (1 << 30) || (scratch == nullptr && C + 1 > kInvertSmemBuckets))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = allow_smem(ivf_invert_kernel);
  if (rc != 0) return rc;
  ivf_invert_kernel<<<1, kInvertThreads, optin, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bids), M, C, static_cast<int*>(scratch), static_cast<int*>(work),
      optin / static_cast<int>(sizeof(int)));
  return static_cast<int>(cudaGetLastError());
}

// K5 on the tensor cores: kind 0 (int8 buckets [C, cap, D], D = 32, 64 or
// 128) or 1 (packed int4 buckets [C, cap, 64], D = 128: cosine4a), u8
// queries [Q, D] (16-byte aligned); bids int32 [Q, P]; work the inverted
// list (px_ivf_invert) or null (each pair its own item: Q = 1);
// bucket_sum / mag2 / rows int32 and bucket_valid uint8 [C, cap] (cap a
// multiple of 4 up to 8,192; each 16-byte aligned); per
// (q, p) the kp smallest (dist, row id) in slot order, into [Q, P, kp] (kp
// < cap, cap <= 2,048), or every slot (kp = cap).
PX_EXPORT int px_ivf_probe_topk(const void* q_codes, const void* q_sum, const void* q_mag2,
                                const void* qr, float md, const void* bids, const void* work,
                                const void* bdata, const void* bsum, const void* bmag2,
                                const void* brows, const void* bvalid, int Q, int P, int C, int cap,
                                int D, int kind, int kp, void* out_d, void* out_i, void* stream) {
  const bool width_ok = kind == kU8 ? (D == 32 || D == 64 || D == 128) : kind == kInt4Asym && D == kDim4;
  const bool select = kp < cap;
  if (!width_ok || Q < 0 || P < 1 || C < 1 || cap < 4 || cap % 4 || cap > kTcMaxCap || kp < 1 || kp > cap ||
      (select && cap > kSelectMaxCap) || 4 * (static_cast<long long>(C) * cap + kTileRows) >= (1ll << 31) ||
      static_cast<long long>(Q) * P >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const int rb = probe_row_bytes(kind, D);
  const int cb = kind == kU8 ? row_chunk(D) : rb;
  const CUtensorMapSwizzle sw = kind == kU8 && cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                         : CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap rows;
  const int rc = encode_map(&rows, 2, bdata, rb, static_cast<uint64_t>(C) * cap, rb, cb, kTileRows, sw);
  if (rc != 0) return rc;
  ProbeArgs a{};
  a.q_codes = static_cast<const int8_t*>(q_codes);
  a.q_sum = static_cast<const int*>(q_sum);
  a.q_mag2 = static_cast<const int*>(q_mag2);
  a.qr = static_cast<const float*>(qr);
  a.md = md;
  a.bids = static_cast<const int*>(bids);
  a.work = static_cast<const int*>(work);
  a.bsum = static_cast<const int*>(bsum);
  a.bmag2 = static_cast<const int*>(bmag2);
  a.brows = static_cast<const int*>(brows);
  a.bvalid = static_cast<const uint8_t*>(bvalid);
  a.M = Q * P;
  a.P = P;
  a.C = C;
  a.cap = cap;
  a.D = D;
  a.kp = kp;
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kU8) return select ? launch_probe<kU8, true>(rows, a, st) : launch_probe<kU8, false>(rows, a, st);
  return select ? launch_probe<kInt4Asym, true>(rows, a, st) : launch_probe<kInt4Asym, false>(rows, a, st);
}

// The first port's K5: kind 0 (int8 buckets [C, cap, D], u8 queries) or 1
// (packed int4 buckets [C, cap, D/2], u8 queries: cosine4a).  bids int32
// [Q, P]; bucket_valid uint8 [C, cap]; out [Q, P * cap], every slot.
PX_EXPORT int px_ivf_probe_collect_dp4a(const void* q_codes, const void* q_sum, const void* q_mag2,
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
    ivf_probe_dp4a_kernel<kU8><<<grid, kThreads, smem, st>>>(PX_IVF_ARGS);
  else
    ivf_probe_dp4a_kernel<kInt4Asym><<<grid, kThreads, smem, st>>>(PX_IVF_ARGS);
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
