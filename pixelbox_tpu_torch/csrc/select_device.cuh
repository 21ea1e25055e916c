// The (dist, id) top-k select, shared by K1c's select kernel
// (lex_topk_select_kernel in fused_scan.cu: a block of 256 threads a
// query) and the tensor-core chunk top-k (tc_chunk_topk_kernel in
// tc_scan.cu: one warp a query): the warp-ballot append of keys to shared
// memory, the MSB-first radix select of the k-th smallest 64-bit key, and
// (K1c) the bitonic sort of a power-of-two run of keys.
//
// A "team" is the threads that select together: the whole block (kTeam =
// blockDim.x, a multiple of 32 up to 256) or one warp (kTeam = 32).  Keys
// are make_key's (dist bits, row id) or any other unsigned 64-bit order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int kTeam>
__device__ __forceinline__ int team_rank() {
  return kTeam == 32 ? static_cast<int>(threadIdx.x & 31) : static_cast<int>(threadIdx.x);
}

template <int kTeam>
__device__ __forceinline__ void team_sync() {
  if constexpr (kTeam == 32) __syncwarp();
  else __syncthreads();
}

// Appends the key of every lane whose `ok` is set to dst at a slot from
// the counter *n (one shared atomic a warp; every lane calls).  Within the
// warp the keys keep their lane order.
__device__ __forceinline__ void warp_append(bool ok, unsigned long long key,
                                            unsigned long long* dst, int* n) {
  const unsigned m = __ballot_sync(0xffffffffu, ok);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (ok) dst[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// warp_append for a buffer one warp owns: the count is the warp's own
// (uniform) register, so no atomic is needed.
__device__ __forceinline__ void warp_append_owned(bool ok, unsigned long long key,
                                                  unsigned long long* dst, int& n) {
  const unsigned m = __ballot_sync(0xffffffffu, ok);
  if (ok) dst[n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = key;
  n += __popc(m);
}

// Ascending bitonic sort of keys[0:n], n a power of two (no divides).
template <int kTeam>
__device__ void bitonic_sort_pow2(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = team_rank<kTeam>(); t < n / 2; t += kTeam) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i];
        const unsigned long long b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      team_sync<kTeam>();
    }
  }
}

// Exclusive sum of v over the team; a block team passes kTeam / 32 ints
// of shared memory (warp_sums), a warp team none.
template <int kTeam>
__device__ __forceinline__ int team_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if constexpr (kTeam == 32) {
    return x - v;
  } else {
    const int w = threadIdx.x >> 5;
    if (lane == 31) warp_sums[w] = x;
    __syncthreads();
    int before = x - v;
    for (int i = 0; i < w; ++i) before += warp_sums[i];
    return before;
  }
}

// The bin of the k-th smallest key: the top k are the keys with (key &
// mask) < prefix, then every key of the bin when whole_bin, else `rank`
// of the bin's keys (every key of it when all 64 bits are decided: the
// bin's one key value, repeated).
struct RadixBin {
  unsigned long long prefix, mask;
  int rank;
  bool whole_bin;
};

// Radix select of the k-th smallest of keys[0:n] (1 <= k < n), MSB first,
// 8-bit digits from bit `shift0` down to bit `shift_end` (the keys agree
// above shift0 + 8): each pass histograms, over 256 shared bins, the digit
// of the keys whose higher digits match the prefix found so far, and finds
// the bin holding the rank-th; a tie plateau carries it into the low bits.
// It stops once that bin holds exactly the rest.  A member reads kBatch
// keys a pass step, all loads first, and each key adds alone (aggregating
// a warp's equal digits by __match_any_sync cost more than it saved, for
// every kernel that selects).  hist: 256 ints; scal: 3 ints; warp_sums: as
// team_exclusive_sum.
template <int kTeam>
__device__ RadixBin radix_select(const unsigned long long* keys, int n, int k, int shift0,
                                 int shift_end, int* hist, int* scal, int* warp_sums) {
  constexpr int kBins = 256 / kTeam;  // the bins a member sums
  constexpr int kBatch = 4;
  const int r = team_rank<kTeam>();
  unsigned long long prefix = 0, mask = 0;
  int rank = k;
  bool whole_bin = true;
  for (int shift = shift0; shift >= shift_end; shift -= 8) {
    for (int b = r; b < 256; b += kTeam) hist[b] = 0;
    team_sync<kTeam>();
    for (int i0 = r; i0 < n + r; i0 += kTeam * kBatch) {  // i0 - r: uniform over the team
      int digit[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kTeam;
        digit[u] = -1;
        if (i < n) {
          const unsigned long long key = keys[i];
          if ((key & mask) == prefix) digit[u] = static_cast<int>(key >> shift) & 255;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (digit[u] >= 0) atomicAdd(hist + digit[u], 1);
      }
    }
    team_sync<kTeam>();
    int h[kBins], local = 0;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      h[b] = hist[r * kBins + b];
      local += h[b];
    }
    int before = team_exclusive_sum<kTeam>(local, warp_sums);
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      if (before < rank && rank <= before + h[b]) {
        scal[0] = r * kBins + b;
        scal[1] = before;
        scal[2] = h[b];
      }
      before += h[b];
    }
    team_sync<kTeam>();
    rank -= scal[1];
    prefix |= static_cast<unsigned long long>(scal[0]) << shift;
    mask |= 0xffull << shift;
    whole_bin = scal[2] == rank;
    if (whole_bin) break;
  }
  return RadixBin{prefix, mask, rank, whole_bin};
}

}  // namespace
