// Multithreaded CPU brute-force cosine scan — native host fallback/oracle.
//
// The exact-integer formulation matches pixelbox_tpu.ops.oracle (and thus
// the TPU scan): centered values c = 2*q - 255, int64 dot/magnitudes, f32
// finals, reciprocal cosine distance (reference src/engine.rs:572-588),
// strict dist < max_distance filter, ascending sort with ties broken by
// row index (engine.rs:375-383).  Used for large-N parity testing where a
// Python oracle would be too slow, and as a host-only query fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Cand {
  float dist;
  int32_t idx;
};

inline bool cand_less(const Cand& a, const Cand& b) {
  if (a.dist != b.dist) return a.dist < b.dist;
  return a.idx < b.idx;
}

void scan_one_query(const uint8_t* db, int64_t n, int64_t d,
                    const uint8_t* query, int32_t k, float max_distance,
                    int n_threads, float* out_dist, int32_t* out_idx) {
  std::vector<int64_t> cq(d);
  int64_t mag2_q = 0;
  for (int64_t j = 0; j < d; ++j) {
    cq[j] = 2 * int64_t(query[j]) - 255;
    mag2_q += cq[j] * cq[j];
  }
  // Canonical spec v2 (ops/distances.py rsqrt_spec): fl(1/fl(sqrt(m2))),
  // both ops correctly rounded here and in numpy/XLA:CPU.
  const float rq = mag2_q > 0 ? 1.0f / std::sqrt(float(mag2_q)) : 0.0f;
  const bool q_zero = mag2_q == 0;

  std::vector<std::vector<Cand>> partials(n_threads);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<Cand>& heap = partials[t];  // max-heap of k best
      const int64_t lo = n * t / n_threads;
      const int64_t hi = n * (t + 1) / n_threads;
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* row = db + i * d;
        int64_t dot = 0, mag2_r = 0;
        for (int64_t j = 0; j < d; ++j) {
          int64_t cr = 2 * int64_t(row[j]) - 255;
          dot += cq[j] * cr;
          mag2_r += cr * cr;
        }
        // Canonical rounding spec v2 (separable magnitudes) — matches
        // ops.distances._cosine_distance_from_moments and the oracle:
        // inv = fl(rq*rr); cos = fl(dot*inv); dist = fl(1/max(cos,1e-6))-1.
        // Integer moments make the reference's mag<1e-6 guard exactly
        // "either magnitude is zero" (engine.rs:582-584).
        float dist;
        const float dot_f = float(dot);
        const float m2r_f = float(mag2_r);
        if (q_zero || mag2_r == 0 ||
            (dot_f == float(mag2_q) && float(mag2_q) == m2r_f)) {
          // Zero-magnitude guard + identical-vector pin (spec guards).
          dist = 0.0f;
        } else {
          const float rr = 1.0f / std::sqrt(m2r_f);
          const float inv = rq * rr;
          const float cos = dot_f * inv;
          dist = std::max(1.0f / std::max(cos, 1e-6f) - 1.0f, 0.0f);
        }
        if (!(dist < max_distance)) continue;
        Cand c{dist, int32_t(i)};
        if (int32_t(heap.size()) < k) {
          heap.push_back(c);
          std::push_heap(heap.begin(), heap.end(), cand_less);
        } else if (k > 0 && cand_less(c, heap.front())) {
          std::pop_heap(heap.begin(), heap.end(), cand_less);
          heap.back() = c;
          std::push_heap(heap.begin(), heap.end(), cand_less);
        }
      }
    });
  }
  for (auto& th : threads) th.join();

  std::vector<Cand> all;
  for (auto& p : partials) all.insert(all.end(), p.begin(), p.end());
  std::sort(all.begin(), all.end(), cand_less);
  for (int32_t j = 0; j < k; ++j) {
    if (j < int32_t(all.size())) {
      out_dist[j] = all[j].dist;
      out_idx[j] = all[j].idx;
    } else {
      out_dist[j] = INFINITY;
      out_idx[j] = -1;
    }
  }
}

}  // namespace

extern "C" {

// db: [n, d] u8 row-major; queries: [q, d]; outputs [q, k].
void cpu_cosine_scan_topk(const uint8_t* db, int64_t n, int64_t d,
                          const uint8_t* queries, int64_t q, int32_t k,
                          float max_distance, int32_t n_threads,
                          float* out_dist, int32_t* out_idx) {
  if (n_threads < 1) n_threads = 1;
  for (int64_t qi = 0; qi < q; ++qi) {
    scan_one_query(db, n, d, queries + qi * d, k, max_distance, n_threads,
                   out_dist + qi * k, out_idx + qi * k);
  }
}

}  // extern "C"
