// Host-side exact MIPS top-k scan (C++ core of the spill index).
//
// Role: when a passage corpus exceeds the device's memory budget, the
// overflow rows live in host RAM (optionally memory-mapped) and are scanned
// here — the CPU analogue of the device's top-k kernel
// (dalm_tpu_torch/kernels/topk.py, csrc/topk.cu). An exact scan: no graph
// build time, no recall loss, predictable memory. A copy of
// dalm_tpu/native/host_topk.cpp, which the JAX package builds apart.
//
// Design: queries x embeddings processed in row blocks for cache
// locality; per (thread, query) running top-k kept in a small binary
// min-heap keyed on score (ties -> larger id treated as smaller priority
// so smaller ids win, matching the device kernel); per-thread partials
// merged at the end. OpenMP across embedding blocks.
//
// Build: at first use by dalm_tpu_torch/index/host_index.py, with g++
// -O3 -march=native -fopenmp, into build/dalm_tpu_torch/host_topk-<hash>/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Hit {
  float score;
  int32_t id;
};

// Min-heap order on (score, -id): root = worst kept hit.
inline bool worse(const Hit& a, const Hit& b) {
  if (a.score != b.score) return a.score < b.score;
  return a.id > b.id;
}

class TopK {
 public:
  explicit TopK(int64_t k) : k_(k) { heap_.reserve(k); }

  inline void offer(float score, int32_t id) {
    if (static_cast<int64_t>(heap_.size()) < k_) {
      heap_.push_back({score, id});
      std::push_heap(heap_.begin(), heap_.end(),
                     [](const Hit& a, const Hit& b) { return worse(b, a); });
    } else if (worse(heap_.front(), {score, id})) {
      std::pop_heap(heap_.begin(), heap_.end(),
                    [](const Hit& a, const Hit& b) { return worse(b, a); });
      heap_.back() = {score, id};
      std::push_heap(heap_.begin(), heap_.end(),
                     [](const Hit& a, const Hit& b) { return worse(b, a); });
    }
  }

  void merge(const TopK& other) {
    for (const Hit& h : other.heap_) offer(h.score, h.id);
  }

  // Emit best-first into out arrays (padded with -inf/0 if < k hits).
  void emit(float* out_scores, int32_t* out_ids) {
    std::vector<Hit> sorted = heap_;
    std::sort(sorted.begin(), sorted.end(),
              [](const Hit& a, const Hit& b) { return worse(b, a); });
    int64_t i = 0;
    for (; i < static_cast<int64_t>(sorted.size()); ++i) {
      out_scores[i] = sorted[i].score;
      out_ids[i] = sorted[i].id;
    }
    for (; i < k_; ++i) {
      out_scores[i] = -3.4028235e38f;
      out_ids[i] = 0;
    }
  }

 private:
  int64_t k_;
  std::vector<Hit> heap_;
};

}  // namespace

extern "C" {

// Exact top-k inner-product search.
//   embs:    (n, d) row-major float32
//   queries: (nq, d) row-major float32
//   out_scores: (nq, k), out_ids: (nq, k)
void dalm_host_topk(const float* embs, int64_t n, int64_t d,
                    const float* queries, int64_t nq, int64_t k,
                    float* out_scores, int32_t* out_ids) {
  const int64_t BLOCK = 4096;
  int num_threads = 1;
#ifdef _OPENMP
  num_threads = omp_get_max_threads();
#endif
  const int64_t num_blocks = (n + BLOCK - 1) / BLOCK;

  // partials[t * nq + q]
  std::vector<std::vector<TopK>> partials;
  partials.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    std::vector<TopK> row;
    row.reserve(nq);
    for (int64_t q = 0; q < nq; ++q) row.emplace_back(k);
    partials.push_back(std::move(row));
  }

#pragma omp parallel for schedule(dynamic)
  for (int64_t b = 0; b < num_blocks; ++b) {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    const int64_t row_start = b * BLOCK;
    const int64_t row_end = std::min(row_start + BLOCK, n);
    for (int64_t q = 0; q < nq; ++q) {
      const float* qv = queries + q * d;
      TopK& topk = partials[tid][q];
      for (int64_t r = row_start; r < row_end; ++r) {
        const float* ev = embs + r * d;
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
        int64_t i = 0;
        for (; i + 4 <= d; i += 4) {  // unrolled; g++ vectorizes further
          acc0 += qv[i] * ev[i];
          acc1 += qv[i + 1] * ev[i + 1];
          acc2 += qv[i + 2] * ev[i + 2];
          acc3 += qv[i + 3] * ev[i + 3];
        }
        float acc = acc0 + acc1 + acc2 + acc3;
        for (; i < d; ++i) acc += qv[i] * ev[i];
        topk.offer(acc, static_cast<int32_t>(r));
      }
    }
  }

  for (int64_t q = 0; q < nq; ++q) {
    TopK merged(k);
    for (int t = 0; t < num_threads; ++t) merged.merge(partials[t][q]);
    merged.emit(out_scores + q * k, out_ids + q * k);
  }
}

}  // extern "C"
