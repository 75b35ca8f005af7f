// The port's copy of igneous_tpu/native/csrc/dijkstra.cpp (the same code).
//
// Incremental multi-source Dijkstra over a CSR graph.
//
// TEASAR's fix_branching regrows a shortest-path forest from the whole
// current tree before every traced path (ops/skeletonize.py; reference
// behavior: kimimaro's fix_branching). A full recompute per path is
// O(E log V) every time — but adding sources S to an existing field only
// improves distances in the region closer to S than to the old tree, so
// seeding the heap with S against the WARM field relaxes exactly that
// region. The result equals a cold multi-source run from (old sources ∪
// S): both compute, per node, min over sources of the penalized path
// cost.
//
// dist/pred are caller-owned arrays persisted across calls:
//   igdij_update(n, indptr, indices, weights, dist, pred, sources, nsrc)
// Initial call: dist pre-filled with +inf, pred with -1, sources={root}.
// Deterministic: the heap orders by (distance, node id).
//
// Exposed as a C ABI for the ctypes loader in ops/skeletonize.py.

#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

int igdij_update(
    int64_t n,
    const int64_t* indptr,      // n+1
    const int32_t* indices,     // nnz
    const double* weights,      // nnz
    double* dist,               // n, in/out
    int32_t* pred,              // n, in/out
    const int64_t* sources, int64_t nsrc) {
  using QE = std::pair<double, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  for (int64_t i = 0; i < nsrc; i++) {
    int64_t s = sources[i];
    if (s < 0 || s >= n) return 1;
    if (dist[s] > 0.0) {
      dist[s] = 0.0;
      pred[s] = -1;
    }
    heap.push({0.0, (int32_t)s});
  }
  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    if (d > dist[u]) continue;  // stale entry
    for (int64_t e = indptr[u]; e < indptr[u + 1]; e++) {
      int32_t v = indices[e];
      double nd = d + weights[e];
      if (nd < dist[v]) {
        dist[v] = nd;
        pred[v] = u;
        heap.push({nd, v});
      }
    }
  }
  return 0;
}

}  // extern "C"
