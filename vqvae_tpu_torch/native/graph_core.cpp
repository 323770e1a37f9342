// Native host graph kernels for vqvae_tpu_torch: the PyTorch port's own
// copy of vqvae_tpu/native/graph_core.cpp (same functions, same results),
// so the port imports nothing from the JAX package.
//
// The reference delegates its host-side hot loops to third-party native
// code: scipy.sparse.csgraph.dijkstra (Cython), sklearn NearestNeighbors
// and FAISS (C++) — reference src/geo/geo_shortest_paths.py:9,
// knn_graph_optimized.py:14-22. This library is the first-party
// replacement: multi-source Dijkstra over CSR with a binary heap
// (threaded across sources, optionally with predecessors), union-find
// connected components, the one-pass CSR / ELL assemblies and blocked
// exact kNN. The device path (ops/) remains primary for large graphs;
// this is the small-graph fast path and the host oracle.
//
// Build (vqvae_tpu_torch/native/__init__.py does this at first use):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//       graph_core.cpp -o libgraph_core-<hash>.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// scipy.sparse.csgraph uses -9999 for "no predecessor"
constexpr int32_t kNoPred = -9999;

void dijkstra_one(const int64_t* indptr, const int32_t* indices,
                  const float* weights, int64_t n, int32_t source,
                  float* dist, int32_t* pred /* nullable */) {
  std::fill(dist, dist + n, kInf);
  if (pred != nullptr) std::fill(pred, pred + n, kNoPred);
  using Item = std::pair<float, int32_t>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
  dist[source] = 0.0f;
  heap.emplace(0.0f, source);
  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    if (d > dist[u]) continue;  // stale entry
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int32_t v = indices[e];
      float nd = d + weights[e];
      if (nd < dist[v]) {
        dist[v] = nd;
        if (pred != nullptr) pred[v] = u;
        heap.emplace(nd, v);
      }
    }
  }
}

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(int64_t n) : parent(n) {
    for (int64_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;  // min-label roots
  }
};

void run_threaded(int64_t count, int threads,
                  const std::function<void(int64_t)>& fn) {
  if (threads <= 1 || count <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int n_threads = std::min<int64_t>(threads, count);
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < count; i = next.fetch_add(1)) {
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Multi-source shortest paths over an undirected CSR graph.
// out has shape (k, n) row-major. Threaded across sources.
void vq_dijkstra_multi_source(const int64_t* indptr, const int32_t* indices,
                              const float* weights, int64_t n,
                              const int32_t* sources, int64_t k,
                              float* out, int threads) {
  run_threaded(k, threads, [&](int64_t s) {
    dijkstra_one(indptr, indices, weights, n, sources[s], out + s * n,
                 nullptr);
  });
}

// As above, also filling predecessors (k, n) int32 with scipy's -9999
// sentinel for source/unreachable nodes.
void vq_dijkstra_multi_source_pred(const int64_t* indptr,
                                   const int32_t* indices,
                                   const float* weights, int64_t n,
                                   const int32_t* sources, int64_t k,
                                   float* out, int32_t* pred, int threads) {
  run_threaded(k, threads, [&](int64_t s) {
    dijkstra_one(indptr, indices, weights, n, sources[s], out + s * n,
                 pred + s * n);
  });
}

// Connected components; labels[i] = min node index in i's component.
// Returns the number of components.
int64_t vq_connected_components(const int64_t* indptr, const int32_t* indices,
                                int64_t n, int32_t* labels) {
  UnionFind uf(n);
  for (int64_t u = 0; u < n; ++u) {
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      uf.unite(static_cast<int32_t>(u), indices[e]);
    }
  }
  int64_t n_components = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t r = uf.find(static_cast<int32_t>(i));
    labels[i] = r;
    if (r == i) ++n_components;
  }
  return n_components;
}

// Fill one degree bucket of the ELL (degree-bucketed) relaxation layout
// (ops/ell.py BucketedGraph): for each of n_rows real rows copy its
// dst-sorted in-edges (row ids + weights) into a dense (n_pad, cap) pair of
// matrices, padding unused slots with (0, +inf); rows >= n_rows are dummy
// alignment rows. One threaded pass in place of a multi-pass numpy
// assembly.
void vq_ell_fill_bucket(const int32_t* src_rows, const float* w,
                        const int64_t* starts, const int64_t* counts,
                        int64_t n_rows, int64_t n_pad, int64_t cap,
                        int32_t* nb, float* wb, int threads) {
  const int64_t block = 4096;  // rows per work item (amortize dispatch)
  const int64_t n_blocks = (n_pad + block - 1) / block;
  run_threaded(n_blocks, threads, [&](int64_t b) {
    const int64_t lo = b * block, hi = std::min(n_pad, lo + block);
    for (int64_t r = lo; r < hi; ++r) {
      int32_t* nbr = nb + r * cap;
      float* wbr = wb + r * cap;
      int64_t c = 0;
      if (r < n_rows) {
        const int64_t s = starts[r];
        c = std::min(counts[r], cap);
        std::memcpy(nbr, src_rows + s, c * sizeof(int32_t));
        std::memcpy(wbr, w + s, c * sizeof(float));
      }
      for (int64_t j = c; j < cap; ++j) {
        nbr[j] = 0;
        wbr[j] = kInf;
      }
    }
  });
}

// Assemble the symmetrized kNN CSR adjacency directly from the search
// result (idx (n,k) int64, dist (n,k) f32) — replaces the scipy
// coo->csr + maximum/minimum(W.T) + setdiag + eliminate_zeros chain
// (ops/graph.py:_assemble) in one pass. Semantics match scipy exactly:
//   union  -> elementwise max with the transpose (missing = 0)
//   mutual -> elementwise min with the transpose (edge survives only if
//             present in BOTH directed lists)
//   self edges (i==j) and zero weights are dropped (setdiag(0) +
//   eliminate_zeros); negative idx entries are treated as padding.
// Each directed edge appears at most once per row (top-k indices are
// unique), so a (i,j) pair occurs 1 or 2 times in the doubled list.
// out_cols/out_w must have capacity 2*n*k; indptr has n+1 slots.
// Returns nnz.
int64_t vq_knn_assemble(const int64_t* idx, const float* dist, int64_t n,
                        int64_t k, int mode_distance, int sym_mutual,
                        int64_t* indptr, int32_t* out_cols, float* out_w,
                        int threads) {
  // pass 1: per-row entry counts of the doubled (edge + transpose) list
  std::vector<int64_t> off(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t e = 0; e < k; ++e) {
      const int64_t j = idx[i * k + e];
      if (j < 0 || j == i) continue;
      ++off[i + 1];
      ++off[j + 1];
    }
  }
  for (int64_t i = 0; i < n; ++i) off[i + 1] += off[i];
  const int64_t m = off[n];

  // pass 2: scatter (col, weight) into per-row segments. The transposed
  // half of the writes hits random rows, so keep col+weight interleaved
  // in ONE struct array — one random cache line per entry, not two.
  struct Entry {
    int32_t col;
    float w;
  };
  std::vector<Entry> tmp(m);
  std::vector<int64_t> cur(off.begin(), off.begin() + n);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t e = 0; e < k; ++e) {
      const int64_t j = idx[i * k + e];
      if (j < 0 || j == i) continue;
      const float w = mode_distance ? dist[i * k + e] : 1.0f;
      tmp[cur[i]++] = {static_cast<int32_t>(j), w};
      tmp[cur[j]++] = {static_cast<int32_t>(i), w};
    }
  }

  // pass 3: per-row sort + dedupe (threaded over row blocks), compacting
  // each segment in place and recording the surviving length
  std::vector<int64_t> row_len(n, 0);
  const int64_t block = 4096;
  const int64_t n_blocks = (n + block - 1) / block;
  run_threaded(n_blocks, threads, [&](int64_t b) {
    const int64_t lo = b * block, hi = std::min(n, lo + block);
    for (int64_t r = lo; r < hi; ++r) {
      const int64_t s = off[r], len = off[r + 1] - s;
      Entry* seg = tmp.data() + s;
      std::sort(seg, seg + len,
                [](const Entry& a, const Entry& b) { return a.col < b.col; });
      int64_t w_at = 0;
      for (int64_t t = 0; t < len;) {
        int64_t u = t + 1;
        float wmin = seg[t].w, wmax = seg[t].w;
        while (u < len && seg[u].col == seg[t].col) {
          wmin = std::min(wmin, seg[u].w);
          wmax = std::max(wmax, seg[u].w);
          ++u;
        }
        const bool both_ways = (u - t) >= 2;
        const float w = sym_mutual ? wmin : wmax;
        if ((!sym_mutual || both_ways) && w != 0.0f) {
          seg[w_at++] = {seg[t].col, w};
        }
        t = u;
      }
      row_len[r] = w_at;
    }
  });

  // pass 4: final indptr + compact split copy into the output arrays
  indptr[0] = 0;
  for (int64_t r = 0; r < n; ++r) indptr[r + 1] = indptr[r] + row_len[r];
  run_threaded(n_blocks, threads, [&](int64_t b) {
    const int64_t lo = b * block, hi = std::min(n, lo + block);
    for (int64_t r = lo; r < hi; ++r) {
      const Entry* seg = tmp.data() + off[r];
      int32_t* oc = out_cols + indptr[r];
      float* ow = out_w + indptr[r];
      for (int64_t t = 0; t < row_len[r]; ++t) {
        oc[t] = seg[t].col;
        ow[t] = seg[t].w;
      }
    }
  });
  return indptr[n];
}

// Assemble a symmetric CSR from a unique undirected edge list (rows[i],
// cols[i], w[i]) — each pair emitted in both directions, per-row sorted by
// column. Replaces the scipy `csr_matrix((w, (r, c))) ; W + W.T` chain in
// the codebook builders. Assumes the pairs are unique and self-loop-free (the builders
// hand in the r < c half of a symmetric graph), so nnz is exactly 2 * e.
int64_t vq_edges_assemble(const int64_t* rows, const int64_t* cols,
                          const float* w, int64_t e, int64_t n,
                          int64_t* indptr, int32_t* out_cols, float* out_w,
                          int threads) {
  // pass 1: per-row counts of the doubled list
  std::vector<int64_t> off(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    ++off[rows[i] + 1];
    ++off[cols[i] + 1];
  }
  for (int64_t i = 0; i < n; ++i) off[i + 1] += off[i];

  // pass 2: scatter both directions (interleaved col+weight: one random
  // cache line per entry — same layout rationale as vq_knn_assemble)
  struct Entry {
    int32_t col;
    float w;
  };
  std::vector<Entry> tmp(off[n]);
  std::vector<int64_t> cur(off.begin(), off.begin() + n);
  for (int64_t i = 0; i < e; ++i) {
    tmp[cur[rows[i]]++] = {static_cast<int32_t>(cols[i]), w[i]};
    tmp[cur[cols[i]]++] = {static_cast<int32_t>(rows[i]), w[i]};
  }

  // pass 3: per-row column sort + copy out (threaded over row blocks);
  // scipy consumers expect sorted indices within each row
  const int64_t block = 4096;
  const int64_t n_blocks = (n + block - 1) / block;
  run_threaded(n_blocks, threads, [&](int64_t b) {
    const int64_t lo = b * block, hi = std::min(n, lo + block);
    for (int64_t r = lo; r < hi; ++r) {
      Entry* seg = tmp.data() + off[r];
      const int64_t len = off[r + 1] - off[r];
      std::sort(seg, seg + len,
                [](const Entry& a, const Entry& b) { return a.col < b.col; });
      int32_t* oc = out_cols + off[r];
      float* ow = out_w + off[r];
      for (int64_t t = 0; t < len; ++t) {
        oc[t] = seg[t].col;
        ow[t] = seg[t].w;
      }
    }
  });
  std::memcpy(indptr, off.data(), (n + 1) * sizeof(int64_t));
  return off[n];
}

// Exact kNN (euclidean), blocked over queries, threaded. Self-matches are
// included (distance 0), mirroring the device kernel's contract.
// dists/idx have shape (n, k) row-major.
void vq_knn_exact(const float* z, int64_t n, int64_t d, int64_t k,
                  float* dists, int64_t* idx, int threads) {
  const int64_t kk = std::min(k, n);
  run_threaded(n, threads, [&](int64_t i) {
    const float* qi = z + i * d;
    thread_local std::vector<std::pair<float, int64_t>> cand;
    cand.resize(n);
    for (int64_t j = 0; j < n; ++j) {
      const float* xj = z + j * d;
      float acc = 0.0f;
      for (int64_t c = 0; c < d; ++c) {
        float diff = qi[c] - xj[c];
        acc += diff * diff;
      }
      cand[j] = {acc, j};
    }
    std::partial_sort(cand.begin(), cand.begin() + kk, cand.end());
    for (int64_t j = 0; j < kk; ++j) {
      dists[i * k + j] = std::sqrt(std::max(cand[j].first, 0.0f));
      idx[i * k + j] = cand[j].second;
    }
    for (int64_t j = kk; j < k; ++j) {
      dists[i * k + j] = kInf;
      idx[i * k + j] = -1;
    }
  });
}

}  // extern "C"
