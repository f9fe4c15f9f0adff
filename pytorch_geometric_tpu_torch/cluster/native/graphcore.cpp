// graphcore: the port's native host-side graph routines.
//
// A copy of pytorch_geometric_tpu/cluster/native/graphcore.cpp without its
// TPU tile packing (pack_edges, pack_edges_bi, pack_edges_asym), whose
// role the port's CSR build (ops/csr.py) takes. These are host operations:
// sequential (greedy matching), data-dependent (radius, kNN) or
// loader-time (coalescing, neighbour sampling), feeding device tensors.
//
// Plain C interface, loaded with ctypes by cluster/_native.py, which
// builds it into the package's _build/ directory with
//   g++ -O3 -shared -fPIC -std=c++17 graphcore.cpp -o libgraphcore-<hash>.so
// The flags are the JAX package's: no -march=native, so no fused
// multiply-adds. Its results are then bitwise those of the JAX package's
// library, and those of voxel_grid, radius, knn and coalesce bitwise
// those of the plain numpy versions in cluster/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <numeric>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Greedy weighted matching (graclus coarsening).
// Reference semantics: torch-cluster graclus_cluster — iterate nodes in a
// (random or given) order; match each unmatched node with its unmatched
// neighbor of maximal edge weight; singletons self-match.  Returns cluster
// id per node (= min matched node id), as the reference kernel does.
// ---------------------------------------------------------------------------
void graclus_cluster(const int64_t* senders, const int64_t* receivers,
                     const double* weights,  // may be null (unweighted)
                     int64_t num_edges, int64_t num_nodes,
                     uint64_t seed, int64_t* cluster_out) {
  // CSR build
  std::vector<int64_t> deg(num_nodes + 1, 0);
  for (int64_t e = 0; e < num_edges; ++e) deg[senders[e] + 1]++;
  std::vector<int64_t> ptr(deg.begin(), deg.end());
  std::partial_sum(ptr.begin(), ptr.end(), ptr.begin());
  std::vector<int64_t> col(num_edges);
  std::vector<double> w(num_edges);
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t p = fill[senders[e]]++;
    col[p] = receivers[e];
    w[p] = weights ? weights[e] : 1.0;
  }

  std::vector<int64_t> order(num_nodes);
  std::iota(order.begin(), order.end(), 0);
  std::mt19937_64 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);

  std::fill(cluster_out, cluster_out + num_nodes, int64_t(-1));
  for (int64_t oi = 0; oi < num_nodes; ++oi) {
    int64_t u = order[oi];
    if (cluster_out[u] != -1) continue;
    int64_t best = -1;
    double best_w = -1.0;
    for (int64_t p = ptr[u]; p < ptr[u + 1]; ++p) {
      int64_t v = col[p];
      if (v == u || cluster_out[v] != -1) continue;
      if (w[p] > best_w) { best_w = w[p]; best = v; }
    }
    if (best == -1) {
      cluster_out[u] = u;
    } else {
      int64_t c = std::min(u, best);
      cluster_out[u] = c;
      cluster_out[best] = c;
    }
  }
}

// ---------------------------------------------------------------------------
// Voxel grid clustering (reference: torch-cluster voxel_grid).
// cluster id = flattened grid cell index of each point (batch-major).
// ---------------------------------------------------------------------------
void voxel_grid(const double* pos, int64_t num_points, int64_t dim,
                const int64_t* batch,  // may be null
                const double* size, const double* start, const double* end,
                int64_t* cluster_out) {
  std::vector<int64_t> cells(dim);
  for (int64_t d = 0; d < dim; ++d) {
    cells[d] = std::max<int64_t>(
        (int64_t)std::floor((end[d] - start[d]) / size[d]) + 1, 1);
  }
  int64_t cells_per_batch = 1;
  for (int64_t d = 0; d < dim; ++d) cells_per_batch *= cells[d];
  for (int64_t i = 0; i < num_points; ++i) {
    int64_t idx = 0;
    for (int64_t d = 0; d < dim; ++d) {
      int64_t c = (int64_t)std::floor((pos[i * dim + d] - start[d])
                                      / size[d]);
      c = std::min(std::max<int64_t>(c, 0), cells[d] - 1);
      idx = idx * cells[d] + c;
    }
    if (batch) idx += batch[i] * cells_per_batch;
    cluster_out[i] = idx;
  }
}

// ---------------------------------------------------------------------------
// Farthest point sampling (reference: torch-cluster fps, used by
// PointNet++ set abstraction, examples/pointnet++.py:39).  Per batch
// segment, iteratively pick the point farthest from the chosen set.
// Returns global indices of sampled points; count = ceil(ratio * n_b).
// ---------------------------------------------------------------------------
int64_t fps(const double* pos, int64_t num_points, int64_t dim,
            const int64_t* batch,  // may be null -> single batch
            double ratio, int64_t random_start, uint64_t seed,
            int64_t* out_idx) {
  std::mt19937_64 rng(seed);
  int64_t out_n = 0;
  int64_t b_start = 0;
  while (b_start < num_points) {
    int64_t b_end = b_start;
    int64_t b = batch ? batch[b_start] : 0;
    while (b_end < num_points && (batch ? batch[b_end] : 0) == b) ++b_end;
    int64_t n = b_end - b_start;
    int64_t k = std::max<int64_t>((int64_t)std::ceil(ratio * n), 1);
    std::vector<double> dist(n, 1e300);
    int64_t cur = random_start
        ? b_start + (int64_t)(rng() % (uint64_t)n) : b_start;
    for (int64_t s = 0; s < k; ++s) {
      out_idx[out_n++] = cur;
      double far_d = -1.0;
      int64_t far_i = cur;
      for (int64_t i = 0; i < n; ++i) {
        double d2 = 0;
        for (int64_t d = 0; d < dim; ++d) {
          double diff = pos[(b_start + i) * dim + d] - pos[cur * dim + d];
          d2 += diff * diff;
        }
        if (d2 < dist[i]) dist[i] = d2;
        if (dist[i] > far_d) { far_d = dist[i]; far_i = b_start + i; }
      }
      cur = far_i;
    }
    b_start = b_end;
  }
  return out_n;
}

// ---------------------------------------------------------------------------
// Radius neighborhood graph (reference: torch-cluster radius).  For each
// query y_i, up to max_neighbors x_j with ||x_j - y_i|| <= r, respecting
// batch segments.  Returns edge count; edges as (row=y idx, col=x idx).
// ---------------------------------------------------------------------------
int64_t radius(const double* x, int64_t nx, const double* y, int64_t ny,
               int64_t dim, const int64_t* batch_x, const int64_t* batch_y,
               double r, int64_t max_neighbors,
               int64_t* row_out, int64_t* col_out) {
  double r2 = r * r;
  int64_t cnt = 0;
  for (int64_t i = 0; i < ny; ++i) {
    int64_t found = 0;
    int64_t bi = batch_y ? batch_y[i] : 0;
    for (int64_t j = 0; j < nx && found < max_neighbors; ++j) {
      if (batch_x && batch_x[j] != bi) continue;
      double d2 = 0;
      for (int64_t d = 0; d < dim; ++d) {
        double diff = x[j * dim + d] - y[i * dim + d];
        d2 += diff * diff;
      }
      if (d2 <= r2) {
        row_out[cnt] = i;
        col_out[cnt] = j;
        ++cnt;
        ++found;
      }
    }
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// kNN graph (reference: torch-cluster knn / knn_graph).
// ---------------------------------------------------------------------------
int64_t knn(const double* x, int64_t nx, const double* y, int64_t ny,
            int64_t dim, const int64_t* batch_x, const int64_t* batch_y,
            int64_t k, int64_t* row_out, int64_t* col_out) {
  int64_t cnt = 0;
  std::vector<std::pair<double, int64_t>> cand;
  for (int64_t i = 0; i < ny; ++i) {
    cand.clear();
    int64_t bi = batch_y ? batch_y[i] : 0;
    for (int64_t j = 0; j < nx; ++j) {
      if (batch_x && batch_x[j] != bi) continue;
      double d2 = 0;
      for (int64_t d = 0; d < dim; ++d) {
        double diff = x[j * dim + d] - y[i * dim + d];
        d2 += diff * diff;
      }
      cand.emplace_back(d2, j);
    }
    int64_t kk = std::min<int64_t>(k, (int64_t)cand.size());
    std::partial_sort(cand.begin(), cand.begin() + kk, cand.end());
    for (int64_t s = 0; s < kk; ++s) {
      row_out[cnt] = i;
      col_out[cnt] = cand[s].second;
      ++cnt;
    }
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// Coalesce: sort edges by (receiver, sender), merge duplicates (sum attr
// columns).  The loader-time hot loop behind every dataset build
// (reference: torch-sparse coalesce).
// ---------------------------------------------------------------------------
int64_t coalesce(const int64_t* senders, const int64_t* receivers,
                 const double* attr, int64_t num_edges, int64_t attr_dim,
                 int64_t num_nodes,
                 int64_t* s_out, int64_t* r_out, double* attr_out) {
  std::vector<int64_t> order(num_edges);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (receivers[a] != receivers[b]) return receivers[a] < receivers[b];
    return senders[a] < senders[b];
  });
  int64_t out_n = -1;
  for (int64_t oi = 0; oi < num_edges; ++oi) {
    int64_t e = order[oi];
    if (out_n >= 0 && s_out[out_n] == senders[e]
        && r_out[out_n] == receivers[e]) {
      if (attr)
        for (int64_t d = 0; d < attr_dim; ++d)
          attr_out[out_n * attr_dim + d] += attr[e * attr_dim + d];
    } else {
      ++out_n;
      s_out[out_n] = senders[e];
      r_out[out_n] = receivers[e];
      if (attr)
        for (int64_t d = 0; d < attr_dim; ++d)
          attr_out[out_n * attr_dim + d] = attr[e * attr_dim + d];
    }
  }
  return out_n + 1;
}

// ---------------------------------------------------------------------------
// Uniform neighbor sampling (the host-pipelined sampler for PPI/Reddit
// style mini-batching; reference analog: sampled mini-batch training,
// examples/ppi.py:11-16).  For each seed, sample up to k in-neighbors
// WITHOUT replacement (degree <= k keeps all).  CSR over receivers.
// ---------------------------------------------------------------------------
int64_t sample_neighbors(const int64_t* indptr, const int64_t* indices,
                         const int64_t* seeds, int64_t num_seeds,
                         int64_t k, uint64_t seed,
                         int64_t* src_out, int64_t* dst_out) {
  std::mt19937_64 rng(seed);
  int64_t cnt = 0;
  std::vector<int64_t> pool;
  for (int64_t s = 0; s < num_seeds; ++s) {
    int64_t v = seeds[s];
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t deg = hi - lo;
    if (deg <= k) {
      for (int64_t p = lo; p < hi; ++p) {
        src_out[cnt] = indices[p];
        dst_out[cnt] = v;
        ++cnt;
      }
    } else {
      pool.resize(deg);
      std::iota(pool.begin(), pool.end(), lo);
      for (int64_t i = 0; i < k; ++i) {  // partial Fisher-Yates
        int64_t j = i + (int64_t)(rng() % (uint64_t)(deg - i));
        std::swap(pool[i], pool[j]);
        src_out[cnt] = indices[pool[i]];
        dst_out[cnt] = v;
        ++cnt;
      }
    }
  }
  return cnt;
}

}  // extern "C"
