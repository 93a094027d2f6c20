// hlhgat_native: host-side preprocessing kernels of the PyTorch port.
//
// The port's own copy of the JAX package's native/hlhgat_native.cpp, the
// code unchanged.  The reference offloads these to torch-cluster's C++/CUDA
// (graclus greedy matching, reference lib/Hodge_Dataset.py:252) and
// pure-Python dict loops (coarse-edge dedup, reference
// lib/Hodge_Dataset.py:260-274); the ELL packing feeds the ELL SpMM kernel
// (csrc/ell_spmm.cu), the sparse L1 build the large-graph layout, and the
// packed fills the per-epoch collate of data/fast_collate.py.
//
// Bit-compatible with the NumPy versions (same visit order, same stable
// tie-breaking); the tests assert equality.
//
// Build: hl_hgat_tpu_torch/native.py compiles this file with g++ into
// hl_hgat_tpu_torch/_build/ at first use and loads it with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Greedy heavy-edge matching (graclus). Nodes are visited in index order;
// each unmatched node pairs with its heaviest-weight unmatched neighbour
// (ties broken by edge input order, matching a stable descending sort).
// out_cluster[i] receives the representative node id (min of the pair).
void graclus_match(int64_t num_nodes, int64_t num_edges,
                   const int32_t* src, const int32_t* dst,
                   const float* weight, int64_t* out_cluster) {
  // bucket neighbours per node, then order each bucket by descending weight
  std::vector<int64_t> degree(num_nodes, 0);
  for (int64_t i = 0; i < num_edges; ++i) {
    if (src[i] == dst[i]) continue;
    ++degree[src[i]];
    ++degree[dst[i]];
  }
  std::vector<int64_t> offset(num_nodes + 1, 0);
  for (int64_t v = 0; v < num_nodes; ++v) offset[v + 1] = offset[v] + degree[v];
  struct Nbr { int32_t v; float w; int64_t order; };
  std::vector<Nbr> nbrs(offset[num_nodes]);
  std::vector<int64_t> cursor(offset.begin(), offset.end() - 1);
  for (int64_t i = 0; i < num_edges; ++i) {
    const int32_t u = src[i], v = dst[i];
    if (u == v) continue;
    const float w = weight ? weight[i] : 1.0f;
    nbrs[cursor[u]++] = {v, w, i};
    nbrs[cursor[v]++] = {u, w, i};
  }
  for (int64_t v = 0; v < num_nodes; ++v) {
    std::stable_sort(nbrs.begin() + offset[v], nbrs.begin() + offset[v + 1],
                     [](const Nbr& a, const Nbr& b) { return a.w > b.w; });
  }
  std::vector<int64_t> m(num_nodes, -1);
  for (int64_t u = 0; u < num_nodes; ++u) {
    if (m[u] >= 0) continue;
    int64_t best = -1;
    for (int64_t k = offset[u]; k < offset[u + 1]; ++k) {
      const int32_t v = nbrs[k].v;
      if (m[v] < 0 && v != u) { best = v; break; }
    }
    if (best >= 0) {
      const int64_t rep = std::min<int64_t>(u, best);
      m[u] = rep;
      m[best] = rep;
    } else {
      m[u] = u;
    }
  }
  std::memcpy(out_cluster, m.data(), sizeof(int64_t) * num_nodes);
}

// Coarse-edge construction: first-seen dedup of (min,max) cluster pairs.
// c_edge[i] = coarse edge id of fine edge i, or -1 when both endpoints
// collapse into one cluster (the reference's `inf` marker).
// Returns the number of coarse edges; coarse endpoints land in
// out_src/out_dst (caller provides capacity num_edges).
int64_t coarse_edges(int64_t num_edges, const int32_t* src, const int32_t* dst,
                     const int64_t* c_node, int32_t* out_src, int32_t* out_dst,
                     int64_t* c_edge) {
  std::unordered_map<int64_t, int64_t> seen;
  seen.reserve(static_cast<size_t>(num_edges) * 2);
  int64_t next = 0;
  for (int64_t i = 0; i < num_edges; ++i) {
    const int64_t a = c_node[src[i]], b = c_node[dst[i]];
    if (a == b) { c_edge[i] = -1; continue; }
    const int64_t lo = std::min(a, b), hi = std::max(a, b);
    const int64_t key = (lo << 32) | hi;
    auto it = seen.find(key);
    if (it != seen.end()) {
      c_edge[i] = it->second;
    } else {
      seen.emplace(key, next);
      out_src[next] = static_cast<int32_t>(lo);
      out_dst[next] = static_cast<int32_t>(hi);
      c_edge[i] = next;
      ++next;
    }
  }
  return next;
}

// COO -> ELL packing for the Pallas SpMM kernel. Zero-valued (padding)
// entries are skipped. Returns -1 if any row exceeds `width`, else 0.
int32_t coo_to_ell(int64_t nnz, const int32_t* rows, const int32_t* cols,
                   const float* vals, int64_t num_rows, int64_t width,
                   int32_t* ell_cols, float* ell_vals) {
  std::vector<int64_t> cursor(num_rows, 0);
  std::memset(ell_cols, 0, sizeof(int32_t) * num_rows * width);
  std::memset(ell_vals, 0, sizeof(float) * num_rows * width);
  for (int64_t i = 0; i < nnz; ++i) {
    if (vals[i] == 0.0f) continue;
    const int64_t r = rows[i];
    const int64_t k = cursor[r];
    if (k >= width) return -1;
    ell_cols[r * width + k] = cols[i];
    ell_vals[r * width + k] = vals[i];
    cursor[r] = k + 1;
  }
  return 0;
}

// L1 = B1^T B1 construction, coalesced COO output, values pre-scaled.
// For each node, all ordered pairs of incident edges contribute
// sign(e@v) * sign(f@v); sign = -1 at the edge's src, +1 at its dst.
// out_* must have capacity sum(deg^2) (call l1_pair_count first).
// Returns the coalesced nnz.
int64_t hodge_l1(int64_t num_nodes, int64_t num_edges,
                 const int32_t* src, const int32_t* dst, float scale,
                 int32_t* out_rows, int32_t* out_cols, float* out_vals) {
  std::vector<int64_t> degree(num_nodes, 0);
  for (int64_t i = 0; i < num_edges; ++i) { ++degree[src[i]]; ++degree[dst[i]]; }
  std::vector<int64_t> offset(num_nodes + 1, 0);
  for (int64_t v = 0; v < num_nodes; ++v) offset[v + 1] = offset[v] + degree[v];
  std::vector<int32_t> inc_edge(offset[num_nodes]);
  std::vector<int8_t> inc_sign(offset[num_nodes]);
  std::vector<int64_t> cursor(offset.begin(), offset.end() - 1);
  for (int64_t i = 0; i < num_edges; ++i) {
    inc_edge[cursor[src[i]]] = static_cast<int32_t>(i);
    inc_sign[cursor[src[i]]++] = -1;
    inc_edge[cursor[dst[i]]] = static_cast<int32_t>(i);
    inc_sign[cursor[dst[i]]++] = 1;
  }
  struct Ent { int64_t key; float val; };
  std::vector<Ent> ents;
  int64_t cap = 0;
  for (int64_t v = 0; v < num_nodes; ++v) cap += degree[v] * degree[v];
  ents.reserve(cap);
  for (int64_t v = 0; v < num_nodes; ++v) {
    for (int64_t a = offset[v]; a < offset[v + 1]; ++a) {
      for (int64_t b = offset[v]; b < offset[v + 1]; ++b) {
        const int64_t key =
            static_cast<int64_t>(inc_edge[a]) * num_edges + inc_edge[b];
        ents.push_back({key, static_cast<float>(inc_sign[a] * inc_sign[b])});
      }
    }
  }
  std::sort(ents.begin(), ents.end(),
            [](const Ent& x, const Ent& y) { return x.key < y.key; });
  int64_t nnz = 0;
  size_t i = 0;
  while (i < ents.size()) {
    const int64_t key = ents[i].key;
    float sum = 0.0f;
    while (i < ents.size() && ents[i].key == key) sum += ents[i++].val;
    if (sum != 0.0f) {
      out_rows[nnz] = static_cast<int32_t>(key / num_edges);
      out_cols[nnz] = static_cast<int32_t>(key % num_edges);
      out_vals[nnz] = sum * scale;
      ++nnz;
    }
  }
  return nnz;
}

int64_t l1_pair_count(int64_t num_nodes, int64_t num_edges,
                      const int32_t* src, const int32_t* dst) {
  std::vector<int64_t> degree(num_nodes, 0);
  for (int64_t i = 0; i < num_edges; ++i) { ++degree[src[i]]; ++degree[dst[i]]; }
  int64_t total = 0;
  for (int64_t v = 0; v < num_nodes; ++v) total += degree[v] * degree[v];
  return total;
}

// Max nnz per row of a COO pattern (for choosing the ELL width).
int64_t max_row_nnz(int64_t nnz, const int32_t* rows, const float* vals,
                    int64_t num_rows) {
  std::vector<int64_t> count(num_rows, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    if (vals[i] != 0.0f) ++count[rows[i]];
  }
  int64_t mx = 0;
  for (int64_t r = 0; r < num_rows; ++r) mx = std::max(mx, count[r]);
  return mx;
}


// ---------------------------------------------------------------------------
// Packed dense collate (complex/dense.py::collate_dense_packed hot path).
//
// The per-epoch batch assembly — scattering each graph's Laplacian COO,
// boundary, masks, degrees and features into block-diagonal dense
// superblocks — is a pure host loop the reference delegates to PyG's
// multi-worker DataLoader collate.  On this host NumPy per-graph calls
// dominate epoch time, so the fill runs here over a once-per-dataset
// flattened arena (data/fast_collate.py); Python only computes bin
// placements.  Bit-compatible with the NumPy path (tests/test_data.py).
// ---------------------------------------------------------------------------

// Fill one resolution level's operators for one packed batch.
// Outputs are caller-allocated: l0/l1/b1/nm/em/deg zeroed,
// n_gid/s_gid prefilled with the dump-bucket id (num_graphs).
void packed_fill_level(
    int64_t n_batch, const int64_t* sample_idx, const int32_t* bin_of,
    const int32_t* node_off, const int32_t* edge_off,
    // flattened dataset, this level:
    const int32_t* num_nodes, const int32_t* num_edges,
    const int64_t* l0_off, const int32_t* l0_rows, const int32_t* l0_cols,
    const float* l0_vals,
    const int64_t* l1_off, const int32_t* l1_rows, const int32_t* l1_cols,
    const float* l1_vals,
    const int64_t* e_off, const int32_t* src, const int32_t* dst,
    const int32_t* gid,  // value to write into n_gid/s_gid per batch slot
    // outputs:
    int64_t s_pad, int64_t e_pad,
    float* l0, float* l1, float* b1, float* nm, float* em, float* deg,
    int32_t* n_gid, int32_t* s_gid) {
  for (int64_t g = 0; g < n_batch; ++g) {
    const int64_t si = sample_idx[g];
    const int64_t b = bin_of[g];
    const int64_t no = node_off[g], eo = edge_off[g];
    const int64_t n = num_nodes[si], e = num_edges[si];
    float* l0b = l0 + b * s_pad * s_pad;
    for (int64_t k = l0_off[si]; k < l0_off[si + 1]; ++k)
      l0b[(no + l0_rows[k]) * s_pad + (no + l0_cols[k])] = l0_vals[k];
    float* l1b = l1 + b * e_pad * e_pad;
    for (int64_t k = l1_off[si]; k < l1_off[si + 1]; ++k)
      l1b[(eo + l1_rows[k]) * e_pad + (eo + l1_cols[k])] = l1_vals[k];
    float* b1b = b1 + b * s_pad * e_pad;
    float* degb = deg + b * s_pad;
    for (int64_t k = 0; k < e; ++k) {
      const int32_t u = src[e_off[si] + k], v = dst[e_off[si] + k];
      b1b[(no + u) * e_pad + (eo + k)] = -1.0f;
      b1b[(no + v) * e_pad + (eo + k)] = 1.0f;
      degb[no + u] += 1.0f;
      degb[no + v] += 1.0f;
    }
    for (int64_t r = 0; r < n; ++r) {
      nm[b * s_pad + no + r] = 1.0f;
      n_gid[b * s_pad + no + r] = gid[g];
    }
    for (int64_t k = 0; k < e; ++k) {
      em[b * e_pad + eo + k] = 1.0f;
      s_gid[b * e_pad + eo + k] = gid[g];
    }
  }
}

// Generic padded row-block copy: out[bin_of[g], row_off[g] + r, :] =
// flat[flat_off[sample_idx[g]] + r, :].  Used for x_t, x_s and per-edge y.
void packed_fill_rows(
    int64_t n_batch, const int64_t* sample_idx, const int32_t* bin_of,
    const int32_t* row_off, const int64_t* flat_off, const float* flat,
    int64_t width, int64_t pad, float* out) {
  for (int64_t g = 0; g < n_batch; ++g) {
    const int64_t si = sample_idx[g];
    const int64_t rows = flat_off[si + 1] - flat_off[si];
    std::memcpy(out + (bin_of[g] * pad + row_off[g]) * width,
                flat + flat_off[si] * width,
                static_cast<size_t>(rows * width) * sizeof(float));
  }
}

// Fine->coarse pooling operators for one pool level, then row-normalize to
// means (scatter_mean semantics; all-zero rows keep denominator 1).
void packed_fill_pool(
    int64_t n_batch, const int64_t* sample_idx, const int32_t* bin_of,
    const int32_t* fine_node_off, const int32_t* fine_edge_off,
    const int32_t* coarse_node_off, const int32_t* coarse_edge_off,
    const int64_t* cn_off, const int64_t* c_node,
    const int64_t* ce_off, const int64_t* c_edge,
    int64_t n_bins, int64_t sc, int64_t sf, int64_t ec, int64_t ef,
    float* p_t, float* p_s) {
  for (int64_t g = 0; g < n_batch; ++g) {
    const int64_t si = sample_idx[g];
    const int64_t b = bin_of[g];
    float* ptb = p_t + b * sc * sf;
    for (int64_t j = 0; j < cn_off[si + 1] - cn_off[si]; ++j) {
      const int64_t c = c_node[cn_off[si] + j];
      if (c >= 0)
        ptb[(coarse_node_off[g] + c) * sf + (fine_node_off[g] + j)] = 1.0f;
    }
    float* psb = p_s + b * ec * ef;
    for (int64_t j = 0; j < ce_off[si + 1] - ce_off[si]; ++j) {
      const int64_t c = c_edge[ce_off[si] + j];
      if (c >= 0)
        psb[(coarse_edge_off[g] + c) * ef + (fine_edge_off[g] + j)] = 1.0f;
    }
  }
  for (int64_t b = 0; b < n_bins; ++b) {
    for (int64_t r = 0; r < sc; ++r) {
      float* row = p_t + (b * sc + r) * sf;
      float s = 0.0f;
      for (int64_t c = 0; c < sf; ++c) s += row[c];
      if (s > 1.0f)
        for (int64_t c = 0; c < sf; ++c) row[c] /= s;
    }
    for (int64_t r = 0; r < ec; ++r) {
      float* row = p_s + (b * ec + r) * ef;
      float s = 0.0f;
      for (int64_t c = 0; c < ef; ++c) s += row[c];
      if (s > 1.0f)
        for (int64_t c = 0; c < ef; ++c) row[c] /= s;
    }
  }
}

}  // extern "C"
