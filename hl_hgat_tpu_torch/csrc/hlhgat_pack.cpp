// hlhgat_pack: the bin planner of the packed collate, the port's own.
//
// First-fit-decreasing packing of graphs into blocks under a node and an edge
// cap, the plan of data/fast_collate.py::pack_indices: each graph, in the
// given order, goes into the first open bin (in bin order) that holds both
// its nodes and its edges, else opens a new bin.  Several orders are tried;
// the one with the fewest bins wins, the earliest on ties.  Exact: the tests
// hold the bins equal to complex/dense.py::pack_plan.
//
// Build: hl_hgat_tpu_torch/native.py compiles this file with
// hlhgat_native.cpp into one library and loads it with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// First-fit of `count` graphs visited in `order`; bin id per visit into
// `bin_of`, the bin count returned.  A bin that cannot take the smallest node
// count or the smallest edge count still to come is closed for good and leaves
// `open`, the list of bins still scanned, in bin order; the placements are
// those of the plain scan over every bin.
int64_t first_fit(int64_t count, const int64_t* n, const int64_t* e, const int64_t* order,
                  int64_t node_cap, int64_t edge_cap, int64_t* bin_of,
                  std::vector<int64_t>& rem_n, std::vector<int64_t>& rem_e,
                  std::vector<int64_t>& min_n, std::vector<int64_t>& min_e,
                  std::vector<int64_t>& open) {
  // suffix minima of the counts along the order
  min_n.assign(count + 1, node_cap + 1);
  min_e.assign(count + 1, edge_cap + 1);
  for (int64_t i = count - 1; i >= 0; --i) {
    min_n[i] = std::min(min_n[i + 1], n[order[i]]);
    min_e[i] = std::min(min_e[i + 1], e[order[i]]);
  }
  rem_n.clear();
  rem_e.clear();
  open.clear();
  for (int64_t i = 0; i < count; ++i) {
    const int64_t p = order[i], nn = n[p], ee = e[p];
    // scan to the first fit, dropping closed bins as they are met
    size_t w = 0, r = 0;
    int64_t b = -1;
    while (r < open.size() && b < 0) {
      const int64_t c = open[r++];
      if (rem_n[c] < min_n[i] || rem_e[c] < min_e[i]) continue;
      open[w++] = c;
      if (rem_n[c] >= nn && rem_e[c] >= ee) b = c;
    }
    open.erase(std::copy(open.begin() + r, open.end(), open.begin() + w), open.end());
    if (b < 0) {
      b = static_cast<int64_t>(rem_n.size());
      rem_n.push_back(node_cap);
      rem_e.push_back(edge_cap);
      open.push_back(b);
    }
    rem_n[b] -= nn;
    rem_e[b] -= ee;
    bin_of[i] = b;
  }
  return static_cast<int64_t>(rem_n.size());
}

}  // namespace

extern "C" {

// First-fit-decreasing under `num_orders` orders (`orders`: [num_orders,
// count] positions into n and e, each a permutation).  Writes the winning
// order to out_order and its bin id per visit to out_bin; returns its bin
// count.  Every count must fit its cap (the caller checks).
int64_t ffd_pack(int64_t count, const int64_t* n, const int64_t* e, int64_t num_orders,
                 const int64_t* orders, int64_t node_cap, int64_t edge_cap,
                 int64_t* out_order, int64_t* out_bin) {
  std::vector<int64_t> rem_n, rem_e, min_n, min_e, open, bin_of(count);
  int64_t best = -1;
  for (int64_t k = 0; k < num_orders; ++k) {
    const int64_t* order = orders + k * count;
    const int64_t bins = first_fit(count, n, e, order, node_cap, edge_cap, bin_of.data(),
                                   rem_n, rem_e, min_n, min_e, open);
    if (best < 0 || bins < best) {
      best = bins;
      std::memcpy(out_order, order, count * sizeof(int64_t));
      std::memcpy(out_bin, bin_of.data(), count * sizeof(int64_t));
    }
  }
  return best < 0 ? 0 : best;
}

}  // extern "C"
