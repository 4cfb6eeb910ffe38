// Louvain community detection (Blondel et al. 2008) for the mask
// association graph (perception/graph.py): the port's copy of
// openobj_tpu/native/louvain.cc, built and loaded by openobj_torch.native.
// The reference uses python-louvain's best_partition (maskclustering/
// mask_graph.py:82-122); this is an independent C++ implementation of the
// same published algorithm: repeated local-moving passes maximizing
// modularity, then graph aggregation, until no level improves.
//
// Deterministic for a given seed (node visiting order is a seeded shuffle,
// like python-louvain's randomize parameter).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#include <numeric>

namespace {

struct Level {
  int64_t n;
  // CSR adjacency (undirected: both directions present), self-loops allowed
  std::vector<int64_t> off, nbr;
  std::vector<double> w;
  std::vector<double> self_loop;  // self-loop weight per node
};

// xorshift64 for the deterministic visiting order
inline uint64_t xs64(uint64_t& s) {
  s ^= s << 13; s ^= s >> 7; s ^= s << 17;
  return s;
}

// One local-moving + aggregation level. labels_out: community per node
// (compacted 0..k-1). Returns true if anything moved.
bool one_level(const Level& g, double resolution, uint64_t seed,
               std::vector<int64_t>& labels_out) {
  const int64_t n = g.n;
  std::vector<int64_t> comm(n);
  std::iota(comm.begin(), comm.end(), 0);

  std::vector<double> k(n, 0.0);       // weighted degree (self-loops x2)
  double two_m = 0.0;
  for (int64_t u = 0; u < n; ++u) {
    double d = 2.0 * g.self_loop[u];
    for (int64_t e = g.off[u]; e < g.off[u + 1]; ++e) d += g.w[e];
    k[u] = d;
    two_m += d;
  }
  if (two_m <= 0) {  // no edges: everything is its own community
    labels_out = comm;
    return false;
  }

  std::vector<double> tot(k);          // sum of degrees per community
  std::vector<double> nbr_w(n, 0.0);   // scratch: weight to each community
  std::vector<int64_t> touched;
  touched.reserve(64);

  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  uint64_t rng = seed ? seed : 0x9e3779b97f4a7c15ULL;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(xs64(rng) % (uint64_t)(i + 1));
    std::swap(order[i], order[j]);
  }

  bool any_move = false;
  bool improved = true;
  int pass = 0;
  while (improved && pass++ < 64) {
    improved = false;
    for (int64_t oi = 0; oi < n; ++oi) {
      const int64_t u = order[oi];
      const int64_t cu = comm[u];

      touched.clear();
      for (int64_t e = g.off[u]; e < g.off[u + 1]; ++e) {
        const int64_t v = g.nbr[e];
        if (v == u) continue;
        const int64_t cv = comm[v];
        if (nbr_w[cv] == 0.0) touched.push_back(cv);
        nbr_w[cv] += g.w[e];
      }
      // remove u from its community
      tot[cu] -= k[u];
      const double w_cu = nbr_w[cu];

      int64_t best_c = cu;
      double best_gain = w_cu - resolution * tot[cu] * k[u] / two_m;
      for (const int64_t c : touched) {
        const double gain = nbr_w[c] - resolution * tot[c] * k[u] / two_m;
        if (gain > best_gain + 1e-12) {
          best_gain = gain;
          best_c = c;
        }
      }
      tot[best_c] += k[u];
      comm[u] = best_c;
      if (best_c != cu) { improved = true; any_move = true; }
      for (const int64_t c : touched) nbr_w[c] = 0.0;
      nbr_w[cu] = 0.0;
    }
  }

  // compact community ids
  std::vector<int64_t> remap(n, -1);
  int64_t k_comms = 0;
  labels_out.resize(n);
  for (int64_t u = 0; u < n; ++u) {
    if (remap[comm[u]] < 0) remap[comm[u]] = k_comms++;
    labels_out[u] = remap[comm[u]];
  }
  return any_move;
}

// Aggregate: communities of g become the nodes of the next level.
Level aggregate(const Level& g, const std::vector<int64_t>& labels,
                int64_t k_comms) {
  // accumulate inter-community weights via hashing into a flat map per node
  std::vector<std::vector<std::pair<int64_t, double>>> agg(k_comms);
  std::vector<double> self_w(k_comms, 0.0);
  for (int64_t u = 0; u < g.n; ++u) {
    const int64_t cu = labels[u];
    self_w[cu] += g.self_loop[u];
    for (int64_t e = g.off[u]; e < g.off[u + 1]; ++e) {
      const int64_t v = g.nbr[e];
      if (v < u) continue;  // count undirected edges once
      const int64_t cv = labels[v];
      const double w = g.w[e];
      if (cu == cv) {
        self_w[cu] += (u == v) ? 0.0 : w;
      } else {
        agg[cu].push_back({cv, w});
        agg[cv].push_back({cu, w});
      }
    }
  }
  Level out;
  out.n = k_comms;
  out.self_loop = std::move(self_w);
  out.off.assign(k_comms + 1, 0);
  // merge duplicate neighbor entries
  for (int64_t c = 0; c < k_comms; ++c) {
    auto& es = agg[c];
    std::vector<std::pair<int64_t, double>> merged;
    if (!es.empty()) {
      std::sort(es.begin(), es.end());
      for (const auto& e : es) {
        if (!merged.empty() && merged.back().first == e.first)
          merged.back().second += e.second;
        else
          merged.push_back(e);
      }
    }
    out.off[c + 1] = out.off[c] + (int64_t)merged.size();
    for (const auto& e : merged) {
      out.nbr.push_back(e.first);
      out.w.push_back(e.second);
    }
  }
  return out;
}

}  // namespace

extern "C" int64_t louvain(
    const int64_t* edge_i, const int64_t* edge_j, const double* edge_w,
    int64_t n_edges, int64_t n_nodes, double resolution, uint64_t seed,
    int64_t* labels_out) {
  // build level 0 (undirected CSR; self-loops separated)
  Level g;
  g.n = n_nodes;
  g.self_loop.assign(n_nodes, 0.0);
  std::vector<int64_t> deg(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t a = edge_i[e], b = edge_j[e];
    if (a < 0 || a >= n_nodes || b < 0 || b >= n_nodes) return -1;
    if (a == b) { g.self_loop[a] += edge_w[e]; continue; }
    ++deg[a]; ++deg[b];
  }
  g.off.assign(n_nodes + 1, 0);
  for (int64_t u = 0; u < n_nodes; ++u) g.off[u + 1] = g.off[u] + deg[u];
  g.nbr.resize(g.off[n_nodes]);
  g.w.resize(g.off[n_nodes]);
  std::vector<int64_t> cur(g.off.begin(), g.off.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t a = edge_i[e], b = edge_j[e];
    if (a == b) continue;
    g.nbr[cur[a]] = b; g.w[cur[a]++] = edge_w[e];
    g.nbr[cur[b]] = a; g.w[cur[b]++] = edge_w[e];
  }

  // levels
  std::vector<int64_t> assign(n_nodes);
  std::iota(assign.begin(), assign.end(), 0);
  for (int level = 0; level < 64; ++level) {
    std::vector<int64_t> labels;
    const bool moved = one_level(g, resolution, seed + (uint64_t)level, labels);
    int64_t k_comms = 0;
    for (const int64_t l : labels) k_comms = std::max(k_comms, l + 1);
    for (int64_t u = 0; u < n_nodes; ++u) assign[u] = labels[assign[u]];
    if (!moved || k_comms == g.n) break;
    g = aggregate(g, labels, k_comms);
  }
  std::memcpy(labels_out, assign.data(), sizeof(int64_t) * n_nodes);
  int64_t k_comms = 0;
  for (int64_t u = 0; u < n_nodes; ++u)
    k_comms = std::max(k_comms, assign[u] + 1);
  return k_comms;
}
