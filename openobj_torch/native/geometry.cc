// Native CPU geometry kernels: the port's copy of
// openobj_tpu/native/geometry.cc, built and loaded by openobj_torch.native.
//
// The reference offloads its CPU geometry (marching cubes, voxel
// downsampling, point-cloud neighbor queries) to third-party C++
// (skimage/Open3D). This is the first-party equivalent: a small C-ABI
// library driven from Python via ctypes (no pybind11 in this image).
//
// Exposed kernels:
//   * marching_tetrahedra: iso-surface of a scalar grid; 6-tet cube
//     decomposition, shared-vertex output via an open-addressing edge
//     hash map (same case table as ops/marching.py).
//   * voxel_downsample: average points per occupied voxel (grid hash).
//   * grid_dbscan_largest: largest-density-cluster filter, the inner loop
//     of the mask-denoise stage (uniform-grid neighborhood counting +
//     BFS flood fill — equivalent to DBSCAN with euclidean eps on CPU).
//   * felz_union_find: the Felzenszwalb segmentation merge pass over
//     pre-sorted edges (perception/segmentation.py's sequential hot loop).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <queue>

extern "C" {

// ---------------------------------------------------------------------------
// marching tetrahedra
// ---------------------------------------------------------------------------

namespace {

struct EdgeHash {
  size_t operator()(uint64_t k) const {
    k ^= k >> 33; k *= 0xff51afd7ed558ccdULL; k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL; k ^= k >> 33;
    return (size_t)k;
  }
};

const int kCorners[8][3] = {
    {0,0,0},{1,0,0},{1,1,0},{0,1,0},{0,0,1},{1,0,1},{1,1,1},{0,1,1}};
const int kTets[6][4] = {
    {0,5,1,6},{0,1,2,6},{0,2,3,6},{0,3,7,6},{0,7,4,6},{0,4,5,6}};

}  // namespace

// values: [n0*n1*n2] row-major; out buffers allocated by caller with
// capacities cap_v (floats*3) and cap_f (ints*3). Returns 0 on success,
// -1 if capacity exceeded. n_verts/n_faces outputs.
int marching_tetrahedra(
    const float* values, int64_t n0, int64_t n1, int64_t n2, float level,
    double* out_verts, int64_t cap_v, int64_t* n_verts,
    int64_t* out_faces, int64_t cap_f, int64_t* n_faces) {
  *n_verts = 0;
  *n_faces = 0;
  std::unordered_map<uint64_t, int64_t, EdgeHash> edge_to_vert;
  edge_to_vert.reserve(1 << 16);

  const int64_t s0 = n1 * n2, s1 = n2;
  auto val = [&](int64_t lid) { return values[lid]; };
  auto emit_vertex = [&](int64_t a, int64_t b) -> int64_t {
    if (a > b) std::swap(a, b);
    uint64_t key = ((uint64_t)a << 32) | (uint64_t)b;
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    double va = val(a), vb = val(b);
    double t = (level - va) / ((std::fabs(vb - va) < 1e-12) ? 1e-12 : (vb - va));
    if (t < 0) t = 0; if (t > 1) t = 1;
    double ax = (double)(a / s0), ay = (double)((a / s1) % n1), az = (double)(a % n2);
    double bx = (double)(b / s0), by = (double)((b / s1) % n1), bz = (double)(b % n2);
    int64_t vid = *n_verts;
    if (vid * 3 + 3 > cap_v) return -1;
    out_verts[vid*3+0] = (ax + t*(bx-ax)) / (double)(n0-1);
    out_verts[vid*3+1] = (ay + t*(by-ay)) / (double)(n1-1);
    out_verts[vid*3+2] = (az + t*(bz-az)) / (double)(n2-1);
    *n_verts = vid + 1;
    edge_to_vert.emplace(key, vid);
    return vid;
  };
  auto emit_tri = [&](int64_t e1a, int64_t e1b, int64_t e2a, int64_t e2b,
                      int64_t e3a, int64_t e3b) -> int {
    int64_t v1 = emit_vertex(e1a, e1b);
    int64_t v2 = emit_vertex(e2a, e2b);
    int64_t v3 = emit_vertex(e3a, e3b);
    if (v1 < 0 || v2 < 0 || v3 < 0) return -1;
    if (v1 == v2 || v2 == v3 || v1 == v3) return 0;  // degenerate
    int64_t f = *n_faces;
    if (f * 3 + 3 > cap_f) return -1;
    out_faces[f*3+0] = v1; out_faces[f*3+1] = v2; out_faces[f*3+2] = v3;
    *n_faces = f + 1;
    return 0;
  };

  int64_t corner_lid[8];
  float cv[8];
  for (int64_t x = 0; x < n0 - 1; ++x)
    for (int64_t y = 0; y < n1 - 1; ++y)
      for (int64_t z = 0; z < n2 - 1; ++z) {
        float cmin = 1e30f, cmax = -1e30f;
        for (int c = 0; c < 8; ++c) {
          corner_lid[c] = (x + kCorners[c][0]) * s0 +
                          (y + kCorners[c][1]) * s1 + (z + kCorners[c][2]);
          cv[c] = values[corner_lid[c]];
          if (cv[c] < cmin) cmin = cv[c];
          if (cv[c] > cmax) cmax = cv[c];
        }
        if (!(cmin < level && cmax >= level)) continue;
        for (int t = 0; t < 6; ++t) {
          int64_t tl[4];
          bool in[4];
          int n_in = 0;
          for (int k = 0; k < 4; ++k) {
            tl[k] = corner_lid[kTets[t][k]];
            in[k] = values[tl[k]] > level;
            n_in += in[k];
          }
          if (n_in == 0 || n_in == 4) continue;
          int ins[4], outs[4], ni = 0, no = 0;
          for (int k = 0; k < 4; ++k) (in[k] ? ins[ni++] : outs[no++]) = k;
          int r = 0;
          if (n_in == 1) {
            r = emit_tri(tl[ins[0]], tl[outs[0]], tl[ins[0]], tl[outs[1]],
                         tl[ins[0]], tl[outs[2]]);
          } else if (n_in == 3) {
            r = emit_tri(tl[ins[0]], tl[outs[0]], tl[ins[2]], tl[outs[0]],
                         tl[ins[1]], tl[outs[0]]);
          } else {  // n_in == 2
            r = emit_tri(tl[ins[0]], tl[outs[0]], tl[ins[0]], tl[outs[1]],
                         tl[ins[1]], tl[outs[1]]);
            if (r == 0)
              r = emit_tri(tl[ins[0]], tl[outs[0]], tl[ins[1]], tl[outs[1]],
                           tl[ins[1]], tl[outs[0]]);
          }
          if (r < 0) return -1;
        }
      }
  return 0;
}

// ---------------------------------------------------------------------------
// voxel downsample: mean of points per voxel
// ---------------------------------------------------------------------------

int64_t voxel_downsample(
    const double* points, int64_t n, double voxel,
    double* out_points, int64_t cap_out) {
  std::unordered_map<uint64_t, std::pair<int64_t, int64_t>, EdgeHash> vox;
  vox.reserve((size_t)n * 2);
  std::vector<double> sums;
  sums.reserve((size_t)n * 3 / 4);
  std::vector<int64_t> counts;
  int64_t n_out = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t kx = (int64_t)std::floor(points[i*3+0] / voxel);
    int64_t ky = (int64_t)std::floor(points[i*3+1] / voxel);
    int64_t kz = (int64_t)std::floor(points[i*3+2] / voxel);
    uint64_t key = ((uint64_t)(kx & 0x1fffff) << 42) |
                   ((uint64_t)(ky & 0x1fffff) << 21) |
                   ((uint64_t)(kz & 0x1fffff));
    auto it = vox.find(key);
    int64_t slot;
    if (it == vox.end()) {
      slot = n_out++;
      if (slot * 3 + 3 > cap_out) return -1;
      vox.emplace(key, std::make_pair(slot, 1));
      sums.resize((size_t)n_out * 3, 0.0);
      counts.resize((size_t)n_out, 0);
    } else {
      slot = it->second.first;
    }
    sums[slot*3+0] += points[i*3+0];
    sums[slot*3+1] += points[i*3+1];
    sums[slot*3+2] += points[i*3+2];
    counts[(size_t)slot] += 1;
  }
  for (int64_t s = 0; s < n_out; ++s) {
    out_points[s*3+0] = sums[s*3+0] / counts[(size_t)s];
    out_points[s*3+1] = sums[s*3+1] / counts[(size_t)s];
    out_points[s*3+2] = sums[s*3+2] / counts[(size_t)s];
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// grid DBSCAN largest-cluster filter
// ---------------------------------------------------------------------------

// Euclidean-eps DBSCAN via uniform grid binning (cell = eps), returning a
// keep-mask for the largest cluster. min_points counts the eps-ball
// neighborhood (27-cell candidates, exact distance test).
int64_t grid_dbscan_largest(
    const double* points, int64_t n, double eps, int64_t min_points,
    uint8_t* keep_mask) {
  if (n == 0) return 0;
  std::unordered_map<uint64_t, std::vector<int32_t>, EdgeHash> grid;
  grid.reserve((size_t)n * 2);
  auto key_of = [&](double x, double y, double z) -> uint64_t {
    int64_t kx = (int64_t)std::floor(x / eps);
    int64_t ky = (int64_t)std::floor(y / eps);
    int64_t kz = (int64_t)std::floor(z / eps);
    return ((uint64_t)(kx & 0x1fffff) << 42) |
           ((uint64_t)(ky & 0x1fffff) << 21) | ((uint64_t)(kz & 0x1fffff));
  };
  for (int64_t i = 0; i < n; ++i)
    grid[key_of(points[i*3], points[i*3+1], points[i*3+2])].push_back((int32_t)i);

  const double eps2 = eps * eps;
  auto neighbors = [&](int64_t i, std::vector<int32_t>& out) {
    out.clear();
    double x = points[i*3], y = points[i*3+1], z = points[i*3+2];
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = grid.find(key_of(x + dx*eps, y + dy*eps, z + dz*eps));
          if (it == grid.end()) continue;
          for (int32_t j : it->second) {
            double ddx = points[j*3] - x, ddy = points[j*3+1] - y,
                   ddz = points[j*3+2] - z;
            if (ddx*ddx + ddy*ddy + ddz*ddz <= eps2) out.push_back(j);
          }
        }
  };

  std::vector<int32_t> labels((size_t)n, -2);  // -2 unvisited, -1 noise
  std::vector<int32_t> nb, nb2;
  int32_t n_clusters = 0;
  std::vector<int64_t> cluster_sizes;
  for (int64_t i = 0; i < n; ++i) {
    if (labels[(size_t)i] != -2) continue;
    neighbors(i, nb);
    if ((int64_t)nb.size() < min_points) { labels[(size_t)i] = -1; continue; }
    int32_t cid = n_clusters++;
    cluster_sizes.push_back(0);
    std::queue<int32_t> q;
    labels[(size_t)i] = cid;
    cluster_sizes[cid]++;
    for (int32_t j : nb)
      if (labels[(size_t)j] == -2 || labels[(size_t)j] == -1) {
        if (labels[(size_t)j] == -2) q.push(j);
        labels[(size_t)j] = cid;
        if (j != i) cluster_sizes[cid]++;
      }
    while (!q.empty()) {
      int32_t u = q.front(); q.pop();
      neighbors(u, nb2);
      if ((int64_t)nb2.size() >= min_points) {
        for (int32_t j : nb2) {
          if (labels[(size_t)j] == -2) {
            labels[(size_t)j] = cid;
            cluster_sizes[cid]++;
            q.push(j);
          } else if (labels[(size_t)j] == -1) {
            labels[(size_t)j] = cid;
            cluster_sizes[cid]++;
          }
        }
      }
    }
  }
  if (n_clusters == 0) return 0;
  int32_t best = 0;
  for (int32_t c = 1; c < n_clusters; ++c)
    if (cluster_sizes[(size_t)c] > cluster_sizes[(size_t)best]) best = c;
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    keep_mask[i] = labels[(size_t)i] == best ? 1 : 0;
    kept += keep_mask[i];
  }
  return kept;
}

// ------------------------------------------------------------------------- //
// Voxel flood-fill largest-cluster filter: the O(n) large-cloud variant of
// grid_dbscan_largest. Exact DBSCAN's neighbor scan costs O(points per
// eps-cell) per point, which explodes when eps greatly exceeds the point
// spacing (dense surface clouds under the adaptive-eps denoise). For the
// denoise role — keep the big connected surface, drop depth-bleed speckle —
// connectivity between eps-edge voxels (3^3 neighborhood, point-weighted
// cluster sizes vs min_points) is equivalent in effect and linear in n.
int64_t voxel_flood_largest(const double* points, int64_t n, double eps,
                            int64_t min_points, uint8_t* keep_mask) {
  if (n <= 0) return 0;
  const double inv = 1.0 / eps;
  auto key_of = [&](double x, double y, double z) -> uint64_t {
    int64_t kx = (int64_t)std::floor(x * inv);
    int64_t ky = (int64_t)std::floor(y * inv);
    int64_t kz = (int64_t)std::floor(z * inv);
    return ((uint64_t)(kx & 0x1fffff) << 42) |
           ((uint64_t)(ky & 0x1fffff) << 21) |
           ((uint64_t)(kz & 0x1fffff));
  };
  // voxel id assignment
  std::unordered_map<uint64_t, int32_t, EdgeHash> vox;
  vox.reserve((size_t)n);
  std::vector<int32_t> pt_vox((size_t)n);
  std::vector<int64_t> vcount;
  std::vector<uint64_t> vkey;
  std::vector<double> vx, vy, vz;   // a representative point per voxel
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = key_of(points[i*3], points[i*3+1], points[i*3+2]);
    auto it = vox.find(k);
    int32_t vid;
    if (it == vox.end()) {
      vid = (int32_t)vcount.size();
      vox.emplace(k, vid);
      vcount.push_back(0);
      vkey.push_back(k);
      vx.push_back(points[i*3]); vy.push_back(points[i*3+1]);
      vz.push_back(points[i*3+2]);
    } else {
      vid = it->second;
    }
    pt_vox[(size_t)i] = vid;
    vcount[(size_t)vid]++;
  }
  const int64_t n_vox = (int64_t)vcount.size();
  // flood fill over 3^3 voxel adjacency
  std::vector<int32_t> comp((size_t)n_vox, -1);
  std::vector<int64_t> comp_weight;
  std::queue<int32_t> q;
  for (int64_t s = 0; s < n_vox; ++s) {
    if (comp[(size_t)s] >= 0) continue;
    int32_t cid = (int32_t)comp_weight.size();
    comp_weight.push_back(0);
    comp[(size_t)s] = cid;
    q.push((int32_t)s);
    while (!q.empty()) {
      int32_t u = q.front(); q.pop();
      comp_weight[(size_t)cid] += vcount[(size_t)u];
      for (int dx = -1; dx <= 1; ++dx)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dz = -1; dz <= 1; ++dz) {
            if (!dx && !dy && !dz) continue;
            auto it = vox.find(key_of(vx[(size_t)u] + dx * eps,
                                      vy[(size_t)u] + dy * eps,
                                      vz[(size_t)u] + dz * eps));
            if (it == vox.end() || comp[(size_t)it->second] >= 0) continue;
            comp[(size_t)it->second] = cid;
            q.push(it->second);
          }
    }
  }
  // largest component by point weight, subject to min_points
  int32_t best = -1;
  int64_t best_w = 0;
  for (size_t c = 0; c < comp_weight.size(); ++c)
    if (comp_weight[c] >= min_points && comp_weight[c] > best_w) {
      best = (int32_t)c;
      best_w = comp_weight[c];
    }
  if (best < 0) return 0;
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    keep_mask[i] = comp[(size_t)pt_vox[(size_t)i]] == best ? 1 : 0;
    kept += keep_mask[i];
  }
  return kept;
}

// ------------------------------------------------------------------------- //
// Felzenszwalb-Huttenlocher graph-segmentation merge pass (the sequential
// union-find over weight-sorted edges — perception/segmentation.py's hot
// loop; the edge construction/sorting stays numpy). Same semantics as the
// Python _union_find_segment: MInt merge rule, then a min_size cleanup
// absorbing small components across their cheapest boundary edge, then
// root labels per pixel. Edges MUST be pre-sorted by weight ascending.
int felz_union_find(const int64_t* ea, const int64_t* eb, const double* w,
                    int64_t n_edges, int64_t n_px, double k,
                    int64_t min_size, int64_t* labels_out) {
  if (n_px <= 0) return 0;
  std::vector<int64_t> parent((size_t)n_px);
  std::vector<int64_t> size((size_t)n_px, 1);
  std::vector<double> internal((size_t)n_px, 0.0);
  for (int64_t i = 0; i < n_px; ++i) parent[(size_t)i] = i;
  auto find = [&](int64_t x) {
    int64_t root = x;
    while (parent[(size_t)root] != root) root = parent[(size_t)root];
    while (parent[(size_t)x] != root) {
      int64_t nxt = parent[(size_t)x];
      parent[(size_t)x] = root;
      x = nxt;
    }
    return root;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ra = find(ea[e]), rb = find(eb[e]);
    if (ra == rb) continue;
    double mint_a = internal[(size_t)ra] + k / (double)size[(size_t)ra];
    double mint_b = internal[(size_t)rb] + k / (double)size[(size_t)rb];
    if (w[e] <= (mint_a < mint_b ? mint_a : mint_b)) {
      if (size[(size_t)ra] < size[(size_t)rb]) std::swap(ra, rb);
      parent[(size_t)rb] = ra;
      size[(size_t)ra] += size[(size_t)rb];
      internal[(size_t)ra] = w[e];  // edges arrive sorted: w is the max
    }
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ra = find(ea[e]), rb = find(eb[e]);
    if (ra != rb && (size[(size_t)ra] < min_size ||
                     size[(size_t)rb] < min_size)) {
      if (size[(size_t)ra] < size[(size_t)rb]) std::swap(ra, rb);
      parent[(size_t)rb] = ra;
      size[(size_t)ra] += size[(size_t)rb];
    }
  }
  for (int64_t i = 0; i < n_px; ++i) labels_out[i] = find(i);
  return 0;
}

}  // extern "C"
