/* Native host-side graph kernels of kimimaro_tpu_torch (a copy of
 * kimimaro_tpu/native/hostops.cpp).
 *
 * kimimaro implements its host graph work (cycle detection, the
 * critical-point distance supergraph) in C++ (skeletontricks.hpp:209-394).
 * These are the equivalents, exposed as a plain C ABI for ctypes.
 * kimimaro_tpu_torch.post loads them when the library builds and falls
 * back to pure python otherwise: results are identical.
 *
 * Build: g++ at first use into build/native/ (kimimaro_tpu_torch.native).
 */

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <cmath>

namespace {

struct Adjacency {
  std::unordered_map<int64_t, std::vector<int64_t>> adj;

  explicit Adjacency(const int32_t* edges, long m) {
    adj.reserve(static_cast<size_t>(m) * 2);
    for (long i = 0; i < m; i++) {
      int64_t a = edges[2 * i];
      int64_t b = edges[2 * i + 1];
      adj[a].push_back(b);
      adj[b].push_back(a);
    }
    // deterministic traversal order
    for (auto& kv : adj) {
      std::sort(kv.second.begin(), kv.second.end());
    }
  }
};

}  // namespace

extern "C" {

/* Find one cycle via iterative DFS from edges[0]. Writes the closed walk
 * [a, x1, ..., a] into out (capacity cap); returns its length, 0 when the
 * graph is acyclic, -1 on overflow. Mirrors kimimaro_tpu_torch.post.find_cycle. */
long kt_find_cycle(const int32_t* edges, long m, int32_t* out, long cap) {
  if (m == 0) return 0;
  Adjacency g(edges, m);

  int64_t root = edges[0];
  std::vector<int64_t> stack{root};
  std::vector<int64_t> parents{-1};
  std::vector<long> depths{0};
  std::vector<int64_t> path;
  std::unordered_set<int64_t> visited;

  int64_t node = -1;
  bool found = false;

  while (!stack.empty()) {
    node = stack.back(); stack.pop_back();
    int64_t parent = parents.back(); parents.pop_back();
    long depth = depths.back(); depths.pop_back();

    while (static_cast<long>(path.size()) > depth) path.pop_back();
    path.push_back(node);

    if (visited.count(node)) { found = true; break; }
    visited.insert(node);

    const auto& nbrs = g.adj[node];
    for (int64_t child : nbrs) {
      if (child == parent) continue;
      stack.push_back(child);
      parents.push_back(node);
      depths.push_back(depth + 1);
    }
  }

  if (!found || path.size() <= 1) return 0;

  size_t i = 0;
  for (; i + 1 < path.size(); i++) {
    if (path[i] == node) break;
  }
  if (path.size() - i < 3) return 0;

  long n = static_cast<long>(path.size() - i);
  if (n > cap) return -1;
  for (long k = 0; k < n; k++) out[k] = static_cast<int32_t>(path[i + k]);
  return n;
}

/* Distance supergraph between critical points (terminals + branch points)
 * of one connected component. Fills out_uv (pairs) and out_d (distances);
 * returns the number of entries, -1 on overflow. Mirrors
 * kimimaro_tpu_torch.post.create_distance_graph. */
long kt_distance_graph(const float* verts, long n_verts,
                       const int32_t* edges, long m,
                       int64_t* out_uv, double* out_d, long cap) {
  if (m == 0) return 0;
  Adjacency g(edges, m);

  std::unordered_map<int64_t, long> degree;
  for (long i = 0; i < m; i++) {
    degree[edges[2 * i]]++;
    degree[edges[2 * i + 1]]++;
  }

  std::unordered_set<int64_t> critical;
  int64_t start = -1;
  // deterministic first terminal: smallest node id with degree 1
  for (const auto& kv : degree) {
    if (kv.second == 1 || kv.second >= 3) critical.insert(kv.first);
    if (kv.second == 1 && (start < 0 || kv.first < start)) start = kv.first;
  }
  if (start < 0) return 0;

  struct Frame { int64_t node, parent, root; double dist; };
  std::vector<Frame> stack{{start, -1, start, 0.0}};
  long count = 0;
  long steps = 0;
  const long max_steps = 4 * m + 16;  // guards against cyclic inputs

  auto vdist = [&](int64_t a, int64_t b) -> double {
    double dx = verts[3 * a] - verts[3 * b];
    double dy = verts[3 * a + 1] - verts[3 * b + 1];
    double dz = verts[3 * a + 2] - verts[3 * b + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };

  while (!stack.empty()) {
    if (++steps > max_steps) return -1;
    Frame f = stack.back(); stack.pop_back();

    int64_t root = f.root;
    double dist = f.dist;
    if (critical.count(f.node) && f.node != f.root) {
      if (count >= cap) return -1;
      out_uv[2 * count] = f.root;
      out_uv[2 * count + 1] = f.node;
      out_d[count] = f.dist;
      count++;
      dist = 0.0;
      root = f.node;
    }

    for (int64_t child : g.adj[f.node]) {
      if (child == f.parent) continue;
      stack.push_back({child, f.node, root,
                       dist + vdist(f.node, child)});
    }
  }
  return count;
}

/* Bounding boxes of arbitrary label ids in ONE pass over the raw volume —
 * the role find_objects plays in the reference (utility.py:86-90) without
 * the renumber it needs first. ids: k sorted uint64 ids; out: k*6 int64
 * rows (minx,miny,minz,maxx,maxy,maxz), min=-1 marks "absent". A one-entry
 * run cache skips the hash lookup inside constant-label runs, which
 * dominate segmentation volumes. labels are uint{8,16,32,64} chosen by
 * `bytes`. Returns 0, or -1 on bad args. */
long kt_bbox_ids(const void* labels_raw, long bytes,
                 long X, long Y, long Z,
                 const uint64_t* ids, long k, int64_t* out) {
  if (k <= 0) return 0;
  std::unordered_map<uint64_t, long> index;
  index.reserve(static_cast<size_t>(k) * 2);
  for (long i = 0; i < k; i++) {
    index.emplace(ids[i], i);
    out[6 * i] = out[6 * i + 1] = out[6 * i + 2] = -1;
    out[6 * i + 3] = out[6 * i + 4] = out[6 * i + 5] = -1;
  }

  uint64_t run_label = ~uint64_t(0);
  long run_idx = -2;  // -1 = "not tracked", -2 = invalid cache

  auto visit = [&](uint64_t l, long x, long y, long z) {
    if (l != run_label || run_idx == -2) {
      run_label = l;
      auto it = index.find(l);
      run_idx = (it == index.end()) ? -1 : it->second;
    }
    if (run_idx < 0) return;
    int64_t* r = out + 6 * run_idx;
    if (r[0] < 0) {
      r[0] = x; r[1] = y; r[2] = z; r[3] = x; r[4] = y; r[5] = z;
    } else {
      if (x < r[0]) r[0] = x;
      if (y < r[1]) r[1] = y;
      if (z < r[2]) r[2] = z;
      if (x > r[3]) r[3] = x;
      if (y > r[4]) r[4] = y;
      if (z > r[5]) r[5] = z;
    }
  };

  auto sweep = [&](auto* p) {
    long i = 0;
    for (long x = 0; x < X; x++)
      for (long y = 0; y < Y; y++)
        for (long z = 0; z < Z; z++, i++)
          visit(static_cast<uint64_t>(p[i]), x, y, z);
  };
  switch (bytes) {
    case 1: sweep(reinterpret_cast<const uint8_t*>(labels_raw)); break;
    case 2: sweep(reinterpret_cast<const uint16_t*>(labels_raw)); break;
    case 4: sweep(reinterpret_cast<const uint32_t*>(labels_raw)); break;
    case 8: sweep(reinterpret_cast<const uint64_t*>(labels_raw)); break;
    default: return -1;
  }
  return 0;
}

}  // extern "C"

/* Single-pass RLE encoder: equal-value runs in C linear order, emitted as
 * (u8 length, value) with runs longer than 255 split into same-value
 * pieces (the layout kimimaro_tpu.intake._upload_labels ships). One
 * streaming read. Returns the run count, or -1 when `cap` would overflow. */
template <typename T>
static long kt_rle_impl(const T* flat, long n, uint8_t* lengths, T* values,
                        long cap) {
  long out = 0;
  long i = 0;
  while (i < n) {
    const T v = flat[i];
    long j = i + 1;
    while (j < n && flat[j] == v) ++j;
    long len = j - i;
    while (len > 0) {
      const long take = len > 255 ? 255 : len;
      if (out >= cap) return -1;
      lengths[out] = static_cast<uint8_t>(take);
      values[out] = v;
      ++out;
      len -= take;
    }
    i = j;
  }
  return out;
}

extern "C" long kt_rle_encode(const void* flat, long n, int esz,
                              uint8_t* lengths, void* values, long cap) {
  switch (esz) {
    case 1:
      return kt_rle_impl(reinterpret_cast<const uint8_t*>(flat), n, lengths,
                         reinterpret_cast<uint8_t*>(values), cap);
    case 2:
      return kt_rle_impl(reinterpret_cast<const uint16_t*>(flat), n, lengths,
                         reinterpret_cast<uint16_t*>(values), cap);
    case 4:
      return kt_rle_impl(reinterpret_cast<const uint32_t*>(flat), n, lengths,
                         reinterpret_cast<uint32_t*>(values), cap);
    default:
      return -1;
  }
}
