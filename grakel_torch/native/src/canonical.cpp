// General canonical-labeling engine (bliss replacement).
//
// Covers the capability of the reference's vendored bliss-0.50
// (reference grakel/kernels/_isomorphism/bliss.pyx:28-361 — the
// Graph.canonical_labeling / isomorphic surface) with a compact
// individualization-refinement search:
//
//   * color refinement: vertices are iteratively re-ranked by
//     (current color, sorted multiset of out-neighbor colors, sorted
//     multiset of in-neighbor colors) until the partition stabilizes —
//     equivariant under isomorphism, so ranks are canonical cell ids;
//   * if the stable partition is not discrete, the first smallest
//     non-singleton cell is individualized: each of its vertices in
//     turn is split into a fresh singleton cell and the search recurses;
//   * every search node carries a node invariant (a hash of its refined
//     color vector); the canonical leaf maximizes the (invariant path,
//     leaf certificate) pair lexicographically, so branches whose
//     invariant falls below the incumbent path are pruned and branches
//     above it restart the incumbent (nauty's indicator-function trick);
//   * the leaf certificate is the initial color sequence in canonical
//     order followed by the permuted adjacency bitmap, making the
//     canonical form exact (not a hash) — collision-free binning.
//
// Worst case is exponential on highly regular graphs (as for all
// I-R solvers without orbit pruning); on the graphlet sizes and TU
// graphs this framework feeds it, the tree is tiny.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

inline uint64_t cmix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

struct CanonSearch {
  int n;
  std::vector<std::vector<int>> out, in;
  std::vector<int32_t> init_color;
  bool directed;

  // incumbent
  std::vector<uint64_t> best_path;  // node invariants along best branch
  std::vector<uint8_t> best_cert;
  bool have_best = false;

  // scratch
  std::vector<int> key_rank;

  // rank vertices by (color, sorted out-neighbor colors, sorted
  // in-neighbor colors) until the number of cells stops growing.
  void refine(std::vector<int> &c) const {
    std::vector<std::vector<int>> keys(n);
    std::vector<int> order(n), nc(n);
    int ncolors = 0;
    for (int v = 0; v < n; ++v) ncolors = std::max(ncolors, c[v] + 1);
    while (true) {
      for (int v = 0; v < n; ++v) {
        auto &k = keys[v];
        k.clear();
        k.push_back(c[v]);
        size_t head = k.size();
        for (int u : out[v]) k.push_back(c[u]);
        std::sort(k.begin() + head, k.end());
        if (directed) {
          k.push_back(-1);  // section mark between out and in lists
          head = k.size();
          for (int u : in[v]) k.push_back(c[u]);
          std::sort(k.begin() + head, k.end());
        }
      }
      for (int v = 0; v < n; ++v) order[v] = v;
      std::sort(order.begin(), order.end(), [&](int a, int b) {
        return keys[a] < keys[b];
      });
      int rank = 0;
      nc[order[0]] = 0;
      for (int i = 1; i < n; ++i) {
        if (keys[order[i]] != keys[order[i - 1]]) ++rank;
        nc[order[i]] = rank;
      }
      c = nc;
      if (rank + 1 == ncolors) return;
      ncolors = rank + 1;
    }
  }

  uint64_t invariant(const std::vector<int> &c, int ncolors) const {
    // folding the cell count in keeps discrete (leaf) vectors from
    // colliding with same-depth internal nodes
    uint64_t h = cmix64(0x9E3779B97F4A7C15ULL ^ (uint64_t)ncolors);
    for (int v = 0; v < n; ++v) h = cmix64(h ^ (uint64_t)c[v]);
    return h;
  }

  // discrete coloring -> certificate bytes
  void leaf_cert(const std::vector<int> &c, std::vector<uint8_t> &cert)
      const {
    std::vector<int> at(n);  // at[pos] = vertex
    for (int v = 0; v < n; ++v) at[c[v]] = v;
    cert.assign((size_t)4 * n + ((size_t)n * n + 7) / 8, 0);
    for (int pos = 0; pos < n; ++pos) {
      uint32_t col = (uint32_t)init_color[at[pos]];
      cert[(size_t)4 * pos] = (uint8_t)(col >> 24);
      cert[(size_t)4 * pos + 1] = (uint8_t)(col >> 16);
      cert[(size_t)4 * pos + 2] = (uint8_t)(col >> 8);
      cert[(size_t)4 * pos + 3] = (uint8_t)col;
    }
    uint8_t *bits = cert.data() + (size_t)4 * n;
    for (int v = 0; v < n; ++v)
      for (int u : out[v]) {
        size_t b = (size_t)c[v] * n + c[u];
        bits[b >> 3] |= (uint8_t)(1u << (b & 7));
      }
  }

  void search(std::vector<int> c, int depth) {
    refine(c);
    int ncolors = 0;
    for (int v = 0; v < n; ++v) ncolors = std::max(ncolors, c[v] + 1);
    uint64_t ni = invariant(c, ncolors);
    if (depth < (int)best_path.size()) {
      if (ni < best_path[depth]) return;  // dominated branch
      if (ni > best_path[depth]) {        // dominates the incumbent
        best_path.resize(depth + 1);
        best_path[depth] = ni;
        have_best = false;
      }
    } else {
      best_path.push_back(ni);
    }
    if (ncolors == n) {  // discrete: a candidate leaf
      std::vector<uint8_t> cert;
      leaf_cert(c, cert);
      if (!have_best || cert > best_cert) {
        best_cert.swap(cert);
        best_perm = c;
        have_best = true;
      }
      return;
    }
    // first smallest non-singleton cell
    std::vector<int> count(ncolors, 0);
    for (int v = 0; v < n; ++v) ++count[c[v]];
    int target = -1, tsize = n + 1;
    for (int col = 0; col < ncolors; ++col)
      if (count[col] > 1 && count[col] < tsize) {
        target = col;
        tsize = count[col];
      }
    for (int v = 0; v < n; ++v) {
      if (c[v] != target) continue;
      std::vector<int> c2(c);
      for (int u = 0; u < n; ++u)
        if (c2[u] >= target) ++c2[u];
      c2[v] = target;  // v gets its own cell just before its old one
      search(std::move(c2), depth + 1);
    }
  }

  std::vector<int> best_perm;
};

}  // namespace

extern "C" {

// out_perm[v] = canonical position of vertex v.  Returns 0 on success.
int canonical_labeling(int n, long ne, const int32_t *src,
                       const int32_t *dst, const int32_t *colors,
                       int directed, int32_t *out_perm) {
  if (n <= 0) return 0;
  CanonSearch s;
  s.n = n;
  s.directed = directed != 0;
  s.out.assign(n, {});
  s.in.assign(n, {});
  for (long e = 0; e < ne; ++e) {
    s.out[src[e]].push_back(dst[e]);
    s.in[dst[e]].push_back(src[e]);
  }
  for (int v = 0; v < n; ++v) {
    auto dedup = [](std::vector<int> &a) {
      std::sort(a.begin(), a.end());
      a.erase(std::unique(a.begin(), a.end()), a.end());
    };
    dedup(s.out[v]);
    dedup(s.in[v]);
  }
  s.init_color.assign(colors, colors + n);
  // initial coloring = rank of the given colors (equivariant)
  std::vector<int32_t> sorted_cols(s.init_color);
  std::sort(sorted_cols.begin(), sorted_cols.end());
  sorted_cols.erase(std::unique(sorted_cols.begin(), sorted_cols.end()),
                    sorted_cols.end());
  std::vector<int> c0(n);
  for (int v = 0; v < n; ++v)
    c0[v] = (int)(std::lower_bound(sorted_cols.begin(), sorted_cols.end(),
                                   s.init_color[v]) -
                  sorted_cols.begin());
  s.search(std::move(c0), 0);
  for (int v = 0; v < n; ++v) out_perm[v] = s.best_perm[v];
  return 0;
}

}  // extern "C"
