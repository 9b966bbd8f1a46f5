// NSPD per-graph hashing engine.
//
// Computes, for one graph, everything the NSPD kernel's parse stage
// needs (reference grakel/kernels/neighborhood_subgraph_pairwise_distance.py
// :357-445 and grakel/graph.py:1221-1333):
//   * level neighborhoods with the reference's doubling recursion
//     (N[k+1][i] = union of N[k][w] for w in N[k][i]), including the
//     duplicate-keeping sorted N[1] lists,
//   * "distance" pairs D[level] (first level at which j enters i's ball)
//     with the reference's self-loop overwrite quirk (a self-loop puts
//     (i,i) in both D[0] and D[1] and leaves Dist_pair[(i,i)] = 1),
//   * per-source sorted (dist, label) token lists,
//   * the canonical neighborhood encoding per (radius, vertex), hashed
//     as a 64-bit stream over INTEGER token/label codes (label bytes are
//     FNV-hashed once per graph; no per-neighborhood string building).
//     Hash VALUES therefore differ from the reference's ArashPartov
//     string hashes, but the induced feature-identity partition — two
//     neighborhoods collide iff their reference encoding strings are
//     equal — is identical (modulo ~2^-32 hash collisions on either
//     side), so every Gram matches.
//
// Edge iteration order inside an encoding replicates CPython's
// set-iteration order exactly (the reference iterates a set of (i, j)
// tuples, and since the encoding strings contain only LABELS, that
// order is part of cross-vertex feature identity — two neighborhoods
// with the same label content but different edge iteration orders hash
// differently).  PySetEmu below reproduces CPython >= 3.8 64-bit
// semantics: xxPRIME tuple hashing, LINEAR_PROBES=9 open addressing,
// fill*5 >= mask*3 growth to used*4, table-order iteration.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline uint64_t fnv64(const uint8_t *p, size_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < len; ++i) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

inline uint64_t mix64(uint64_t x) {  // splitmix64 finalizer
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// order-dependent 64-bit stream combine
inline void feed(uint64_t &acc, uint64_t x) {
  acc = mix64(acc ^ (x + 0x9E3779B97F4A7C15ULL));
}

// CPython set emulator for distinct (i, j) int-tuple keys.  Stores an
// opaque int32 payload (edge id) per key; iteration = table order.
struct PySetEmu {
  struct Ent {
    uint64_t hash;
    int32_t key;
    bool used;
  };
  std::vector<Ent> table;
  size_t mask = 7, fill = 0, used = 0;

  PySetEmu() { table.assign(8, Ent{0, 0, false}); }
  void reset() {
    table.assign(8, Ent{0, 0, false});
    mask = 7;
    fill = used = 0;
  }
  static inline uint64_t rotl(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
  }
  // CPython tuplehash (Objects/tupleobject.c, >= 3.8, SIZEOF_PY_UHASH_T
  // == 8) of (a, b) where hash(int) == int for small non-negatives.
  static uint64_t tuple_hash(uint64_t a, uint64_t b) {
    const uint64_t P1 = 11400714785074694791ULL;
    const uint64_t P2 = 14029467366897019727ULL;
    const uint64_t P5 = 2870177450012600261ULL;
    uint64_t acc = P5;
    acc += a * P2;
    acc = rotl(acc, 31);
    acc *= P1;
    acc += b * P2;
    acc = rotl(acc, 31);
    acc *= P1;
    acc += 2ULL ^ (P5 ^ 3527539ULL);
    if (acc == (uint64_t)-1) acc = 1546275796ULL;
    return acc;
  }
  static void insert_clean(std::vector<Ent> &tab, size_t msk,
                           uint64_t hash, int32_t key) {
    size_t perturb = hash, i = hash & msk;
    while (true) {
      Ent *e = &tab[i];
      if (!e->used) {
        *e = Ent{hash, key, true};
        return;
      }
      if (i + 9 <= msk) {
        for (int j = 0; j < 9; ++j) {
          ++e;
          if (!e->used) {
            *e = Ent{hash, key, true};
            return;
          }
        }
      }
      perturb >>= 5;
      i = (i * 5 + 1 + perturb) & msk;
    }
  }
  void resize(size_t minused) {
    size_t newsize = 8;
    while (newsize <= minused) newsize <<= 1;
    std::vector<Ent> old;
    old.swap(table);
    table.assign(newsize, Ent{0, 0, false});
    size_t oldmask = mask;
    mask = newsize - 1;
    fill = used;
    for (size_t j = 0; j <= oldmask; ++j)
      if (old[j].used) insert_clean(table, mask, old[j].hash, old[j].key);
  }
  void add(uint64_t hash, int32_t key) {  // keys assumed distinct tuples
    size_t i = hash & mask, perturb = hash;
    while (true) {
      size_t probes = (i + 9 <= mask) ? 9 : 0;
      Ent *e = &table[i];
      do {
        if (!e->used) {
          *e = Ent{hash, key, true};
          ++fill;
          ++used;
          if (fill * 5 >= mask * 3)
            resize(used > 50000 ? used * 2 : used * 4);
          return;
        }
        if (e->hash == hash && e->key == key) return;
        ++e;
      } while (probes--);
      perturb >>= 5;
      i = (i * 5 + 1 + perturb) & mask;
    }
  }
  template <typename F>
  void for_each(F f) const {  // table order == CPython iteration order
    for (size_t j = 0; j <= mask; ++j)
      if (table[j].used) f(table[j].key);
  }
};

struct Bits {
  std::vector<uint64_t> w;
  int nw;
  explicit Bits(int n) : w((n + 63) / 64, 0), nw((n + 63) / 64) {}
  inline void set(int i) { w[i >> 6] |= (uint64_t)1 << (i & 63); }
  inline bool get(int i) const {
    return (w[i >> 6] >> (i & 63)) & 1;
  }
  inline void clear() { std::fill(w.begin(), w.end(), 0); }
  inline void orin(const Bits &o) {
    for (int k = 0; k < nw; ++k) w[k] |= o.w[k];
  }
};

}  // namespace

extern "C" {

// Returns the number of (A, B, level) distance triples written, or -1
// if `cap` was too small.  out_hash is indexed [radius * n + v].
long nspd_hash_graph(
    int n, int R, int D,
    long ne_raw, const int32_t *raw_src, const int32_t *raw_dst,
    long ne, const int32_t *esrc, const int32_t *edst,  // sorted unique
    const uint8_t *vl_bytes, const int64_t *vl_offs,    // n+1 offsets
    const uint8_t *el_bytes, const int64_t *el_offs,    // ne+1 offsets
    uint32_t *out_hash, long cap, int32_t *out_pa, int32_t *out_pb,
    int32_t *out_pd) {
  const int maxlev = std::max(R, D);
  long np_out = 0;
  auto emit = [&](int a, int b, int lev) -> bool {
    if (np_out >= cap) return false;
    out_pa[np_out] = a;
    out_pb[np_out] = b;
    out_pd[np_out] = lev;
    ++np_out;
    return true;
  };

  // ---- neighbor lists from the RAW edge arrays (duplicates kept,
  //      matching Graph.neighbors + N[1][i] = sorted([i] + ns)) -------- //
  std::vector<std::vector<int>> n1(n);
  for (int i = 0; i < n; ++i) n1[i].push_back(i);
  for (long e = 0; e < ne_raw; ++e) n1[raw_src[e]].push_back(raw_dst[e]);
  for (int i = 0; i < n; ++i) std::sort(n1[i].begin(), n1[i].end());

  // ---- level balls as bitmasks + distance pairs --------------------- //
  // dist[i*n+j]: final Dist_pair value (later levels overwrite, which
  // only matters for the self-loop (i,i) 0 -> 1 case).
  std::vector<int8_t> dist((size_t)n * n, -1);
  for (int i = 0; i < n; ++i) {
    dist[(size_t)i * n + i] = 0;
    if (!emit(i, i, 0)) return -1;
  }
  // NOTE: the reference computes NOTHING past level 0 when r == 0 —
  // the whole level>=1 block sits under `if r > 0` (graph.py:1264),
  // even when d >= 1.  Replicate that gate exactly.
  std::vector<Bits> cur, nxt;
  cur.reserve(n);
  for (int i = 0; i < n; ++i) cur.emplace_back(n);
  if (R >= 1) {
    for (int i = 0; i < n; ++i) {
      for (int v : n1[i]) cur[i].set(v);
      if (D >= 1) {
        // D[1] = {(i, j) : j in set(ns)}; may re-emit (i,i) on self-loop
        bool self_loop = false;
        for (size_t k = 1; k < n1[i].size(); ++k)
          if (n1[i][k] == i && n1[i][k - 1] == i) self_loop = true;
        for (int j = 0; j < n; ++j)
          if (cur[i].get(j) && (j != i || self_loop)) {
            dist[(size_t)i * n + j] = 1;
            if (!emit(i, j, 1)) return -1;
          }
      }
    }
  }
  // ball_lists[r][v] for r in 0..R (encodings); r>=2 are duplicate-free
  std::vector<std::vector<std::vector<int>>> ball(R + 1);
  if (R >= 0) {
    ball[0].resize(n);
    for (int i = 0; i < n; ++i) ball[0][i] = {i};
  }
  if (R >= 1) ball[1] = n1;
  std::vector<Bits> ballmask1 = cur;  // radius-1 masks (after level 1)

  for (int i = 0; i < n; ++i) nxt.emplace_back(n);
  for (int level = 1; R >= 1 && level < maxlev; ++level) {
    for (int i = 0; i < n; ++i) {
      nxt[i].clear();
      for (int w = 0; w < n; ++w)
        if (cur[i].get(w)) nxt[i].orin(cur[w]);
    }
    if (level <= D - 1) {
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          if (nxt[i].get(j) && !cur[i].get(j)) {
            dist[(size_t)i * n + j] = (int8_t)(level + 1);
            if (!emit(i, j, level + 1)) return -1;
          }
    }
    std::swap(cur, nxt);
    if (level + 1 <= R) {
      ball[level + 1].resize(n);
      for (int i = 0; i < n; ++i) {
        auto &lst = ball[level + 1][i];
        for (int j = 0; j < n; ++j)
          if (cur[i].get(j)) lst.push_back(j);
      }
    }
  }

  // ---- per-source sorted integer token lists -------------------------- //
  // reference token = str(dist) + "," + vl[j], sorted lexicographically;
  // any total order that is a function of the (dist, label) multiset
  // yields the same equality relation on label contents, so tokens sort
  // by (dist, fnv64(label-bytes)) instead — no strings.
  std::vector<uint64_t> vh(n);
  for (int j = 0; j < n; ++j)
    vh[j] = fnv64(vl_bytes + vl_offs[j],
                  (size_t)(vl_offs[j + 1] - vl_offs[j]));
  struct Tok {
    int32_t d;
    int32_t j;
    uint64_t vh;
    uint64_t code;  // mix of (d, vh): the token's stream contribution
    bool operator<(const Tok &o) const {
      return d != o.d ? d < o.d : vh < o.vh;
    }
  };
  std::vector<std::vector<Tok>> toks(n);
  for (int i = 0; i < n; ++i) {
    auto &t = toks[i];
    for (int j = 0; j < n; ++j) {
      int dv = dist[(size_t)i * n + j];
      if (dv < 0) continue;
      t.push_back(Tok{dv, j, vh[j],
                      mix64((uint64_t)dv * 0xD6E8FEB86659FD93ULL ^ vh[j])});
    }
    std::sort(t.begin(), t.end());
  }

  // ---- encodings ----------------------------------------------------- //
  std::vector<uint64_t> ehash(ne), elh(ne);
  for (long e = 0; e < ne; ++e) {
    ehash[e] = PySetEmu::tuple_hash((uint64_t)esrc[e], (uint64_t)edst[e]);
    elh[e] = fnv64(el_bytes + el_offs[e],
                   (size_t)(el_offs[e + 1] - el_offs[e]));
  }
  std::vector<uint64_t> label(n);  // 64-bit code of the sv-filtered label
  std::vector<int64_t> label_gen(n, -1);
  PySetEmu re, re_next;
  int64_t gen = 0;
  Bits sv(n);
  const uint64_t SECTION = 0xA5A5A5A55A5A5A5AULL;
  for (int v = 0; v < n; ++v) {
    bool first_radius = true;
    for (int radius = R; radius >= 0; --radius, ++gen) {
      const std::vector<int> &verts =
          (radius == 0) ? ball[0][v] : ball[radius][v];
      sv.clear();
      for (int i : verts) sv.set(i);
      // re = {(i, j) for (i, j) in re if i in sv and j in sv} — a fresh
      // CPython set built by inserting in the previous set's iteration
      // order (the sorted `sel` list on the first radius)
      re_next.reset();
      if (first_radius) {
        for (long e = 0; e < ne; ++e)
          if (sv.get(esrc[e]) && sv.get(edst[e]))
            re_next.add(ehash[e], (int32_t)e);
        first_radius = false;
      } else {
        re.for_each([&](int32_t e) {
          if (sv.get(esrc[e]) && sv.get(edst[e]))
            re_next.add(ehash[e], e);
        });
      }
      std::swap(re, re_next);
      // vertex label codes within sv (polynomial over sorted tokens,
      // memoized per generation)
      uint64_t acc = 0x243F6A8885A308D3ULL;
      for (size_t k = 0; k < verts.size(); ++k) {
        int i = verts[k];
        if (label_gen[i] != gen) {
          label_gen[i] = gen;
          uint64_t L = 0xCBF29CE484222325ULL;
          for (const Tok &t : toks[i])
            if (sv.get(t.j)) L = (L ^ t.code) * 0x100000001B3ULL;
          label[i] = L;
        }
        feed(acc, label[i]);
      }
      feed(acc, SECTION);
      re.for_each([&](int32_t e) {
        feed(acc, label[esrc[e]]);
        feed(acc, label[edst[e]]);
        feed(acc, elh[e]);
      });
      out_hash[(size_t)radius * n + v] = (uint32_t)(acc ^ (acc >> 32));
    }
  }
  return np_out;
}

}  // extern "C"
