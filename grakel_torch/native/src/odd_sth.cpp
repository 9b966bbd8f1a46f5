// ODD-STh decomposition engine.
//
// Semantics mirror the reference's pure-Python pipeline
// (reference grakel/kernels/odd_sth.py:263-608) and the Python fallback in
// grakel_tpu/kernels/odd_sth.py:
//   * per vertex v: BFS DAG rooted at v — children(u) = neighbors one BFS
//     level deeper, depth-capped at h (odd_sth.py:333-376);
//   * inverse-topological (Kahn) ordering popping a (label, insertion)
//     min-heap — exactly the reference's "re-sort queue by label before
//     every pop" order (odd_sth.py:379-457);
//   * bottom-up canonical subtree identity over (label, children ordered
//     by the Kahn ordering) — here a 128-bit fingerprint instead of the
//     reference's nested ID strings (odd_sth.py:460-511), so identity
//     survives across calls (fit vs transform) without string interning;
//   * per-graph counts merged by fingerprint, then appended to a global
//     first-appearance table whose inserting frequency is the C weight
//     (odd_sth.py:514-608, position-0 quirk at :604).
//
// Performance structure (REDDIT-scale graphs produce ~n^2 fingerprints
// per graph — the measured hot path):
//   * roots are decomposed in parallel (OpenMP), each root writing its
//     pop-ordered fingerprint list into its own slot, so the downstream
//     counting pass iterates a DETERMINISTIC order independent of the
//     thread schedule;
//   * all count/identity tables are open-addressing linear-probe maps
//     (std::unordered_map's node allocations measured ~4x slower);
//   * Kahn heap items pack (insertion, vertex) into one uint64 so the
//     heap moves 16-byte PODs.
//
// One call decomposes a whole batch of graphs; outputs are malloc'd and
// released with odd_sth_free.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Key128 {
    uint64_t a, b;
    bool operator==(const Key128 &o) const { return a == o.a && b == o.b; }
};

static inline uint64_t fmix64(uint64_t x) {
    x ^= x >> 33; x *= 0xFF51AFD7ED558CCDULL;
    x ^= x >> 33; x *= 0xC4CEB9FE1A85EC53ULL;
    x ^= x >> 33; return x;
}

static inline void mix(Key128 &k, uint64_t x) {
    k.a = fmix64(k.a ^ x);
    k.b = (k.b ^ x) * 0xC6A4A7935BD1E995ULL + 0x2545F4914F6CDD1DULL;
}

// open-addressing linear-probe map Key128 -> long long
struct FlatMap {
    std::vector<Key128> keys;
    std::vector<long long> vals;
    std::vector<uint8_t> used;
    size_t mask = 0, cnt = 0;

    void init(size_t want) {
        size_t cap = 64;
        while (cap < want * 2) cap <<= 1;
        keys.assign(cap, Key128{0, 0});
        vals.assign(cap, 0);
        used.assign(cap, 0);
        mask = cap - 1;
        cnt = 0;
    }

    void grow() {
        FlatMap nm;
        nm.init(keys.size());  // doubles (init uses want*2)
        for (size_t i = 0; i < keys.size(); ++i)
            if (used[i]) *nm.probe(keys[i]) = vals[i];
        nm.cnt = cnt;
        *this = std::move(nm);
    }

    // returns pointer to the value slot, inserting 0 if absent
    long long *probe(const Key128 &k) {
        size_t i = (size_t)(k.a ^ (k.b * 0x9E3779B97F4A7C15ULL)) & mask;
        for (;; i = (i + 1) & mask) {
            if (!used[i]) {
                if (cnt * 2 >= keys.size()) { grow(); return probe(k); }
                used[i] = 1;
                keys[i] = k;
                vals[i] = 0;
                ++cnt;
                return &vals[i];
            }
            if (keys[i] == k) return &vals[i];
        }
    }

    // find without insert; returns nullptr if absent
    long long *find(const Key128 &k) {
        if (mask == 0) return nullptr;
        size_t i = (size_t)(k.a ^ (k.b * 0x9E3779B97F4A7C15ULL)) & mask;
        for (;; i = (i + 1) & mask) {
            if (!used[i]) return nullptr;
            if (keys[i] == k) return &vals[i];
        }
    }
};

template <typename T>
static T *dup(const std::vector<T> &v) {
    T *p = (T *)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(T));
    if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(T));
    return p;
}

struct Scratch {
    std::vector<int> level, bfs, indeg, kahn, ord;
    std::vector<std::vector<int>> kids;
    std::vector<Key128> fp;
    std::vector<std::vector<int>> buckets;  // label-rank FIFO queues
    std::vector<size_t> heads;

    void ensure(int n) {
        if ((int)level.size() < n) {
            level.resize(n);
            bfs.resize(n);
            indeg.resize(n);
            kahn.resize(n);
            ord.resize(n);
            kids.resize(n);
            fp.resize(n);
        }
    }

    void ensure_buckets(int k) {
        if ((int)buckets.size() < k) {
            buckets.resize(k);
            heads.resize(k);
        }
    }
};

}  // namespace

extern "C" {

// node_off:  int64[n_graphs+1]   per-graph vertex offsets (global space)
// adj_off:   int64[total_nodes+1] CSR row offsets into adj
// adj:       int32[total_adj]     neighbor lists, LOCAL vertex indices
// labels:    int64[total_nodes]   order-preserving label codes (drive the
//            Kahn heap comparisons; batch-local is fine)
// ids:       int64[total_nodes]    stable label identity codes (mixed into
//            the fingerprints; must be identical across fit/transform)
// h:         BFS depth cap; < 0 means unbounded
// Returns the number of distinct subtrees (table rows), or -1 on error.
long odd_sth_decompose(
    int n_graphs, const long long *node_off, const long long *adj_off,
    const int *adj, const long long *labels, const long long *ids, int h,
    unsigned long long **out_ha, unsigned long long **out_hb,
    long long **out_C,
    int **out_node, int **out_graph, long long **out_freq,
    long long *out_nnz) {
    const int depth_cap = h < 0 ? INT32_MAX : h;

    FlatMap table;  // key -> row
    table.init(1 << 12);
    std::vector<unsigned long long> ha, hb;
    std::vector<long long> Cw;
    std::vector<int> coo_node, coo_graph;
    std::vector<long long> coo_freq;

    std::vector<std::vector<Key128>> root_fps;
    std::vector<Scratch> scratch;
#ifdef _OPENMP
    scratch.resize(omp_get_max_threads());
#else
    scratch.resize(1);
#endif
    FlatMap gcount;

    for (int g = 0; g < n_graphs; ++g) {
        const long long base = node_off[g];
        const int n = (int)(node_off[g + 1] - base);
        if (n <= 0) continue;

        if ((int)root_fps.size() < n) root_fps.resize(n);

        // dense per-graph label ranks: with <= 64 distinct labels the
        // Kahn queue becomes k FIFO buckets + a non-empty bitmask
        // (lowest set bit = next label) — O(1) per push/pop versus the
        // heap's O(log n) tuple moves, and insertion order within a
        // label is FIFO exactly as (label, insertion) requires
        std::vector<long long> lsort(labels + base, labels + base + n);
        std::sort(lsort.begin(), lsort.end());
        lsort.erase(std::unique(lsort.begin(), lsort.end()), lsort.end());
        const int n_lab = (int)lsort.size();
        const bool bucketed = n_lab <= 64;
        std::vector<int> vrank(n);
        if (bucketed)
            for (int v = 0; v < n; ++v)
                vrank[v] = (int)(std::lower_bound(lsort.begin(),
                                                  lsort.end(),
                                                  labels[base + v])
                                 - lsort.begin());

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
        for (int root = 0; root < n; ++root) {
#ifdef _OPENMP
            Scratch &sc = scratch[omp_get_thread_num()];
#else
            Scratch &sc = scratch[0];
#endif
            sc.ensure(n);
            std::vector<int> &level = sc.level;
            std::vector<int> &bfs = sc.bfs;
            std::vector<int> &indeg = sc.indeg;
            std::vector<int> &kahn = sc.kahn;
            std::vector<int> &ord = sc.ord;
            std::vector<std::vector<int>> &kids = sc.kids;
            std::vector<Key128> &fp = sc.fp;

            // ---- BFS DAG (children = one level deeper) ----
            std::fill(level.begin(), level.begin() + n, -1);
            int head = 0, tail = 0;
            bfs[tail++] = root;
            level[root] = 0;
            int n_dag = 1;
            while (head < tail) {
                const int u = bfs[head++];
                const int lu = level[u];
                kids[u].clear();
                if (lu == depth_cap) break;
                const long long a0 = adj_off[base + u];
                const long long a1 = adj_off[base + u + 1];
                for (long long e = a0; e < a1; ++e) {
                    const int w = adj[e];
                    if (level[w] < 0) {
                        level[w] = lu + 1;
                        kids[u].push_back(w);
                        bfs[tail++] = w;
                        ++n_dag;
                    } else if (level[w] == lu + 1) {
                        kids[u].push_back(w);
                    }
                }
            }
            // nodes never popped (queue drained early by the depth cap)
            // keep whatever kids were assigned; unpopped ones get none
            for (int qi = head; qi < tail; ++qi) kids[bfs[qi]].clear();

            // ---- Kahn with (label, insertion) min order ----
            for (int i = 0; i < tail; ++i) indeg[bfs[i]] = 0;
            for (int i = 0; i < tail; ++i)
                for (int c : kids[bfs[i]]) ++indeg[c];
            int popped = 0, visited = n_dag;
            if (bucketed) {
                sc.ensure_buckets(n_lab);
                for (int r = 0; r < n_lab; ++r) {
                    sc.buckets[r].clear();
                    sc.heads[r] = 0;
                }
                uint64_t nonempty = 0;
                for (int i = 0; i < tail; ++i) {
                    const int v = bfs[i];
                    if (indeg[v] == 0) {
                        const int r = vrank[v];
                        sc.buckets[r].push_back(v);
                        nonempty |= 1ULL << r;
                    }
                }
                while (nonempty) {
                    const int r = __builtin_ctzll(nonempty);
                    const int e = sc.buckets[r][sc.heads[r]++];
                    if (sc.heads[r] == sc.buckets[r].size()) {
                        sc.buckets[r].clear();
                        sc.heads[r] = 0;
                        nonempty &= ~(1ULL << r);
                    }
                    kahn[popped++] = e;
                    ord[e] = visited--;
                    for (int c : kids[e]) {
                        if (--indeg[c] == 0) {
                            const int rc = vrank[c];
                            sc.buckets[rc].push_back(c);
                            nonempty |= 1ULL << rc;
                        }
                    }
                }
            } else {
                // wide alphabets: (label, (insertion << 32) | vertex)
                // heap; unique insertion counters keep the packed low
                // word from ever changing the (label, insertion) order
                using Item = std::pair<long long, unsigned long long>;
                std::priority_queue<Item, std::vector<Item>,
                                    std::greater<Item>> heap;
                unsigned long long cnt = 0;
                for (int i = 0; i < tail; ++i) {
                    const int v = bfs[i];
                    if (indeg[v] == 0)
                        heap.emplace(labels[base + v],
                                     (cnt++ << 32) | (unsigned)v);
                }
                while (!heap.empty()) {
                    const int e = (int)(heap.top().second & 0xFFFFFFFFu);
                    heap.pop();
                    kahn[popped++] = e;
                    ord[e] = visited--;
                    for (int c : kids[e]) {
                        if (--indeg[c] == 0)
                            heap.emplace(labels[base + c],
                                         (cnt++ << 32) | (unsigned)c);
                    }
                }
            }

            // ---- bottom-up fingerprints, children ordered by (ord,
            // label) — ord is a bijection so it alone decides ----
            std::vector<Key128> &out = root_fps[root];
            out.clear();
            out.reserve(popped);
            for (int i = popped - 1; i >= 0; --i) {
                const int v = kahn[i];
                std::sort(kids[v].begin(), kids[v].end(),
                          [&](int x, int y) { return ord[x] < ord[y]; });
                Key128 k{0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL};
                mix(k, (uint64_t)ids[base + v]);
                for (int c : kids[v]) {
                    mix(k, fp[c].a);
                    mix(k, fp[c].b);
                }
                if (!kids[v].empty()) mix(k, 0x510E527FADE682D1ULL);
                fp[v] = k;
                out.push_back(k);
            }
        }

        // ---- per-graph counts in deterministic (root, pop) order ----
        size_t total = 0;
        for (int root = 0; root < n; ++root) total += root_fps[root].size();
        gcount.init(total);
        for (int root = 0; root < n; ++root)
            for (const Key128 &k : root_fps[root]) ++*gcount.probe(k);
        // second pass appends each key once, in first-seen order —
        // deterministic regardless of the thread schedule above
        FlatMap seen;
        seen.init(gcount.cnt);
        for (int root = 0; root < n; ++root)
            for (const Key128 &k : root_fps[root]) {
                long long *s = seen.probe(k);
                if (*s != 0) continue;
                *s = 1;
                const long long freq = *gcount.find(k);
                long long row;
                long long *t = table.find(k);
                if (t == nullptr) {
                    row = (long long)ha.size();
                    *table.probe(k) = row;
                    ha.push_back(k.a);
                    hb.push_back(k.b);
                    Cw.push_back(freq);  // inserting freq == C
                } else {
                    row = *t;
                }
                coo_node.push_back((int)row);
                coo_graph.push_back(g);
                coo_freq.push_back(freq);
            }
    }

    *out_ha = dup(ha);
    *out_hb = dup(hb);
    *out_C = dup(Cw);
    *out_node = dup(coo_node);
    *out_graph = dup(coo_graph);
    *out_freq = dup(coo_freq);
    *out_nnz = (long long)coo_node.size();
    return (long long)ha.size();
}

void odd_sth_free(void *p) { std::free(p); }

}  // extern "C"
