// Unit-weight all-pairs shortest-path triplet counts via batched BFS.
//
// The ShortestPath kernel's feature is the per-graph count of triplets
// (label_u, label_v, d(u, v)) over ordered reachable vertex pairs u != v
// (reference grakel/kernels/shortest_path.py:413-500).  On unit-weight
// graphs d(u, v) is the BFS hop count, so the whole counts stream costs
// O(sum_g n_g * E_g) host work — at REDDIT scale orders of magnitude
// below the padded O(V^3) device Floyd-Warshall per size bucket (the
// 4096-vertex tail buckets of heavy-tailed datasets are VPU-bound there).
//
// Ids use EXACTLY the device encoding (kernels/shortest_path.py
// _direct_ids): id = (label_u * L + label_v) * D + d, so native and
// device count streams are interchangeable in every downstream Gram.
//
// Output is the per-graph aggregated COO stream (graph, id, count) —
// at most L^2 * diameter entries per graph.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// open-addressing linear-probe map int64 -> long long
struct FlatMap64 {
    std::vector<long long> keys, vals;
    std::vector<uint8_t> used;
    size_t mask = 0, cnt = 0;

    void init(size_t want) {
        size_t cap = 64;
        while (cap < want * 2) cap <<= 1;
        keys.assign(cap, 0);
        vals.assign(cap, 0);
        used.assign(cap, 0);
        mask = cap - 1;
        cnt = 0;
    }

    void grow() {
        FlatMap64 nm;
        nm.init(keys.size());
        for (size_t i = 0; i < keys.size(); ++i)
            if (used[i]) *nm.probe(keys[i]) = vals[i];
        nm.cnt = cnt;
        *this = std::move(nm);
    }

    long long *probe(long long k) {
        size_t i = (size_t)(k * 0x9E3779B97F4A7C15ULL) & mask;
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
};

template <typename T>
static T *dup_vec(const std::vector<T> &v) {
    T *p = (T *)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(T));
    if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(T));
    return p;
}

}  // namespace

extern "C" {

// node_off: int64[n_graphs+1] per-graph vertex offsets (global space)
// adj_off:  int64[total_nodes+1] CSR row offsets (directed edges)
// adj:      int32 neighbor lists, LOCAL vertex indices
// labels:   int32[total_nodes] label ids in [0, L)
// L, D:     id-encoding dimensions (id = (lu*L+lv)*D + d, d in [1, D))
// Returns 0, or -1 on a d >= D overflow (caller must size D > diameter).
long long sp_bfs_counts(
    int n_graphs, const long long *node_off, const long long *adj_off,
    const int *adj, const int *labels, long long L, long long D,
    int **out_gid, long long **out_key, long long **out_cnt,
    long long *out_nnz) {
    std::vector<int> coo_gid;
    std::vector<long long> coo_key, coo_cnt;
    int overflow = 0;

#ifdef _OPENMP
    const int n_threads = omp_get_max_threads();
#else
    const int n_threads = 1;
#endif
    std::vector<FlatMap64> tmaps(n_threads);
    std::vector<std::vector<int>> tq(n_threads);
    std::vector<std::vector<int>> tdist(n_threads);

    for (int g = 0; g < n_graphs; ++g) {
        const long long base = node_off[g];
        const int n = (int)(node_off[g + 1] - base);
        if (n <= 0) continue;
        for (int t = 0; t < n_threads; ++t) {
            tmaps[t].init(64);
            if ((int)tq[t].size() < n) {
                tq[t].resize(n);
                tdist[t].resize(n);
            }
        }

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (int s = 0; s < n; ++s) {
#ifdef _OPENMP
            const int tid = omp_get_thread_num();
#else
            const int tid = 0;
#endif
            FlatMap64 &m = tmaps[tid];
            std::vector<int> &q = tq[tid];
            std::vector<int> &dist = tdist[tid];
            std::fill(dist.begin(), dist.begin() + n, -1);
            int head = 0, tail = 0;
            q[tail++] = s;
            dist[s] = 0;
            const long long ls = labels[base + s];
            while (head < tail) {
                const int u = q[head++];
                const int du = dist[u];
                const long long a0 = adj_off[base + u];
                const long long a1 = adj_off[base + u + 1];
                for (long long e = a0; e < a1; ++e) {
                    const int w = adj[e];
                    if (dist[w] < 0) {
                        dist[w] = du + 1;
                        q[tail++] = w;
                        if (du + 1 >= D) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
                            overflow = 1;
                        } else {
                            const long long lt = labels[base + w];
                            *m.probe((ls * L + lt) * D + (du + 1)) += 1;
                        }
                    }
                }
            }
        }
        if (overflow) return -1;
        // merge thread maps deterministically: probe thread 0's map
        FlatMap64 &m0 = tmaps[0];
        for (int t = 1; t < n_threads; ++t) {
            FlatMap64 &mt = tmaps[t];
            for (size_t i = 0; i < mt.keys.size(); ++i)
                if (mt.used[i]) *m0.probe(mt.keys[i]) += mt.vals[i];
        }
        // emit in ascending key order (deterministic across runs)
        std::vector<size_t> slots;
        slots.reserve(m0.cnt);
        for (size_t i = 0; i < m0.keys.size(); ++i)
            if (m0.used[i]) slots.push_back(i);
        std::sort(slots.begin(), slots.end(),
                  [&](size_t a, size_t b) {
                      return m0.keys[a] < m0.keys[b];
                  });
        for (size_t i : slots) {
            coo_gid.push_back(g);
            coo_key.push_back(m0.keys[i]);
            coo_cnt.push_back(m0.vals[i]);
        }
    }

    *out_gid = dup_vec(coo_gid);
    *out_key = dup_vec(coo_key);
    *out_cnt = dup_vec(coo_cnt);
    *out_nnz = (long long)coo_gid.size();
    return 0;
}

void sp_bfs_free(void *p) { std::free(p); }

}  // extern "C"
