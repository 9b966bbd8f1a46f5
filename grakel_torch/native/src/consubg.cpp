// Exhaustive enumeration of connected k-vertex subsets (ESU, Wernicke
// 2006) — the native equivalent of the reference's ConSubg
// (_c_functions/functions.pyx:177-281, Karakashian 2013).  Each
// connected k-subset is emitted exactly once.
//
// consubg(n, offs, adj, k, &out) returns the number of subsets and
// allocates *out with k int32 vertex ids per subset (caller frees with
// consubg_free).
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Ctx {
    int k;
    const int* offs;
    const int* adj;
    std::vector<char> mark;   // in subgraph or neighbor-of-subgraph
    std::vector<int> sub;
    std::vector<int> out;
};

void extend(Ctx& c, std::vector<int>& ext, int root) {
    if ((int)c.sub.size() == c.k) {
        c.out.insert(c.out.end(), c.sub.begin(), c.sub.end());
        return;
    }
    while (!ext.empty()) {
        const int w = ext.back();
        ext.pop_back();
        std::vector<int> next = ext;
        std::vector<int> undo;
        for (int i = c.offs[w]; i < c.offs[w + 1]; ++i) {
            const int u = c.adj[i];
            if (u > root && !c.mark[u]) {
                c.mark[u] = 1;
                undo.push_back(u);
                next.push_back(u);
            }
        }
        c.sub.push_back(w);
        extend(c, next, root);
        c.sub.pop_back();
        for (int u : undo) c.mark[u] = 0;
    }
}

}  // namespace

extern "C" long consubg(int n, const int* offs, const int* adj, int k,
                        int** out) {
    Ctx c;
    c.k = k;
    c.offs = offs;
    c.adj = adj;
    c.mark.assign(n, 0);
    if (k >= 1) {
        for (int v = 0; v < n; ++v) {
            std::vector<int> ext;
            c.mark[v] = 1;
            std::vector<int> undo;
            for (int i = offs[v]; i < offs[v + 1]; ++i) {
                const int u = adj[i];
                if (u > v && !c.mark[u]) {
                    c.mark[u] = 1;
                    undo.push_back(u);
                    ext.push_back(u);
                }
            }
            c.sub.assign(1, v);
            extend(c, ext, v);
            for (int u : undo) c.mark[u] = 0;
            c.mark[v] = 0;
        }
    }
    const long count = (long)(k ? c.out.size() / k : 0);
    int* buf = (int*)std::malloc(c.out.size() * sizeof(int) + 1);
    std::memcpy(buf, c.out.data(), c.out.size() * sizeof(int));
    *out = buf;
    return count;
}

extern "C" void consubg_free(int* p) { std::free(p); }
