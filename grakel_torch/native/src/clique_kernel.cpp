// Weighted connected-clique value accumulation over a product graph —
// the native core of the SubgraphMatching kernel.
//
// Functional equivalent of the reference's sm_core
// (grakel/kernels/_c_functions/src/sm_core.cpp:18-113): enumerate every
// clique of the weighted product graph that is reachable by attaching
// each new vertex through a POSITIVE (c-)edge, where candidates attached
// so far only through negative (d-)edges are deferred until a positive
// edge appears; accumulate per-size sums of
//   prod(vertex costs) * prod(|edge weights|).
//
// Candidate bookkeeping uses two explicit vectors (P = positively
// reachable now, D = deferred d-edge-only) instead of the reference's
// in-place pivoted index array; the enumerated clique set and the
// accumulated values are identical.

#include <cmath>
#include <cstddef>
#include <vector>

namespace {

struct Ctx {
  int nv;
  int kmax;
  const double* cv;
  const double* ce;  // nv * nv row-major
  double* tv;        // kmax + 1 entries; tv[s] sums (s+1)-cliques
};

void expand(const Ctx& ctx, double value, std::vector<int>& clique,
            const std::vector<int>& P, const std::vector<int>& D) {
  for (std::size_t pi = 0; pi < P.size(); ++pi) {
    const int v = P[pi];
    const double* ev = ctx.ce + static_cast<std::size_t>(v) * ctx.nv;
    double val = value * ctx.cv[v];
    for (int m : clique) val *= std::fabs(ev[m]);
    ctx.tv[clique.size()] += val;
    if (static_cast<int>(clique.size()) + 1 < ctx.kmax) {
      std::vector<int> newP, newD;
      newP.reserve(P.size() - pi + D.size());
      for (std::size_t qi = pi + 1; qi < P.size(); ++qi) {
        if (ev[P[qi]] != 0.0) newP.push_back(P[qi]);
      }
      for (int w : D) {
        const double e = ev[w];
        if (e > 0.0) {
          newP.push_back(w);
        } else if (e < 0.0) {
          newD.push_back(w);
        }
      }
      clique.push_back(v);
      expand(ctx, val, clique, newP, newD);
      clique.pop_back();
    }
  }
}

}  // namespace

extern "C" {

void clique_values(int nv, int kmax, const double* cv, const double* ce,
                   double* tv) {
  Ctx ctx{nv, kmax, cv, ce, tv};
  std::vector<int> clique;
  for (int i = 0; i < nv; ++i) {
    tv[0] += cv[i];
    if (kmax > 1) {
      const double* ei = ce + static_cast<std::size_t>(i) * nv;
      std::vector<int> P, D;
      for (int j = i + 1; j < nv; ++j) {
        if (ei[j] > 0.0) {
          P.push_back(j);
        } else if (ei[j] < 0.0) {
          D.push_back(j);
        }
      }
      clique.push_back(i);
      expand(ctx, ctx.cv[i], clique, P, D);
      clique.pop_back();
    }
  }
}

}  // extern "C"
