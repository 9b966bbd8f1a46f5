"""Subgraph matching kernel (Kriege & Mutzel 2012).

The counterpart of ``grakel_tpu/kernels/subgraph_matching.py``.
Reference semantics (grakel/kernels/subgraph_matching.py +
_c_functions/functions.pyx:28-162 + src/sm_core.cpp):

* weighted product graph of a pair (x, y): vertices = label-compatible
  pairs with cost kv(Lx_i, Ly_j) != 0; edges between (i, j), (i2, j2)
  with i != i2, j != j2: ke value when BOTH graphs have the edge
  (c-edge), -1 when NEITHER has it (d-edge), 0 otherwise;
* native clique enumeration accumulates per-size sums of
  prod(vertex costs) * prod(|edge weights|) for cliques grown through
  positive edges (grakel_torch.native.clique_values);
* kernel value = lambda-weight vector (uniform / increasing /
  decreasing / strong_decreasing / iterable / callable over sizes
  0..k) dotted with the per-size sums.

For the default dirac kv/ke the product-graph construction is fully
vectorized in numpy (label-id equality outer products) instead of the
reference's O(nv^2) Python loop; custom callables use the loop.

The kernel runs on the host (the base class's pairwise loop over the
native clique enumeration); its entry points still follow the device
rule: they raise without a card unless the CPU is asked for.
"""

from __future__ import annotations

from numbers import Real

import numpy as np

from .base import Kernel, normalize_input
from ..native import clique_values

__all__ = ["SubgraphMatching"]


def _dirac(a, b):
    return int(a == b)


class SubgraphMatching(Kernel):
    """Subgraph matching kernel."""

    def __init__(self, n_jobs=None, verbose=False, normalize=False,
                 k=5, kv=_dirac, ke=_dirac, lw="uniform"):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.k = k
        self.kv = kv
        self.ke = ke
        self.lw = lw

    def initialize(self):
        if not isinstance(self.k, int) or self.k < 1:
            raise TypeError("'k' must be a positive integer")
        if not callable(self.kv) and self.kv is not None:
            raise TypeError("kv must be callable or None")
        if not callable(self.ke) and self.ke is not None:
            raise TypeError("ke must be callable or None")
        k = self.k + 1
        lw = self.lw
        not_str_iter = not isinstance(lw, str) and hasattr(lw, "__iter__")
        if not_str_iter:
            lw = list(lw)
        if (not_str_iter and len(lw) == self.k
                and all(isinstance(x, Real) for x in lw)):
            self.lambdas_ = np.array(lw).reshape((1, k))
        elif lw == "uniform":
            self.lambdas_ = np.full((1, k), 1.0)
        elif lw == "increasing":
            self.lambdas_ = np.arange(1.0, float(k) + 1.0).reshape(1, k)
        elif lw == "decreasing":
            self.lambdas_ = 1.0 / np.arange(1.0, float(k) + 1.0
                                            ).reshape(1, k)
        elif lw == "strong_decreasing":
            self.lambdas_ = 1.0 / np.square(
                np.arange(1.0, float(k) + 1.0)).reshape(1, k)
        elif callable(lw):
            try:
                self.lambdas_ = np.array(
                    [lw(i) for i in range(k)]).reshape((1, k))
            except Exception as e:
                raise TypeError("Incorrect Callable: " + str(e))
        else:
            raise TypeError(
                'lw can either be str with values "uniform", "increasing", '
                '"decreasing", "strong_decreasing" or an iterable of k+1 '
                "elements or a callable of one integer argument.")

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs = normalize_input(X)
        out = []
        for g in graphs:
            L = g.get_labels(label_type="vertex",
                             return_none=(self.kv is None))
            Le = g.get_labels(label_type="edge",
                              return_none=(self.ke is None))
            Er = {(int(a), int(b))
                  for a, b in zip(g.senders, g.receivers) if a != b}
            out.append((g.n, Er, L, Le))
        return out

    # ------------------------------------------------------------------ #
    def _product_graph(self, x, y):
        """-> (cv [nv], ce [nv, nv]) of the weighted product graph."""
        nx_, Ex, Lx, Lex = x
        ny_, Ey, Ly, Ley = y
        kv, ke = self.kv, self.ke
        dirac_v = kv is _dirac
        dirac_e = ke is _dirac

        if kv is None:
            ai, bi = np.meshgrid(np.arange(nx_), np.arange(ny_),
                                 indexing="ij")
            ai, bi = ai.ravel(), bi.ravel()
            cv = np.ones(ai.shape[0])
        else:
            if dirac_v:
                enum = {}
                ix = np.array([enum.setdefault(Lx[i], len(enum))
                               for i in range(nx_)])
                iy = np.array([enum.setdefault(Ly[j], len(enum))
                               for j in range(ny_)])
                M = (ix[:, None] == iy[None, :]).astype(float)
            else:
                M = np.array([[kv(Lx[i], Ly[j]) for j in range(ny_)]
                              for i in range(nx_)], dtype=float)
            ai, bi = np.nonzero(M)
            cv = M[ai, bi]

        nv = ai.shape[0]
        # adjacency indicators of the two graphs
        Ax = np.zeros((nx_, nx_), bool)
        for (a, b) in Ex:
            Ax[a, b] = True
        Ay = np.zeros((ny_, ny_), bool)
        for (a, b) in Ey:
            Ay[a, b] = True
        ex = Ax[ai[:, None], ai[None, :]]
        ey = Ay[bi[:, None], bi[None, :]]
        same = (ai[:, None] == ai[None, :]) | (bi[:, None] == bi[None, :])

        if ke is None:
            kevals = np.ones((nv, nv))
        elif dirac_e:
            eenum = {}
            Ixe = np.zeros((nx_, nx_), np.int64)
            for (a, b) in Ex:
                Ixe[a, b] = eenum.setdefault(Lex[(a, b)], len(eenum)) + 1
            Iye = np.zeros((ny_, ny_), np.int64)
            for (a, b) in Ey:
                lab = Ley.get((a, b))
                Iye[a, b] = (eenum[lab] + 1 if lab in eenum else -1)
            ie_x = Ixe[ai[:, None], ai[None, :]]
            ie_y = Iye[bi[:, None], bi[None, :]]
            kevals = (ie_x == ie_y).astype(float)
        else:
            kevals = None  # computed lazily below

        ce = np.zeros((nv, nv))
        both = ex & ey & ~same
        neither = ~ex & ~ey & ~same
        ce[neither] = -1.0
        if kevals is not None:
            ce[both] = kevals[both]
        else:
            ii, jj = np.nonzero(both)
            for a, b in zip(ii, jj):
                ea = (ai[a], ai[b])
                eb = (bi[a], bi[b])
                try:
                    ce[a, b] = self.ke(Lex[ea], Ley[eb])
                except KeyError as key_error:
                    raise KeyError(str(key_error) +
                                   "\nEdge labels must exist for all edges.")
        return cv, ce

    def pairwise_operation(self, x, y):
        cv, ce = self._product_graph(x, y)
        tv = clique_values(cv, ce, self.k)
        return float(np.dot(self.lambdas_, tv)[0])
