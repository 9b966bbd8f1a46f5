"""GraphHopper kernel (Feragen et al. 2013).

The counterpart of ``grakel_tpu/kernels/graph_hopper.py``, on the same
host decomposition (the shortest-path DAG counts are exact integers).

Reference semantics (grakel/kernels/graph_hopper.py):

* per graph, per source j: Dijkstra SSSP (+ predecessor tree); the
  shortest-path DAG of the connected component adds edges from every
  neighbor one step closer to the source AND the Dijkstra-tree parent
  (:139-205);
* ``od_vectors_dag`` DP computes per-node occurrence/descendant vectors
  over generations (:356-421); the per-node weight tensor
  M[v, a, b] = sum_j des_j[v, b-a] * occ_j[v, a] counts "v appears at
  position a of a shortest path of length b" (:224-233);
* pairwise k(x, y) = <M_i M_j^T, nodepair-kernel> with nodepair =
  linear / gaussian(mu) / bridge over node attributes (:239-337), with
  M tensors truncated to the common diameter.

Unweighted graphs take the level-synchronous path-counting recurrences
over all sources at once (exact int64 einsums); weighted graphs the
per-source Dijkstra and DP.  For the (default) linear node kernel the
pairwise value factorizes, k(x, y) = <vec(NA_x^T M_x), vec(NA_y^T
M_y)>, so the Gram is one f64 GEMM over explicit features on the
kernel's device (``ops.gram.gram_gemm`` / ``gram_rect``); its diagonal
stays the untruncated pair loop.  The other node kernels run the host
pair loop, as in the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from numbers import Real

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..graph import dijkstra
from ..ops.gram import gram_gemm, gram_rect

__all__ = ["GraphHopper"]


def od_vectors_dag(dag, dist):
    """Per-node occurrence / descendant path-count vectors of a
    shortest-path DAG (the weighted-graph route).

    ``dag[u, v] = 1`` means u sits one step nearer the source than v.
    Returns ``(occ, des)`` where ``occ[v, a]`` counts the shortest paths
    reaching v from the source in exactly ``a`` hops and ``des[v, c]``
    counts the length-``c`` descending walks leaving v (the reference DP,
    graph_hopper.py:356-421, as one forward push and one backward pull
    over a distance-ordered sweep).
    """
    n = dag.shape[0]
    width = int(np.max(dist + 1))
    order = np.argsort(dist, kind="stable")
    occ = np.zeros((n, width), dtype=int)
    des = np.zeros((n, width), dtype=int)
    occ[order[0], 0] = 1
    des[:, 0] = 1
    # DAG edges strictly increase distance, so ascending-distance order
    # is topological: push hop-shifted path counts source -> leaves ...
    for u in order:
        kids = np.flatnonzero(dag[u])
        if kids.size:
            occ[kids, 1:] += occ[u, :-1]
    # ... and pull descent counts leaves -> source.
    for v in order[::-1]:
        kids = np.flatnonzero(dag[v])
        if kids.size:
            des[v, 1:] = des[kids, :-1].sum(axis=0)
    return occ, des


def linear_kernel(x, y):
    M_i, NA_i = x
    M_j, NA_j = y
    weight = M_i @ M_j.T
    return float(np.dot(weight.ravel(), (NA_i @ NA_j.T).ravel()))


def gaussian_kernel(x, y, mu):
    M_i, NA_i, n2_i = x
    M_j, NA_j, n2_j = y
    weight = M_i @ M_j.T
    lin = NA_i @ NA_j.T
    sqd = ((-2 * lin.T + n2_i).T + n2_j)
    return float(np.dot(weight.ravel(), np.exp(-mu * sqd).ravel()))


def bridge_kernel(x, y):
    M_i, NA_i = x
    M_j, NA_j = y
    weight = M_i @ M_j.T
    NAs = np.vstack([NA_i, NA_j])
    K = NAs @ NAs.T
    dg = K.diagonal().reshape(-1, 1)
    Dm = np.sqrt(np.maximum(dg + dg.T - 2 * K, 0))
    nodepair = (4 - Dm[:NA_i.shape[0], NA_i.shape[0]:]) / 4
    nodepair[nodepair < 0] = 0
    return float(np.dot(weight.ravel(), nodepair.ravel()))


def _hopper_tensor(AM, spm, max_diam):
    """M[v, a, b] for an UNWEIGHTED graph, all sources at once.

    occ[j, v, a] = [d(j,v)=a] * N(j,v) where N counts shortest paths
    (level-synchronous recurrence); des[j, v, c] = number of length-c
    descents of the source-j shortest-path DAG from v:
    DES_c[j, v] = sum_w B[j, v, w] DES_{c-1}[j, w] with
    B[j, v, w] = [AM[w, v] > 0][d(j,w) = d(j,v)+1].  Exactly the
    reference's per-source od_vectors_dag values (graph_hopper.py
    :139-237, :356-421), without the per-source loop.
    """
    n = AM.shape[0]
    finite = np.isfinite(spm)
    di = np.where(finite, spm, -10).astype(np.int64)
    diam = int(di.max()) if finite.any() else 0
    B = ((AM.T > 0)[None, :, :]
         & (di[:, None, :] == di[:, :, None] + 1)).astype(np.int64)
    # shortest-path counts
    N = (di == 0).astype(np.int64)
    for lev in range(1, diam + 1):
        T = np.einsum("ju,juv->jv", N, B)
        N = np.where(di == lev, T, N)
    # descendant-path counts per length
    DES = np.zeros((max_diam, n, n), np.int64)
    DES[0] = 1
    for c in range(1, min(max_diam, diam + 1)):
        DES[c] = np.einsum("jvw,jw->jv", B, DES[c - 1])
    W = N[None, :, :] * DES                      # (c, j, v)
    C = np.zeros((n, max_diam, max_diam))        # C[v, a, c]
    jj, vv = np.nonzero(finite)
    np.add.at(C, (vv, di[jj, vv]), W[:, jj, vv].T)
    return _shift(C, max_diam)


def _shift(C, max_diam):
    """M[v, a, a:] = C[v, a, :max_diam - a]."""
    M = np.zeros((C.shape[0], max_diam, max_diam))
    for a in range(max_diam):
        M[:, a, a:] = C[:, a, :max_diam - a]
    return M


def _weighted_tensor(AM, node_nr, max_diam):
    """M[v, a, b] of a weighted graph: per-source Dijkstra and the
    shortest-path DAG's occurrence / descendant DP (reference
    graph_hopper.py:139-237)."""
    des = np.zeros((node_nr, node_nr, max_diam), dtype=int)
    occ = np.zeros((node_nr, node_nr, max_diam), dtype=int)
    idx_i, idx_j = np.where(AM > 0)
    ed = defaultdict(dict)
    for a, b in zip(idx_i, idx_j):
        if a != b:
            ed[int(a)][int(b)] = AM[a, b]
    for j in range(node_nr):
        D, p = dijkstra(ed, j)
        Dv = np.array([D.get(k, np.inf) for k in range(node_nr)])
        p = dict(p)
        p[j] = -1
        conn = np.where(Dv < np.inf)[0]
        A_cc = np.zeros((conn.size, conn.size))
        AM_cc = AM[conn, :][:, conn]
        D_cc = Dv[conn]
        conv = np.zeros(node_nr + 1, dtype=int)
        for k in range(conn.size):
            conv[conn[k] + 1] = k
        p_cc = np.array([conv[p[int(k)] + 1] for k in conn])
        for v in range(conn.size):
            if p_cc[v] > 0:
                A_cc[p_cc[v], v] = 1
            v_nbs = np.where(AM_cc[v, :] > 0)[0]
            v_parents = v_nbs[D_cc[v_nbs] == (D_cc[v] - 1)]
            A_cc[v_parents, v] = 1
        occ_p, des_p = od_vectors_dag(A_cc, D_cc)
        if des_p.shape[0] == 1 and j == 0:
            des[j, 0, 0] = des_p
            occ[j, 0, 0] = occ_p
        else:
            d_levels = des_p.shape[1]
            des[j, conn, :d_levels] = des_p
            occ[j, conn, :d_levels] = occ_p
    # M[v, a, b] = sum_j occ[j, v, a] * des[j, v, b - a]
    # == C_v[a, b - a] with C_v = occ[:, v, :]^T des[:, v, :]
    return _shift(np.einsum("jva,jvc->vac", occ, des), max_diam)


class GraphHopper(Kernel):
    """GraphHopper kernel over attributed graphs."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 kernel_type="linear"):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.kernel_type = kernel_type

    def initialize(self):
        kt = self.kernel_type
        if isinstance(kt, str):
            if kt == "linear":
                self.metric_ = linear_kernel
                self.calculate_norm_ = False
            elif kt == "gaussian":
                self.metric_ = lambda x, y: gaussian_kernel(x, y, 1)
                self.calculate_norm_ = True
            elif kt == "bridge":
                self.metric_ = bridge_kernel
                self.calculate_norm_ = False
            else:
                raise ValueError('Unsupported kernel with name "%s"' % kt)
        elif (isinstance(kt, tuple) and len(kt) == 2
                and kt[0] == "gaussian" and isinstance(kt[1], Real)):
            self.metric_ = lambda x, y: gaussian_kernel(x, y, kt[1])
            self.calculate_norm_ = True
        elif callable(kt):
            self.metric_ = kt
            self.calculate_norm_ = False
        else:
            raise TypeError('Unrecognized "kernel_type"')

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs_in = normalize_input(X)
        graphs, diam = [], []
        for g in graphs_in:
            spm, _ = g.build_shortest_path_matrix()
            labs = g.get_labels(label_type="vertex", return_none=True)
            if labs is None:
                raise ValueError("GraphHopper requires node attributes")
            try:
                attributes = np.array([labs[j] for j in range(g.n)],
                                      dtype=float)
            except (TypeError, ValueError):
                raise TypeError("All attributes of a single graph should "
                                "have the same dimension.")
            if attributes.ndim == 1:
                attributes = attributes[:, None]
            diam.append(int(np.max(spm[spm < np.inf])))
            graphs.append((g.get_adjacency_matrix(), g.n, attributes, spm))

        if self._method_calling == 1:
            self._max_diam = max(diam) + 1
            max_diam = self._max_diam
        else:
            max_diam = max(self._max_diam, max(diam) + 1)

        out = []
        for AM, node_nr, attributes, spm in graphs:
            if node_nr and np.all((AM == 0) | (AM == 1)):
                M = _hopper_tensor(AM, spm, max_diam)
            else:
                M = _weighted_tensor(AM, node_nr, max_diam)
            if self.calculate_norm_:
                out.append((M, attributes, np.sum(attributes ** 2, axis=1)))
            else:
                out.append((M, attributes))
        return out

    def _features(self, parsed):
        """Explicit features of the linear node kernel, f64 [n, D]:
        phi(G) = vec(NA^T M[:, :m, :m]) with m = the fit-time diameter
        bound — every pairwise min-truncation involves a fit graph, so
        truncating both sides to the fit width reproduces it exactly."""
        m = self._max_diam
        rows = []
        for tup in parsed:
            M, NA = tup[0], tup[1]
            Mt = np.ascontiguousarray(
                M[:, :m, :m]).reshape(M.shape[0], m * m)
            rows.append((NA.T @ Mt).ravel())
        return torch.from_numpy(np.stack(rows))

    def _gram(self, parsed_x, parsed_y=None):
        """The linear node kernel's Gram: one f64 GEMM of the features on
        the kernel's device (None for the other node kernels: the pair
        loop)."""
        if self.metric_ is not linear_kernel:
            return None
        dev = self._device()
        fx = self._features(parsed_x)
        if parsed_y is None:
            return gram_gemm(fx, dev, torch.float64)
        return gram_rect(self._features(parsed_y), fx, dev, torch.float64)

    def _diag(self, parsed):
        # the reference's diagonal is pairwise(x, x) UNtruncated (a
        # transform graph may exceed the fit diameter bound), so the
        # feature-map shortcut does not apply here
        return np.array([self.pairwise_operation(x, x) for x in parsed])

    def pairwise_operation(self, x, y):
        xp, yp = x[0], y[0]
        m = min(xp.shape[1], yp.shape[1])
        m_sq = m ** 2
        if x[0].shape[1] > m:
            xp = xp[:, :m, :][:, :, :m]
        elif y[0].shape[1] > m:
            yp = yp[:, :m, :][:, :, :m]
        return self.metric_((xp.reshape(xp.shape[0], m_sq),) + x[1:],
                            (yp.reshape(yp.shape[0], m_sq),) + y[1:])
