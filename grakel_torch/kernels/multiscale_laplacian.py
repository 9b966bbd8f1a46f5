"""Multiscale Laplacian kernel (Kondor & Pan 2016), randomized scheme.

The counterpart of ``grakel_tpu/kernels/multiscale_laplacian.py``: the
same draw stream (the numpy ``RandomState`` of ``random_state``: the
vertex shuffles of fit) and the same host numpy linear algebra, so its
Grams equal the JAX package's to rounding.  The JAX package runs no
device program here, and neither does the port: every step is a
batched host ``inv`` / ``eigvals`` / ``eig`` in float64.

Reference semantics (grakel/kernels/multiscale_laplacian.py:91-350):

* per graph: regularized Laplacian inverse (heta on the diagonal) and
  raw feature matrix phi (:180-192);
* level 0: sample n_samples (graph, vertex) pairs, eigendecompose their
  feature Gram, project all vertex features onto the top-P positive
  eigenspace (:216-239);
* levels 1..L: per sampled vertex the FLG matrix of its level-l
  neighborhood subgraph — S = U^T L^-1 U + gamma I — and a Nystroem-like
  projection through the sampled FLG Gram (:240-280); transform replays
  the stored per-level (C, Q) bases (:281-290);
* final per-graph S via the Laplacian inverse; pairwise FLG value
  k = exp((logdet((Sx^-1+Sy^-1)) * -1 - (logdet Sx + logdet Sy)/2)/2)
  computed in log space, clipped at exp(-30) (:302-329).

``calculate_C`` is evaluated once per (graph, vertex, level) as an
identity-padded batched ``inv`` / ``eigvals`` over all neighborhoods of
a level, and every FLG block (the sampled Gram, the projection rows,
the final Gram) is one batched ``eigvals`` over stacked (P, P) sums.
"""

from __future__ import annotations

import warnings
from math import exp
from numbers import Real

import numpy as np
from numpy.linalg import eig, eigvals, inv, multi_dot
from scipy.sparse.csgraph import laplacian

from .base import Kernel, normalize_input
from ..estimator import check_random_state

__all__ = ["MultiscaleLaplacian"]

positive_eigenvalue_limit = 1e-6


def _inc_diag(A, value):
    A[np.diag_indices_from(A)] += value


class MultiscaleLaplacian(Kernel):
    """Fast multiscale Laplacian kernel."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 random_state=None, L=3, gamma=0.01, heta=0.01, P=10,
                 n_samples=50):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.random_state = random_state
        self.L = L
        self.gamma = gamma
        self.heta = heta
        self.P = P
        self.n_samples = n_samples

    def initialize(self):
        self.random_state_ = check_random_state(self.random_state)
        if not isinstance(self.gamma, Real):
            raise TypeError("gamma must be a real number")
        elif self.gamma == 0.0:
            warnings.warn("with zero gamma the calculation may crash")
        elif self.gamma < 0:
            raise TypeError("gamma must be positive")
        if not isinstance(self.heta, Real):
            raise TypeError("heta must be a real number")
        elif self.heta == 0.0:
            warnings.warn("with zero heta the calculation may crash")
        elif self.heta < 0:
            raise TypeError("heta must be positive")
        if not isinstance(self.L, int) or self.L < 0:
            raise TypeError("L must be a positive integer")
        if not isinstance(self.n_samples, int) or self.n_samples <= 0:
            raise TypeError("n_samples must be a positive integer")
        if not isinstance(self.P, int) or self.P <= 0:
            raise TypeError("P must be a positive integer")

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs = normalize_input(X)
        ng = len(graphs)
        data = {}
        neighborhoods = {}
        for k, g in enumerate(graphs):
            labs = g.get_labels(label_type="vertex", return_none=True)
            if labs is None:
                raise ValueError(
                    "MultiscaleLaplacian requires node attributes")
            A = g.get_adjacency_matrix()
            try:
                phi = np.array([list(labs[i]) for i in range(g.n)])
            except TypeError:
                raise TypeError("Features must be iterable and castable "
                                "in total to a numpy array.")
            Lap = laplacian(A).astype(float)
            _inc_diag(Lap, self.heta)
            data[k] = {0: A, 1: phi, 2: inv(Lap)}
            neighborhoods[k] = g

        if self._method_calling == 1:
            V = [(k, j) for k in range(ng)
                 for j in range(data[k][0].shape[0])]
            ns = min(len(V), self.n_samples)
            self.random_state_.shuffle(V)
            vs = V[:ns]
            phi_k = np.array([data[k][1][j, :] for (k, j) in vs])
            K = phi_k.dot(phi_k.T)
            v, w = eig(K)
            v, w = np.real(v), np.real(w.T)
            vpos = np.argpartition(v, -self.P)[-self.P:] \
                if v.shape[0] > self.P else np.arange(v.shape[0])
            vpos = vpos[np.where(v[vpos] > positive_eigenvalue_limit)]
            ksi = w[vpos].dot(phi_k).T / np.sqrt(v[vpos])
            for j in range(ng):
                data[j][1] = data[j][1].dot(ksi)
            self._data_level = {0: ksi}
            goff = np.cumsum([0] + [data[k][0].shape[0]
                                    for k in range(ng)])
            for l in range(1, self.L + 1):
                self.random_state_.shuffle(V)
                # C once per (graph, vertex) in one padded batch,
                # aligned to the freshly shuffled V; the sampled C[m]
                # are its first ns rows (vs = V[:ns])
                S_all, ld_all = self._batch_C(V, l, data, neighborhoods)
                S_vs, ld_vs = S_all[:ns], ld_all[:ns]
                # all FLG values against the sampled set in one block
                K_all = self._flg_block(S_all, ld_all, S_vs, ld_vs)
                K = K_all[:ns]
                v, w = eig(K)
                v, w = np.real(v), np.real(w.T)
                vpos = np.argpartition(v, -self.P)[-self.P:] \
                    if v.shape[0] > self.P else np.arange(v.shape[0])
                vpos = vpos[np.where(v[vpos] > positive_eigenvalue_limit)]
                Q = w[vpos].T / np.sqrt(v[vpos])
                # un-shuffle K_all rows into per-graph vertex order
                order = np.empty(len(V), np.int64)
                for i, (k, j) in enumerate(V):
                    order[goff[k] + j] = i
                K_grouped = K_all[order]
                for j in range(ng):
                    data[j][1] = K_grouped[goff[j]:goff[j + 1]].dot(Q)
                C = {m: (S_vs[m], ld_vs[m]) for m in range(ns)}
                self._data_level[l] = (C, Q)
        elif self._method_calling == 3:
            ksi = self._data_level[0]
            for j in range(ng):
                data[j][1] = data[j][1].dot(ksi)
            V = [(k, j) for k in range(ng)
                 for j in range(data[k][0].shape[0])]
            for l in range(1, self.L + 1):
                C, Q = self._data_level[l]
                S_m = np.stack([C[m][0] for m in range(len(C))])
                ld_m = np.array([C[m][1] for m in range(len(C))])
                S_all, ld_all = self._batch_C(V, l, data, neighborhoods)
                K_all = self._flg_block(S_all, ld_all, S_m, ld_m)
                row = 0
                for j in range(ng):
                    nv = data[j][0].shape[0]
                    data[j][1] = K_all[row:row + nv].dot(Q)
                    row += nv

        out = []
        for k in range(ng):
            S = multi_dot((data[k][1].T, data[k][2], data[k][1]))
            _inc_diag(S, self.gamma)
            out.append((inv(S), np.sum(np.log(np.real(eigvals(S))))))
        return out

    # ------------------------------------------------------------------ #
    def _batch_C(self, items, l, data, neighborhoods):
        """calculate_C (reference multiscale_laplacian.py:240-258) for
        every (graph, vertex) in ``items``, identity-padded and batched:
        S = U^T Lp^-1 U + gamma I over the level-``l`` neighborhood.
        Returns (S_inv[B, d, d], logdet[B])."""
        for k in {k for (k, _) in items}:
            if not isinstance(neighborhoods[k], dict):
                neighborhoods[k] = neighborhoods[k].produce_neighborhoods(
                    r=self.L, sort_neighbors=False)
        idxs = [list(neighborhoods[k][l][j]) for (k, j) in items]
        B = len(items)
        d = data[items[0][0]][1].shape[1]
        nmax = max(len(ix) for ix in idxs)
        Lp = np.tile(np.eye(nmax), (B, 1, 1))
        U = np.zeros((B, nmax, d))
        for b, ((k, j), ix) in enumerate(zip(items, idxs)):
            m = len(ix)
            Lb = laplacian(data[k][0][np.ix_(ix, ix)]).astype(float)
            _inc_diag(Lb, self.heta)
            Lp[b, :m, :m] = Lb
            U[b, :m, :] = data[k][1][ix, :]
        T = np.matmul(inv(Lp), U)               # (B, nmax, d)
        S = np.einsum("bnd,bne->bde", U, T)     # U^T Lp^-1 U
        S[:, np.arange(d), np.arange(d)] += self.gamma
        ev = eigvals(S) if d else np.zeros((B, 0))
        logdet = np.sum(np.log(np.real(ev)), axis=1)
        return inv(S), logdet

    def _flg_block(self, Sa, la, Sb, lb, chunk=256):
        """FLG kernel values between two stacks of (S_inv, logdet):
        k = exp((-logdet(Sa_i + Sb_j) - (la_i + lb_j)/2)/2), zero below
        exp(-30) (reference multiscale_laplacian.py:302-329)."""
        Na, Nb = len(la), len(lb)
        d = Sa.shape[1] if Na else 0
        out = np.zeros((Na, Nb))
        for s in range(0, Na, chunk):
            e = min(s + chunk, Na)
            T = (Sa[s:e, None] + Sb[None, :]).reshape(-1, d, d)
            if d:
                ev = eigvals(T)
                log_detS = -np.sum(np.log(np.real(ev)),
                                   axis=1).reshape(e - s, Nb)
            else:
                log_detS = np.zeros((e - s, Nb))
            logr = (log_detS - 0.5 * (la[s:e, None] + lb[None, :])) / 2.0
            blk = np.exp(logr)
            blk[logr < -30] = 0.0
            out[s:e] = blk
        return out

    def _gram(self, px, py=None):
        Sx = np.stack([c[0] for c in px])
        lx = np.array([c[1] for c in px])
        if py is None:
            return self._flg_block(Sx, lx, Sx, lx)
        Sy = np.stack([c[0] for c in py])
        ly = np.array([c[1] for c in py])
        return self._flg_block(Sy, ly, Sx, lx)

    def _diag(self, parsed):
        S = 2.0 * np.stack([c[0] for c in parsed])
        ld = np.array([c[1] for c in parsed])
        d = S.shape[1]
        ev = eigvals(S) if d else np.zeros((len(parsed), 0))
        logr = (-np.sum(np.log(np.real(ev)), axis=1) - ld) / 2.0
        out = np.exp(logr)
        out[logr < -30] = 0.0
        return out

    def pairwise_operation(self, x, y):
        S_inv_x, log_det_x = x
        S_inv_y, log_det_y = y
        log_detS = -np.sum(np.log(np.real(eigvals(S_inv_x + S_inv_y))))
        logr = (log_detS - 0.5 * (log_det_x + log_det_y)) / 2.0
        if logr < -30:
            return 0.0
        return exp(logr)
