"""Weisfeiler-Lehman optimal assignment kernel (Kriege et al. 2016).

The counterpart of ``grakel_tpu/kernels/wl_optimal_assignment.py``.
Reference semantics (grakel/kernels/weisfeiler_lehman_optimal_assignment.py):

* WL refinement with GLOBAL label ids shared across iterations
  (``n_iter + 1`` generations, :74); each new label is inserted into a
  hierarchy tree whose parent is the node's previous-generation label,
  with omega = 1 (:220-237);
* per-graph histogram over hierarchy nodes: each vertex's final label
  walks its ancestor chain adding omega at every node (:206-218);
* K = histogram intersection sum_l min(H_i[l], H_j[l]) (:270-288),
  transform truncating to the fit histogram width (:416-434);
* transform-time unseen credentials get fresh ids hung off 'root'
  (iteration 0) or their previous label (:353-399).

The credential refinement and the hierarchy stay on the host (string
credentials with the reference's exact sorted global enumeration), as
in the JAX package.  The histogram-intersection Gram uses the
unary-threshold identity

    sum_l min(a_l, b_l) = sum_{(l, t): t <= max} [a_l >= t][b_l >= t]

so a histogram entry of count c becomes c sparse 0/1 features
``(l, 1..c)``, whose stream is as long as the total histogram mass, and
the Gram is the chunked counts-GEMM every histogram kernel uses
(``ops/gram.coo_counts_gram``) on the kernel's device.  Expanded feature
ids are compacted on the host with np.unique; at transform time mapping
through the FIT enumeration is exact (a transform feature (l, t) absent
from fit means no fit graph reaches count t at l, so its column is
all-zero on the fit side).  The GEMMs run over few columns: at fit, a
column that only one graph reaches (most late-generation labels: 551k
of 561k columns on the NCI1-scale set) adds only to that graph's
diagonal, as WL-VH's singletons do; at transform, only the columns the
new graphs reach can add to an entry.  An entry is at most the smaller
graph's histogram mass, so the Gram sums in f64 once that can pass
2^24.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..estimator import NotFittedError
from ..ops.gram import (coo_counts_gram, count_dtype, normalize_gram,
                        shared_cols_gram_rect)

__all__ = ["WeisfeilerLehmanOptimalAssignment"]


class WeisfeilerLehmanOptimalAssignment(Kernel):
    """WL-OA kernel."""

    def __init__(self, n_jobs=None, verbose=False, normalize=False,
                 n_iter=5, sparse=False):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.n_iter = n_iter
        self.sparse = sparse  # accepted for API parity; device path is dense

    def initialize(self):
        if not isinstance(self.n_iter, int) or self.n_iter <= 0:
            raise TypeError("'n_iter' must be a positive integer")
        self._n_iter = self.n_iter + 1

    # ------------------------------------------------------------------ #
    def _graphs_to_ed(self, X):
        graphs = normalize_input(X)
        eds, labels = [], []
        for g in graphs:
            ed = {v: set() for v in range(g.n)}
            for s, r in zip(g.senders, g.receivers):
                ed[int(s)].add(int(r))
            eds.append(ed)
            labs = g.get_labels(label_type="vertex", return_none=True)
            if labs is None:
                raise ValueError("WL-OA requires node labels")
            labels.append(dict(labs))
        return eds, labels

    def _insert(self, label, previous_label):
        h = self._hierarchy
        h[label] = {"parent": previous_label, "children": [],
                    "w": h[previous_label]["w"] + 1, "omega": 1}
        h[previous_label]["children"].append(label)

    def _refine(self, eds, L, known=None):
        """The final WL labels (global ids, one dict a graph) of the
        graphs ``eds`` with original labels ``L``, each label new to this
        call inserted into the hierarchy under its previous-generation
        label ('root' at generation 0).  At fit (``known`` None) every
        label is new and each generation's enumeration goes to
        ``_inv_labels``; at transform ``known`` is ``_inv_labels`` and
        only what it lacks gets fresh ids, counted on from its size."""
        fit = known is None
        known = {} if fit else known
        count = sum(len(inv) for inv in known.values())

        def enumerate_new(pairs):
            nonlocal count
            inv = {}
            for key, parent in pairs:
                inv[key] = count
                self._insert(count, parent)
                count += 1
            if fit:
                self._inv_labels[len(self._inv_labels)] = inv
            return inv

        def relabel(labels, i, inv):
            seen = known.get(i, {})
            return [{v: seen.get(x[v], inv.get(x[v])) for v in x}
                    for x in labels]

        distinct = set()
        for lab in L:
            distinct |= set(x for x in lab.values()
                            if x not in known.get(0, ()))
        try:
            ordered = sorted(distinct)
        except TypeError:
            ordered = sorted(distinct, key=str)
        L = relabel(L, 0, enumerate_new((x, "root") for x in ordered))
        for i in range(1, self._n_iter):
            new_set, creds = set(), []
            for j, ed in enumerate(eds):
                cred = {}
                for v in ed:
                    c = (str(L[j][v]) + ","
                         + str(sorted(L[j][n] for n in ed[v])))
                    cred[v] = c
                    if c not in known.get(i, ()):
                        new_set.add((c, L[j][v]))
                creds.append(cred)
            L = relabel(creds, i, enumerate_new(
                sorted(new_set, key=lambda t: t[0])))
        return L

    def _sparse_histograms(self, labels_per_graph):
        """Ancestor-chain histograms as an expanded unary COO stream.

        Returns ``(gids, ekeys, mass)``: for every (graph, hierarchy
        node) entry with count c, c int64 keys ``(hid << 32) | t``
        (t = 1..c — a fixed encoding so transform keys map through the
        fit enumeration); ``mass[j]`` = total histogram mass of graph j
        (= its intersection self-term sum_l min(h, h) = sum_l h)."""
        chains = {}

        def chain_of(l):
            c = chains.get(l)
            if c is None:
                c = []
                cur = l
                while self._hierarchy[cur]["parent"] is not None:
                    c.append((cur, self._hierarchy[cur]["omega"]))
                    cur = self._hierarchy[cur]["parent"]
                chains[l] = c
            return c

        gl, hl = [], []
        for j, L in enumerate(labels_per_graph):
            for l in L.values():
                for node, omega in chain_of(l):
                    gl.extend((j,) * omega)
                    hl.extend((node,) * omega)
        n = len(labels_per_graph)
        gids = np.asarray(gl, np.int64)
        hids = np.asarray(hl, np.int64)
        if gids.size == 0:
            return gids, hids, np.zeros(n)
        # per-(graph, hid) counts -> unary expansion (hid, t=1..c)
        base = np.int64(len(self._hierarchy) + 1)
        pair = gids * base + hids
        upair, counts = np.unique(pair, return_counts=True)
        g_rep = np.repeat(upair // base, counts)
        h_rep = np.repeat(upair % base, counts)
        # t-index within each run of equal (graph, hid)
        offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
        t = np.arange(g_rep.size, dtype=np.int64) - np.repeat(offs, counts)
        ekeys = (h_rep << np.int64(32)) | (t + 1)
        mass = np.bincount(gids, minlength=n).astype(np.float64)
        return g_rep, ekeys, mass

    # ------------------------------------------------------------------ #
    def fit(self, X, y=None):
        self._method_calling = 1
        self._is_transformed = False
        self.initialize()
        self.X = self._parse_fit(X)
        self._X_diag = None
        return self

    def _parse_fit(self, X):
        eds, L = self._graphs_to_ed(X)
        nx = len(eds)
        self._nx = nx
        self._hierarchy = {"root": {"parent": None, "children": [],
                                    "w": 0, "omega": 0}}
        self._inv_labels = {}
        L = self._refine(eds, L)
        gids, ekeys, mass = self._sparse_histograms(L)
        # fit enumeration: sorted unique expanded keys; eids dense in it
        self._ekeys = np.unique(ekeys)
        eids = np.searchsorted(self._ekeys, ekeys)
        self._mass = mass
        return {"gids": gids, "eids": eids, "n": nx,
                "width": len(self._ekeys)}

    def _tensor(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self._device())

    def _fit_gram(self):
        """The fit Gram: the counts-GEMM over the columns that two or
        more graphs reach, plus each graph's count of columns only it
        reaches on the diagonal."""
        gids, eids, n = self.X["gids"], self.X["eids"], self.X["n"]
        cnt = np.bincount(eids, minlength=self.X["width"])
        rep = cnt[eids] > 1
        remap = np.cumsum(cnt > 1) - 1
        n_rep = int(rep.sum())
        K = coo_counts_gram(
            self._tensor(gids[rep]), self._tensor(remap[eids[rep]]),
            np.ones(n_rep, np.float32), np.ones(n_rep, bool),
            n, max(int((cnt > 1).sum()), 1),
            dtype=count_dtype(self._mass.max(initial=0.0)))
        single = np.bincount(gids[~rep], minlength=n)
        torch.diagonal(K).add_(torch.from_numpy(single).to(K))
        return K.cpu().numpy()

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self._is_transformed = False
        self.initialize()
        self.X = self._parse_fit(X)
        K = self._fit_gram()
        self._X_diag = self._mass.copy()
        self._K_fit = K
        if self.normalize:
            K = normalize_gram(K, self._X_diag, self._X_diag)
        return np.asarray(K)

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        eds, L = self._graphs_to_ed(X)
        nx = len(eds)
        L = self._refine(eds, L, self._inv_labels)
        gids, ekeys, mass = self._sparse_histograms(L)
        self._Y_mass = mass
        # map through the FIT enumeration; unseen (hid, t) keys have an
        # all-zero indicator column on the fit side -> contribute 0
        # (this also subsumes the reference's truncation to fit width)
        pos = np.searchsorted(self._ekeys, ekeys)
        pos_c = np.minimum(pos, max(len(self._ekeys) - 1, 0))
        hit = (self._ekeys[pos_c] == ekeys) if len(self._ekeys) else \
            np.zeros(ekeys.shape[0], bool)
        # only the fit columns the new graphs reach add to an entry
        bound = min(mass.max(initial=0.0), self._mass.max(initial=0.0))
        K = shared_cols_gram_rect(
            gids[hit], pos_c[hit], np.ones(int(hit.sum()), np.float32),
            self.X["gids"], self.X["eids"],
            np.ones(len(self.X["eids"]), np.float32), nx, self.X["n"],
            self._device(), dtype=count_dtype(bound)).cpu().numpy()
        self._is_transformed = True
        if self.normalize:
            X_diag, Y_diag = self.diagonal()
            K = normalize_gram(K, Y_diag, X_diag)
        return np.asarray(K)

    def diagonal(self):
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if self._X_diag is None:
            self._X_diag = self._mass.copy()
        if getattr(self, "_is_transformed", False):
            return self._X_diag, self._Y_mass
        return self._X_diag
