"""Neighborhood Subgraph Pairwise Distance kernel (Costa & De Grave 2010).

The counterpart of ``grakel_tpu/kernels/nspd.py``.  Reference semantics
(grakel/kernels/neighborhood_subgraph_pairwise_distance.py):

* per graph: level neighborhoods + pair "distances" from
  ``Graph.produce_neighborhoods`` (including the reference's doubling
  recursion — see graph.py docstring);
* every rooted neighborhood is hashed to a 32-bit value: vertex labels
  are the sorted join of "dist,label" strings over in-neighborhood
  pairs, expanded over edges, hashed with the ArashPartov string hash
  (:357-445);
* features per (radius r <= R, distance d <= D) level: counts of
  (hash(root A ngbhd), hash(root B ngbhd)) keys over pairs (A, B) at
  distance d (:170-231); transform keys extend the fit enumeration;
* Gram = sum over levels of the PER-LEVEL-NORMALIZED count Gram
  (Q = K / sqrt(outer(diag, diag)), nan diag -> 1) (:306-325);
  ``normalize=True`` divides by the level count; diagonal() reports the
  level count (:326-355).

Split: neighborhood hashing is host combinatorial work in the native
C++ engine (``native/src/nspd.cpp``, the JAX package's source), which
hashes integer token streams whose equality relation matches the
reference's encoding strings; :meth:`_graph_hash_pairs_py` reproduces
the reference's string encodings and AP hash and is the engine's plain
version.  The two give different hash values but the same partition of
neighborhoods, and so the same Grams.

The level count matrices are extremely sparse, their columns almost all
held by one graph.  ``fit_transform`` scales rows by 1/sqrt(level
diagonal), which makes each level's normalized Gram a plain product,
and assembles their sum over all levels at once by multiplicity split
(``ops.gram.sparse_counts_gram`` in f64: columns of 2-64 graphs by pair
products on the host, the denser ones as one f64 block multiplied on
the kernel's device); the diagonal is the level count.  ``transform``
is one f64 counts-Gram on the device of the row-scaled transform
features against the row-scaled fit features, over only the fit
columns, of all levels together, that the transform graphs hold.
"""

from __future__ import annotations

from itertools import filterfalse

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..estimator import NotFittedError
from ..ops.gram import shared_cols_gram_rect, sparse_counts_gram

__all__ = ["NeighborhoodSubgraphPairwiseDistance", "ap_hash"]

_M32 = 0xFFFFFFFF


def ap_hash(s):
    """ArashPartov string hash over the bytes of ``s`` (uint32).

    Same arithmetic as the reference's C implementation
    (_c_functions/src/ArashPartov.cpp:8-20; public hash from
    partow.net/programming/hashfunctions).
    """
    h = 0xAAAAAAAA
    for i, b in enumerate(s.encode("utf-8")):
        if (i & 1) == 0:
            h ^= ((h << 7) ^ (b * (h >> 3))) & _M32
        else:
            h ^= (~((h << 11) + (b ^ (h >> 5))) & _M32)
        h &= _M32
    return h


def _encode_graph(per_i, vertices, sv, edges, gle):
    """Canonical neighborhood encoding string (reference :394-445).

    ``per_i[i]`` is the graph-wide list of (token, j) pairs for source
    ``i`` — token = "dist,label(j)" — PRESORTED by token, so each
    vertex label is a filtered scan instead of a rebuild+sort (the
    reference re-sorts per neighborhood, O(ball^2 log) per vertex).
    The AP hash is applied in batch afterwards
    (:func:`grakel_torch.native.ap_hash_batch`)."""
    parts = []
    Lv = {}
    for i in vertices:
        label = "|".join(t for (t, j) in per_i[i] if j in sv)
        parts.append(label)
        parts.append(".")
        Lv[i] = label
    parts[-1:] = [":"]
    for (i, j) in edges:
        parts.append(Lv[i] + "," + Lv[j] + "," + str(gle[(i, j)]) + "_")
    return "".join(parts)


def _level_sq_sum(m, n):
    """Per-graph sum of a level's squared counts (its Gram diagonal)."""
    rows, cols, vals, width = m
    out = np.zeros(n)
    np.add.at(out, rows, vals.astype(np.float64) ** 2)
    return out


def _inv_sqrt(d):
    """1/sqrt(d) where d > 0, else 0."""
    out = np.zeros(len(d))
    nz = d > 0
    out[nz] = 1.0 / np.sqrt(d[nz])
    return out


class NeighborhoodSubgraphPairwiseDistance(Kernel):
    """NSPD kernel with radius ``r`` and distance ``d`` levels."""

    # column-multiplicity split point: columns shared by more graphs go
    # through one dense GEMM; rarer columns through exact pair counting
    _DENSE_COL_MULT = 64
    # the widest chunk of the transform's counts-Gram: one GEMM while
    # the touched fit columns fit in it
    _TRANSFORM_CHUNK = 1 << 14

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 r=3, d=4):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.r = r
        self.d = d

    def initialize(self):
        if not isinstance(self.r, int) or self.r < 0:
            raise TypeError("r must be a non-negative integer")
        if not isinstance(self.d, int) or self.d < 0:
            raise TypeError("d must be a non-negative integer")

    # ------------------------------------------------------------------ #
    def _hash_neighborhoods(self, n, edges, Lv, Le, N, D_pair):
        from ..native import ap_hash_batch
        per_i = [[] for _ in range(n)]
        for (i, j), d in D_pair.items():
            per_i[i].append((str(d) + "," + str(Lv[j]), j))
        for lst in per_i:
            lst.sort()
        keys, encodings = [], []
        sel = sorted(edges)
        for v in range(n):
            re = sel
            for radius in range(self.r, -1, -1):
                sub_vertices = sorted(N[radius][v])
                sv = set(sub_vertices)
                # NOTE: ``re`` must be a set built exactly like the
                # reference's (:382-384) — the encoding iterates it, so
                # set-iteration order is part of feature identity.
                re = {(i, j) for (i, j) in re if i in sv and j in sv}
                keys.append((radius, v))
                encodings.append(
                    _encode_graph(per_i, sub_vertices, sv, re, Le))
        hashes = ap_hash_batch(encodings)
        return {k: int(h) for k, h in zip(keys, hashes)}

    @staticmethod
    def _edges(g):
        """The graph's distinct directed edges (sorted source-major)."""
        n = g.n
        if n and len(g.senders):
            enc = g.senders.astype(np.int64) * n + g.receivers
            u = np.unique(enc)
            return (u // n).astype(np.int32), (u % n).astype(np.int32)
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    def _graph_hash_pairs(self, g):
        """Per-graph hashing stage on the native engine
        (native/src/nspd.cpp): ``(H, pa, pb, pd)`` where ``H`` is
        ``uint32[(r+1, n)]`` of rooted-neighborhood hashes and
        ``(pa, pb, pd)`` the (A, B, distance-level) triples."""
        from ..native import nspd_hash_graph
        n = g.n
        Lv = g.get_labels(label_type="vertex")
        Le = g.get_labels(label_type="edge")
        esrc, edst = self._edges(g)
        return nspd_hash_graph(
            n, g.senders, g.receivers, esrc, edst,
            [str(Lv[j]) for j in range(n)],
            [str(Le[(int(s), int(r_))])
             for s, r_ in zip(esrc, edst)],
            self.r, self.d)

    def _graph_hash_pairs_py(self, g):
        """The plain version of :meth:`_graph_hash_pairs`: the
        reference's CPython set-iteration encodings and AP hashes.  Hash
        VALUES differ from the engine's but the induced feature-identity
        partition — and hence every Gram — is identical (both encode the
        same content deterministically); a kernel uses one path for fit
        and transform."""
        n = g.n
        Lv = g.get_labels(label_type="vertex")
        Le = g.get_labels(label_type="edge")
        esrc, edst = self._edges(g)
        edges = set(zip(esrc.tolist(), edst.tolist()))
        N, D, D_pair = g.produce_neighborhoods(
            self.r, with_distances=True, d=self.d)
        Hd = self._hash_neighborhoods(n, edges, Lv, Le, N, D_pair)
        H = np.zeros((self.r + 1, n), np.uint32)
        for (radius, v), h in Hd.items():
            H[radius, v] = h
        pa, pb, pd = [], [], []
        for d in filterfalse(lambda x: x not in D, range(self.d + 1)):
            for (A, B) in D[d]:
                pa.append(A)
                pb.append(B)
                pd.append(d)
        return (H, np.asarray(pa, np.int32), np.asarray(pb, np.int32),
                np.asarray(pd, np.int32))

    def parse_input(self, X):
        graphs = normalize_input(X)
        ng = len(graphs)
        if ng == 0:
            raise ValueError("parsed input is empty")
        # concatenate per-graph hashes + distance pairs (vertex ids
        # offset into the concatenated hash columns)
        H_l, pa_l, pb_l, pd_l, pg_l = [], [], [], [], []
        off = 0
        for gid, g in enumerate(graphs):
            H, pa, pb, pd = self._graph_hash_pairs(g)
            H_l.append(H)
            pa_l.append(pa.astype(np.int64) + off)
            pb_l.append(pb.astype(np.int64) + off)
            pd_l.append(pd)
            pg_l.append(np.full(len(pd), gid, np.int64))
            off += g.n
        Hcat = np.concatenate(H_l, axis=1) if off else \
            np.zeros((self.r + 1, 0), np.uint32)
        PA = np.concatenate(pa_l)
        PB = np.concatenate(pb_l)
        PD = np.concatenate(pd_l)
        PG = np.concatenate(pg_l)

        fit = self._method_calling in (1, 2)
        if fit:
            self._fit_keys = {}
        M = {}
        for d in range(self.d + 1):
            m = PD == d
            if not m.any():
                continue  # level absent, like the reference's missing D[d]
            A, B, G = PA[m], PB[m], PG[m]
            for r_ in range(self.r + 1):
                keys = ((Hcat[r_, A].astype(np.uint64) << np.uint64(32))
                        | Hcat[r_, B].astype(np.uint64))
                uk, inv = np.unique(keys, return_inverse=True)
                inv = inv.reshape(-1)
                if fit:
                    col = inv
                    width = len(uk)
                    self._fit_keys[r_, d] = uk
                else:
                    xk = getattr(self, "_fit_keys", {}).get(
                        (r_, d), np.zeros(0, np.uint64))
                    xw = len(xk)
                    pos = np.searchsorted(xk, uk)
                    if xw:
                        present = (pos < xw) & \
                            (xk[np.minimum(pos, xw - 1)] == uk)
                    else:
                        present = np.zeros(len(uk), bool)
                    # unseen keys get fresh columns past the fit width
                    # (they only contribute to the Y normalization sums;
                    # transform truncates columns >= xw)
                    colmap = np.where(present, pos,
                                      xw + np.cumsum(~present) - 1)
                    col = colmap[inv]
                    width = xw + int((~present).sum())
                comb = G * np.int64(width) + col
                ucomb, cnt = np.unique(comb, return_counts=True)
                M[r_, d] = ((ucomb // width).astype(np.int32),
                            (ucomb % width).astype(np.int32),
                            cnt.astype(np.float32), int(width))
        if fit:
            self._ngx = ng
        else:
            self._ngy = ng
        return M

    # ------------------------------------------------------------------ #
    def _scaled_items(self, levels, norms, n):
        """The items of ``levels`` (levels of the fit's, or truncated to
        the fit's widths) as one stream over all levels: (rows int64,
        columns offset by the fit levels' widths int64, counts scaled by
        1/sqrt(``norms``' row of their level) f64)."""
        offs, off = {}, 0
        for key, m in self.X.items():
            offs[key] = off
            off += m[3]
        rows, cols, vals = [], [], []
        for key, (r, c, v, _) in levels.items():
            rows.append(r.astype(np.int64))
            cols.append(c.astype(np.int64) + offs[key])
            vals.append(v.astype(np.float64) * _inv_sqrt(norms[key])[r])
        if not rows:
            e = np.zeros(0, np.int64)
            return e, e, np.zeros(0)
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    def fit_transform(self, X, y=None):
        """Gram = sum over levels of the per-level-normalized count Gram
        (reference neighborhood_subgraph_pairwise_distance.py:306-325),
        one multiplicity-split product over all levels (module
        docstring); the diagonal is analytically the number of levels."""
        self._method_calling = 2
        self.fit(X)
        n = self._ngx
        with self.timer_.stage("gram"):
            N = {key: _level_sq_sum(m, n) for key, m in self.X.items()}
            r, c, w = self._scaled_items(self.X, N, n)
            S = sparse_counts_gram(r, c, n, weights=w,
                                   dense_col_mult=self._DENSE_COL_MULT,
                                   dtype=torch.float64,
                                   device=self._device())
            np.fill_diagonal(S, float(len(self.X)))
        self._X_level_norm_factor = N
        self._report_stages()
        if self.normalize:
            return S / len(self.X)
        return S

    def transform(self, X):
        """``sum_levels K_level / sqrt(outer(ysq, Nf))`` as one product
        of row-scaled features, ``y_ic / sqrt(ysq_i)`` against ``x_jc /
        sqrt(Nf_j)``, over the fit columns the new graphs hold (a zero
        norm gives a zero row or column, as the reference's
        ``nan_to_num``)."""
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        Y = self.parse_input(X)
        if not hasattr(self, "_X_level_norm_factor"):
            self._X_level_norm_factor = {
                key: _level_sq_sum(m, self._ngx)
                for key, m in self.X.items()}
        Nf = self._X_level_norm_factor
        ny, nx = self._ngy, self._ngx
        # truncate transform features to the fit width; the Y norms
        # count every item, unseen keys included
        kept, ysq = {}, {}
        for key, (rows, cols, vals, width) in Y.items():
            if key not in self.X:
                continue
            keep = cols < self.X[key][3]
            kept[key] = (rows[keep], cols[keep], vals[keep], width)
            ysq[key] = _level_sq_sum((rows, cols, vals, width), ny)
        ry, cy, wy = self._scaled_items(kept, ysq, ny)
        # the fit items of the columns the transform items hold (a mask
        # over each level's width: no sort of the fit stream)
        held = {}
        for key, m in kept.items():
            xr, xc, xv, xw = self.X[key]
            hit = np.zeros(xw, bool)
            hit[m[1]] = True
            hit = hit[xc]
            held[key] = (xr[hit], xc[hit], xv[hit], xw)
        rx, cx, wx = self._scaled_items(held, Nf, nx)
        S = shared_cols_gram_rect(
            ry, cy, wy, rx, cx, wx, ny, nx, self._device(),
            chunk=self._TRANSFORM_CHUNK, dtype=torch.float64).cpu().numpy()
        self._Y = Y
        self._is_transformed = True
        if self.normalize:
            S /= np.sqrt(np.outer(*self.diagonal()[::-1]))
        return S

    def diagonal(self):
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        self._X_diag = len(self.X)
        if getattr(self, "_is_transformed", False):
            return self._X_diag, len(self._Y)
        return self._X_diag
