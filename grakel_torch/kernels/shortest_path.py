"""Shortest-path kernels.

The counterpart of ``grakel_tpu/kernels/shortest_path.py`` (dense mode).

``ShortestPath`` — reference semantics (grakel/kernels/shortest_path.py:
413-500): per graph compute APSP; features count triplets
``(label_u, label_v, d(u, v))`` (labeled) or distances ``d(u, v)``
(unlabeled), skipping ``u == v`` and unreachable pairs; the Gram is the
dot product of those count vectors, with transform-time features unseen
at fit contributing nothing (enum-extension semantics, :477-487).

Design: graphs are grouped into V-size buckets (multiples of 8) and each
bucket's dense padded adjacency runs the batched Floyd-Warshall of
``ops/floyd_warshall.py`` (the hand kernel K3 on a CUDA tensor).  The
per-pair work around it is torch elementwise ops on the kernel's device:

* **direct-index** (unit edge weights): distances are exact small
  integers, so the triplet id ``(l_u * L + l_v) * D + d`` is computed on
  the device and every bucket's ids feed one chunked counts-Gram
  (``ops/gram.py``).  ``D`` is the largest bucket's V, or, when
  ``L^2 * V`` passes ``_DIRECT_MAX_WIDTH``, the observed largest distance
  + 1 (one device-to-host read per call);
* **hash compaction** (weighted graphs, or feature spaces still past the
  cap): per pair the (f32 distance bits, label pair) hash is compacted to
  dense ids on the device (``ops/wl.compact_pairs``); exact float
  distance equality matches the reference's dict-key equality.  Ids
  occurring once only touch the diagonal (``split_singletons``); a still
  wide repeated-id space assembles on the host (``sparse_counts_gram``).

Count Grams sum in f32 while no entry can pass 2^24 (widest bucket V
with (V (V - 1))^2 < 2^24, so V <= 64) and in f64 above, so they are
exact integers either way; the JAX package sums in f32 throughout and
rounds such entries.

Not ported: the JAX package's stream mode with its native BFS engine and
its small-cell routing to XLA-CPU.  Its own tests show stream mode gives
the dense mode's Gram.

``ShortestPathAttr`` — the reference's O(n^4) pair loop
(shortest_path.py:131-165) reformulated per distinct distance value d:
k(x, y) = sum_d sum(M * (X_d @ M @ Y_d)) with M[i, k] = metric(attr_x_i,
attr_y_k), X_d = [S_x == d], Y_d = [S_y == d], through the base class's
pairwise loop on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..batch import enumerate_labels
from ..ops.floyd_warshall import INF, batched_floyd_warshall
from ..ops.gram import (coo_counts_gram, coo_counts_gram_rect, count_dtype,
                        counts_diag, sparse_counts_gram)
from ..ops.wl import compact_pairs, split_singletons

__all__ = ["ShortestPath", "ShortestPathAttr"]

_M32 = 0xFFFFFFFF


def _size_buckets(graphs):
    """Group graph indices by padded vertex-count bucket (multiples of
    8): pair counts grow with V^2, so fine buckets bound the padded-pair
    volume."""
    out = {}
    for i, g in enumerate(graphs):
        v = max(8, -(-g.n // 8) * 8)
        out.setdefault(v, []).append(i)
    return out


class _Bucket:
    """One bucket after Floyd-Warshall, on the kernel's device: S f32
    [nb, V, V], valid bool [nb, V, V] (both endpoints real, u != v,
    reachable), labels int64 [nb, V], graph ids int64 [nb].  ``unit``:
    every edge weight is 1, so K3 may take its integral-weight route."""

    def __init__(self, idxs, A, Lb, M, dev, unit):
        M = torch.from_numpy(M).to(dev)
        self.S = batched_floyd_warshall(torch.from_numpy(A).to(dev), M,
                                        integral=unit)
        V = self.S.shape[1]
        eye = torch.eye(V, dtype=torch.bool, device=dev)
        self.valid = (M[:, :, None] & M[:, None, :] & ~eye[None]
                      & (self.S < INF / 2))
        self.labels = torch.from_numpy(Lb).to(dev, torch.int64)
        self.gids = torch.from_numpy(idxs).to(dev, torch.int64)

    def dmax(self):
        """Largest finite distance (0-d tensor; 0 when none)."""
        return torch.where(self.valid, self.S, 0.0).amax()

    def pair_gids(self, offset=0):
        V = self.S.shape[1]
        return (self.gids + offset)[:, None, None].expand(-1, V, V)

    def direct_ids(self, L, D):
        """Triplet ids (l_u * L + l_v) * D + d; the distance is masked
        before the integer cast (INF has no int32 value to saturate to
        on every device)."""
        d = torch.where(self.valid, self.S, 0.0).to(torch.int64)
        d = d.clamp_(0, D - 1)
        lu = self.labels[:, :, None]
        lv = self.labels[:, None, :]
        return (lu * L + lv) * D + d

    def hashes(self):
        """(h1, h2) u32 values in int64: the f32 distance bits and the
        label pair l_u * 0x10001 + l_v mod 2^32."""
        h1 = self.S.view(torch.int32).to(torch.int64) & _M32
        lab = self.labels & _M32
        h2 = (lab[:, :, None] * 0x10001 + lab[:, None, :]) & _M32
        return h1, h2


def _flat(parts):
    parts = [p.reshape(-1) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class ShortestPath(Kernel):
    """Labeled/unlabeled shortest-path kernel."""

    # direct-index feature-space cap: L^2 * D label-distance cells;
    # larger spaces use hash compaction
    _DIRECT_MAX_WIDTH = 1 << 18
    # repeated-triplet-id count past which the symmetric Gram assembles
    # on the host (sparse_counts_gram) instead of the chunked GEMM
    _SPARSE_GRAM_MIN_REP = 1 << 16

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 algorithm_type="auto", with_labels=True):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        # algorithm_type accepted for reference API parity; the device
        # path always runs batched Floyd-Warshall.
        self.algorithm_type = algorithm_type
        self.with_labels = with_labels

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        """-> per-bucket dense host arrays + label metadata; all per-pair
        work runs on the device inside ``_gram`` / ``_diag``.  At
        transform, labels unseen at fit extend the enumeration."""
        graphs = normalize_input(X)
        if self._method_calling in (1, 2):
            self._enum = {}
        elif not hasattr(self, "_enum"):
            raise ValueError("fit before transform")
        buckets = []
        unit = True
        for V, idxs in sorted(_size_buckets(graphs).items()):
            nb = len(idxs)
            A = np.zeros((nb, V, V), dtype=np.float32)
            L = np.zeros((nb, V), dtype=np.int32)
            M = np.zeros((nb, V), dtype=bool)
            for bi, gi in enumerate(idxs):
                g = graphs[gi]
                if len(g.senders):
                    A[bi, g.senders, g.receivers] = g.weights
                M[bi, :g.n] = True
                if self.with_labels:
                    labs = g.get_labels(label_type="vertex",
                                        return_none=True)
                    if labs is None:
                        raise ValueError(
                            "ShortestPath with_labels=True requires "
                            "node-labeled graphs")
                    L[bi, :g.n] = enumerate_labels(
                        [labs[v] for v in range(g.n)], self._enum)
            if unit:
                w = A[A != 0]
                if w.size and not np.all(w == 1.0):
                    unit = False
            buckets.append((np.asarray(idxs, np.int32), A, L, M))
        return {"n": len(graphs), "buckets": buckets, "unit": unit,
                "max_V": max((b[3].shape[1] for b in buckets), default=1)}

    # ------------------------------------------------------------------ #
    def _fw(self, p):
        dev = self._device()
        return [_Bucket(*b, dev, p["unit"]) for b in p["buckets"]]

    @staticmethod
    def _count_dtype(*ps):
        """Width of the count Grams of the parses ``ps``: a graph of V
        vertices has at most V (V - 1) valid pairs, so an entry is at
        most (V (V - 1))^2 for V the widest bucket; f32 sums of integers
        are exact below 2^24, f64 ones below 2^53."""
        V = max(p["max_V"] for p in ps)
        return count_dtype((V * (V - 1)) ** 2)

    def _plan(self, *ps):
        """(route, L, D, fw) for the parses ``ps``: route "direct" or
        "hash"; ``fw`` their Floyd-Warshall buckets when the observed
        distance range had to be read (else None)."""
        L = max(len(self._enum), 1) if self.with_labels else 1
        if not all(p["unit"] for p in ps):
            return "hash", L, None, None
        D = max(p["max_V"] for p in ps)
        if L * L * D <= self._DIRECT_MAX_WIDTH:
            return "direct", L, D, None
        # wider label space: size D by the observed distance range, one
        # device-to-host read for all buckets of all parses
        fw = [self._fw(p) for p in ps]
        dmax = torch.stack([b.dmax() for f in fw for b in f]).amax()
        D = int(dmax) + 1
        return ("direct" if L * L * D <= self._DIRECT_MAX_WIDTH
                else "hash"), L, D, fw

    @staticmethod
    def _direct_items(fw, L, D):
        """Concatenated (gids, ids) of the valid pairs."""
        valid = _flat([b.valid for b in fw])
        return (_flat([b.pair_gids() for b in fw])[valid],
                _flat([b.direct_ids(L, D) for b in fw])[valid])

    @staticmethod
    def _hash_labels(fws, n_per):
        """The pair hashes of several parses' buckets (graph ids of each
        parse offset past the previous ones'), compacted jointly and
        split: (gids, gram_labels, gram_valid, n_rep, diag_correction
        f64)."""
        gids, h1s, h2s, valids = [], [], [], []
        off = 0
        for fw, n in zip(fws, n_per):
            for b in fw:
                h1, h2 = b.hashes()
                h1s.append(h1)
                h2s.append(h2)
                gids.append(b.pair_gids(off))
                valids.append(b.valid)
            off += n
        gids, valid = _flat(gids), _flat(valids)
        ids, _, counts = compact_pairs(_flat(h1s), _flat(h2s), valid)
        gl, gv, n_rep, dcorr = split_singletons(ids, counts, valid, gids,
                                                sum(n_per))
        return gids, gl, gv, n_rep, dcorr

    def _gram(self, px, py=None):
        if py is None:
            return self._gram_sym(px)
        return self._gram_rect(px, py)

    def _gram_sym(self, p):
        n = p["n"]
        route, L, D, fw = self._plan(p)
        fw = fw[0] if fw else self._fw(p)
        dt = self._count_dtype(p)
        if route == "direct":
            gids, ids = self._direct_items(fw, L, D)
            return coo_counts_gram(gids, ids, torch.ones_like(ids,
                                   dtype=torch.float32), True, n,
                                   L * L * D, dtype=dt)
        gids, gl, gv, n_rep, dcorr = self._hash_labels([fw], [n])
        if n_rep > self._SPARSE_GRAM_MIN_REP:
            # still-wide repeated-id space: a chunked GEMM over it is
            # nearly all zeros; host multiplicity-split assembly instead
            K = torch.from_numpy(sparse_counts_gram(gids[gv], gl[gv], n,
                                                    dtype=dt))
        else:
            K = coo_counts_gram(gids, gl, torch.ones_like(
                gids, dtype=torch.float32), gv, n, max(n_rep, 1), dtype=dt)
        K.diagonal().add_(dcorr.to(K.device, K.dtype))
        return K

    def _gram_rect(self, px, py):
        """Rows = Y (transform) graphs, columns = X (fit) graphs; also
        leaves Y's diagonal in ``_Y_diag_cache``.  Labels unseen at fit
        extended the enumeration, so the fit side's ids are recomputed
        under the new L."""
        nx, ny = px["n"], py["n"]
        route, L, D, fw = self._plan(px, py)
        fwx, fwy = fw if fw else (self._fw(px), self._fw(py))
        dt = self._count_dtype(px, py)
        if route == "direct":
            xg, xi = self._direct_items(fwx, L, D)
            yg, yi = self._direct_items(fwy, L, D)
            W = L * L * D
            ones_x = torch.ones_like(xi, dtype=torch.float32)
            ones_y = torch.ones_like(yi, dtype=torch.float32)
            K = coo_counts_gram_rect(yg, yi, ones_y, True, xg, xi, ones_x,
                                     True, ny, nx, W, dtype=dt)
            self._Y_diag_cache = counts_diag(yg, yi, ones_y, True, ny, W,
                                             dtype=dt)
            return K
        # joint compaction: consistent feature ids across X and Y;
        # singletons occur on one side only and re-enter Y's diagonal
        gids, gl, gv, n_rep, dcorr = self._hash_labels([fwx, fwy], [nx, ny])
        is_y = gids >= nx
        gy = torch.where(is_y, gids - nx, 0)
        gx = torch.where(is_y, 0, gids)
        ones = torch.ones_like(gids, dtype=torch.float32)
        W = max(n_rep, 1)
        K = coo_counts_gram_rect(gy, gl, ones, gv & is_y, gx, gl, ones,
                                 gv & ~is_y, ny, nx, W, dtype=dt)
        self._Y_diag_cache = (counts_diag(gy, gl, ones, gv & is_y, ny, W,
                                          dtype=dt)
                              .to(torch.float64) + dcorr[nx:nx + ny])
        return K

    def _diag(self, parsed):
        if (getattr(self, "_is_transformed", False)
                and parsed is getattr(self, "_Y", None)
                and hasattr(self, "_Y_diag_cache")):
            return self._Y_diag_cache
        n = parsed["n"]
        route, L, D, fw = self._plan(parsed)
        fw = fw[0] if fw else self._fw(parsed)
        dt = self._count_dtype(parsed)
        if route == "direct":
            gids, ids = self._direct_items(fw, L, D)
            return counts_diag(gids, ids, torch.ones_like(
                ids, dtype=torch.float32), True, n, L * L * D, dtype=dt)
        gids, gl, gv, n_rep, dcorr = self._hash_labels([fw], [n])
        return counts_diag(gids, gl, torch.ones_like(
            gids, dtype=torch.float32), gv, n, max(n_rep, 1), dtype=dt) \
            .to(torch.float64) + dcorr


class ShortestPathAttr(Kernel):
    """Attributed shortest-path kernel (reference
    shortest_path.py:131-165), reformulated as per-distance products."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 algorithm_type="auto", metric=np.dot):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.algorithm_type = algorithm_type
        self.metric = metric

    def parse_input(self, X):
        graphs = normalize_input(X)
        out = []
        for g in graphs:
            S, _ = g.build_shortest_path_matrix()
            labs = g.get_labels(label_type="vertex", return_none=True)
            if labs is None:
                raise ValueError("ShortestPathAttr requires node attributes")
            attrs = np.asarray([np.asarray(labs[v], dtype=np.float64)
                                for v in range(g.n)])
            out.append((S, attrs))
        return out

    def pairwise_operation(self, x, y):
        Sx, Ax = x
        Sy, Ay = y
        if self.metric is np.dot:
            M = Ax @ Ay.T
        else:
            M = np.asarray([[self.metric(a, b) for b in Ay] for a in Ax])
        dx = Sx[np.isfinite(Sx)]
        dy = Sy[np.isfinite(Sy)]
        common = np.intersect1d(np.unique(dx), np.unique(dy))
        total = 0.0
        for d in common:
            if d == 0:
                # u == v pairs are excluded in the reference loop (i != j)
                Xd = (Sx == 0) & ~np.eye(Sx.shape[0], dtype=bool)
                Yd = (Sy == 0) & ~np.eye(Sy.shape[0], dtype=bool)
            else:
                Xd = Sx == d
                Yd = Sy == d
            if not Xd.any() or not Yd.any():
                continue
            total += float(np.sum(M * (Xd.astype(np.float64) @ M
                                       @ Yd.astype(np.float64))))
        return total
