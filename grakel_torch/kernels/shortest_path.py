"""Shortest-path kernels.

The counterpart of ``grakel_tpu/kernels/shortest_path.py``.

``ShortestPath`` — reference semantics (grakel/kernels/shortest_path.py:
413-500): per graph compute APSP; features count triplets
``(label_u, label_v, d(u, v))`` (labeled) or distances ``d(u, v)``
(unlabeled), skipping ``u == v`` and unreachable pairs; the Gram is the
dot product of those count vectors, with transform-time features unseen
at fit contributing nothing (enum-extension semantics, :477-487).

Design: graphs are grouped into V-size buckets (multiples of 8).  A
parse whose dense buckets would pass ``_STREAM_BYTES`` takes **stream
mode**: it keeps each graph's COO edges and never builds a dense
``[nb, V, V]`` array (REDDIT-M-12K's dense buckets are ~13.7 GB).

Dense mode: each bucket's padded adjacency runs the batched
Floyd-Warshall of ``ops/floyd_warshall.py`` (the hand kernel K3 on a
CUDA tensor).  The per-pair work around it is torch elementwise ops on
the kernel's device:

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

Stream mode, unit weights (``D`` the largest bucket's V, which exceeds
every distance):

* **BFS** (the default): the native batched-BFS engine
  (``native.sp_bfs_counts_native``) counts each graph's triplets on the
  host from a CSR built from the COO; the observed keys are compacted
  with ``np.unique`` and the counts-Gram runs on the device, or, past
  ``_BFS_DEVICE_MAX_W`` keys, on the host (``sparse_counts_gram``; a
  scipy CSR product for a transform);
* **slab** (``_STREAM_BFS = False``, while ``L^2 D`` is within
  ``_DIRECT_MAX_WIDTH``): a bucket at a time in slabs of at most
  ``max(8, min(512, _STREAM_SLAB_BYTES // (4 V^2)))`` graphs, each
  slab's edges go up once and are scattered into a zeroed ``[S, V, V]``
  adjacency on the device, K3 runs on it, and one ``index_add_`` adds its
  triplet ids into the per-graph counts ``C [n + 1, L^2 D]`` (the last
  row parks the invalid pairs); the Gram is one product, ``C C^T`` or
  ``C_y C_x^T``, after the last slab.

Weighted stream parses (and unit ones no stream route takes) are
materialized into dense buckets on the host, with a warning.

Count Grams sum in f32 while no entry can pass 2^24 (widest bucket V
with (V (V - 1))^2 < 2^24, so V <= 64) and in f64 above, so they are
exact integers on every route; the JAX package sums in f32 throughout
and rounds such entries.

Not ported: the JAX package's power-of-two coarsening of stream buckets
and its small-cell routing to XLA-CPU (both cut XLA compiles or round
trips over a TPU link).

``ShortestPathAttr`` — the reference's O(n^4) pair loop
(shortest_path.py:131-165) reformulated per distinct distance value d:
k(x, y) = sum_d sum(M * (X_d @ M @ Y_d)) with M[i, k] = metric(attr_x_i,
attr_y_k), X_d = [S_x == d], Y_d = [S_y == d], through the base class's
pairwise loop on the host.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..batch import enumerate_labels
from ..ops.floyd_warshall import INF, batched_floyd_warshall
from ..ops.gram import (coo_counts_gram, coo_counts_gram_rect, count_dtype,
                        counts_diag, full_fp32, sparse_counts_gram)
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
    """Graphs after Floyd-Warshall, on one device: S f32 [nb, V, V],
    valid bool [nb, V, V] (both endpoints real, u != v, reachable),
    labels int64 [nb, V], graph ids int64 [nb].  Built from tensors A f32
    [nb, V, V], M bool [nb, V], labels and graph ids on that device;
    ``unit``: every edge weight is 1, so K3 may take its integral-weight
    route."""

    def __init__(self, A, M, labels, gids, unit):
        self.S = batched_floyd_warshall(A, M, integral=unit)
        V = self.S.shape[1]
        eye = torch.eye(V, dtype=torch.bool, device=M.device)
        self.valid = (M[:, :, None] & M[:, None, :] & ~eye[None]
                      & (self.S < INF / 2))
        self.labels = labels.to(torch.int64)
        self.gids = gids.to(torch.int64)

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


def _up(a, dev):
    """A host array as a tensor on ``dev``."""
    return torch.from_numpy(a).to(dev)


def _flat(parts):
    parts = [p.reshape(-1) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class ShortestPath(Kernel):
    """Labeled/unlabeled shortest-path kernel."""

    _host_parse = True

    # direct-index feature-space cap: L^2 * D label-distance cells;
    # larger spaces use hash compaction
    _DIRECT_MAX_WIDTH = 1 << 18
    # repeated-triplet-id count past which the symmetric Gram assembles
    # on the host (sparse_counts_gram) instead of the chunked GEMM
    _SPARSE_GRAM_MIN_REP = 1 << 16
    # total dense-bucket bytes past which the parse keeps COO only
    # (stream mode)
    _STREAM_BYTES = 1 << 28
    # adjacency bytes a slab of the stream slab route aims at
    _STREAM_SLAB_BYTES = 1 << 28
    # observed-key width past which the BFS-count Gram assembles on the
    # host: a chunked GEMM over a sparse key space that wide is nearly
    # all zeros
    _BFS_DEVICE_MAX_W = 1 << 20
    # stream mode's unit-weight route: the native BFS counts (True) or
    # K3 a slab at a time on the device (False)
    _STREAM_BFS = True

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 algorithm_type="auto", with_labels=True):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        # algorithm_type accepted for reference API parity; the device
        # path always runs batched Floyd-Warshall.
        self.algorithm_type = algorithm_type
        self.with_labels = with_labels

    def __getstate__(self):
        # drop the cached count matrices (tensors on the kernel's
        # device; rebuilt on demand after unpickling)
        st = self.__dict__.copy()
        for attr in ("X", "_Y"):
            p = st.get(attr)
            if isinstance(p, dict) and p.get("counts"):
                st[attr] = dict(p, counts={})
        return st

    # ------------------------------------------------------------------ #
    def parse_input(self, X, stream=None):
        """-> per-bucket host arrays + label metadata; all per-pair work
        runs in ``_gram`` / ``_diag``.  A bucket is ``(graph ids, A,
        labels, mask)`` with ``A`` the dense f32 adjacency, or in stream
        mode (``stream``; None: when the dense buckets would pass
        ``_STREAM_BYTES``) each graph's ``(senders, receivers,
        weights)``.  At transform, labels unseen at fit extend the
        enumeration."""
        graphs = normalize_input(X)
        if self._method_calling in (1, 2):
            self._enum = {}
        elif not hasattr(self, "_enum"):
            raise ValueError("fit before transform")
        sizes = sorted(_size_buckets(graphs).items())
        if stream is None:
            stream = sum(len(idxs) * V * V * 4
                         for V, idxs in sizes) > self._STREAM_BYTES
        buckets = []
        unit = True
        for V, idxs in sizes:
            nb = len(idxs)
            A = [] if stream else np.zeros((nb, V, V), dtype=np.float32)
            L = np.zeros((nb, V), dtype=np.int32)
            M = np.zeros((nb, V), dtype=bool)
            for bi, gi in enumerate(idxs):
                g = graphs[gi]
                if stream:
                    A.append((g.senders, g.receivers, g.weights))
                    if unit and len(g.weights) and \
                            not np.all(g.weights == 1.0):
                        unit = False
                elif len(g.senders):
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
            if unit and not stream:
                w = A[A != 0]
                if w.size and not np.all(w == 1.0):
                    unit = False
            buckets.append((np.asarray(idxs, np.int32), A, L, M))
        return {"n": len(graphs), "buckets": buckets, "unit": unit,
                "stream": stream, "counts": {},
                "max_V": max((b[3].shape[1] for b in buckets), default=1)}

    # ------------------------------------------------------------------ #
    def _fw(self, p):
        """Floyd-Warshall of every bucket of a dense parse."""
        dev = self._device()
        return [_Bucket(_up(A, dev), _up(M, dev), _up(Lb, dev),
                        _up(idxs, dev), p["unit"])
                for idxs, A, Lb, M in p["buckets"]]

    @staticmethod
    def _count_dtype(*ps):
        """Width of the count Grams of the parses ``ps``: a graph of V
        vertices has at most V (V - 1) valid pairs, so an entry is at
        most (V (V - 1))^2 for V the widest bucket; f32 sums of integers
        are exact below 2^24, f64 ones below 2^53."""
        V = max(p["max_V"] for p in ps)
        return count_dtype((V * (V - 1)) ** 2)

    def _n_labels(self):
        return max(len(self._enum), 1) if self.with_labels else 1

    def _plan(self, *ps):
        """(route, L, D, fw) for the dense parses ``ps``: route "direct"
        or "hash"; ``fw`` their Floyd-Warshall buckets when the observed
        distance range had to be read (else None)."""
        L = self._n_labels()
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

    def _stream_plan(self, *ps):
        """(route, L, D) for parses ``ps`` of which one or more is in
        stream mode: route "bfs", "slab", or None when the parses must be
        materialized (weighted edges, or a slab feature space past
        ``_DIRECT_MAX_WIDTH`` or the int32 segment range)."""
        L = self._n_labels()
        D = max(p["max_V"] for p in ps)
        if not all(p["unit"] for p in ps):
            return None, L, D
        if self._STREAM_BFS:
            return "bfs", L, D
        if (L * L * D <= self._DIRECT_MAX_WIDTH
                and self._counts_ok(L * L * D, *ps)):
            return "slab", L, D
        return None, L, D

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
        ps = [px] if py is None else [px, py]
        if any(p["stream"] for p in ps):
            route, L, D = self._stream_plan(*ps)
            if route == "bfs":
                return self._bfs_gram(px, py, L, D)
            if route == "slab":
                return self._slab_gram(px, py, L, D)
            for p in ps:
                self._materialize(p)
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
        dt = self._count_dtype(parsed)
        if parsed["stream"]:
            route, L, D = self._stream_plan(parsed)
            if route == "bfs":
                return self._bfs_diag(parsed, L, D)
            if route == "slab":
                # sum_f c^2 is the same in every (L, D) encoding: any
                # cached counts matrix gives the diagonal
                C = next(iter(parsed["counts"].values()), None)
                if C is None:
                    C = self._slab_counts(parsed, L, D)
                C = C[:n].to(dt)
                return (C * C).sum(1)
            self._materialize(parsed)
        route, L, D, fw = self._plan(parsed)
        fw = fw[0] if fw else self._fw(parsed)
        if route == "direct":
            gids, ids = self._direct_items(fw, L, D)
            return counts_diag(gids, ids, torch.ones_like(
                ids, dtype=torch.float32), True, n, L * L * D, dtype=dt)
        gids, gl, gv, n_rep, dcorr = self._hash_labels([fw], [n])
        return counts_diag(gids, gl, torch.ones_like(
            gids, dtype=torch.float32), gv, n, max(n_rep, 1), dtype=dt) \
            .to(torch.float64) + dcorr

    # ---------------------------------------------------- stream mode -- #
    def _materialize(self, p):
        """Turn a stream-mode parse into dense buckets in place (the
        weighted and too-wide routes need them)."""
        if not p["stream"]:
            return
        warnings.warn("ShortestPath streaming fallback: materializing "
                      "dense buckets on host (weighted or very wide "
                      "label space at large scale)")
        buckets = []
        for idxs, coo, Lb, M in p["buckets"]:
            V = M.shape[1]
            A = np.zeros((len(idxs), V, V), np.float32)
            for bi, (s, r, w) in enumerate(coo):
                if len(s):
                    A[bi, s, r] = w
            buckets.append((idxs, A, Lb, M))
        p["buckets"] = buckets
        p["stream"] = False

    @staticmethod
    def _counts_ok(width, *ps):
        """True iff the segment g * width + id of every pair of the
        parses ``ps`` (the park row's included) stays within the int32
        range: the JAX package's slab route needs it, and the port keeps
        its routes."""
        n = max(p["n"] for p in ps)
        return (n + 1) * width <= (1 << 31) - 1

    def _slab_cap(self, V):
        """Graphs a slab of bucket width V holds."""
        return int(max(8, min(512, self._STREAM_SLAB_BYTES // (V * V * 4))))

    def _slabs(self, p):
        """(A f32 [S, V, V], M, labels, graph ids) a slab, on the kernel's
        device: a stream parse's edges go up once a slab and are
        scattered into a zeroed adjacency there (unit weights); a dense
        parse's bucket rows go up as they are."""
        dev = self._device()
        for idxs, Ab, Lb, M in p["buckets"]:
            V = M.shape[1]
            cap = self._slab_cap(V)
            for s0 in range(0, len(idxs), cap):
                sl = slice(s0, s0 + cap)
                nb = len(idxs[sl])
                if p["stream"]:
                    flat = [bi * V * V + s.astype(np.int64) * V + r
                            for bi, (s, r, _) in enumerate(Ab[sl])]
                    A = torch.zeros(nb * V * V, dtype=torch.float32,
                                    device=dev)
                    if flat:
                        A[_up(np.concatenate(flat), dev)] = 1.0
                    A = A.view(nb, V, V)
                else:
                    A = _up(Ab[sl], dev)
                yield (A, _up(M[sl], dev), _up(Lb[sl], dev),
                       _up(idxs[sl], dev))

    def _slab_counts(self, p, L, D):
        """Per-graph triplet counts ``C [n + 1, L^2 D]`` on the kernel's
        device, built a slab at a time (K3, then one ``index_add_`` of
        the slab's ids; row n parks the invalid pairs).  Cached in
        ``p["counts"]`` by (L, D)."""
        key = (L, D)
        C = p["counts"].get(key)
        if C is not None:
            return C
        n, W = p["n"], L * L * D
        V = p["max_V"]
        # a cell counts at most V (V - 1) pairs
        C = torch.zeros((n + 1) * W, dtype=count_dtype(V * (V - 1)),
                        device=self._device())
        for A, M, Lb, gids in self._slabs(p):
            b = _Bucket(A, M, Lb, gids, True)
            seg = torch.where(b.valid, b.pair_gids() * W
                              + b.direct_ids(L, D), n * W)
            C.index_add_(0, seg.reshape(-1),
                         b.valid.reshape(-1).to(C.dtype))
            del A, b, seg   # free this slab before the next is built
        C = C.view(n + 1, W)
        p["counts"][key] = C
        return C

    def _slab_gram(self, px, py, L, D):
        """The slab route's Gram: one product of the count matrices
        (rows = Y, columns = X for a transform, which also leaves Y's
        diagonal in ``_Y_diag_cache``)."""
        if py is None:
            dt = self._count_dtype(px)
            Cx = self._slab_counts(px, L, D)[:px["n"]].to(dt)
            with full_fp32():
                return Cx @ Cx.T
        dt = self._count_dtype(px, py)
        Cx = self._slab_counts(px, L, D)[:px["n"]].to(dt)
        Cy = self._slab_counts(py, L, D)[:py["n"]].to(dt)
        self._Y_diag_cache = (Cy * Cy).sum(1)
        with full_fp32():
            return Cy @ Cx.T

    def _bfs_counts_coo(self, p, L, D):
        """The host COO triplet-count stream ``(gids int32, ids int64,
        counts int64)`` of a parse, by the native batched-BFS engine
        (unit weights only; ids in the device encoding (l_u * L + l_v) *
        D + d).  Cached in ``p["bfs_coo"]`` by (L, D); a stream cached
        under (L0, D0) with L0 <= L and D0 <= D (labels unseen at fit
        extended L) is re-encoded instead of counted again.  The
        engine's seconds add up in ``p["bfs_s"]``."""
        from ..native import sp_bfs_counts_native
        key = (L, D)
        cache = p.setdefault("bfs_coo", {})
        if key in cache:
            return cache[key]
        for (L0, D0), (g, ids, c) in cache.items():
            if L0 <= L and D0 <= D:
                pair, d = np.divmod(ids, D0)
                lu, lv = np.divmod(pair, L0)
                cache[key] = (g, (lu * L + lv) * D + d, c)
                return cache[key]
        t = time.perf_counter()
        n = p["n"]
        per = [None] * n
        for idxs, Ab, Lb, M in p["buckets"]:
            for bi, gi in enumerate(idxs):
                m = int(M[bi].sum())
                if p["stream"]:
                    s, r, _w = Ab[bi]
                else:
                    s, r = np.nonzero(Ab[bi])
                per[int(gi)] = (m, s, r, Lb[bi, :m])
        node_off = np.zeros(n + 1, np.int64)
        node_off[1:] = np.cumsum([it[0] for it in per])
        N = int(node_off[-1])
        deg_off = np.zeros(N + 1, np.int64)
        adjs = []
        labs = np.zeros(N, np.int32)
        for gi, (m, s, r, lb) in enumerate(per):
            lo = int(node_off[gi])
            if m:
                labs[lo:lo + m] = lb
            cnt = np.bincount(np.asarray(s, np.int64), minlength=m)
            deg_off[lo + 1:lo + m + 1] = cnt
            order = np.argsort(s, kind="stable")
            adjs.append(np.asarray(r, np.int32)[order])
        adj_off = np.cumsum(deg_off)
        adj = (np.concatenate(adjs) if adjs else np.zeros(0, np.int32))
        cache[key] = sp_bfs_counts_native(node_off, adj_off, adj, labs, L,
                                          D)
        p["bfs_s"] = p.get("bfs_s", 0.0) + time.perf_counter() - t
        return cache[key]

    def _bfs_gram(self, px, py, L, D):
        """Symmetric or rectangular Gram from the BFS count streams,
        over the observed fit keys (compacted with ``np.unique``; keys
        seen only in the transform set have no fit column and drop); a
        transform also leaves Y's diagonal in ``_Y_diag_cache``."""
        dev = self._device()
        gx, kx, wx = self._bfs_counts_coo(px, L, D)
        wx = wx.astype(np.float64)
        keys = np.unique(kx)
        W = max(len(keys), 1)
        host = W > self._BFS_DEVICE_MAX_W
        ids_x = np.searchsorted(keys, kx)
        if py is None:
            dt = self._count_dtype(px)
            if host:
                K = sparse_counts_gram(gx, ids_x, px["n"], weights=wx,
                                       dtype=dt, device=dev)
                # the stream can hold ~1e9 items (WL-SP generations on hub
                # graphs): a transform recounts it
                px["bfs_coo"].clear()
                return torch.from_numpy(K)
            return coo_counts_gram(torch.from_numpy(gx).to(dev), ids_x, wx,
                                   True, px["n"], W, dtype=dt)
        dt = self._count_dtype(px, py)
        gy, ky, wy = self._bfs_counts_coo(py, L, D)
        wy = wy.astype(np.float64)
        pos = np.minimum(np.searchsorted(keys, ky), max(len(keys) - 1, 0))
        hit = (keys[pos] == ky) if len(keys) else np.zeros(len(ky), bool)
        self._Y_diag_cache = self._bfs_diag(py, L, D)
        nx, ny = px["n"], py["n"]
        if host:
            import scipy.sparse as sp
            Cx = sp.csr_matrix((wx, (gx, ids_x)), shape=(nx, W))
            Cy = sp.csr_matrix((wy[hit], (gy[hit], pos[hit])),
                               shape=(ny, W))
            return torch.from_numpy((Cy @ Cx.T).toarray())
        return coo_counts_gram_rect(
            torch.from_numpy(gy).to(dev), pos, wy, hit,
            torch.from_numpy(gx).to(dev), ids_x, wx, True, ny, nx, W,
            dtype=dt)

    def _bfs_diag(self, p, L, D):
        """Each graph's sum of squared counts, f64 numpy."""
        g, _k, w = self._bfs_counts_coo(p, L, D)
        return np.bincount(g, weights=w.astype(np.float64) ** 2,
                           minlength=p["n"])[:p["n"]]


class ShortestPathAttr(Kernel):
    """Attributed shortest-path kernel (reference
    shortest_path.py:131-165), reformulated as per-distance products."""

    _host_parse = True

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
