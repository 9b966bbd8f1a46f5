"""Pyramid match kernel (Nikolentzos et al. 2017).

The counterpart of ``grakel_tpu/kernels/pyramid_match.py``.  Reference
semantics:

* per graph: d-dim vertex embedding U = |top-d adjacency eigenvectors|
  (scipy ``eigs`` when n > d+1 with ncv=10d, dense ``eig`` otherwise,
  eigenvalues sorted descending);
* histograms at levels j = 0..L-1 with 2^j cells per dimension; labeled
  graphs count per (label*d + dim, cell) row; transform-time unseen
  labels extend the label enumeration;
* pairwise value, the closed form of the reference's progressive
  accumulation over the per-level intersections I_p:

      k = I_{L-1} + sum_{p=0}^{L-2} 2^{-(L-p-1)} ((L-p) I_p
                                                  - (L-p-1) I_{p+1})

Embeddings of graphs with at least ``_DEVICE_EMBED_MIN_N`` vertices come
from the slab-batched Lanczos on the kernel's device (ops/spectral.py);
smaller graphs keep the scipy path.  The level intersections I_p are
computed on the kernel's device with the integer weights 2^(L-1) c_p
folded in: the levels whose count expansion stays narrow (labeled ones)
one :func:`min_intersection_gram` call each on the tensor-core kernel
K1-tc, the others (unlabeled ones) weighted and concatenated into one
call of the CUDA-core kernel K1; one division by 2^(L-1) follows.
Integer-valued, exact in f32 while no entry can reach 2^24; past that
bound the levels are folded in f64 (``_combined_gram``).

Past ``_DENSE_MAX_W`` (wide label universes) the kernel switches to a
SPARSE path: histogram entries become unary-expanded 0/1 features
((level, row, cell, t), t = 1..count — min(a, b) = sum_t [a>=t][b>=t]),
weighted sqrt(c_p), and the per-level intersections fuse into ONE
chunked counts-GEMM (ops/gram.py).  The diagonal is the closed form
n_vertices * dims * sum_p c_p.  Transform maps expanded keys through the
fit enumeration — exact, because a key absent from either side has
min(a, 0) = 0.
"""

from __future__ import annotations

from itertools import chain

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..ops import intersect
from ..ops.gram import coo_counts_gram, coo_counts_gram_rect
from ..ops.intersect import min_intersection_gram

__all__ = ["PyramidMatch"]


class PyramidMatch(Kernel):
    """Pyramid match kernel."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 with_labels=True, L=4, d=6):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.with_labels = with_labels
        self.L = L
        self.d = d

    def initialize(self):
        if not isinstance(self.with_labels, bool):
            raise TypeError("with_labels must be a boolean")
        if not isinstance(self.L, int) or self.L < 0:
            raise TypeError("L must be a non-negative integer")
        if not isinstance(self.d, int) or self.d <= 0:
            raise TypeError("d must be a positive integer")

    # ------------------------------------------------------------------ #
    def _embed(self, A):
        """|top-d eigenvector| embedding on the host, as the reference."""
        n = A.shape[0]
        if n > self.d + 1:
            from scipy.sparse import csr_matrix
            from scipy.sparse.linalg import eigs, ArpackError
            try:
                Lambda, U = eigs(csr_matrix(A, dtype=float), k=self.d,
                                 ncv=10 * self.d)
            except ArpackError:
                # edgeless / degenerate adjacency (ARPACK -9: zero
                # starting vector) — the dense solver handles it
                Lambda, U = np.linalg.eig(A)
                Lambda, U = Lambda[:self.d], U[:, :self.d]
            idx = Lambda.argsort()[::-1]
            U = U[:, idx]
        else:
            Lambda, U = np.linalg.eig(A)
            idx = Lambda.argsort()[::-1]
            U = U[:, idx][:, :self.d]
        return np.absolute(U)

    # graphs at least this large embed through the slab-batched device
    # Lanczos (ops/spectral.py); smaller ones keep scipy, where ARPACK is
    # cheap and matches the reference bit for bit
    _DEVICE_EMBED_MIN_N = 128

    def parse_input(self, X):
        graphs = normalize_input(X)
        # embeddings are STRUCTURE-only, so they live in the graph's
        # structural cache — shared across WL-style generations
        ck = f"pm_embed_{self.d}"
        big = [(i, g.n, g.senders, g.receivers, g.weights)
               for i, g in enumerate(graphs)
               if ck not in g._cache and g.n >= self._DEVICE_EMBED_MIN_N]
        dev_U = {}
        if big:
            from ..ops.spectral import batched_topd_abs_eigvecs
            dev_U = batched_topd_abs_eigvecs(big, self.d, self._device())
        Us, Ls = [], []
        for i, g in enumerate(graphs):
            if ck not in g._cache:
                U = dev_U.get(i)
                if U is None:
                    U = self._embed(g.get_adjacency_matrix())
                g._cache[ck] = U
            Us.append((g.n, g._cache[ck]))
            if self.with_labels:
                labs = g.get_labels(label_type="vertex", return_none=True)
                if labs is None:
                    raise ValueError(
                        "PyramidMatch with_labels=True requires node labels")
                Ls.append(labs)
        if self.with_labels:
            if self._method_calling in (1, 2):
                self._labels = set()
                for L in Ls:
                    self._labels |= set(L.values())
                self._labels = {l: i for i, l in enumerate(self._labels)}
                labels = self._labels
            else:
                rest = set()
                for L in Ls:
                    rest |= set(L.values())
                rest -= set(self._labels.keys())
                labels = dict(chain(
                    self._labels.items(),
                    ((j, i) for i, j in enumerate(rest, len(self._labels)))))
        else:
            Ls, labels = None, None
        num_labels = len(labels) if labels is not None else 1
        if self._method_calling in (1, 2):
            self._sparse_mode = (num_labels * self.d * (1 << max(
                self.L - 1, 0)) > self._DENSE_MAX_W)
        if self._sparse_mode:
            return self._sparse_entries(Us, Ls, labels)
        return self._histograms(Us, Ls, labels)

    # densest-level width past which the sparse unary path takes over
    _DENSE_MAX_W = 4096

    def _level_coeffs(self):
        """k = sum_p c_p I_p — closed-form positive level weights."""
        L = self.L
        c = np.zeros(max(L, 1))
        if L == 0:
            return c
        c[L - 1] = 1.0
        for p in range(L - 1):
            w = 1.0 / 2 ** (L - p - 1)
            c[p] += w * (L - p)
            c[p + 1] -= w * (L - p - 1)
        return c

    def _sparse_entries(self, Us, Ls, labels):
        """Unary-expanded COO features for the sparse Gram path.

        Returns {"sparse", "n", "gids", "ekeys", "mass"}:
        per occurrence t = 1..count of histogram cell (level, row, cell),
        one int64 key (lvl << 60 | row << 30 | cell << 20 | t) — a fixed
        layout so transform keys map through the fit enumeration."""
        d = self.d
        if self.L > 8:
            raise ValueError("sparse PyramidMatch path supports L <= 8")
        gl, rl, cl, ll = [], [], [], []
        mass = np.zeros(len(Us))
        for gi, (n, u) in enumerate(Us):
            u = u[:n]
            if n == 0:
                continue
            du = u.shape[1]
            mass[gi] = n * du
            if Ls is not None:
                row_lab = np.fromiter(
                    (labels[Ls[gi][p]] for p in range(n)), np.int64, n)
                rows = (row_lab[:, None] * d
                        + np.arange(du)[None, :]).ravel()
            else:
                rows = np.broadcast_to(np.arange(du), (n, du)).ravel()
            for j in range(self.L):
                k = 1 << j
                T = np.floor(u * k).astype(np.int64)
                T[T == k] = k - 1
                gl.append(np.full(rows.size, gi, np.int64))
                rl.append(rows)
                cl.append(T.ravel())
                ll.append(np.full(rows.size, j, np.int64))
        if not gl:
            return {"sparse": True, "n": len(Us),
                    "gids": np.zeros(0, np.int64),
                    "ekeys": np.zeros(0, np.int64), "mass": mass}
        gids = np.concatenate(gl)
        rows = np.concatenate(rl)
        cells = np.concatenate(cl)
        lvls = np.concatenate(ll)
        if rows.size and (int(rows.max()) >= 1 << 30
                          or len(Us) >= 1 << 19):
            raise ValueError("sparse PyramidMatch key space exceeded")
        # per-(gid, lvl, row, cell) counts -> unary expansion t = 1..c
        ckey = ((((gids << 4) | lvls) << 30 | rows) << 10) | cells
        uk, counts = np.unique(ckey, return_counts=True)
        if counts.size and int(counts.max()) >= 1 << 20:
            raise ValueError("sparse PyramidMatch count space exceeded")
        offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
        t = (np.arange(int(counts.sum()), dtype=np.int64)
             - np.repeat(offs, counts) + 1)
        g_rep = np.repeat(uk >> 44, counts)
        lvl_rep = np.repeat((uk >> 40) & 0xF, counts)
        row_rep = np.repeat((uk >> 10) & ((1 << 30) - 1), counts)
        cell_rep = np.repeat(uk & ((1 << 10) - 1), counts)
        ekeys = (lvl_rep << 60) | (row_rep << 30) | (cell_rep << 20) | t
        return {"sparse": True, "n": len(Us), "gids": g_rep,
                "ekeys": ekeys, "mass": mass}

    def _histograms(self, Us, Ls=None, labels=None):
        """Per-graph per-level cell-count histograms, scattered for ALL
        graphs at once (one ``np.add.at`` per level)."""
        num_labels = len(labels) if labels is not None else 1
        G = len(Us)
        vals, gid_l, row_l = [], [], []
        for gi, (n, u) in enumerate(Us):
            u = u[:n]
            if n == 0 or u.size == 0:
                continue
            du = u.shape[1]
            dims = np.broadcast_to(np.arange(du), (n, du))
            if Ls is not None:
                row_lab = np.fromiter(
                    (labels[Ls[gi][p]] for p in range(n)), np.int64, n)
                rows = row_lab[:, None] * self.d + dims
            else:
                rows = dims
            vals.append(u.ravel())
            row_l.append(rows.ravel())
            gid_l.append(np.full(n * du, gi, np.int64))
        R = self.d * num_labels
        levels = []
        if vals:
            v = np.concatenate(vals)
            rr = np.concatenate(row_l)
            gg = np.concatenate(gid_l)
        for j in range(self.L):
            k = 2 ** j
            D = np.zeros((G, R, k))
            if vals:
                T = np.floor(v * k).astype(np.int64)
                T[T == k] = k - 1
                np.add.at(D, (gg, rr, T), 1)
            levels.append(D)
        return [[levels[j][gi] for j in range(self.L)] for gi in range(G)]

    # ------------------------------------------------------------------ #
    def _level_matrix(self, parsed, level, width):
        """Stack level-``level`` histograms flattened to ``width``."""
        n = len(parsed)
        out = np.zeros((n, width), np.float32)
        for i, du in enumerate(parsed):
            if len(du) == 0:
                continue
            flat = du[level].ravel()
            m = min(len(flat), width)
            out[i, :m] = flat[:m]
        return out

    # an f32 sum of integers is exact below this
    _F32_EXACT = 2 ** 24

    def _combined_gram(self, px, py):
        """Dense-path Gram: k = sum_p c_p I_p, the level intersections
        I_p [len(py), len(px)] computed on the kernel's device.  The c_p
        are dyadic rationals; scaled by 2^(L-1) every weight is an exact
        integer w_p.  The level matrices are counts built here on the
        host, so every decision below is made from host data and nothing
        is read back from the device.

        While no entry of sum_p w_p I_p can reach 2^24 (bounded per level
        by the smaller of the column maxima's min-sum and the row masses)
        the weighted sum is exact in f32: each level is routed
        (``min_gram_route`` on its own column maxima), the levels that
        take K1 are scaled by w_p (w min(a, b) = min(w a, w b)) and
        concatenated along L for ONE K1 call, and the K1-tc levels are
        concatenated too, for ONE K1-tc call whose expanded columns carry
        their level's w_p as their int8 value (w_p <= 127; heavier levels
        fold in one call each, w_p in the epilogue), adding into K1's
        result in its epilogue.  From
        2^24 on, each level's f32 Gram is computed apart (exact while the
        level stays below 2^24) and the levels are folded in f64, as the
        JAX package's per-level path does.  One division by 2^(L-1)
        finishes in f64.

        Row truncation to the smaller label count (reference :270-277) is
        equivalent to truncating the flattened feature width to the
        smaller of the two, because rows are label-major and each level's
        cell count is shared."""
        if self.L == 0:
            return torch.zeros((len(py), len(px)), dtype=torch.float64)
        dev = self._device()
        sym = py is px
        cs = self._level_coeffs()
        scale = float(2 ** max(self.L - 1, 0))
        levels, bound = [], 0.0   # (w_p, Ma, Mb, their column maxima)
        for j in range(self.L):
            cj = float(round(cs[j] * scale))
            wx = next((d[j].size for d in px if len(d)), 0)
            wy = next((d[j].size for d in py if len(d)), 0)
            w = min(wx, wy) if (wx and wy) else 0
            if w == 0 or cj == 0.0:
                continue
            Ma = self._level_matrix(py, j, w)
            Mb = Ma if sym else self._level_matrix(px, j, w)
            mx = (Ma.max(0), Mb.max(0))
            bound += cj * min(float(np.minimum(*mx).sum()),
                              float(Ma.sum(1).max()), float(Mb.sum(1).max()))
            levels.append((cj, Ma, Mb, mx))
        if not levels:
            return torch.zeros((len(py), len(px)), dtype=torch.float64)

        def upload(Ma, Mb):
            A = torch.from_numpy(Ma).to(dev)
            return A, (A if sym else torch.from_numpy(Mb).to(dev))

        if bound >= self._F32_EXACT:
            K = None
            for cj, Ma, Mb, mx in levels:
                I = min_intersection_gram(*upload(Ma, Mb), count_max=mx)
                I = I.to(torch.float64)
                K = I.mul_(cj) if K is None else K.add_(I, alpha=cj)
            return K / scale
        routes = [intersect.min_gram_route(*mx, True, sym)
                  for _, _, _, mx in levels]
        group = [lv for lv, r in zip(levels, routes) if r == "min_gram"]
        Kacc = None
        if group:
            Wa = np.concatenate([cj * Ma for cj, Ma, _, _ in group], axis=1)
            Wb = Wa if sym else np.concatenate(
                [cj * Mb for cj, _, Mb, _ in group], axis=1)
            Kacc = min_intersection_gram(*upload(Wa, Wb), route="min_gram")
        tc = [lv for lv, r in zip(levels, routes) if r == "min_gram_tc"]
        # the K1-tc levels whose weight is an int8 indicator value:
        # concatenated for ONE K1-tc call, each column carrying its
        # level's weight; heavier weights (L > 8) fold in one call each
        fused = [lv for lv in tc if lv[0] <= intersect._TC_MAX_WEIGHT]
        if fused:
            Ma = np.concatenate([lv[1] for lv in fused], axis=1)
            Mb = Ma if sym else np.concatenate([lv[2] for lv in fused],
                                               axis=1)
            mx = tuple(np.concatenate([lv[3][k] for lv in fused])
                       for k in (0, 1))
            w = np.concatenate([np.full(lv[1].shape[1], lv[0])
                                for lv in fused])
            Kacc = min_intersection_gram(
                *upload(Ma, Mb), count_max=mx, out=Kacc,
                route="min_gram_tc", weights=w)
        for cj, Ma, Mb, mx in tc:
            if cj > intersect._TC_MAX_WEIGHT:
                Kacc = min_intersection_gram(
                    *upload(Ma, Mb), count_max=mx, out=Kacc, alpha=cj,
                    route="min_gram_tc")
        return Kacc.to(torch.float64) / scale

    def _sparse_gram(self, px, py=None):
        """Fused all-level weighted counts-GEMM (see module docstring)."""
        dev = self._device()
        sqrt_c = np.sqrt(self._level_coeffs())

        def weights(p):
            w = sqrt_c[(p["ekeys"] >> 60).astype(np.int64)] \
                if p["ekeys"].size else np.zeros(0)
            return torch.from_numpy(w.astype(np.float32)).to(dev)

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(dev)

        keys = np.unique(px["ekeys"])
        W = max(len(keys), 1)
        eids_x = np.searchsorted(keys, px["ekeys"])
        valid_x = np.ones(eids_x.shape[0], bool)
        if py is None:
            return coo_counts_gram(t(px["gids"]), t(eids_x), weights(px),
                                   t(valid_x), px["n"], W)
        # rect: enumerate over the FIT side; unseen keys drop (exact —
        # min(a, 0) = 0, and this subsumes the reference's width
        # truncation)
        pos = np.searchsorted(keys, py["ekeys"])
        pos_c = np.minimum(pos, max(len(keys) - 1, 0))
        hit = (keys[pos_c] == py["ekeys"]) if len(keys) else \
            np.zeros(py["ekeys"].shape[0], bool)
        return coo_counts_gram_rect(
            t(py["gids"]), t(pos_c), weights(py), t(hit),
            t(px["gids"]), t(eids_x), weights(px), t(valid_x),
            py["n"], px["n"], W)

    def _gram(self, px, py=None):
        if isinstance(px, dict) and px.get("sparse"):
            return self._sparse_gram(px, py)
        return self._combined_gram(px, px if py is None else py)

    def _diag(self, parsed):
        if isinstance(parsed, dict) and parsed.get("sparse"):
            # self-intersection at every level is the full histogram
            # mass n * dims, so diag = mass * sum_p c_p in closed form
            return parsed["mass"] * float(self._level_coeffs().sum())
        vals = np.zeros(len(parsed))
        for i, du in enumerate(parsed):
            if len(du) == 0:
                continue
            I = [np.sum(du[j]) for j in range(self.L)]
            L = self.L
            k = I[L - 1]
            for p in range(L - 1):
                w = 1.0 / (2 ** (L - p - 1))
                k += w * ((L - p) * I[p] - (L - p - 1) * I[p + 1])
            vals[i] = k
        return vals
