"""Random-walk kernels (geometric / exponential / p-step).

The counterpart of ``grakel_tpu/kernels/random_walk.py``.  The host
parse is the JAX package's, operation for operation, so the host spectra
are equal; the pair numerics run on the kernel's device through
``ops/random_walk.py``:

* ``method_type='fast', kernel_type='geometric', p=None`` (default) on
  symmetric adjacencies: the closed form from each graph's spectrum
  (``eigh`` up to ``_EIG_MAX_N`` vertices, 40 power iterations and the
  walk moments above).  With ``rho = lamda * max|mu|^2 <= 0.9`` the Gram
  is a host f64 product of moment features; above, one
  ``ops.random_walk.spectral_gram`` call a Gram (K9 on a card, one
  launch) over a plan of tiles of up to 32 x 32 graphs ordered by size,
  a symmetric Gram's tiles on or above its diagonal only;
* fast geometric otherwise (directed graphs, or a diverging series with
  moments-only graphs), and ``RandomWalkLabeled``'s fast geometric:
  20 CG steps a pair (``ops.random_walk.pair_cg``, K8 on a card), each
  graph packed once into its bucket's table (labeled: its vertices
  sorted by label), one call a (row bucket, column bucket) over the
  pairs as table rows;
* ``fast`` + (``p`` or exponential): per-graph spectra at parse
  (``np.linalg.eig``), ``k = (u_i^2)^T f(lamda w_i w_j^T) (u_j^2)``;
* ``baseline``: the dense Kronecker system, a solve or a matrix
  exponential; ``p``: iterated matvecs with the mu series.

Reference semantics (grakel/kernels/random_walk.py:181-272, 275-471):
the CG solve of ``(I - lamda * (Ax (x) Ay)) x = 1`` with the matvec
``x - lamda*vec(Ax @ X @ Ay)``, rtol=1e-6, maxiter=20, kernel = sum(x);
``RandomWalkLabeled`` sums the matvec over common ordered label pairs,
computed without the per-label-pair matrices via the mask identity

    sum_k Ax_k X Ay_k = sum_c Dx_c Ax (M o (X Dy_c Ay))

(M[u,v] = [Lx[u] == Ly[v]]).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..ops import random_walk as rw
from ..ops.random_walk import bucket as _bucket

__all__ = ["RandomWalk", "RandomWalkLabeled"]

_CHUNK = 512  # pairs a device call of the p-step, spectral and baselines


class RandomWalk(Kernel):
    """Unlabeled random-walk kernel."""

    _labeled = False

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 lamda=0.1, method_type="fast", kernel_type="geometric",
                 p=None):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.lamda = lamda
        self.method_type = method_type
        self.kernel_type = kernel_type
        self.p = p

    def initialize(self):
        self._spectral_log = []
        if self.method_type not in ("baseline", "fast"):
            raise ValueError('unsupported method_type')
        if self.kernel_type not in ("geometric", "exponential"):
            raise ValueError('unsupported kernel type: either "geometric" '
                             'or "exponential"')
        if self.p is not None:
            if isinstance(self.p, int) and self.p > 0:
                if self.kernel_type == "exponential":
                    self.mu_ = [1.0]
                    fact = 1.0
                    power = 1.0
                    for k in range(1, self.p + 1):
                        fact *= k
                        power *= self.lamda
                        self.mu_.append(power / fact)
                else:
                    self.mu_ = [1.0]
                    power = 1.0
                    for k in range(1, self.p + 1):
                        power *= self.lamda
                        self.mu_.append(power)
            else:
                raise TypeError("p must be a positive integer or None")
        if self.lamda <= 0:
            raise TypeError("lambda must be positive")
        elif self.lamda > 0.5 and self.p is None:
            warnings.warn("random-walk series may fail to converge")

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs = normalize_input(X)
        out = []
        for g in graphs:
            A = g.get_adjacency_matrix()
            item = {"A": np.asarray(A, np.float32), "n": g.n}
            if self._labeled:
                labs = g.get_labels(label_type="vertex", return_none=True)
                if labs is None:
                    raise ValueError(
                        "RandomWalkLabeled requires node labels")
                item["labels"] = [labs[v] for v in range(g.n)]
            if (self.method_type == "fast"
                    and not self._labeled
                    and (self.p is not None
                         or self.kernel_type == "exponential")):
                # spectral data, host-side like the reference (sd, :478)
                w, v = np.linalg.eig(A)
                item["u"] = np.real(np.sum(v, axis=0)).astype(np.float32)
                item["w"] = np.real(w).astype(np.float32)
            elif (self.method_type == "fast" and not self._labeled
                    and self.p is None and self.kernel_type == "geometric"
                    and item["A"].size
                    and np.array_equal(item["A"], item["A"].T)):
                # symmetric adjacency: the geometric kernel has the exact
                # closed form sum_ij s_i^2 t_j^2 / (1 - lamda mu_i nu_j)
                # — evaluated batched instead of one CG per pair
                if g.n <= self._EIG_MAX_N:
                    w, v = np.linalg.eigh(item["A"])
                    item["s2"] = (np.sum(v, axis=0) ** 2).astype(
                        np.float32)
                    item["mu"] = w.astype(np.float32)
                else:
                    # large graphs: moments m_k = 1^T A^k 1 come from
                    # iterated matvecs (eigh is O(n^3)); mu_max via
                    # power iteration gates series convergence
                    A = np.asarray(item["A"], np.float64)
                    v = np.ones(g.n) / np.sqrt(g.n)
                    mu = 0.0
                    for _ in range(40):
                        v = A @ v
                        nrm = np.linalg.norm(v)
                        if nrm == 0:
                            break
                        mu = nrm
                        v = v / nrm
                    item["mu_max"] = float(mu)
                    item["moments_only"] = True
            out.append(item)
        return out

    # above this size, spectral data comes from matvec moments instead
    # of a full eigendecomposition (parse_input)
    _EIG_MAX_N = 512

    # ------------------------------------------------------------------ #
    # graphs a side of a tile of the spectral plan (K9 takes at most 32)
    _SPEC_TILE = rw.K9_TILE

    def _spectral_gram(self, rows, cols, symmetric):
        """Batched exact geometric Gram from per-graph (s2, mu).

        Two regimes by the worst-case series ratio
        rho = lamda * (max |mu|)^2:

        * rho <= 0.9 — moment features: k = sum_k lamda^k m_x[k] m_y[k]
          with m[k] = sum_i s_i^2 mu_i^k; ONE feature GEMM.
        * else — the rational closed form over a tile plan (K9,
          ops.random_walk.spectral_gram), in f64 from the f32 spectra.

        Each call appends ``{"rho", "route", "tiles"}`` to
        ``self._spectral_log``."""
        def item_mu_max(it):
            if it.get("moments_only"):
                return it["mu_max"]
            return float(np.max(np.abs(it["mu"]))) if it["mu"].size \
                else 0.0
        mu_max = max(item_mu_max(it) for it in list(rows) + list(cols))
        rho = self.lamda * mu_max * mu_max
        any_big = any(it.get("moments_only")
                      for it in list(rows) + list(cols))
        if rho <= 0.9:
            K_terms = int(min(64, max(
                8, np.ceil(np.log(1e-9) / np.log(max(rho, 1e-9))))))
            sq = np.sqrt(self.lamda)

            def feats(items):
                # power (sqrt(lamda) * mu)^k, |.| <= sqrt(rho) < 1:
                # bounded for every k (raw mu^k overflows f32 by k~40)
                P = np.zeros((len(items), K_terms), np.float64)
                for a, it in enumerate(items):
                    if it.get("moments_only"):
                        # m_k = 1^T A^k 1 via iterated matvecs, with
                        # sqrt(lamda) folded in to keep magnitudes flat
                        A = np.asarray(it["A"], np.float64)
                        u = np.ones(it["n"])
                        for k in range(K_terms):
                            P[a, k] = u.sum()
                            u = sq * (A @ u)
                        continue
                    m = sq * np.asarray(it["mu"], np.float64)
                    s2 = np.asarray(it["s2"], np.float64)
                    mk = np.ones_like(m)
                    for k in range(K_terms):
                        P[a, k] = s2 @ mk
                        mk = mk * m
                return P
            Pr = feats(rows)
            Pc = Pr if symmetric else feats(cols)
            self._spectral_log.append({"rho": rho, "route": "moments",
                                       "tiles": 0})
            return np.asarray(Pr @ Pc.T)
        if any_big:
            # diverging series with moments-only graphs: no rational
            # evaluation possible without their spectra — pair CG path
            self._spectral_log.append({"rho": rho, "route": "cg",
                                       "tiles": 0})
            return None

        # one K9 launch over the distinct pairs: the plan orders the
        # graphs by size and keeps a symmetric Gram's tiles on or above
        # its diagonal; each side's spectra go to the device once and
        # the Gram comes back once, mirrored and in input order
        dev = self._device()
        plan = rw.spectral_plan([it["n"] for it in rows],
                                [it["n"] for it in cols], symmetric,
                                self._SPEC_TILE)

        def packed(items, order):
            return rw.pack_spectra([it["s2"] for it in items],
                                   [it["mu"] for it in items], order, dev)
        spec_r = packed(rows, plan.order_r)
        spec_c = spec_r if symmetric else packed(cols, plan.order_c)
        K = rw.spectral_gram(spec_r, spec_c, plan, float(self.lamda))
        self._spectral_log.append({"rho": rho, "route": "tile",
                                   "tiles": len(plan.tiles)})
        return K.cpu().numpy()

    def _gram(self, px, py=None):
        symmetric = py is None
        rows = px if symmetric else py
        cols = px
        if (not self._labeled and self.method_type == "fast"
                and self.p is None and self.kernel_type == "geometric"
                and all("s2" in it or it.get("moments_only")
                        for it in list(rows) + list(cols))):
            K = self._spectral_gram(rows, cols, symmetric)
            if K is not None:
                return K
        enum, n_labels = None, 0
        if self._labeled:
            enum = {}
            for it in list(rows) + ([] if symmetric else list(cols)):
                for lab in it["labels"]:
                    if lab not in enum:
                        enum[lab] = len(enum)
            n_labels = max(len(enum), 1)
        if (self.method_type == "fast" and self.p is None
                and self.kernel_type == "geometric"):
            return self._cg_gram(rows, cols, symmetric, enum, n_labels)
        K = np.zeros((len(rows), len(cols)), np.float64)
        pairs = []
        for i in range(len(rows)):
            for j in range(len(cols)):
                if symmetric and j < i:
                    continue
                pairs.append((i, j))
        # group by padded size pair for static shapes
        groups = {}
        for i, j in pairs:
            key = (_bucket(rows[i]["n"]), _bucket(cols[j]["n"]))
            groups.setdefault(key, []).append((i, j))
        for (V1, V2), ps in groups.items():
            for lo in range(0, len(ps), _CHUNK):
                chunk = ps[lo:lo + _CHUNK]
                vals = self._pair_chunk(rows, cols, chunk, V1, V2, enum,
                                        n_labels)
                for (i, j), v in zip(chunk, vals):
                    K[i, j] = v
                    if symmetric:
                        K[j, i] = v
        return K

    def _cg_gram(self, rows, cols, symmetric, enum, n_labels):
        """The fast geometric Gram by pair CG: each graph packed once into
        its bucket's table (labeled: vertices sorted by label), one
        ``ops.random_walk.pair_cg`` call a (row bucket, column bucket)
        over the pairs of table rows (i <= j when symmetric), every
        result fetched at once."""
        dev = self._device()

        def tables(items):
            by = {}
            for i, it in enumerate(items):
                by.setdefault(_bucket(it["n"]), []).append(i)
            out = {}
            for V, idx in by.items():
                labels = None if enum is None else [
                    [enum[l] for l in items[i]["labels"]] for i in idx]
                A, n, L = rw.cg_table([items[i]["A"] for i in idx], V,
                                      labels)
                out[V] = (np.asarray(idx), [
                    None if x is None else torch.from_numpy(x).to(dev)
                    for x in (A, n, L)])
            return out
        tr = tables(rows)
        tc = tr if symmetric else tables(cols)
        vals, where_r, where_c = [], [], []
        for ir, (A1, n1, L1) in tr.values():
            for ic, (A2, n2, L2) in tc.values():
                I, J = np.meshgrid(np.arange(len(ir)), np.arange(len(ic)),
                                   indexing="ij")
                I, J = I.ravel(), J.ravel()
                if symmetric:
                    keep = ir[I] <= ic[J]
                    I, J = I[keep], J[keep]
                if not len(I):
                    continue
                t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
                vals.append(rw.pair_cg(A1, A2, n1, n2, t(I), t(J),
                                       self.lamda, L1, L2, n_labels))
                where_r.append(ir[I])
                where_c.append(ic[J])
        K = np.zeros((len(rows), len(cols)), np.float64)
        if vals:
            v = torch.cat(vals).cpu().numpy()
            i, j = np.concatenate(where_r), np.concatenate(where_c)
            K[i, j] = v
            if symmetric:
                K[j, i] = v
        return K

    def _pair_chunk(self, rows, cols, chunk, V1, V2, enum, n_labels):
        B = len(chunk)
        dev = self._device()

        def pad_A(item, V):
            n = item["n"]
            A = np.zeros((V, V), np.float32)
            A[:n, :n] = item["A"]
            return A

        Ax = np.zeros((B, V1, V1), np.float32)
        Ay = np.zeros((B, V2, V2), np.float32)
        nx = np.zeros(B, np.int32)
        ny = np.zeros(B, np.int32)
        for b, (i, j) in enumerate(chunk):
            Ax[b], nx[b] = pad_A(rows[i], V1), rows[i]["n"]
            Ay[b], ny[b] = pad_A(cols[j], V2), cols[j]["n"]
        t = lambda a: torch.from_numpy(a).to(dev)
        Ax, Ay, nx, ny = t(Ax), t(Ay), t(nx), t(ny)
        host = lambda v: v.cpu().numpy()

        fast = self.method_type == "fast"
        if self._labeled:
            Lx = np.full((B, V1), -1, np.int32)
            Ly = np.full((B, V2), -2, np.int32)
            for b, (i, j) in enumerate(chunk):
                Lx[b, :rows[i]["n"]] = [enum[l] for l in rows[i]["labels"]]
                Ly[b, :cols[j]["n"]] = [enum[l] for l in cols[j]["labels"]]
            Lx, Ly = t(Lx), t(Ly)
            if self.p is not None:
                return host(rw.pair_pstep_labeled(Ax, Ay, Lx, Ly, nx, ny,
                                                  tuple(self.mu_)))
            return host(rw.pair_baseline_labeled(
                Ax, Ay, Lx, Ly, nx, ny, self.lamda,
                self.kernel_type == "exponential"))

        if fast:  # spectral: p-step or exponential
            ux = np.zeros((B, V1), np.float32)
            wx = np.zeros((B, V1), np.float32)
            uy = np.zeros((B, V2), np.float32)
            wy = np.zeros((B, V2), np.float32)
            for b, (i, j) in enumerate(chunk):
                n1, n2 = rows[i]["n"], cols[j]["n"]
                ux[b, :n1] = rows[i]["u"]
                wx[b, :n1] = rows[i]["w"]
                uy[b, :n2] = cols[j]["u"]
                wy[b, :n2] = cols[j]["w"]
            return host(rw.pair_spectral(
                t(ux), t(wx), t(uy), t(wy), self.lamda,
                tuple(getattr(self, "mu_", [1.0])),
                self.p is None and self.kernel_type == "exponential"))
        # baseline
        if self.p is not None:
            return host(rw.pair_pstep(Ax, Ay, nx, ny, tuple(self.mu_)))
        if self.kernel_type == "geometric":
            return host(rw.pair_baseline_geometric(Ax, Ay, nx, ny,
                                                   self.lamda))
        return host(rw.pair_baseline_exponential(Ax, Ay, nx, ny,
                                                 self.lamda))


class RandomWalkLabeled(RandomWalk):
    """Label-filtered random-walk kernel (reference random_walk.py:275)."""

    _labeled = True
