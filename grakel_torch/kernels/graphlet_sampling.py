"""Graphlet sampling kernel (Shervashidze et al. 2009).

The counterpart of ``grakel_tpu/kernels/graphlet_sampling.py``: the same
draw stream (the numpy ``RandomState`` the caller passes), the same bin
keys and count bookkeeping, so its Grams equal the JAX package's.
Canonical codes run on the kernel's device (K7 on a card,
``ops/canonical.py``); the Grams are one GEMM on the device in
``ops.gram.count_dtype`` of a host bound on their entries (f32 below
2^24, f64 from there, where the JAX package's f32 Gram rounds).

Reference semantics (grakel/kernels/graphlet_sampling.py):

* ``sampling=None``: exhaustive enumeration of all connected k-subsets
  (ConSubg, functions.pyx:177-281); ``sampling={"n_samples": n}``:
  n uniform random vertex subsets of sizes 3..k; ``sampling={"delta",
  "epsilon", "a"}``: sample count from the sample-complexity bound with
  the isomorphism-count table {3:4,...,9:13599} (+ cubic interpolation
  past 9) (:155-232);
* each sampled graphlet is binned into an isomorphism class; the
  reference linearly scans bliss ``isomorphic()`` calls (:419-467) —
  here isomorphism classes are CANONICAL CODES (min-over-permutations,
  batched on device, ops/canonical.py) so binning is a dict lookup; the
  reference's exact count bookkeeping (the bin-creating sample counts 1,
  every matching sample adds 1 on top of an initial 1) is reproduced
  faithfully;
* phi = bin-count matrix; K = phi phi^T (GEMM); transform-time new bins
  extend the fit bins (:269-284).

Graphlets of size > 8 are binned by their EXACT canonical form (the
individualization-refinement engine in isomorphism.py / native
canonical.cpp — the framework's bliss replacement), so ``k=9+`` needs
no optional dependency and stays a dict lookup.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from scipy.interpolate import interp1d

from .base import Kernel, normalize_input
from ..estimator import NotFittedError, check_random_state
from ..ops.canonical import canonical_codes, MAX_DEVICE_SIZE
from ..ops.consubg import connected_subsets
from ..ops.gram import count_dtype, gram_gemm, gram_rect

__all__ = ["GraphletSampling"]


class GraphletSampling(Kernel):
    """Graphlet sampling kernel."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 random_state=None, k=5, sampling=None):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.random_state = random_state
        self.k = k
        self.sampling = sampling

    def initialize(self):
        self.random_state_ = check_random_state(self.random_state)
        if not isinstance(self.k, int):
            raise TypeError("k must be an int")
        if self.k > 10:
            warnings.warn("graphlets are too big - computation may be slow")
        elif self.k < 3:
            raise TypeError("k must be bigger than 3")
        sampling = self.sampling
        if sampling is None:
            self.n_samples_ = None
        elif isinstance(sampling, dict):
            if "n_samples" in sampling:
                self.n_samples_ = sampling["n_samples"]
                ignored = [a for a in ("delta", "epsilon", "a")
                           if a in sampling]
                if ignored:
                    warnings.warn("Number of samples defined as input, "
                                  "ignoring arguments: " + ", ".join(ignored))
            elif any(a in sampling for a in ("delta", "epsilon", "a")):
                delta = sampling.get("delta", 0.05)
                epsilon = sampling.get("epsilon", 0.05)
                a = sampling.get("a", -1)
                if not 0 <= delta <= 1:
                    raise TypeError("delta must be in the range (0,1)")
                if not 0 <= epsilon <= 1:
                    raise TypeError("epsilon must be in the range (0,1)")
                if not isinstance(a, int):
                    raise TypeError("a must be an integer")
                elif a == 0:
                    raise TypeError("a cannot be zero")
                elif a < -1:
                    raise TypeError("negative a smaller than -1 have "
                                    "no meaning")
                if a == -1:
                    fallback = {1: 1, 2: 2, 3: 4, 4: 8, 5: 19, 6: 53,
                                7: 209, 8: 1253, 9: 13599}
                    if self.k > 9:
                        warnings.warn(
                            "for such size the number of isomorphisms is "
                            "not known - interpolation on known values "
                            "will be used")
                        a = interp1d(list(fallback.keys()),
                                     list(fallback.values()),
                                     kind="cubic")(self.k)
                    else:
                        a = fallback[self.k]
                self.n_samples_ = math.ceil(
                    2 * (a * np.log10(2) + np.log10(1 / delta))
                    / (epsilon ** 2))
            else:
                raise ValueError(
                    "sampling doesn't have a valid dictionary format")
        else:
            raise TypeError("sampling can either be a dictionary or None")

    # ------------------------------------------------------------------ #
    def _sample(self, A):
        """Yield sampled 0/1 graphlet adjacency arrays in draw order.

        ``A`` is the RAW adjacency: the sampling path binarizes only the
        tiny [r, r] gathers (binarizing the full [n, n] matrix and
        slicing rows first measured ~60 % of REDDIT-M-12K parse — two
        full-matrix copies per graph plus a [r, n] intermediate per
        draw)."""
        if self.n_samples_ is None:
            Ab = (A > 0).astype(int)
            G = {i: set(np.where(Ab[i, :] != 0)[0])
                 for i in range(Ab.shape[0])}
            for s in connected_subsets(G, self.k):
                idx = list(s)
                yield Ab[np.ix_(idx, idx)]
        else:
            s = np.arange(A.shape[0])  # same rs.choice stream as a list
            rs = self.random_state_
            min_r = min(3, A.shape[0])
            max_r = min(self.k, A.shape[0])
            for _ in range(self.n_samples_):
                r = min_r if min_r == max_r else rs.randint(min_r, max_r + 1)
                idx = rs.choice(s, r, replace=False)
                yield (A[np.ix_(idx, idx)] > 0).astype(int)

    def _keys_for(self, samples):
        """Canonical bin keys per sample, preserving sample order.

        Min-perm codes on the kernel's device for sizes <=
        MAX_DEVICE_SIZE (batched per size); larger graphlets get exact
        canonical-form bytes from the general canonicalizer
        (isomorphism.canonical_form) — both are hashable keys, so binning
        stays a dict lookup either way.
        """
        from ..isomorphism import canonical_form
        by_size = {}
        order = []
        for j, Q in enumerate(samples):
            by_size.setdefault(Q.shape[0], []).append((j, Q))
            order.append(None)
        for s, items in by_size.items():
            if s <= MAX_DEVICE_SIZE:
                codes = canonical_codes([Q for _, Q in items],
                                        self._device())
                for (j, _), c in zip(items, codes):
                    order[j] = (s, int(c))
            else:
                for j, Q in items:
                    order[j] = canonical_form(Q)
        return order

    def parse_input(self, X):
        graphs = normalize_input(X)
        if self._method_calling == 1:
            self._graph_bins = {}       # bin index -> key
            self._bin_of = {}           # key -> bin index
        elif self._method_calling == 3:
            self._Y_graph_bins = {}
            self._Y_bin_of = {}
        local_values = {}
        # draw ALL samples first (host RNG, sequential per graph to keep
        # the reference's draw order), then canonicalize them in ONE
        # device batch per graphlet size: one K7 launch a size, not one a
        # graph
        per_graph = []
        for g in graphs:
            A = g.get_adjacency_matrix(copy=False)  # read-only gathers
            per_graph.append(list(self._sample(A)))
        flat = [Q for samples in per_graph for Q in samples]
        flat_keys = self._keys_for(flat)
        keys_of = []
        pos = 0
        for samples in per_graph:
            keys_of.append(flat_keys[pos:pos + len(samples)])
            pos += len(samples)
        for i, keys in enumerate(keys_of):
            if self._method_calling == 1:
                for key in keys:
                    kbin = self._lookup_fit(key)
                    if kbin is None:
                        kbin = len(self._graph_bins)
                        self._graph_bins[kbin] = key
                        self._bin_of[key] = kbin
                        local_values[(i, kbin)] = 1
                    else:
                        # reference count bookkeeping (:426-433): ensure
                        # 1 then increment
                        if (i, kbin) not in local_values:
                            local_values[(i, kbin)] = 1
                        local_values[(i, kbin)] += 1
            else:
                for key in keys:
                    kbin = self._lookup_fit(key)
                    if kbin is not None:
                        if (i, kbin) not in local_values:
                            local_values[(i, kbin)] = 1
                        local_values[(i, kbin)] += 1
                        continue
                    start = len(self._graph_bins)
                    ybin = self._lookup_y(key)
                    if ybin is None:
                        ybin = len(self._Y_graph_bins)
                        self._Y_graph_bins[ybin] = key
                        self._Y_bin_of[key] = ybin
                        local_values[(i, start + ybin)] = 1
                    else:
                        bk = (i, start + ybin)
                        if bk not in local_values:
                            local_values[bk] = 1
                        local_values[bk] += 1
        if self._method_calling == 1:
            self._nx = len(graphs)
        else:
            self._ny = len(graphs)
        return local_values

    def _lookup_fit(self, key):
        return self._bin_of.get(key)

    def _lookup_y(self, key):
        return self._Y_bin_of.get(key)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _phi(values, n, width):
        """The f32 [n, width] count matrix of ``{(graph, bin): count}``."""
        phi = np.zeros((n, width), np.float32)
        for (i, j), v in values.items():
            phi[i, j] = v
        return phi

    @staticmethod
    def _count_dtype(*phis):
        """The Gram dtype for feature rows whose largest sum is m: an entry
        (and every partial sum of it) is at most m^2
        (:func:`ops.gram.count_dtype`)."""
        m = max((float(p.sum(1).max(initial=0)) for p in phis), default=0)
        return count_dtype(m * m)

    @staticmethod
    def _self_products(phi, dtype):
        return np.einsum("ij,ij->i", phi, phi) if dtype == torch.float32 \
            else np.einsum("ij,ij->i", phi.astype(np.float64),
                           phi.astype(np.float64))

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self.fit(X)
        phi_x = self._phi(self.X, self._nx, len(self._graph_bins))
        self._phi_X = phi_x
        km = gram_gemm(phi_x, self._device(),
                       self._count_dtype(phi_x)).cpu().numpy()
        self._X_diag = np.diagonal(km)
        if self.normalize:
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.divide(km, np.sqrt(np.outer(self._X_diag,
                                                      self._X_diag)))
        return km

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        Y = self.parse_input(X)
        if not hasattr(self, "_phi_X"):
            self._phi_X = self._phi(self.X, self._nx, len(self._graph_bins))
        nb = len(self._graph_bins)
        phi_y = self._phi(Y, self._ny, nb + len(self._Y_graph_bins))
        self._phi_Y = phi_y
        km = gram_rect(phi_y[:, :nb], self._phi_X, self._device(),
                       self._count_dtype(phi_y, self._phi_X)).cpu().numpy()
        self._is_transformed = True
        if self.normalize:
            X_diag, Y_diag = self.diagonal()
            with np.errstate(divide="ignore", invalid="ignore"):
                km = km / np.sqrt(np.outer(Y_diag, X_diag))
        return km

    def diagonal(self):
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if getattr(self, "_X_diag", None) is None:
            phi_x = getattr(self, "_phi_X", None)
            if phi_x is None:
                phi_x = self._phi(self.X, self._nx, len(self._graph_bins))
                self._phi_X = phi_x
            self._X_diag = self._self_products(phi_x,
                                               self._count_dtype(phi_x))
        if getattr(self, "_is_transformed", False):
            Y_diag = self._self_products(self._phi_Y,
                                         self._count_dtype(self._phi_Y))
            return self._X_diag, Y_diag
        return self._X_diag
