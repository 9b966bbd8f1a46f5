"""Lovász-theta kernel (Johansson et al. 2014).

The counterpart of ``grakel_tpu/kernels/lovasz_theta.py``: the same
draw stream (the numpy ``RandomState`` of ``random_state``), the same
size buckets, labelling and features.

Reference semantics (grakel/kernels/lovasz_theta.py):

* per graph: the Lovász SDP — min t s.t. S = t*I + M - J PSD with M
  supported on NON-edges — yields t and the PSD slack S (:282-332);
  orthonormal labelling U = (e_d 1^T + cholesky(S)) / sqrt(t), padded to
  d = max graph size + 1 rows (:335-378);
* for each sampled vertex subset (counts by ``distribute_samples``):
  the cosine of the minimum enclosing cone of the subset's labelling
  columns (:380-506); phi = per-subset-size mean;
* pairwise = metric(phi_x, phi_y), default full inner product (:509).

The SDP runs on the kernel's device per size bucket
(``ops/lovasz_sdp.lovasz_theta_batch``: Douglas-Rachford, one batched
``eigh`` and one K12 launch an iteration on a card); the Cholesky
labelling stays on the host in f64, as in the JAX package.  The cones
of all sampled subsets are solved together by the Badoiu-Clarkson
iteration on the device (``ops/lovasz_sdp.min_cone``, K13 on a card),
each subset padded to the largest size by repeating its first column
(a duplicate point does not move the enclosing ball).
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.linalg import LinAlgError, cholesky

from .base import Kernel, normalize_input
from ..estimator import check_random_state
from ..ops.lovasz_sdp import lovasz_theta_batch, min_cone
from ..tools import distribute_samples

__all__ = ["LovaszTheta"]

angle_precision = 1e-6
min_weight = 1e-10


def inner_product(x, y):
    return x.T.dot(y)


class LovaszTheta(Kernel):
    """Lovász-theta kernel."""

    # device bytes of one batch of subset columns [S, d, hi] f32: the
    # subsets are solved in batches of at most this size
    _MEC_BATCH_BYTES = 2 << 30

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 random_state=None, n_samples=50, subsets_size_range=(2, 8),
                 max_dim=None, metric=inner_product):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.random_state = random_state
        self.n_samples = n_samples
        self.subsets_size_range = subsets_size_range
        self.max_dim = max_dim
        self.metric = metric

    def initialize(self):
        self.random_state_ = check_random_state(self.random_state)
        if not isinstance(self.n_samples, int) or self.n_samples <= 0:
            raise TypeError("n_samples must be a positive integer")
        if (not isinstance(self.subsets_size_range, tuple)
                or len(self.subsets_size_range) != 2
                or self.subsets_size_range[0] > self.subsets_size_range[1]
                or self.subsets_size_range[0] <= 0):
            raise TypeError("subsets_size_range must be an increasing "
                            "positive int pair")
        if not callable(self.metric):
            raise TypeError("metric must be callable")
        if self.max_dim is not None and (not isinstance(self.max_dim, int)
                                         or self.max_dim < 1):
            raise ValueError("max_dim if not None, should be an integer "
                             "bigger than 1")
        if self._method_calling in (0, 1, 2) or not hasattr(self, "d_"):
            self.d_ = None if self.max_dim is None else self.max_dim + 1

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs = normalize_input(X)
        adjm = [g.get_adjacency_matrix() for g in graphs]
        max_dim = max(A.shape[0] for A in adjm)
        if self._method_calling in (1, 2):
            if self.d_ is None:
                self.d_ = max_dim + 1
        if self.d_ < max_dim + 1:
            if self.max_dim is None and self._method_calling == 3:
                raise ValueError(
                    "Maximum dimension of a graph in transform is bigger "
                    "than the one found in fit. To avoid that use max_dim "
                    "parameter.")
            raise ValueError("max_dim should correspond to the biggest "
                             "graph inside the dataset")

        thetas, slacks = self._sdp(adjm)
        Us = []
        for A, t, S in zip(adjm, thetas, slacks):
            if A.shape[0] == 1:
                U = np.ones((self.d_, 1))
            else:
                U = self._labelling(S, t, self.d_)
            Us.append(U)
        return self._mec_levels_batch(Us)

    def _sdp(self, adjm):
        """theta and the f64 dual slack S of every graph: one device SDP
        per size bucket (an instance hook, so tests can share the SDP's
        results between packages)."""
        buckets = {}
        for i, A in enumerate(adjm):
            V = max(4, 1 << (max(A.shape[0] - 1, 1)).bit_length())
            buckets.setdefault(V, []).append(i)
        thetas = [None] * len(adjm)
        slacks = [None] * len(adjm)
        for V, idxs in buckets.items():
            batch = np.zeros((len(idxs), V, V), np.float32)
            ns = []
            for b, gi in enumerate(idxs):
                n = adjm[gi].shape[0]
                batch[b, :n, :n] = (np.abs(adjm[gi]) > min_weight)
                ns.append(n)
            t, S = lovasz_theta_batch(batch, ns, device=self._device())
            for b, gi in enumerate(idxs):
                n = ns[b]
                thetas[gi] = float(t[b])
                slacks[gi] = np.asarray(S[b][:n, :n], np.float64)
        return thetas, slacks

    @staticmethod
    def _labelling(S, t, d):
        """Cholesky labelling (reference :335-378)."""
        n = S.shape[0]
        try:
            V = cholesky(S + 1e-9 * np.eye(n))
        except LinAlgError:
            S = S + 2 * abs(float(np.linalg.eigvalsh(S)[0])) * np.eye(n)
            V = cholesky(S + 1e-9 * np.eye(n))
        V = np.pad(V, [(0, d - n), (0, 0)], mode="constant")
        c = np.zeros(d)
        c[-1] = 1
        C = np.outer(c, np.ones(n))
        return (C + V) / np.sqrt(t)

    # minimum-enclosing-cone sampling ---------------------------------- #
    def _mec_levels_batch(self, Us):
        """phi [n_levels, 1] per graph: the mean cone cosine of its
        sampled subsets at each size.  The draws run on the host in the
        JAX package's order; every subset's columns are gathered on the
        device from the stacked labellings and solved together by
        :meth:`_min_cone_batch`."""
        lo, hi = self.subsets_size_range
        n_levels = hi - lo + 1
        G = len(Us)
        keys, idxs = [], []
        for g, U in enumerate(Us):
            n = U.shape[1]
            samples = distribute_samples(n, self.subsets_size_range,
                                         self.n_samples)
            for i, level in enumerate(range(lo, hi + 1)):
                v = samples.get(level)
                if v is None:
                    continue
                for _ in range(v):
                    if level <= n:
                        idx = self.random_state_.choice(n, level,
                                                        replace=False)
                    else:
                        idx = np.arange(n)
                    if idx.size < hi:
                        idx = np.concatenate(
                            [idx, np.full(hi - idx.size, idx[0],
                                          dtype=np.int64)])
                    keys.append((g, i))
                    idxs.append(idx)
        sums = np.zeros((G, n_levels))
        cnts = np.zeros((G, n_levels), dtype=np.int64)
        if keys:
            dev = self._device()
            d = self.d_
            nmax = max(U.shape[1] for U in Us)
            cols = np.zeros((G, nmax, d), np.float32)
            for g, U in enumerate(Us):
                cols[g, :U.shape[1]] = U.T
            cols = torch.from_numpy(cols).to(dev)
            gi = np.asarray(keys, dtype=np.int64)
            sel = np.stack(idxs).astype(np.int64)
            step = max(1, self._MEC_BATCH_BYTES // (4 * d * hi))
            t = np.concatenate([
                self._min_cone_batch(cols[
                    torch.from_numpy(gi[s:s + step, 0:1]).to(dev),
                    torch.from_numpy(sel[s:s + step]).to(dev)
                ].transpose(1, 2).contiguous())
                for s in range(0, len(keys), step)])
            np.add.at(sums, (gi[:, 0], gi[:, 1]), t)
            np.add.at(cnts, (gi[:, 0], gi[:, 1]), 1)
        phi = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
        return [phi[g][:, None] for g in range(G)]

    @staticmethod
    def _min_cone_batch(A):
        """Min enclosing cone cosine per subset: A [S, d, m] f32 tensor
        -> t [S] f64 numpy, snapped to +-1 within ``angle_precision``."""
        t = min_cone(A).cpu().numpy().astype(np.float64)
        t = np.where((t > 1.0) & (t < 1.0 + angle_precision), 1.0, t)
        t = np.where((t < -1.0) & (t > -1.0 - angle_precision), -1.0, t)
        return t

    # ------------------------------------------------------------------ #
    def _feature_matrix(self, parsed):
        if self.metric is not inner_product:
            return None
        return np.concatenate([p.T for p in parsed], axis=0)

    def pairwise_operation(self, x, y):
        v = self.metric(x, y)
        return float(np.asarray(v).reshape(-1)[0])
