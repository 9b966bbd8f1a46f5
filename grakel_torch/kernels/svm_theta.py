"""SVM-theta kernel (Johansson et al. 2014).

The counterpart of ``grakel_tpu/kernels/svm_theta.py``: the same draw
stream (the numpy ``RandomState`` of ``random_state``), the same sample
counts per subset size and the same features.

Reference semantics (grakel/kernels/svm_theta.py):

* per graph: K = binarized adjacency (> 1e-10), zero diagonal; if the
  smallest eigenvalue is < -1e-6, scale by -1/min_eig and add identity
  (:222-229); OneClassSVM(precomputed) dual coefficients scattered to a
  per-vertex alpha vector (:230-235);
* phi = per-subset-size mean over sampled vertex subsets of
  sum(alpha[subset]); sample counts per size from ``distribute_samples``
  (binomially weighted; :180-206); subsets drawn with ``random_state``;
* pairwise = metric(phi_x, phi_y); the reference default
  ``np.inner(x, y)[0, 0]`` over COLUMN vectors evaluates to
  ``phi_x[0] * phi_y[0]`` — only the smallest subset size contributes
  (:23-24) — reproduced here as a rank-1 feature GEMM on the device.

The per-graph spectral shift and one-class dual solve run batched on
the kernel's device (``ops/svm_qp.py``: on a card one launch a size
bucket runs the Lanczos kernel K10 and then the shift and FISTA kernel
K11, on the bucket's bit rows).  The JAX package's libsvm oracle
(``_svm_alphas``) is not carried: the port does not depend on
scikit-learn, and its tests take the oracle from the JAX package.
"""

from __future__ import annotations

import numpy as np

from .base import Kernel, normalize_input
from ..estimator import check_random_state
from ..ops.svm_qp import one_class_alphas
from ..tools import distribute_samples

__all__ = ["SvmTheta"]


def _inner(x, y):
    return np.inner(x, y)[0, 0]


class SvmTheta(Kernel):
    """SVM-theta kernel."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 random_state=None, n_samples=50, subsets_size_range=(2, 8),
                 metric=_inner):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.random_state = random_state
        self.n_samples = n_samples
        self.subsets_size_range = subsets_size_range
        self.metric = metric

    def initialize(self):
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
        self.random_state_ = check_random_state(self.random_state)

    def parse_input(self, X):
        graphs = normalize_input(X)
        adjm = [g.get_adjacency_matrix() for g in graphs]
        alphas = self._alphas_batch(adjm)
        return [self._levels(A, al) for A, al in zip(adjm, alphas)]

    def _alphas_batch(self, adjm):
        """One-class dual coefficients for the whole batch, on the
        kernel's device (an instance hook, so tests can swap in other
        alphas)."""
        return one_class_alphas(adjm, device=self._device())

    def _levels(self, A, alphas):
        n = A.shape[0]
        samples = distribute_samples(n, self.subsets_size_range,
                                     self.n_samples)
        lo, hi = self.subsets_size_range
        phi = np.zeros((hi - lo + 1, 1))
        for i, level in enumerate(range(lo, hi + 1)):
            v = samples.get(level)
            if v is not None:
                vals = []
                for _ in range(v):
                    if level <= n:
                        idx = self.random_state_.choice(n, level,
                                                        replace=False)
                    else:
                        idx = range(n)
                    vals.append(np.sum(alphas[idx]))
                phi[i] = np.mean(vals)
        return phi

    def _feature_matrix(self, parsed):
        if self.metric is not _inner:
            return None
        # the default metric reads only phi[0] (see module docstring)
        return np.asarray([[p[0, 0]] for p in parsed])

    def pairwise_operation(self, x, y):
        return self.metric(x, y)
