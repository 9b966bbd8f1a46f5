"""The two cross-validation splitters :func:`grakel_torch.utils.
cross_validate_Kfold_SVM` uses, without scikit-learn.

Only as far as that function needs them: :class:`KFold` and
:class:`ShuffleSplit` split an index range, and their draws on a numpy
``RandomState`` are those of ``sklearn.model_selection``'s classes of the
same name, bit for bit and in the same order:

* ``KFold(n_splits, shuffle=True, random_state=rng).split(X)`` draws
  ``rng.shuffle(np.arange(n))`` once a call.  The test folds are runs of
  that order, the first ``n % n_splits`` of them one longer; each fold's
  test and train indices come back in ascending order (scikit-learn
  builds both from masks);
* ``ShuffleSplit(n_splits, test_size=t, random_state=rng).split(X)``
  draws ``rng.permutation(n)`` once a split; a float ``t`` takes
  ``ceil(t * n)`` test indices (the same float expression), the first of
  the permutation, and the train indices are the ones after them, in
  the permutation's order.
"""

from __future__ import annotations

import numbers
from math import ceil

import numpy as np

from .estimator import check_random_state

__all__ = ["KFold", "ShuffleSplit"]


def _num_samples(X):
    if hasattr(X, "shape") and len(getattr(X, "shape", ())) > 0:
        return int(X.shape[0])
    return len(X)


class KFold:
    """K-fold splits of ``range(len(X))``; see the module docstring."""

    def __init__(self, n_splits=5, *, shuffle=False, random_state=None):
        if not isinstance(n_splits, numbers.Integral) or n_splits < 2:
            raise ValueError("k-fold cross-validation requires an integer "
                             "n_splits of 2 or more, got %r" % (n_splits,))
        if not shuffle and random_state is not None:
            raise ValueError(
                "Setting a random_state has no effect since shuffle is "
                "False. You should leave random_state to its default "
                "(None), or set shuffle=True.")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X):
        """Yield (train, test) index arrays, one pair a fold."""
        n = _num_samples(X)
        if self.n_splits > n:
            raise ValueError(
                "Cannot have number of splits n_splits=%d greater than the "
                "number of samples: n_samples=%d." % (self.n_splits, n))
        indices = np.arange(n)
        order = np.arange(n)
        if self.shuffle:
            check_random_state(self.random_state).shuffle(order)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[:n % self.n_splits] += 1
        start = 0
        for size in sizes:
            mask = np.zeros(n, dtype=bool)
            mask[order[start:start + size]] = True
            start += size
            yield indices[~mask], indices[mask]


class ShuffleSplit:
    """Random train/test splits of ``range(len(X))``: ``test_size`` a
    float in (0, 1) (a share, rounded up) or an int; see the module
    docstring."""

    def __init__(self, n_splits=10, *, test_size=0.1, random_state=None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.random_state = random_state

    def split(self, X):
        """Yield (train, test) index arrays, one pair a split."""
        n = _num_samples(X)
        t = self.test_size
        if isinstance(t, numbers.Integral):
            ok, n_test = 0 < t < n, int(t)
        else:
            ok, n_test = 0 < t < 1, ceil(t * n)
        if not ok or n_test >= n:
            raise ValueError("test_size=%s leaves no train or no test set of "
                             "%d samples" % (t, n))
        rng = check_random_state(self.random_state)
        for _ in range(self.n_splits):
            perm = rng.permutation(n)
            yield perm[n_test:], perm[:n_test]
