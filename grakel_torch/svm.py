"""A C-SVC on a precomputed kernel, without scikit-learn.

:class:`SVC` is ``sklearn.svm.SVC(kernel="precomputed")`` at its
defaults (tol 1e-3, shrinking on, one-vs-one; no other option): the same
solver (libsvm's, as :mod:`grakel_torch.ops.csvc` runs it: K15 on a
card, its plain version on the CPU), the same fitted attributes (``classes_``,
``support_``, ``n_support_``, ``dual_coef_``, ``intercept_``,
``n_iter_``) and the same ``predict`` and ``decision_function`` (K16).
It runs on the ambient device (:func:`grakel_torch.use_device`), else
the card, never falling back to the CPU.  Any kernel other than ``"precomputed"``
raises, and so does a Gram that holds NaN or infinity (scikit-learn's
messages, checked on the host before any upload).  It is what
:func:`grakel_torch.utils.cross_validate_Kfold_SVM` fits, and what a
callable scorer there receives.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .estimator import BaseEstimator, NotFittedError, check_random_state
from .ops import csvc

__all__ = ["SVC", "nonfinite_message", "NAN_MESSAGE", "INF_MESSAGE"]

# scikit-learn 1.9's messages (sklearn.utils.validation._assert_all_finite)
NAN_MESSAGE = (
    "Input X contains NaN.\nSVC does not accept missing values encoded as "
    "NaN natively. For supervised learning, you might want to consider "
    "sklearn.ensemble.HistGradientBoostingClassifier and Regressor which "
    "accept missing values encoded as NaNs natively. Alternatively, it is "
    "possible to preprocess the data, for instance by using an imputer "
    "transformer in a pipeline or drop samples with missing values. See "
    "https://scikit-learn.org/stable/modules/impute.html You can find a "
    "list of all estimators that handle NaN values at the following page: "
    "https://scikit-learn.org/stable/modules/impute.html"
    "#estimators-that-handle-nan-values")
INF_MESSAGE = ("Input X contains infinity or a value too large for "
               "dtype('float64').")


def nonfinite_message(X):
    """scikit-learn's ``ValueError`` message for a Gram ``X`` that holds
    NaN (that message first) or infinity, else None."""
    if np.isfinite(X).all():
        return None
    return NAN_MESSAGE if np.isnan(X).any() else INF_MESSAGE


def _check_finite(X):
    msg = nonfinite_message(X)
    if msg is not None:
        raise ValueError(msg)


def _ovr_decision(predictions, confidences, n_classes):
    """scikit-learn's ``_ovr_decision_function``: votes plus the
    confidences' sums squashed into (-1/3, 1/3)."""
    n = predictions.shape[0]
    votes = np.zeros((n, n_classes))
    conf = np.zeros((n, n_classes))
    k = 0
    for i in range(n_classes):
        for j in range(i + 1, n_classes):
            conf[:, i] -= confidences[:, k]
            conf[:, j] += confidences[:, k]
            votes[predictions[:, k] == 0, i] += 1
            votes[predictions[:, k] == 1, j] += 1
            k += 1
    return votes + conf / (3 * (np.abs(conf) + 1))


def _decision_scores(dec, n_classes):
    """``decision_function``'s values from K16's one-vs-one decision
    values ``dec`` [m, pairs]: [m] for two classes (positive: the second
    class), else their one-vs-rest transform [m, n_classes]."""
    if n_classes == 2:
        return -dec.ravel()
    return _ovr_decision(dec < 0, -dec, n_classes)


class SVC(BaseEstimator):
    """C-Support Vector Classification on a precomputed Gram.

    Parameters
    ----------
    C : float, default=1.0
        The regularization parameter, > 0.
    kernel : {"precomputed"}
        Only precomputed kernels: ``fit(K, y)`` takes the [n, n] Gram of
        the training samples, ``predict(K)`` the [m, n] Gram of new
        samples against them.
    """

    def __init__(self, C=1.0, kernel="precomputed"):
        self.C = C
        self.kernel = kernel

    def fit(self, X, y):
        """Fit on the training Gram ``X`` [n, n] and labels ``y`` [n]."""
        if self.kernel != "precomputed":
            raise ValueError("grakel_torch's SVC supports only "
                             "kernel='precomputed', got %r" % (self.kernel,))
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y).reshape(-1)
        _check_finite(X)
        if X.ndim != 2 or X.shape[0] != X.shape[1]:
            raise ValueError("Precomputed matrix must be a square matrix. "
                             "Input is a %s matrix." % "x".join(
                                 map(str, X.shape)))
        if X.shape[0] != y.shape[0]:
            raise ValueError("X and y have incompatible shapes.\nX has %d "
                             "samples, but y has %d."
                             % (X.shape[0], y.shape[0]))
        if y.dtype.kind == "f" and np.any(y != np.round(y)):
            raise ValueError("Unknown label type: continuous. Maybe you are "
                             "trying to fit a classifier, which expects "
                             "discrete classes on a regression target with "
                             "continuous values.")
        dev = resolve_device()
        plan = csvc.plan_fits([(0, np.arange(X.shape[0]), y,
                                float(self.C))])
        # scikit-learn's fit draws a libsvm seed from this generator
        check_random_state(None).randint(np.iinfo("i").max)
        Kf = torch.from_numpy(X.astype(np.float32)).to(dev)
        diag = torch.from_numpy(np.ascontiguousarray(np.diag(X))).to(dev)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        coef, rho, iters = csvc.smo(Kf, diag, t(plan.ids), t(plan.sign),
                                    t(plan.off), t(plan.C), t(plan.gram))
        self._set_solution(plan, 0, coef.cpu().numpy(), rho.cpu().numpy(),
                           iters.cpu().numpy(), dev, X.shape[0])
        return self

    def _set_solution(self, plan, f, coef, rho, iters, device, n_train):
        """Build the fitted attributes of fit ``f`` of ``plan`` from K15's
        (coef, rho, iters) of the whole plan, host arrays."""
        meta = plan.fits[f]
        k = meta["classes"].shape[0]
        q0, npair = meta["pair0"], meta["n_pairs"]
        counts, perm = meta["counts"], meta["perm"]
        starts = np.cumsum(counts) - counts
        lo, hi = int(plan.off[q0]), int(plan.off[q0 + npair])
        self._coef = np.ascontiguousarray(coef[lo:hi])
        self._pos = plan.pos[lo:hi].astype(np.int32)
        self._off = (plan.off[q0:q0 + npair + 1] - lo).astype(np.int32)
        self._rho = np.ascontiguousarray(rho[q0:q0 + npair], np.float64)
        nonzero = np.zeros(counts.sum(), bool)     # in grouped order
        ii, jj = np.triu_indices(k, 1)
        for p in range(npair):
            c = self._coef[self._off[p]:self._off[p + 1]]
            ci = counts[ii[p]]
            nonzero[starts[ii[p]]:starts[ii[p]] + ci] |= np.abs(c[:ci]) > 0
            nonzero[starts[jj[p]]:starts[jj[p]] + counts[jj[p]]] |= \
                np.abs(c[ci:]) > 0
        nsv = np.array([nonzero[s:s + c].sum() for s, c in
                        zip(starts, counts)], np.int32)
        nz_start = np.cumsum(nsv) - nsv
        sv_coef = np.zeros((k - 1, int(nsv.sum())))
        for p in range(npair):
            i, j = ii[p], jj[p]
            c = self._coef[self._off[p]:self._off[p + 1]]
            ci = counts[i]
            sv_coef[j - 1, nz_start[i]:nz_start[i] + nsv[i]] = \
                c[:ci][nonzero[starts[i]:starts[i] + ci]]
            sv_coef[i, nz_start[j]:nz_start[j] + nsv[j]] = \
                c[ci:][nonzero[starts[j]:starts[j] + counts[j]]]
        intercept = np.where(self._rho != 0, -self._rho, 0.0)
        if not (np.isfinite(intercept).all() and np.isfinite(sv_coef).all()):
            raise ValueError("The dual coefficients or intercepts are not "
                             "finite. The input data may contain large "
                             "values and need to be preprocessed.")
        self.classes_ = meta["classes"]
        self.support_ = perm[nonzero].astype(np.int32)
        self.n_support_ = nsv
        self._dual_coef_ = sv_coef
        self._intercept_ = intercept
        self.dual_coef_ = -sv_coef if k == 2 else sv_coef
        self.intercept_ = intercept * -1 if k == 2 else intercept.copy()
        self.n_iter_ = np.asarray(iters[q0:q0 + npair], np.int32)
        self.shape_fit_ = (n_train, n_train)
        self.device_ = device
        return self

    def _decision(self, X):
        if not hasattr(self, "classes_"):
            raise NotFittedError("This SVC instance is not fitted yet. Call "
                                 "'fit' with appropriate arguments before "
                                 "using this estimator.")
        X = np.asarray(X, dtype=np.float64)
        _check_finite(X)
        if X.ndim != 2 or X.shape[1] != self.shape_fit_[0]:
            raise ValueError("X.shape[1] = %d should be equal to %d, the "
                             "number of samples at training time"
                             % (X.shape[-1], self.shape_fit_[0]))
        dev = self.device_
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        k = self.classes_.shape[0]
        models = torch.tensor([[0, k, 0, 0]], dtype=torch.int64)
        dec, pred = csvc.vote(t(X), t(np.arange(X.shape[0], dtype=np.int32)),
                              t(self._pos), t(self._coef), t(self._off),
                              t(self._rho), models.to(dev))
        npair = k * (k - 1) // 2
        return dec.cpu().numpy().reshape(X.shape[0], npair), \
            pred.cpu().numpy()

    def predict(self, X):
        """Class labels of the samples whose Gram against the training
        samples is ``X`` [m, n]."""
        pred = self._decision(X)[1]
        return self.classes_[pred]

    def decision_function(self, X):
        """[m] for two classes (positive: ``classes_[1]``), else the
        one-vs-one decision values' one-vs-rest transform [m, classes],
        as scikit-learn's default ``decision_function_shape="ovr"``."""
        return _decision_scores(self._decision(X)[0],
                                self.classes_.shape[0])
