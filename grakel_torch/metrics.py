"""The scorers :func:`grakel_torch.utils.cross_validate_Kfold_SVM` takes
by name, without scikit-learn.

Each reads only an estimator's ``predict`` and computes its metric as
``sklearn.metrics`` does, in numpy, with the same arithmetic (the
counts, then one float64 division a class, then numpy's mean or
weighted mean), so a score equals scikit-learn's to the last bit:

* ``"accuracy"`` (the default) and ``"balanced_accuracy"``;
* ``"precision"``, ``"recall"`` and ``"f1"`` (binary targets, positive
  label 1), and their ``_micro``, ``_macro`` and ``_weighted`` forms.

A division by zero gives 0.0 and an ``UndefinedMetricWarning``, as
scikit-learn's default ``zero_division="warn"`` does.  Any other string
raises ``ValueError`` naming the supported set; a callable
``scorer(estimator, X, y)`` is used as it is.  Scorers that read
``decision_function`` or probabilities (``"roc_auc"``,
``"average_precision"``, ``"neg_log_loss"``, ...) are not ported.
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["get_scorer", "get_scorer_names", "accuracy_score",
           "balanced_accuracy_score", "precision_score", "recall_score",
           "f1_score", "UndefinedMetricWarning"]


class UndefinedMetricWarning(UserWarning):
    """A metric divided by zero and was set to 0.0."""


def _continuous(y):
    return y.dtype.kind == "f" and np.any(y != np.round(y))


def _targets(y_true, y_pred):
    """(y_type, sorted labels of both, y_true, y_pred): "binary" when the
    two hold at most two labels together, else "multiclass"."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError("Found input variables with inconsistent numbers "
                         "of samples: [%d, %d]"
                         % (y_true.shape[0], y_pred.shape[0]))
    if y_true.shape[0] < 1:
        raise ValueError("Found empty input array (e.g., `y_true` or "
                         "`y_pred`) while a minimum of 1 sample is required.")
    for y in (y_true, y_pred):
        if _continuous(y):
            raise ValueError("continuous is not supported")
    labels = np.unique(np.concatenate([y_true, y_pred]))
    return ("binary" if labels.shape[0] <= 2 else "multiclass"), labels, \
        y_true, y_pred


def _divide(num, den, what):
    den = np.asarray(den, dtype=np.float64).copy()
    mask = den == 0
    den[mask] = 1
    out = np.asarray(num, dtype=np.float64) / den
    if mask.any():
        out[mask] = 0.0
        warnings.warn("%s is ill-defined and being set to 0.0; no samples "
                      "to divide by." % what, UndefinedMetricWarning,
                      stacklevel=3)
    return out


def accuracy_score(y_true, y_pred):
    """The share of equal labels."""
    _, _, y_true, y_pred = _targets(y_true, y_pred)
    return float(np.mean(y_true == y_pred))


def balanced_accuracy_score(y_true, y_pred):
    """The mean recall over the classes of ``y_true``."""
    _, labels, y_true, y_pred = _targets(y_true, y_pred)
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    L = labels.shape[0]
    C = np.bincount(t * L + p, minlength=L * L).reshape(L, L)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(C) / C.sum(axis=1)
    if np.any(np.isnan(per_class)):
        warnings.warn("y_pred contains classes not in y_true")
        per_class = per_class[~np.isnan(per_class)]
    return float(np.mean(per_class))


def _prf(y_true, y_pred, average, pos_label=1):
    """(precision, recall, f1) averaged as scikit-learn's
    ``precision_recall_fscore_support(beta=1)`` does."""
    y_type, present, y_true, y_pred = _targets(y_true, y_pred)
    if average == "binary":
        if y_type != "binary":
            raise ValueError(
                "Target is multiclass but average='binary'. Please choose "
                "another average setting, one of [None, 'micro', 'macro', "
                "'weighted'].")
        if pos_label not in present and len(present) >= 2:
            raise ValueError("pos_label=%r is not a valid label. It should "
                             "be one of %s" % (pos_label, present))
        labels = np.asarray([pos_label])
    else:
        labels = present
    hit_t = y_true[None, :] == labels[:, None]
    hit_p = y_pred[None, :] == labels[:, None]
    tp = np.sum(hit_t & hit_p, axis=1)
    pred = np.sum(hit_p, axis=1)
    true = np.sum(hit_t, axis=1)
    if average == "micro":
        tp, pred, true = (np.sum(a).reshape(1) for a in (tp, pred, true))
    precision = _divide(tp, pred, "Precision")
    recall = _divide(tp, true, "Recall")
    f = _divide(2 * tp.astype(np.float64),
                1 * true.astype(np.float64) + pred.astype(np.float64),
                "F-score")

    def avg(a):
        if average != "weighted":
            return float(np.nanmean(a))
        w = true.astype(np.float64)
        scale = np.sum(w)
        if scale == 0.0:
            return float(np.mean(a))
        return float(np.sum(np.multiply(a, w)) / scale)

    return avg(precision), avg(recall), avg(f)


def precision_score(y_true, y_pred, average="binary", pos_label=1):
    return _prf(y_true, y_pred, average, pos_label)[0]


def recall_score(y_true, y_pred, average="binary", pos_label=1):
    return _prf(y_true, y_pred, average, pos_label)[1]


def f1_score(y_true, y_pred, average="binary", pos_label=1):
    return _prf(y_true, y_pred, average, pos_label)[2]


class _PredictScorer:
    """``scorer(estimator, X, y)``: the metric of ``estimator.predict(X)``
    against ``y``; :meth:`score` takes the predictions directly."""

    def __init__(self, name, metric, **kwargs):
        self.name = name
        self._metric = metric
        self._kwargs = kwargs

    def score(self, y_true, y_pred):
        return self._metric(y_true, y_pred, **self._kwargs)

    def __call__(self, estimator, X, y_true):
        return self.score(y_true, estimator.predict(X))

    def __repr__(self):
        return "make_scorer(%s)" % self.name


def _registry():
    out = {"accuracy": _PredictScorer("accuracy", accuracy_score),
           "balanced_accuracy": _PredictScorer("balanced_accuracy",
                                               balanced_accuracy_score)}
    for name, metric in (("precision", precision_score),
                         ("recall", recall_score), ("f1", f1_score)):
        out[name] = _PredictScorer(name, metric)
        for average in ("micro", "macro", "weighted"):
            key = "%s_%s" % (name, average)
            out[key] = _PredictScorer(key, metric, average=average)
    return out


_SCORERS = _registry()


def get_scorer_names():
    """The scoring strings this module supports, sorted."""
    return sorted(_SCORERS)


def get_scorer(scoring):
    """The scorer named ``scoring``, or ``scoring`` itself when it is a
    callable ``scorer(estimator, X, y)``."""
    if isinstance(scoring, str):
        try:
            return _SCORERS[scoring]
        except KeyError:
            raise ValueError("%r is not a supported scoring value; "
                             "grakel_torch supports %s"
                             % (scoring, ", ".join(get_scorer_names())))
    if callable(scoring):
        return scoring
    raise ValueError("scoring must be a string or a callable "
                     "scorer(estimator, X, y), got %r" % (scoring,))
