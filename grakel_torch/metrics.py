"""The scorers :func:`grakel_torch.utils.cross_validate_Kfold_SVM` takes
by name, without scikit-learn.

Each computes its metric as scikit-learn 1.9's ``sklearn.metrics`` does,
in numpy, with the same arithmetic in the same order (the counts, then
the same float64 divisions, sums and means on arrays of the same shapes),
so a score equals scikit-learn's to the last bit.  The one exception is
``adjusted_mutual_info_score``: scikit-learn's expected mutual
information sums libm ``exp`` and ``lgamma`` terms in Cython, here numpy's
``exp`` and ``scipy.special.gammaln``, which agree to about 1e-15.

From a fit's predictions (``predict``):

* ``"accuracy"`` (the default), ``"balanced_accuracy"`` and
  ``"matthews_corrcoef"``;
* ``"precision"``, ``"recall"``, ``"f1"`` and ``"jaccard"`` (binary
  targets, positive label 1), and their ``_micro``, ``_macro`` and
  ``_weighted`` forms;
* ``"positive_likelihood_ratio"`` and ``"neg_negative_likelihood_ratio"``
  (binary targets);
* the clustering scores of the labels: ``"mutual_info_score"``,
  ``"adjusted_mutual_info_score"``, ``"normalized_mutual_info_score"``,
  ``"homogeneity_score"``, ``"completeness_score"``,
  ``"v_measure_score"``, ``"adjusted_rand_score"``, ``"rand_score"`` and
  ``"fowlkes_mallows_score"``;
* the regression scores of the labels taken as numbers:
  ``"explained_variance"``, ``"r2"``, ``"d2_absolute_error_score"``,
  ``"neg_max_error"``, ``"neg_mean_absolute_error"``,
  ``"neg_mean_absolute_percentage_error"``, ``"neg_mean_squared_error"``,
  ``"neg_mean_squared_log_error"``, ``"neg_median_absolute_error"``,
  ``"neg_root_mean_squared_error"`` and
  ``"neg_root_mean_squared_log_error"``.

From a fit's decision values (``decision_function``; the CV reads them
from K16's output): ``"roc_auc"`` and ``"average_precision"`` (binary
targets) and ``"top_k_accuracy"`` (k = 2).

Where scikit-learn raises, these raise the same exception type with
scikit-learn's message (a ``jaccard`` of three classes, a squared log
error of labels -1 and 1, string labels in a regression score); where it
warns, they warn with its text, :class:`UndefinedMetricWarning` for its
``UndefinedMetricWarning``.  Any other string raises ``ValueError``
naming the supported set, among them scikit-learn's names that read
probabilities (``"neg_log_loss"``, ``"roc_auc_ovr"``, ...: a
precomputed ``SVC`` has no ``predict_proba``), its ``*_samples`` forms
(multilabel targets only) and its Poisson and Gamma deviances (which
need positive targets, and a classifier's labels are not); those raise
in scikit-learn on any data.  A callable ``scorer(estimator, X, y)`` is
used as it is.
"""

from __future__ import annotations

import warnings
from math import log

import numpy as np

__all__ = ["get_scorer", "get_scorer_names", "accuracy_score",
           "balanced_accuracy_score", "precision_score", "recall_score",
           "f1_score", "jaccard_score", "matthews_corrcoef",
           "class_likelihood_ratios", "positive_likelihood_ratio",
           "negative_likelihood_ratio", "mutual_info_score",
           "adjusted_mutual_info_score", "normalized_mutual_info_score",
           "homogeneity_completeness_v_measure", "homogeneity_score",
           "completeness_score", "v_measure_score", "adjusted_rand_score",
           "rand_score", "fowlkes_mallows_score", "explained_variance_score",
           "r2_score", "d2_absolute_error_score", "max_error",
           "mean_absolute_error", "mean_absolute_percentage_error",
           "mean_squared_error", "mean_squared_log_error",
           "median_absolute_error", "root_mean_squared_error",
           "root_mean_squared_log_error", "roc_auc_score",
           "average_precision_score", "top_k_accuracy_score",
           "UndefinedMetricWarning"]


class UndefinedMetricWarning(UserWarning):
    """A metric is ill-defined on its input (scikit-learn's warning of
    the same name)."""


# --------------------------------------------------------------------- #
# input checks (scikit-learn's check_array, type_of_target, _check_targets
# for 1-d label arrays)
# --------------------------------------------------------------------- #
def _consistent_length(*arrays):
    lengths = [np.asarray(a).shape[0] if np.ndim(a) else 1 for a in arrays]
    if len(set(lengths)) > 1:
        raise ValueError("Found input variables with inconsistent numbers "
                         "of samples: %r" % [int(n) for n in lengths])


def _assert_finite(y, name=""):
    if y.dtype.kind in "fc" and not np.isfinite(y).all():
        what = "NaN" if np.isnan(y).any() else \
            "infinity or a value too large for %r" % y.dtype
        raise ValueError("Input %scontains %s." % (name + " " if name
                                                   else "", what))


def _check_array(y, dtype=None, min_samples=1, finite=True):
    """``check_array(y, ensure_2d=False, dtype=dtype)``: ``dtype`` None
    keeps the array's, ``"numeric"`` refuses strings and turns objects
    into float64, a numpy dtype converts."""
    y = np.asarray(y)
    if isinstance(dtype, str) and dtype == "numeric":
        if y.dtype.kind in "USV":
            raise ValueError("dtype='numeric' is not compatible with arrays "
                             "of bytes/strings.Convert your data to numeric "
                             "values explicitly instead.")
        if y.dtype.kind == "O":
            y = y.astype(np.float64)
    elif dtype is not None:
        y = np.asarray(y, dtype=dtype)
    if finite:
        _assert_finite(y)
    if y.ndim and y.shape[0] < min_samples:
        raise ValueError("Found array with %d sample(s) (shape=%r) while a "
                         "minimum of %d is required."
                         % (y.shape[0], y.shape, min_samples))
    return y


def _column_or_1d(y):
    y = np.asarray(y)
    if y.ndim == 1 or (y.ndim == 2 and y.shape[1] == 1):
        return y.reshape(-1)
    raise ValueError("y should be a 1d array, got an array of shape {} "
                     "instead.".format(y.shape))


def _type_of_target(y, name=""):
    """scikit-learn's ``type_of_target`` for label and score arrays."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] > 1 and y.dtype.kind in "biuf":
        labels = np.unique(y)
        if labels.shape[0] < 3 and (y.dtype.kind in "biu" or np.all(
                labels == labels.astype(int))):
            return "multilabel-indicator"
    if y.ndim not in (1, 2):
        return "unknown"
    if not min(y.shape):
        return "binary" if y.ndim == 1 else "unknown"
    if y.dtype == object and not isinstance(y.flat[0], str):
        return "unknown"
    suffix = "-multioutput" if y.ndim == 2 and y.shape[1] > 1 else ""
    if y.dtype.kind == "f":
        with np.errstate(invalid="ignore"):
            integral = y.astype(np.int64).astype(y.dtype)
        if np.any(y != integral):
            _assert_finite(y, name)
            return "continuous" + suffix
    if np.unique(y).shape[0] > 2 or (y.ndim == 2 and y.shape[1] > 1):
        return "multiclass" + suffix
    return "binary"


def _unique_labels(*ys):
    kinds = {y.dtype.kind in "USO" for y in ys if y.size}
    if len(kinds) > 1:
        raise ValueError("Mix of label input types (string and number); "
                         "Got %s." % " and ".join("%s" % np.unique(y)
                                                  for y in ys))
    return np.unique(np.concatenate([y.reshape(-1) for y in ys]))


def _check_targets(y_true, y_pred):
    """(y_type, sorted labels of both, y_true, y_pred): scikit-learn's
    ``_check_targets`` for binary and multiclass label arrays."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    _consistent_length(y_true, y_pred)
    type_true = _type_of_target(y_true, "y_true")
    type_pred = _type_of_target(y_pred, "y_pred")
    if y_true.shape[0] < 1 or y_pred.shape[0] < 1:
        raise ValueError("Found empty input array (e.g., `y_true` or "
                         "`y_pred`) while a minimum of 1 sample is required.")
    y_type = {type_true, type_pred}
    if y_type == {"binary", "multiclass"}:
        y_type = {"multiclass"}
    if len(y_type) > 1:
        raise ValueError("Classification metrics can't handle a mix of {0} "
                         "and {1} targets".format(type_true, type_pred))
    y_type = y_type.pop()
    if y_type not in ("binary", "multiclass"):
        raise ValueError("{0} is not supported".format(y_type))
    y_true = _column_or_1d(y_true)
    y_pred = _column_or_1d(y_pred)
    labels = _unique_labels(y_true, y_pred)
    if y_type == "binary" and labels.shape[0] > 2:
        y_type = "multiclass"
    return y_type, labels, y_true, y_pred


# --------------------------------------------------------------------- #
# classification scores of predictions
# --------------------------------------------------------------------- #
def accuracy_score(y_true, y_pred):
    """The share of equal labels."""
    _, _, y_true, y_pred = _check_targets(y_true, y_pred)
    return float(np.mean(y_true == y_pred))


def _confusion_matrix(y_true, y_pred):
    """scikit-learn's ``confusion_matrix`` over the present labels, int64,
    with its warning for a single label."""
    _, labels, y_true, y_pred = _check_targets(y_true, y_pred)
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    L = labels.shape[0]
    cm = np.bincount(t * L + p, minlength=L * L).reshape(L, L)
    if cm.shape == (1, 1):
        warnings.warn("A single label was found in 'y_true' and 'y_pred'. "
                      "For the confusion matrix to have the correct shape, "
                      "use the 'labels' parameter to pass all known labels.",
                      UserWarning)
    return cm


def balanced_accuracy_score(y_true, y_pred):
    """The mean recall over the classes of ``y_true``."""
    C = _confusion_matrix(y_true, y_pred)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(C) / C.sum(axis=1)
    if np.any(np.isnan(per_class)):
        warnings.warn("y_pred contains classes not in y_true")
        per_class = per_class[~np.isnan(per_class)]
    return float(np.mean(per_class))


def _set_wise_labels(y_true, y_pred, average, pos_label):
    """scikit-learn's ``_check_set_wise_labels``: ``[pos_label]`` for a
    binary average, else None (every present label); ``"samples"``
    raises, as it does outside multilabel targets."""
    options = (None, "micro", "macro", "weighted", "samples")
    if average not in options and average != "binary":
        raise ValueError("average has to be one of " + str(options))
    y_type, present, _, _ = _check_targets(y_true, y_pred)
    if average == "binary":
        if y_type == "binary":
            if pos_label not in present and len(present) >= 2:
                raise ValueError(
                    f"pos_label={pos_label} is not a valid label. It "
                    f"should be one of {present}")
            return [pos_label]
        options = list(options)
        options.remove("samples")
        raise ValueError("Target is %s but average='binary'. Please choose "
                         "another average setting, one of %r."
                         % (y_type, options))
    if pos_label not in (None, 1):
        warnings.warn("Note that pos_label (set to %r) is ignored when "
                      "average != 'binary' (got %r). You may use "
                      "labels=[pos_label] to specify a single positive "
                      "class." % (pos_label, average), UserWarning)
    if average == "samples":
        raise ValueError("Samplewise metrics are not available outside of "
                         "multilabel classification.")
    return None


def _multilabel_confusion(y_true, y_pred, labels=None):
    """scikit-learn's ``multilabel_confusion_matrix`` of 1-d targets:
    [labels, 2, 2] rows (tn, fp; fn, tp), ``labels`` first then the other
    present labels' order cut away."""
    _, present, y_true, y_pred = _check_targets(y_true, y_pred)
    if labels is None:
        labels, n_labels = present, None
    else:
        labels = np.asarray(labels)
        n_labels = labels.shape[0]
        labels = np.concatenate(
            [labels, np.setdiff1d(present, labels, assume_unique=True)])
    sorted_labels = np.unique(labels)
    y_true = np.searchsorted(sorted_labels, y_true)
    y_pred = np.searchsorted(sorted_labels, y_pred)
    tp = y_true == y_pred
    tp_bins = y_true[tp]
    L = labels.shape[0]
    if tp_bins.shape[0]:
        tp_sum = np.bincount(tp_bins, minlength=L)
    else:
        tp_sum = np.zeros(L)
    pred_sum = np.bincount(y_pred, minlength=L)
    true_sum = np.bincount(y_true, minlength=L)
    indices = np.searchsorted(sorted_labels, labels[:n_labels])
    tp_sum = np.take(tp_sum, indices, axis=0)
    true_sum = np.take(true_sum, indices, axis=0)
    pred_sum = np.take(pred_sum, indices, axis=0)
    fp = pred_sum - tp_sum
    fn = true_sum - tp_sum
    tn = y_true.shape[0] - tp_sum - fp - fn
    return np.stack([tn, fp, fn, tp_sum]).T.reshape(-1, 2, 2)


def _prf_divide(num, den, metric, modifier, warn_for):
    """scikit-learn's ``_prf_divide``: ``num / den`` in float64, 0.0
    where ``den`` is 0, with its warning when ``metric`` is the one
    ``warn_for`` names."""
    mask = den == 0
    den = np.asarray(den, dtype=np.float64).copy()
    den[mask] = 1
    out = np.asarray(num, dtype=np.float64) / den
    if not np.any(mask):
        return out
    out[mask] = 0.0
    if metric == warn_for:
        where = "due to" if out.shape[0] == 1 else "in labels with"
        warnings.warn("%s is ill-defined and being set to 0.0 %s no %s "
                      "samples. Use `zero_division` parameter to control "
                      "this behavior." % (metric.capitalize(), where,
                                          modifier),
                      UndefinedMetricWarning, stacklevel=3)
    return out


def _prf(y_true, y_pred, average, pos_label, warn_for):
    """(precision, recall, f1) averaged as scikit-learn's
    ``precision_recall_fscore_support(beta=1)`` does, warning for the
    one ``warn_for`` names ("precision", "recall" or "f-score")."""
    labels = _set_wise_labels(y_true, y_pred, average, pos_label)
    MCM = _multilabel_confusion(y_true, y_pred, labels)
    tp = MCM[:, 1, 1]
    pred = tp + MCM[:, 0, 1]
    true = tp + MCM[:, 1, 0]
    if average == "micro":
        tp, pred, true = (np.sum(a).reshape(1) for a in (tp, pred, true))
    precision = _prf_divide(tp, pred, "precision", "predicted", warn_for)
    recall = _prf_divide(tp, true, "recall", "true", warn_for)
    f = _prf_divide(2 * tp.astype(np.float64),
                    1 * true.astype(np.float64) + pred.astype(np.float64),
                    "f-score", "true nor predicted", warn_for)

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
    return _prf(y_true, y_pred, average, pos_label, "precision")[0]


def recall_score(y_true, y_pred, average="binary", pos_label=1):
    return _prf(y_true, y_pred, average, pos_label, "recall")[1]


def f1_score(y_true, y_pred, average="binary", pos_label=1):
    return _prf(y_true, y_pred, average, pos_label, "f-score")[2]


def jaccard_score(y_true, y_pred, *, pos_label=1, average="binary"):
    """The Jaccard index of the positive label (``average="binary"``) or
    of every present label, averaged ("micro", "macro", "weighted")."""
    labels = _set_wise_labels(y_true, y_pred, average, pos_label)
    MCM = _multilabel_confusion(y_true, y_pred, labels)
    numerator = MCM[:, 1, 1]
    denominator = MCM[:, 1, 1] + MCM[:, 0, 1] + MCM[:, 1, 0]
    if average == "micro":
        numerator = np.sum(numerator, keepdims=True)
        denominator = np.sum(denominator, keepdims=True)
    jaccard = _prf_divide(numerator, denominator, "jaccard",
                          "true or predicted", "jaccard")
    if average is None:
        return jaccard
    weights = None
    if average == "weighted":
        weights = MCM[:, 1, 0] + MCM[:, 1, 1]
        if not np.any(weights):
            weights = None
    return float(np.average(jaccard, weights=weights))


def matthews_corrcoef(y_true, y_pred):
    """The Matthews correlation coefficient (multiclass: Gorodkin's
    R_K)."""
    C = _confusion_matrix(y_true, y_pred)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    cov_ypyp_ytyt = cov_ypyp * cov_ytyt
    if cov_ypyp_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp_ytyt))


_LR_HOW = ("Use the `replace_undefined_by` param to control this behavior. "
           "To suppress this warning or turn it into an error, see Python's "
           "`warnings` module and `warnings.catch_warnings()`.")


def class_likelihood_ratios(y_true, y_pred, *, replace_undefined_by=np.nan):
    """(LR+, LR-) of a binary target, the positive class the greater
    label; ``replace_undefined_by`` (NaN or 1.0) stands for a ratio that
    divides by zero."""
    y_type, _, y_true, y_pred = _check_targets(y_true, y_pred)
    if y_type != "binary":
        raise ValueError("class_likelihood_ratios only supports binary "
                         "classification problems, got targets of type: %s"
                         % y_type)
    if not (replace_undefined_by == 1.0 or np.isnan(replace_undefined_by)):
        raise ValueError("replace_undefined_by must be np.nan or 1.0, got "
                         "%r" % (replace_undefined_by,))
    tn, fp, fn, tp = _confusion_matrix(y_true, y_pred).ravel()
    support_pos = tp + fn
    support_neg = tn + fp
    pos_num = tp * support_neg
    pos_denom = fp * support_pos
    neg_num = fn * support_neg
    neg_denom = tn * support_pos
    if support_pos == 0:
        warnings.warn(
            "No samples of the positive class are present in `y_true`. "
            "`positive_likelihood_ratio` and `negative_likelihood_ratio` are "
            "both set to `np.nan`. " + _LR_HOW, UndefinedMetricWarning,
            stacklevel=2)
    if fp == 0:
        if tp == 0:
            start = ("No samples were predicted for the positive class and "
                     "`positive_likelihood_ratio` is ")
        else:
            start = "`positive_likelihood_ratio` is ill-defined and "
        # scikit-learn's message ends here, mid-sentence
        warnings.warn(start + "set to `np.nan`. Use the "
                      "`replace_undefined_by` param to ",
                      UndefinedMetricWarning, stacklevel=2)
        lr_pos = replace_undefined_by
    else:
        lr_pos = pos_num / pos_denom
    if tn == 0:
        warnings.warn("`negative_likelihood_ratio` is ill-defined and set to "
                      "`np.nan`. " + _LR_HOW, UndefinedMetricWarning,
                      stacklevel=2)
        lr_neg = replace_undefined_by
    else:
        lr_neg = neg_num / neg_denom
    return float(lr_pos), float(lr_neg)


def positive_likelihood_ratio(y_true, y_pred):
    """LR+, 1.0 where undefined (the scorer's setting)."""
    return class_likelihood_ratios(y_true, y_pred,
                                   replace_undefined_by=1.0)[0]


def negative_likelihood_ratio(y_true, y_pred):
    """LR-, 1.0 where undefined (the scorer's setting)."""
    return class_likelihood_ratios(y_true, y_pred,
                                   replace_undefined_by=1.0)[1]


# --------------------------------------------------------------------- #
# clustering scores of the labels
# --------------------------------------------------------------------- #
def _check_clusterings(labels_true, labels_pred):
    labels_true = _check_array(labels_true, min_samples=0)
    labels_pred = _check_array(labels_pred, min_samples=0)
    type_label = _type_of_target(labels_true)
    type_pred = _type_of_target(labels_pred)
    if "continuous" in (type_pred, type_label):
        warnings.warn("Clustering metrics expects discrete values but "
                      "received %s values for label, and %s values for "
                      "target" % (type_label, type_pred), UserWarning)
    if labels_true.ndim != 1:
        raise ValueError("labels_true must be 1D: shape is %r"
                         % (labels_true.shape,))
    if labels_pred.ndim != 1:
        raise ValueError("labels_pred must be 1D: shape is %r"
                         % (labels_pred.shape,))
    _consistent_length(labels_true, labels_pred)
    return labels_true, labels_pred


def _contingency(labels_true, labels_pred):
    """The int64 contingency table [classes, clusters]."""
    _, ci = np.unique(labels_true, return_inverse=True)
    _, ki = np.unique(labels_pred, return_inverse=True)
    C, K = int(ci.max(initial=-1)) + 1, int(ki.max(initial=-1)) + 1
    return np.bincount(ci.reshape(-1) * K + ki.reshape(-1),
                       minlength=C * K).reshape(C, K).astype(np.int64)


def _entropy(labels):
    if len(labels) == 0:
        return 1.0
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _mutual_info(contingency):
    """scikit-learn's ``mutual_info_score`` of a contingency table (its
    nonzero cells in row-major order, as ``scipy.sparse.find`` gives
    them)."""
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy]
    contingency_sum = contingency.sum()
    pi = np.ravel(contingency.sum(axis=1))
    pj = np.ravel(contingency.sum(axis=0))
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx).astype(np.int64, copy=False) \
        * pj.take(nzy).astype(np.int64, copy=False)
    log_outer = -np.log(outer) + log(pi.sum()) + log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def mutual_info_score(labels_true, labels_pred):
    """The mutual information of two labelings (nats)."""
    labels_true, labels_pred = _check_clusterings(labels_true, labels_pred)
    return _mutual_info(_contingency(labels_true, labels_pred))


def _expected_mutual_info(contingency, n_samples):
    """scikit-learn's ``expected_mutual_information`` (its Cython loop
    over the cells and each cell's admissible count, summed in that order)
    in numpy, with ``scipy.special.gammaln`` for ``lgamma``."""
    from scipy.special import gammaln
    a = np.ravel(contingency.sum(axis=1).astype(np.int64, copy=False))
    b = np.ravel(contingency.sum(axis=0).astype(np.int64, copy=False))
    if a.size == 1 or b.size == 1:
        return 0.0
    nijs = np.arange(0, max(np.max(a), np.max(b)) + 1, dtype="float")
    nijs[0] = 1
    term1 = nijs / n_samples
    log_a = np.log(a)
    log_b = np.log(b)
    log_Nnij = np.log(n_samples) + np.log(nijs)
    gln_a = gammaln(a + 1)
    gln_b = gammaln(b + 1)
    gln_Na = gammaln(n_samples - a + 1)
    gln_Nb = gammaln(n_samples - b + 1)
    gln_Nnij = gammaln(nijs + 1) + gammaln(n_samples + 1)
    i, j = (x.reshape(-1) for x in np.meshgrid(
        np.arange(a.size), np.arange(b.size), indexing="ij"))
    start = np.maximum(1, a[i] - n_samples + b[j])
    lens = np.maximum(np.minimum(a[i], b[j]) + 1 - start, 0)
    i, j = np.repeat(i, lens), np.repeat(j, lens)
    nij = np.repeat(start - (np.cumsum(lens) - lens), lens) \
        + np.arange(int(lens.sum()))
    ai, bj = a[i], b[j]
    term2 = log_Nnij[nij] - log_a[i] - log_b[j]
    gln = (gln_a[i] + gln_b[j] + gln_Na[i] + gln_Nb[j] - gln_Nnij[nij]
           - gammaln((ai - nij + 1).astype(np.float64))
           - gammaln((bj - nij + 1).astype(np.float64))
           - gammaln((n_samples - ai - bj + nij + 1).astype(np.float64)))
    terms = term1[nij] * term2 * np.exp(gln)
    return float(np.cumsum(terms)[-1]) if terms.size else 0.0


def adjusted_mutual_info_score(labels_true, labels_pred):
    """The mutual information adjusted for chance (the entropies'
    arithmetic mean as the normalizer)."""
    labels_true, labels_pred = _check_clusterings(labels_true, labels_pred)
    n_samples = labels_true.shape[0]
    classes = np.unique(labels_true)
    clusters = np.unique(labels_pred)
    if (classes.shape[0] == clusters.shape[0] == 1
            or classes.shape[0] == clusters.shape[0] == 0):
        return 1.0
    if classes.shape[0] == 1 or clusters.shape[0] == 1:
        return 0.0
    contingency = _contingency(labels_true, labels_pred)
    mi = _mutual_info(contingency)
    emi = _expected_mutual_info(contingency, n_samples)
    h_true, h_pred = _entropy(labels_true), _entropy(labels_pred)
    normalizer = np.mean([h_true, h_pred])
    eps = np.finfo("float64").eps
    denominator = normalizer - emi
    denominator = min(denominator, -eps) if denominator < 0 \
        else max(denominator, eps)
    numerator = mi - emi
    numerator = min(numerator, -eps) if numerator < 0 else max(numerator,
                                                                  eps)
    return float(numerator / denominator)


def normalized_mutual_info_score(labels_true, labels_pred):
    """The mutual information over the mean of the two entropies."""
    labels_true, labels_pred = _check_clusterings(labels_true, labels_pred)
    classes = np.unique(labels_true)
    clusters = np.unique(labels_pred)
    if (classes.shape[0] == clusters.shape[0] == 1
            or classes.shape[0] == clusters.shape[0] == 0):
        return 1.0
    mi = _mutual_info(_contingency(labels_true, labels_pred))
    if mi == 0:
        return 0.0
    h_true, h_pred = _entropy(labels_true), _entropy(labels_pred)
    return float(mi / np.mean([h_true, h_pred]))


def homogeneity_completeness_v_measure(labels_true, labels_pred):
    """(homogeneity, completeness, V-measure) of a labeling."""
    labels_true, labels_pred = _check_clusterings(labels_true, labels_pred)
    if len(labels_true) == 0:
        return 1.0, 1.0, 1.0
    entropy_C = _entropy(labels_true)
    entropy_K = _entropy(labels_pred)
    MI = _mutual_info(_contingency(labels_true, labels_pred))
    homogeneity = MI / (entropy_C) if entropy_C else 1.0
    completeness = MI / (entropy_K) if entropy_K else 1.0
    if homogeneity + completeness == 0.0:
        v_measure = 0.0
    else:
        # scikit-learn's (1 + beta) h c / (beta h + c) at beta = 1.0
        v_measure = (2.0 * homogeneity * completeness
                     / (homogeneity + completeness))
    return float(homogeneity), float(completeness), float(v_measure)


def homogeneity_score(labels_true, labels_pred):
    return homogeneity_completeness_v_measure(labels_true, labels_pred)[0]


def completeness_score(labels_true, labels_pred):
    return homogeneity_completeness_v_measure(labels_true, labels_pred)[1]


def v_measure_score(labels_true, labels_pred):
    return homogeneity_completeness_v_measure(labels_true, labels_pred)[2]


def _pair_confusion(labels_true, labels_pred):
    """The 2 x 2 int64 pair confusion matrix."""
    labels_true, labels_pred = _check_clusterings(labels_true, labels_pred)
    n_samples = np.int64(labels_true.shape[0])
    contingency = _contingency(labels_true, labels_pred)
    n_c = np.ravel(contingency.sum(axis=1))
    n_k = np.ravel(contingency.sum(axis=0))
    sum_squares = (contingency ** 2).sum()
    C = np.empty((2, 2), dtype=np.int64)
    C[1, 1] = sum_squares - n_samples
    C[0, 1] = contingency.dot(n_k).sum() - sum_squares
    C[1, 0] = contingency.transpose().dot(n_c).sum() - sum_squares
    C[0, 0] = n_samples ** 2 - C[0, 1] - C[1, 0] - sum_squares
    return C


def rand_score(labels_true, labels_pred):
    """The share of sample pairs on which two labelings agree."""
    contingency = _pair_confusion(labels_true, labels_pred)
    numerator = contingency.diagonal().sum()
    denominator = contingency.sum()
    if numerator == denominator or denominator == 0:
        return 1.0
    return float(numerator / denominator)


def adjusted_rand_score(labels_true, labels_pred):
    """The Rand index adjusted for chance."""
    (tn, fp), (fn, tp) = _pair_confusion(labels_true, labels_pred)
    tn, fp, fn, tp = int(tn), int(fp), int(fn), int(tp)
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def fowlkes_mallows_score(labels_true, labels_pred):
    """The geometric mean of pairwise precision and recall."""
    labels_true, labels_pred = _check_clusterings(labels_true, labels_pred)
    (n_samples,) = labels_true.shape
    c = _contingency(labels_true, labels_pred)
    data = c[np.nonzero(c)]
    tk = np.dot(data, data) - n_samples
    pk = np.sum(np.asarray(c.sum(axis=0)).ravel() ** 2) - n_samples
    qk = np.sum(np.asarray(c.sum(axis=1)).ravel() ** 2) - n_samples
    return float(np.sqrt(tk / pk) * np.sqrt(tk / qk)) if tk != 0.0 else 0.0


# --------------------------------------------------------------------- #
# regression scores of the labels
# --------------------------------------------------------------------- #
def _reg_targets(y_true, y_pred, dtype="float"):
    """scikit-learn's ``_check_reg_targets`` of 1-d targets: both as
    [n, 1] columns; ``dtype="float"`` converts to the inputs' float type
    (float64 unless one is a float array), ``"numeric"`` keeps numbers."""
    if dtype == "float":
        floats = [np.asarray(a).dtype for a in (y_true, y_pred)
                  if hasattr(a, "dtype") and np.asarray(a).dtype.kind == "f"]
        dtype = np.result_type(*floats) if floats else np.float64
    _consistent_length(y_true, y_pred)
    y_true = _check_array(y_true, dtype)
    y_pred = _check_array(y_pred, dtype)
    if y_true.ndim == 1:
        y_true = y_true.reshape(-1, 1)
    if y_pred.ndim == 1:
        y_pred = y_pred.reshape(-1, 1)
    if y_true.shape[1] != y_pred.shape[1]:
        raise ValueError("y_true and y_pred have different number of output "
                         "({0}!={1})".format(y_true.shape[1], y_pred.shape[1]))
    return y_true, y_pred


def _explained_fraction(numerator, denominator):
    """scikit-learn's ``_assemble_fraction_of_explained_deviance`` with
    ``force_finite=True``, averaged uniformly."""
    nonzero_denominator = denominator != 0
    nonzero_numerator = numerator != 0
    output_scores = np.ones([numerator.shape[0]], dtype=numerator.dtype)
    valid = nonzero_denominator & nonzero_numerator
    output_scores[valid] = 1 - (numerator[valid] / denominator[valid])
    output_scores[nonzero_numerator & ~nonzero_denominator] = 0.0
    return float(np.average(output_scores))


def explained_variance_score(y_true, y_pred):
    """1 - Var(y_true - y_pred) / Var(y_true), 1.0 or 0.0 where that
    divides by zero."""
    y_true, y_pred = _reg_targets(y_true, y_pred)
    y_diff_avg = np.average(y_true - y_pred, axis=0)
    numerator = np.average((y_true - y_pred - y_diff_avg) ** 2, axis=0)
    y_true_avg = np.average(y_true, axis=0)
    denominator = np.average((y_true - y_true_avg) ** 2, axis=0)
    return _explained_fraction(numerator, denominator)


def r2_score(y_true, y_pred):
    """The coefficient of determination, 1.0 or 0.0 where it divides by
    zero; NaN and a warning for fewer than two samples."""
    y_true, y_pred = _reg_targets(y_true, y_pred)
    if y_pred.shape[0] < 2:
        warnings.warn("R^2 score is not well-defined with less than two "
                      "samples.", UndefinedMetricWarning)
        return float("nan")
    weight = 1.0
    numerator = np.sum(weight * (y_true - y_pred) ** 2, axis=0)
    denominator = np.sum(weight * (y_true - np.average(y_true, axis=0)) ** 2,
                         axis=0)
    return _explained_fraction(numerator, denominator)


def _pinball_loss(y_true, y_pred, alpha, weights=None):
    diff = y_true - y_pred
    sign = (diff >= 0).astype(diff.dtype)
    loss = alpha * sign * diff - (1 - alpha) * (1 - sign) * diff
    return np.average(loss, weights=weights, axis=0)


def d2_absolute_error_score(y_true, y_pred):
    """1 - the mean absolute error over that of the median of
    ``y_true``; NaN and a warning for fewer than two samples."""
    y_true, y_pred = _reg_targets(y_true, y_pred)
    if y_pred.shape[0] < 2:
        warnings.warn("D^2 score is not well-defined with less than two "
                      "samples.", UndefinedMetricWarning)
        return float("nan")
    numerator = _pinball_loss(y_true, y_pred, 0.5)
    n = y_true.shape[0]
    # scikit-learn's _weighted_percentile at 50 with unit weights and
    # averaging: the middle value, or the mean of the two middle values
    s = np.sort(y_true[:, 0])
    median = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    y_quantile = np.tile(np.asarray([median], dtype=y_true.dtype), (n, 1))
    denominator = _pinball_loss(y_true, y_quantile, 0.5,
                                np.ones(n, dtype=y_true.dtype))
    return _explained_fraction(numerator, denominator)


def max_error(y_true, y_pred):
    """The largest absolute difference."""
    y_true, y_pred = _reg_targets(y_true, y_pred, "numeric")
    return float(np.max(np.abs(y_true - y_pred)))


def mean_absolute_error(y_true, y_pred):
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return float(np.average(np.average(np.abs(y_pred - y_true), axis=0)))


def mean_absolute_percentage_error(y_true, y_pred):
    """The mean of |y_pred - y_true| / max(|y_true|, eps)."""
    y_true, y_pred = _reg_targets(y_true, y_pred)
    epsilon = np.asarray(np.finfo(np.float64).eps, dtype=y_true.dtype)
    mape = np.abs(y_pred - y_true) / np.maximum(np.abs(y_true), epsilon)
    return float(np.average(np.average(mape, axis=0)))


def _squared_errors(y_true, y_pred):
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return np.average((y_true - y_pred) ** 2, axis=0)


def mean_squared_error(y_true, y_pred):
    return float(np.average(_squared_errors(y_true, y_pred)))


def root_mean_squared_error(y_true, y_pred):
    return float(np.average(np.sqrt(_squared_errors(y_true, y_pred))))


def _log1p_targets(y_true, y_pred, what):
    y_true, y_pred = _reg_targets(y_true, y_pred)
    if np.any(y_true <= -1) or np.any(y_pred <= -1):
        raise ValueError("%s cannot be used when targets contain values "
                         "less than or equal to -1." % what)
    return np.log1p(y_true), np.log1p(y_pred)


def mean_squared_log_error(y_true, y_pred):
    """The mean squared error of log1p of both; targets above -1."""
    return mean_squared_error(*_log1p_targets(
        y_true, y_pred, "Mean Squared Logarithmic Error"))


def root_mean_squared_log_error(y_true, y_pred):
    return root_mean_squared_error(*_log1p_targets(
        y_true, y_pred, "Root Mean Squared Logarithmic Error"))


def median_absolute_error(y_true, y_pred):
    y_true, y_pred = _reg_targets(y_true, y_pred, "numeric")
    return float(np.average(np.median(np.abs(y_pred - y_true), axis=0)))


# --------------------------------------------------------------------- #
# scores of decision values
# --------------------------------------------------------------------- #
def _pos_label_consistency(pos_label, y_true):
    if pos_label is None:
        classes = np.unique(y_true)
        if (classes.dtype.kind in "OUS" or classes.shape[0] > 2
                or not any(np.array_equal(classes, c) for c in
                           ([0, 1], [-1, 1], [0], [-1], [1]))):
            raise ValueError(
                "y_true takes value in {%s} and pos_label is not specified: "
                "either make y_true take value in {0, 1} or {-1, 1} or pass "
                "pos_label explicitly."
                % ", ".join(repr(c) for c in classes.tolist()))
        pos_label = 1
    return pos_label


def _binary_clf_curve(y_true, y_score, pos_label=None):
    """(fps, tps, thresholds) at each distinct score, descending:
    scikit-learn's ``confusion_matrix_at_thresholds`` unweighted."""
    y_true = np.asarray(y_true)
    y_type = _type_of_target(y_true, "y_true")
    if not (y_type == "binary"
            or (y_type == "multiclass" and pos_label is not None)):
        raise ValueError("{0} format is not supported".format(y_type))
    pos_label = _pos_label_consistency(pos_label, y_true)
    y_true = np.asarray(y_true == pos_label, dtype=np.int32)
    _consistent_length(y_true, y_score)
    y_true = _column_or_1d(y_true)
    y_score = _column_or_1d(y_score)
    _assert_finite(y_true)
    _assert_finite(y_score)
    # a stable descending sort, as array_api_compat's argsort makes it
    desc = np.flip(np.argsort(np.flip(y_score), kind="stable"))
    desc = y_score.shape[0] - 1 - desc
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct_value_indices = np.nonzero(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct_value_indices,
                                     np.asarray([y_true.size - 1])])
    y_true = y_true.astype(np.float64)
    tps = np.cumsum(y_true * 1.0, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def _binary_roc_auc(y_true, y_score):
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.", UndefinedMetricWarning)
        return np.nan
    from scipy.integrate import trapezoid
    fps, tps, _ = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        optimal_idxs = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
             [True]]))[0]
        fps = fps[optimal_idxs]
        tps = tps[optimal_idxs]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    # two classes are present: fps[-1] and tps[-1] are positive
    fpr = fps / fps[-1]
    tpr = tps / tps[-1]
    dx = np.diff(fpr)
    direction = 1
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError("x is neither increasing nor decreasing : {}."
                             .format(fpr))
    return float(direction * trapezoid(tpr, fpr))


def roc_auc_score(y_true, y_score):
    """The area under the ROC curve of a binary target, the positive
    class the greater label; NaN and a warning when ``y_true`` holds one
    class.  Multiclass targets raise, as scikit-learn's default
    ``multi_class="raise"`` does."""
    y_type = _type_of_target(y_true, "y_true")
    y_true = _check_array(y_true)
    y_score = _check_array(y_score, "numeric")
    if y_type == "multiclass" or (y_type == "binary" and y_score.ndim == 2
                                  and y_score.shape[1] > 2):
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    if y_type != "binary":
        raise ValueError("{0} format is not supported".format(y_type))
    labels = np.unique(y_true)
    y_true = (y_true == labels[1]).astype(np.int64) if labels.shape[0] == 2 \
        else np.zeros(y_true.shape[0], np.int64)
    return _binary_roc_auc(y_true, y_score)


def _binary_average_precision(y_true, y_score, pos_label=1):
    fps, tps, _ = _binary_clf_curve(y_true, y_score, pos_label)
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to "
                      "one for all thresholds.")
        recall = np.full(tps.shape, 1.0)
    else:
        recall = tps / tps[-1]
    precision = np.concatenate((np.flip(precision), np.asarray([1.0])))
    recall = np.concatenate((np.flip(recall), np.asarray([0.0])))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision_score(y_true, y_score, *, pos_label=1):
    """The average precision (the step area under the precision-recall
    curve) of ``pos_label``; of a multiclass target, the mean over its
    classes, one against the rest, of ``y_score``'s columns."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    y_type = _type_of_target(y_true, "y_true")
    present_labels = np.unique(y_true)
    if y_type == "binary":
        if present_labels.shape[0] == 2 and pos_label not in present_labels:
            raise ValueError(f"pos_label={pos_label} is not a valid label. "
                             f"It should be one of {present_labels}")
        return _binary_average_precision(y_true, y_score, pos_label)
    if y_type != "multiclass":
        raise ValueError("{0} format is not supported".format(y_type))
    if pos_label != 1:
        raise ValueError("Parameter pos_label is fixed to 1 for multiclass "
                         "y_true. Do not set pos_label or set pos_label to "
                         "1.")
    Y = (y_true.reshape(-1, 1) == present_labels.reshape(1, -1)).astype(
        np.int64)
    if not y_score.shape == Y.shape:
        raise ValueError("`y_score` needs to be of shape `(n_samples, "
                         "n_classes)`, since `y_true` contains multiple "
                         "classes. Got `y_score.shape=%s`." % (y_score.shape,))
    y_score = _check_array(y_score, "numeric")
    score = np.zeros((Y.shape[1],))
    for c in range(Y.shape[1]):
        score[c] = _binary_average_precision(Y[:, c], y_score[:, c])
    return float(np.average(score))


def top_k_accuracy_score(y_true, y_score, *, k=2, labels=None):
    """The share of samples whose label is among the ``k`` classes of
    highest score (binary: 1-d scores, the positive class the greater
    label)."""
    y_true = _column_or_1d(_check_array(y_true))
    y_type = _type_of_target(y_true, "y_true")
    if y_type == "binary" and labels is not None and len(labels) > 2:
        y_type = "multiclass"
    if y_type not in {"binary", "multiclass"}:
        raise ValueError(f"y type must be 'binary' or 'multiclass', got "
                         f"'{y_type}' instead.")
    y_score = _check_array(y_score, "numeric")
    if y_type == "binary":
        if y_score.ndim == 2 and y_score.shape[1] != 1:
            raise ValueError(
                "`y_true` is binary while y_score is 2d with"
                f" {y_score.shape[1]} classes. If `y_true` does not contain "
                "all the labels, `labels` must be provided.")
        y_score = _column_or_1d(y_score)
    elif not y_score.ndim == 2:
        raise ValueError("`y_score` needs to be of shape `(n_samples, "
                         "n_classes)`, since `y_true` contains multiple "
                         "classes. Got `y_score.shape=%s`." % (y_score.shape,))
    _consistent_length(y_true, y_score)
    y_score_n_classes = y_score.shape[1] if y_score.ndim == 2 else 2
    if labels is None:
        classes = np.unique(y_true)
        n_classes = len(classes)
        if n_classes != y_score_n_classes:
            raise ValueError(
                f"Number of classes in 'y_true' ({n_classes}) not equal "
                f"to the number of classes in 'y_score' "
                f"({y_score_n_classes}).You can provide a list of all known "
                "classes by assigning it to the `labels` parameter.")
    else:
        labels = _column_or_1d(labels)
        classes = np.unique(labels)
        n_labels = len(labels)
        n_classes = len(classes)
        if n_classes != n_labels:
            raise ValueError("Parameter 'labels' must be unique.")
        if not np.array_equal(classes, labels):
            raise ValueError("Parameter 'labels' must be ordered.")
        if n_classes != y_score_n_classes:
            raise ValueError(
                f"Number of given labels ({n_classes}) not equal to the "
                f"number of classes in 'y_score' ({y_score_n_classes}).")
        if len(np.setdiff1d(y_true, classes)):
            raise ValueError("'y_true' contains labels not in parameter "
                             "'labels'.")
    if k >= n_classes:
        warnings.warn(f"'k' ({k}) greater than or equal to 'n_classes' "
                      f"({n_classes}) will result in a perfect score and is "
                      "therefore meaningless.", UndefinedMetricWarning)
    y_true_encoded = np.searchsorted(classes, y_true)
    if y_type == "binary":
        if k == 1:
            threshold = 0.5 if y_score.min() >= 0 and y_score.max() <= 1 \
                else 0
            y_pred = (y_score > threshold).astype(np.int64)
            hits = y_pred == y_true_encoded
        else:
            hits = np.ones_like(y_score, dtype=np.bool_)
    else:
        sorted_pred = np.argsort(y_score, axis=1, kind="mergesort")[:, ::-1]
        hits = (y_true_encoded == sorted_pred[:, :k].T).any(axis=0)
    return float(np.average(hits))


# --------------------------------------------------------------------- #
# scorers
# --------------------------------------------------------------------- #
class _PredictScorer:
    """``scorer(estimator, X, y)``: ``sign`` times the metric of
    ``estimator.predict(X)`` against ``y``; :meth:`score` takes the
    predictions directly.  ``pos_label`` (None, or the positive label a
    binary metric reads) must be one of a binary fit's classes
    (:meth:`check_classes`), as scikit-learn's scorers require."""

    def __init__(self, name, metric, sign=1, pos_label=None, **kwargs):
        self.name = name
        self._metric = metric
        self._sign = sign
        self._pos_label = pos_label
        self._kwargs = kwargs

    def check_classes(self, classes):
        """Raise scikit-learn's ``ValueError`` when the scorer's positive
        label is not among a binary fit's ``classes``."""
        if (self._pos_label is not None and classes.shape[0] == 2
                and _type_of_target(classes) == "binary"
                and self._pos_label not in classes.tolist()):
            raise ValueError(f"pos_label={self._pos_label} is not a valid "
                             f"label: It should be one of {classes}")

    def score(self, y_true, y_pred):
        return self._sign * self._metric(y_true, y_pred, **self._kwargs)

    def __call__(self, estimator, X, y_true):
        self.check_classes(estimator.classes_)
        return self.score(y_true, estimator.predict(X))

    def __repr__(self):
        return "make_scorer(%s)" % self.name


class _DecisionScorer(_PredictScorer):
    """``scorer(estimator, X, y)``: the metric of
    ``estimator.decision_function(X)`` against ``y``;
    :meth:`score_dec` takes the decision values directly (a binary
    fit's sign already turned to ``pos_label`` by :meth:`oriented`)."""

    def oriented(self, classes, y_score):
        """``y_score`` negated where the scorer's positive label is a
        binary fit's first class (scikit-learn's
        ``_process_decision_function``)."""
        if (classes.shape[0] == 2 and self._pos_label is not None
                and self._pos_label == classes[0]):
            return -1 * y_score
        return y_score

    def score_dec(self, y_true, y_score):
        return self._sign * self._metric(y_true, y_score, **self._kwargs)

    def __call__(self, estimator, X, y_true):
        classes = estimator.classes_
        self.check_classes(classes)
        return self.score_dec(y_true, self.oriented(
            classes, estimator.decision_function(X)))


_REGRESSION = (("explained_variance", explained_variance_score, 1),
               ("r2", r2_score, 1),
               ("d2_absolute_error_score", d2_absolute_error_score, 1),
               ("neg_max_error", max_error, -1),
               ("neg_mean_absolute_error", mean_absolute_error, -1),
               ("neg_mean_absolute_percentage_error",
                mean_absolute_percentage_error, -1),
               ("neg_mean_squared_error", mean_squared_error, -1),
               ("neg_mean_squared_log_error", mean_squared_log_error, -1),
               ("neg_median_absolute_error", median_absolute_error, -1),
               ("neg_root_mean_squared_error", root_mean_squared_error, -1),
               ("neg_root_mean_squared_log_error",
                root_mean_squared_log_error, -1))
_CLUSTERING = (mutual_info_score, adjusted_mutual_info_score,
               normalized_mutual_info_score, homogeneity_score,
               completeness_score, v_measure_score, adjusted_rand_score,
               rand_score, fowlkes_mallows_score)


def _registry():
    out = {}
    for name, metric in (("accuracy", accuracy_score),
                         ("balanced_accuracy", balanced_accuracy_score),
                         ("matthews_corrcoef", matthews_corrcoef),
                         ("positive_likelihood_ratio",
                          positive_likelihood_ratio)):
        out[name] = _PredictScorer(name, metric)
    out["neg_negative_likelihood_ratio"] = _PredictScorer(
        "neg_negative_likelihood_ratio", negative_likelihood_ratio, -1)
    for name, metric in (("precision", precision_score),
                         ("recall", recall_score), ("f1", f1_score),
                         ("jaccard", jaccard_score)):
        out[name] = _PredictScorer(name, metric, pos_label=1)
        for average in ("micro", "macro", "weighted"):
            key = "%s_%s" % (name, average)
            out[key] = _PredictScorer(key, metric, average=average)
    for metric in _CLUSTERING:
        out[metric.__name__] = _PredictScorer(metric.__name__, metric)
    for name, metric, sign in _REGRESSION:
        out[name] = _PredictScorer(name, metric, sign)
    out["roc_auc"] = _DecisionScorer("roc_auc", roc_auc_score)
    out["average_precision"] = _DecisionScorer(
        "average_precision", average_precision_score, pos_label=1)
    out["top_k_accuracy"] = _DecisionScorer("top_k_accuracy",
                                            top_k_accuracy_score)
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
