"""grakel_torch.metrics against sklearn.metrics on seeded random labels
and scores: the same value to the last bit, the same exception type and
message where scikit-learn raises, and the same warnings (category name
and text).  The one tolerance: adjusted_mutual_info_score, whose expected
mutual information scikit-learn sums from libm ``exp`` and ``lgamma``
terms in Cython (the port: numpy's ``exp`` and ``scipy.special.gammaln``),
is held to rtol 1e-12."""

import warnings

import numpy as np
import pytest
import sklearn.metrics as skm

from grakel_torch import metrics as tm


def _outcome(fn):
    """(("ok", value) or ("error", type name, message), warnings as
    (category name, text))."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            got = ("ok", fn())
        except Exception as e:
            got = ("error", type(e).__name__, str(e))
    return got, [(w.category.__name__, str(w.message)) for w in seen]


def _held(port, ref, rtol=0.0):
    a, wa = _outcome(port)
    b, wb = _outcome(ref)
    assert a[0] == b[0], (a, b)
    if a[0] == "error":
        assert a[1:] == b[1:]
    elif rtol:
        np.testing.assert_allclose(a[1], b[1], rtol=rtol, atol=0)
    else:
        assert type(a[1]) is type(b[1]) or np.isscalar(a[1])
        assert (a[1] == b[1] or (np.isnan(a[1]) and np.isnan(b[1]))), (a, b)
    assert wa == wb
    return a


# label sets: binary, three classes, the usual SVM coding, one class
# present, strings (two and three), booleans
LABELS = {"binary": [0, 1], "three": [0, 1, 2], "pm1": [-1, 1],
          "one": [4], "str2": ["a", "b"], "str3": ["a", "b", "c"],
          "bool": [False, True]}


def _labels(case, seed, n=23):
    rng = np.random.RandomState(seed)
    labs = np.array(LABELS[case])
    t = labs[rng.randint(0, labs.shape[0], n)]
    # a prediction that agrees with the truth about half the time
    p = np.where(rng.rand(n) < 0.5, t, labs[rng.randint(0, labs.shape[0],
                                                          n)])
    return t, p


PREDICT = {
    "accuracy_score": (tm.accuracy_score, skm.accuracy_score),
    "balanced_accuracy_score": (tm.balanced_accuracy_score,
                                skm.balanced_accuracy_score),
    "matthews_corrcoef": (tm.matthews_corrcoef, skm.matthews_corrcoef),
    "jaccard": (tm.jaccard_score, skm.jaccard_score),
    "jaccard_micro": (lambda t, p: tm.jaccard_score(t, p, average="micro"),
                      lambda t, p: skm.jaccard_score(t, p,
                                                     average="micro")),
    "jaccard_macro": (lambda t, p: tm.jaccard_score(t, p, average="macro"),
                      lambda t, p: skm.jaccard_score(t, p,
                                                     average="macro")),
    "jaccard_weighted": (
        lambda t, p: tm.jaccard_score(t, p, average="weighted"),
        lambda t, p: skm.jaccard_score(t, p, average="weighted")),
    "likelihood_ratios": (tm.class_likelihood_ratios,
                          skm.class_likelihood_ratios),
    "likelihood_ratios_1": (
        lambda t, p: tm.class_likelihood_ratios(t, p,
                                                replace_undefined_by=1.0),
        lambda t, p: skm.class_likelihood_ratios(t, p,
                                                 replace_undefined_by=1.0)),
}
for _name in ("precision_score", "recall_score", "f1_score"):
    for _average in ("binary", "micro", "macro", "weighted"):
        PREDICT["%s_%s" % (_name, _average)] = (
            lambda t, p, f=getattr(tm, _name), a=_average: f(t, p,
                                                             average=a),
            lambda t, p, f=getattr(skm, _name), a=_average: f(t, p,
                                                              average=a))
for _name in ("mutual_info_score", "adjusted_mutual_info_score",
              "normalized_mutual_info_score", "homogeneity_score",
              "completeness_score", "v_measure_score", "adjusted_rand_score",
              "rand_score", "fowlkes_mallows_score",
              "explained_variance_score", "r2_score",
              "d2_absolute_error_score", "max_error", "mean_absolute_error",
              "mean_absolute_percentage_error", "mean_squared_error",
              "mean_squared_log_error", "median_absolute_error",
              "root_mean_squared_error", "root_mean_squared_log_error"):
    PREDICT[_name] = (getattr(tm, _name), getattr(skm, _name))


@pytest.mark.parametrize("case", sorted(LABELS))
@pytest.mark.parametrize("name", sorted(PREDICT))
def test_prediction_metric_equals_sklearn(name, case):
    port, ref = PREDICT[name]
    rtol = 1e-12 if name == "adjusted_mutual_info_score" else 0.0
    for seed in range(4):
        t, p = _labels(case, seed)
        a, wa = _outcome(lambda: port(t, p))
        b, wb = _outcome(lambda: ref(t, p))
        assert a[0] == b[0], (name, case, seed, a, b)
        if a[0] == "error":
            assert a[1:] == b[1:]
        elif isinstance(a[1], tuple):
            assert np.array_equal(a[1], b[1], equal_nan=True)
        elif rtol and a[1] != b[1]:
            np.testing.assert_allclose(a[1], b[1], rtol=rtol, atol=0)
        else:
            assert a[1] == b[1] or (np.isnan(a[1]) and np.isnan(b[1])), \
                (name, case, seed, a, b)
        assert wa == wb


def test_prediction_metrics_raise_as_sklearn():
    """The cases the CV meets where scikit-learn raises: a binary metric
    on three classes, the log errors on labels -1 and 1, string labels in
    a regression score, booleans in the differences it takes as numbers,
    mismatched lengths and an empty input."""
    t3, p3 = _labels("three", 0)
    tpm, ppm = _labels("pm1", 0)
    ts, ps = _labels("str2", 0)
    tb, pb = _labels("bool", 0)
    cases = [(tm.jaccard_score, skm.jaccard_score, t3, p3),
             (tm.class_likelihood_ratios, skm.class_likelihood_ratios, t3,
              p3),
             (tm.mean_squared_log_error, skm.mean_squared_log_error, tpm,
              ppm),
             (tm.root_mean_squared_log_error,
              skm.root_mean_squared_log_error, tpm, ppm),
             (tm.mean_squared_error, skm.mean_squared_error, ts, ps),
             (tm.median_absolute_error, skm.median_absolute_error, ts, ps),
             (tm.max_error, skm.max_error, tb, pb),
             (tm.median_absolute_error, skm.median_absolute_error, tb, pb),
             (tm.matthews_corrcoef, skm.matthews_corrcoef, t3, p3[:-1]),
             (tm.r2_score, skm.r2_score, t3[:0], p3[:0]),
             (tm.jaccard_score, skm.jaccard_score, ts, ps),
             (tm.matthews_corrcoef, skm.matthews_corrcoef, ts,
              np.zeros(ts.shape[0], int))]
    for port, ref, t, p in cases:
        got = _held(lambda: port(t, p), lambda: ref(t, p))
        assert got[0] == "error", (port.__name__, got)


def test_single_sample_regression_scores_warn_nan():
    for name in ("r2_score", "d2_absolute_error_score"):
        got = _held(lambda: getattr(tm, name)([1], [0]),
                    lambda: getattr(skm, name)([1], [0]))
        assert np.isnan(got[1])


def _scores(case, seed, cols, n=23, ties=False):
    t = _labels(case, seed, n)[0]
    rng = np.random.RandomState(seed + 100)
    s = rng.randn(n) if cols is None else rng.randn(n, cols)
    return t, (np.round(s, 1) if ties else s)


DECISION = {"roc_auc": (tm.roc_auc_score, skm.roc_auc_score),
            "average_precision": (tm.average_precision_score,
                                  skm.average_precision_score),
            "top_k_accuracy": (tm.top_k_accuracy_score,
                               skm.top_k_accuracy_score)}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", sorted(LABELS))
@pytest.mark.parametrize("name", sorted(DECISION))
def test_decision_metric_equals_sklearn(name, case, ties):
    """1-d scores (a binary fit's decision values) and 2-d scores of two
    to four columns (a multiclass fit's), with and without ties."""
    port, ref = DECISION[name]
    for seed in range(3):
        for cols in (None, 2, 3, 4):
            t, s = _scores(case, seed, cols, ties=ties)
            _held(lambda: port(t, s), lambda: ref(t, s))


def test_decision_metrics_with_labels_and_k():
    """top_k_accuracy's ``k`` and ``labels`` checks, and average
    precision's ``pos_label``."""
    t, s = _scores("three", 1, 3)
    for kw in (dict(k=1), dict(k=3), dict(labels=[0, 1, 2]),
               dict(labels=[0, 1, 2, 3]), dict(labels=[2, 1, 0]),
               dict(labels=[0, 0, 1]), dict(labels=[0, 1]),
               dict(k=1, labels=[0, 1, 2])):
        _held(lambda: tm.top_k_accuracy_score(t, s, **kw),
              lambda: skm.top_k_accuracy_score(t, s, **kw))
    tb, sb = _scores("binary", 2, None)
    for kw in (dict(k=1), dict(k=1, labels=[0, 1]), dict(labels=[0, 1, 2])):
        _held(lambda: tm.top_k_accuracy_score(tb, sb, **kw),
              lambda: skm.top_k_accuracy_score(tb, sb, **kw))
    for pos_label in (0, 1, 2):
        _held(lambda: tm.average_precision_score(tb, sb,
                                                 pos_label=pos_label),
              lambda: skm.average_precision_score(tb, sb,
                                                  pos_label=pos_label))


def test_scorer_names_and_signs():
    """The 44 names: scikit-learn's 58 less the 14 that raise on any data
    in its precomputed-kernel SVC; each ``neg_*`` negated."""
    from sklearn.metrics import get_scorer, get_scorer_names
    names = tm.get_scorer_names()
    refused = {"neg_log_loss", "neg_brier_score", "d2_log_loss_score",
               "d2_brier_score", "roc_auc_ovr", "roc_auc_ovo",
               "roc_auc_ovr_weighted", "roc_auc_ovo_weighted",
               "precision_samples", "recall_samples", "f1_samples",
               "jaccard_samples", "neg_mean_poisson_deviance",
               "neg_mean_gamma_deviance"}
    assert len(names) == 44 and len(refused) == 14
    assert set(names) | refused == set(get_scorer_names())
    assert not set(names) & refused
    for name in refused:
        with pytest.raises(ValueError, match="not a supported scoring"):
            tm.get_scorer(name)
    t, p = _labels("three", 3)
    for name in names:
        ref = get_scorer(name)
        scorer = tm.get_scorer(name)
        assert scorer._sign == ref._sign, name
        if isinstance(scorer, tm._DecisionScorer):
            continue
        _held(lambda: scorer.score(t, p),
              lambda: ref._sign * ref._score_func(t, p, **ref._kwargs),
              rtol=1e-12 if name == "adjusted_mutual_info_score" else 0.0)
