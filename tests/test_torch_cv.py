"""grakel_torch.cross_validate_Kfold_SVM on the CPU route against
grakel_tpu's (scikit-learn's SVC, KFold, ShuffleSplit and scorers): the
same draws, fits and scores, so the same numbers exactly."""

import os
import warnings

import numpy as np
import pytest
from sklearn import model_selection as sk_ms

import grakel_torch
from grakel_torch import model_selection, use_device
from grakel_torch.metrics import get_scorer_names
from grakel_tpu.utils import cross_validate_Kfold_SVM as cv_jax

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _gram(n, seed, k):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    phi = rng.randn(n, 4) + 0.7 * y[:, None]
    sq = (phi ** 2).sum(1)
    return np.exp(-0.25 * (sq[:, None] + sq[None, :] - 2 * phi @ phi.T)), y


def _cv_port(*args, **kw):
    with use_device("cpu"):
        return grakel_torch.cross_validate_Kfold_SVM(*args, **kw)


def _same(a, b):
    assert len(a) == len(b)
    for x, z in zip(a, b):
        assert [float(v) for v in x] == [float(v) for v in z]


@pytest.mark.parametrize("n,n_splits,seed", [(10, 2, 0), (37, 5, 1),
                                             (100, 10, 2), (41, 41, 3)])
def test_kfold_and_shuffle_split_draws_equal_sklearns(n, n_splits, seed):
    """A shared RandomState consumed in the CV function's order: KFold
    shuffles, then ShuffleSplits on each fold's train set."""
    rs_a, rs_b = np.random.RandomState(seed), np.random.RandomState(seed)
    y = np.zeros(n)
    for _ in range(2):
        fa = list(model_selection.KFold(n_splits, shuffle=True,
                                        random_state=rs_a).split(y))
        fb = list(sk_ms.KFold(n_splits, shuffle=True,
                              random_state=rs_b).split(y))
        assert len(fa) == len(fb) == n_splits
        for (tra, tea), (trb, teb) in zip(fa, fb):
            np.testing.assert_array_equal(tra, trb)
            np.testing.assert_array_equal(tea, teb)
            sa = next(iter(model_selection.ShuffleSplit(
                n_splits=1, test_size=0.1, random_state=rs_a).split(tra)))
            sb = next(iter(sk_ms.ShuffleSplit(
                n_splits=1, test_size=0.1, random_state=rs_b).split(trb)))
            for a, b in zip(sa, sb):
                np.testing.assert_array_equal(a, b)
    assert rs_a.randint(1 << 30) == rs_b.randint(1 << 30)


def test_splitters_check_their_arguments():
    with pytest.raises(ValueError):
        list(model_selection.KFold(5).split(np.zeros(3)))
    with pytest.raises(ValueError):
        model_selection.KFold(1)
    with pytest.raises(ValueError):
        model_selection.KFold(3, random_state=0)
    with pytest.raises(ValueError):
        list(model_selection.ShuffleSplit(test_size=0.99).split(
            np.zeros(2)))
    a = list(model_selection.ShuffleSplit(3, test_size=4,
                                          random_state=7).split(range(12)))
    b = list(sk_ms.ShuffleSplit(3, test_size=4, random_state=7).split(
        np.zeros(12)))
    for x, z in zip(a, b):
        np.testing.assert_array_equal(x[0], z[0])
        np.testing.assert_array_equal(x[1], z[1])


@pytest.mark.parametrize("k", [2, 3])
def test_cv_equals_jax_binary_and_multiclass(k):
    K, y = _gram(48, k, k)
    kw = dict(n_iter=2, n_splits=4, random_state=0)
    _same(_cv_port([K], y, **kw), cv_jax([K], y, **kw))


def test_cv_equals_jax_variants_and_two_elements():
    K1, y = _gram(40, 5, 2)
    K2, _ = _gram(40, 6, 2)
    kw = dict(n_iter=2, n_splits=3, random_state=4,
              C_grid=[[0.1, 1.0], [10.0, 100.0]])
    _same(_cv_port([K1, [K2, K1, 0.5 * K1]], y, **kw),
          cv_jax([K1, [K2, K1, 0.5 * K1]], y, **kw))


@pytest.mark.parametrize("seed", ["int", "randomstate", "none"])
def test_cv_equals_jax_random_state_inputs(seed):
    """An int, a RandomState, and None: scikit-learn's SVC.fit draws a
    seed from numpy's global generator, so None shares it with the
    folds."""
    K, y = _gram(36, 9, 2)
    kw = dict(n_iter=2, n_splits=3, C_grid=10.0 ** np.arange(-1, 3))
    runs = []
    for cv in (_cv_port, cv_jax):
        np.random.seed(11)
        rs = {"int": 3, "randomstate": np.random.RandomState(3),
              "none": None}[seed]
        runs.append((cv([K], y, random_state=rs, **kw),
                     np.random.randint(1 << 30)))
    _same(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


# the names whose scorer needs two classes (a binary average, the
# likelihood ratios, the decision values of a binary fit); the others run
# on three
BINARY_ONLY = ("precision", "recall", "f1", "jaccard", "roc_auc",
               "average_precision", "top_k_accuracy",
               "positive_likelihood_ratio", "neg_negative_likelihood_ratio")
# the names that score a number only where every inner eval block holds
# both classes (else the likelihood ratios and top_k_accuracy raise and
# roc_auc is NaN, in both packages): 90 points, blocks of 6
BOTH_IN_EVERY_BLOCK = ("roc_auc", "average_precision", "top_k_accuracy",
                       "positive_likelihood_ratio",
                       "neg_negative_likelihood_ratio")


@pytest.mark.parametrize("scoring", get_scorer_names())
def test_cv_equals_jax_every_scorer(scoring):
    k = 2 if scoring in BINARY_ONLY else 3
    K, y = _gram(90 if scoring in BOTH_IN_EVERY_BLOCK else 30, 21, k)
    kw = dict(n_iter=1, n_splits=3, random_state=2, scoring=scoring,
              C_grid=[1e-3, 1.0, 1e2])
    with warnings.catch_warnings():       # zero divisions warn in both
        warnings.simplefilter("ignore")
        got, want = _cv_port([K], y, **kw), cv_jax([K], y, **kw)
    if scoring == "adjusted_mutual_info_score":
        # the expected mutual information: numpy's exp and gammaln against
        # scikit-learn's libm exp and lgamma
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        _same(got, want)


@pytest.mark.parametrize("scoring", ["jaccard", "roc_auc",
                                     "positive_likelihood_ratio",
                                     "neg_negative_likelihood_ratio",
                                     "average_precision", "top_k_accuracy"])
def test_cv_three_classes_raise_as_jax(scoring):
    """The six names that fail on three classes in the reference: the
    binary ones on any eval block, average_precision and top_k_accuracy
    where an eval block lacks a class (here every one: 2 points)."""
    K, y = _gram(30, 21, 3)
    kw = dict(n_iter=1, n_splits=3, random_state=2, scoring=scoring,
              C_grid=[1e-3, 1.0])
    outcomes = []
    for cv in (_cv_port, cv_jax):
        with pytest.raises(Exception) as e:
            cv([K], y, **kw)
        outcomes.append((type(e.value), str(e.value)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] is ValueError


def test_cv_fold_of_nan_scores_raises_type_error_as_jax():
    """roc_auc on eval blocks of one point is NaN for every inner fit of
    a fold: no fit is picked, and both packages fail at the unpacking of
    the fold's best model."""
    K, y = _gram(10, 4, 2)
    kw = dict(n_iter=1, n_splits=2, random_state=0, scoring="roc_auc",
              C_grid=[0.1, 10.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for cv in (_cv_port, cv_jax):
            with pytest.raises(TypeError):
                cv([K], y, **kw)


@pytest.mark.parametrize("scoring,k", [
    ("roc_auc", 2), ("average_precision", 2), ("average_precision", 3),
    ("top_k_accuracy", 3)])
def test_cv_decision_scorers_read_the_stages_vote(scoring, k, monkeypatch):
    """A decision-value scorer reads K16's output (a binary fit's
    negated, a multiclass fit's one-vs-rest transform): one vote a stage,
    as with accuracy, and no per-fit SVC."""
    from grakel_torch import svm
    from grakel_torch.ops import csvc
    K, y = _gram(90, 7, k)
    kw = dict(n_iter=1, n_splits=3, random_state=1, C_grid=[0.1, 10.0])
    votes = []
    vote = csvc.vote
    monkeypatch.setattr(csvc, "vote",
                        lambda *a, **k: votes.append(1) or vote(*a, **k))
    _cv_port([K], y, scoring="accuracy", **kw)
    stages = [s["problems"] for s in
              grakel_torch.cross_validate_Kfold_SVM.last["stages"]]
    monkeypatch.setattr(svm, "SVC", None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _cv_port([K], y, scoring=scoring, **kw)
        _same(got, cv_jax([K], y, scoring=scoring, **kw))
    assert votes == [1] * 4
    assert [s["problems"] for s in grakel_torch.cross_validate_Kfold_SVM
            .last["stages"]] == stages


def test_cv_equals_jax_callable_scorer_and_fold_reduce():
    K, y = _gram(36, 14, 3)

    def scorer(est, X, y_true):
        # the estimator is a fitted SVC: read its predictions and a
        # fitted attribute, the same in both packages
        return float(np.mean(est.predict(X) == y_true)) \
            + 1e-3 * float(np.sum(est.n_support_))

    kw = dict(n_iter=2, n_splits=3, random_state=8, scoring=scorer,
              fold_reduce=lambda s: float(np.max(s) - np.min(s)),
              C_grid=[0.01, 1.0, 100.0])
    _same(_cv_port([K], y, **kw), cv_jax([K], y, **kw))


def test_cv_equals_jax_mutag_protocol():
    """docs/accuracy.md's protocol on MUTAG (WL h=5, normalized)."""
    from grakel_tpu import WeisfeilerLehman
    from grakel_tpu.datasets import read_data
    b = read_data("MUTAG", path=DATA)
    K = np.asarray(WeisfeilerLehman(n_iter=5, normalize=True)
                   .fit_transform(b.data), np.float64)
    y = np.asarray(b.target)
    kw = dict(n_iter=3, n_splits=10, random_state=0,
              C_grid=10.0 ** np.arange(-2, 5))
    _same(_cv_port([K], y, **kw), cv_jax([K], y, **kw))


def _chip_smoke():
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mutag_gram():
    from grakel_tpu import WeisfeilerLehman
    from grakel_tpu.datasets import read_data
    b = read_data("MUTAG", path=DATA)
    return (np.asarray(WeisfeilerLehman(n_iter=5, normalize=True)
                       .fit_transform(b.data), np.float64),
            np.asarray(b.target))


def _scores_or_error(cv, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return [float(s) for s in cv(*args, **kw)[0]]
        except Exception as e:
            return (type(e).__name__, str(e))


SMOKE = _chip_smoke()


@pytest.mark.parametrize("scoring", sorted(SMOKE.CV_MUTAG_SCORERS_JAX))
def test_chip_smoke_mutag_scorers_equal_jax(scoring, mutag_gram):
    """chip_smoke.py's pinned CV_MUTAG_SCORERS_JAX (the card's scores
    must equal it) is the JAX function's output; for the names that read
    decision values and for the two that raise on MUTAG's labels -1 and
    1, the port's CPU route gives it too."""
    K, y = mutag_gram
    kw = dict(SMOKE.CV_PROTOCOL, n_iter=1, scoring=scoring)
    want = SMOKE.CV_MUTAG_SCORERS_JAX[scoring]
    runs = [cv_jax]
    if scoring in ("roc_auc", "average_precision", "top_k_accuracy",
                   "neg_mean_squared_log_error",
                   "neg_root_mean_squared_log_error"):
        runs.append(_cv_port)
    for cv in runs:
        got = _scores_or_error(cv, [K], y, **kw)
        rtol = SMOKE.CV_MUTAG_SCORERS_RTOL.get(scoring)
        if rtol and isinstance(want, list):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
        else:
            assert got == want, (cv, got, want)


def test_chip_smoke_scorer_names_are_the_ports_new_ones():
    """The smoke's 30 names: every name the port supports but the first
    14 (accuracy, balanced_accuracy, precision, recall, f1 and their
    averages)."""
    first = {"accuracy", "balanced_accuracy"} | {
        "%s%s" % (m, a) for m in ("precision", "recall", "f1")
        for a in ("", "_micro", "_macro", "_weighted")}
    assert sorted(SMOKE.CV_MUTAG_SCORERS_JAX) == sorted(
        set(get_scorer_names()) - first)
    assert len(SMOKE.CV_MUTAG_SCORERS_JAX) == 30


def test_cv_errors_raise_value_error():
    K, y = _gram(20, 1, 2)
    for kw in (dict(fold_reduce=3), dict(scoring="neg_log_loss"),
               dict(scoring="no_such_scorer")):
        with pytest.raises(ValueError):
            _cv_port([K], y, n_iter=1, n_splits=2, **kw)
    with pytest.raises(ValueError, match="kernel matrix"):
        _cv_port([[np.zeros(3), "x"]], y, n_iter=1, n_splits=2)
    with pytest.raises(ValueError, match="kernel matrix"):
        cv_jax([[np.zeros(3), "x"]], y, n_iter=1, n_splits=2)
    y1 = np.zeros(20, int)
    y1[0] = 1            # a training set of one class in some fold
    with pytest.raises(ValueError, match="greater than one"):
        _cv_port([K], y1, n_iter=1, n_splits=2, random_state=0)
    with pytest.raises(ValueError, match="greater than one"):
        cv_jax([K], y1, n_iter=1, n_splits=2, random_state=0)


def test_cv_unsupported_scorer_names_the_supported_set():
    K, y = _gram(20, 1, 2)
    with pytest.raises(ValueError, match="balanced_accuracy"):
        _cv_port([K], y, n_iter=1, n_splits=2, scoring="neg_log_loss")


def test_cv_records_two_stages():
    K, y = _gram(30, 2, 3)
    _cv_port([K], y, n_iter=2, n_splits=3, random_state=1,
             C_grid=[0.1, 10.0])
    stages = grakel_torch.cross_validate_Kfold_SVM.last["stages"]
    assert [s["problems"] for s in stages] == [2 * 3 * 2 * 3, 2 * 3 * 3]
    assert all(s["iterations"] > 0 and s["route"] is None for s in stages)


def _outcome(cv, *args, **kw):
    """A call's scores, or the message of the ValueError it raised."""
    try:
        return "scores", cv(*args, **kw)
    except ValueError as e:
        return "error", str(e)


def _same_outcome(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] == "error":
        assert a[1] == b[1]
    else:
        _same(a[1], b[1])


def _probe():
    """The inputs of the port's non-finite probe: a linear Gram of 40
    points and the sign of their first feature."""
    X = np.random.RandomState(0).randn(40, 5)
    return X @ X.T, (X[:, 0] > 0).astype(int)


PROBE = dict(n_iter=1, n_splits=3, C_grid=[1.0], random_state=0)


@pytest.mark.parametrize("case", ["nan_row", "inf_diag", "neg_inf",
                                  "past_n", "n_iter_0"])
def test_cv_rejects_a_non_finite_gram_as_jax(case, monkeypatch):
    """The probe's cases, message for message: a NaN row and column, an
    infinity on the diagonal or off it; non-finite entries only past row
    ``len(y)`` score as the finite Gram does; ``n_iter=0`` returns
    ``[[]]``.  No solver starts when the call raises."""
    K, y = _probe()
    kw = dict(PROBE)
    if case == "nan_row":
        K[3, :] = np.nan
        K[:, 3] = np.nan
    elif case == "inf_diag":
        K[3, 3] = np.inf
    elif case == "neg_inf":
        K[5, 11] = -np.inf
    elif case == "past_n":
        big = np.zeros((45, 45))
        big[:40, :40] = K
        big[42, 42], big[41, :], big[:, 43] = np.nan, np.inf, np.nan
        K = big
    else:
        K[3, :] = np.nan
        kw["n_iter"] = 0
    want = _outcome(cv_jax, [K], y, **kw)
    if want[0] == "error":
        from grakel_torch.ops import csvc
        monkeypatch.setattr(csvc, "smo", lambda *a, **k: 1 / 0)
    got = _outcome(_cv_port, [K], y, **kw)
    _same_outcome(got, want)
    assert want[0] == ("scores" if case in ("past_n", "n_iter_0")
                       else "error")
    if case == "n_iter_0":
        assert got[1] == [[]]


@pytest.mark.parametrize("seed", range(6))
def test_cv_first_non_finite_fit_decides_the_message(seed):
    """NaN and infinity in different fits: the first fit of the
    reference's loop (its fit block, then its eval block) whose blocks
    hold one decides the message."""
    K, y = _probe()
    rng = np.random.RandomState(seed)
    a, b, c = rng.choice(40, 3, replace=False)
    K[a, a] = np.inf
    K[b, c] = np.nan
    kw = dict(PROBE, random_state=seed, n_iter=2)
    _same_outcome(_outcome(_cv_port, [K], y, **kw),
                  _outcome(cv_jax, [K], y, **kw))


def test_cv_non_finite_entries_of_variants_as_jax():
    """A NaN or an infinity in one variant: where only the refit of the
    fold whose inner split held it out reads it, the chosen variant
    decides, so the call scores or raises as the reference does; where an
    inner fit reads it, it raises the reference's message."""
    K, y = _probe()
    kw = dict(n_iter=1, n_splits=2, random_state=2, C_grid=[0.01, 1.0])
    rs = np.random.RandomState(kw["random_state"])
    (tr0, te0), _ = model_selection.KFold(2, shuffle=True,
                                          random_state=rs).split(y)
    sub_tr, sub_val = next(iter(model_selection.ShuffleSplit(
        n_splits=1, test_size=0.1, random_state=rs).split(tr0)))
    held, fitted = tr0[sub_val[0]], tr0[sub_tr[0]]
    seen = set()
    for a, b in ((te0[0], held), (fitted, held), (held, fitted),
                 (fitted, fitted)):
        for value in (np.nan, np.inf):
            Kb = K.copy()
            Kb[a, b] = value
            for grid in ([[K, Kb]], [[Kb, K]]):
                want = _outcome(cv_jax, grid, y, **kw)
                _same_outcome(_outcome(_cv_port, grid, y, **kw), want)
                seen.add(want[0] if want[0] == "scores" else want[1][:14])
    assert seen == {"scores", "Input X contai"}
