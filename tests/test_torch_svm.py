"""grakel_torch.svm.SVC (K15 / K16's plain versions on the CPU) against
scikit-learn's ``SVC(kernel="precomputed")`` at its defaults: the same
libsvm path, so the same support vectors, iteration counts and
predictions, and the coefficients and decision values to the last bits.
"""

import numpy as np
import pytest
import torch
from sklearn.svm import SVC as SkSVC

from grakel_torch import use_device
from grakel_torch.estimator import NotFittedError
from grakel_torch.ops import csvc
from grakel_torch.svm import SVC

CS = [1e-7, 1e-3, 0.1, 1.0, 100.0, 1e5]


def _gram(n, seed, k, dup=0, single=False):
    """A seeded PSD Gram (an RBF kernel on random points, ``dup`` of them
    repeated: tied rows) and ``k``-class labels; ``single``: the last
    class has one sample."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    y[:k] = np.arange(k)
    if single:
        y[k:] = rng.randint(0, k - 1, n - k)
    phi = rng.randn(n, 4) + 0.8 * y[:, None]
    if dup:
        src = rng.randint(0, n - dup, dup)
        phi[n - dup:], y[n - dup:] = phi[src], y[src]
    sq = (phi ** 2).sum(1)
    return np.exp(-0.25 * (sq[:, None] + sq[None, :] - 2 * phi @ phi.T)), y


def _both(K, y, n_fit, **kw):
    with use_device("cpu"):
        ours = SVC(**kw).fit(K[:n_fit, :n_fit], y[:n_fit])
    ref = SkSVC(kernel="precomputed", **kw).fit(K[:n_fit, :n_fit], y[:n_fit])
    return ours, ref


def _assert_same(ours, ref, Kt):
    for attr in ("classes_", "support_", "n_support_", "n_iter_"):
        np.testing.assert_array_equal(getattr(ours, attr),
                                      getattr(ref, attr), err_msg=attr)
    for attr in ("dual_coef_", "intercept_"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr),
                                   rtol=1e-12, atol=0, err_msg=attr)
    np.testing.assert_array_equal(ours.predict(Kt), ref.predict(Kt))
    np.testing.assert_allclose(ours.decision_function(Kt),
                               ref.decision_function(Kt), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("k", [2, 3, 5])
def test_svc_matches_sklearn(k, C):
    K, y = _gram(48, 10 * k, k, dup=4)
    ours, ref = _both(K, y, 36, C=C)
    _assert_same(ours, ref, K[36:, :36])


@pytest.mark.parametrize("k", [2, 4])
def test_svc_class_of_one_sample(k):
    K, y = _gram(40, 3, k, single=True)
    ours, ref = _both(K, y, 40, C=10.0)
    _assert_same(ours, ref, K[:12])


@pytest.mark.parametrize("C", [0.01, 1.0, 100.0])
def test_svc_matches_sklearn_on_a_graph_kernel(C):
    """A normalized WL Gram of MUTAG graphs: entries shared by many
    pairs, so libsvm's tie rules decide the path."""
    import os
    from grakel_torch import WeisfeilerLehman
    from grakel_torch.datasets import read_data
    b = read_data("MUTAG", path=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "data"))
    with use_device("cpu"):
        K = WeisfeilerLehman(n_iter=3, normalize=True).fit_transform(
            b.data[:90])
    y = np.asarray(b.target)[:90]
    ours, ref = _both(np.asarray(K, np.float64), y, 70, C=C)
    _assert_same(ours, ref, np.asarray(K, np.float64)[70:, :70])


def test_svc_long_run_with_shrinking_and_string_labels():
    """Duplicated rows at a large C: thousands of iterations, several
    shrinking rounds and the unshrink; string labels."""
    K, y = _gram(70, 5, 2, dup=10)
    labels = np.array(["neg", "pos"])[y]
    ours, ref = _both(K, labels, 70, C=1e4)
    assert ref.n_iter_[0] > 2 * 70
    _assert_same(ours, ref, K[:20])


def test_svc_errors():
    K, y = _gram(20, 1, 2)
    with use_device("cpu"):
        with pytest.raises(ValueError, match="greater than one"):
            SVC().fit(K, np.zeros(20, int))
        with pytest.raises(ValueError, match="precomputed"):
            SVC(kernel="rbf").fit(K, y)
        with pytest.raises(ValueError, match="square"):
            SVC().fit(K[:, :10], y)
        with pytest.raises(ValueError):
            SVC(C=0.0).fit(K, y)
        with pytest.raises(NotFittedError):
            SVC().predict(K)
        clf = SVC().fit(K, y)
        with pytest.raises(ValueError, match="number of samples at training"):
            clf.predict(K[:, :5])


def test_svc_runs_on_the_ambient_device_and_never_falls_back():
    K, y = _gram(20, 2, 2)
    with use_device("cpu"):
        clf = SVC().fit(K, y)
    assert clf.device_.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="use_device"):
            SVC().fit(K, y)


@pytest.mark.parametrize("smem_rows", [0, 20, 35, 10 ** 4])
def test_k15_routes_split_problems_by_threshold(smem_rows):
    lens = np.array([35, 7, 20, 21, 1, 2, 35, 0])
    on_global, soff, nbytes, smem = csvc.k15_routes(lens, smem_rows)
    np.testing.assert_array_equal(on_global, lens > smem_rows)
    assert (soff[~on_global] == -1).all()
    g = np.nonzero(on_global)[0]
    # each global problem's rows lie in its own 8-byte aligned slot
    assert (soff[g] % 8 == 0).all()
    ends = soff[g] + lens[g] * csvc.ROW_BYTES
    assert (ends[:-1] <= soff[g][1:]).all() if g.size > 1 else True
    assert nbytes >= (ends.max() if g.size else 0)
    assert smem == (lens[~on_global].max() if (~on_global).any() else 0)


def test_k15_plain_is_one_solver_whatever_the_batch():
    """A problem solved in a batch of others (lockstep, padding, other
    sizes and Cs) gives what it gives alone, and what libsvm gives."""
    K, y = _gram(60, 9, 3, dup=5)
    fits = [(0, np.arange(40), y[:40], 1.0), (0, np.arange(10, 60),
                                               y[10:60], 1e3),
            (0, np.arange(0, 60, 2), y[0:60:2], 0.01)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    Kt = t(K)
    args = lambda plan: (Kt.float(), torch.diagonal(Kt).contiguous(),
                         t(plan.ids), t(plan.sign), t(plan.off), t(plan.C),
                         t(plan.gram))
    plan = csvc.plan_fits(fits)
    coef, rho, iters = csvc.smo_plain(*args(plan))
    for f, fit in enumerate(fits):
        one = csvc.plan_fits([fit])
        c1, r1, i1 = csvc.smo_plain(*args(one))
        q0, q1 = plan.fits[f]["pair0"], plan.fits[f]["pair0"] + 3
        assert torch.equal(coef[plan.off[q0]:plan.off[q1]], c1)
        assert torch.equal(rho[q0:q1], r1) and torch.equal(iters[q0:q1], i1)
        ref = SkSVC(kernel="precomputed", C=fit[3]).fit(
            K[np.ix_(fit[1], fit[1])], fit[2])
        np.testing.assert_array_equal(i1.numpy(), ref.n_iter_)
