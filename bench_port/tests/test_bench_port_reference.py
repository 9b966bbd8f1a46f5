"""The plain references: hand-worked Grams on tiny graphs, and the port
held to them on the CPU at a small size."""

import numpy as np
import pytest

from bench_port import svm_ref
from bench_port.graphs import make_dataset
from bench_port.manifest import Manifest
from bench_port.run import cv_inputs

MAN = Manifest()
WL = MAN.reference("wl_nci1")
SP = MAN.reference("sp_nci1")


def _g(edges, labels):
    e = set()
    for u, v in edges:
        e.add((u, v))
        e.add((v, u))
    return [e, dict(enumerate(labels)), {}]


def test_wl_reference_by_hand():
    # generation 0: {a, b} and {a, a}; generation 1: (a,(b)) (b,(a)) and
    # (a,(a)) twice
    gs = [_g([(0, 1)], "ab"), _g([(0, 1)], "aa")]
    K = WL.gram(gs, {"n_iter": 1})
    assert np.array_equal(K, [[2 + 2, 2 + 0], [2 + 0, 4 + 4]])
    N = WL.gram(gs, {"n_iter": 1, "normalize": True})
    assert np.allclose(N, [[1, 2 / np.sqrt(32)], [2 / np.sqrt(32), 1]],
                       rtol=0, atol=1e-15)


def test_sp_reference_by_hand():
    # path a-b-a: (a,b,1) x2, (b,a,1) x2, (a,a,2) x2; edge a-b: (a,b,1),
    # (b,a,1); two lone vertices: no pair has a path
    gs = [_g([(0, 1), (1, 2)], "aba"), _g([(0, 1)], "ab"),
          [set(), {0: "a", 1: "a"}, {}]]
    K = SP.gram(gs, {})
    assert np.array_equal(K, [[12, 4, 0], [4, 2, 0], [0, 0, 0]])
    N = SP.gram(gs, {"normalize": True})
    assert N[2, 2] == 0 and N[0, 0] == 1
    assert N[0, 1] == 4 / np.sqrt(24)


def test_controls_break_the_comparison_on_a_small_set():
    fit, _ = make_dataset(dict(MAN.config("wl_nci1")["data"], graphs=80,
                               held_out=2), 4)
    p = MAN.config("wl_nci1")["kernel"]["params"]
    assert np.abs(WL.control(fit, p) - WL.gram(fit, p)).max() > \
        MAN.config("wl_nci1")["limits"]["gram_err"]
    assert np.abs(SP.control(fit, {}) - SP.gram(fit, {})).max() > 0


@pytest.fixture(scope="module")
def small():
    cfg = MAN.config("wl_nci1")
    data = dict(cfg["data"], graphs=150, held_out=2)
    fit, _ = make_dataset(data, 2 ** 33 + 1)
    return dict(cfg, data=data), fit


def test_port_equals_the_references_on_the_cpu(small):
    import grakel_torch as gt
    cfg, fit = small
    with gt.use_device("cpu"):
        Kw = gt.WeisfeilerLehman(n_iter=5, normalize=True).fit_transform(fit)
        Ks = gt.ShortestPath().fit_transform(fit)
    assert np.array_equal(Kw, WL.gram(fit, cfg["kernel"]["params"]))
    assert np.array_equal(Ks, SP.gram(fit, {}))


def test_port_cv_equals_the_reference_on_the_cpu(small):
    import grakel_torch as gt
    cfg, fit = small
    K = WL.gram(fit, cfg["kernel"]["params"])
    y, rs = cv_inputs(cfg, fit, 2 ** 33 + 1)
    want = svm_ref.cross_validate(K, y, 2, 4, rs)
    with gt.use_device("cpu"):
        got = gt.cross_validate_Kfold_SVM([K], y, n_iter=2, n_splits=4,
                                          random_state=rs, fold_reduce=list)
    assert np.array_equal(np.asarray(got[0]), np.asarray(want))


def test_folds_draw_as_scikit_learn_does():
    plan = svm_ref.folds(23, 2, 5, 7)
    rng = np.random.RandomState(7)
    order = np.arange(23)
    rng.shuffle(order)
    assert set(plan[0][0][1]) == set(order[:5])
    for per in plan:
        tests = np.concatenate([p[1] for p in per])
        assert sorted(tests) == list(range(23))
        for train, test, tr_in, val in per:
            assert sorted(np.concatenate([tr_in, val])) == sorted(train)
            assert val.shape[0] == int(np.ceil(0.1 * train.shape[0]))
