"""grakel_torch's OddSth against grakel_tpu on JAX-CPU: the native
decomposition and the Python one give the same big-DAG partition, and
the Gram is the exact integer ``F diag(C) F^T`` (the JAX package streams
``F sqrt(C)`` in f32, so it is held to rtol 1e-5), f64 past 2^24."""

import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import GraphKernel, use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset
from grakel_torch.estimator import NotFittedError
from grakel_torch.kernels.odd_sth import OddSth
from grakel_torch.ops.gram import (shared_cols_gram_rect, sparse_counts_gram,
                                   split_weighted_singletons)
from jax_native_ref import jax_native  # noqa: F401 (fixture)

# the expected values come from grakel_tpu's native engine: load it
# first (see jax_native_ref)
pytestmark = pytest.mark.usefixtures("jax_native")


@pytest.fixture(scope="module")
def data():
    return generate_dataset(n_graphs=40, n_graphs_test=10,
                            r_vertices=(5, 20), random_state=5,
                            features=("nl", 4))


def _dense_F(state, lo, hi, D):
    F = np.zeros((hi - lo, D), np.int64)
    sel = (state["graph"] >= lo) & (state["graph"] < hi)
    np.add.at(F, (state["graph"][sel] - lo, state["node"][sel]),
              state["freq"][sel])
    return F


def _exact(k, test):
    """The exact int64 fit and transform Grams ``F diag(C) F^T`` from the
    port kernel's native table."""
    nx = k._nx
    full = k._merge_native(k.X, k._decompose_native(
        grakel_torch.kernels.base.normalize_input(test)))
    C = full["C"].astype(np.int64)
    D = len(C)
    Fx = _dense_F(full, 0, nx, D)
    Fy = _dense_F(full, nx, nx + len(test), D)
    return (Fx * C) @ Fx.T, (Fy * C) @ Fx.T, Fx, Fy, C


@pytest.mark.parametrize("params", [{}, {"h": 2}, {"normalize": True},
                                    {"h": 1, "normalize": True}], ids=str)
def test_oddsth_matches_jax_and_exact_gram(data, params):
    train, test = data
    kj = grakel_tpu.OddSth(**params)
    Kj = kj.fit_transform(train)
    Tj = kj.transform(test)
    with use_device("cpu"):
        k = OddSth(**params)
        K = k.fit_transform(train)
        d = k.diagonal()
        T = k.transform(test)
        xd, yd = k.diagonal()
    np.testing.assert_allclose(K, Kj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(T, Tj, rtol=1e-5, atol=0)
    jxd, jyd = kj.diagonal()
    np.testing.assert_allclose(xd, jxd, rtol=1e-5, atol=0)
    np.testing.assert_allclose(yd, jyd, rtol=1e-5, atol=0)
    Ke, Te, Fx, Fy, C = _exact(k, test)
    dx, dy = np.diag(Ke), ((Fy * C) * Fy).sum(1)
    assert np.array_equal(d, dx) and np.array_equal(xd, dx)
    assert np.array_equal(yd, dy)
    if params.get("normalize"):
        np.testing.assert_allclose(K, Ke / np.sqrt(np.outer(dx, dx)),
                                   rtol=1e-14)
        np.testing.assert_allclose(T, Te / np.sqrt(np.outer(dy, dx)),
                                   rtol=1e-14)
    else:
        assert np.array_equal(K, Ke) and np.array_equal(T, Te)


def test_oddsth_python_decomposition_equals_native(data, monkeypatch):
    train, test = data
    with use_device("cpu"):
        kn = OddSth(h=3)
        Kn, Tn = kn.fit_transform(train), kn.transform(test)
        kp = OddSth(h=3)
        monkeypatch.setattr(kp, "_decompose_native", lambda graphs: None)
        Kp, Tp = kp.fit_transform(train), kp.transform(test)
    assert isinstance(kn.X, dict) and isinstance(kp.X, tuple)
    assert np.array_equal(Kn, Kp) and np.array_equal(Tn, Tp)


def _listed(graphs):
    """The same graphs with each label wrapped in a list (unhashable, so
    not sortable as a set: the Python decomposition's case)."""
    return [[e, {v: [l] for v, l in nl.items()}, el] for e, nl, el in graphs]


def test_oddsth_unsortable_labels_take_python_route(data):
    train, test = data
    ltrain, ltest = _listed(train), _listed(test)
    kj = grakel_tpu.OddSth()
    Kj, Tj = kj.fit_transform(ltrain), kj.transform(ltest)
    with use_device("cpu"):
        k = OddSth()
        K, T = k.fit_transform(ltrain), k.transform(ltest)
        ki = OddSth()
        Ki, Ti = ki.fit_transform(train), ki.transform(test)
    assert isinstance(k.X, tuple)
    np.testing.assert_allclose(K, Kj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(T, Tj, rtol=1e-5, atol=0)
    # [l] orders as l does and its ID string is injective: same Grams
    assert np.array_equal(K, Ki) and np.array_equal(T, Ti)


def test_oddsth_native_fit_unsortable_transform_raises(data):
    train, test = data
    with use_device("cpu"):
        k = OddSth()
        k.fit(train)
        with pytest.raises(RuntimeError, match="native decomposition"):
            k.transform(_listed(test))
        with pytest.raises(NotFittedError):
            OddSth().transform(test)


def _edgeless(n, label=0):
    return [np.zeros((n, n)), {v: label for v in range(n)}]


def test_oddsth_counts_exact_past_2_24():
    """Edgeless graphs of n vertices: one subtree of frequency n, its C
    the first graph's n, so K[i, j] = n_0 n_i n_j, past 2^24 and odd
    (f32 would round it); the port sums in f64 there."""
    ns = [261, 263, 259, 5]
    fit = [_edgeless(n) for n in ns]
    exact = np.array([[ns[0] * a * b for b in ns] for a in ns], np.int64)
    assert exact.max() > 1 << 24 and (exact % 2 == 1).any()
    with use_device("cpu"):
        k = OddSth()
        K = k.fit_transform(fit)
        T = k.transform([_edgeless(267), _edgeless(3, 1)])
        yd = k.diagonal()[1]
    assert np.array_equal(K, exact)
    assert np.array_equal(T, np.array([[ns[0] * 267 * b for b in ns],
                                       [0] * 4]))
    # a transform subtree is weighted by ITS first graph's frequency
    assert np.array_equal(yd, [ns[0] * 267 ** 2, 3 ** 3])


@pytest.mark.parametrize("case", ["int", "f64", "disjoint"])
def test_shared_cols_gram_rect_matches_dense(case):
    """The rectangular Gram restricted to the columns both sides hold
    equals the dense product over every column."""
    rng = np.random.RandomState(len(case))
    ny, nx, L = 7, 11, 300
    gy, gx = rng.randint(0, ny, 40), rng.randint(0, nx, 500)
    cy = rng.randint(0, L, 40) * 1009 + (1 << 40)   # sparse, wide keys
    cx = rng.randint(0, L, 500) * 1009 + (1 << 40)
    if case == "disjoint":
        cx = cx + 1
    wy, wx = rng.randint(1, 5, 40), rng.randint(1, 5, 500)
    if case == "f64":
        wy, wx = wy * np.pi, wx / 3.0
    keys = np.unique(np.r_[cy, cx])
    Y, X = np.zeros((ny, len(keys))), np.zeros((nx, len(keys)))
    np.add.at(Y, (gy, np.searchsorted(keys, cy)), wy)
    np.add.at(X, (gx, np.searchsorted(keys, cx)), wx)
    dt = torch.float64 if case == "f64" else torch.float32
    K = shared_cols_gram_rect(gy, cy, wy.astype(np.float64), gx, cx,
                              wx.astype(np.float64), ny, nx,
                              torch.device("cpu"), chunk=128, dtype=dt)
    assert K.dtype == dt and K.shape == (ny, nx)
    if case == "f64":
        np.testing.assert_allclose(K.numpy(), Y @ X.T, rtol=1e-13)
    else:
        assert np.array_equal(K.numpy(), Y @ X.T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_weighted_singletons_matches_dense(seed):
    rng = np.random.RandomState(seed)
    n, L, m = 9, 40, 120
    g = rng.randint(0, n, m)
    c = rng.randint(0, L, m)
    w = rng.randint(1, 6, m)
    s = rng.randint(1, 5, L)
    F = np.zeros((n, L), np.int64)
    np.add.at(F, (g, c), w)
    for cw in (None, s):
        sc = np.ones(L, np.int64) if cw is None else cw
        gs, ks, ws, shared, diag = split_weighted_singletons(g, c, w, n, cw)
        assert diag.dtype == np.int64 and np.array_equal(
            shared, np.flatnonzero((F > 0).sum(0) > 1))
        assert np.array_equal(ks, np.searchsorted(shared, shared[ks]))
        Fs = np.zeros((n, len(shared)), np.int64)
        np.add.at(Fs, (gs, ks), ws)
        assert np.array_equal((Fs * sc[shared]) @ Fs.T + np.diag(diag),
                              (F * sc) @ F.T)
        # float weights: a float diagonal
        gf, kf, wf, sf, df = split_weighted_singletons(
            g, c, w * 0.5, n, cw)
        np.testing.assert_allclose(df, diag * 0.25, rtol=1e-15)


def test_oddsth_state_carry_from_jax(data):
    train, test = data
    kj = grakel_tpu.OddSth(h=3).fit(train)
    Tj = kj.transform(test)
    state = dict({key: kj.X[key] for key in
                  ("ha", "hb", "C", "node", "graph", "freq", "ncols")},
                 h=3)
    with use_device("cpu"):
        k = kernel_from_state("OddSth", {}, state)
        T = k.transform(test)
    np.testing.assert_allclose(T, Tj, rtol=1e-5, atol=0)


def test_graph_kernel_builds_oddsth(data):
    train, _ = data
    for name in ("ODD", "odd_sth", "ODD-STh"):
        gk = GraphKernel(kernel={"name": name, "h": 2})
        with use_device("cpu"):
            K = gk.fit_transform(train[:10])
        assert isinstance(gk.kernel_, OddSth) and K.shape == (10, 10)


@pytest.mark.parametrize("mult", [1, 4, 64])
def test_sparse_counts_gram_dense_block_on_device(mult):
    """``sparse_counts_gram`` with its dense block on a torch device
    equals the dense ``F F^T``."""
    rng = np.random.RandomState(mult)
    n, L, m = 30, 50, 600
    g = rng.randint(0, n, m)
    c = np.where(rng.rand(m) < 0.4, rng.randint(0, 3, m),
                 rng.randint(3, L, m))
    w = rng.randint(1, 4, m)
    F = np.zeros((n, L), np.int64)
    np.add.at(F, (g, c), w)
    for dt in (torch.float32, torch.float64):
        for dev in (None, torch.device("cpu")):
            K = sparse_counts_gram(g, c, n, weights=w.astype(np.float64),
                                   dense_col_mult=mult, dtype=dt,
                                   device=dev)
            assert np.array_equal(K, F @ F.T)
