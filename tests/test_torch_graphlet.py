"""grakel_torch's GraphletSampling against grakel_tpu on JAX-CPU.

The same draw stream (numpy ``RandomState``), bin keys and count
bookkeeping give integer Grams, so fit_transform, transform and the
diagonals are equal bit for bit in every sampling mode: exhaustive
(``sampling=None``, the native ESU), a sample count, and the
sample-complexity bound; at k = 3..6 (canonical codes) and k = 9
(canonical-form bytes).  Past 2^24 the port's Gram is the exact integer
one, where the JAX package's f32 Gram rounds."""

import os

import numpy as np
import pytest
import torch

import grakel_torch
import grakel_tpu
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.kernels import graphlet_sampling as tgs
from grakel_tpu.datasets import read_data as jax_read_data
from jax_native_ref import jax_native  # noqa: F401 (fixture)

# the expected values come from grakel_tpu's native engine: load it
# first (see jax_native_ref)
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def mutag():
    return (read_data("MUTAG", path=DATA).data,
            jax_read_data("MUTAG", path=DATA).data)


@pytest.fixture(scope="module")
def small():
    return generate_dataset(n_graphs=36, n_graphs_test=8,
                            r_vertices=(6, 14), random_state=5,
                            features=("nl", 3))


def _both(params, fit, tr, jfit=None, jtr=None, normalize=False):
    """(K, T, X_diag, Y_diag) of the port on the CPU and of the JAX
    package, each from fit_transform, diagonal() and transform."""
    out = []
    for mod, f, t in ((grakel_torch, fit, tr),
                      (grakel_tpu, jfit or fit, jtr or tr)):
        k = mod.GraphletSampling(normalize=normalize, **params)
        with use_device("cpu"):
            K = k.fit_transform(f)
            d0 = k.diagonal()
            T = k.transform(t)
            xd, yd = k.diagonal()
        assert np.array_equal(d0, xd)
        out.append((K, T, xd, yd))
    return out


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [3, 4, 5, 6])
def test_exhaustive_matches_jax(mutag, k):
    data, jdata = mutag
    ours, ref = _both({"k": k}, data[:14], data[14:20], jdata[:14],
                      jdata[14:20])
    _equal(ours, ref)
    assert ours[0].dtype == np.float32


@pytest.mark.parametrize("k", [3, 4, 5, 6])
@pytest.mark.parametrize("normalize", [False, True])
def test_n_samples_matches_jax(small, k, normalize):
    train, test = small
    ours, ref = _both({"k": k, "sampling": {"n_samples": 60},
                       "random_state": 42}, train, test,
                      normalize=normalize)
    _equal(ours, ref)


@pytest.mark.parametrize("sampling", [
    {"delta": 0.1, "epsilon": 0.2}, {"delta": 0.1, "epsilon": 0.2, "a": 3}],
    ids=str)
def test_sample_complexity_bound_matches_jax(small, sampling):
    train, test = small
    ours, ref = _both({"k": 4, "sampling": sampling, "random_state": 7},
                      train[:12], test)
    _equal(ours, ref)


def test_k9_canonical_form_keys_match_jax():
    rng = np.random.RandomState(9)
    data = []
    for i in range(8):
        n = rng.randint(10, 14)
        A = (np.random.RandomState(800 + i).rand(n, n) < 0.35).astype(int)
        A = np.triu(A, 1)
        data.append([A + A.T, {v: 0 for v in range(n)}, {}])
    params = {"k": 9, "sampling": {"n_samples": 40}, "random_state": 0}
    ours, ref = _both(params, data[:6], data[6:])
    _equal(ours, ref)
    k = grakel_torch.GraphletSampling(**params)
    with use_device("cpu"):
        k.fit(data[:6])
    assert any(isinstance(key, tuple) and isinstance(key[1], bytes)
               for key in k._graph_bins.values())


def test_fit_then_transform_order_matches_jax(small):
    """fit -> transform -> diagonal (no fit_transform first)."""
    train, test = small
    out = []
    for mod in (grakel_torch, grakel_tpu):
        k = mod.GraphletSampling(k=5, sampling={"n_samples": 50},
                                 random_state=1, normalize=True)
        with use_device("cpu"):
            T = k.fit(train).transform(test)
            out.append((T,) + tuple(k.diagonal()))
    _equal(*out)


def test_graph_kernel_gr_matches_jax(small):
    train, test = small
    out = []
    for mod in (grakel_torch, grakel_tpu):
        gk = mod.GraphKernel(kernel={"name": "GR", "k": 4,
                                     "sampling": {"n_samples": 30}},
                             random_state=3, normalize=True)
        with use_device("cpu"):
            out.append((gk.fit_transform(train), gk.transform(test)))
    _equal(*out)
    from grakel_torch.graph_kernels import _registry
    assert all(_registry()[n] is grakel_torch.GraphletSampling
               for n in ("graphlet_sampling", "graphlet", "GR"))


def test_parameter_checks_match_jax():
    for bad, err in (({"k": 2}, TypeError), ({"k": 4.0}, TypeError),
                     ({"sampling": 3}, TypeError),
                     ({"sampling": {"x": 1}}, ValueError),
                     ({"sampling": {"a": 0}}, TypeError)):
        for mod in (grakel_torch, grakel_tpu):
            with pytest.raises(err):
                with use_device("cpu"):
                    mod.GraphletSampling(**bad).fit([[np.ones((3, 3))]])
    with pytest.raises(grakel_torch.estimator.NotFittedError):
        with use_device("cpu"):
            grakel_torch.GraphletSampling().transform([[np.ones((3, 3))]])


def _clique(n):
    return [np.ones((n, n)) - np.eye(n), {v: 0 for v in range(n)}, {}]


@pytest.mark.parametrize("forced_f32", [False, True])
def test_gs_counts_exact_past_2_24(monkeypatch, forced_f32):
    """Exhaustive k = 3 on a 31-clique puts its C(31, 3) = 4495 triangles
    in one bin: the Gram entry is 4495^2 = 20205025, past 2^24 and odd,
    so an f32 Gram rounds it.  The port sums in f64 there
    (``ops.gram.count_dtype``) and returns the exact integer in fit_transform,
    transform (4496 there: a matching sample first ensures 1) and the
    diagonals; forcing f32 must break it (the JAX package stays f32)."""
    if forced_f32:
        monkeypatch.setattr(tgs, "count_dtype", lambda bound: torch.float32)
    fit, tr = [_clique(31), _clique(6)], [_clique(31)]
    k = grakel_torch.GraphletSampling(k=3)
    with use_device("cpu"):
        K = k.fit_transform(fit)
        T = k.transform(tr)
        xd, yd = k.diagonal()
    # bin counts: 4495 (the first sample creates the bin with 1), 21 for
    # the 6-clique's 20 triangles and 4496 for the transform graph (a
    # first match of an existing bin counts 2)
    c = np.array([4495, 21])
    exact_K = np.outer(c, c)
    exact_T = 4496 * c[None, :]
    got = (K, T, xd, yd)
    want = (exact_K, exact_T, np.diagonal(exact_K), np.array([4496 ** 2]))
    same = all(np.array_equal(np.asarray(g, np.float64), w)
               for g, w in zip(got, want))
    assert same != forced_f32
    if not forced_f32:
        assert K.dtype == np.float64 and T.dtype == np.float64
    kj = grakel_tpu.GraphletSampling(k=3)
    Kj = kj.fit_transform(fit)
    assert Kj[0, 0] != exact_K[0, 0]          # the JAX package rounds here
    assert np.array_equal(Kj[1:, 1:], exact_K[1:, 1:])
