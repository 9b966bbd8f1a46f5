"""grakel_torch's NeighborhoodSubgraphPairwiseDistance against grakel_tpu
on JAX-CPU: the native neighborhood hashing (the JAX package's engine)
and the plain Python hashing give the same Grams; the fit Gram (one
multiplicity-split product over all levels, f64) and the transform (one
f64 product over the fit columns the new graphs hold) equal the JAX
package's per-level Grams to rtol 1e-6."""

import os

import numpy as np
import pytest

import grakel_tpu
from grakel_torch import GraphKernel, use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.estimator import NotFittedError
from grakel_torch.kernels import nspd as nspd_mod
from grakel_torch.kernels.nspd import (NeighborhoodSubgraphPairwiseDistance
                                       as NSPD, ap_hash)
from grakel_torch.native import _ap_hash_py
from grakel_torch.ops import gram as gram_ops
from jax_native_ref import jax_native  # noqa: F401 (fixture)

# the expected values come from grakel_tpu's native engine: load it
# first (see jax_native_ref)
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def data():
    return generate_dataset(n_graphs=40, n_graphs_test=10,
                            r_vertices=(5, 16), random_state=8,
                            features=("nl", 4))


@pytest.fixture(scope="module")
def mutag():
    return read_data("MUTAG", path=DATA).data


def _planted(graphs, label=99):
    """Each graph with its first vertex relabeled ``label`` (keys unseen
    at fit)."""
    out = []
    for e, nl, el in graphs:
        nl = dict(nl)
        nl[next(iter(nl))] = label
        out.append([e, nl, el])
    return out


def _run(k, fit, tr):
    K = k.fit_transform(fit)
    d = k.diagonal()
    T = k.transform(tr)
    return K, d, T, k.diagonal()


@pytest.mark.parametrize("params", [
    {}, {"normalize": True}, {"r": 0}, {"d": 0}, {"r": 0, "d": 0},
    {"r": 2, "d": 3, "normalize": True}], ids=str)
def test_nspd_matches_jax(data, params):
    train, test = data
    test = test[:5] + _planted(test[5:])
    rj = _run(grakel_tpu.NeighborhoodSubgraphPairwiseDistance(**params),
              train, test)
    with use_device("cpu"):
        rt = _run(NSPD(**params), train, test)
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(rt[2], rj[2], rtol=1e-6, atol=1e-12)
    assert rt[1] == rj[1] and rt[3] == rj[3]


def test_nspd_mutag_edge_labels_match_jax(mutag):
    rj = _run(grakel_tpu.NeighborhoodSubgraphPairwiseDistance(), mutag[:30],
              mutag[30:40])
    with use_device("cpu"):
        rt = _run(NSPD(), mutag[:30], mutag[30:40])
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(rt[2], rj[2], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("params", [{}, {"r": 1, "d": 2}], ids=str)
def test_nspd_python_hashing_equals_native(mutag, params, monkeypatch):
    fit, tr = mutag[:20], _planted(mutag[20:28])
    with use_device("cpu"):
        kn = NSPD(**params)
        Kn, Tn = kn.fit_transform(fit), kn.transform(tr)
        kp = NSPD(**params)
        monkeypatch.setattr(kp, "_graph_hash_pairs", kp._graph_hash_pairs_py)
        Kp, Tp = kp.fit_transform(fit), kp.transform(tr)
    # different hash values, the same partition
    assert any(not np.array_equal(kn._fit_keys[key], kp._fit_keys[key])
               for key in kn._fit_keys)
    np.testing.assert_allclose(Kp, Kn, rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(Tp, Tn, rtol=1e-13, atol=1e-14)


def test_nspd_transform_is_one_product_over_touched_columns(data,
                                                            monkeypatch):
    train, test = data
    calls = []
    real = gram_ops.coo_counts_gram_rect

    def spy(*a, **k):
        calls.append((a[-1], k))
        return real(*a, **k)

    monkeypatch.setattr(gram_ops, "coo_counts_gram_rect", spy)
    with use_device("cpu"):
        k = NSPD()
        k.fit_transform(train)
        k.transform(_planted(test))
    assert len(calls) == 1
    width = sum(m[3] for m in k.X.values())
    touched = sum(len(np.unique(m[1][m[1] < k.X[key][3]]))
                  for key, m in k._Y.items() if key in k.X)
    assert calls[0][0] == touched < width
    assert calls[0][1]["dtype"] == nspd_mod.torch.float64


def test_ap_hash_matches_native_plain_version():
    for s in ("", "a", "0,1|1,2.:", "héllo"):
        assert ap_hash(s) == _ap_hash_py(s.encode("utf-8"))


def test_nspd_state_carry_from_jax(data):
    train, test = data
    kj = grakel_tpu.NeighborhoodSubgraphPairwiseDistance(normalize=True)
    kj.fit_transform(train)
    Tj = kj.transform(_planted(test))
    state = {"levels": kj.X, "fit_keys": kj._fit_keys,
             "norms": kj._X_level_norm_factor, "n": kj._ngx}
    with use_device("cpu"):
        k = kernel_from_state("NeighborhoodSubgraphPairwiseDistance",
                              {"normalize": True}, state)
        T = k.transform(_planted(test))
    np.testing.assert_allclose(T, Tj, rtol=1e-6, atol=1e-12)


def test_nspd_errors_and_graph_kernel(data):
    train, test = data
    with use_device("cpu"):
        with pytest.raises(NotFittedError):
            NSPD().transform(test)
        with pytest.raises(TypeError):
            NSPD(r=-1).fit(train)
        for name in ("NSPD", "NSPDK",
                     "neighborhood_subgraph_pairwise_distance"):
            gk = GraphKernel(kernel={"name": name, "r": 1, "d": 1})
            K = gk.fit_transform(train[:8])
            assert isinstance(gk.kernel_, NSPD) and K.shape == (8, 8)


@pytest.mark.parametrize("mult", [0, 3])
def test_nspd_dense_block_matches_jax(data, mult, monkeypatch):
    """Columns of more than ``_DENSE_COL_MULT`` graphs go through the
    f64 dense block on the kernel's device (at 40 graphs none passes the
    default 64, so the split point is lowered here)."""
    train, test = data
    rj = _run(grakel_tpu.NeighborhoodSubgraphPairwiseDistance(), train,
              test)
    monkeypatch.setattr(NSPD, "_DENSE_COL_MULT", mult)
    with use_device("cpu"):
        rt = _run(NSPD(), train, test)
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(rt[2], rj[2], rtol=1e-6, atol=1e-12)
