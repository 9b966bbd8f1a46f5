"""grakel_torch's WL optimal assignment kernel against grakel_tpu on
JAX-CPU: integer Grams exactly equal on fit_transform and on transform
with labels unseen at fit, normalized Grams and diagonals too, through
the kernel, ``GraphKernel("WL-OA")`` and ``kernel_from_state``."""

import os

import numpy as np
import pytest

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.kernels.base import normalize_input
from grakel_tpu.datasets import read_data as jax_read_data

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def data():
    # the test split plants a label unseen at fit
    return generate_dataset(n_graphs=40, n_graphs_test=8, r_vertices=(2, 14),
                            random_state=17, features=("nl", 5))


def _pair(params, train, test, via="kernel"):
    kj = grakel_tpu.WeisfeilerLehmanOptimalAssignment(**params)
    jout = (kj.fit_transform(train), kj.transform(test), kj.diagonal())
    with use_device("cpu"):
        if via == "kernel":
            kt = grakel_torch.WeisfeilerLehmanOptimalAssignment(**params)
        else:
            kt = grakel_torch.GraphKernel(kernel=dict(params, name="WL-OA"))
        tout = (kt.fit_transform(train), kt.transform(test), kt.diagonal())
    return jout, tout


@pytest.mark.parametrize("n_iter", [1, 3, 5])
@pytest.mark.parametrize("normalize", [False, True])
def test_wloa_matches_grakel_tpu(data, n_iter, normalize):
    train, test = data
    (Kj, Tj, (xj, yj)), (Kt, Tt, (xt, yt)) = _pair(
        {"n_iter": n_iter, "normalize": normalize}, train, test)
    assert Kt.shape == (32, 32) and Tt.shape == (8, 32)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)
    if not normalize:
        assert np.array_equal(np.diagonal(Kt), xt)


def test_wloa_graph_kernel_on_mutag():
    t = read_data("MUTAG", path=DATA).data
    j = jax_read_data("MUTAG", path=DATA).data
    kj = grakel_tpu.WeisfeilerLehmanOptimalAssignment(n_iter=3)
    Kj, Tj = kj.fit_transform(j[:60]), kj.transform(j[60:80])
    with use_device("cpu"):
        gk = grakel_torch.GraphKernel(kernel={"name": "WL-OA", "n_iter": 3})
        Kt, Tt = gk.fit_transform(t[:60]), gk.transform(t[60:80])
        assert isinstance(gk.kernel_,
                          grakel_torch.WeisfeilerLehmanOptimalAssignment)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)


def test_wloa_fit_then_diagonal_transform_and_checks(data):
    train, test = data
    kj = grakel_tpu.WeisfeilerLehmanOptimalAssignment(n_iter=2).fit(train)
    with use_device("cpu"):
        kt = grakel_torch.WeisfeilerLehmanOptimalAssignment(n_iter=2)
        with pytest.raises(grakel_torch.estimator.NotFittedError):
            kt.transform(test)
        with pytest.raises(grakel_torch.estimator.NotFittedError):
            kt.diagonal()
        kt.fit(train)
        assert np.array_equal(kt.diagonal(), kj.diagonal())
        assert np.array_equal(kt.transform(test), kj.transform(test))
        with pytest.raises(TypeError):
            grakel_torch.WeisfeilerLehmanOptimalAssignment(n_iter=0).fit(
                train)


def test_wloa_singleton_columns_fold_into_the_diagonal(data):
    """The fit Gram runs its GEMM over the columns two or more graphs
    reach and adds the others on the diagonal: equal to the counts-GEMM
    over every column."""
    import torch
    from grakel_torch.ops.gram import coo_counts_gram
    train, _ = data
    with use_device("cpu"):
        kt = grakel_torch.WeisfeilerLehmanOptimalAssignment(n_iter=4)
        K = kt.fit_transform(train)
        X = kt.X
        full = coo_counts_gram(torch.from_numpy(X["gids"]), X["eids"],
                               np.ones(len(X["gids"]), np.float32),
                               np.ones(len(X["gids"]), bool), X["n"],
                               X["width"]).numpy()
    cnt = np.bincount(X["eids"])
    assert (cnt == 1).sum() > 0 and (cnt > 1).sum() > 0
    assert np.array_equal(K, full)


def test_wloa_state_carry(data):
    """kernel_from_state("WeisfeilerLehmanOptimalAssignment") refits from
    the fit graphs: transform equals the JAX kernel's."""
    train, test = data
    kj = grakel_tpu.WeisfeilerLehmanOptimalAssignment(n_iter=3).fit(train)
    Tj = kj.transform(test)
    graphs = [(g.n, g.senders, g.receivers, g.weights, dict(g.node_labels))
              for g in normalize_input(train)]
    with use_device("cpu"):
        kt = kernel_from_state("WeisfeilerLehmanOptimalAssignment",
                               {"n_iter": 3}, {"graphs": graphs})
        Tt = kt.transform(test)
    assert np.array_equal(Tt, Tj)
