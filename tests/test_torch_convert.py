"""Fitted state of grakel_tpu kernels carried into grakel_torch with
``convert.kernel_from_state``: port ``transform`` Grams equal the JAX
kernel's on the same new graphs."""

import numpy as np
import pytest

import grakel_tpu
from grakel_torch import use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset
from grakel_torch.graph import Graph as TGraph
from grakel_tpu.graph import Graph as JGraph


def _graph_arrays(graphs):
    return [(g.n, g.senders, g.receivers, g.weights, dict(g.node_labels))
            for g in graphs]


def jax_state(name, kernel, fit_graphs):
    """Read a fitted grakel_tpu kernel into kernel_from_state's layout."""
    if name in ("VertexHistogram", "EdgeHistogram"):
        return {"enum": dict(kernel._enum), "X": dict(kernel.X)}
    if name == "WeisfeilerLehman":
        return {"graphs": _graph_arrays(kernel.X)}
    key = "pm_embed_%d" % kernel.d
    return {"labels": getattr(kernel, "_labels", None)
            if kernel.with_labels else None,
            "sparse_mode": kernel._sparse_mode,
            "graphs": _graph_arrays(fit_graphs),
            "embeddings": [g._cache[key] for g in fit_graphs]}


@pytest.fixture(scope="module")
def data():
    return generate_dataset(n_graphs=40, n_graphs_test=8, r_vertices=(3, 12),
                            random_state=21, features=("nl", 5))


@pytest.mark.parametrize("name,params", [
    ("VertexHistogram", {}), ("VertexHistogram", {"normalize": True}),
    ("WeisfeilerLehman", {"n_iter": 3}),
    ("WeisfeilerLehman", {"n_iter": 2, "normalize": True})])
def test_histogram_and_wl_state_carry(data, name, params):
    train, test = data
    kj = getattr(grakel_tpu, name)(**params).fit(train)
    Tj = kj.transform(test)
    with use_device("cpu"):
        kt = kernel_from_state(name, params, jax_state(name, kj, None))
        Tt = kt.transform(test)
    np.testing.assert_array_equal(Tt, Tj)


def _big(seed, count):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        n = rng.randint(130, 170)
        A = (rng.rand(n, n) < 0.05).astype(float)
        A = np.triu(A, 1)
        out.append([A + A.T, {v: int(rng.randint(0, 4)) for v in range(n)}])
    return out


@pytest.mark.parametrize("params", [{}, {"normalize": True},
                                    {"with_labels": False}], ids=str)
def test_pm_state_carry_with_large_graphs(data, params):
    train, test = data
    fit_items = train[:20] + _big(3, 3)   # >= 128 vertices: device Lanczos
    jfit = [JGraph(*it) for it in fit_items]
    kj = grakel_tpu.PyramidMatch(**params).fit(jfit)
    jtest = [JGraph(*it) for it in test]
    Tj = kj.transform(jtest)
    # the transform graphs' own embeddings are shared too (ARPACK's start
    # vector depends on call history; see test_torch_pm)
    ttest = [TGraph(*it) for it in test]
    for a, b in zip(jtest, ttest):
        b._cache["pm_embed_6"] = a._cache["pm_embed_6"]
    state = jax_state("PyramidMatch", kj, jfit)
    with use_device("cpu"):
        kt = kernel_from_state("PyramidMatch", params, state)
        Tt = kt.transform(ttest)
    np.testing.assert_array_equal(Tt, Tj)


def test_unknown_kernel_rejected():
    with pytest.raises(ValueError):
        kernel_from_state("ShortestPath", {}, {})
