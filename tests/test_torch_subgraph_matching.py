"""grakel_torch's SubgraphMatching against grakel_tpu on JAX-CPU: the
weighted product graph (vectorised for the dirac kv / ke, the loop for
callables) and the native clique enumeration give the JAX package's
Grams at rtol 1e-6 / atol 1e-8 for every lambda-weight form; the entry
points follow the device rule though the kernel runs on the host."""

import os

import numpy as np
import pytest
import torch

import grakel_tpu
from grakel_torch import GraphKernel, use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import read_data
from grakel_torch.kernels.subgraph_matching import SubgraphMatching
from grakel_torch.native import _clique_values_py, clique_values
from jax_native_ref import jax_native  # noqa: F401 (fixture)

# the expected values come from grakel_tpu's native engine: load it
# first (see jax_native_ref)
pytestmark = pytest.mark.usefixtures("jax_native")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def mutag():
    g = read_data("MUTAG", path=DATA).data
    # the smallest graphs: a k = 5 enumeration grows fast with size
    order = sorted(range(len(g)), key=lambda i: len(g[i][1]))
    return [g[i] for i in order[:9]]


def _both(fit, tr, **params):
    kj = grakel_tpu.SubgraphMatching(**params)
    rj = (kj.fit_transform(fit), kj.transform(tr), *kj.diagonal())
    with use_device("cpu"):
        kt = SubgraphMatching(**params)
        rt = (kt.fit_transform(fit), kt.transform(tr), *kt.diagonal())
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    return rt


def _lw_times_two(i):
    return 2.0 * i + 1.0


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("lw", ["uniform", "increasing", "decreasing",
                                "strong_decreasing", "callable"])
def test_sm_matches_jax(mutag, k, lw):
    lw = _lw_times_two if lw == "callable" else lw
    _both(mutag[:6], mutag[6:9], k=k, lw=lw,
          normalize=(lw == "decreasing"))


def _kv(a, b):
    return 1.0 if a == b else 0.5


def _ke(a, b):
    return 2.0 if a == b else 0.25


@pytest.mark.parametrize("kv,ke", [(_kv, _ke), (None, None), (_kv, None),
                                   (None, _ke)],
                         ids=["callables", "none", "kv_only", "ke_only"])
def test_sm_kv_ke_forms_match_jax(mutag, kv, ke):
    _both(mutag[:5], mutag[5:8], k=3, kv=kv, ke=ke)


def test_sm_lw_errors_match_jax(mutag):
    """An iterable ``lw`` of k values reshapes to k + 1 and fails in the
    JAX package as in the port; a bad ``lw`` raises TypeError."""
    for lw in ([1.0, 2.0, 3.0], "bogus"):
        with pytest.raises((ValueError, TypeError)) as ej:
            grakel_tpu.SubgraphMatching(k=3, lw=lw).fit(mutag[:2])
        with use_device("cpu"), pytest.raises(ej.type):
            SubgraphMatching(k=3, lw=lw).fit(mutag[:2])


def test_clique_values_on_product_graphs(mutag):
    """The native enumeration equals its Python version on SM's product
    graphs."""
    k = SubgraphMatching(k=4)
    k.initialize()
    parsed = k.parse_input(mutag[:4])
    for x in parsed:
        for y in parsed:
            cv, ce = k._product_graph(x, y)
            tv = np.zeros(5)
            _clique_values_py(len(cv), 4, cv, ce, tv)
            np.testing.assert_allclose(clique_values(cv, ce, 4), tv,
                                       rtol=1e-12)


def test_sm_device_rule_and_graph_kernel(mutag, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_device"):
        SubgraphMatching(k=2).fit_transform(mutag[:3])
    for name in ("SM", "subgraph_matching"):
        gk = GraphKernel(kernel={"name": name, "k": 2})
        with use_device("cpu"):
            K = gk.fit_transform(mutag[:4])
        assert isinstance(gk.kernel_, SubgraphMatching) and K.shape == (4, 4)


def test_sm_state_carry(mutag):
    fit, tr = mutag[:5], mutag[5:8]
    Tj = grakel_tpu.SubgraphMatching(k=3).fit(fit).transform(tr)
    with use_device("cpu"):
        from grakel_torch.kernels.base import normalize_input
        state = {"graphs": [(g.n, g.senders, g.receivers, g.weights,
                             g.node_labels, g.edge_labels)
                            for g in normalize_input(fit)]}
        T = kernel_from_state("SubgraphMatching", {"k": 3},
                              state).transform(tr)
    np.testing.assert_allclose(T, Tj, rtol=1e-6, atol=1e-8)
