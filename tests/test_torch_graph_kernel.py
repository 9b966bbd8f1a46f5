"""grakel_torch.GraphKernel and the TU reader against grakel_tpu on
JAX-CPU: the spec mini-language (synonyms, chaining), its errors,
Nystroem, the device rule through the wrapper, and ``read_data`` on the
vendored MUTAG and Cuneiform."""

import os

import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.estimator import NotFittedError
from grakel_tpu.datasets import read_data as jax_read_data

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def data():
    return generate_dataset(n_graphs=40, n_graphs_test=8, r_vertices=(3, 16),
                            r_connectivity=(0.15, 0.4), random_state=17,
                            features=("nl", 5))


def _both(spec, train, test, **kw):
    out = []
    for mod in (grakel_tpu, grakel_torch):
        gk = mod.GraphKernel(kernel=spec, **kw)
        with use_device("cpu"):
            out.append((np.asarray(gk.fit_transform(train)),
                        np.asarray(gk.transform(test)), gk))
    return out


@pytest.mark.parametrize("spec", [
    "shortest_path", "SP", {"name": "SP", "with_labels": False},
    ["shortest_path"], "VH", "ST-WL", "WL"], ids=str)
def test_graph_kernel_synonyms_match_jax(data, spec):
    (Kj, Tj, _), (Kt, Tt, gk) = _both(spec, *data)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)


@pytest.mark.parametrize("spec", [
    [{"name": "WL", "n_iter": 2}, "shortest_path"],
    [{"name": "core_framework"}, "SP"],
    [{"name": "CORE"}, {"name": "WL", "n_iter": 1}, "VH"]], ids=str)
def test_graph_kernel_chaining_matches_jax(data, spec):
    (Kj, Tj, _), (Kt, Tt, _) = _both(spec, *data, normalize=True)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-12, atol=0)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-12, atol=0)


def test_graph_kernel_default_is_shortest_path():
    gk = grakel_torch.GraphKernel()
    gk.initialize()
    assert type(gk.kernel_) is grakel_torch.ShortestPath


@pytest.mark.parametrize("spec", ["graph_hoper", "no_such_kernel",
                                  [{"name": "WL"}, "GHX"]], ids=str)
def test_graph_kernel_unported_or_unknown_name_lists_names(spec):
    with pytest.raises(ValueError, match="available:.*shortest_path"):
        grakel_torch.GraphKernel(kernel=spec).initialize()


def test_graph_kernel_unknown_parameter_raises_type_error():
    with pytest.raises(TypeError, match="with_lables"):
        grakel_torch.GraphKernel(
            kernel={"name": "SP", "with_lables": False}).initialize()


@pytest.mark.parametrize("spec,ncomp", [("SP", 10), ("WL", 25)])
def test_graph_kernel_nystroem_matches_jax(data, spec, ncomp):
    (Kj, Tj, gj), (Kt, Tt, gt) = _both(spec, *data, Nystroem=ncomp,
                                       random_state=5)
    assert np.array_equal(gt.components_indices_, gj.components_indices_)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-9, atol=1e-9)


def test_graph_kernel_device_rule(data, monkeypatch):
    train, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_device"):
        grakel_torch.GraphKernel().fit_transform(train)
    gk = grakel_torch.GraphKernel(kernel=[{"name": "CORE"}, "SP"])
    gk.device = "cpu"    # forwarded to the kernel it builds
    K = gk.fit_transform(train)
    assert K.shape == (len(train), len(train))
    assert gk.kernel_.device == "cpu"


def test_graph_kernel_transform_before_fit(data):
    with pytest.raises(NotFittedError):
        grakel_torch.GraphKernel().transform(data[1])


def test_graph_kernel_set_params_rebuilds(data):
    train, test = data
    gk = grakel_torch.GraphKernel(kernel="SP")
    with use_device("cpu"):
        gk.fit_transform(train)
        gk.set_params(kernel="VH")
        K = gk.fit_transform(train)
        ref = grakel_torch.VertexHistogram().fit_transform(train)
    assert np.array_equal(K, ref)


def _items(bunch):
    return [(sorted(e), sorted(nl.items()), sorted(el.items()))
            for e, nl, el in bunch.data]


@pytest.mark.parametrize("name,kw", [
    ("MUTAG", {}), ("MUTAG", {"is_symmetric": True}),
    ("MUTAG", {"produce_labels_nodes": True, "with_classes": False}),
    ("Cuneiform", {"prefer_attr_nodes": True, "prefer_attr_edges": True})])
def test_read_data_matches_jax_reader(name, kw):
    b = read_data(name, path=DATA, **kw)
    j = jax_read_data(name, path=DATA, **kw)
    assert sorted(b.keys()) == sorted(j.keys())
    assert _items(b) == _items(j)
    if "target" in j:
        assert np.array_equal(b.target, j.target)


def test_read_data_mutag_through_shortest_path():
    b = read_data("MUTAG", path=DATA)
    j = jax_read_data("MUTAG", path=DATA)
    assert len(b.data) == 188 and b["target"].shape == (188,)
    Kj = grakel_tpu.ShortestPath().fit_transform(j.data[:60])
    with use_device("cpu"):
        Kt = grakel_torch.ShortestPath().fit_transform(b.data[:60])
    assert np.array_equal(Kt, Kj)
