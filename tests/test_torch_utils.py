"""grakel_torch.utils against grakel_tpu.utils on JAX-CPU: every
converter gives the JAX package's graphs (vertices, edges, weights and
labels) and, through a kernel, its Gram; KMTransformer gives its
matrices, and works inside scikit-learn (``clone``, a ``Pipeline`` with
a precomputed-kernel ``SVC``; the test imports scikit-learn, the port
does not).  Mirrors ``tests/test_utils.py``."""

import types

import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.estimator import NotFittedError

ATTRS = ("n", "senders", "receivers", "weights", "node_labels",
         "edge_labels", "index_of")


def _same_graph(gt, gj):
    """A port Graph and a JAX package Graph hold the same structure and
    labels."""
    for a in ATTRS:
        x, y = getattr(gt, a), getattr(gj, a)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), a
            for k in x:
                assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), a
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), a


def _same_input(it, ij):
    """Two converter outputs ([graph_object, node_labels, edge_labels]
    lists, or Graphs) are the same."""
    if isinstance(it, grakel_torch.Graph):
        _same_graph(it, ij)
        return
    assert len(it) == len(ij)
    for a, b in zip(it, ij):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k], dtype=object),
                                      np.asarray(b[k], dtype=object))
        else:
            assert a == b


def _grams(inputs_t, inputs_j, make, split=None):
    """The port's (on the CPU) and the JAX package's fit_transform Grams,
    and transforms of the inputs past ``split``."""
    out = []
    for mod, inputs in ((grakel_torch, inputs_t), (grakel_tpu, inputs_j)):
        k = make(mod)
        with use_device("cpu"):
            if split is None:
                out.append((k.fit_transform(inputs),))
            else:
                out.append((k.fit_transform(inputs[:split]),
                            k.transform(inputs[split:])))
    return out


def _random_nx(n_graphs=6, seed=0):
    import networkx as nx
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = rng.randint(4, 9)
        G = nx.Graph()
        for v in range(n):
            G.add_node(v, label=int(rng.randint(0, 3)))
        for u in range(n):
            for v in range(u + 1, n):
                if rng.rand() < 0.4:
                    G.add_edge(u, v, label=int(rng.randint(0, 2)),
                               w=float(rng.rand()))
        out.append(G)
    return out


@pytest.mark.parametrize("kw", [
    {"node_labels_tag": "label", "edge_labels_tag": "label"},
    {"node_labels_tag": "label", "edge_weight_tag": "w"},
    {"val_node_labels": "x", "val_edge_labels": 1},
    {"node_labels_tag": "label", "as_Graph": True}], ids=str)
def test_graph_from_networkx_matches_jax(kw):
    gs = _random_nx(8)
    t = list(grakel_torch.graph_from_networkx(gs, **kw))
    j = list(grakel_tpu.graph_from_networkx(gs, **kw))
    assert len(t) == len(j) == 8
    for a, b in zip(t, j):
        _same_input(a, b)
    (Kt, Tt), (Kj, Tj) = _grams(
        t, j, lambda m: m.WeisfeilerLehman(n_iter=2), split=5)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    if "edge_weight_tag" in kw:
        assert any(w not in (0.0, 1.0) for g in t
                   for w in grakel_torch.Graph(*g).weights)
        (Kt,), (Kj,) = _grams(t, j, lambda m: m.ShortestPath())
        assert np.array_equal(Kt, Kj)


def test_graph_from_networkx_rejects_non_iterable():
    with pytest.raises(ValueError):
        next(grakel_torch.graph_from_networkx(3))


def _frames():
    import pandas as pd
    # node ids are global row indices: graph 0 owns nodes 0-2, graph 1
    # 3-5, graph 2 6-8
    edges = pd.DataFrame({
        "g": [0, 0, 0, 1, 1, 2, 2],
        "src": [0, 1, 2, 3, 4, 6, 7],
        "dst": [1, 2, 0, 4, 5, 7, 8],
        "w": [1.0, 2.0, 1.5, 1.0, 0.5, 1.0, 1.0],
        "lab": ["a", "b", "a", "b", "a", "a", "a"],
        "a1": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7],
        "a2": [1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0]})
    nodes = pd.DataFrame({"g": [0, 0, 0, 1, 1, 1, 2, 2, 2],
                          "lab": ["x", "y", "x", "y", "x", "y", "x", "x",
                                  "y"],
                          "f": np.arange(9.0)})
    return edges, nodes


@pytest.mark.parametrize("case", ["labels", "attrs", "directed",
                                  "no_nodes", "as_Graph"])
def test_graph_from_pandas_matches_jax(case):
    edges, nodes = _frames()
    e = (edges, "g", ("src", "dst"), "w", "lab")
    n = (nodes, "g", "lab")
    kw = {}
    if case == "attrs":
        e = (edges, "g", ("src", "dst"), None, ["a1", "a2"])
        n = (nodes, "g", ["f"])
    elif case == "directed":
        kw["directed"] = True
    elif case == "no_nodes":
        n = None
    elif case == "as_Graph":
        kw["as_Graph"] = True
    t = grakel_torch.graph_from_pandas(e, n, **kw)
    j = grakel_tpu.graph_from_pandas(e, n, **kw)
    assert sorted(t) == sorted(j) == [0, 1, 2]
    for key in t:
        _same_input(t[key], j[key])
    if case in ("labels", "directed", "as_Graph"):
        (Kt,), (Kj,) = _grams(list(t.values()), list(j.values()),
                              lambda m: m.VertexHistogram())
        assert np.array_equal(Kt, Kj)
        (Kt,), (Kj,) = _grams(list(t.values()), list(j.values()),
                              lambda m: m.ShortestPath())
        assert np.array_equal(Kt, Kj)


def test_graph_from_pandas_rejects_bad_frames():
    edges, nodes = _frames()
    with pytest.raises(ValueError):
        grakel_torch.graph_from_pandas((edges, "g"))
    with pytest.raises(ValueError):
        grakel_torch.graph_from_pandas((edges, "g", ("src", "dst"), None,
                                        None), (nodes, "g"))
    with pytest.raises(ValueError):   # a graph missing from node_df
        grakel_torch.graph_from_pandas(
            (edges, "g", ("src", "dst"), None, None),
            (nodes[nodes.g < 2], "g", None))


def _csv_files(tmp_path):
    rng = np.random.RandomState(4)
    efiles, nfiles = [], []
    for i in range(7):
        n = rng.randint(4, 10)
        lines = []
        for u in range(n):
            for v in range(u + 1, n):
                if rng.rand() < 0.4:
                    lines.append("%d,%d,%.3f,%s" % (
                        u, v, rng.choice([0.5, 1.0, 2.0]),
                        "ab"[rng.randint(2)]))
        e = tmp_path / ("e%d.csv" % i)
        e.write_text("\n".join(lines) + "\n")
        nd = tmp_path / ("n%d.csv" % i)
        nd.write_text("".join("%d,%s\n" % (v, "xyz"[rng.randint(3)])
                              for v in range(n)))
        efiles.append(str(e))
        nfiles.append(str(nd))
    return efiles, nfiles


@pytest.mark.parametrize("weights", [True, False])
def test_graph_from_csv_matches_jax(tmp_path, weights):
    efiles, nfiles = _csv_files(tmp_path)
    out = []
    for mod in (grakel_torch, grakel_tpu):
        if weights:
            gs = list(mod.graph_from_csv((efiles, True, False),
                                         (nfiles, False)))
        else:
            # the weight column read as the edge label
            gs = list(mod.graph_from_csv((efiles, False, False),
                                         (nfiles, False), index_type=int))
        out.append(gs)
    t, j = out
    assert len(t) == len(j) == 7
    for a, b in zip(t, j):
        _same_input(a, b)
    for make in (lambda m: m.ShortestPath(),
                 lambda m: m.WeisfeilerLehman(n_iter=3)):
        (Kt, Tt), (Kj, Tj) = _grams(t, j, make, split=5)
        assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)


def test_graph_from_csv_attributes_and_checks(tmp_path):
    e = tmp_path / "g.csv"
    e.write_text("0;1;0.5;1.0;2.0\n1;2;1.5;3.0;4.0\n\n")
    nd = tmp_path / "n.csv"
    nd.write_text("0;1.0;0.0\n1;0.0;1.0\n2;1.0;1.0\n3;0.5;0.5\n")
    kw = dict(sep=";", directed=True, as_Graph=True)
    t = list(grakel_torch.graph_from_csv(([str(e)], True, True),
                                         ([str(nd)], True), **kw))
    j = list(grakel_tpu.graph_from_csv(([str(e)], True, True),
                                       ([str(nd)], True), **kw))
    _same_graph(t[0], j[0])
    assert t[0].n == 4   # the isolated vertex of the node file
    with pytest.raises(ValueError):
        next(grakel_torch.graph_from_csv(([str(e)], True, True),
                                         index_type="int"))
    with pytest.raises(ValueError):
        next(grakel_torch.graph_from_csv(([str(e)], True)))


def _tg(**fields):
    """Minimal stand-in for a torch_geometric Data/Batch object: the
    converter only reads attributes."""
    base = dict(x=None, edge_attr=None, y=None, batch=None)
    base.update(fields)
    return types.SimpleNamespace(**base)


def _tg_batch():
    rng = np.random.RandomState(8)
    src, dst, member, off = [], [], [], 0
    for g in range(6):
        n = rng.randint(3, 8)
        for u in range(n):
            for v in range(u + 1, n):
                if rng.rand() < 0.5:
                    src += [off + u, off + v]
                    dst += [off + v, off + u]
        member += [g] * n
        off += n
    x = np.eye(3)[rng.randint(0, 3, off)]
    ea = np.eye(2)[rng.randint(0, 2, len(src))]
    return _tg(edge_index=torch.tensor([src, dst]),
               x=torch.tensor(x, dtype=torch.float32),
               edge_attr=torch.tensor(ea, dtype=torch.float32),
               y=torch.tensor(rng.randint(0, 2, 6)),
               batch=torch.tensor(member))


@pytest.mark.parametrize("one_hot", [True, False])
def test_graph_from_torch_geometric_batch_matches_jax(one_hot):
    data = _tg_batch()
    t = grakel_torch.graph_from_torch_geometric(
        data, node_one_hot=one_hot, edge_one_hot=one_hot)
    j = grakel_tpu.graph_from_torch_geometric(
        data, node_one_hot=one_hot, edge_one_hot=one_hot)
    assert t["y"] == j["y"] and len(t["graph"]) == len(j["graph"]) == 6
    for a, b in zip(t["graph"], j["graph"]):
        _same_graph(a, b)
    if one_hot:
        for make in (lambda m: m.ShortestPath(),
                     lambda m: m.WeisfeilerLehman(n_iter=2)):
            (Kt, Tt), (Kj, Tj) = _grams(t["graph"], j["graph"], make,
                                        split=4)
            assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    else:
        lab = t["graph"][0].get_labels(label_type="vertex")
        assert np.asarray(next(iter(lab.values()))).shape == (3,)
    assert "y" not in grakel_torch.graph_from_torch_geometric(
        data, ignore_y=True)


def test_graph_from_torch_geometric_single_and_crossing():
    data = _tg(edge_index=torch.tensor([[0, 1, 1, 2], [1, 0, 2, 1]]),
               x=torch.tensor([[0.0, 1.0], [1.0, 0.0], [0.0, 1.0]]),
               edge_attr=torch.tensor([[1.0, 0.0]] * 4),
               y=torch.tensor([1]))
    t = grakel_torch.graph_from_torch_geometric(data, node_one_hot=True,
                                                edge_one_hot=True)
    j = grakel_tpu.graph_from_torch_geometric(data, node_one_hot=True,
                                              edge_one_hot=True)
    assert t["y"] == j["y"] == 1
    _same_graph(t["graph"], j["graph"])
    assert t["graph"].get_labels(label_type="vertex") == {0: 1, 1: 0, 2: 1}
    bad = _tg(edge_index=torch.tensor([[0, 2], [1, 1]]),
              batch=torch.tensor([0, 0, 1]))
    with pytest.raises(ValueError):
        grakel_torch.graph_from_torch_geometric(bad)


def test_km_transformer_matches_jax():
    rng = np.random.RandomState(1)
    K = rng.rand(9, 9)
    t, j = grakel_torch.KMTransformer(K=K), grakel_tpu.KMTransformer(K=K)
    assert np.array_equal(t.fit_transform([0, 2, 5]),
                          j.fit_transform([0, 2, 5]))
    assert np.array_equal(t.transform([1, 3, 8]), j.transform([1, 3, 8]))
    assert np.array_equal(t.transform([1, 3, 8]),
                          K[np.ix_([1, 3, 8], [0, 2, 5])])
    for bad in ([-1], [10]):
        with pytest.raises(ValueError):
            t.transform(bad)
        with pytest.raises(ValueError):
            grakel_torch.KMTransformer(K=K).fit(bad)
    with pytest.raises(NotFittedError):
        grakel_torch.KMTransformer(K=K).transform([0])


def test_km_transformer_params_bunch_and_sparse():
    import scipy.sparse as sp
    from sklearn.utils import Bunch
    K = np.arange(16.0).reshape(4, 4)
    t = grakel_torch.KMTransformer(K=K)
    assert t.get_params() == {"K": K}
    t.fit([0, 1])
    K2 = 2 * K
    assert t.set_params(K=K2) is t and not t._initialized["K"]
    assert np.array_equal(t.fit_transform([1, 2]), K2[np.ix_([1, 2], [1, 2])])
    b = grakel_torch.KMTransformer(K=Bunch(mat=K))
    assert np.array_equal(b.fit_transform([3]), [[15.0]])
    with pytest.raises(ValueError):
        grakel_torch.KMTransformer(K=Bunch(other=K)).fit([0])
    s = grakel_torch.KMTransformer(K=sp.csr_matrix(K))
    assert np.array_equal(s.fit_transform([0, 3]), K[np.ix_([0, 3], [0, 3])])
    with pytest.raises(ValueError):
        grakel_torch.KMTransformer(K=np.arange(3.0)).fit([0])
    assert np.array_equal(grakel_torch.KMTransformer().fit_transform([0]),
                          [[1.0]])


def test_km_transformer_in_sklearn_pipeline():
    """clone copies K; a Pipeline of KMTransformer and a precomputed SVC
    gives the JAX package's KMTransformer's predictions."""
    from sklearn.base import clone
    from sklearn.pipeline import Pipeline
    from sklearn.svm import SVC
    rng = np.random.RandomState(2)
    y = np.arange(40) % 2
    phi = rng.randn(40, 4) + 2.0 * y[:, None]
    K = phi @ phi.T
    t = grakel_torch.KMTransformer(K=K)
    c = clone(t)
    assert c is not t and np.array_equal(c.K, K)
    preds = []
    for km in (t, grakel_tpu.KMTransformer(K=K)):
        pipe = Pipeline([("km", km), ("svc", SVC(kernel="precomputed"))])
        pipe.fit(np.arange(30), y[:30])
        preds.append(pipe.predict(np.arange(30, 40)))
    assert np.array_equal(preds[0], preds[1])
    assert (preds[0] == y[30:]).mean() >= 0.8


def test_port_import_loads_no_networkx_or_pandas():
    """networkx and pandas are imported by the converters that read them
    only: importing every module of the port loads neither (the card's
    machine has neither installed)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pkgutil, importlib, grakel_torch\n"
            "for m in pkgutil.walk_packages(grakel_torch.__path__, "
            "'grakel_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(','.join(sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('networkx', 'pandas'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
