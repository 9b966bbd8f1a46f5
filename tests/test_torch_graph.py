"""Host layer of grakel_torch against grakel_tpu: the Graph container
over the 7 input formats, generate_dataset, and GraphBatch packing."""

import numpy as np
import pytest
import scipy.sparse as sp

from grakel_torch.batch import GraphBatch as TBatch
from grakel_torch.datasets import generate_dataset as t_generate
from grakel_torch.graph import Graph as TGraph
from grakel_torch.kernels.base import normalize_input as t_normalize
from grakel_tpu.batch import GraphBatch as JBatch
from grakel_tpu.datasets import generate_dataset as j_generate
from grakel_tpu.graph import Graph as JGraph

_A = np.array([[0, 1, 0, 2], [1, 0, 1, 0], [0, 1, 0, 0], [2, 0, 0, 0]],
              dtype=float)
FORMATS = {
    "numpy": (_A, {0: "x", 1: "y", 2: "x", 3: "z"}),
    "scipy": (sp.csr_matrix(_A), {0: 1, 1: 2, 2: 1, 3: 2}),
    "list_of_lists": (_A.tolist(), {0: "a", 1: "a", 2: "b", 3: "b"}),
    "dict_of_dicts": ({"a": {"b": 1.0}, "b": {"a": 1.0, "c": 2.0},
                       "c": {"b": 2.0}}, {"a": 1, "b": 2, "c": 3}),
    "dict_of_lists": ({0: [1, 2], 1: [0], 2: [0]}, {0: "u", 1: "v", 2: "u"}),
    "edge_pairs": ([(0, 1), (1, 0), (1, 2), (2, 1)], {0: 5, 1: 6, 2: 5}),
    "weighted_triples": ([(0, 1, 0.5), (1, 0, 0.5), (1, 2, 3.0)],
                         {0: 1, 1: 1, 2: 2}),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_graph_round_trips_like_grakel_tpu(fmt):
    init, labels = FORMATS[fmt]
    el = {(0, 1): "e", (1, 0): "e"}
    t, j = TGraph(init, labels, el), JGraph(init, labels, el)
    assert t.n == j.n
    np.testing.assert_array_equal(t.senders, j.senders)
    np.testing.assert_array_equal(t.receivers, j.receivers)
    np.testing.assert_array_equal(t.weights, j.weights)
    assert t.get_labels() == j.get_labels()
    assert t.get_labels(label_type="edge") == j.get_labels(label_type="edge")
    np.testing.assert_array_equal(t.get_adjacency_matrix(),
                                  j.get_adjacency_matrix())
    assert t.index_of == j.index_of
    a, b = t.numeric_node_label_array(), j.numeric_node_label_array()
    assert (a is None and b is None) or np.array_equal(a, b)


def test_graph_from_arrays_and_structural_cache():
    s = np.array([0, 1, 1, 2], np.int32)
    r = np.array([1, 0, 2, 1], np.int32)
    t = TGraph.from_arrays(3, s, r, None, {0: 1, 1: 2, 2: 1})
    j = JGraph.from_arrays(3, s, r, None, {0: 1, 1: 2, 2: 1})
    np.testing.assert_array_equal(t.get_adjacency_matrix(),
                                  j.get_adjacency_matrix())
    np.testing.assert_array_equal(t.numeric_node_label_array(),
                                  j.numeric_node_label_array())
    assert "adj" in t._cache
    t.build_graph(np.eye(2))
    assert t._cache == {}


@pytest.mark.parametrize("kw", [
    dict(n_graphs=30, n_graphs_test=5, random_state=0),
    dict(n_graphs=20, n_graphs_test=4, r_vertices=(3, 9),
         r_weight_edges=(1, 3), random_state=1, features=("nl", 4, "el", 3)),
    dict(n_graphs=12, n_graphs_test=2, random_state=2,
         features=("na", 3, "ea", 2)),
])
def test_generate_dataset_identical(kw):
    tt, te = t_generate(**kw)
    jt, je = j_generate(**kw)
    assert len(tt) == len(jt) and len(te) == len(je)
    for a, b in zip(tt + te, jt + je):
        np.testing.assert_array_equal(a[0], b[0])
        for da, db in zip(a[1:], b[1:]):
            assert da.keys() == db.keys()
            for k in da:
                np.testing.assert_array_equal(da[k], db[k])


def test_normalize_input_skips_empty():
    with pytest.warns(UserWarning):
        out = t_normalize([[[(0, 1), (1, 0)], {0: "a", 1: "a"}], []])
    assert len(out) == 1


@pytest.mark.parametrize("features", [("nl", 5), ("nl", 3, "el", 2)])
def test_graph_batch_flat_layout_matches(features):
    train, _ = t_generate(n_graphs=25, n_graphs_test=2, r_vertices=(2, 9),
                          random_state=4, features=features)
    tg = [TGraph(*g) for g in train]
    jg = [JGraph(*g) for g in train]
    tb = TBatch.from_graphs(tg, node_label_enum={}, device="cpu")
    jb = JBatch.from_graphs(jg, node_label_enum={})
    for name in ("node_graph_ids", "node_mask", "node_labels", "senders",
                 "receivers", "edge_mask", "edge_weights", "edge_labels",
                 "edge_graph_ids"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for name in ("n_nodes", "n_edges", "node_offsets"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    assert (tb.num_node_labels, tb.num_edge_labels) == \
        (jb.num_node_labels, jb.num_edge_labels)
    assert tb.max_nodes == jb.max_nodes and tb.total_edges == jb.total_edges


def test_stage_timer_and_trace(tmp_path):
    import torch
    from grakel_torch.profiling import StageTimer, trace
    timer = StageTimer()
    with timer.stage("parse"):
        pass
    with timer.stage("parse"):
        pass
    assert timer.counts["parse"] == 2 and "parse" in timer.report()
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_derived_data_equal(seed):
    from grakel_torch import graph as t_graph
    from grakel_tpu import graph as j_graph
    rng = np.random.RandomState(seed)
    A = (rng.rand(9, 9) < 0.35).astype(float)
    A = np.triu(A, 1)
    A = A + A.T
    labels = {v: int(rng.randint(0, 3)) for v in range(9)}
    t, j = TGraph(A, labels), JGraph(A, labels)
    np.testing.assert_array_equal(t.build_shortest_path_matrix()[0],
                                  j.build_shortest_path_matrix()[0])
    np.testing.assert_array_equal(t.laplacian(), j.laplacian())
    np.testing.assert_array_equal(t.degrees(), j.degrees())
    assert [t.neighbors(v) for v in range(9)] == \
        [j.neighbors(v) for v in range(9)]
    assert t.core_numbers() == j.core_numbers()
    assert t_graph.dijkstra(t, 0) == j_graph.dijkstra(j, 0)
    tn = t.produce_neighborhoods(r=3, with_distances=True, d=3)
    jn = j.produce_neighborhoods(r=3, with_distances=True, d=3)
    assert tn == jn
    ts, js = t.get_subgraph([0, 2, 3, 7]), j.get_subgraph([0, 2, 3, 7])
    np.testing.assert_array_equal(ts.get_adjacency_matrix(),
                                  js.get_adjacency_matrix())
    assert ts.get_labels() == js.get_labels()
