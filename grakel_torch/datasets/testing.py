"""Synthetic random-graph dataset generation for testing.

API parity with the reference ``grakel.datasets.testing.generate_dataset``
(reference grakel/datasets/testing.py:7-281): returns (train, test) lists
of ``[adjacency, node_label_dict, edge_label_dict]`` with controllable
vertex-count range, connectivity, edge weights, and feature type; when
discrete labels are requested, the test split is GUARANTEED to contain a
label never seen in train (testing.py:232-261) so transform-time
unseen-label paths get exercised.

A copy of ``grakel_tpu/datasets/testing.py`` over the port's own
``check_random_state``: the same seed gives the same graphs.
"""

from __future__ import annotations

from numbers import Real

import numpy as np

from ..estimator import check_random_state

__all__ = ["generate_dataset"]


def _parse_features(features):
    """-> (node_kind, node_dim, edge_kind, edge_dim); kind in
    {None, 'label', 'attr'}."""
    if features is None:
        return None, 0, None, 0
    if isinstance(features, str):
        features = (features,)
    if not isinstance(features, tuple) or not 0 < len(features) <= 4:
        raise TypeError("features must be a str or a tuple of <= 4 items")
    nk, nd, ek, ed = None, 5, None, 5
    items = list(features)
    i = 0
    while i < len(items):
        f = items[i]
        if f is None:
            i += 1
            continue
        if f not in ("nl", "na", "el", "ea"):
            raise TypeError("unknown feature kind %r" % (f,))
        dim = None
        if i + 1 < len(items) and isinstance(items[i + 1], int):
            dim = items[i + 1]
            i += 1
        if f == "nl":
            if nk == "attr":
                raise ValueError("node labels and attributes are exclusive")
            nk = "label"
            nd = dim if dim is not None else 5
            if nd < 2:
                raise TypeError("need >= 2 distinct node labels")
        elif f == "na":
            if nk == "label":
                raise ValueError("node labels and attributes are exclusive")
            nk = "attr"
            nd = dim if dim is not None else 4
            if nd < 1:
                raise TypeError("node attribute dim must be positive")
        elif f == "el":
            if ek == "attr":
                raise ValueError("edge labels and attributes are exclusive")
            ek = "label"
            ed = dim if dim is not None else 5
            if ed < 2:
                raise TypeError("need >= 2 distinct edge labels")
        else:
            if ek == "label":
                raise ValueError("edge labels and attributes are exclusive")
            ek = "attr"
            ed = dim if dim is not None else 4
            if ed < 1:
                raise TypeError("edge attribute dim must be positive")
        i += 1
    return nk, nd, ek, ed


def generate_dataset(n_graphs=100, r_vertices=(1, 20),
                     r_connectivity=(0.2, 0.8), r_weight_edges=(1, 1),
                     n_graphs_test=20, random_state=None, features="nl"):
    """Generate (train, test) random-graph splits; see module docstring."""
    if not isinstance(n_graphs, int) or n_graphs < 1:
        raise TypeError("n_graphs must be a positive integer")
    if (not isinstance(n_graphs_test, int) or n_graphs_test < 1
            or n_graphs_test >= n_graphs):
        raise TypeError("n_graphs_test must be positive and < n_graphs")
    if (not isinstance(r_vertices, tuple) or len(r_vertices) != 2
            or r_vertices[0] > r_vertices[1] or r_vertices[0] < 0
            or not all(isinstance(v, int) for v in r_vertices)):
        raise TypeError("r_vertices must be an int (lo, hi) tuple")
    if (not isinstance(r_connectivity, tuple) or len(r_connectivity) != 2
            or r_connectivity[0] > r_connectivity[1]
            or r_connectivity[0] < 0 or r_connectivity[1] > 1
            or not all(isinstance(v, Real) for v in r_connectivity)):
        raise TypeError("r_connectivity must be a real (lo, hi) in [0, 1]")
    if (not isinstance(r_weight_edges, tuple) or len(r_weight_edges) != 2
            or r_weight_edges[0] > r_weight_edges[1] or r_weight_edges[0] <= 0
            or not all(isinstance(v, Real) for v in r_weight_edges)):
        raise TypeError("r_weight_edges must be a positive real (lo, hi)")

    nk, nd, ek, ed = _parse_features(features)
    rs = check_random_state(random_state)

    # when labels requested: train draws from [0, nd-1), test plants the
    # held-out label nd-1 in at least one graph (unseen-label guarantee)
    def make_graph(split, plant_unseen):
        n = rs.randint(r_vertices[0], r_vertices[1] + 1)
        n = max(n, 1)
        p = rs.uniform(r_connectivity[0], r_connectivity[1])
        A = (rs.rand(n, n) < p).astype(float)
        A = np.triu(A, 1)
        if r_weight_edges != (1, 1):
            W = rs.uniform(r_weight_edges[0], r_weight_edges[1], size=(n, n))
            A = A * W
        A = A + A.T
        item = [A]
        if nk == "label":
            hi = nd - 1 if split == "train" else nd
            labs = {v: int(rs.randint(0, max(hi, 1))) for v in range(n)}
            if plant_unseen:
                labs[int(rs.randint(0, n))] = nd - 1
            item.append(labs)
        elif nk == "attr":
            item.append({v: rs.rand(nd) for v in range(n)})
        else:
            item.append({})
        es, rt = np.nonzero(A)
        if ek == "label":
            hi = ed - 1 if split == "train" else ed
            el = {}
            for u, v in zip(es, rt):
                if u < v:
                    lab = int(rs.randint(0, max(hi, 1)))
                    el[(int(u), int(v))] = lab
                    el[(int(v), int(u))] = lab
            item.append(el)
        elif ek == "attr":
            el = {}
            for u, v in zip(es, rt):
                if u < v:
                    a = rs.rand(ed)
                    el[(int(u), int(v))] = a
                    el[(int(v), int(u))] = a
            item.append(el)
        else:
            item.append({})
        return item

    n_train = n_graphs - n_graphs_test
    train = [make_graph("train", False) for _ in range(n_train)]
    test = []
    for i in range(n_graphs_test):
        plant = (nk == "label") and i == 0
        test.append(make_graph("test", plant))
    return train, test
