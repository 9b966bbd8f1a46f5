"""The stand-in generator: NCI1's means, connected molecule-like graphs,
the same work for every seed."""

from collections import Counter, deque

import numpy as np

from bench_port.graphs import class_labels, make_dataset, stats
from bench_port.manifest import Manifest

DATA = Manifest().config("wl_nci1")["data"]


def _connected(g):
    adj = {}
    for u, v in g[0]:
        adj.setdefault(u, []).append(v)
    verts = list(g[1])
    seen, todo = {verts[0]}, deque([verts[0]])
    while todo:
        for w in adj.get(todo.popleft(), ()):
            if w not in seen:
                seen.add(w)
                todo.append(w)
    return len(seen) == len(verts)


def test_generator_matches_nci1_means_and_graphs_are_connected():
    fit, held = make_dataset(DATA, 2 ** 31 + 5)
    s = stats(fit)
    assert s["graphs"] == 4110 and len(held) == 64
    assert abs(s["mean_vertices"] - 29.87) < 0.15
    assert abs(s["mean_edges"] - 32.30) < 1e-9
    assert s["labels"] == 37
    for g in fit:
        assert _connected(g)
        assert all((v, u) in g[0] for u, v in g[0])
        assert all(u != v for u, v in g[0])
        deg = Counter(u for u, _ in g[0])
        assert max(deg.values()) <= DATA["max_degree"]
        assert 10 <= len(g[1]) <= 50 and g[2] == {}


def test_every_seed_makes_the_same_work_in_another_order():
    a, _ = make_dataset(DATA, 1)
    b, _ = make_dataset(DATA, 2 ** 32 + 3)
    c, _ = make_dataset(DATA, 1)
    assert sorted(len(g[1]) for g in a) == sorted(len(g[1]) for g in b)
    assert sum(len(g[0]) for g in a) == sum(len(g[0]) for g in b)
    assert [len(g[1]) for g in a] != [len(g[1]) for g in b]
    assert all(x[0] == y[0] and x[1] == y[1] for x, y in zip(a, c))


def test_class_labels_are_two_balanced_classes():
    fit, _ = make_dataset(DATA, 9)
    y = class_labels(fit, DATA, 9)
    assert set(np.unique(y)) == {0, 1}
    assert 0.45 < y.mean() < 0.55
    assert (y == class_labels(fit, DATA, 9)).all()
