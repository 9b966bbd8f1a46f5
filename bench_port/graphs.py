"""The seeded stand-in for a TU molecule dataset, frozen here.

:func:`make_dataset` reads a configuration's ``data`` block and draws,
from ``--seed`` alone, graphs in the format ``read_data`` gives a
TUDataset: ``[set of (u, v) edges, both directions, {vertex: label},
{}]``.  Each graph is connected, like a molecule: a random tree whose
vertices take at most ``max_degree`` neighbours (a valence), plus extra
edges between vertices still under it.  Every seed gets the same
multiset of vertex counts (each count of ``vertices`` equally often, in
another order) and the same total of extra edges, so the work of a call
does not move with the seed; the seed moves which graph is which, the
trees, the extra edges and the labels.

:func:`class_labels` gives two balanced classes for model selection (the
rule stated under ``assumed`` in the configuration).
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "class_labels", "stats", "sizes_of"]


def sizes_of(n, lo, hi, rng):
    """``n`` vertex counts, each of ``lo..hi`` equally often (the first
    ``n mod (hi - lo + 1)`` once more), shuffled by ``rng``."""
    sizes = lo + np.arange(n, dtype=np.int64) % (hi - lo + 1)
    rng.shuffle(sizes)
    return sizes


def _graph(n, extra, n_labels, max_degree, rng):
    """One connected graph of ``n`` vertices: a random tree under the
    valence, then up to ``extra`` more edges between distinct vertices
    under it that are not yet joined."""
    deg = [0] * n
    edges = set()
    order = rng.permutation(n).tolist()
    picks = rng.random(n + 64 * extra).tolist()
    under = [order[0]]           # vertices under the valence, in order
    for k in range(1, n):
        v = order[k]
        a = int(picks[k] * len(under))
        u = under[a]
        edges.add((u, v))
        edges.add((v, u))
        deg[u] += 1
        deg[v] = 1
        if deg[u] == max_degree:
            under[a] = under[-1]
            under.pop()
        under.append(v)
    p = n
    for _ in range(extra):
        for _ in range(32):      # a few draws for a pair not yet joined
            if len(under) < 2:
                break
            a = int(picks[p] * len(under))
            b = int(picks[p + 1] * (len(under) - 1))
            p += 2
            b += b >= a
            u, v = under[a], under[b]
            if (u, v) in edges:
                continue
            edges.add((u, v))
            edges.add((v, u))
            deg[u] += 1
            deg[v] += 1
            for x in sorted((a, b), reverse=True):
                if deg[under[x]] == max_degree:
                    under[x] = under[-1]
                    under.pop()
            break
    labels = rng.integers(0, n_labels, size=n).tolist()
    return [edges, dict(enumerate(labels)), {}]


def _split(n, data, rng):
    lo, hi = data["vertices"]
    sizes = sizes_of(n, lo, hi, rng)
    # extra edges over the tree's n - 1, so that the set's mean edge
    # count is the published one; spread over the graphs by their size
    total = int(round((data["mean_edges"] - (sizes - 1).mean()) * n))
    extra = rng.multinomial(max(total, 0), sizes / sizes.sum())
    return [_graph(int(s), int(e), data["labels"], data["max_degree"], rng)
            for s, e in zip(sizes, extra)]


def make_dataset(data, seed):
    """(fit graphs, held-out graphs) of the configuration's ``data``
    block: ``graphs`` and ``held_out`` counts, ``vertices`` [lo, hi],
    ``mean_edges``, ``labels``, ``max_degree``."""
    rng = np.random.default_rng([int(seed), 0])
    fit = _split(int(data["graphs"]), data, rng)
    held = _split(int(data["held_out"]), data, rng)
    return fit, held


def class_labels(graphs, data, seed):
    """Two balanced classes: class 1 when a graph's share of vertices
    labeled below ``class_rule.label_below`` exceeds the set's median
    share, then each flipped with probability ``class_rule.flip``."""
    rule = data["class_rule"]
    share = np.array([np.mean(np.fromiter(g[1].values(), np.int64)
                              < rule["label_below"]) for g in graphs])
    y = (share > np.median(share)).astype(np.int64)
    flip = np.random.default_rng([int(seed), 1]).random(len(graphs)) \
        < rule["flip"]
    y[flip] = 1 - y[flip]
    return y


def stats(graphs):
    """Vertices, undirected edges and vertex labels of a set: the means a
    configuration states beside the published ones."""
    nv = np.array([len(g[1]) for g in graphs], np.float64)
    ne = np.array([len(g[0]) // 2 for g in graphs], np.float64)
    labels = set()
    for g in graphs:
        labels.update(g[1].values())
    return {"graphs": len(graphs), "mean_vertices": float(nv.mean()),
            "mean_edges": float(ne.mean()), "labels": len(labels),
            "vertices": int(nv.sum()), "directed_edges": int(2 * ne.sum())}
