"""Plain reference of ``wl_nci1``: the Weisfeiler-Lehman subtree kernel
over vertex histograms (Shervashidze et al. 2011, as GraKeL ships it).

Generation 0 labels each vertex with its own label; each of ``n_iter``
refinements relabels a vertex by (its label, the sorted labels of its
neighbours), one new id for each distinct such pair over the whole set.
The Gram sums, over the ``n_iter + 1`` generations, the dot products of
the graphs' label histograms, and is then normalized.  Python dicts for
the labels, the exact counts-Gram of :mod:`bench_port.refcommon`.
"""

from __future__ import annotations

import numpy as np

from bench_port.refcommon import counts_gram, normalize

__all__ = ["features", "gram", "control"]


def features(graphs, n_iter):
    """(graph id, feature id) of every vertex in every generation; the
    feature ids of different generations never meet."""
    labels, nbrs = [], []
    first = {}
    for g in graphs:
        edges, lab = g[0], g[1]
        verts = sorted(lab)
        index = {v: k for k, v in enumerate(verts)}
        adj = [[] for _ in verts]
        for u, v in edges:
            adj[index[u]].append(index[v])
        nbrs.append(adj)
        labels.append([first.setdefault(lab[v], len(first)) for v in verts])
    gids, fids = [], []
    base = 0
    for it in range(n_iter + 1):
        if it:
            table = {}
            labels = [[table.setdefault(
                (ls[v], tuple(sorted(ls[u] for u in adj[v]))), len(table))
                for v in range(len(ls))] for ls, adj in zip(labels, nbrs)]
            width = len(table)
        else:
            width = len(first)
        for k, ls in enumerate(labels):
            gids.append(np.full(len(ls), k, np.int64))
            fids.append(np.asarray(ls, np.int64) + base)
        base += width
    return np.concatenate(gids), np.concatenate(fids)


def gram(graphs, params, device="cpu", dtype=np.float64):
    """The normalized Gram of ``WeisfeilerLehman(**params)`` with its
    default vertex-histogram base kernel, in ``dtype`` (float64, or
    float32 for the control)."""
    import torch
    gids, fids = features(graphs, params["n_iter"])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    K = counts_gram(gids, fids, len(graphs), device, tdt)
    return normalize(K, dtype) if params.get("normalize") else K


def control(graphs, params, device="cpu"):
    """The reference in the precision below the configuration's: the
    normalization in float32 (the counts stay exact)."""
    return gram(graphs, params, device, np.float32)
