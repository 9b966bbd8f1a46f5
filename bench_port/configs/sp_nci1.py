"""Plain reference of ``sp_nci1``: the labeled shortest-path kernel
(Borgwardt & Kriegel 2005, as GraKeL ships it with ``with_labels=True``).

Each graph's all-pairs shortest paths over unit-weight edges
(Floyd-Warshall in NumPy, the graphs of one vertex count at a time);
each ordered pair of distinct vertices joined by a path counts the
triplet (label of the first, label of the second, distance).  The Gram
is the dot product of those counts, then normalized.
"""

from __future__ import annotations

import numpy as np

from bench_port.refcommon import counts_gram, normalize

__all__ = ["distances", "features", "gram", "control"]


def distances(graphs):
    """{graph index: (vertices in sorted order, [V, V] f64 distances,
    inf where no path)}, computed a vertex count at a time."""
    by_n = {}
    for k, g in enumerate(graphs):
        by_n.setdefault(len(g[1]), []).append(k)
    out = {}
    for V, ks in by_n.items():
        D = np.full((len(ks), V, V), np.inf)
        D[:, np.arange(V), np.arange(V)] = 0.0
        orders = []
        for b, k in enumerate(ks):
            verts = sorted(graphs[k][1])
            index = {v: i for i, v in enumerate(verts)}
            for u, v in graphs[k][0]:
                if u != v:
                    D[b, index[u], index[v]] = 1.0
            orders.append(verts)
        for m in range(V):
            np.minimum(D, D[:, :, m:m + 1] + D[:, m:m + 1, :], out=D)
        for b, k in enumerate(ks):
            out[k] = (orders[b], D[b])
    return out


def features(graphs):
    """(graph id, feature id) of every ordered pair u != v with a path."""
    first = {}
    lab = [[first.setdefault(g[1][v], len(first)) for v in sorted(g[1])]
           for g in graphs]
    L = max(len(first), 1)
    dist = distances(graphs)
    dmax = max((len(g[1]) for g in graphs), default=1)
    gids, fids = [], []
    for k in range(len(graphs)):
        _, D = dist[k]
        V = D.shape[0]
        ok = np.isfinite(D) & ~np.eye(V, dtype=bool)
        u, v = np.nonzero(ok)
        lu = np.asarray(lab[k], np.int64)
        fids.append((lu[u] * L + lu[v]) * dmax + D[u, v].astype(np.int64))
        gids.append(np.full(u.shape[0], k, np.int64))
    return np.concatenate(gids), np.concatenate(fids)


def gram(graphs, params, device="cpu", dtype=np.float64):
    """The normalized Gram of ``ShortestPath(**params)`` (labeled, unit
    weights), in ``dtype`` (float64, or float32 for the control)."""
    import torch
    if params.get("with_labels", True) is not True:
        raise ValueError("sp_nci1's reference is of the labeled kernel")
    gids, fids = features(graphs)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    K = counts_gram(gids, fids, len(graphs), device, tdt)
    return normalize(K, dtype) if params.get("normalize") else K


def control(graphs, params, device="cpu"):
    """The reference with its exact counts broken as a 16-bit Gram would
    break them: each entry rounded to bfloat16 (exact only to 256)."""
    import torch
    K = torch.from_numpy(gram(graphs, params, device))
    return K.to(torch.bfloat16).double().numpy()
