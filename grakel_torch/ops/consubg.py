"""Enumeration of all connected k-vertex subsets of a graph.

The counterpart of ``grakel_tpu/ops/consubg.py`` (the reference's ConSubg,
Karakashian 2013): given ``G`` as {vertex: set of neighbors}, the set of
all vertex subsets of size k that induce a connected subgraph, each
emitted once.  The enumeration is combinatorial backtracking with no
tensor shape, so it runs on the host in the port's native ESU engine
(``native/src/consubg.cpp``, :func:`grakel_torch.native.
connected_subsets_native`), which raises when it cannot be built.
:func:`connected_subsets_plain` is the Python anchored-extension
enumeration the tests hold the engine against.
"""

from __future__ import annotations

__all__ = ["connected_subsets", "connected_subsets_plain"]


def connected_subsets(G, k):
    """All connected k-subsets of ``G`` ({v: set(neighbors)}), as a set
    of frozensets, from the native engine."""
    from ..native import connected_subsets_native
    return connected_subsets_native(G, k)


def connected_subsets_plain(G, k):
    """The same set from the Python enumeration (anchored extension with
    forbidden sets)."""
    out = set()
    if k <= 0:
        return out
    for anchor in G:
        _extend(G, k, {anchor},
                {v for v in G[anchor] if v != anchor}, {anchor}, out)
    return out


def _extend(G, k, sub, ext, forbidden, out):
    if len(sub) == k:
        out.add(frozenset(sub))
        return
    ext = list(ext)
    while ext:
        v = ext.pop()
        forbidden = forbidden | {v}
        new_ext = set(ext)
        for w in G[v]:
            if w not in sub and w not in forbidden:
                new_ext.add(w)
        _extend(G, k, sub | {v}, new_ext, forbidden, out)
