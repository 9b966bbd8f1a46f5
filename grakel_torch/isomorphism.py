"""General graph canonicalization and isomorphism testing.

The counterpart of ``grakel_tpu/isomorphism.py`` (the reference's vendored
bliss surface, ``Graph.canonical_labeling`` / ``Graph.isomorphic``): an
individualization-refinement search in the port's native engine
(``native/src/canonical.cpp``, :func:`grakel_torch.native.
canonical_labeling_native`), which raises when it cannot be built.
:func:`_canonical_py` (with :func:`_refine` and :func:`_leaf_cert`) is
the same algorithm in Python, the plain engine the tests hold the native
one against.

The canonical form returned by :func:`canonical_form` is EXACT (initial
colors in canonical order + permuted adjacency bitmap), so two graphs
are isomorphic (respecting colors) iff their canonical forms are equal
bytes: no hash collisions, no pairwise VF2 calls.
"""

from __future__ import annotations

import numpy as np

from .native import canonical_labeling_native

__all__ = ["canonical_labeling", "canonical_form", "is_isomorphic"]


def _as_edges(A):
    A = np.asarray(A)
    src, dst = np.nonzero(A)
    return A.shape[0], src.astype(np.int32), dst.astype(np.int32)


def _rank_colors(colors, n):
    if colors is None:
        return np.zeros(n, np.int32)
    vals = [colors[i] if isinstance(colors, dict) else colors[i]
            for i in range(n)]
    uniq = sorted(set(map(str, vals)))
    idx = {u: i for i, u in enumerate(uniq)}
    return np.array([idx[str(v)] for v in vals], np.int32)


# ------------------------------------------------------------------ #
# the plain engine: the algorithm of native/src/canonical.cpp
def _refine(c, out_nb, in_nb, directed):
    n = len(c)
    ncolors = max(c) + 1 if n else 0
    while True:
        keys = []
        for v in range(n):
            k = (c[v], tuple(sorted(c[u] for u in out_nb[v])))
            if directed:
                k += (tuple(sorted(c[u] for u in in_nb[v])),)
            keys.append(k)
        order = sorted(range(n), key=lambda v: keys[v])
        nc = [0] * n
        rank = 0
        for i, v in enumerate(order):
            if i and keys[v] != keys[order[i - 1]]:
                rank += 1
            nc[v] = rank
        c = nc
        if rank + 1 == ncolors:
            return c
        ncolors = rank + 1


def _leaf_cert(c, n, out_nb, init_color):
    at = [0] * n
    for v in range(n):
        at[c[v]] = v
    bits = bytearray((n * n + 7) // 8)
    for v in range(n):
        for u in out_nb[v]:
            b = c[v] * n + c[u]
            bits[b >> 3] |= 1 << (b & 7)
    head = b"".join(int(init_color[at[p]]).to_bytes(4, "big")
                    for p in range(n))
    return head + bytes(bits)


def _canonical_py(n, src, dst, colors, directed):
    out_nb = [set() for _ in range(n)]
    in_nb = [set() for _ in range(n)]
    for s, d in zip(src.tolist(), dst.tolist()):
        out_nb[s].add(d)
        in_nb[d].add(s)
    out_nb = [sorted(s) for s in out_nb]
    in_nb = [sorted(s) for s in in_nb]
    state = {"path": [], "cert": None, "perm": None}

    def search(c, depth):
        c = _refine(c, out_nb, in_nb, directed)
        ncolors = max(c) + 1
        ni = hash((ncolors, tuple(c)))
        path = state["path"]
        if depth < len(path):
            if ni < path[depth]:
                return
            if ni > path[depth]:
                del path[depth:]
                path.append(ni)
                state["cert"] = None
        else:
            path.append(ni)
        if ncolors == n:
            cert = _leaf_cert(c, n, out_nb, colors)
            if state["cert"] is None or cert > state["cert"]:
                state["cert"] = cert
                state["perm"] = list(c)
            return
        count = [0] * ncolors
        for v in range(n):
            count[c[v]] += 1
        target = min((cnt, col) for col, cnt in enumerate(count)
                     if cnt > 1)[1]
        for v in range(n):
            if c[v] != target:
                continue
            c2 = [x + 1 if x >= target else x for x in c]
            c2[v] = target
            search(c2, depth + 1)

    if n == 0:
        return np.zeros(0, np.int32)
    search(list(colors), 0)
    return np.asarray(state["perm"], np.int32)


# ------------------------------------------------------------------ #
def canonical_labeling(A, colors=None, directed=False):
    """Canonical positions per vertex for adjacency matrix ``A``.

    ``perm[v]`` is the position of vertex ``v`` in the canonical order;
    relabeling any isomorphic (color-respecting) copy of the graph by
    its own ``perm`` yields identical adjacency.  Matches the surface of
    the reference's ``bliss.Graph.canonical_labeling``
    (bliss.pyx:313-335).
    """
    n, src, dst = _as_edges(A)
    cols = _rank_colors(colors, n)
    return canonical_labeling_native(n, src, dst, cols, directed)


def canonical_form(A, colors=None, directed=False):
    """Exact canonical-form bytes: ``(n, colors-in-canonical-order +
    permuted adjacency bitmap)``.  Equal bytes <=> isomorphic."""
    A = np.asarray(A)
    n = A.shape[0]
    perm = canonical_labeling(A, colors=colors, directed=directed)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    cols = _rank_colors(colors, n)[inv]
    P = (A[np.ix_(inv, inv)] != 0)
    bits = np.packbits(P.reshape(-1)) if n else np.zeros(0, np.uint8)
    return (n, cols.tobytes() + bits.tobytes())


def is_isomorphic(A1, A2, colors1=None, colors2=None, directed=False):
    """Color-respecting isomorphism test via canonical forms (reference
    bliss.pyx:337-358 ``Graph.isomorphic``)."""
    A1, A2 = np.asarray(A1), np.asarray(A2)
    if A1.shape != A2.shape:
        return False
    n = A1.shape[0]
    # colors must be ranked over the UNION of both graphs' label values
    if colors1 is None and colors2 is None:
        c1 = c2 = None
    else:
        v1 = ["" if colors1 is None else str(colors1[i]) for i in range(n)]
        v2 = ["" if colors2 is None else str(colors2[i]) for i in range(n)]
        idx = {u: i for i, u in enumerate(sorted(set(v1) | set(v2)))}
        c1 = np.array([idx[v] for v in v1], np.int32)
        c2 = np.array([idx[v] for v in v2], np.int32)
    return canonical_form(A1, c1, directed) == canonical_form(A2, c2,
                                                              directed)
