"""Carry a fitted kernel's state into the port.

The slice's kernels have no weights: what ``fit`` learns is the label
enumeration and the per-graph features of the fit graphs.
:func:`kernel_from_state` builds a fitted port kernel from that state,
given as plain numpy arrays and dicts (for example read off a fitted
``grakel_tpu`` kernel), so that ``transform`` of new graphs on the port
is comparable with ``transform`` on the kernel the state came from.

State layout, by kernel name:

* ``"VertexHistogram"`` / ``"EdgeHistogram"``:
  ``{"enum": {label: id}, "X": {"n", "gids", "labels", "valid",
  "n_labels"}}`` — the label enumeration and the parsed fit items;
* ``"WeisfeilerLehman"``: ``{"graphs": [(n, senders, receivers, weights,
  node_labels), ...]}`` — the fit graphs (WL refits from them: the fast
  path's fitted state is the graphs themselves, and the general path's
  credential dicts are rebuilt deterministically from them);
* ``"PyramidMatch"``: ``{"labels": {label: id} or None, "sparse_mode":
  bool, "graphs": [(n, senders, receivers, weights, node_labels), ...],
  "embeddings": [U [n, d], ...]}`` — the label enumeration, the path
  chosen at fit, and each fit graph's |top-d eigenvector| embedding
  (which makes the histograms identical even where two eigensolvers
  would differ in the last float bits).
"""

from __future__ import annotations

import numpy as np

from .graph import Graph
from .kernels import (EdgeHistogram, PyramidMatch, VertexHistogram,
                      WeisfeilerLehman)

__all__ = ["kernel_from_state"]

_CLASSES = {"VertexHistogram": VertexHistogram,
            "EdgeHistogram": EdgeHistogram,
            "WeisfeilerLehman": WeisfeilerLehman,
            "PyramidMatch": PyramidMatch}


def _graphs(items):
    out = []
    for n, s, r, w, nl in items:
        if nl is not None and not isinstance(nl, dict):
            nl = {i: v for i, v in enumerate(np.asarray(nl).tolist())}
        out.append(Graph.from_arrays(n, s, r, w, nl))
    return out


def kernel_from_state(name, params, state):
    """A fitted port kernel of class ``name`` built with constructor
    ``params`` from ``state`` (layout in the module docstring)."""
    if name not in _CLASSES:
        raise ValueError("no state carry for kernel %r (known: %s)"
                         % (name, ", ".join(sorted(_CLASSES))))
    k = _CLASSES[name](**params)
    k.initialize()
    if name in ("VertexHistogram", "EdgeHistogram"):
        X = state["X"]
        k._enum = dict(state["enum"])
        k.X = {"n": int(X["n"]),
               "gids": np.asarray(X["gids"], np.int32),
               "labels": np.asarray(X["labels"], np.int32),
               "valid": np.asarray(X["valid"], bool),
               "n_labels": int(X["n_labels"])}
    elif name == "WeisfeilerLehman":
        return k.fit(_graphs(state["graphs"]))
    else:
        graphs = _graphs(state["graphs"])
        ck = "pm_embed_%d" % k.d
        for g, U in zip(graphs, state["embeddings"]):
            g._cache[ck] = np.asarray(U, np.float64)
        labels = state["labels"]
        k._labels = None if labels is None else dict(labels)
        k._sparse_mode = bool(state["sparse_mode"])
        # parse against the carried enumeration (transform mode keeps
        # _labels and _sparse_mode as given; no label is new here)
        k._method_calling = 3
        k.X = k.parse_input(graphs)
    k._method_calling = 1
    k._is_transformed = False
    k._X_diag = None
    return k
