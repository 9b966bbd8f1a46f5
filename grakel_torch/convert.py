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
  would differ in the last float bits);
* ``"ShortestPath"``: ``{"enum": {label: id}, "graphs": [(n, senders,
  receivers, weights, node_labels), ...]}`` and optionally ``"stream":
  bool`` — the label enumeration and the fit graphs (the fitted state is
  their buckets, parsed again against the enumeration: dense, or their
  COO edges in stream mode; without ``"stream"`` the parse chooses by
  ``_STREAM_BYTES`` as a fit does);
* ``"NeighborhoodHash"``: ``{"labels_hash": {label: int}, "graphs": [(n,
  senders, receivers, weights, node_labels), ...]}`` — the random label
  hash drawn at fit and the fit graphs (their round histograms are
  computed again with that hash);
* ``"WeisfeilerLehmanOptimalAssignment"``: ``{"graphs": [...]}`` — the
  fit graphs (the hierarchy and the credential dicts are rebuilt
  deterministically from them: WL-OA refits);
* ``"HadamardCode"``: ``{"enum": {label: id}, "graphs": [...]}`` — the
  label enumeration and the fit graphs (a base kernel other than
  VertexHistogram is fitted again on their generations);
* ``"Propagation"`` / ``"PropagationAttr"``: ``{"u": [...], "b": [...],
  "hd": [{code: id}, ...], "enum_labels": {label: column},
  "parent_labels": set, "dim": int (PropagationAttr), "X": [{t: (vals,
  cnts)}, ...]}`` and optionally ``"random_state"`` (a
  ``RandomState.get_state()`` tuple) — the projections, offsets and
  bucket dicts drawn at fit, the label columns, the fit bags, and the
  generator's state after fit (a transform with labels unseen at fit
  draws from it);
* ``"OddSth"``: ``{"ha", "hb", "C", "node", "graph", "freq": arrays,
  "ncols": int, "h": int or None}`` — the native engine's big-DAG table
  (the distinct-subtree fingerprint halves and C weights in
  first-appearance order, the (table row, graph column, frequency)
  stream of the fit graphs), the fit graph count and the BFS depth cap;
* ``"NeighborhoodSubgraphPairwiseDistance"``: ``{"levels": {(r, d):
  (rows, cols, counts, width)}, "fit_keys": {(r, d): uint64 keys},
  "norms": {(r, d): f64[n]}, "n": int}`` — the fit graphs' level count
  matrices, each level's sorted (hash A, hash B) key enumeration, each
  level's per-graph squared-count sums and the fit graph count.  The
  keys are native-engine hashes: carry them only into a kernel that
  hashes with the engine too (the default);
* ``"SubgraphMatching"``: ``{"graphs": [(n, senders, receivers, weights,
  node_labels, edge_labels), ...]}`` — the fit graphs (its parameters
  are the constructor's ``params``);
* ``"GraphletSampling"``: ``{"bins": {bin: key}, "bin_of": {key: bin},
  "X": {(graph, bin): count}, "nx": int}`` and optionally
  ``"random_state"`` (a ``RandomState.get_state()`` tuple) — the fit
  bins with their keys (``(s, code)`` for s <= 8, canonical-form
  ``(n, bytes)`` above), the fit counts, the fit graph count, and the
  generator's state after fit (a sampling transform draws from it);
* ``"RandomWalk"`` / ``"RandomWalkLabeled"``: ``{"X": [item, ...]}`` —
  the parsed fit graphs, each a dict of ``"A"`` (f32 [n, n]), ``"n"``,
  ``"labels"`` (RandomWalkLabeled) and the spectral data parse computed:
  ``"s2"`` / ``"mu"``, or ``"mu_max"`` with ``"moments_only"``, or
  ``"u"`` / ``"w"``;
* ``"SvmTheta"`` / ``"LovaszTheta"``: ``{"X": [phi [levels, 1], ...]}``,
  LovaszTheta also ``"d": int`` (the labelling's row count), and
  optionally ``"random_state"`` (a ``RandomState.get_state()`` tuple) —
  the fit graphs' sampled features and the generator's state after fit
  (transform draws its subsets from it);
* ``"GraphHopper"``: ``{"X": [(M [n, D, D], attributes [n, a]) or (M,
  attributes, squared norms [n]), ...], "max_diam": int}`` — the fit
  graphs' hopper tensors and attributes and the fit diameter bound;
* ``"MultiscaleLaplacian"``: ``{"X": [(S_inv [P, P], logdet), ...],
  "data_level": {0: ksi [features, P], l: ({m: (S_inv, logdet)}, Q),
  ...}}`` — the fit graphs' final FLG terms and the per-level bases
  transform replays.
"""

from __future__ import annotations

import numpy as np

from .graph import Graph
from .kernels import (EdgeHistogram, GraphHopper, GraphletSampling,
                      HadamardCode, LovaszTheta, MultiscaleLaplacian,
                      NeighborhoodHash, NeighborhoodSubgraphPairwiseDistance,
                      OddSth, Propagation, PropagationAttr, PyramidMatch,
                      RandomWalk, RandomWalkLabeled, ShortestPath,
                      SubgraphMatching, SvmTheta, VertexHistogram,
                      WeisfeilerLehman, WeisfeilerLehmanOptimalAssignment)

__all__ = ["kernel_from_state"]

_CLASSES = {"VertexHistogram": VertexHistogram,
            "EdgeHistogram": EdgeHistogram,
            "WeisfeilerLehman": WeisfeilerLehman,
            "PyramidMatch": PyramidMatch,
            "ShortestPath": ShortestPath,
            "NeighborhoodHash": NeighborhoodHash,
            "WeisfeilerLehmanOptimalAssignment":
                WeisfeilerLehmanOptimalAssignment,
            "HadamardCode": HadamardCode,
            "Propagation": Propagation,
            "PropagationAttr": PropagationAttr,
            "OddSth": OddSth,
            "NeighborhoodSubgraphPairwiseDistance":
                NeighborhoodSubgraphPairwiseDistance,
            "SubgraphMatching": SubgraphMatching,
            "GraphletSampling": GraphletSampling,
            "RandomWalk": RandomWalk,
            "RandomWalkLabeled": RandomWalkLabeled,
            "SvmTheta": SvmTheta,
            "LovaszTheta": LovaszTheta,
            "GraphHopper": GraphHopper,
            "MultiscaleLaplacian": MultiscaleLaplacian}


def _graphs(items):
    out = []
    for n, s, r, w, nl, *el in items:
        if nl is not None and not isinstance(nl, dict):
            nl = {i: v for i, v in enumerate(np.asarray(nl).tolist())}
        out.append(Graph.from_arrays(n, s, r, w, nl, *el))
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
    elif name in ("WeisfeilerLehman", "WeisfeilerLehmanOptimalAssignment"):
        return k.fit(_graphs(state["graphs"]))
    elif name == "NeighborhoodHash":
        k._labels_hash_dict = dict(state["labels_hash"])
        # parse in transform mode: the carried hash is kept, not redrawn
        k._method_calling = 3
        k.X = k.parse_input(_graphs(state["graphs"]))
    elif name == "HadamardCode":
        k.X = _graphs(state["graphs"])
        k._enum = dict(state["enum"])
        if not k._fast:
            k._host_fit(with_gram=False)
    elif name in ("Propagation", "PropagationAttr"):
        k._u = [np.asarray(u, np.float64) for u in state["u"]]
        k._b = [np.asarray(b, np.float64) if np.ndim(b) else float(b)
                for b in state["b"]]
        k._hd = [dict(h) for h in state["hd"]]
        if name == "PropagationAttr":
            k._dim = int(state["dim"])
        else:
            k._enum_labels = dict(state["enum_labels"])
            k._parent_labels = set(state["parent_labels"])
        k.X = [{t: (np.asarray(v, np.int64), np.asarray(c, np.int64))
                for t, (v, c) in phi.items()} for phi in state["X"]]
        if state.get("random_state") is not None:
            # a generator of its own: never the global one that
            # random_state=None resolves to
            k.random_state_ = np.random.RandomState()
            k.random_state_.set_state(state["random_state"])
    elif name == "OddSth":
        k.h = state["h"]
        k.initialize()
        k.X = {key: np.asarray(state[key]) for key in
               ("ha", "hb", "C", "node", "graph", "freq")}
        k.X["ncols"] = k._nx = int(state["ncols"])
    elif name == "NeighborhoodSubgraphPairwiseDistance":
        k.X = {tuple(key): (np.asarray(r, np.int32), np.asarray(c, np.int32),
                            np.asarray(v, np.float32), int(w))
               for key, (r, c, v, w) in state["levels"].items()}
        k._fit_keys = {tuple(key): np.asarray(v, np.uint64)
                       for key, v in state["fit_keys"].items()}
        k._X_level_norm_factor = {tuple(key): np.asarray(v, np.float64)
                                  for key, v in state["norms"].items()}
        k._ngx = int(state["n"])
    elif name == "SubgraphMatching":
        k.X = k.parse_input(_graphs(state["graphs"]))
    elif name == "GraphletSampling":
        k._graph_bins = dict(state["bins"])
        k._bin_of = dict(state["bin_of"])
        k.X = {tuple(key): int(v) for key, v in state["X"].items()}
        k._nx = int(state["nx"])
        if state.get("random_state") is not None:
            k.random_state_ = np.random.RandomState()
            k.random_state_.set_state(state["random_state"])
    elif name in ("RandomWalk", "RandomWalkLabeled"):
        k.X = [dict(item) for item in state["X"]]
    elif name in ("SvmTheta", "LovaszTheta"):
        k.X = [np.asarray(p, np.float64) for p in state["X"]]
        if name == "LovaszTheta":
            k.d_ = int(state["d"])
        if state.get("random_state") is not None:
            k.random_state_ = np.random.RandomState()
            k.random_state_.set_state(state["random_state"])
    elif name == "GraphHopper":
        k.X = [tuple(np.asarray(a, np.float64) for a in item)
               for item in state["X"]]
        k._max_diam = int(state["max_diam"])
    elif name == "MultiscaleLaplacian":
        k.X = [(np.asarray(S, np.float64), float(ld))
               for S, ld in state["X"]]
        levels = state["data_level"]
        k._data_level = {0: np.asarray(levels[0], np.float64)}
        for lev in range(1, k.L + 1):
            C, Q = levels[lev]
            k._data_level[lev] = (
                {int(m): (np.asarray(S, np.float64), float(ld))
                 for m, (S, ld) in C.items()}, np.asarray(Q, np.float64))
    elif name == "ShortestPath":
        k._enum = dict(state["enum"])
        # parse in transform mode: the carried enumeration is kept and,
        # every label being in it, not extended
        k._method_calling = 3
        k.X = k.parse_input(_graphs(state["graphs"]),
                            stream=state.get("stream"))
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
