"""Interop utilities: a precomputed-kernel pipeline transformer and
converters from networkx / pandas / csv / torch-geometric into
grakel_torch graph inputs.

The counterpart of ``grakel_tpu/utils.py`` (API parity with the
reference ``grakel.utils``, utils.py:26-801), without scikit-learn:
:class:`KMTransformer` stands on :mod:`grakel_torch.estimator`, and a
scikit-learn ``Bunch`` is read through its ``mat`` attribute by duck
typing.  ``networkx`` and ``pandas`` are imported by the converters
that read them, never at module import.

Not ported: ``cross_validate_Kfold_SVM`` (it is built on scikit-learn's
``SVC``, ``KFold`` and scorers).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .estimator import BaseEstimator, NotFittedError
from .graph import Graph

__all__ = ["KMTransformer", "graph_from_networkx", "graph_from_pandas",
           "graph_from_csv", "graph_from_torch_geometric"]


def _valid_matrix(K, transform=False):
    try:
        if hasattr(K, "toarray"):
            K = K.toarray()
        M = np.asarray(K, dtype=float)
        ok = M.ndim == 2
    except Exception:
        ok, M = False, None
    return (ok, M) if transform else ok


class KMTransformer(BaseEstimator):
    """Index into a precomputed kernel matrix inside sklearn-style
    pipelines (reference utils.py:26-141): ``fit(idx)`` keeps the row
    indices, ``fit_transform(idx)`` returns ``K[idx][:, idx]`` and
    ``transform(idx2)`` ``K[idx2][:, idx]``."""

    def __init__(self, K=None):
        self.K = K
        self._initialized = {"K": False}

    def initialize(self):
        if not self._initialized["K"]:
            if self.K is None:
                M = np.array([[1.0]])
            else:
                K = self.K
                if isinstance(K, dict) or hasattr(K, "mat"):
                    # a scikit-learn Bunch (a dict with attribute access)
                    try:
                        K = K.mat
                    except AttributeError:
                        raise ValueError(
                            "If in an sklearn Bunch K must be under mat")
                flag, M = _valid_matrix(K, transform=True)
                if not flag:
                    raise ValueError("The provided K cannot be converted "
                                     "to a two dimensional np.array.")
            self.K_ = M
            self._initialized["K"] = True

    def _check_indices(self, X):
        if any(x < 0 or x > self.K_.shape[0] for x in X):
            raise ValueError("index out of bounds of the kernel matrix")

    def fit(self, X, y=None):
        self.initialize()
        self._check_indices(X)
        self.X = np.array(X)
        return self

    def fit_transform(self, X, y=None):
        self.fit(X)
        return self.K_[self.X, :][:, self.X]

    def transform(self, X):
        if not hasattr(self, "X"):
            raise NotFittedError("This KMTransformer instance is not "
                                 "fitted yet; call fit first")
        self._check_indices(X)
        return self.K_[X, :][:, self.X]

    def set_params(self, **params):
        super().set_params(**params)
        self._initialized["K"] = False
        return self


# --------------------------------------------------------------------- #
def graph_from_networkx(X, node_labels_tag=None, edge_labels_tag=None,
                        edge_weight_tag=None, as_Graph=False,
                        val_node_labels=None, val_edge_labels=None):
    """networkx graphs -> grakel_torch inputs (generator; reference
    utils.py:233-360, networkx >= 2 semantics)."""
    if not hasattr(X, "__iter__"):
        raise ValueError("X must be an iterable")
    for G in X:
        graph_object = {}
        nl = ({} if (node_labels_tag is not None
                     or val_node_labels is not None) else None)
        el = ({} if (edge_labels_tag is not None
                     or val_edge_labels is not None) else None)
        for u in G.nodes():
            graph_object[u] = {}
            if node_labels_tag is not None:
                nl[u] = G.nodes[u][node_labels_tag]
            elif val_node_labels is not None:
                nl[u] = val_node_labels
            for v in G.neighbors(u):
                if edge_weight_tag is not None:
                    graph_object[u][v] = G.edges[(u, v)][edge_weight_tag]
                else:
                    graph_object[u][v] = 1.0
                if edge_labels_tag is not None:
                    el[(u, v)] = G.edges[(u, v)][edge_labels_tag]
                elif val_edge_labels is not None:
                    el[(u, v)] = val_edge_labels
        if as_Graph:
            yield Graph(graph_object, nl, el)
        else:
            yield [graph_object, nl, el]


def graph_from_pandas(edge_df, node_df=None, directed=False,
                      as_Graph=False):
    """pandas edge/node DataFrames -> {graph_id: input} dict
    (reference utils.py:362-519).

    edge_df = (DataFrame, graph_col, (src_col, dst_col), weight_col|None,
    label_col | [attr_cols] | None); node_df = (DataFrame, graph_col,
    label_col | [attr_cols] | None) with node id = row index."""
    from pandas import DataFrame

    graphs = defaultdict(lambda: {"graph": defaultdict(dict),
                                  "node_label": None, "edge_label": None})
    known_nodes = node_df is not None
    if known_nodes:
        if not (isinstance(node_df, tuple) and len(node_df) == 3
                and isinstance(node_df[0], DataFrame)):
            raise ValueError("node_df must be (DataFrame, graph_col, "
                             "labels_col|attr_cols|None)")
        df, gtag, labs = node_df
        for index, row in df.iterrows():
            g = graphs[row[gtag]]
            g["graph"][index] = {}
            if labs is not None:
                if g["node_label"] is None:
                    g["node_label"] = {}
                if isinstance(labs, list):
                    g["node_label"][index] = np.array(
                        [row[c] for c in labs])
                else:
                    g["node_label"][index] = row[labs]

    if not (isinstance(edge_df, tuple) and len(edge_df) == 5
            and isinstance(edge_df[0], DataFrame)
            and isinstance(edge_df[2], tuple) and len(edge_df[2]) == 2):
        raise ValueError("edge_df must be (DataFrame, graph_col, "
                         "(src, dst), weight_col|None, "
                         "labels_col|attr_cols|None)")
    df, gtag, (src_c, dst_c), w_c, labs = edge_df
    for index, row in df.iterrows():
        gidx = row[gtag]
        if known_nodes and gidx not in graphs:
            raise ValueError("graph index %r missing from node_df" % gidx)
        g = graphs[gidx]
        src, dst = row[src_c], row[dst_c]
        w = row[w_c] if w_c is not None else 1.0
        g["graph"][src][dst] = w
        if not directed:
            g["graph"][dst][src] = w
        if labs is not None:
            if g["edge_label"] is None:
                g["edge_label"] = {}
            lab = (np.array([row[c] for c in labs])
                   if isinstance(labs, list) else row[labs])
            g["edge_label"][(src, dst)] = lab
            if not directed:
                g["edge_label"][(dst, src)] = lab

    out = {}
    for gidx, g in graphs.items():
        item = [dict(g["graph"]), g["node_label"], g["edge_label"]]
        out[gidx] = Graph(*item) if as_Graph else item
    return out


def graph_from_csv(edge_files, node_files=None, index_type=str,
                   directed=False, sep=",", as_Graph=False):
    """csv files (one graph per file) -> generator of inputs
    (reference utils.py:522-696).

    edge_files = (iter(path), weight_flag, attributes_flag);
    node_files = (iter(path), attributes_flag) or None."""
    if not isinstance(index_type, type):
        raise ValueError("index_type must be a class `type` object")
    if not (isinstance(edge_files, tuple) and len(edge_files) == 3):
        raise ValueError("edge_files must be (iterable of paths, "
                         "weight_flag, attributes_flag)")
    efiles, weight_flag, e_attr_flag = edge_files
    if node_files is not None:
        nfiles, n_attr_flag = node_files
        nfiles = list(nfiles)
    else:
        nfiles = None

    for i, epath in enumerate(efiles):
        ed = defaultdict(dict)
        el = {} if e_attr_flag is not None else None
        with open(epath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(sep)
                u, v = index_type(parts[0]), index_type(parts[1])
                pos = 2
                w = 1.0
                if weight_flag:
                    w = float(parts[pos])
                    pos += 1
                ed[u][v] = w
                if not directed:
                    ed[v][u] = w
                if e_attr_flag is True:
                    lab = np.array([float(x) for x in parts[pos:]])
                elif e_attr_flag is False:
                    lab = parts[pos]
                else:
                    lab = None
                if lab is not None:
                    el[(u, v)] = lab
                    if not directed:
                        el[(v, u)] = lab
        nl = None
        if nfiles is not None:
            nl = {}
            with open(nfiles[i]) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split(sep)
                    u = index_type(parts[0])
                    ed.setdefault(u, {})
                    if n_attr_flag is True:
                        nl[u] = np.array([float(x) for x in parts[1:]])
                    elif n_attr_flag is False:
                        nl[u] = parts[1]
        item = [dict(ed), nl, el]
        yield Graph(*item) if as_Graph else item


def _tensor_rows(mat, decode_one_hot):
    """torch feature tensor (any device) -> list of per-row labels:
    argmax ints when the rows are one-hot codes, raw numpy vectors
    otherwise."""
    arr = mat.detach().cpu().numpy()
    if decode_one_hot:
        return arr.argmax(axis=1).tolist()
    return list(arr)


def graph_from_torch_geometric(data, node_one_hot=False,
                               edge_one_hot=False, ignore_y=False):
    """torch_geometric ``Data`` / batched ``Batch`` -> grakel_torch input.

    Capability parity with reference utils.py:699-801: a single ``Data``
    yields ``{"graph": Graph, "y": int}``; a batched object is split back
    into its member graphs via the ``batch`` vector and yields
    ``{"graph": [Graph, ...], "y": [int, ...]}`` (node ids stay in the
    batch-global index space).  ``node_one_hot`` / ``edge_one_hot``
    decode one-hot feature rows to integer labels; otherwise features
    pass through as numpy attribute vectors.  Only attribute access is
    required of ``data``, so any namespace with the right fields works;
    its tensors may lie on any device (they are read to the host).
    """
    ei = data.edge_index.detach().cpu().numpy()
    pairs = [(int(u), int(v)) for u, v in zip(ei[0], ei[1])]
    x_feat = getattr(data, "x", None)
    e_feat = getattr(data, "edge_attr", None)
    node_vals = (_tensor_rows(x_feat, node_one_hot)
                 if x_feat is not None else None)
    edge_vals = (_tensor_rows(e_feat, edge_one_hot)
                 if e_feat is not None else None)
    y = getattr(data, "y", None)

    membership = getattr(data, "batch", None)
    if membership is None:
        node_labels = (dict(enumerate(node_vals))
                       if node_vals is not None else {})
        edge_labels = (dict(zip(pairs, edge_vals))
                       if edge_vals is not None else {})
        out = {"graph": Graph(pairs, node_labels, edge_labels)}
        if not ignore_y and y is not None:
            out["y"] = int(y.item())
        return out

    member = membership.detach().cpu().numpy().astype(np.int64)
    src_g, dst_g = member[ei[0]], member[ei[1]]
    crossing = np.flatnonzero(src_g != dst_g)
    if crossing.size:
        u, v = pairs[int(crossing[0])]
        raise ValueError("edge (%d, %d) connects vertices of two "
                         "different graphs" % (u, v))
    out = defaultdict(list)
    for gid in np.unique(member).tolist():
        e_rows = np.flatnonzero(src_g == gid)
        g_pairs = [pairs[i] for i in e_rows]
        nl = el = None
        if node_vals is not None:
            nl = {int(v): node_vals[v]
                  for v in np.flatnonzero(member == gid)}
        if edge_vals is not None:
            el = {pairs[i]: edge_vals[i] for i in e_rows}
        out["graph"].append(Graph(g_pairs, nl, el))
        if not ignore_y and y is not None:
            out["y"].append(int(y[gid].item()))
    return out
