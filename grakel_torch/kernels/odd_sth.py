"""ODD-STh kernel (Da San Martino et al., ordered DAG decomposition).

The counterpart of ``grakel_tpu/kernels/odd_sth.py``.  Reference
semantics (grakel/kernels/odd_sth.py):

* per graph, per vertex v: BFS DAG rooted at v keeping edges to nodes at
  the same-or-deeper BFS level, depth-capped at ``h`` (:333-376);
* inverse topological ordering (Kahn's algorithm, queue sorted by vertex
  label each step) and edge lists sorted by (ordering, label) (:379-457);
* bottom-up subtree canonical IDs ``label(child_id,child_id,...)`` with
  per-node subtree size d and frequency (:460-511);
* all per-vertex DAGs of a graph merge into one DAG keyed by ID, then all
  graphs merge into a *bigDAG* with per-graph frequency vectors
  (:514-608);
* K = phi^T (C * phi) where phi[node, graph] = frequency and C[node] is
  the node's frequency in the first graph that contributed it (the
  reference stores the inserting frequency in position 0 of each bigDAG
  entry, odd_sth.py:604, and reads it back as C at :160-166);
  transform deep-copies the fit bigDAG and appends the new graphs
  (:101-120).

The decomposition runs on the host: the native engine
(``native/src/odd_sth.cpp``, the JAX package's source) for the whole
batch, and the Python decomposition below for labels that cannot be
sorted (and as the engine's plain version in the tests).

The Gram is the exact integer ``K = F diag(C) F^T`` (``F[i, c]`` the
frequency of bigDAG node c in graph i): a column that one graph holds
adds ``C_c F_ic^2`` to that graph's diagonal only
(``ops.gram.split_weighted_singletons``), and the shared columns go
through the rectangular counts-Gram on the kernel's device, items
weighted ``F C`` on one side and ``F`` on the other, f32 while the host's
int64 bound ``max_i sum_c C_c F_ic^2`` stays below 2^24, f64 past it.
(The JAX package streams ``F sqrt(C)`` in f32 and so rounds twice.)
``transform`` multiplies only over the fit columns the new graphs hold
(``ops.gram.shared_cols_gram_rect``): any other column adds zero to
every ``K[i, j]``.  Diagonals are summed on the host in int64, from the
same split in both.

Note: the reference's ``diagonal()`` references a non-existent
``_phi_X`` attribute and crashes on the fit-then-transform path; this
implementation computes the documented quantity instead.
"""

from __future__ import annotations

import copy
import heapq
from collections import defaultdict

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..estimator import NotFittedError
from ..ops.gram import (coo_counts_gram_rect, count_dtype, normalize_gram,
                        shared_cols_gram_rect, split_weighted_singletons)

__all__ = ["OddSth"]


def _bfs_dag(root, nbrs, h):
    """BFS DAG from ``root``: level dict + child lists (reference dag())."""
    q = [(root, 0)]
    level = {root: 0}
    children = defaultdict(list)
    while q:
        u, lev = q.pop(0)
        if lev == h:
            break
        for n in nbrs[u]:
            if n not in level:
                children[u].append(n)
                q.append((n, lev + 1))
                level[n] = lev + 1
            elif level[n] >= lev + 1:
                children[u].append(n)
    return set(level.keys()), children


def _inverse_topological(vertices, children, labels):
    """Kahn's algorithm with the reference's label-sorted queue; returns
    (ordering dict, children with lists sorted by (ordering, label)).

    The reference re-sorts the whole queue by label before every pop
    (stable, so equal labels keep insertion order); a heap keyed by
    (label, insertion counter) pops in exactly that order in O(log k).
    """
    indeg = {}
    zero = set(vertices)
    for u, cs in children.items():
        for v in cs:
            indeg[v] = indeg.get(v, 0) + 1
            zero.discard(v)
    cnt = 0
    q = []
    for x in zero:
        q.append((labels[x], cnt, x))
        cnt += 1
    heapq.heapify(q)
    ordering = {}
    visited = len(vertices)
    while q:
        _, _, e = heapq.heappop(q)
        ordering[e] = visited
        for k in children[e]:
            if k in indeg:
                if indeg[k] == 1:
                    indeg.pop(k)
                    heapq.heappush(q, (labels[k], cnt, k))
                    cnt += 1
                else:
                    indeg[k] -= 1
        visited -= 1
    for u in children:
        children[u].sort(key=lambda x: (ordering[x], labels[x]))
    return ordering, children


def _hash_tree(vertices, children, ordering, labels):
    """Bottom-up subtree IDs; returns ({v: [d, freq, ID]}, {ID: [v...]},
    v_ordered) (reference hash_trees())."""
    v_ordered = sorted(vertices, key=lambda x: (ordering[x], labels[x]))
    hash_map = {}
    info = {}
    for v in v_ordered:
        cs = children.get(v, [])
        if len(cs) == 0:
            ID = str(labels[v])
            info[v] = [0, 1, ID]
        else:
            d = 0
            ids = []
            for c in cs:
                d += 1 + info[c][0]
                ids.append(info[c][2])
            ID = str(labels[v]) + "(" + ",".join(ids) + ")"
            info[v] = [d, 1, ID]
        hash_map.setdefault(ID, []).append(v)
    return info, hash_map, v_ordered


def _merge(dag, acc, merge_features=True, col=None):
    """Merge one DAG into the accumulator keyed by subtree ID
    (reference big_dag_append()); acc = (info, hash_map, edges, labels).

    With ``merge_features`` (within-graph merging) frequencies are plain
    ints.  Without it (the cross-graph bigDAG), each node's frequency is
    a sparse ``{graph column: count}`` dict written at ``col`` — the
    reference densifies a per-graph list instead (odd_sth.py:514-608),
    which is O(nodes x graphs); the dict keeps it O(nnz).
    """
    info, hash_map, v_ordered, children, labels = dag
    if acc is None:
        D_info, D_hash, D_edges, D_labels = {}, {}, {}, {}
    else:
        D_info, D_hash, D_edges, D_labels = acc
    idx = len(D_info)
    for q in v_ordered:
        key = info[q][2]
        if key in D_hash:
            node = D_hash[key][0]
            if merge_features:
                D_info[node][1] += info[q][1]
            else:
                f = D_info[node][1]
                f[col] = f.get(col, 0) + info[q][1]
        else:
            D_labels[idx] = labels[q]
            d_edges = []
            seen = set()
            for c in children.get(q, []):
                ck = info[c][2]
                if ck in D_hash:
                    node = D_hash[ck][0]
                    if node not in seen:
                        d_edges.append(node)
                        seen.add(node)
            D_edges[idx] = d_edges
            D_hash[key] = [idx]
            freq = info[q][1] if merge_features else {col: info[q][1]}
            # position 0 mirrors the reference exactly (odd_sth.py:604):
            # the inserting frequency, NOT the subtree size d from
            # hash_trees — the reference's C weights are the frequency of
            # the subtree in the first graph that contributed it
            D_info[idx] = [info[q][1], freq, key]
            idx += 1
    return (D_info, D_hash, D_edges, D_labels)


def _graph_big_dag(g, h):
    """All per-vertex DAGs of one graph merged, reordered
    (reference make_big_dag())."""
    labs = g.get_labels(label_type="vertex", return_none=True)
    if labs is None:
        raise ValueError("OddSth requires node labels")
    nbrs = [g.neighbors(v) for v in range(g.n)]
    acc = None
    for v in range(g.n):
        vertices, children = _bfs_dag(v, nbrs, h)
        ordering, children = _inverse_topological(vertices, children, labs)
        info, hash_map, v_ordered = _hash_tree(vertices, children,
                                               ordering, labs)
        acc = _merge((info, hash_map, v_ordered, children, labs), acc)
    D_info, D_hash, D_edges, D_labels = acc
    ordering, D_edges = _inverse_topological(
        set(D_info.keys()), D_edges, D_labels)
    v_ordered = sorted(D_info.keys(),
                       key=lambda x: (ordering[x], D_labels[x]))
    return (D_info, D_hash, v_ordered, D_edges, D_labels)


def _stable_label_id(l):
    """Stable (cross-process) 64-bit identity of a node label for the
    native fingerprint engine: integral values map to themselves, other
    labels to an FNV-1a of their string form with the top bit set."""
    if isinstance(l, (int, np.integer)) or (
            isinstance(l, (float, np.floating)) and float(l).is_integer()):
        u = int(l) & 0xFFFFFFFFFFFFFFFF
    else:
        u = 0xCBF29CE484222325
        for b in str(l).encode("utf-8", "surrogatepass"):
            u = ((u ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        u |= 1 << 63
    return u - (1 << 64) if u >= (1 << 63) else u


def _split(g, c, f, C, n):
    """The weighted split of ``F diag(C) F^T`` over items ``(g, c, f)``
    (duplicate (graph, column) items summed): the shared columns' items
    (graph ids, dense column ids, frequencies, frequencies times C), the
    singleton columns' part of the diagonal, and the whole diagonal
    ``sum_c C_c F_ic^2``, both int64."""
    gs, ks, fs, shared, single = split_weighted_singletons(g, c, f, n, C)
    fc = fs * C[shared][ks]
    diag = single.copy()
    np.add.at(diag, gs, fc * fs)
    return gs, ks, fs, fc, single, diag


class OddSth(Kernel):
    """ODD-STh kernel."""

    def __init__(self, n_jobs=None, normalize=False, verbose=False, h=None):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.h = h

    def initialize(self):
        if self.h is not None and (not isinstance(self.h, int)
                                   or self.h <= 0):
            raise ValueError("h must be an integer bigger than zero")
        self.h_ = -1 if self.h is None else self.h

    # ---------------------------------------------------------------- #
    # native path: the whole batch decomposition (BFS DAGs, Kahn
    # ordering, subtree fingerprints, per-graph merge) runs in C++
    # (native/src/odd_sth.cpp); the big-DAG state is plain arrays.
    # ---------------------------------------------------------------- #
    def _decompose_native(self, graphs):
        """The native decomposition of ``graphs``, or None when their
        labels cannot be sorted (the Python decomposition's case)."""
        from ..native import odd_sth_decompose_native
        per_graph = []
        for g in graphs:
            labs = g.get_labels(label_type="vertex", return_none=True)
            if labs is None:
                raise ValueError("OddSth requires node labels")
            per_graph.append([labs[v] for v in range(g.n)])
        flat = [l for ls in per_graph for l in ls]
        try:
            distinct = sorted(set(flat))
        except TypeError:   # unsortable/unhashable labels -> python path
            return None
        code_of = {l: i for i, l in enumerate(distinct)}
        id_of = {l: _stable_label_id(l) for l in distinct}
        codes = np.fromiter((code_of[l] for l in flat), np.int64,
                            len(flat))
        ids = np.fromiter((id_of[l] for l in flat), np.int64, len(flat))
        node_off = np.zeros(len(graphs) + 1, np.int64)
        np.cumsum([g.n for g in graphs], out=node_off[1:])
        adj_parts, deg_parts = [], []
        for g in graphs:
            s = np.asarray(g.senders)
            # neighbor order must match Graph.neighbors (edge order)
            order = np.argsort(s, kind="stable")
            adj_parts.append(np.asarray(g.receivers)[order]
                             .astype(np.int32))
            deg_parts.append(np.bincount(s, minlength=g.n)
                             .astype(np.int64))
        adj = (np.concatenate(adj_parts) if adj_parts
               else np.zeros(0, np.int32))
        degs = (np.concatenate(deg_parts) if deg_parts
                else np.zeros(0, np.int64))
        adj_off = np.zeros(len(degs) + 1, np.int64)
        np.cumsum(degs, out=adj_off[1:])
        ha, hb, C, node, graph, freq = odd_sth_decompose_native(
            node_off, adj_off, adj, codes, ids, self.h_)
        return {"ha": ha, "hb": hb, "C": C, "node": node, "graph": graph,
                "freq": freq, "ncols": len(graphs)}

    @staticmethod
    def _merge_native(fit, y):
        """Append a transform batch to the fit big-DAG table: matched
        fingerprints reuse fit rows (and fit C weights); fresh ones get
        new rows in the transform batch's first-appearance order, C =
        their frequency in the first transform graph containing them —
        exactly the reference's deep-copy-and-append semantics
        (reference odd_sth.py:101-120).  Equal fingerprints are grouped
        by one ``lexsort`` of the two halves (the JAX package's
        ``np.unique(axis=0)`` sorts rows as bytes, several times slower;
        only the grouping is used, so the table is the same)."""
        Df = len(fit["ha"])
        ha = np.concatenate([fit["ha"], y["ha"]])
        hb = np.concatenate([fit["hb"], y["hb"]])
        order = np.lexsort((hb, ha))
        a, b = ha[order], hb[order]
        new = np.r_[True, (a[1:] != a[:-1]) | (b[1:] != b[:-1])]
        inv = np.empty(len(order), np.int64)
        inv[order] = np.cumsum(new) - 1
        lut = np.full(inv.max() + 1 if len(inv) else 1, -1, np.int64)
        lut[inv[:Df]] = np.arange(Df)
        y_row = lut[inv[Df:]]
        fresh = y_row < 0
        y_row = np.where(fresh, Df + np.cumsum(fresh) - 1, y_row)
        return {
            "ha": np.concatenate([fit["ha"], y["ha"][fresh]]),
            "hb": np.concatenate([fit["hb"], y["hb"][fresh]]),
            "C": np.concatenate([fit["C"], y["C"][fresh]]),
            "node": np.concatenate([fit["node"].astype(np.int64),
                                    y_row[y["node"]]]),
            "graph": np.concatenate([fit["graph"].astype(np.int64),
                                     y["graph"] + fit["ncols"]]),
            "freq": np.concatenate([fit["freq"], y["freq"]]),
            "ncols": fit["ncols"] + y["ncols"],
        }

    def parse_input(self, X):
        graphs = normalize_input(X)
        fit_native = (self._method_calling != 3
                      or isinstance(self.X, dict))
        native = self._decompose_native(graphs) if fit_native else None
        if native is not None:
            if self._method_calling == 3:
                merged = self._merge_native(self.X, native)
                self._ny = len(graphs)
                return merged
            self._nx = len(graphs)
            return native
        if self._method_calling == 3 and isinstance(self.X, dict):
            raise RuntimeError(
                "OddSth was fitted with the native decomposition engine "
                "but its transform input has labels that cannot be "
                "sorted (the Python decomposition's case); refit with "
                "matching inputs")
        if self._method_calling == 3:
            out = copy.deepcopy(self.X)
            col0 = self._nx
        else:
            out = None
            col0 = 0
        for ci, g in enumerate(graphs):
            out = _merge(_graph_big_dag(g, self.h_), out,
                         merge_features=False, col=col0 + ci)
        if self._method_calling in (1, 2):
            self._nx = len(graphs)
        else:
            self._ny = len(graphs)
        return out

    # ------------------------------------------------------------------ #
    @staticmethod
    def _items(state, lo, hi):
        """The integer COO stream of graph columns ``[lo, hi)``:
        ``(graph - lo, bigDAG node, frequency)`` int64 arrays, and the C
        weight of every bigDAG node (int64), from either state form."""
        if isinstance(state, dict):
            cols = state["graph"]
            sel = (cols >= lo) & (cols < hi)
            return ((cols[sel] - lo).astype(np.int64),
                    state["node"][sel].astype(np.int64),
                    state["freq"][sel].astype(np.int64),
                    np.asarray(state["C"], np.int64))
        D_info = state[0]
        g, k, f = [], [], []
        for i, v in enumerate(D_info.keys()):
            for j, fr in D_info[v][1].items():
                if lo <= j < hi and fr:
                    g.append(j - lo)
                    k.append(i)
                    f.append(fr)
        C = np.fromiter((D_info[v][0] for v in D_info), np.int64,
                        len(D_info))
        return (np.asarray(g, np.int64), np.asarray(k, np.int64),
                np.asarray(f, np.int64), C)

    def _gram_sym(self, g, k, f, C, n):
        """``F diag(C) F^T`` of the fit graphs on the kernel's device;
        returns (K f64 numpy, exact int64 diagonal)."""
        gs, ks, fs, fc, single, diag = _split(g, k, f, C, n)
        gt = torch.from_numpy(gs).to(self._device())
        K = coo_counts_gram_rect(gt, ks, fc.astype(np.float64), True, gt,
                                 ks, fs.astype(np.float64), True, n, n,
                                 int(ks.max(initial=0)) + 1,
                                 dtype=count_dtype(int(diag.max(initial=0))))
        K.diagonal().add_(torch.from_numpy(single).to(K))
        return K.cpu().numpy().astype(np.float64), diag

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self.fit(X)
        with self.timer_.stage("gram"):
            g, k, f, C = self._items(self.X, 0, self._nx)
            km, diag = self._gram_sym(g, k, f, C, self._nx)
        self._X_diag = diag.astype(np.float64)
        self._report_stages()
        if self.normalize:
            return normalize_gram(km, self._X_diag, self._X_diag)
        return km

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        if not hasattr(self, "timer_"):    # a kernel built from a state
            from ..profiling import StageTimer
            self.timer_ = StageTimer()
        with self.timer_.stage("parse_y"):
            full = self.parse_input(X)
        with self.timer_.stage("gram_y"):
            gx, kx, fx, C = self._items(full, 0, self._nx)
            gy, ky, fy, _ = self._items(full, self._nx, self._nx + self._ny)
            dx = _split(gx, kx, fx, C, self._nx)[-1]
            dy = _split(gy, ky, fy, C, self._ny)[-1]
            bound = int(max(dx.max(initial=0), dy.max(initial=0)))
            km = shared_cols_gram_rect(
                gy, ky, (fy * C[ky]).astype(np.float64), gx, kx,
                fx.astype(np.float64), self._ny, self._nx, self._device(),
                dtype=count_dtype(bound)).cpu().numpy().astype(np.float64)
        self._X_diag = dx.astype(np.float64)
        self._Y_diag_cache = dy.astype(np.float64)
        self._is_transformed = True
        self._report_stages()
        if self.normalize:
            km = normalize_gram(km, self._Y_diag_cache, self._X_diag)
        return km

    def diagonal(self):
        if getattr(self, "_X_diag", None) is None:
            raise NotFittedError("call fit_transform or transform first")
        if getattr(self, "_is_transformed", False):
            return self._X_diag, self._Y_diag_cache
        return self._X_diag
