"""Propagation kernels (Neumann et al. 2015).

The counterpart of ``grakel_tpu/kernels/propagation.py``.  Reference
semantics (grakel/kernels/propagation.py):

* per graph: transition matrix T = row-l1-normalized adjacency (or a
  user-supplied T as 4th element / (Graph, T) pair);
* P0 = stacked one-hot label matrix over all graphs [attr variant: raw
  attribute matrix];
* ``t_max`` rounds: LSH bucket ids ``floor((P.u + b)/w)`` with
  u ~ N(0,1) (sqrt(P) first for M='H'), u ~ Cauchy for M='TV'
  [attr: per-dimension ``floor((P*u+b)/w)`` row-tuples, L1/L2];
  per-graph Counter of bucket ids per round; ``P <- T.P`` between
  rounds;
* pairwise k = sum_t metric(Counter_x[t], Counter_y[t]), default dot;
* transform reuses fit's u/b and bucket dicts; graphs with labels unseen
  at fit follow the reference's extension quirks.

Split: the hashing pipeline runs on the host in numpy float64, in the
JAX package's operations and order (its LSH is a ``floor``: another
summation order can move a node across a bucket edge), with its
RandomState draw order; the Gram over the bucket-count features is one
counts-Gram on the kernel's device, keyed by (round, bucket id), over
the keys two or more graphs share (a key one graph alone holds adds its
count squared to that graph's diagonal only).  Counts sum in f32, or
f64 once an entry could pass 2^24.  A custom ``metric`` takes the base
class's host pairwise loop.
"""

from __future__ import annotations

import warnings
from collections import Counter
from numbers import Real

import numpy as np
import torch

from .base import Kernel
from ..estimator import check_random_state
from ..graph import Graph
from ..ops.gram import coo_counts_gram, count_dtype, shared_cols_gram_rect

__all__ = ["Propagation", "PropagationAttr"]


def _dot(x, y):
    return sum(x[k] * y[k] for k in x.keys() & y.keys())


def _row_l1_normalize(T):
    """Row-l1-normalize a dense matrix or a scipy CSR, as
    ``sklearn.preprocessing.normalize(..., 'l1')`` does: zero rows stay
    zero."""
    import scipy.sparse as sp
    if sp.issparse(T):
        T = T.tocsr(copy=True)
        rs = np.asarray(np.abs(T).sum(axis=1)).ravel()
        scale = np.where(rs > 0, 1.0 / np.where(rs > 0, rs, 1.0), 0.0)
        T.data = T.data * np.repeat(scale, np.diff(T.indptr))
        return T
    T = np.asarray(T, dtype=np.float64)
    rs = np.abs(T).sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(rs > 0, T / np.where(rs > 0, rs, 1.0), 0.0)
    return out


def _bag_counter(bag_t):
    """Round entry -> Counter (entries are (vals, cnts) array pairs, or
    Counters on the transform's unseen-label branch)."""
    if isinstance(bag_t, Counter):
        return bag_t
    vals, cnts = bag_t
    return Counter(dict(zip(vals.tolist(), cnts.tolist())))


def _shared(keys):
    """Items whose key another item also carries (numpy bool)."""
    _, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    return cnt[inv.reshape(-1)] > 1


class Propagation(Kernel):
    """Label propagation kernel (M in {'H', 'TV'})."""

    attr_ = False

    def __init__(self, n_jobs=None, verbose=False, normalize=False,
                 random_state=None, metric=_dot, M="TV", t_max=5, w=0.01):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.random_state = random_state
        self.M = M
        self.t_max = t_max
        self.w = w
        self.metric = metric

    def initialize(self):
        valid = ["L1", "L2"] if self.attr_ else ["H", "TV"]
        if not isinstance(self.M, str) or self.M not in valid:
            raise TypeError("Metric type must be a str, one of %s" % valid)
        if not self.attr_:
            self.take_sqrt_ = self.M == "H"
        self.take_cauchy_ = self.M in ("TV", "L1")
        if not isinstance(self.t_max, int) or self.t_max <= 0:
            raise TypeError("The number of iterations must be a "
                            "positive integer.")
        if not isinstance(self.w, Real) or self.w <= 0:
            raise TypeError("The bin width must be a positive number.")
        if not callable(self.metric):
            raise TypeError("The base kernel must be callable.")
        self.random_state_ = check_random_state(self.random_state)

    # ------------------------------------------------------------------ #
    def _parse_graphs(self, X):
        """-> list of (graph, T) with T row-normalized or None."""
        out = []
        for idx, x in enumerate(X):
            T = None
            if isinstance(x, Graph):
                g = x
            elif isinstance(x, (list, tuple)):
                x = list(x)
                if len(x) == 0:
                    warnings.warn("Ignoring empty element on index: "
                                  + str(idx))
                    continue
                if len(x) == 2 and isinstance(x[0], Graph):
                    g, T = x
                else:
                    g = Graph(x[0], x[1] if len(x) > 1 else None, None)
                    if len(x) == 4:
                        T = x[3]
            else:
                g = Graph(x)
            if T is not None:
                T = np.asarray(T)
                if T.shape[0] != T.shape[1]:
                    raise TypeError("Transition matrix on index %d must "
                                    "be a square matrix." % idx)
                if T.shape[0] != g.n:
                    raise TypeError("Propagation matrix must have the same "
                                    "dimension as the number of vertices.")
                T = _row_l1_normalize(T)
            # T is None in the common case: the block-diagonal transition
            # is assembled once in _block_transition
            out.append((g, T))
        if len(out) == 0:
            raise ValueError("Parsed input is empty")
        return out

    @staticmethod
    def _block_transition(graphs, offsets):
        """ONE row-l1-normalized block-diagonal CSR over the whole
        dataset: a round's propagation is one SpMM."""
        import scipy.sparse as sp
        N = int(offsets[-1])
        rows, cols, data = [], [], []
        for k, (g, T) in enumerate(graphs):
            lo = int(offsets[k])
            if T is None:
                rows.append(g.senders.astype(np.int64) + lo)
                cols.append(g.receivers.astype(np.int64) + lo)
                data.append(g.weights.astype(np.float64))
            else:
                Ts = sp.coo_matrix(T)
                rows.append(Ts.row.astype(np.int64) + lo)
                cols.append(Ts.col.astype(np.int64) + lo)
                data.append(Ts.data.astype(np.float64))
        Tb = sp.csr_matrix(
            (np.concatenate(data) if data else np.zeros(0),
             (np.concatenate(rows) if rows else np.zeros(0, np.int64),
              np.concatenate(cols) if cols else np.zeros(0, np.int64))),
            shape=(N, N))
        # user-supplied T blocks arrive normalized; normalizing the block
        # matrix again leaves them and normalizes the adjacency blocks
        return _row_l1_normalize(Tb)

    def _lsh(self, X, u, b):
        if not self.attr_ and self.take_sqrt_:
            X = np.sqrt(X)
        if self.attr_:
            return np.floor((X * u + b) / self.w)
        return np.floor((np.dot(X, u) + b) / self.w)

    # ---------------------------------------------------------------- #
    # The RandomState draw order is the reference's: one randn(width)
    # [and one more under Cauchy] then one b a round at fit, and at
    # transform one randn(#new labels) a round for unseen columns.
    # ---------------------------------------------------------------- #
    def _draw_projection(self, dim):
        u = self.random_state_.randn(dim)
        if self.take_cauchy_:
            u = u / self.random_state_.randn(dim)
        return u

    def _draw_offset(self):
        return self.w * self.random_state_.rand()

    @staticmethod
    def _bag(bags, ids, offsets, t):
        """Per-graph multiset of bucket ids for round ``t``, stored as
        (vals, cnts) int arrays: one composite-key np.unique over all
        nodes."""
        n = len(bags)
        ids = np.asarray(ids, np.int64)
        gid = np.repeat(np.arange(n, dtype=np.int64),
                        np.diff(offsets).astype(np.int64))
        width = int(ids.max()) + 1 if ids.size else 1
        key = gid * width + ids
        uk, cnt = np.unique(key, return_counts=True)
        kg = uk // width
        kv = uk % width
        starts = np.searchsorted(kg, np.arange(n + 1))
        for k in range(n):
            sl = slice(starts[k], starts[k + 1])
            bags[k][t] = (kv[sl], cnt[sl])

    @staticmethod
    def _ids_extending(hd, codes):
        """Bucket ids for scalar hash codes against a fit-time bucket
        dict, assigning fresh ids (in ascending code order) to codes
        missing from it.  Returns ``(ids, next_free_id)``; ``hd`` itself
        is not changed."""
        uniq, inv = np.unique(codes, return_inverse=True)
        lut = np.empty(len(uniq), dtype=np.int64)
        free = len(hd)
        for i, v in enumerate(uniq.tolist()):
            known = hd.get(v)
            if known is None:
                known = free
                free += 1
            lut[i] = known
        return lut[inv.reshape(-1)], free

    def _label_columns(self, graphs):
        """Label -> P-column map; fit defines it, transform extends a
        copy (fresh labels get the trailing columns).  The columns follow
        the iteration order of a ``set`` built by the JAX package's
        operations, in its order: that order picks the projection entry
        each label is drawn against."""
        seen = set()
        per_graph = []
        for g, _ in graphs:
            lab = g.get_labels(label_type="vertex")
            per_graph.append(lab)
            seen |= set(lab.values())
        if self._method_calling in (1, 2):
            self._enum_labels = {l: i for i, l in enumerate(seen)}
            self._parent_labels = seen
            return self._enum_labels, per_graph
        fresh = seen - self._parent_labels
        if not fresh:
            return self._enum_labels, per_graph
        cols = dict(self._enum_labels)
        for l in fresh:
            cols[l] = len(cols)
        return cols, per_graph

    @staticmethod
    def _offsets(graphs):
        offsets = np.zeros(len(graphs) + 1, dtype=np.int64)
        np.cumsum([g.n for g, _ in graphs], out=offsets[1:])
        return offsets

    def parse_input(self, X):
        if not hasattr(X, "__iter__"):
            raise ValueError("input must be an iterable\n")
        graphs = self._parse_graphs(X)
        n = len(graphs)
        offsets = self._offsets(graphs)
        transition = self._block_transition(graphs, offsets)

        col_of, per_graph = self._label_columns(graphs)
        width = len(col_of)
        # per-node label -> column; only the distinct values touch the
        # dict when every label is an integer
        arrs = [g.numeric_node_label_array()
                if g.node_labels and len(g.node_labels) == g.n else None
                for g, _ in graphs]
        if all(a is not None for a in arrs) and offsets[-1]:
            uniq, inv = np.unique(np.concatenate(arrs),
                                  return_inverse=True)
            lut = np.fromiter((col_of[int(u)] for u in uniq), np.intp,
                              len(uniq))
            col_idx = lut[inv.reshape(-1)]
        else:
            col_idx = np.empty(int(offsets[-1]), dtype=np.intp)
            for k, lab in enumerate(per_graph):
                col_idx[offsets[k]:offsets[k + 1]] = [
                    col_of[lab[j]] for j in range(int(offsets[k + 1]
                                                      - offsets[k]))]
        P = np.zeros((int(offsets[-1]), width))
        P[np.arange(len(col_idx)), col_idx] = 1.0

        bags = [dict() for _ in range(n)]
        if self._method_calling in (1, 2):
            self._u, self._b, self._hd = [], [], []
            for t in range(self.t_max):
                self._u.append(self._draw_projection(width))
                self._b.append(self._draw_offset())
                codes = self._lsh(P, self._u[t], self._b[t])
                uniq, ids = np.unique(codes, return_inverse=True)
                self._hd.append({v: i for i, v in enumerate(uniq.tolist())})
                self._bag(bags, ids.reshape(-1), offsets, t)
                if t + 1 < self.t_max:
                    P = transition @ P
            return bags

        dim_orig = len(self._enum_labels)
        if width <= dim_orig:           # every label was seen at fit
            for t in range(self.t_max):
                codes = self._lsh(P, self._u[t], self._b[t])
                ids, _ = self._ids_extending(self._hd[t], codes)
                self._bag(bags, ids, offsets, t)
                if t + 1 < self.t_max:
                    P = transition @ P
            return bags

        # Unseen labels.  The reference splits vertices into "old"
        # (distribution supported on fit columns) and "new"; old vertices
        # hash through the fit projection restricted to the fit columns,
        # new ones through an extended projection whose buckets never
        # merge with fit-time buckets.  Two quirks are kept: the
        # per-graph membership test has an inclusive upper bound (a
        # graph's first vertex also counts into its predecessor), and
        # after each propagation a vertex moves to the "new" side only
        # once ALL its unseen-column mass is strictly positive.
        old = np.flatnonzero(col_idx < dim_orig)
        new = np.flatnonzero(col_idx >= dim_orig)
        n_extra = width - dim_orig
        for t in range(self.t_max):
            codes = self._lsh(P[old][:, :dim_orig], self._u[t], self._b[t])
            ids, free = self._ids_extending(self._hd[t], codes)

            u_ext = np.concatenate([self._u[t],
                                    self._draw_projection(n_extra)])
            codes_new = self._lsh(P[new], u_ext, self._b[t])
            _, inv_new = np.unique(codes_new, return_inverse=True)
            ids_new = free + inv_new.reshape(-1)

            for k in range(n):
                lo, hi = offsets[k], offsets[k + 1]
                bags[k][t] = (
                    Counter(ids[(old >= lo) & (old <= hi)].tolist())
                    + Counter(ids_new[(new >= lo) & (new <= hi)].tolist()))

            if t + 1 < self.t_max:
                P = transition @ P
                saturated = np.all(P[:, dim_orig:] > 0, axis=1)
                old = np.flatnonzero(~saturated)
                new = np.flatnonzero(saturated)
        return bags

    # ------------------------------------------------------------------ #
    @staticmethod
    def _stream(parsed):
        """Bag entries -> (graph id, composite (t, bucket) int64 key,
        count) numpy arrays, one item per graph and key."""
        gl, kl, wl = [], [], []
        for gi, phi in enumerate(parsed):
            for t, bag_t in phi.items():
                if isinstance(bag_t, Counter):
                    vals = np.fromiter(bag_t.keys(), np.int64, len(bag_t))
                    cnts = np.fromiter(bag_t.values(), np.float64,
                                       len(bag_t))
                else:
                    vals, cnts = bag_t
                gl.append(np.full(len(vals), gi, np.int64))
                kl.append(np.asarray(vals, np.int64)
                          + (np.int64(t) << np.int64(40)))
                wl.append(np.asarray(cnts, np.float64))
        if not gl:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float64))
        return np.concatenate(gl), np.concatenate(kl), np.concatenate(wl)

    def _count_dtype(self, *parsed):
        """Width of the count Grams of ``parsed``: a round adds at most
        m_x m_y to an entry, m the items a graph puts into the round's
        bag (n, or n + 1 on the unseen-label branch, whose inclusive bound
        also counts the next graph's first vertex;
        :func:`ops.gram.count_dtype`)."""
        most = max(self._mass(phi) for ps in parsed for phi in ps)
        return count_dtype(self.t_max * most * most)

    @staticmethod
    def _mass(phi):
        """The most items a graph puts into one round's bag."""
        most = 0
        for bag_t in phi.values():
            cnts = (np.fromiter(bag_t.values(), np.int64, len(bag_t))
                    if isinstance(bag_t, Counter) else bag_t[1])
            most = max(most, int(np.sum(cnts)))
        return most

    def _items(self, g, ids, w):
        """(graph ids, key ids, counts, valid) tensors on the kernel's
        device."""
        dev = self._device()
        return (torch.from_numpy(g).to(dev), torch.from_numpy(ids).to(dev),
                torch.from_numpy(w).to(dev),
                torch.ones(len(g), dtype=torch.bool, device=dev))

    def _gram(self, px, py=None):
        if self.metric is not _dot:
            if self.verbose:
                import sys
                print("[%s] custom metric: the O(N^2) host pairwise loop "
                      "(the device counts-Gram serves the default dot "
                      "metric only)" % type(self).__name__, file=sys.stderr)
            return None
        gx, cx, wx = self._stream(px)
        if py is None:
            dt = self._count_dtype(px)
            rep = _shared(cx)
            keys, ids = np.unique(cx[rep], return_inverse=True)
            K = coo_counts_gram(*self._items(gx[rep], ids.reshape(-1),
                                             wx[rep]),
                                len(px), max(len(keys), 1), dtype=dt)
            diag = np.bincount(gx[~rep], weights=wx[~rep] ** 2,
                               minlength=len(px))
            torch.diagonal(K).add_(torch.from_numpy(diag).to(K))
            return K
        # rect: only the keys both sides hold meet in a product
        dt = self._count_dtype(px, py)
        gy, cy, wy = self._stream(py)
        return shared_cols_gram_rect(gy, cy, wy, gx, cx, wx, len(py),
                                     len(px), self._device(), dtype=dt)

    def _diag(self, parsed):
        """Each (graph, key) is one item, so the diagonal is each graph's
        sum of squared counts, summed on the kernel's device."""
        if self.metric is not _dot:
            return None
        g, _, w = self._stream(parsed)
        dt = self._count_dtype(parsed)
        dev = self._device()
        d = torch.zeros(len(parsed), dtype=dt, device=dev)
        return d.index_add_(0, torch.from_numpy(g).to(dev),
                            torch.from_numpy(w).to(dev, dt) ** 2)

    def pairwise_operation(self, x, y):
        return sum(self.metric(_bag_counter(x[t]), _bag_counter(y[t]))
                   for t in range(self.t_max))


class PropagationAttr(Propagation):
    """Attributed propagation kernel (M in {'L1', 'L2'})."""

    attr_ = True

    def __init__(self, n_jobs=None, verbose=False, normalize=False,
                 random_state=None, metric=_dot, M="L1", t_max=5, w=4):
        super().__init__(n_jobs=n_jobs, verbose=verbose, normalize=normalize,
                         random_state=random_state, metric=metric, M=M,
                         t_max=t_max, w=w)

    def _draw_offset(self):
        # per-dimension offset vector (the label variant draws a scalar)
        return self.w * self.random_state_.randn(self._dim)

    def parse_input(self, X):
        if not hasattr(X, "__iter__"):
            raise ValueError("input must be an iterable\n")
        graphs = self._parse_graphs(X)
        n = len(graphs)
        offsets = self._offsets(graphs)
        transition = self._block_transition(graphs, offsets)

        blocks = []
        for g, _ in graphs:
            attr = g.get_labels(label_type="vertex")
            try:
                blocks.append(np.array([attr[j] for j in range(g.n)]))
            except TypeError:
                raise TypeError("All attributes of a single graph should "
                                "have the same dimension.")
        try:
            P = np.vstack(blocks).astype(float)
        except ValueError:
            raise ValueError("Attribute dimensions should be the same, "
                             "for all graphs")
        fitting = self._method_calling in (1, 2)
        if fitting:
            self._dim = P.shape[1]
            self._u, self._b, self._hd = [], [], []
        elif self._dim != P.shape[1]:
            raise ValueError("transform attribute vectors should have "
                             "the same dimension as in fit")

        bags = [dict() for _ in range(n)]
        for t in range(self.t_max):
            if fitting:
                self._u.append(self._draw_projection(self._dim))
                self._b.append(self._draw_offset())
            codes = self._lsh(P, self._u[t], self._b[t])
            # bucket key = the whole per-dimension bin-id row
            uniq, inv = np.unique(codes, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            if fitting:
                self._hd.append({tuple(r): i
                                 for i, r in enumerate(uniq.tolist())})
                ids = inv
            else:
                hd = self._hd[t]
                lut = np.empty(len(uniq), dtype=np.int64)
                free = len(hd)
                for i, r in enumerate(uniq.tolist()):
                    known = hd.get(tuple(r))
                    if known is None:
                        known = free
                        free += 1
                    lut[i] = known
                ids = lut[inv]
            self._bag(bags, ids, offsets, t)
            if t + 1 < self.t_max:
                P = transition @ P
        return bags
