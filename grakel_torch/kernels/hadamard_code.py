"""Hadamard code kernel framework (Kataoka & Inokuchi 2016).

The counterpart of ``grakel_tpu/kernels/hadamard_code.py``.  Reference
semantics (grakel/kernels/hadamard_code.py:107-260):

* initial label(v) = row ``enum[l(v)]`` of the Hadamard matrix
  H(2^ceil(log2(#labels)));
* iteration: new(v) = old(v) + sum over out-neighbours old(q) (vector
  addition);
* ``n_iter`` generations in all (the initial one and n_iter - 1
  refinements), each fed as tuple-valued node labels to one base-kernel
  instance (default VertexHistogram); K = sum over generations;
* transform extends the label enumeration on a copy; if that crosses a
  power of two, H grows and transform-time code tuples can never equal
  fit-time ones (they differ in length): the code dimension is part of
  each row's hash, with the fit graphs' rows tagged with the fit
  dimension and zero-padded to the larger one.

Two execution paths:

* **fast path** (base kernel VertexHistogram without parameters): the
  initial codes go to the kernel's device as a row index a node into a
  small table of Hadamard rows, and one call of
  ``ops/hadamard.hadamard_generations`` gives every generation's keys
  (on the card the hand kernel K6, one launch for the graphs that fit a
  block's shared memory: the neighbour sums and the row hash of each
  node, K2's int64 compaction key); then, a generation at a time,
  ``torch.unique`` compaction and the counts-Gram, over the repeated
  codes only, singletons folded into the diagonal as on WL's fast
  path.  Counts sum in f32, or f64 once an entry could pass 2^24
  (an entry is at most n_iter max_n^2).
* **host path** (any other base kernel): the generation loop with tuple
  labels, one base-kernel instance a generation, dispatched through
  :func:`parallel_sum`.
"""

from __future__ import annotations

from math import ceil, log2

import numpy as np
import torch
from scipy.linalg import hadamard

from .base import (Kernel, _diagonal_of, _to_numpy, normalize_input,
                   parallel_sum)
from .histogram import VertexHistogram
from ..batch import GraphBatch
from ..estimator import NotFittedError
from ..graph import Graph
from ..ops import wl as wl_ops
from ..ops.gram import (chunk_plan, chunked_counts_gram_raw,
                        coo_counts_gram_rect, count_dtype, counts_diag,
                        normalize_gram)
from ..ops.hadamard import hadamard_generations

__all__ = ["HadamardCode"]


class HadamardCode(Kernel):
    """Hadamard code framework kernel."""

    def __init__(self, n_jobs=None, verbose=False, normalize=False,
                 n_iter=5, base_graph_kernel=None):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.n_iter = n_iter
        self.base_graph_kernel = base_graph_kernel

    def initialize(self):
        if not isinstance(self.n_iter, int) or self.n_iter <= 0:
            raise TypeError("'n_iter' must be a positive integer")
        bk = self.base_graph_kernel
        if bk is None:
            self._base_cls, self._base_params = VertexHistogram, {}
        elif isinstance(bk, tuple) and len(bk) == 2:
            self._base_cls, self._base_params = bk[0], dict(bk[1])
        elif isinstance(bk, type) and issubclass(bk, Kernel):
            self._base_cls, self._base_params = bk, {}
        else:
            raise TypeError("base_graph_kernel must be None, a Kernel "
                            "subclass, or a (class, params) tuple")
        self._base_params.pop("normalize", None)
        self._fast = (self._base_cls is VertexHistogram
                      and not self._base_params)

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        return normalize_input(X)

    def fit(self, X, y=None):
        self._method_calling = 1
        self._is_transformed = False
        self.initialize()
        self.X = self.parse_input(X)
        self._enum = {}
        self._collect_labels(self.X)
        self._X_diag = None
        if not self._fast:
            self._host_fit(with_gram=False)
        return self

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self._is_transformed = False
        self.initialize()
        self.X = self.parse_input(X)
        self._enum = {}
        self._collect_labels(self.X)
        self._X_diag = None
        if self._fast:
            K = self._device_sym(self.X)
        else:
            K = np.asarray(self._host_fit(with_gram=True))
        # a Gram on the card is normalized there (K17) before its fetch
        d = _diagonal_of(K)
        if self.normalize:
            K = normalize_gram(K, d, d)
        self._X_diag = _to_numpy(d).copy()
        return _to_numpy(K)

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        Y = self.parse_input(X)
        n_fit_labels = len(self._enum)
        enum_t = dict(self._enum)
        self._collect_labels(Y, enum_t)
        if self._fast:
            K, xd, yd = self._device_rect(self.X, Y, n_fit_labels, enum_t)
        else:
            K = np.asarray(self._host_transform(Y, enum_t))
            yd = self._host_diag(side=1)
            xd = self._X_diag if self._X_diag is not None \
                else self._host_diag(side=0)
        if self.normalize:
            K = normalize_gram(K, yd, xd)
        if self._X_diag is None:
            self._X_diag = _to_numpy(xd)
        self._Y_diag = _to_numpy(yd)
        self._is_transformed = True
        return _to_numpy(K)

    def diagonal(self):
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if self._X_diag is None:
            if self._fast:
                self._X_diag = torch.diagonal(
                    self._device_sym(self.X)).cpu().numpy()
            else:
                self._X_diag = self._host_diag(side=0)
        if getattr(self, "_is_transformed", False):
            return self._X_diag, self._Y_diag
        return self._X_diag

    # ------------------------------------------------------------------ #
    def _collect_labels(self, graphs, enum=None):
        """Extend ``enum`` (the fit enumeration when None) with each
        graph's labels in the order of the JAX package's loop over a
        per-graph ``set``."""
        enum = self._enum if enum is None else enum
        for g in graphs:
            labs = g.get_labels(label_type="vertex", return_none=True)
            if labs is None:
                raise ValueError("HadamardCode requires node labels")
            for v in set(labs.values()):
                if v not in enum:
                    enum[v] = len(enum)
        return enum

    @staticmethod
    def _hdim(nl):
        return int(2 ** ceil(log2(max(nl, 1))))

    def _initial_codes(self, graphs, enum, D_pad):
        """The initial Hadamard codes of ``graphs``' vertices as (row
        indices int32 [sum nodes], table int32 [D, D_pad]): vertex v's
        code is row ``enum[l(v)]`` of H(D), D the dimension of ``enum``,
        zero-padded to D_pad."""
        D = self._hdim(len(enum))
        table = np.zeros((D, D_pad), np.int32)
        table[:, :D] = hadamard(D)
        idx = []
        for g in graphs:
            labs = g.get_labels(label_type="vertex")
            idx.extend(enum[labs[v]] for v in range(g.n))
        return np.asarray(idx, np.int32), table

    # ------------------------------------------------------- device path
    def _batch(self, graphs):
        return GraphBatch.from_graphs(graphs, node_label_enum={},
                                      device=self._device())

    def _count_dtype(self, batch):
        """Width of the count Grams over ``batch``: a generation adds at
        most n_i n_j to an entry (:func:`ops.gram.count_dtype`)."""
        return count_dtype(self.n_iter * batch.max_nodes ** 2)

    @staticmethod
    def _code_table(batch, parts):
        """(table int32 [T + 1, D_pad], row int32 [N_pad]) for ``batch``,
        whose nodes' initial codes are the ``(rows, table)`` parts of
        :meth:`_initial_codes` in node order: the parts' tables stacked,
        their rows offset to match, the padding rows on a last zero
        row."""
        tables, rows, at = [], [], 0
        for r, t in parts:
            rows.append(r + at)
            tables.append(t)
            at += t.shape[0]
        tables.append(np.zeros((1, tables[0].shape[1]), np.int32))
        row = np.full(batch.node_labels.shape[0], at, np.int32)
        np.concatenate(rows, out=row[:batch.total_nodes])
        return np.concatenate(tables), row

    def _keys(self, batch, parts, tags):
        """The generations' compaction keys [n_iter, N_pad] over
        ``batch`` (:meth:`_code_table` of ``parts``), with ``tags``
        [N_pad] (on the batch's device) the rows' dimension tags."""
        table, row = self._code_table(batch, parts)
        dev = batch.device
        return hadamard_generations(
            batch, torch.from_numpy(table).to(dev),
            torch.from_numpy(row).to(dev), tags, self.n_iter)

    def _device_sym(self, graphs):
        """Symmetric Gram on the fast path, on the kernel's device: per
        generation a counts-GEMM accumulation over the codes that occur
        more than once, singletons folded into the diagonal."""
        batch = self._batch(graphs)
        n = batch.n_graphs
        gids, valid = batch.node_graph_ids, batch.node_mask
        D = self._hdim(len(self._enum))
        N_pad = gids.shape[0]
        ones = torch.ones(N_pad, dtype=torch.float32, device=gids.device)
        K = torch.zeros((n, n), dtype=self._count_dtype(batch),
                        device=gids.device)
        diag = torch.zeros(n, dtype=torch.float64, device=gids.device)
        tags = torch.full((N_pad,), D, dtype=torch.int32, device=gids.device)
        for key in self._keys(
                batch, [self._initial_codes(graphs, self._enum, D)], tags):
            ids, _, counts = wl_ops.compact_key_ids(key, valid)
            labels, rep_valid, n_rep, dc = wl_ops.split_singletons(
                ids, counts, valid, gids, n)
            K = chunked_counts_gram_raw(gids, labels, ones, rep_valid, n,
                                        *chunk_plan(max(n_rep, 1)), K0=K)
            diag += dc
        torch.diagonal(K).add_(diag.to(K.dtype))
        return K

    def _device_rect(self, Xg, Yg, n_fit_labels, enum_t):
        """(K [ny, nx], X diagonal, Y diagonal) on the fast path, from one
        batch of the fit and the transform graphs: X codes of dimension
        Dx tagged Dx, Y codes tagged Dt, both zero-padded to the larger."""
        nx, ny = len(Xg), len(Yg)
        batch = self._batch(list(Xg) + list(Yg))
        gids = batch.node_graph_ids.to(torch.int64)
        valid = batch.node_mask
        N_pad = gids.shape[0]
        Dx = self._hdim(n_fit_labels)
        Dt = self._hdim(len(enum_t))
        D_pad = max(Dx, Dt)
        cx = self._initial_codes(Xg, self._enum, D_pad)
        cy = self._initial_codes(Yg, enum_t, D_pad)
        tags = torch.full((N_pad,), Dt, dtype=torch.int32, device=gids.device)
        tags[:len(cx[0])] = Dx
        is_y = gids >= nx
        gids_y = torch.where(is_y, gids - nx, 0)
        gids_x = torch.where(is_y, 0, gids)
        ones = torch.ones(N_pad, dtype=torch.float32, device=gids.device)
        dt = self._count_dtype(batch)
        K = torch.zeros((ny, nx), dtype=dt, device=gids.device)
        xd = torch.zeros(nx, dtype=dt, device=gids.device)
        yd = torch.zeros(ny, dtype=dt, device=gids.device)
        single = torch.zeros(nx + ny, dtype=torch.float64, device=gids.device)
        for key in self._keys(batch, [cx, cy], tags):
            ids, _, counts = wl_ops.compact_key_ids(key, valid)
            labels, rep_valid, n_rep, dc = wl_ops.split_singletons(
                ids, counts, valid, gids, nx + ny)
            L = max(n_rep, 1)
            vy, vx = rep_valid & is_y, rep_valid & ~is_y
            K += coo_counts_gram_rect(gids_y, labels, ones, vy, gids_x,
                                      labels, ones, vx, ny, nx, L, dtype=dt)
            xd += counts_diag(gids_x, labels, ones, vx, nx, L, dtype=dt)
            yd += counts_diag(gids_y, labels, ones, vy, ny, L, dtype=dt)
            single += dc
        xd += single[:nx].to(dt)
        yd += single[nx:].to(dt)
        return K, xd, yd

    # --------------------------------------------------------- host path
    def _host_generations(self, graphs, enum):
        D = self._hdim(len(enum))
        H = hadamard(D).astype(np.int64)
        labels = []
        for g in graphs:
            labs = g.get_labels(label_type="vertex")
            labels.append({v: H[enum[labs[v]]] for v in range(g.n)})
        nbrs = [[g.neighbors(v) for v in range(g.n)] for g in graphs]

        def materialize(labels):
            out = []
            for g, lab in zip(graphs, labels):
                ng = Graph.from_arrays(
                    g.n, g.senders, g.receivers, g.weights,
                    {v: tuple(lab[v]) for v in lab}, g.edge_labels)
                # generations share the source graph's STRUCTURAL cache
                # (an SP base kernel then solves each graph once)
                ng._cache = g._cache
                out.append(ng)
            return out

        yield materialize(labels)
        for _ in range(1, self.n_iter):
            new = []
            for gi, g in enumerate(graphs):
                nl = {}
                for v in range(g.n):
                    acc = labels[gi][v]
                    for q in nbrs[gi][v]:
                        acc = np.add(acc, labels[gi][q])
                    nl[v] = acc
                new.append(nl)
            labels = new
            yield materialize(labels)

    def _host_fit(self, with_gram):
        """One base-kernel instance a generation, dispatched through
        :func:`parallel_sum` (threads when ``n_jobs`` is set)."""
        self._base_kernels = {}
        jobs = []
        for i, gen in enumerate(self._host_generations(self.X, self._enum)):
            bk = self._base_cls(normalize=False, verbose=self.verbose,
                                **self._base_params)
            self._base_kernels[i] = bk
            if with_gram:
                jobs.append(lambda bk=bk, gen=gen: bk.fit_transform(gen))
            else:
                jobs.append(lambda bk=bk, gen=gen: bk.fit(gen) and None)
        K = parallel_sum(jobs, self.n_jobs)
        return K if with_gram else None

    def _host_transform(self, Y, enum_t):
        jobs = [
            lambda bk=self._base_kernels[i], gen=gen: bk.transform(gen)
            for i, gen in enumerate(self._host_generations(Y, enum_t))]
        return parallel_sum(jobs, self.n_jobs)

    def _host_diag(self, side):
        """The base kernels' diagonals of the fit (``side`` 0) or the
        transform (1) graphs, summed in f64 as :func:`parallel_sum` sums
        their Grams."""
        d = None
        for bk in self._base_kernels.values():
            di = bk.diagonal()
            if isinstance(di, tuple):
                di = di[side]
            di = np.asarray(di, np.float64)
            d = di if d is None else d + di
        return d
