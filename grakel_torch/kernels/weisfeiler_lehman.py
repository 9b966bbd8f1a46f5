"""Weisfeiler-Lehman subtree framework.

The counterpart of ``grakel_tpu/kernels/weisfeiler_lehman.py``.
Reference semantics:

* ``n_iter`` refinement rounds -> ``n_iter + 1`` label generations
  (generation 0 = compacted initial labels);
* one base-kernel instance per generation, fed the relabeled graphs,
  with ``normalize=False`` forced on the inner kernels;
* K = sum over generations;
* transform maps credentials unseen at fit to fresh ids.

Two execution paths:

* **fast path** (base kernel is VertexHistogram, the default): the whole
  pipeline stays on the kernel's device.  Refinement = the K2 multiset
  hash over the batch's sender CSR, which also gives each node's
  compaction key, + ``torch.unique`` compaction (ops/wl.py);
  per-generation Gram = chunked scatter + fp32 GEMM accumulation
  (ops/gram.py; f64 once an entry could pass 2^24, bounded on the host
  by :meth:`WeisfeilerLehman._count_dtype`), over the repeated labels
  only, with singletons folded into the diagonal.
  Transform recomputes WL on the disjoint union of fit and transform
  graphs (refinement is per-graph independent, so fit ids keep their
  meaning) and evaluates only the rectangular block.  Under a mesh
  (``Kernel.mesh``, ``ops.gram.use_mesh``) ``fit_transform`` takes
  ``parallel.distributed_wl_gram`` and ``transform``'s rectangular
  Grams the ring-tiled ``coo_counts_gram_rect``.
* **general path** (any other base kernel): host-side credential
  refinement with per-generation base-kernel instances, mirroring the
  reference's structure for full API parity.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (Kernel, _diagonal_of, _to_numpy, normalize_input,
                   parallel_sum)
from .histogram import VertexHistogram
from ..batch import GraphBatch, bucket_size
from ..estimator import NotFittedError
from ..graph import Graph
from ..ops import wl as wl_ops
from ..ops.gram import (active_mesh, chunk_plan, chunked_counts_gram_raw,
                        coo_counts_gram_rect, count_dtype, counts_diag,
                        normalize_gram)
from ..profiling import StageTimer

__all__ = ["WeisfeilerLehman"]


class WeisfeilerLehman(Kernel):
    """WL subtree kernel framework."""

    _host_parse = True

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 n_iter=5, base_graph_kernel=None):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.n_iter = n_iter
        self.base_graph_kernel = base_graph_kernel

    # ------------------------------------------------------------------ #
    def initialize(self):
        if not isinstance(self.n_iter, int) or self.n_iter <= 0:
            raise TypeError("'n_iter' must be a positive integer")
        self._h = self.n_iter + 1
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
        self.timer_ = StageTimer()
        self.X = self._parse_timed(X, "parse")
        self._X_diag = None
        if not self._fast:
            with self.timer_.stage("gram"):
                self._host_fit(self.X, with_gram=False)
        return self

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self._is_transformed = False
        self.initialize()
        self.timer_ = StageTimer()
        self.X = self._parse_timed(X, "parse")
        self._X_diag = None
        mesh = active_mesh()
        with self.timer_.stage("gram"):
            if self._fast and mesh is not None:
                # the mesh route: graph-sharded refinement and ring-tiled
                # Grams (parallel.wl) on the mesh's device, which must be
                # the kernel's
                from ..parallel import distributed_wl_gram
                from ..parallel.mesh import check_tensor
                check_tensor(mesh, torch.empty(0, device=self._device()))
                K = distributed_wl_gram(self.X, self.n_iter, mesh)
            elif self._fast:
                K = self._device_sym(self.X)
            else:
                K = np.asarray(self._host_fit(self.X, with_gram=True))
        # a Gram on the card is normalized there (K17), so only the f64
        # result and the diagonal cross to the host
        d = _diagonal_of(K)
        if self.normalize:
            with self.timer_.stage("normalize"):
                K = normalize_gram(K, d, d)
        self._X_diag = _to_numpy(d).copy()
        self._report_stages()
        return _to_numpy(K)

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        if not hasattr(self, "timer_"):
            self.timer_ = StageTimer()
        Y = self._parse_timed(X, "parse_y")
        with self.timer_.stage("gram_y"):
            if self._fast:
                K, xd, yd = self._device_rect(self.X, Y)
            else:
                K = np.asarray(self._host_transform(Y))
                yd = self._host_diag_y(Y)
                xd = self._X_diag if self._X_diag is not None \
                    else self._host_diag_x()
        if self.normalize:
            with self.timer_.stage("normalize_y"):
                K = normalize_gram(K, yd, xd)
        if self._X_diag is None:
            self._X_diag = _to_numpy(xd)
        self._Y_diag = _to_numpy(yd)
        self._is_transformed = True
        self._report_stages()
        return _to_numpy(K)

    def diagonal(self):
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if self._X_diag is None:
            if self._fast:
                self._X_diag = torch.diagonal(
                    self._device_sym(self.X)).cpu().numpy()
            else:
                self._X_diag = self._host_diag_x()
        if getattr(self, "_is_transformed", False):
            return self._X_diag, self._Y_diag
        return self._X_diag

    # ------------------------------------------------------- device path
    def _batch(self, graphs):
        return GraphBatch.from_graphs(graphs, node_label_enum={},
                                      device=self._device())

    def _generations(self, batch):
        """Yield (labels, n_labels_bound) for generations 0..n_iter."""
        labels = batch.node_labels
        yield labels, max(batch.num_node_labels, 1)
        for _ in range(self.n_iter):
            labels, nu, _ = self._refine(batch, labels)
            yield labels, bucket_size(nu)

    def _count_dtype(self, batch):
        """Width of the count Grams over ``batch``: a generation adds at
        most n_i n_j to an entry, so an entry is at most (n_iter + 1)
        max_n^2 (:func:`ops.gram.count_dtype`)."""
        return count_dtype(self._h * batch.max_nodes ** 2)

    @staticmethod
    def _refine(batch, labels):
        """One refinement over the batch's CSR: (ids, n_unique, counts)."""
        key = wl_ops._wl_hash_refine_csr(
            labels, batch.csr_offsets, batch.csr_targets)
        return wl_ops.compact_key_ids(key, batch.node_mask)

    def _device_sym(self, graphs):
        """Symmetric fit_transform Gram on the WL fast path: one
        counts-GEMM accumulation per generation over the labels that
        occur more than once; singleton labels only add to the diagonal
        (ops/wl.py split_singletons).  Returns K [n, n], f32, or f64 when
        an entry could pass 2^24 (:meth:`_count_dtype`)."""
        batch = self._batch(graphs)
        n = batch.n_graphs
        gids, valid = batch.node_graph_ids, batch.node_mask
        labels = batch.node_labels
        ones = torch.ones(labels.shape[0], dtype=torch.float32,
                          device=labels.device)
        L = max(batch.num_node_labels, 1)
        gram_labels, gram_valid = labels, valid
        diag_corr = torch.zeros(n, dtype=torch.float64, device=labels.device)
        K = torch.zeros((n, n), dtype=self._count_dtype(batch),
                        device=labels.device)
        for _ in range(self.n_iter):
            K = chunked_counts_gram_raw(gids, gram_labels, ones, gram_valid,
                                        n, *chunk_plan(L), K0=K)
            labels, _, counts = self._refine(batch, labels)
            gram_labels, gram_valid, n_rep, dc = wl_ops.split_singletons(
                labels, counts, valid, gids, n)
            diag_corr += dc
            L = bucket_size(max(n_rep, 1))
        K = chunked_counts_gram_raw(gids, gram_labels, ones, gram_valid,
                                    n, *chunk_plan(L), K0=K)
        torch.diagonal(K).add_(diag_corr.to(K.dtype))
        return K

    def _device_rect(self, Xg, Yg):
        nx, ny = len(Xg), len(Yg)
        batch = self._batch(list(Xg) + list(Yg))
        gids = batch.node_graph_ids.to(torch.int64)
        valid = batch.node_mask
        is_y = gids >= nx
        gids_y = torch.where(is_y, gids - nx, 0)
        gids_x = torch.where(is_y, 0, gids)
        vy = valid & is_y
        vx = valid & ~is_y
        ones = torch.ones(gids.shape[0], dtype=torch.float32,
                          device=gids.device)
        dt = self._count_dtype(batch)
        K = xd = yd = None
        for labels, L in self._generations(batch):
            Ki = coo_counts_gram_rect(
                gids_y, labels, ones, vy, gids_x, labels, ones, vx,
                ny, nx, L, dtype=dt)
            xi = counts_diag(gids_x, labels, ones, vx, nx, L, dtype=dt)
            yi = counts_diag(gids_y, labels, ones, vy, ny, L, dtype=dt)
            K = Ki if K is None else K + Ki
            xd = xi if xd is None else xd + xi
            yd = yi if yd is None else yd + yi
        return K, xd, yd

    # --------------------------------------------------------- host path
    def _host_generations(self, graphs, inv_labels=None):
        """Host credential refinement.  Yields per-generation relabeled
        Graph lists; records fit-time credential dicts in self._inv_labels
        when ``inv_labels`` is None (fit), else reuses/extends them."""
        fit_mode = inv_labels is None
        if fit_mode:
            self._inv_labels = {}
        store = self._inv_labels
        nbrs = [[g.neighbors(v) for v in range(g.n)] for g in graphs]
        # generation 0: compact initial labels
        labs = [dict(g.get_labels()) for g in graphs]
        mapping = {} if fit_mode else dict(store[0])
        for d in labs:
            for lab in sorted(set(d.values()), key=str):
                if lab not in mapping:
                    mapping[lab] = len(mapping)
        if fit_mode:
            store[0] = mapping
        cur = [{v: mapping[d[v]] for v in d} for d in labs]
        yield self._materialize(graphs, cur)
        for it in range(1, self._h):
            creds = []
            for gi, g in enumerate(graphs):
                c = {}
                for v in range(g.n):
                    neigh = sorted(cur[gi][u] for u in nbrs[gi][v])
                    c[v] = (cur[gi][v], tuple(neigh))
                creds.append(c)
            mapping = {} if fit_mode else dict(store[it])
            for c in creds:
                for cred in sorted(set(c.values())):
                    if cred not in mapping:
                        mapping[cred] = len(mapping)
            if fit_mode:
                store[it] = mapping
            cur = [{v: mapping[c[v]] for v in c} for c in creds]
            yield self._materialize(graphs, cur)

    @staticmethod
    def _materialize(graphs, labelings):
        out = []
        for i, g in enumerate(graphs):
            ng = Graph.from_arrays(g.n, g.senders, g.receivers, g.weights,
                                   labelings[i], g.edge_labels)
            # generations share the source graph's STRUCTURAL cache
            ng._cache = g._cache
            out.append(ng)
        return out

    def _host_fit(self, graphs, with_gram):
        """One base-kernel instance per generation; the base-kernel Grams
        are dispatched through :func:`parallel_sum` (threads when
        ``n_jobs`` is set, as the reference's per-iteration joblib)."""
        self._base_kernels = {}
        jobs = []
        for i, gen in enumerate(self._host_generations(graphs)):
            bk = self._base_cls(normalize=False, verbose=self.verbose,
                                **self._base_params)
            self._base_kernels[i] = bk
            if with_gram:
                jobs.append(lambda bk=bk, gen=gen: bk.fit_transform(gen))
            else:
                jobs.append(lambda bk=bk, gen=gen: bk.fit(gen) and None)
        K = parallel_sum(jobs, self.n_jobs)
        return K if with_gram else None

    def _host_transform(self, Y):
        jobs = [
            lambda bk=self._base_kernels[i], gen=gen: bk.transform(gen)
            for i, gen in enumerate(
                self._host_generations(Y, inv_labels=self._inv_labels))]
        return parallel_sum(jobs, self.n_jobs)

    def _host_diag_x(self):
        d = None
        for bk in self._base_kernels.values():
            di = bk.diagonal()
            if isinstance(di, tuple):
                di = di[0]
            d = di if d is None else d + di
        return np.asarray(d)

    def _host_diag_y(self, Y):
        d = None
        for bk in self._base_kernels.values():
            di = bk.diagonal()
            if isinstance(di, tuple):
                d = di[1] if d is None else d + di[1]
        return np.asarray(d) if d is not None else None
