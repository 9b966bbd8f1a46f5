"""Vertex- and edge-label histogram kernels.

The counterpart of ``grakel_tpu/kernels/histogram.py``.  Reference
semantics: per-graph label-frequency vectors, Gram = Phi @ Phi^T, with a
fit-time label enumeration that is *extended* (never re-fit) at
transform time so unseen labels land in fresh columns that the fit side
has zero counts in.

Labels never become a dense [n_graphs, n_labels] host matrix: the flat
(graph_id, label_id) COO stream goes through the chunked scatter + GEMM
accumulation of :func:`grakel_torch.ops.gram.coo_counts_gram` on the
kernel's device, whatever the label count, in f32 or, once an entry
could pass 2^24, in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..batch import bucket_size, enumerate_labels
from ..ops.gram import (coo_counts_gram, coo_counts_gram_rect, count_dtype,
                        counts_diag)

__all__ = ["VertexHistogram", "EdgeHistogram"]


class _HistogramKernel(Kernel):
    """Shared machinery; subclass picks vertex vs edge labels."""

    _label_type = "vertex"
    _host_parse = True

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 sparse="auto"):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        # accepted for API compatibility with the reference, where it
        # picks a dense or scipy-sparse feature matrix; here features
        # stream as COO, so every mode is sparse-safe and only validated
        self.sparse = sparse

    def initialize(self):
        if self.sparse not in ("auto", True, False):
            raise TypeError("sparse could be False, True or auto")

    def _collect_labels(self, g):
        if self._label_type == "edge" and g.nb_edges() == 0:
            return []  # edgeless graph -> zero feature row
        labs = g.get_labels(label_type=self._label_type, return_none=True)
        if labs is None:
            raise ValueError(
                "%s requires %s labels" % (type(self).__name__,
                                           self._label_type))
        if self._label_type == "vertex":
            return [labs[v] for v in range(g.n)]
        return [labs[(int(s), int(r))]
                for s, r in zip(g.senders, g.receivers)]

    def _numeric_label_arrays(self, graphs):
        """Per-graph int64 label arrays when every graph has a full,
        integer-valued label dict; None otherwise."""
        if self._label_type != "vertex":
            return None
        arrs = []
        for g in graphs:
            if not g.node_labels or len(g.node_labels) != g.n:
                return None
            a = g.numeric_node_label_array()
            if a is None:
                return None
            arrs.append(a)
        return arrs

    def _enum_ids(self, values):
        """Vectorized label enumeration: only the distinct values touch
        the ``_enum`` dict (new labels extend it in ascending order)."""
        uniq, inv = np.unique(values, return_inverse=True)
        lut = np.empty(max(len(uniq), 1), dtype=np.int32)
        for i, u in enumerate(uniq.tolist()):
            idx = self._enum.get(u)
            if idx is None:
                idx = len(self._enum)
                self._enum[u] = idx
            lut[i] = idx
        return lut[inv.reshape(-1)]

    def parse_input(self, X):
        graphs = normalize_input(X)
        if self._method_calling in (1, 2):
            self._enum = {}
        elif not hasattr(self, "_enum"):
            raise ValueError("fit before transform")
        arrs = self._numeric_label_arrays(graphs)
        if arrs is not None:
            sizes = [len(a) for a in arrs]
            gids = np.repeat(np.arange(len(graphs), dtype=np.int64), sizes)
            labels = self._enum_ids(np.concatenate(arrs)
                                    if arrs else np.zeros(0, np.int64))
        else:
            gids, raw = [], []
            for gi, g in enumerate(graphs):
                ls = self._collect_labels(g)
                raw.extend(ls)
                gids.extend([gi] * len(ls))
            labels = enumerate_labels(raw, self._enum, extend=True)
        n_items = len(labels)
        pad = bucket_size(max(n_items, 1))
        gids_a = np.zeros(pad, dtype=np.int32)
        labs_a = np.zeros(pad, dtype=np.int32)
        valid = np.zeros(pad, dtype=bool)
        gids_a[:n_items] = gids
        labs_a[:n_items] = labels
        valid[:n_items] = True
        return {"n": len(graphs), "gids": gids_a, "labels": labs_a,
                "valid": valid, "n_labels": len(self._enum)}

    def _items(self, p):
        """(gids, labels, ones, valid) tensors on the kernel's device."""
        dev = self._device()
        return (torch.from_numpy(p["gids"]).to(dev),
                torch.from_numpy(p["labels"]).to(dev),
                torch.ones(len(p["gids"]), dtype=torch.float32, device=dev),
                torch.from_numpy(p["valid"]).to(dev))

    @staticmethod
    def _count_dtype(*ps):
        """Width of the count Grams of the parses ``ps``: an entry is at
        most the product of two graphs' item counts, so at most the
        largest item count squared (:func:`ops.gram.count_dtype`)."""
        most = max(int(np.bincount(p["gids"][p["valid"]]).max(initial=0))
                   for p in ps)
        return count_dtype(most * most)

    def _gram(self, px, py=None):
        L = max(px["n_labels"], py["n_labels"] if py else 0, 1)
        if py is None:
            return coo_counts_gram(*self._items(px), px["n"], L,
                                   dtype=self._count_dtype(px))
        # rows = transform graphs (py), cols = fit graphs (px)
        return coo_counts_gram_rect(*self._items(py), *self._items(px),
                                    py["n"], px["n"], L,
                                    dtype=self._count_dtype(px, py))

    def _diag(self, parsed):
        L = max(parsed["n_labels"], 1)
        return counts_diag(*self._items(parsed), parsed["n"], L,
                           dtype=self._count_dtype(parsed))


class VertexHistogram(_HistogramKernel):
    """Node-label frequency kernel (aliases in the reference: VH,
    subtree_wl)."""
    _label_type = "vertex"


class EdgeHistogram(_HistogramKernel):
    """Edge-label frequency kernel (reference edge_histogram.py)."""
    _label_type = "edge"
