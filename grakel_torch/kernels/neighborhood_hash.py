"""Neighborhood hashing kernel (Hido & Kashima 2009).

The counterpart of ``grakel_tpu/kernels/neighborhood_hash.py``.
Reference semantics (grakel/kernels/neighborhood_hash.py):

* fit collects the global node-label set and maps each distinct label to
  a random distinct ``bits``-wide integer drawn with ``random_state``
  (:166-192); transform maps unseen labels to ``None``, poisoning every
  node whose own or neighbour label is unknown (:395-421);
* R hashing rounds applied iteratively (round 0 already hashes once),
  ``simple`` or ``count_sensitive`` (:423-507);
* pairwise k(x, y) = mean over rounds of c / (nx + ny - c), c the
  multiset intersection of the two label arrays (:534-573); the output
  is inherently normalized, diagonal 1 (:346-368).

Device path: the graphs pack into a ``GraphBatch``, whose sender CSR
carries the R rounds (``ops/nh.nh_rounds``: on the card the hand kernel
K4, one launch for all R rounds of the graphs that fit a block's shared
memory, one a round for the others) to int32 label histograms [R, n,
2^bits], converted to f32 once.  The Gram is
``ops/intersect.jaccard_gram_rounds``: one routed min-intersection a
round (K1-tc or K1) and the Jaccard fold K5 (the fit Gram on its
upper-triangle route), bit-identical to the JAX package's.  ``nv`` counts every vertex of a
graph, the poisoned ones included.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .base import Kernel, normalize_input
from ..batch import GraphBatch
from ..estimator import NotFittedError, check_random_state
from ..ops.intersect import jaccard_gram_rounds
from ..ops.nh import nh_rounds

__all__ = ["NeighborhoodHash"]


class NeighborhoodHash(Kernel):
    """Neighborhood hash kernel (simple / count_sensitive)."""

    _inherently_normalized = True

    def __init__(self, n_jobs=None, normalize=False, verbose=False,
                 random_state=None, R=3, nh_type="simple", bits=8):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.random_state = random_state
        self.R = R
        self.nh_type = nh_type
        self.bits = bits

    def initialize(self):
        if not isinstance(self.R, int) or self.R <= 0:
            raise TypeError("R must be an integer bigger than zero")
        if self.nh_type not in ("simple", "count_sensitive"):
            raise TypeError("unrecognised neighborhood hashing type")
        if not isinstance(self.bits, int) or self.bits <= 0:
            raise TypeError("illegal number of bits for hashing")
        self._max_number = 1 << self.bits
        self._mask = self._max_number - 1
        self.random_state_ = check_random_state(self.random_state)

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs = normalize_input(X)
        if self._method_calling in (1, 2):
            # draw the random label hash (reference :166-192): a python
            # set built in graph order, then distinct random ints
            labels_hash_set = set()
            for g in graphs:
                labs = g.get_labels(label_type="vertex", return_none=True)
                if labs is None:
                    raise ValueError("NeighborhoodHash requires node labels")
                labels_hash_set |= set(labs.values())
            if len(labels_hash_set) > self._max_number:
                warnings.warn("Number of labels is smaller than the biggest "
                              "possible.. Collisions will appear on the "
                              "new labels.")
                nl, nrl = [], len(labels_hash_set)
                while nrl > self._max_number:
                    nl += self.random_state_.choice(
                        self._max_number, self._max_number,
                        replace=False).tolist()
                    nrl -= self._max_number
                if nrl > 0:
                    nl += self.random_state_.choice(
                        self._max_number, nrl, replace=False).tolist()
            else:
                nl = self.random_state_.choice(
                    self._max_number, len(labels_hash_set),
                    replace=False).tolist()
            self._labels_hash_dict = dict(zip(labels_hash_set, nl))
        elif not hasattr(self, "_labels_hash_dict"):
            raise ValueError("fit before transform")
        return self._device_levels(graphs)

    # ------------------------------------------------------------------ #
    def _device_levels(self, graphs):
        """Run the R hashing rounds on the kernel's device; return the
        per-round label histograms (f32 [R, n, 2^bits] there) and the
        vertex counts (f64 numpy)."""
        batch, lab, lab_valid = self._round_inputs(graphs)
        hists = nh_rounds(batch, lab, lab_valid, batch.n_graphs, self.R,
                          self.bits, self.nh_type == "count_sensitive")
        return {"n": batch.n_graphs, "hists": hists.to(torch.float32),
                "nv": batch.n_nodes.astype(np.float64)}

    def _round_inputs(self, graphs):
        """(batch, hashed labels int32 [N_pad], validity bool [N_pad]) of
        ``graphs`` on the kernel's device: a label unseen at fit, and
        every padding node, is invalid with label 0."""
        for g in graphs:
            if not g.node_labels or len(g.node_labels) != g.n:
                raise ValueError("NeighborhoodHash requires a label on "
                                 "every vertex")
        enum = {}
        batch = GraphBatch.from_graphs(graphs, node_label_enum=enum,
                                       device=self._device())
        # the batch's label ids -> hashed labels (-1: unseen at fit); only
        # the distinct labels touch the hash dict
        lut = np.full(max(len(enum), 1), -1, np.int64)
        for raw, i in enum.items():
            lut[i] = self._labels_hash_dict.get(raw, -1)
        mapped = torch.from_numpy(lut).to(batch.device)[
            batch.node_labels.to(torch.int64)]
        lab_valid = batch.node_mask & (mapped >= 0)
        lab = torch.where(lab_valid, mapped, 0).to(torch.int32)
        return batch, lab, lab_valid

    # ------------------------------------------------------------------ #
    def _gram(self, px, py=None):
        symmetric = py is None
        if py is None:
            py = px
        # rows: py's graphs (transform), columns: px's (fit)
        K = jaccard_gram_rounds(py["hists"], px["hists"], va=py["nv"],
                                vb=px["nv"], symmetrize=symmetric)
        return K.cpu().to(torch.float64)

    def _diag(self, parsed):
        return np.ones(parsed["n"], np.float64)

    def diagonal(self):
        """Inherently normalized (reference :346-368)."""
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if getattr(self, "_is_transformed", False):
            return 1.0, 1.0
        return 1.0
