"""Core decomposition framework kernel (Nikolentzos et al. 2018).

The counterpart of ``grakel_tpu/kernels/core_framework.py``.  Reference
semantics (grakel/kernels/core_framework.py:98-235):

* per graph: k-core numbers (``Graph.core_numbers``, the bucket
  algorithm of :381-420);
* for core level i = max_core .. min_core + 1: the induced subgraph of
  vertices with core >= i per graph, one base-kernel instance per level
  (default ShortestPath), K += level Gram scattered by the indexes of
  graphs that still have vertices at that level (:176-219);
* transform keeps "dummy kernels" for levels absent at fit, used only
  for the Y diagonal (:209-219, :355-377).

The reference's ``__init__`` overwrites the ``min_core`` argument with
-1 (core_framework.py:50); this implementation honors the argument (the
default -1 matches the reference).

A host orchestration layer: the base kernels run on the device of the
entry point, which they inherit as the ambient device.
"""

from __future__ import annotations

import numpy as np

from .base import Kernel, normalize_input
from .shortest_path import ShortestPath
from ..estimator import NotFittedError

__all__ = ["CoreFramework"]


class CoreFramework(Kernel):
    """k-core decomposition framework."""

    def __init__(self, n_jobs=None, verbose=False, normalize=False,
                 min_core=-1, base_graph_kernel=None):
        super().__init__(n_jobs=n_jobs, normalize=normalize, verbose=verbose)
        self.min_core = min_core
        self.base_graph_kernel = base_graph_kernel

    def initialize(self):
        bk = self.base_graph_kernel
        if bk is None:
            cls, params = ShortestPath, {}
        elif isinstance(bk, type) and issubclass(bk, Kernel):
            cls, params = bk, {}
        else:
            try:
                cls, params = bk
            except Exception:
                raise TypeError("Base kernel was not formulated in the "
                                "correct way. Check documentation.")
            if not (isinstance(cls, type) and issubclass(cls, Kernel)):
                raise TypeError("The first argument must be a valid "
                                "kernel class")
            if not isinstance(params, dict):
                raise ValueError("base kernel params must be a dict")
            params = dict(params)
            params.pop("normalize", None)
        params["normalize"] = False
        params["verbose"] = self.verbose
        params["n_jobs"] = None
        self.base_graph_kernel_ = cls
        self.params_ = params
        if not isinstance(self.min_core, int) or self.min_core < -1:
            raise TypeError("'min_core' must be an integer bigger than -1")

    # ------------------------------------------------------------------ #
    def parse_input(self, X):
        graphs = normalize_input(X)
        nx = len(graphs)
        core_numbers = []
        max_core_number = 0
        for g in graphs:
            c = g.core_numbers()
            mx = max(c.values()) if c else 0
            max_core_number = max(max_core_number, mx)
            core_numbers.append(c)
        if max_core_number <= self.min_core:
            raise ValueError("The maximum core equals the min_core "
                             "boundary set in init.")

        if self._method_calling == 2:
            K = np.zeros((nx, nx))
        elif self._method_calling == 3:
            self._dummy_kernel = {}
            K = np.zeros((nx, self._nx))

        base_graph_kernel, indexes_list = {}, {}
        for i in range(max_core_number, self.min_core, -1):
            subgraphs, indexes = [], []
            for idx, (cn, g) in enumerate(zip(core_numbers, graphs)):
                vertices = [k for k, v in cn.items() if v >= i]
                if len(vertices) > 0:
                    subgraphs.append(g.get_subgraph(vertices))
                    indexes.append(idx)
            indexes = np.array(indexes, dtype=np.int64)
            indexes_list[i] = indexes

            if self._method_calling == 1 and indexes.shape[0] > 0:
                bk = self.base_graph_kernel_(**self.params_)
                bk.fit(subgraphs)
                base_graph_kernel[i] = bk
            elif self._method_calling == 2 and indexes.shape[0] > 0:
                bk = self.base_graph_kernel_(**self.params_)
                Ki = np.asarray(bk.fit_transform(subgraphs))
                base_graph_kernel[i] = bk
                K[np.ix_(indexes, indexes)] += Ki
            elif self._method_calling == 3:
                if (self._max_core_number < i
                        or self._fit_indexes[i].shape[0] == 0):
                    if len(indexes) > 0:
                        dk = self.base_graph_kernel_(**self.params_)
                        dk.fit(subgraphs)
                        self._dummy_kernel[i] = dk
                elif indexes.shape[0] > 0:
                    Ki = np.asarray(self.X[i].transform(subgraphs))
                    K[np.ix_(indexes, self._fit_indexes[i])] += Ki

        if self._method_calling in (1, 2):
            self._nx = nx
            self._max_core_number = max_core_number
            self._fit_indexes = indexes_list
            if self._method_calling == 1:
                return base_graph_kernel
            return K, base_graph_kernel
        self._t_nx = nx
        self._max_core_number_trans = max_core_number
        self._transform_indexes = indexes_list
        return K

    # ------------------------------------------------------------------ #
    def fit(self, X, y=None):
        self._method_calling = 1
        self._is_transformed = False
        self.initialize()
        if X is None:
            raise ValueError("fit input cannot be None")
        self.X = self.parse_input(X)
        self._X_diag = None
        return self

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self._is_transformed = False
        self.initialize()
        if X is None:
            raise ValueError("fit_transform input cannot be None")
        km, self.X = self.parse_input(X)
        self._X_diag = np.diagonal(km)
        if self.normalize:
            with np.errstate(divide="ignore", invalid="ignore"):
                km = np.nan_to_num(np.divide(
                    km, np.sqrt(np.outer(self._X_diag, self._X_diag))))
        return km

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        if X is None:
            raise ValueError("transform input cannot be None")
        km = self.parse_input(X)
        self._is_transformed = True
        if self.normalize:
            X_diag, Y_diag = self.diagonal()
            with np.errstate(divide="ignore", invalid="ignore"):
                km = np.nan_to_num(km / np.sqrt(np.outer(Y_diag, X_diag)))
        return km

    def diagonal(self):
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if getattr(self, "_X_diag", None) is not None:
            if self._is_transformed:
                Y_diag = np.zeros(self._t_nx)
                max_cn = min(self._max_core_number_trans,
                             self._max_core_number)
                for i in range(max_cn, self.min_core, -1):
                    tidx = self._transform_indexes[i]
                    if tidx.shape[0] > 0 and i in self.X:
                        Y_diag[tidx] += self.X[i].diagonal()[1]
        else:
            X_diag = np.zeros(self._nx)
            if self._is_transformed:
                max_cn = min(self._max_core_number_trans,
                             self._max_core_number)
                Y_diag = np.zeros(self._t_nx)
                for i in range(max_cn, self.min_core, -1):
                    fidx = self._fit_indexes[i]
                    tidx = self._transform_indexes.get(
                        i, np.zeros(0, np.int64))
                    if tidx.shape[0] > 0 and fidx.shape[0] > 0:
                        x, y = self.X[i].diagonal()
                        X_diag[fidx] += np.asarray(x).ravel()
                        Y_diag[tidx] += np.asarray(y).ravel()
                if max_cn < self._max_core_number:
                    for i in range(self._max_core_number, max_cn, -1):
                        fidx = self._fit_indexes[i]
                        if fidx.shape[0] > 0 and i in self.X:
                            d = self.X[i].diagonal()
                            if isinstance(d, tuple):
                                d = d[0]
                            X_diag[fidx] += np.asarray(d).ravel()
            else:
                for i in range(self._max_core_number, self.min_core, -1):
                    fidx = self._fit_indexes[i]
                    if fidx.shape[0] > 0 and i in self.X:
                        d = self.X[i].diagonal()
                        if isinstance(d, tuple):
                            d = d[0]
                        X_diag[fidx] += np.asarray(d).ravel()
            self._X_diag = X_diag
        if self._is_transformed:
            for idx, bk in getattr(self, "_dummy_kernel", {}).items():
                Y_diag[self._transform_indexes[idx]] += bk.diagonal()
            return self._X_diag, Y_diag
        return self._X_diag
