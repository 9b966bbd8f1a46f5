"""Kernel base class: scikit-learn-style frontend over device Gram assembly.

The counterpart of ``grakel_tpu/kernels/base.py`` (API parity with the
reference ``grakel.kernels.Kernel``): ``fit`` / ``transform`` /
``fit_transform`` / ``diagonal`` / ``set_params`` with ``normalize`` /
``verbose`` / ``n_jobs`` constructor params.  Subclasses implement ONE
of, in preference order:

1. ``_feature_matrix(parsed)``   -> Phi [n, D]; the base computes
      K = Phi @ Phi^T as one GEMM on the kernel's device;
2. ``_gram(parsed_X, parsed_Y)`` -> full custom batched Gram
      (parsed_Y is None for the symmetric fit_transform case);
3. ``pairwise_operation(x, y)``  -> scalar; host double-loop fallback.

Device: every public entry point resolves ``self.device`` (see
:mod:`grakel_torch.device`) and installs it as the ambient device for
the call, so framework base kernels created inside inherit it.
Entry points return numpy arrays, as the JAX package's do.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..device import resolve_device, use_device
from ..estimator import BaseEstimator, NotFittedError, check_random_state
from ..graph import Graph
from ..ops.gram import gram_gemm, gram_rect

__all__ = ["Kernel", "normalize_input", "parallel_sum"]


def parallel_sum(thunks, n_jobs):
    """Run result-producing thunks and return the sum of their outputs.

    The per-iteration framework dispatch (WL hands one base-kernel job
    per label generation to this helper).  ``n_jobs`` ``None``/``0``/``1``
    runs sequentially; ``-1`` uses one thread per job; ``k > 1`` caps the
    pool at ``k``.
    """
    thunks = list(thunks)
    if not thunks:
        return None
    if n_jobs in (None, 0, 1) or len(thunks) == 1:
        outs = [t() for t in thunks]
    else:
        from concurrent.futures import ThreadPoolExecutor
        w = len(thunks) if n_jobs < 0 else min(n_jobs, len(thunks))
        with ThreadPoolExecutor(max_workers=w) as ex:
            outs = list(ex.map(lambda t: t(), thunks))
    acc = outs[0]
    for r in outs[1:]:
        if r is not None:
            acc = acc + r
    return acc


def normalize_input(X):
    """Normalize user input into a list of :class:`Graph`.

    Accepts an iterable whose elements are ``Graph`` instances or
    ``[init_obj]`` / ``[init_obj, node_labels]`` /
    ``[init_obj, node_labels, edge_labels]``.  Empty elements are skipped
    with a warning.
    """
    if not hasattr(X, "__iter__"):
        raise TypeError("input must be an iterable of graphs")
    out = []
    for idx, x in enumerate(X):
        if isinstance(x, Graph):
            out.append(x)
            continue
        if isinstance(x, (tuple, list)):
            x = list(x)
            if len(x) == 0:
                warnings.warn("Ignoring empty element on index: " + str(idx))
                continue
            init = x[0]
            nl = x[1] if len(x) > 1 else None
            el = x[2] if len(x) > 2 else None
            g = Graph(init, nl, el)
            if g.n == 0:
                warnings.warn("Ignoring empty element on index: " + str(idx))
                continue
            out.append(g)
        elif isinstance(x, (dict, np.ndarray)):
            g = Graph(x)
            if g.n == 0:
                warnings.warn("Ignoring empty element on index: " + str(idx))
                continue
            out.append(g)
        else:
            raise TypeError(
                "each element of X must be a Graph or a list "
                "[init_obj, node_labels, edge_labels], got %s" % type(x))
    if len(out) == 0:
        raise ValueError("parsed input is empty")
    return out


def _to_numpy(K):
    if isinstance(K, torch.Tensor):
        return K.detach().cpu().numpy()
    return np.asarray(K)


def _device_entry(fn):
    """Entry-point wrapper: resolve ``self.device`` (instance attribute,
    else the ambient device, else cuda) and install it as the ambient
    device for the call."""
    @functools.wraps(fn)
    def wrapped(self, *a, **k):
        with use_device(resolve_device(self.device)):
            return fn(self, *a, **k)
    wrapped._device_wrapped = True
    return wrapped


class Kernel(BaseEstimator):
    """Base graph kernel (see module docstring)."""

    # subclasses may flip this to request normalized-by-construction output
    _inherently_normalized = False

    # The device the kernel runs on: a torch.device or string, or None
    # for the ambient use_device device, else cuda.  An attribute, not a
    # constructor argument, so the kernel signatures stay at reference
    # parity (as ``mesh`` does in the JAX package).
    device = None

    def __init__(self, n_jobs=None, normalize=False, verbose=False):
        self.n_jobs = n_jobs
        self.normalize = normalize
        self.verbose = verbose
        # 1: fit, 2: fit_transform, 3: transform — reference kernel.py:66-71
        self._method_calling = 0

    def __init_subclass__(cls, **kw):
        """Wrap every public entry point (including subclass overrides)
        so the resolved device is ambient for the call's duration."""
        super().__init_subclass__(**kw)
        for name in ("fit", "fit_transform", "transform", "diagonal"):
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "_device_wrapped", False):
                setattr(cls, name, _device_entry(fn))

    def _device(self):
        """The device of the running entry point."""
        return resolve_device(self.device)

    # -------------------------------------------------------------- hooks
    def initialize(self):
        """(Re)compute derived params; called at every fit entry point."""
        pass

    def parse_input(self, X):
        """Subclass: user input -> internal parsed representation."""
        raise NotImplementedError

    def _feature_matrix(self, parsed):
        return None

    def _gram(self, parsed_x, parsed_y=None):
        return None

    def pairwise_operation(self, x, y):
        raise NotImplementedError

    def _diag(self, parsed):
        """Optional subclass hook: cheap self-kernel diagonal."""
        return None

    # ---------------------------------------------------------------- API
    def fit(self, X, y=None):
        self._method_calling = 1
        self._is_transformed = False
        self.initialize()
        if X is None:
            raise ValueError("fit input cannot be None")
        from ..profiling import StageTimer
        self.timer_ = StageTimer()
        with self.timer_.stage("parse"):
            self.X = self.parse_input(X)
        self._X_diag = None
        return self

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self.fit(X)
        if not hasattr(self, "timer_"):  # subclass-overridden fit
            from ..profiling import StageTimer
            self.timer_ = StageTimer()
        with self.timer_.stage("gram"):
            K = _to_numpy(self._compute_symmetric(self.X))
        self._K_fit = K
        if self.normalize and not self._inherently_normalized:
            with self.timer_.stage("normalize"):
                d = np.diagonal(K).copy()
                self._X_diag = d
                # plain division — zero self-kernels yield NaN like the
                # reference (kernel.py:200-204 has no nan guard)
                with np.errstate(divide="ignore", invalid="ignore"):
                    K = np.asarray(K, np.float64) / np.sqrt(np.outer(d, d))
        self._report_stages()
        return np.asarray(K)

    def transform(self, X):
        self._method_calling = 3
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before transform")
        if X is None:
            raise ValueError("transform input cannot be None")
        from ..profiling import StageTimer
        if not hasattr(self, "timer_"):
            self.timer_ = StageTimer()
        with self.timer_.stage("parse_y"):
            Y = self.parse_input(X)
        with self.timer_.stage("gram_y"):
            K = _to_numpy(self._compute_rectangular(Y, self.X))
        self._Y = Y
        self._is_transformed = True
        if self.normalize and not self._inherently_normalized:
            with self.timer_.stage("normalize_y"):
                Xd, Yd = self.diagonal()
                with np.errstate(divide="ignore", invalid="ignore"):
                    K = np.asarray(K, np.float64) / np.sqrt(
                        np.outer(Yd, Xd))
        self._report_stages()
        return np.asarray(K)

    def _report_stages(self):
        if self.verbose:
            import sys
            print("[%s] stages:\n%s"
                  % (type(self).__name__, self.timer_.report()),
                  file=sys.stderr)

    def diagonal(self):
        """Self-kernel values of fit (and transform, if called) inputs.

        Returns ``X_diag`` after fit/fit_transform, ``(X_diag, Y_diag)``
        after transform.
        """
        if not hasattr(self, "X") or self.X is None:
            raise NotFittedError("call fit before diagonal")
        if self._X_diag is None:
            if getattr(self, "_K_fit", None) is not None:
                self._X_diag = np.asarray(np.diagonal(self._K_fit)).copy()
            else:
                self._X_diag = self._diagonal_of(self.X)
        if getattr(self, "_is_transformed", False):
            Y_diag = self._diagonal_of(self._Y)
            return self._X_diag, Y_diag
        return self._X_diag

    # ------------------------------------------------------------ helpers
    def _diagonal_of(self, parsed):
        d = self._diag(parsed)
        if d is not None:
            return _to_numpy(d)
        phi = self._feature_matrix(parsed)
        if phi is not None:
            if hasattr(phi, "toarray"):
                phi = phi.toarray()
            phi = _to_numpy(phi)
            return np.einsum("ij,ij->i", phi, phi)
        K = self._gram(parsed, None)
        if K is not None:
            return np.diagonal(_to_numpy(K)).copy()
        return np.array([self.pairwise_operation(x, x) for x in parsed])

    def _compute_symmetric(self, parsed):
        phi = self._feature_matrix(parsed)
        if phi is not None:
            return gram_gemm(phi, self._device())
        K = self._gram(parsed, None)
        if K is not None:
            return K
        return self._pairwise_loop(parsed, None)

    def _compute_rectangular(self, parsed_y, parsed_x):
        phi_y = self._feature_matrix(parsed_y)
        if phi_y is not None:
            phi_x = self._feature_matrix(parsed_x)
            return gram_rect(phi_y, phi_x, self._device())
        K = self._gram(parsed_x, parsed_y)
        if K is not None:
            return K
        return self._pairwise_loop(parsed_y, parsed_x)

    def _pairwise_loop(self, A, B=None):
        """Host O(N^2) fallback, sequential (upper triangle + reflect
        when symmetric)."""
        if B is None:
            n = len(A)
            K = np.zeros((n, n))
            for i in range(n):
                for j in range(i, n):
                    K[i, j] = self.pairwise_operation(A[i], A[j])
            return np.triu(K) + np.triu(K, 1).T
        K = np.zeros((len(A), len(B)))
        for i in range(len(A)):
            for j in range(len(B)):
                K[i, j] = self.pairwise_operation(A[i], B[j])
        return K

    def _rng(self, seed_attr="random_state"):
        return check_random_state(getattr(self, seed_attr, None))


# the base entry points get the same device wrapping subclass overrides do
for _name in ("fit", "fit_transform", "transform", "diagonal"):
    setattr(Kernel, _name, _device_entry(Kernel.__dict__[_name]))
del _name
