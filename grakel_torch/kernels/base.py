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
the call, so framework base kernels created inside inherit it.  Mesh:
the entry points of a kernel whose ``mesh`` is set install it as the
ambient Gram mesh (``ops.gram.use_mesh``) the same way.
Entry points return numpy arrays, as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import functools
import warnings

import numpy as np
import torch

from ..device import resolve_device, use_device
from ..estimator import BaseEstimator, NotFittedError, check_random_state
from ..graph import Graph
from ..ops.gram import active_mesh, gram_gemm, gram_rect, use_mesh
from ..profiling import StageTimer, host_span

__all__ = ["Kernel", "normalize_input", "parallel_sum"]


def parallel_sum(thunks, n_jobs):
    """Run result-producing thunks and return the sum of their outputs.

    The per-iteration framework dispatch (WL hands one base-kernel job
    per label generation to this helper).  ``n_jobs`` ``None``/``0``/``1``
    runs sequentially; ``-1`` uses one thread per job; ``k > 1`` caps the
    pool at ``k``.  The outputs are summed in f64 numpy, in thunk order
    (integer count Grams stay exact past 2^24); None outputs are skipped,
    and None is returned when every output is None.
    """
    thunks = list(thunks)
    if not thunks:
        return None
    # under a mesh the thunks' collectives must be issued in the same
    # order on every rank: sequentially
    if n_jobs in (None, 0, 1) or len(thunks) == 1 \
            or active_mesh() is not None:
        outs = [t() for t in thunks]
    else:
        from concurrent.futures import ThreadPoolExecutor
        w = len(thunks) if n_jobs < 0 else min(n_jobs, len(thunks))
        with ThreadPoolExecutor(max_workers=w) as ex:
            outs = list(ex.map(lambda t: t(), thunks))
    acc = None
    for r in outs:
        if r is not None:
            r = np.asarray(_to_numpy(r), np.float64)
            acc = r if acc is None else acc + r
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


def _diagonal_of(K):
    """The diagonal of a Gram (a tensor or a numpy array) as a view of the
    same kind, on the Gram's device."""
    if isinstance(K, torch.Tensor):
        return torch.diagonal(K)
    return np.diagonal(K)


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


def _mesh_entry(fn):
    """Entry-point wrapper installing ``self.mesh`` (resolved) as the
    ambient Gram mesh for the call; kernels with ``mesh`` None run
    unwrapped and inherit any ambient mesh."""
    @functools.wraps(fn)
    def wrapped(self, *a, **k):
        if self.mesh is None:
            return fn(self, *a, **k)
        with use_mesh(self._resolved_mesh()):
            return fn(self, *a, **k)
    return wrapped


def _entry(fn):
    """The device wrapper around the mesh wrapper: ``"auto"`` resolves
    its mesh on the call's device."""
    if getattr(fn, "_device_wrapped", False):
        return fn
    return _device_entry(_mesh_entry(fn))


class Kernel(BaseEstimator):
    """Base graph kernel (see module docstring)."""

    # subclasses may flip this to request normalized-by-construction output
    _inherently_normalized = False

    # True where ``parse_input`` is host work only: its stage is then
    # also the host span ``parse`` (see :mod:`grakel_torch.profiling`)
    _host_parse = False

    # The device the kernel runs on: a torch.device or string, or None
    # for the ambient use_device device, else cuda.  An attribute, not a
    # constructor argument, so the kernel signatures stay at reference
    # parity; so is ``mesh``.
    device = None

    # Multi-GPU Gram assembly: a grakel_torch.parallel.Mesh, or "auto"
    # (every rank of the world; None at world size 1).  Every Gram this
    # kernel funnels through ops.gram then assembles ring-tiled over the
    # mesh's ranks, each rank called with the same input and returning
    # the full Gram.  GraphKernel(mesh=...) sets it on the kernel it
    # builds; framework base kernels inherit the ambient mesh.
    mesh = None

    def __init__(self, n_jobs=None, normalize=False, verbose=False):
        self.n_jobs = n_jobs
        self.normalize = normalize
        self.verbose = verbose
        # 1: fit, 2: fit_transform, 3: transform — reference kernel.py:66-71
        self._method_calling = 0

    def __init_subclass__(cls, **kw):
        """Wrap every public entry point (including subclass overrides)
        so the resolved device, and the kernel's mesh when it has one,
        are ambient for the call's duration."""
        super().__init_subclass__(**kw)
        for name in ("fit", "fit_transform", "transform", "diagonal"):
            fn = cls.__dict__.get(name)
            if fn is not None:
                setattr(cls, name, _entry(fn))

    def _device(self):
        """The device of the running entry point."""
        return resolve_device(self.device)

    def _resolved_mesh(self):
        """``self.mesh`` with ``"auto"`` resolved to every rank of the
        world, on the call's device (None at world size 1)."""
        m = self.mesh
        if isinstance(m, str):
            if m != "auto":
                raise ValueError("mesh must be a Mesh, 'auto', or None")
            import torch.distributed as dist
            if not dist.is_initialized() or dist.get_world_size() <= 1:
                return None
            from ..parallel import make_mesh
            return make_mesh(device=self._device())
        return m

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
        self.timer_ = StageTimer()
        self.X = self._parse_timed(X, "parse")
        self._X_diag = None
        return self

    def fit_transform(self, X, y=None):
        self._method_calling = 2
        self.fit(X)
        if not hasattr(self, "timer_"):  # subclass-overridden fit
            self.timer_ = StageTimer()
        with self.timer_.stage("gram"):
            K = _to_numpy(self._compute_symmetric(self.X))
        self._K_fit = K
        if self.normalize and not self._inherently_normalized:
            with host_span("normalize", self.timer_):
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
        if not hasattr(self, "timer_"):
            self.timer_ = StageTimer()
        Y = self._parse_timed(X, "parse_y")
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

    def _parse_timed(self, X, stage):
        """``parse_input(X)`` timed as ``stage``; for a kernel whose
        parse is host work only, also the host span ``parse``."""
        span = host_span("parse") if self._host_parse \
            else contextlib.nullcontext()
        with self.timer_.stage(stage), span:
            return self.parse_input(X)

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


# the base entry points get the same wrapping subclass overrides do
for _name in ("fit", "fit_transform", "transform", "diagonal"):
    setattr(Kernel, _name, _entry(Kernel.__dict__[_name]))
del _name
