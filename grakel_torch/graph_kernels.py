"""GraphKernel: generic wrapper with the reference's kernel-spec
mini-language (reference grakel/graph_kernels.py:40-68, 445-556).

The counterpart of ``grakel_tpu/graph_kernels.py``.  Accepts ``kernel=``
as a string name/synonym, a dict ``{"name": ..., **params}``, or a list
of those where the tail becomes the ``base_graph_kernel`` of the head
(framework chaining).  Also implements Nystroem low-rank approximation
(graph_kernels.py:313-337, 366-372).  The registry holds the kernels the
port has; any other name raises ``ValueError`` listing them.
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator, NotFittedError, check_random_state

__all__ = ["GraphKernel"]

# class name -> (names, synonyms), the JAX package's table
_NAMES = {
    "VertexHistogram": ("vertex_histogram", "subtree_wl", "VH", "ST-WL"),
    "EdgeHistogram": ("edge_histogram", "EH"),
    "ShortestPath": ("shortest_path", "SP"),
    "ShortestPathAttr": ("shortest_path_attr", "SPA"),
    "GraphletSampling": ("graphlet_sampling", "graphlet", "GR"),
    "RandomWalk": ("random_walk", "RW"),
    "RandomWalkLabeled": ("random_walk_labeled", "RWL"),
    "WeisfeilerLehman": ("weisfeiler_lehman", "WL"),
    "NeighborhoodHash": ("neighborhood_hash", "NH"),
    "NeighborhoodSubgraphPairwiseDistance": (
        "neighborhood_subgraph_pairwise_distance", "NSPD", "NSPDK"),
    "LovaszTheta": ("lovasz_theta", "lovasz-theta", "LOVT"),
    "SvmTheta": ("svm_theta", "svm-theta", "SVMT"),
    "OddSth": ("odd_sth", "ODD", "ODD-STh"),
    "Propagation": ("propagation", "PR", "PK"),
    "PropagationAttr": ("propagation_attr", "PRA"),
    "PyramidMatch": ("pyramid_match", "PM"),
    "SubgraphMatching": ("subgraph_matching", "SM"),
    "MultiscaleLaplacian": ("multiscale_laplacian", "ML"),
    "HadamardCode": ("hadamard_code", "HC"),
    "CoreFramework": ("core_framework", "CORE"),
    "GraphHopper": ("graph_hopper", "GH"),
    "WeisfeilerLehmanOptimalAssignment": (
        "weisfeiler_lehman_optimal_assignment", "WL-OA"),
}


def _registry():
    """name/synonym -> class, for the kernels the port has (built
    lazily: the kernels import after this module)."""
    from . import kernels as K
    table = {}
    for cls_name, names in _NAMES.items():
        cls = getattr(K, cls_name, None)
        if cls is not None:
            table.update((n, cls) for n in names)
    return table


class GraphKernel(BaseEstimator):
    """Generic wrapper dispatching a kernel spec to a kernel instance.

    Every kernel name and argument of the JAX package's wrapper is
    ported.  ``mesh`` (a :class:`grakel_torch.parallel.Mesh`, or
    ``"auto"`` for every rank of the world) assembles the kernel's Grams
    over several GPUs, one process a rank (see
    :mod:`grakel_torch.parallel`); it is set on the kernel the wrapper
    builds, whose framework base kernels inherit it.  Like every kernel,
    the wrapper has a ``device`` attribute (None: the ambient device,
    else cuda), forwarded to the kernel it builds.
    """

    device = None

    def __init__(self, kernel="shortest_path", normalize=False, verbose=False,
                 n_jobs=None, random_state=None, Nystroem=False, mesh=None):
        self.kernel = kernel
        self.normalize = normalize
        self.verbose = verbose
        self.n_jobs = n_jobs
        self.random_state = random_state
        self.Nystroem = Nystroem
        self.mesh = mesh
        self._initialized = False

    # ------------------------------------------------------------------ #
    def initialize(self):
        spec = self.kernel
        if isinstance(spec, (str, dict)):
            spec = [spec]
        elif not isinstance(spec, list) or len(spec) == 0:
            raise ValueError("kernel spec must be a str, dict, or non-empty "
                             "list of dicts")
        self.kernel_ = self._make_kernel(list(spec))
        if self.device is not None:
            # an attribute, not a constructor parameter, as on the
            # kernels; framework base kernels inherit it as the ambient
            # device of the call
            self.kernel_.device = self.device
        if self.mesh is not None:
            # the same for the mesh (kernels.base.Kernel.mesh)
            self.kernel_.mesh = self.mesh
        if self.Nystroem:
            ncomp = 100 if self.Nystroem is True else int(self.Nystroem)
            if ncomp <= 0:
                raise ValueError("Nystroem components must be positive")
            self.nystroem_ = ncomp
        else:
            self.nystroem_ = False
        self._initialized = True

    def _make_kernel(self, specs):
        head = specs[0]
        if isinstance(head, str):
            head = {"name": head}
        elif not isinstance(head, dict):
            raise ValueError("each kernel spec element must be str or dict")
        head = dict(head)
        name = head.pop("name")
        table = _registry()
        if name not in table:
            raise ValueError("unsupported kernel: %r (available: %s)"
                             % (name, sorted(set(table))))
        cls = table[name]
        params = dict(head)
        params.setdefault("verbose", self.verbose)
        params.setdefault("n_jobs", self.n_jobs)
        params.setdefault("normalize", self.normalize)
        if len(specs) > 1:
            # framework chaining: the tail becomes the base kernel spec,
            # recursively (reference graph_kernels.py:545-553)
            params["base_graph_kernel"] = self._resolve_base(specs[1:])
        valid = cls().get_params()
        if self.random_state is not None and "random_state" in valid:
            params.setdefault("random_state", self.random_state)
        unknown = sorted(set(params) - set(valid))
        if unknown:
            # surface typos instead of silently dropping them
            # (reference graph_kernels.py:445-491 raises the same way)
            raise TypeError("%s got unexpected kernel parameter(s): %s "
                            "(valid: %s)"
                            % (cls.__name__, ", ".join(unknown),
                               ", ".join(sorted(valid))))
        return cls(**params)

    def _resolve_base(self, specs):
        """Resolve a tail spec list into a (class, params) pair."""
        head = specs[0] if isinstance(specs[0], dict) else {"name": specs[0]}
        head = dict(head)
        name = head.pop("name", None)
        base_cls = _registry().get(name)
        if base_cls is None:
            raise ValueError("unsupported base kernel: %r (available: %s)"
                             % (name, sorted(set(_registry()))))
        bparams = dict(head)
        if len(specs) > 1:
            bparams["base_graph_kernel"] = self._resolve_base(specs[1:])
        return (base_cls, bparams)

    # ------------------------------------------------------------------ #
    def fit(self, X, y=None):
        if not self._initialized:
            self.initialize()
        if self.nystroem_:
            X = list(X)
            n = len(X)
            ncomp = min(self.nystroem_, n)
            self.components_indices_ = check_random_state(
                self.random_state).permutation(n)[:ncomp]
            basis = [X[i] for i in self.components_indices_]
            K_bb = self.kernel_.fit_transform(basis)
            from scipy.linalg import svd
            U, S, V = svd(np.asarray(K_bb))
            S = np.maximum(S, 1e-12)
            self.normalization_ = np.dot(U / np.sqrt(S), V)
            self.components_ = basis
        else:
            self.kernel_.fit(X)
        return self

    def transform(self, X):
        if not self._initialized:
            raise NotFittedError("call fit first")
        K = self.kernel_.transform(X)
        if self.nystroem_:
            return np.dot(K, self.normalization_.T)
        return K

    def fit_transform(self, X, y=None):
        if not self._initialized:
            self.initialize()
        if self.nystroem_:
            self.fit(X)
            return np.dot(self.kernel_.transform(X), self.normalization_.T)
        # normalization is injected into the inner kernel at construction
        return self.kernel_.fit_transform(X)

    def diagonal(self):
        return self.kernel_.diagonal()

    def set_params(self, **params):
        super().set_params(**params)
        self._initialized = False
        return self
