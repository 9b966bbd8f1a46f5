"""Host-side graph container for grakel_torch.

A copy of ``grakel_tpu/graph.py`` (numpy and scipy only), kept in the
port so that the port imports nothing of the JAX package.

A deliberate redesign of the reference's dual-format ``grakel.Graph``
(reference: grakel/graph.py:25-1537): instead of maintaining both an
adjacency matrix and a nested edge dictionary, we normalize every accepted
input format into ONE canonical representation —

  * ``n``            number of vertices
  * ``senders``      int32[E]  edge source indices (directed; symmetric
                     inputs produce both directions)
  * ``receivers``    int32[E]  edge target indices
  * ``weights``      float32[E]
  * ``node_labels``  dict  index -> label   (hashable label, any type)
  * ``edge_labels``  dict  (i, j) -> label
  * ``index_of``     dict  original vertex symbol -> index (``edsamic``
                     equivalent, reference grakel/graph.py:874-915)

Derived data (dense adjacency, shortest-path matrix, laplacian, BFS
neighborhoods, core numbers) is computed lazily and cached.  Device-side
batched equivalents live in :mod:`grakel_torch.batch` / :mod:`grakel_torch.ops`.

Accepted input formats (reference grakel/graph.py:1539-1706):
  1. numpy 2-D array (adjacency matrix)
  2. scipy sparse matrix
  3. list-of-lists square matrix
  4. 2-level dict  {u: {v: weight}}
  5. dict  u -> iterable of neighbors
  6. iterable of (u, v) edge tuples
  7. iterable of (u, v, weight) tuples
"""

from __future__ import annotations

import collections
import heapq
import warnings

import numpy as np

try:  # scipy is a hard dep of the project, but keep import local-fail safe
    import scipy.sparse as sp
except ImportError:  # pragma: no cover
    sp = None

__all__ = ["Graph", "is_adjacency", "is_edge_dictionary",
           "dijkstra", "floyd_warshall"]


def is_adjacency(g, transform=False):
    """Check (and optionally convert) adjacency-style input.

    Mirrors reference grakel/graph.py:1539-1583 semantics: numpy 2-D square
    arrays, scipy sparse matrices and square lists-of-lists qualify.
    """
    if sp is not None and sp.issparse(g):
        if g.shape[0] != g.shape[1]:
            raise ValueError("adjacency matrix must be square")
        return (True, np.asarray(g.todense(), dtype=np.float64)) if transform else True
    if isinstance(g, np.ndarray):
        ok = g.ndim == 2 and g.shape[0] == g.shape[1]
        if not ok:
            if transform:
                raise ValueError("numpy adjacency input must be a square 2-D array")
            return False
        # copy=False: numeric inputs pass through uncopied; the Graph
        # never mutates the pending adjacency (get_adjacency_matrix
        # copies).  CONTRACT: a float64 adjacency passed to Graph must
        # not be mutated by the caller afterwards — COO extraction is
        # lazy, so later edits would change the extracted edges.
        return (True, g.astype(np.float64, copy=False)) if transform \
            else True
    if isinstance(g, list):
        n = len(g)
        ok = n > 0 and all(isinstance(r, list) and len(r) == n for r in g)
        if not ok:
            return (False, None) if transform else False
        return (True, np.asarray(g, dtype=np.float64)) if transform else True
    return (False, None) if transform else False


def is_edge_dictionary(g, transform=False):
    """Check (and optionally normalize) dictionary-style input.

    Mirrors reference grakel/graph.py:1585-1706: 2-level dicts,
    dict-of-iterables, and iterables of 2/3-tuples.  When ``transform`` is
    true returns ``(True, edge_dict)`` with a canonical
    ``{u: {v: weight}}`` nested dict.
    """
    def _ret(ok, val=None):
        return (ok, val) if transform else ok

    if isinstance(g, dict):
        out = {}
        vertices = set(g.keys())
        for u, nbrs in g.items():
            if isinstance(nbrs, dict):
                out[u] = {v: float(w) for v, w in nbrs.items()}
            elif isinstance(nbrs, (list, set, tuple, frozenset)):
                out[u] = {v: 1.0 for v in nbrs}
            else:
                return _ret(False)
            vertices |= set(out[u].keys())
        for v in vertices:
            out.setdefault(v, {})
        return _ret(True, out)
    if isinstance(g, (list, set, tuple)) or hasattr(g, "__iter__"):
        items = list(g)
        if len(items) == 0:
            return _ret(True, {})
        out = {}
        vertices = set()
        for t in items:
            if not isinstance(t, (tuple, list)) or len(t) not in (2, 3):
                return _ret(False)
            if len(t) == 2:
                u, v = t
                w = 1.0
            else:
                u, v, w = t
                w = float(w)
            out.setdefault(u, {})[v] = w
            vertices.add(u)
            vertices.add(v)
        for v in vertices:
            out.setdefault(v, {})
        return _ret(True, out)
    return _ret(False)


class Graph(object):
    """Canonical host graph.

    Parameters
    ----------
    initialization_object : any of the 7 accepted formats (see module doc).
    node_labels : dict mapping vertex (symbol or index) -> label.
    edge_labels : dict mapping (u, v) -> label.
    graph_format : kept for API compatibility with the reference
        (``"all"|"adjacency"|"dictionary"|"auto"``); the internal
        representation is always canonical, so this only controls which
        *label keying* is assumed for adjacency inputs.
    """

    def __init__(self, initialization_object=None, node_labels=None,
                 edge_labels=None, graph_format="auto"):
        self._format_hint = graph_format
        self.n = 0
        self._senders = np.zeros(0, dtype=np.int32)
        self._receivers = np.zeros(0, dtype=np.int32)
        self._weights = np.zeros(0, dtype=np.float32)
        self._adj_pending = None  # adjacency awaiting lazy COO extraction
        self.node_labels = {}
        self.edge_labels = {}
        self._index_of = {}      # symbol -> index; None = identity 0..n-1
        self._symbol_of = {}     # index -> symbol; None = identity
        # structure-derived caches only (adj/sp/lap/nbr) — safe to SHARE
        # between same-structure graphs with different labels (the WL
        # frameworks relabel per generation; sharing makes e.g. WL-SP
        # compute Floyd-Warshall once instead of once per generation)
        self._cache = {}
        self._nlarr = False      # numeric-label cache (label-dependent)
        if initialization_object is not None:
            self.build_graph(initialization_object, node_labels, edge_labels)

    # --- lazy COO view ------------------------------------------------- #
    # Adjacency inputs defer the (costly) np.nonzero scan until some
    # consumer actually needs edges: VertexHistogram/EdgeHistogram-style
    # parses read only labels, and at REDDIT scale the eager scan was
    # the single largest cost of the whole kernel.
    def _extract_coo(self):
        A = self._adj_pending
        self._adj_pending = None
        s, r = np.nonzero(A)
        self._senders = s.astype(np.int32)
        self._receivers = r.astype(np.int32)
        self._weights = A[s, r].astype(np.float32)

    @property
    def senders(self):
        if self._adj_pending is not None:
            self._extract_coo()
        return self._senders

    @senders.setter
    def senders(self, v):
        self._adj_pending = None
        self._senders = v

    @property
    def receivers(self):
        if self._adj_pending is not None:
            self._extract_coo()
        return self._receivers

    @receivers.setter
    def receivers(self, v):
        self._adj_pending = None
        self._receivers = v

    @property
    def weights(self):
        if self._adj_pending is not None:
            self._extract_coo()
        return self._weights

    @weights.setter
    def weights(self, v):
        self._adj_pending = None
        self._weights = v

    # --- lazy identity symbol maps ------------------------------------- #
    @property
    def index_of(self):
        if self._index_of is None:
            self._index_of = {i: i for i in range(self.n)}
        return self._index_of

    @index_of.setter
    def index_of(self, v):
        self._index_of = v

    @property
    def symbol_of(self):
        if self._symbol_of is None:
            self._symbol_of = {i: i for i in range(self.n)}
        return self._symbol_of

    @symbol_of.setter
    def symbol_of(self, v):
        self._symbol_of = v

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def build_graph(self, g, node_labels=None, edge_labels=None):
        self._cache = {}
        self._nlarr = False
        self._adj_pending = None
        ok_adj = is_adjacency(g)
        if ok_adj and self._format_hint != "dictionary":
            _, A = is_adjacency(g, transform=True)
            self._from_adjacency(A)
        else:
            ok, ed = is_edge_dictionary(g, transform=True)
            if not ok:
                raise ValueError(
                    "Unsupported graph initialization object of type %s"
                    % type(g))
            self._from_edge_dict(ed)
        self._attach_labels(node_labels, edge_labels)
        return self

    def _from_adjacency(self, A):
        self.n = A.shape[0]
        self._adj_pending = A    # COO extracted lazily (see senders)
        self._index_of = None    # identity, materialized on demand
        self._symbol_of = None

    def _from_edge_dict(self, ed):
        # natural sort when keys are mutually comparable (ints etc.) to
        # match the reference's vertex enumeration (grakel/graph.py:159
        # `sorted(vertices)`); heterogeneous keys fall back to a stable
        # type-then-string order.
        try:
            symbols = sorted(ed.keys())
        except TypeError:
            symbols = sorted(ed.keys(), key=lambda x: (str(type(x)), str(x)))
        self.index_of = {sym: i for i, sym in enumerate(symbols)}
        self.symbol_of = {i: sym for sym, i in self.index_of.items()}
        self.n = len(symbols)
        s, r, w = [], [], []
        for u, nbrs in ed.items():
            ui = self.index_of[u]
            for v, wt in nbrs.items():
                s.append(ui)
                r.append(self.index_of[v])
                w.append(wt)
        self.senders = np.asarray(s, dtype=np.int32)
        self.receivers = np.asarray(r, dtype=np.int32)
        self.weights = np.asarray(w, dtype=np.float32)

    def _attach_labels(self, node_labels, edge_labels):
        self.node_labels = {}
        identity = self._index_of is None
        if node_labels:
            if identity and isinstance(node_labels, dict):
                # adjacency inputs key labels by index already.  Validate
                # the whole key set vectorized (np.fromiter is C-speed;
                # per-key Python loops dominated parse at REDDIT scale):
                # every key must be a non-negative integral < n — keys
                # like 1.5 fall through to the slow path instead of
                # silently truncating onto the wrong vertex.
                keys = None
                try:
                    keys = np.fromiter(node_labels.keys(), np.float64,
                                       len(node_labels))
                except (TypeError, ValueError):
                    pass
                if keys is not None:
                    ints = keys.astype(np.int64)
                    if ((keys == ints) & (ints >= 0)
                            & (ints < self.n)).all():
                        self.node_labels = dict(node_labels)
                        node_labels = None
            if node_labels is not None:
                for k, v in node_labels.items():
                    if identity:
                        idx = k if isinstance(k, (int, np.integer)) \
                            or (isinstance(k, float) and k == int(k)) \
                            else None
                    else:
                        idx = self.index_of.get(k, k if isinstance(
                            k, (int, np.integer)) and 0 <= k < self.n
                            else None)
                    if idx is not None and 0 <= int(idx) < self.n:
                        self.node_labels[int(idx)] = v
        self.edge_labels = {}
        if edge_labels:
            if self._index_of is None:
                for (u, v), lab in edge_labels.items():
                    try:
                        self.edge_labels[(int(u), int(v))] = lab
                    except (TypeError, ValueError):
                        continue
            else:
                for (u, v), lab in edge_labels.items():
                    ui = self.index_of.get(u, u)
                    vi = self.index_of.get(v, v)
                    try:
                        self.edge_labels[(int(ui), int(vi))] = lab
                    except (TypeError, ValueError):
                        continue

    @classmethod
    def from_arrays(cls, n, senders, receivers, weights=None,
                    node_labels=None, edge_labels=None):
        """Fast path: build directly from index-space arrays (no parsing)."""
        g = cls()
        g.n = int(n)
        g.senders = np.asarray(senders, dtype=np.int32)
        g.receivers = np.asarray(receivers, dtype=np.int32)
        g.weights = (np.ones(len(g.senders), np.float32) if weights is None
                     else np.asarray(weights, dtype=np.float32))
        g._index_of = None       # identity, materialized on demand
        g._symbol_of = None
        g.node_labels = dict(node_labels) if node_labels else {}
        g.edge_labels = dict(edge_labels) if edge_labels else {}
        return g

    # ------------------------------------------------------------------ #
    # accessors (reference-compatible names)
    # ------------------------------------------------------------------ #
    @property
    def nv(self):
        return self.n

    def nb_vertices(self):
        return self.n

    def nb_edges(self):
        return len(self.senders)

    def get_vertices(self, purpose="any"):
        return list(range(self.n))

    def get_edges(self, purpose="any"):
        return list(zip(self.senders.tolist(), self.receivers.tolist()))

    def get_adjacency_matrix(self, copy=True):
        """Dense adjacency.  ``copy=False`` returns the pending input
        matrix itself when one exists (READ-ONLY by contract, and not
        cached — no aliasing with the mutable cached copy): at
        REDDIT-M-12K scale the defensive per-graph dense copy measured
        ~30 s of GraphletSampling parse."""
        if "adj" in self._cache:
            return self._cache["adj"]
        if self._adj_pending is not None:
            if (not copy and isinstance(self._adj_pending, np.ndarray)
                    and self._adj_pending.dtype == np.float64):
                return self._adj_pending
            # copy: callers of the default path may mutate the result
            A = np.array(self._adj_pending, dtype=np.float64)
        else:
            A = np.zeros((self.n, self.n), dtype=np.float64)
            if len(self.senders):
                A[self.senders, self.receivers] = self.weights
        self._cache["adj"] = A
        return self._cache["adj"]

    # alias used throughout the reference API surface
    adjacency_matrix = property(get_adjacency_matrix)

    def get_labels(self, purpose="any", label_type="vertex", return_none=False):
        """Return labels keyed by vertex index / edge index-pair.

        reference: grakel/graph.py:471-559 (get_labels with purpose
        adjacency/dictionary); here a single canonical keying exists.
        """
        if label_type in ("vertex", "node"):
            if not self.node_labels:
                return None if return_none else {i: 0 for i in range(self.n)}
            return dict(self.node_labels)
        elif label_type == "edge":
            if not self.edge_labels:
                if return_none:
                    return None
                return {(int(u), int(v)): 0
                        for u, v in zip(self.senders, self.receivers)}
            return dict(self.edge_labels)
        raise ValueError("label_type must be 'vertex' or 'edge'")

    def get_label(self, v, label_type="vertex"):
        return self.get_labels(label_type=label_type)[v]

    def numeric_node_label_array(self):
        """int64[n] of node labels in index order, or ``None`` when any
        label is non-integer (packing fast path; see batch.from_graphs).
        Unlabeled vertices get 0, matching ``get_labels`` defaults."""
        if self._nlarr is False:
            arr = np.zeros(self.n, dtype=np.int64)
            if self.node_labels:
                try:
                    ks = np.fromiter(self.node_labels.keys(), np.int64,
                                     len(self.node_labels))
                    vs = np.fromiter(self.node_labels.values(), np.int64,
                                     len(self.node_labels))
                except (TypeError, ValueError):
                    self._nlarr = None
                    return None
                arr[ks] = vs
            self._nlarr = arr
        return self._nlarr

    def label(self, v, label_type="vertex"):
        return self.get_label(v, label_type)

    # ------------------------------------------------------------------ #
    # derived data
    # ------------------------------------------------------------------ #
    def neighbors(self, v):
        if "nbr" not in self._cache:
            nbr = [[] for _ in range(self.n)]
            for s, r in zip(self.senders, self.receivers):
                nbr[s].append(int(r))
            self._cache["nbr"] = nbr
        return self._cache["nbr"][v]

    def degrees(self):
        d = np.zeros(self.n, dtype=np.int64)
        np.add.at(d, self.senders, 1)
        return d

    def build_shortest_path_matrix(self, algorithm_type="auto", clean=False,
                                   labels="vertex"):
        """All-pairs shortest paths.  Dense Floyd–Warshall on host numpy
        (the TPU batched variant lives in ops/floyd_warshall.py).

        reference: grakel/graph.py:593-692.  Returns (S, node_labels_dict).
        """
        if "sp" not in self._cache or clean:
            A = self.get_adjacency_matrix()
            self._cache["sp"] = floyd_warshall(A)
        labs = self.get_labels(label_type="vertex") if labels else None
        return self._cache["sp"], labs

    def laplacian(self, save=True):
        """Weighted Laplacian L = D - A (reference grakel/graph.py:1060)."""
        A = self.get_adjacency_matrix()
        L = np.diag(A.sum(axis=1)) - A
        if save:
            self._cache["lap"] = L
        return L

    def produce_neighborhoods(self, r=3, purpose="any", with_distances=False,
                              d=-1, sort_neighbors=True):
        """Level neighborhoods exactly as the reference computes them
        (grakel/graph.py:1221-1333), including its doubling recursion:
        ``N[level+1][i] = union of N[level][w] for w in N[level][i]`` —
        so ``N[k]`` for k >= 2 is the ball of radius 2^(k-1), NOT k, and
        the "distance" assigned to pairs first appearing at level k is k.
        NSPD's published features depend on this exact behavior.

        Returns ``N`` alone, or ``(N, D, Dist_pair)`` when
        ``with_distances``: D[level] = set of (i, j) pairs first reached
        at that level, Dist_pair maps each such pair to its level.
        """
        if r < 0:
            raise ValueError("r must be positive or equal to zero")
        if with_distances and d < 0:
            d = r
            warnings.warn("negative d as input - d set to r")
        n = self.n
        track = with_distances
        top = max(r, d) if track else r
        N = {0: {i: {i} for i in range(n)}}
        if track:
            level_pairs = {0: {(i, i) for i in range(n)}}
            first_seen = {(i, i): 0 for i in range(n)}

        if r > 0:
            eye = np.eye(n, dtype=bool)
            ball = eye.copy()  # closed ball reachability, grows per level
            # level 1 keeps duplicate entries in the sorted list (a
            # self-loop contributes its endpoint twice), so it is built
            # from raw neighbor lists rather than the boolean mask
            lists = {}
            loops = []
            for i in range(n):
                ns = list(self.neighbors(i))
                closed = [i] + ns
                lists[i] = sorted(closed) if sort_neighbors else closed
                ball[i, ns] = True
                if i in ns:
                    loops.append(i)
            N[1] = lists
            if track and d >= 1:
                s, t = np.nonzero(ball & ~eye)
                fresh = list(zip(s.tolist(), t.tolist()))
                fresh += [(i, i) for i in loops]
                level_pairs[1] = set(fresh)
                first_seen.update((p, 1) for p in fresh)
            # doubling recursion: composing the level-k ball with itself
            # is one boolean matmul, so N[k] holds the radius-2^(k-1)
            # ball for k >= 2 (exactly the reference's level sequence)
            for level in range(1, top):
                f = ball.astype(np.float32)
                grown = (f @ f) > 0
                if track and level <= d - 1:
                    s, t = np.nonzero(grown & ~ball)
                    fresh = list(zip(s.tolist(), t.tolist()))
                    level_pairs[level + 1] = set(fresh)
                    first_seen.update((p, level + 1) for p in fresh)
                ball = grown
                N[level + 1] = {i: np.flatnonzero(ball[i]).tolist()
                                for i in range(n)}
            if track:
                # the reference drops the levels it only computed for
                # distance tracking — but keeps level d itself when d > r
                for level in range(r + 1, d):
                    N.pop(level, None)
        if track:
            return N, level_pairs, first_seen
        return N

    def canonical_labeling(self, use_labels=False):
        """Canonical position per vertex (bliss-surface replacement;
        reference _isomorphism/bliss.pyx:313-335).  With ``use_labels``
        the vertex labels act as an initial coloring the canonical form
        must respect."""
        from .isomorphism import canonical_labeling
        A = self.get_adjacency_matrix()
        colors = self.get_labels(label_type="vertex") if use_labels \
            else None
        return canonical_labeling(A, colors=colors)

    def isomorphic(self, other, use_labels=False):
        """Exact isomorphism test against another Graph via canonical
        forms (reference _isomorphism/bliss.pyx:337-358)."""
        from .isomorphism import is_isomorphic
        c1 = c2 = None
        if use_labels:
            l1 = self.get_labels(label_type="vertex")
            l2 = other.get_labels(label_type="vertex")
            c1 = [l1[i] for i in range(self.n)]
            c2 = [l2[i] for i in range(other.n)]
        return is_isomorphic(self.get_adjacency_matrix(),
                             other.get_adjacency_matrix(), c1, c2)

    def get_subgraph(self, vertices):
        """Induced subgraph on ``vertices`` with labels remapped to the new
        compact index space (reference grakel/graph.py:1355-1480)."""
        vs = sorted(set(int(v) for v in vertices))
        remap = {v: i for i, v in enumerate(vs)}
        keep = np.array([(int(s) in remap and int(r) in remap)
                         for s, r in zip(self.senders, self.receivers)],
                        dtype=bool)
        s = np.array([remap[int(x)] for x in self.senders[keep]], np.int32) \
            if keep.any() else np.zeros(0, np.int32)
        r = np.array([remap[int(x)] for x in self.receivers[keep]], np.int32) \
            if keep.any() else np.zeros(0, np.int32)
        w = self.weights[keep] if keep.any() else np.zeros(0, np.float32)
        nl = {remap[v]: self.node_labels[v] for v in vs if v in self.node_labels}
        el = {(remap[int(u)], remap[int(v)]): lab
              for (u, v), lab in self.edge_labels.items()
              if int(u) in remap and int(v) in remap}
        return Graph.from_arrays(len(vs), s, r, w, nl, el)

    def core_numbers(self):
        """k-core decomposition via the standard bucket algorithm
        (reference core_framework.py:381-420)."""
        n = self.n
        deg = self.degrees().astype(np.int64)
        order = list(np.argsort(deg, kind="stable"))
        pos = {int(v): i for i, v in enumerate(order)}
        bin_start = {}
        cur = 0
        for i, v in enumerate(order):
            d = int(deg[v])
            if d not in bin_start:
                bin_start[d] = i
        core = deg.copy()
        nbrs = [list(self.neighbors(v)) for v in range(n)]
        removed = [False] * n
        for i in range(n):
            v = int(order[i])
            removed[v] = True
            for u in nbrs[v]:
                if not removed[u] and core[u] > core[v]:
                    du = int(core[u])
                    pu = pos[u]
                    pw = bin_start[du]
                    w = int(order[pw])
                    if u != w:
                        order[pu], order[pw] = order[pw], order[pu]
                        pos[u], pos[w] = pw, pu
                    bin_start[du] += 1
                    core[u] -= 1
                    if int(core[u]) not in bin_start or bin_start[int(core[u])] > pos[u]:
                        bin_start[int(core[u])] = pos[u]
        return {v: int(core[v]) for v in range(n)}

    # compatibility no-ops: the canonical representation serves every purpose
    def desired_format(self, graph_format="all", warn=False):
        return self

    def change_format(self, graph_format="all"):
        return self

    def __len__(self):
        return self.n


def dijkstra(edge_dict_or_graph, source, end_vertex=None):
    """Single-source shortest paths with a binary heap.

    Accepts either a ``Graph`` or a 2-level edge dict.  Returns
    ``(distances, predecessors)`` dicts like the reference
    (grakel/graph.py:1709-1761); ties pop in (distance, vertex) order.
    """
    if isinstance(edge_dict_or_graph, Graph):
        g = edge_dict_or_graph
        adj = collections.defaultdict(list)
        for s, r, w in zip(g.senders, g.receivers, g.weights):
            adj[int(s)].append((int(r), float(w)))
    else:
        adj = {u: [(v, float(w)) for v, w in nbrs.items()]
               for u, nbrs in edge_dict_or_graph.items()}
    dist = {}
    pred = {}
    est = {source: 0.0}
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if u in dist or d > est.get(u, np.inf):
            continue
        dist[u] = d
        if u == end_vertex:
            break
        for v, w in adj.get(u, ()):
            nd = d + w
            if v in dist:
                continue
            if v not in est or nd < est[v]:
                est[v] = nd
                pred[v] = u
                heapq.heappush(heap, (nd, v))
    return dist, pred


def floyd_warshall(A):
    """Dense all-pairs shortest paths on a (possibly weighted) adjacency.

    Row-vectorized O(n^3) like the reference (grakel/graph.py:1764-1791):
    zero entries mean "no edge" (except the diagonal); unreachable pairs
    stay +inf.
    """
    A = np.asarray(A, dtype=np.float64)
    n = A.shape[0]
    S = np.where(A > 0, A, np.inf)
    np.fill_diagonal(S, 0.0)
    for k in range(n):
        S = np.minimum(S, S[:, k:k + 1] + S[k:k + 1, :])
    return S
