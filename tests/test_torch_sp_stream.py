"""grakel_torch's ShortestPath in stream mode against grakel_tpu on
JAX-CPU and against a plain count Gram built here.

Stream mode keeps each graph's COO edges (``_STREAM_BYTES = 0`` forces
it at these sizes).  Its routes: the native BFS counts (the default),
their host assembly past ``_BFS_DEVICE_MAX_W`` keys, and the slab route
(``_STREAM_BFS = False``: K3's plain version a slab at a time on the
CPU, an ``index_add_`` into the count matrix, one product).  Every Gram,
transform (with a label unseen at fit) and diagonal must equal the JAX
package's stream Gram (its native BFS route and, with its native engine
switched off, its slab route), its dense Gram and the plain Gram
exactly: the graphs are small, so the JAX package's f32 sums are exact
integers."""

import pickle
from collections import Counter

import numpy as np
import pytest
import torch
from scipy.sparse.csgraph import shortest_path as csgraph_sp

import grakel_tpu
import grakel_tpu.native as jax_native_mod
import grakel_torch
from grakel_torch import native, use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.graph import Graph
from grakel_torch.kernels import shortest_path as sp_mod
from grakel_torch.ops.floyd_warshall import INF, floyd_warshall_plain
from grakel_tpu.graph import Graph as JGraph

from jax_native_ref import jax_native  # noqa: F401

N_FIT = 20


def _graphs(seed, labeled, n=28, vmax=18, weighted=False):
    """``n`` random undirected graphs of 5..vmax-1 vertices as
    [adjacency, node labels, {}]; labels 0-2, and label 3 planted on a
    vertex of the first transform graph (unseen at fit)."""
    rng = np.random.RandomState(seed)
    gs = []
    for i in range(n):
        m = rng.randint(5, vmax)
        A = (rng.rand(m, m) < 0.25).astype(float)
        if weighted:
            A *= rng.choice([0.5, 1.0, 2.0], (m, m))
        A = np.triu(A, 1)
        A = A + A.T
        nl = ({v: int(rng.randint(0, 3)) for v in range(m)} if labeled
              else {v: 0 for v in range(m)})
        gs.append([A, nl, {}])
    if labeled and n > N_FIT:
        gs[N_FIT][1][0] = 3
    return gs


def _plain_features(gs, labeled):
    """Each graph's Counter of (l_u, l_v, d) over ordered reachable pairs
    u != v, by scipy's unweighted BFS."""
    out = []
    for A, nl, _ in gs:
        S = csgraph_sp(np.asarray(A), unweighted=True)
        c = Counter()
        for u, v in zip(*np.nonzero(np.isfinite(S))):
            if u != v:
                c[(nl[u] if labeled else 0, nl[v] if labeled else 0,
                   int(S[u, v]))] += 1
        out.append(c)
    return out


def _dot(a, b):
    return sum(v * b.get(k, 0) for k, v in a.items())


def _plain(gs, labeled):
    """(K, T, x diagonal, y diagonal) as exact Python integers."""
    f = _plain_features(gs, labeled)
    fx, fy = f[:N_FIT], f[N_FIT:]
    K = np.array([[_dot(a, b) for b in fx] for a in fx], np.float64)
    T = np.array([[_dot(a, b) for b in fx] for a in fy], np.float64)
    return (K, T, np.array([_dot(a, a) for a in fx], np.float64),
            np.array([_dot(a, a) for a in fy], np.float64))


def _run(k, gs):
    K = k.fit_transform(gs[:N_FIT])
    T = k.transform(gs[N_FIT:])
    xd, yd = k.diagonal()
    return tuple(np.asarray(a, np.float64) for a in (K, T, xd, yd))


_JAX = {}


def _jax(labeled, mode):
    """The JAX package's outputs: ``mode`` "dense", "stream" (its native
    BFS route) or "stream_slab" (its native engine off)."""
    key = (labeled, mode)
    if key not in _JAX:
        k = grakel_tpu.ShortestPath(with_labels=labeled)
        if mode != "dense":
            k._STREAM_BYTES = 0
        orig = jax_native_mod.have_native
        if mode == "stream_slab":
            jax_native_mod.have_native = lambda: False
        try:
            _JAX[key] = _run(k, _graphs(11, labeled))
        finally:
            jax_native_mod.have_native = orig
        if mode == "stream":
            assert k.X["stream"] and k.X.get("bfs_coo")
    return _JAX[key]


ROUTES = {"bfs": {}, "host": {"_BFS_DEVICE_MAX_W": 0},
          "slab": {"_STREAM_BFS": False},
          "slab_small": {"_STREAM_BFS": False, "_STREAM_SLAB_BYTES": 0}}


def _port(labeled, attrs, gs=None):
    k = grakel_torch.ShortestPath(with_labels=labeled)
    k._STREAM_BYTES = 0
    for a, v in attrs.items():
        setattr(k, a, v)
    with use_device("cpu"):
        out = _run(k, _graphs(11, labeled) if gs is None else gs)
    return out, k


@pytest.mark.parametrize("labeled", [True, False],
                         ids=["labeled", "unlabeled"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stream_matches_jax_and_plain(jax_native, labeled, route):
    out, k = _port(labeled, ROUTES[route])
    assert k.X["stream"] and k._Y["stream"]
    with use_device("cpu"):
        assert k._stream_plan(k.X)[0] == ("slab" if "slab" in route
                                          else "bfs")
    if route != "host":
        assert bool(k.X["counts"]) == ("slab" in route)
    refs = [_jax(labeled, m) for m in ("stream", "stream_slab", "dense")]
    refs.append(_plain(_graphs(11, labeled), labeled))
    for ref in refs:
        for a, b in zip(out, ref):
            assert np.array_equal(a, b)
    assert np.array_equal(np.diagonal(out[0]), out[2])


@pytest.mark.parametrize("route", ["bfs", "host", "slab"])
def test_stream_fit_then_diagonal(route):
    """diagonal() after fit alone (no Gram cached) runs each route's own
    diagonal; after fit_transform it equals diag(K)."""
    gs = _graphs(5, True)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    for a, v in ROUTES[route].items():
        setattr(k, a, v)
    with use_device("cpu"):
        d = k.fit(gs[:N_FIT]).diagonal()
    assert np.array_equal(d, _plain(gs, True)[2])


def test_slab_route_cuts_buckets_into_slabs(monkeypatch):
    """With a zero slab budget a slab holds 8 graphs: K3 (its plain
    version here) runs once a slab, never on more than 8 graphs."""
    gs = _graphs(7, True, n=60)
    calls = []
    plain_fw = sp_mod.batched_floyd_warshall

    def spy(A, M, integral=False):
        calls.append((A.shape[0], integral))
        return plain_fw(A, M, integral)

    monkeypatch.setattr(sp_mod, "batched_floyd_warshall", spy)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    k._STREAM_BFS = False
    k._STREAM_SLAB_BYTES = 0
    with use_device("cpu"):
        K = k.fit_transform(gs[:40])
    sizes = [len(b[0]) for b in k.X["buckets"]]
    assert len(calls) == sum(-(-s // 8) for s in sizes) > len(sizes)
    assert all(n <= 8 and integral for n, integral in calls)
    feats = _plain_features(gs[:40], True)
    assert np.array_equal(K, [[_dot(a, b) for b in feats] for a in feats])


@pytest.mark.parametrize("fit_stream", [True, False],
                         ids=["fit-stream", "transform-stream"])
@pytest.mark.parametrize("route", ["bfs", "slab"])
def test_stream_and_dense_parses_mixed(fit_stream, route):
    """One side in stream mode, the other dense: both routes read the
    dense side's buckets (np.nonzero for BFS, the rows as a slab)."""
    gs = _graphs(13, True)
    k = grakel_torch.ShortestPath()
    for a, v in ROUTES[route].items():
        setattr(k, a, v)
    ref = _plain(gs, True)
    with use_device("cpu"):
        k._STREAM_BYTES = 0 if fit_stream else 1 << 40
        K = k.fit_transform(gs[:N_FIT])
        k._STREAM_BYTES = 1 << 40 if fit_stream else 0
        T = k.transform(gs[N_FIT:])
        xd, yd = k.diagonal()
    assert k.X["stream"] == fit_stream and k._Y["stream"] != fit_stream
    for a, b in zip((K, T, xd, yd), ref):
        assert np.array_equal(a, b)


def test_stream_weighted_materializes(jax_native):
    """Weighted edges have no stream route: the parse warns, turns into
    dense buckets and takes the hash route, giving the JAX package's
    dense Grams."""
    gs = _graphs(3, True, weighted=True)
    kj = grakel_tpu.ShortestPath()
    ref = _run(kj, gs)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    with use_device("cpu"):
        with pytest.warns(UserWarning, match="materializing"):
            K = k.fit_transform(gs[:N_FIT])
        assert not k.X["stream"] and not k.X["unit"]
        with pytest.warns(UserWarning, match="materializing"):
            T = k.transform(gs[N_FIT:])
        xd, yd = k.diagonal()
    for a, b in zip((K, T, xd, yd), ref):
        assert np.array_equal(np.asarray(a, np.float64), b)


def test_stream_too_wide_for_slabs_materializes():
    """The slab route needs L^2 D within _DIRECT_MAX_WIDTH; past it the
    parse is materialized and the dense routes give the same Gram."""
    gs = _graphs(4, True)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    k._STREAM_BFS = False
    k._DIRECT_MAX_WIDTH = 8
    with use_device("cpu"):
        with pytest.warns(UserWarning, match="materializing"):
            out = _run(k, gs)
    for a, b in zip(out, _plain(gs, True)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("route", ["bfs", "slab"])
def test_stream_pickle_drops_counts(route):
    gs = _graphs(6, True)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    for a, v in ROUTES[route].items():
        setattr(k, a, v)
    with use_device("cpu"):
        k.fit_transform(gs[:N_FIT])
        T = k.transform(gs[N_FIT:])
        assert bool(k.X["counts"]) == (route == "slab")
        k2 = pickle.loads(pickle.dumps(k))
        assert k2.X["stream"] and k2.X["counts"] == {}
        assert np.array_equal(k2.transform(gs[N_FIT:]), T)
    assert np.array_equal(T, _plain(gs, True)[1])


@pytest.mark.parametrize("route", ["bfs", "slab"])
def test_stream_state_carry(jax_native, route):
    """A JAX kernel fitted in stream mode carries into a stream-mode fit
    of the port (``"stream"`` in the state), whose transform gives the
    JAX package's."""
    gs = _graphs(9, True)
    jfit = [JGraph(*it) for it in gs[:N_FIT]]
    kj = grakel_tpu.ShortestPath()
    kj._STREAM_BYTES = 0
    kj.fit(jfit)
    assert kj.X["stream"]
    state = {"enum": dict(kj._enum), "stream": kj.X["stream"],
             "graphs": [(g.n, g.senders, g.receivers, g.weights,
                         dict(g.node_labels)) for g in jfit]}
    Tj = kj.transform(gs[N_FIT:])
    with use_device("cpu"):
        kt = kernel_from_state("ShortestPath", {}, state)
        for a, v in ROUTES[route].items():
            setattr(kt, a, v)
        assert kt.X["stream"]
        Tt = kt.transform(gs[N_FIT:])
    assert np.array_equal(Tt, Tj)


@pytest.mark.parametrize("route", ["bfs", "host", "slab"])
def test_stream_counts_exact_past_2_24(route):
    """Graphs past V = 64 (entries up to (V (V - 1))^2 > 2^24) sum in f64
    on every stream route: the exact integer Gram, of which f32 would
    round some entries."""
    rng = np.random.RandomState(2)
    gs = []
    for i in range(6):
        m = 96 + 5 * i
        A = np.triu(rng.rand(m, m) < 0.9, 1).astype(float)   # dense:
        A = A + A.T                                  # most pairs at d = 1
        gs.append([A, {v: 0 for v in range(m)}, {}])
    k = grakel_torch.ShortestPath(with_labels=False)
    k._STREAM_BYTES = 0
    for a, v in ROUTES[route].items():
        setattr(k, a, v)
    with use_device("cpu"):
        K = k.fit_transform(gs)
    f = _plain_features(gs, False)
    ref = np.array([[_dot(a, b) for b in f] for a in f], np.int64)
    assert (ref.astype(np.float32).astype(np.int64) != ref).any()
    assert K.dtype == np.float64 and np.array_equal(K, ref)


def _csr(gs):
    """(node_off, adj_off, adj, labels, dense A [n, V, V], mask) of
    graphs given as [A, labels, {}]."""
    V = max(len(A) for A, _, _ in gs)
    node_off, adj_off, adj, labs = [0], [0], [], []
    Ad = np.zeros((len(gs), V, V), np.float32)
    M = np.zeros((len(gs), V), bool)
    Lb = np.zeros((len(gs), V), np.int64)
    for g, (A, nl, _) in enumerate(gs):
        m = len(A)
        for u in range(m):
            nb = np.flatnonzero(A[u])
            adj.extend(nb.tolist())
            adj_off.append(adj_off[-1] + len(nb))
            labs.append(nl[u])
        node_off.append(node_off[-1] + m)
        Ad[g, :m, :m] = A
        M[g, :m] = True
        Lb[g, :m] = [nl[u] for u in range(m)]
    return (np.array(node_off, np.int64), np.array(adj_off, np.int64),
            np.array(adj, np.int32), np.array(labs, np.int32), Ad, M, Lb)


@pytest.mark.parametrize("labeled", [True, False])
def test_native_bfs_counts_equal_floyd_warshall_plain(labeled):
    """sp_bfs_counts_native's (graph, id, count) stream equals the counts
    of the triplet ids built from floyd_warshall_plain's distances."""
    gs = _graphs(21, labeled, n=12, vmax=30)
    node_off, adj_off, adj, labs, A, M, Lb = _csr(gs)
    L, D = 4, A.shape[1]
    g, ids, c = native.sp_bfs_counts_native(node_off, adj_off, adj, labs,
                                            L, D)
    S = floyd_warshall_plain(torch.from_numpy(A),
                             torch.from_numpy(M)).numpy()
    V = S.shape[1]
    valid = (M[:, :, None] & M[:, None, :] & ~np.eye(V, dtype=bool)
             & (S < INF / 2))
    gg, uu, vv = np.nonzero(valid)
    key = ((Lb[gg, uu] * L + Lb[gg, vv]) * D
           + S[gg, uu, vv].astype(np.int64))
    uk, cnt = np.unique(gg * (L * L * D) + key, return_counts=True)
    got = np.sort(g.astype(np.int64) * (L * L * D) + ids)
    order = np.argsort(g.astype(np.int64) * (L * L * D) + ids)
    assert np.array_equal(got, uk) and np.array_equal(c[order], cnt)
    with pytest.raises(ValueError):   # a distance reaching D raises
        native.sp_bfs_counts_native(node_off, adj_off, adj, labs, L, 2)


def test_stream_parse_keeps_coo_only():
    """A stream parse holds each graph's COO edges, never a dense
    bucket; the dense-bytes switch picks the mode."""
    gs = _graphs(1, True)
    k = grakel_torch.ShortestPath()
    with use_device("cpu"):
        k.fit(gs[:N_FIT])
        assert not k.X["stream"]
        total = sum(A.nbytes for _, A, _, _ in k.X["buckets"])
        k._STREAM_BYTES = total - 1
        k.fit(gs[:N_FIT])
    assert k.X["stream"]
    for idxs, coo, Lb, M in k.X["buckets"]:
        assert isinstance(coo, list) and len(coo) == len(idxs)
        for (s, r, w), gi in zip(coo, idxs):
            g = Graph(*gs[gi][:2])
            assert np.array_equal(s, g.senders) and np.all(w == 1)


def test_bfs_stream_reencoded_when_labels_extend(monkeypatch):
    """A transform whose labels extend L re-encodes the fit side's cached
    BFS stream instead of running the engine on the fit graphs again;
    the Grams stay the plain ones."""
    gs = _graphs(17, True)
    calls = []
    real = native.sp_bfs_counts_native

    def spy(node_off, *a):
        calls.append(len(node_off) - 1)
        return real(node_off, *a)

    monkeypatch.setattr(native, "sp_bfs_counts_native", spy)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    with use_device("cpu"):
        out = _run(k, gs)
    assert len(k._enum) == 4 and len(k.X["bfs_coo"]) == 2
    assert calls == [N_FIT, len(gs) - N_FIT]
    (L0, D0), (L1, D1) = k.X["bfs_coo"]
    assert (L0, L1) == (3, 4) and D0 == D1
    for a, b in zip(out, _plain(gs, True)):
        assert np.array_equal(a, b)
