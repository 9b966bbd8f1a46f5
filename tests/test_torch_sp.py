"""grakel_torch's ShortestPath family against grakel_tpu on JAX-CPU:
the batched Floyd-Warshall bit for bit, ShortestPath's Grams exactly on
every route (direct, observed-distance direct, hash, host sparse),
ShortestPathAttr, CoreFramework and WL-SP, and the host pieces they
use (``sparse_counts_gram``, ``compact_pairs``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.kernels.base import normalize_input
from grakel_torch.ops import floyd_warshall as fw
from grakel_torch.ops import gram as tgram
from grakel_torch.ops import wl as twl
from grakel_tpu.datasets import read_data as jax_read_data
from grakel_tpu.ops import gram as jgram
from grakel_tpu.ops import wl as jwl
from grakel_tpu.ops.floyd_warshall import batched_floyd_warshall as jax_fw

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _batch(seed, n, V, weighted, pad):
    rng = np.random.RandomState(seed)
    A = (rng.rand(n, V, V) < 0.2).astype(np.float32)
    if weighted:
        A *= rng.uniform(0.5, 2.0, (n, V, V)).astype(np.float32)
    A = np.triu(A, 1)
    A = A + A.transpose(0, 2, 1)
    M = np.ones((n, V), bool)
    if pad:
        for g in range(n):
            M[g, rng.randint(1, V + 1):] = False
        # junk in the padding must not leak into S
        A[~(M[:, :, None] & M[:, None, :])] = rng.randint(0, 3)
    return A, M


@pytest.mark.parametrize("weighted,pad", [(False, False), (True, False),
                                          (False, True), (True, True)],
                         ids=["unit", "weighted", "padded",
                              "weighted-padded"])
def test_floyd_warshall_plain_bit_identical_to_jax(weighted, pad):
    A, M = _batch(7, 24, 32, weighted, pad)
    ref = np.asarray(jax_fw(jnp.asarray(A), jnp.asarray(M)))
    S = fw.floyd_warshall_plain(torch.from_numpy(A), torch.from_numpy(M))
    assert np.array_equal(S.numpy().view(np.uint32), ref.view(np.uint32))
    # the dispatcher takes the plain version on the CPU
    S2 = fw.batched_floyd_warshall(torch.from_numpy(A), torch.from_numpy(M))
    assert torch.equal(S2, S)


def test_floyd_warshall_cuda_wrapper_refuses_cpu_tensors():
    A, M = _batch(1, 2, 8, False, False)
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(torch.from_numpy(A), torch.from_numpy(M))


def _data(seed, n=40, weighted=False, labels=5, vmax=20):
    return generate_dataset(
        n_graphs=n, n_graphs_test=8, r_vertices=(3, vmax),
        r_connectivity=(0.1, 0.4), random_state=seed,
        r_weight_edges=(0.5, 2.0) if weighted else (1, 1),
        features=("nl", labels))


def _pair(train, test, attrs=None, normalize=False, **kw):
    """fit_transform, transform and diagonals of grakel_tpu's and the
    port's ShortestPath on the same graphs."""
    out = []
    for mod in (grakel_tpu, grakel_torch):
        k = mod.ShortestPath(normalize=normalize, **kw)
        for a, v in (attrs or {}).items():
            setattr(k, a, v)
        with use_device("cpu"):
            K = k.fit_transform(train)
            T = k.transform(test)
            xd, yd = k.diagonal()
        out.append((np.asarray(K), np.asarray(T), np.asarray(xd),
                    np.asarray(yd), k))
    return out


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("force_hash", [False, True])
def test_shortest_path_matches_jax(with_labels, weighted, force_hash):
    train, test = _data(3, weighted=weighted)
    attrs = {"_DIRECT_MAX_WIDTH": 0} if force_hash else None
    (Kj, Tj, xj, yj, _), (Kt, Tt, xt, yt, kt) = _pair(
        train, test, attrs, with_labels=with_labels)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)
    assert np.array_equal(np.diagonal(Kt), xt)
    with use_device("cpu"):
        route = kt._plan(kt.X)[0]
    assert route == ("hash" if weighted or force_hash else "direct")


@pytest.mark.parametrize("force_hash", [False, True])
def test_shortest_path_normalized_matches_jax(force_hash):
    train, test = _data(5)
    attrs = {"_DIRECT_MAX_WIDTH": 0} if force_hash else None
    (Kj, Tj, *_), (Kt, Tt, *_) = _pair(train, test, attrs, normalize=True)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-12, atol=0)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-12, atol=0)


def test_shortest_path_unseen_labels_extend_enumeration():
    train, test = _data(8)
    (Kj, Tj, _, yj, kj), (Kt, Tt, _, yt, kt) = _pair(train, test)
    # the held-out label is planted in the test split only
    with use_device("cpu"):
        L = kt._plan(kt.X)[1]
    assert len(kt._enum) == len(kj._enum) == L
    assert np.array_equal(Tt, Tj) and np.array_equal(yt, yj)


def test_shortest_path_observed_distance_route():
    """L^2 * max V past the cap, the observed distance range within it:
    D from one device read, the direct route kept."""
    train, test = _data(9, labels=120, vmax=24)
    (Kj, Tj, xj, yj, _), (Kt, Tt, xt, yt, kt) = _pair(train, test)
    with use_device("cpu"):
        route, L, D, fwb = kt._plan(kt.X)
    assert fwb is not None and route == "direct"
    assert L * L * kt.X["max_V"] > kt._DIRECT_MAX_WIDTH
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)


def test_shortest_path_host_sparse_route():
    train, test = _data(4, n=30, weighted=True)
    attrs = {"_SPARSE_GRAM_MIN_REP": 0}
    (Kj, Tj, xj, yj, _), (Kt, Tt, xt, yt, _) = _pair(train, test, attrs)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)


def test_shortest_path_diagonal_after_fit_only():
    train, _ = _data(6, weighted=True)
    kj = grakel_tpu.ShortestPath().fit(train)
    with use_device("cpu"):
        d = grakel_torch.ShortestPath().fit(train).diagonal()
    assert np.array_equal(d, np.asarray(kj.diagonal()))


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_counts_gram_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n, items = 50, 3000
    gids = rng.randint(0, n, items)
    # a few hot columns over many graphs, many narrow ones
    labels = np.where(rng.rand(items) < 0.3, rng.randint(0, 4, items),
                      rng.randint(4, 900, items))
    w = rng.randint(1, 4, items).astype(np.float64)
    for weights in (None, w):
        ref = jgram.sparse_counts_gram(gids, labels, n, weights=weights,
                                       dense_col_mult=8)
        got = tgram.sparse_counts_gram(torch.from_numpy(gids), labels, n,
                                       weights=weights, dense_col_mult=8)
        assert got.dtype == np.float64 and np.array_equal(got, ref)


def test_compact_pairs_matches_host_compact_counts():
    rng = np.random.RandomState(2)
    h1 = rng.randint(0, 6, 5000).astype(np.uint32) * np.uint32(0x9E3779B9)
    h2 = rng.randint(0, 7, 5000).astype(np.uint32) * np.uint32(0x85EBCA6B)
    valid = rng.rand(5000) < 0.8
    ids_j, nu_j, counts_j = jwl.host_compact_counts(h1, h2, valid)
    ids, nu, counts = twl.compact_pairs(
        torch.from_numpy(h1.astype(np.int64)),
        torch.from_numpy(h2.astype(np.int64)), torch.from_numpy(valid))
    assert nu == nu_j and np.array_equal(counts.numpy(), counts_j)
    assert np.array_equal(ids.numpy(), ids_j)


def test_shortest_path_attr_on_cuneiform():
    data = read_data("Cuneiform", path=DATA, prefer_attr_nodes=True).data
    jdata = jax_read_data(
        "Cuneiform", path=DATA, prefer_attr_nodes=True).data
    fit, tr = data[:12], data[30:35]
    kj = grakel_tpu.ShortestPathAttr()
    Kj, Tj = kj.fit_transform(jdata[:12]), kj.transform(jdata[30:35])
    with use_device("cpu"):
        kt = grakel_torch.ShortestPathAttr()
        Kt, Tt = kt.fit_transform(fit), kt.transform(tr)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-9)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-9)


@pytest.mark.parametrize("base", ["default", "wl"])
def test_core_framework_matches_jax(base):
    train, test = _data(11, n=36, vmax=16)
    out = []
    for mod in (grakel_tpu, grakel_torch):
        bk = None if base == "default" else (mod.WeisfeilerLehman,
                                             {"n_iter": 2})
        for normalize in (False, True):
            k = mod.CoreFramework(base_graph_kernel=bk, normalize=normalize)
            with use_device("cpu"):
                out.append((k.fit_transform(train), k.transform(test),
                            k.diagonal()))
    (Kj, Tj, dj), (Kjn, Tjn, _), (Kt, Tt, dt), (Ktn, Ttn, _) = out
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert np.array_equal(dt[0], dj[0]) and np.array_equal(dt[1], dj[1])
    np.testing.assert_allclose(Ktn, Kjn, rtol=1e-12, atol=0)
    np.testing.assert_allclose(Ttn, Tjn, rtol=1e-12, atol=0)


@pytest.mark.parametrize("min_core", [0, 1, 2])
@pytest.mark.parametrize("base", ["default", "wl"])
def test_core_framework_min_core_fit_then_transform_matches_jax(base,
                                                                min_core):
    """CoreFramework at min_core >= 0 (the core levels below it are left
    out), called fit -> transform -> diagonal (no fit_transform first),
    with and without normalize: the JAX package's Grams exactly (integer
    counts), normalized to rtol 1e-12."""
    train, test = _data(13, n=36, vmax=16)
    out = []
    for mod in (grakel_tpu, grakel_torch):
        bk = None if base == "default" else (mod.WeisfeilerLehman,
                                             {"n_iter": 2})
        for normalize in (False, True):
            k = mod.CoreFramework(base_graph_kernel=bk, normalize=normalize,
                                  min_core=min_core)
            with use_device("cpu"):
                T = k.fit(train).transform(test)
                out.append((T,) + tuple(k.diagonal()))
    (Tj, xj, yj), (Tjn, _, _), (Tt, xt, yt), (Ttn, _, _) = out
    assert np.array_equal(Tt, Tj)
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)
    np.testing.assert_allclose(Ttn, Tjn, rtol=1e-12, atol=0)


def test_wl_shortest_path_matches_jax():
    train, test = _data(12, n=36)
    res = []
    for mod in (grakel_tpu, grakel_torch):
        k = mod.WeisfeilerLehman(n_iter=3,
                                 base_graph_kernel=mod.ShortestPath)
        with use_device("cpu"):
            res.append((k.fit_transform(train), k.transform(test),
                        k.diagonal()))
    (Kj, Tj, dj), (Kt, Tt, dt) = res
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert np.array_equal(dt[0], dj[0]) and np.array_equal(dt[1], dj[1])


def _exact_sp_features(graphs, with_labels):
    """Each graph's shortest-path feature counts as a Counter of Python
    ints: (l_u, l_v, d) (or d) over ordered pairs u != v that are
    connected, from the plain Floyd-Warshall."""
    from collections import Counter
    out = []
    for g in normalize_input(graphs):
        A = np.zeros((1, g.n, g.n), np.float32)
        A[0, g.senders, g.receivers] = g.weights
        S = fw.floyd_warshall_plain(torch.from_numpy(A),
                                    torch.ones((1, g.n), dtype=torch.bool))
        S = S[0].numpy()
        labs = g.get_labels(label_type="vertex", return_none=True)
        c = Counter()
        for u in range(g.n):
            for v in range(g.n):
                if u != v and S[u, v] < fw.INF:
                    d = int(S[u, v])
                    c[(labs[u], labs[v], d) if with_labels else d] += 1
        out.append(c)
    return out


@pytest.mark.parametrize("with_labels,force_hash", [
    (False, False), (True, False), (True, True)])
def test_shortest_path_counts_exact_past_2_24(with_labels, force_hash):
    """Graphs past 64 vertices can push a count-Gram entry past 2^24,
    where f32 sums round (here past 2^26: ordered-pair counts of an
    undirected graph are even, so f32 holds their products to 2^26):
    ShortestPath then sums in f64, and its Grams and diagonals equal the
    exact integer Gram of the feature counts, on the direct and the hash
    route."""
    train, test = generate_dataset(
        n_graphs=8, n_graphs_test=3, r_vertices=(150, 200),
        r_connectivity=(0.01, 0.03), random_state=5, features=("nl", 2))
    with use_device("cpu"):
        k = grakel_torch.ShortestPath(with_labels=with_labels)
        if force_hash:
            k._DIRECT_MAX_WIDTH = 0
        K = k.fit_transform(train)
        T = k.transform(test)
        dx, dy = k.diagonal()
    fx = _exact_sp_features(train, with_labels)
    fy = _exact_sp_features(test, with_labels)

    def dot(a, b):
        return sum(v * b[f] for f, v in a.items() if f in b)

    Kx = np.array([[dot(a, b) for b in fx] for a in fx], dtype=object)
    Ty = np.array([[dot(a, b) for b in fx] for a in fy], dtype=object)
    assert Kx.max() > 2 ** 26 and Kx.max() < 2 ** 53
    assert np.array_equal(K, Kx.astype(np.float64))
    assert np.array_equal(T, Ty.astype(np.float64))
    assert np.array_equal(dx, np.diagonal(Kx).astype(np.float64))
    assert np.array_equal(dy, np.array([dot(a, a) for a in fy], np.float64))
