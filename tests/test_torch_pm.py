"""PyramidMatch and its ops in grakel_torch against grakel_tpu on
JAX-CPU: the plain min-intersection (the CPU side of K1) against the
Pallas kernel in interpret mode, the Lanczos embeddings against JAX's
and scipy's, and the PM Grams on the dense, sparse and fallback paths.

ARPACK's start vector depends on the process's call history, so a graph
with a repeated eigenvalue gets a different eigenvector basis each time
it is embedded.  The Gram comparisons therefore hand the port the
embeddings grakel_tpu computed for the same graphs (they sit in each
Graph's structural cache), which isolates what the port computes:
histograms, level Grams and their combination."""

import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_tpu.ops.intersect
import grakel_torch
from grakel_torch import use_device
from grakel_torch.graph import Graph as TGraph
from grakel_torch.ops.intersect import min_gram_plain, min_intersection_gram
from grakel_torch.ops.spectral import batched_topd_abs_eigvecs as t_embed
from grakel_tpu.graph import Graph as JGraph
from grakel_tpu.ops.intersect import min_intersection_gram as j_min_gram
from grakel_tpu.ops.spectral import batched_topd_abs_eigvecs as j_embed


@pytest.mark.parametrize("n,m,L,integer", [
    (10, 7, 30, True), (64, 32, 600, True), (8, 128, 512, True),
    (37, 101, 333, True), (1, 5, 7, True),
    (20, 33, 700, False), (37, 101, 333, False), (3, 2, 1, False)])
def test_plain_min_gram_matches_pallas_interpret(n, m, L, integer):
    rng = np.random.RandomState(n * 1000 + L)
    if integer:
        A = rng.randint(0, 5, (n, L)).astype(np.float32)
        B = rng.randint(0, 5, (m, L)).astype(np.float32)
    else:
        A = rng.rand(n, L).astype(np.float32)
        B = rng.rand(m, L).astype(np.float32)
    exp = j_min_gram(A, B, force_pallas=True)
    got = min_intersection_gram(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.float32 and got.shape == (n, m)
    if integer:
        np.testing.assert_array_equal(got.numpy(), exp)
    else:
        # f32 sums in another order than the Pallas kernel's
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-4)


def test_min_gram_defaults_and_tiles():
    rng = np.random.RandomState(9)
    A = torch.from_numpy(rng.randint(0, 7, (70, 19)).astype(np.float64))
    K = min_intersection_gram(A)
    ref = torch.minimum(A[:, None, :], A[None, :, :]).sum(-1).float()
    assert torch.equal(K, ref)
    assert torch.equal(min_gram_plain(A.float(), A.float(), tile=7), ref)
    with pytest.raises(ValueError):
        min_intersection_gram(A, A[:, :5])


def _big_graphs(seed=5, count=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        n = rng.randint(130, 200)
        A = (rng.rand(n, n) < 0.05).astype(float)
        A = np.triu(A, 1)
        out.append(A + A.T)
    return out


def test_lanczos_embeddings_match_jax_and_scipy():
    adjm = _big_graphs()
    coo = []
    for i, A in enumerate(adjm):
        r, c = np.nonzero(A)
        coo.append((i, A.shape[0], r.astype(np.int32), c.astype(np.int32),
                    A[r, c].astype(np.float32)))
    got = t_embed(coo, 6, torch.device("cpu"))
    jax_u = j_embed(coo, 6)
    pm = grakel_torch.PyramidMatch()
    pm.initialize()
    for i, A in enumerate(adjm):
        assert got[i].shape == (A.shape[0], 6) and got[i].dtype == np.float64
        np.testing.assert_allclose(got[i], jax_u[i], atol=2e-4)
        np.testing.assert_allclose(got[i], pm._embed(A), atol=2e-4)


def _pm_data(seed, count, with_big=False):
    rng = np.random.RandomState(seed)
    graphs = []
    for i in range(count):
        n = rng.randint(4, 14)
        A = (rng.rand(n, n) < 0.35).astype(float)
        A = np.triu(A, 1)
        graphs.append([A + A.T, {v: int(rng.randint(0, 6))
                                 for v in range(n)}, {}])
    if with_big:
        graphs += [[A, {v: v % 3 for v in range(A.shape[0])}, {}]
                   for A in _big_graphs(seed, 2)]
    return graphs


def _twins(items):
    return ([JGraph(*it) for it in items], [TGraph(*it) for it in items])


def _share_embeddings(jg, tg, d=6):
    key = "pm_embed_%d" % d
    for a, b in zip(jg, tg):
        b._cache[key] = a._cache[key]


def _pm_both(kw, fit, test, dense_max_w=None):
    jf, tf = _twins(fit)
    jt, tt = _twins(test)
    kj = grakel_tpu.PyramidMatch(**kw)
    kt = grakel_torch.PyramidMatch(**kw)
    if dense_max_w is not None:
        kj._DENSE_MAX_W = kt._DENSE_MAX_W = dense_max_w
    Kj, Tj = kj.fit_transform(jf), kj.transform(jt)
    _share_embeddings(jf, tf, kw.get("d", 6))
    _share_embeddings(jt, tt, kw.get("d", 6))
    with use_device("cpu"):
        Kt, Tt = kt.fit_transform(tf), kt.transform(tt)
        dt = kt.diagonal()
    assert kt._sparse_mode == kj._sparse_mode
    return (Kt, Tt, dt), (Kj, Tj, kj.diagonal())


PM_KW = [{}, {"normalize": True}, {"with_labels": False},
         {"with_labels": False, "normalize": True}, {"L": 2, "d": 3}]


@pytest.mark.parametrize("kw", PM_KW, ids=str)
def test_pm_dense_grams_equal(kw):
    data = _pm_data(5, 30)   # transform graphs hold labels unseen at fit
    for v in data[-1][1]:
        data[-1][1][v] = 99
    (Kt, Tt, dt), (Kj, Tj, dj) = _pm_both(kw, data[:22], data[22:])
    np.testing.assert_array_equal(Kt, Kj)
    np.testing.assert_array_equal(Tt, Tj)
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", PM_KW[:3], ids=str)
def test_pm_jax_fallback_path_equal(kw, monkeypatch):
    """With the JAX package's threshold GEMM ruled out, its per-level
    _intersections + _combine path runs: the port's one route (K1 per
    level, integer-weighted sum) gives the same Grams."""
    monkeypatch.setattr(grakel_tpu.ops.intersect, "_GEMM_MAX_T", 1)
    data = _pm_data(6, 26)
    (Kt, Tt, _), (Kj, Tj, _) = _pm_both(kw, data[:20], data[20:])
    np.testing.assert_array_equal(Kt, Kj)
    np.testing.assert_array_equal(Tt, Tj)


@pytest.mark.parametrize("kw", PM_KW[:3], ids=str)
def test_pm_sparse_path_close(kw):
    """Sparse unary path forced via _DENSE_MAX_W = 0: weighted by
    sqrt(c_p), so the f32 sums differ from JAX's in order only."""
    data = _pm_data(7, 24)
    (Kt, Tt, dt), (Kj, Tj, dj) = _pm_both(kw, data[:16], data[16:],
                                          dense_max_w=0)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-5, atol=1e-5)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_pm_with_device_embeddings_equal(normalize):
    """>= 128-vertex graphs take each package's own Lanczos (f32, other
    summation orders); on these graphs the embeddings agree to well
    inside every histogram cell, so the large graphs' Gram block is
    equal."""
    data = _pm_data(8, 6, with_big=True)
    kw = {"with_labels": False, "normalize": normalize}
    Kj = grakel_tpu.PyramidMatch(**kw).fit_transform(data)
    with use_device("cpu"):
        Kt = grakel_torch.PyramidMatch(**kw).fit_transform(data)
    assert Kt.shape == Kj.shape and np.isfinite(Kt).all()
    np.testing.assert_array_equal(Kt[-2:, -2:], Kj[-2:, -2:])
