"""Counts-Gram ops and histogram kernels of grakel_torch against
grakel_tpu on JAX-CPU (integer counts: exactly equal)."""

import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset
from grakel_torch.ops import gram as t_gram
from grakel_tpu.ops import gram as j_gram


def _items(seed, n_items, n_graphs, n_labels, integer_weights=True):
    rng = np.random.RandomState(seed)
    gids = rng.randint(0, n_graphs, n_items).astype(np.int32)
    labels = rng.randint(0, n_labels, n_items).astype(np.int32)
    w = rng.randint(1, 4, n_items).astype(np.float32) if integer_weights \
        else rng.rand(n_items).astype(np.float32)
    valid = rng.rand(n_items) < 0.85
    return gids, labels, w, valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n_labels,chunk", [(7, 4096), (300, 128),
                                            (5000, 4096)])
def test_coo_counts_gram_and_diag_equal(n_labels, chunk):
    g, l, w, v = _items(0, 3000, 23, n_labels)
    exp = np.asarray(j_gram.coo_counts_gram(g, l, w, v, 23, n_labels,
                                            chunk=chunk))
    got = t_gram.coo_counts_gram(*_t(g, l, w, v), 23, n_labels, chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)
    d = t_gram.counts_diag(*_t(g, l, w, v), 23, n_labels, chunk=chunk)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(j_gram.counts_diag(g, l, w, v, 23, n_labels,
                                                 chunk=chunk)))
    np.testing.assert_array_equal(d.numpy(), np.diagonal(exp))


@pytest.mark.parametrize("n_labels", [9, 700])
def test_coo_counts_gram_rect_equal(n_labels):
    a = _items(1, 900, 11, n_labels)
    b = _items(2, 1500, 17, n_labels)
    exp = np.asarray(j_gram.coo_counts_gram_rect(*a, *b, 11, 17, n_labels,
                                                 chunk=256))
    got = t_gram.coo_counts_gram_rect(*_t(*a), *_t(*b), 11, 17, n_labels,
                                      chunk=256)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_real_weights_close():
    g, l, w, v = _items(3, 2000, 13, 50, integer_weights=False)
    exp = np.asarray(j_gram.coo_counts_gram(g, l, w, v, 13, 50))
    got = t_gram.coo_counts_gram(*_t(g, l, w, v), 13, 50).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)


def test_normalize_gram_and_chunk_plan_equal():
    rng = np.random.RandomState(4)
    K = rng.randint(0, 50, (9, 6)).astype(np.float32)
    dr = rng.randint(0, 40, 9).astype(np.float32)
    dc = rng.randint(1, 40, 6).astype(np.float32)
    dr[2] = 0.0   # x/0 and 0/0 map to 0, as in the JAX package
    K[2, 3] = 0.0
    exp = j_gram.normalize_gram(K, dr, dc)
    got = t_gram.normalize_gram(torch.from_numpy(K), torch.from_numpy(dr),
                                dc)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, exp)
    for L in (1, 37, 128, 129, 4096, 5000, 100000):
        assert t_gram.chunk_plan(L) == j_gram.chunk_plan(L)


def test_gemm_grams_full_fp32_and_tf32_restored():
    rng = np.random.RandomState(5)
    phi = rng.randint(0, 30, (12, 40)).astype(np.float32)
    psi = rng.randint(0, 30, (5, 33)).astype(np.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = t_gram.gram_gemm(phi, "cpu")
        rect = t_gram.gram_rect(psi, phi, "cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    np.testing.assert_array_equal(got.numpy(), j_gram.gram_gemm(phi))
    np.testing.assert_array_equal(rect.numpy(), j_gram.gram_rect(psi, phi))
    f64 = phi.astype(np.float64)
    np.testing.assert_array_equal(t_gram.gram_gemm(f64, "cpu").numpy(),
                                  j_gram.gram_gemm(f64))


@pytest.mark.parametrize("name,features", [
    ("VertexHistogram", ("nl", 6)), ("EdgeHistogram", ("nl", 3, "el", 4))])
@pytest.mark.parametrize("normalize", [False, True])
def test_histogram_kernels_equal(name, features, normalize):
    train, test = generate_dataset(n_graphs=40, n_graphs_test=8,
                                   r_vertices=(2, 12), random_state=6,
                                   features=features)
    kj = getattr(grakel_tpu, name)(normalize=normalize)
    Kj, Tj = kj.fit_transform(train), kj.transform(test)
    with use_device("cpu"):
        kt = getattr(grakel_torch, name)(normalize=normalize)
        Kt, Tt = kt.fit_transform(train), kt.transform(test)
        xd, yd = kt.diagonal()
    # edgeless graphs have a zero self-kernel: NaN rows when normalized,
    # in both packages (the reference's plain division)
    np.testing.assert_array_equal(Kt, Kj)
    np.testing.assert_array_equal(Tt, Tj)
    jxd, jyd = kj.diagonal()
    np.testing.assert_array_equal(xd, jxd)
    np.testing.assert_array_equal(yd, jyd)


def _toy_kernels(base):
    """A feature-map kernel and a pairwise kernel on a package's Kernel
    base: they exercise the base's GEMM and host-loop Gram paths."""
    class Feat(base.Kernel):
        def parse_input(self, X):
            return base.normalize_input(X)

        def _feature_matrix(self, graphs):
            return np.array([[g.n, g.nb_edges(), 1.0] for g in graphs],
                            np.float32)

    class Pair(base.Kernel):
        def parse_input(self, X):
            return base.normalize_input(X)

        def pairwise_operation(self, x, y):
            return float(min(x.n, y.n) + x.nb_edges() * y.nb_edges())

    return Feat, Pair


@pytest.mark.parametrize("which", [0, 1], ids=["feature_map", "pairwise"])
@pytest.mark.parametrize("normalize", [False, True])
def test_kernel_base_gram_paths_equal(which, normalize):
    import grakel_tpu.kernels.base as j_base
    import grakel_torch.kernels.base as t_base
    train, test = generate_dataset(n_graphs=20, n_graphs_test=5,
                                   r_vertices=(2, 9), random_state=8)
    kj = _toy_kernels(j_base)[which](normalize=normalize)
    Kj, Tj = kj.fit_transform(train), kj.transform(test)
    with use_device("cpu"):
        kt = _toy_kernels(t_base)[which](normalize=normalize)
        Kt, Tt = kt.fit_transform(train), kt.transform(test)
        xd, yd = kt.diagonal()
    np.testing.assert_array_equal(Kt, Kj)
    np.testing.assert_array_equal(Tt, Tj)
    jxd, jyd = kj.diagonal()
    np.testing.assert_array_equal(xd, jxd)
    np.testing.assert_array_equal(yd, jyd)
