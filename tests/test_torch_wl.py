"""WL refinement ops and the WL-VH kernel of grakel_torch against
grakel_tpu on JAX-CPU: the plain K2 hash is bit-identical to both
``wl_hash_refine`` and ``host_hash_refine``, compaction ranks hash pairs
in unsigned order, and the Grams are exactly equal."""

import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset
from grakel_torch.ops import wl as t_wl
from grakel_tpu.ops import wl as j_wl


def _hash_inputs(seed, n=300, e=900, big_labels=True):
    rng = np.random.RandomState(seed)
    hi = 2 ** 31 - 1 if big_labels else 40
    labels = rng.randint(0, hi, n).astype(np.int32)
    s = rng.randint(0, n, e).astype(np.int32)
    r = rng.randint(0, n, e).astype(np.int32)
    ev = rng.rand(e) < 0.7
    return labels, s, r, ev


@pytest.mark.parametrize("seed,big", [(0, True), (1, False), (2, True)])
def test_plain_hash_bit_identical_to_jax_and_numpy(seed, big):
    labels, s, r, ev = _hash_inputs(seed, big_labels=big)
    h1, h2 = t_wl.wl_hash_refine(*map(torch.from_numpy, (labels, s, r, ev)))
    assert h1.dtype == torch.int32 and h2.dtype == torch.int32
    j1, j2 = (np.asarray(x) for x in j_wl.wl_hash_refine(labels, s, r, ev))
    n1, n2 = j_wl.host_hash_refine(labels, s, r, ev)
    for got, a, b in ((h1, j1, n1), (h2, j2, n2)):
        u = got.numpy().view(np.uint32)
        np.testing.assert_array_equal(u, a)
        np.testing.assert_array_equal(u, b)
    # the hashes span the full u32 range, so the int32 view carries
    # negative values that compaction must read as unsigned
    assert (h1 < 0).any() and (h1 >= 0).any()


def _i32(h):
    """u32 hashes as the int32 bit patterns K2 returns."""
    return torch.from_numpy(h.view(np.int32))


def test_compaction_matches_host_compact_counts():
    labels, s, r, ev = _hash_inputs(3, n=500, big_labels=False)
    h1, h2 = j_wl.host_hash_refine(labels, s, r, ev)
    rng = np.random.RandomState(5)
    valid = rng.rand(500) < 0.8
    # repeated pairs, pairs equal in h1 only, and values >= 2^31
    h1[:40] = h1[40:80]
    h2[:20] = h2[40:60]
    h1[100:110] = 0x80000000
    h1[110:120] = 0x7FFFFFFF
    h1[120:125] = 0xFFFFFFFF
    ids, nu, counts = t_wl.compact_ids(
        _i32(h1), _i32(h2), torch.from_numpy(valid))
    jids, jnu, jcounts = j_wl.host_compact_counts(h1, h2, valid)
    assert nu == jnu
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(counts.numpy(), jcounts)


def test_compaction_orders_unsigned():
    h1 = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 0x80000000],
                  np.uint32)
    h2 = np.array([0, 1, 0xFFFFFFFF, 5, 0], np.uint32)
    valid = np.array([True, True, True, True, False])
    ids, nu, counts = t_wl.compact_ids(
        _i32(h1), _i32(h2), torch.from_numpy(valid))
    assert ids.tolist() == [3, 2, 1, 0, 4] and nu == 5
    assert counts.tolist() == [1, 1, 1, 1, 1]


def test_split_singletons_matches():
    rng = np.random.RandomState(7)
    n, n_graphs = 400, 30
    gids = np.sort(rng.randint(0, n_graphs, n)).astype(np.int32)
    valid = rng.rand(n) < 0.9
    h1 = rng.randint(0, 60, n).astype(np.uint32)
    h2 = np.zeros(n, np.uint32)
    jids, _, jcounts = j_wl.host_compact_counts(h1, h2, valid)
    ids, _, counts = t_wl.compact_ids(_i32(h1), _i32(h2),
                                      torch.from_numpy(valid))
    got = t_wl.split_singletons(ids, counts, torch.from_numpy(valid),
                                torch.from_numpy(gids), n_graphs)
    exp = j_wl.split_singletons(jids, jcounts, valid, gids, n_graphs)
    np.testing.assert_array_equal(got[0].numpy(), exp[0])
    np.testing.assert_array_equal(got[1].numpy(), exp[1])
    assert got[2] == exp[2]
    np.testing.assert_array_equal(got[3].numpy(), exp[3])


@pytest.fixture(scope="module")
def wl_data():
    return generate_dataset(n_graphs=48, n_graphs_test=8, r_vertices=(3, 14),
                            random_state=11, features=("nl", 5))


@pytest.mark.parametrize("n_iter", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("normalize", [False, True])
def test_wl_vh_grams_equal(wl_data, n_iter, normalize):
    train, test = wl_data   # test holds labels unseen at fit
    kj = grakel_tpu.WeisfeilerLehman(n_iter=n_iter, normalize=normalize)
    Kj, Tj = kj.fit_transform(train), kj.transform(test)
    with use_device("cpu"):
        kt = grakel_torch.WeisfeilerLehman(n_iter=n_iter,
                                           normalize=normalize)
        Kt, Tt = kt.fit_transform(train), kt.transform(test)
        xd, yd = kt.diagonal()
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    jxd, jyd = kj.diagonal()
    assert np.array_equal(xd, jxd) and np.array_equal(yd, jyd)


def test_wl_fit_then_diagonal_and_transform(wl_data):
    train, test = wl_data
    kj = grakel_tpu.WeisfeilerLehman(n_iter=3).fit(train)
    with use_device("cpu"):
        kt = grakel_torch.WeisfeilerLehman(n_iter=3).fit(train)
        assert np.array_equal(kt.diagonal(), kj.diagonal())
        assert np.array_equal(kt.transform(test), kj.transform(test))


@pytest.mark.parametrize("normalize", [False, True])
def test_wl_general_path_equal(wl_data, normalize):
    train, test = wl_data
    kj = grakel_tpu.WeisfeilerLehman(
        n_iter=3, normalize=normalize,
        base_graph_kernel=(grakel_tpu.VertexHistogram, {"sparse": True}))
    Kj, Tj = kj.fit_transform(train), kj.transform(test)
    with use_device("cpu"):
        kt = grakel_torch.WeisfeilerLehman(
            n_iter=3, normalize=normalize,
            base_graph_kernel=(grakel_torch.VertexHistogram,
                               {"sparse": True}))
        Kt, Tt = kt.fit_transform(train), kt.transform(test)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)


@pytest.mark.slow
def test_wl_vh_nci1_scale_equal():
    """The 4110-graph set bench.py times (generate_dataset, seed 1234)."""
    train, test = generate_dataset(
        n_graphs=4110 + 16, n_graphs_test=16, r_vertices=(10, 50),
        r_connectivity=(0.07, 0.15), random_state=1234,
        features=("nl", 37))
    kj = grakel_tpu.WeisfeilerLehman(n_iter=5)
    Kj, Tj = kj.fit_transform(train), kj.transform(test)
    with use_device("cpu"):
        kt = grakel_torch.WeisfeilerLehman(n_iter=5)
        Kt, Tt = kt.fit_transform(train), kt.transform(test)
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
