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
from grakel_torch.kernels.base import normalize_input
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
    """u32 hashes as int32 bit patterns."""
    return torch.from_numpy(h.view(np.int32))


def _pair_key(h1, h2):
    """The compaction key of u32 hash pairs: the packed u64 ``h1 << 32 |
    h2`` with its top bit flipped, read as int64 (signed order = unsigned
    order of the pair)."""
    u = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
    return torch.from_numpy((u ^ np.uint64(1 << 63)).view(np.int64))


def _compact_pairs(h1, h2, valid):
    """compact_key_ids of u32 hash pairs."""
    return t_wl.compact_key_ids(_pair_key(h1, h2), torch.from_numpy(valid))


def _csr_inputs(seed, n=200, e=700):
    """COO edges with invalid ones, edges into the padding nodes' range
    masked off, self-loops and isolated nodes (the last 20 nodes have no
    valid edge)."""
    labels, s, r, ev = _hash_inputs(seed, n=n, e=e)
    rng = np.random.RandomState(seed + 100)
    s[:40] = r[:40] = rng.randint(0, n - 20, 40)          # self-loops
    s[40:] = np.minimum(s[40:], n - 21)
    r[40:] = np.minimum(r[40:], n - 21)
    s[-30:] = r[-30:] = n - 1                              # padding edges
    ev[-30:] = False
    return labels, s, r, ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_plain_hash_bit_identical(seed):
    labels, s, r, ev = _csr_inputs(seed)
    t = [torch.from_numpy(x) for x in (labels, s, r, ev)]
    offsets, targets = t_wl.csr_from_edges(t[1], t[2], t[3], len(labels))
    assert offsets.dtype == targets.dtype == torch.int32
    assert int(offsets[-1]) == int(ev.sum())
    key = t_wl._wl_hash_refine_csr(t[0], offsets, targets)
    assert key.dtype == torch.int64
    h1, h2 = t_wl.key_hashes(key)
    p1, p2 = t_wl.wl_hash_refine_plain(*t)
    assert torch.equal(h1, p1) and torch.equal(h2, p2)
    n1, n2 = j_wl.host_hash_refine(labels, s, r, ev)
    np.testing.assert_array_equal(h1.numpy().view(np.uint32), n1)
    np.testing.assert_array_equal(h2.numpy().view(np.uint32), n2)
    assert torch.equal(key, _pair_key(n1, n2))
    # isolated nodes hash their own label only
    e1, e2 = t_wl.wl_hash_refine_plain(t[0][-20:], *(x[:0] for x in t[1:]))
    assert torch.equal(h1[-20:], e1) and torch.equal(h2[-20:], e2)


def test_compaction_key_form_matches_pair_form():
    """Keys rank as the hash pairs do: compact_key_ids gives the ids and
    counts of a lexicographic np.unique over (h1, h2) as unsigned."""
    labels, s, r, ev = _hash_inputs(4, n=400, big_labels=False)
    h1, h2 = j_wl.host_hash_refine(labels, s, r, ev)
    h1[:50] = h1[50:100]
    h2[:30] = h2[50:80]
    h1[100:110] = 0x80000000
    valid = np.random.RandomState(8).rand(400) < 0.85
    ids, nu, counts = _compact_pairs(h1, h2, valid)
    pairs = np.stack([h1[valid], h2[valid]], 1)
    uniq, inv, cnt = np.unique(pairs, axis=0, return_inverse=True,
                               return_counts=True)
    assert nu == len(uniq) + 1                      # + the invalid rows
    np.testing.assert_array_equal(ids.numpy()[valid], inv.ravel())
    assert (ids.numpy()[~valid] == len(uniq)).all()
    np.testing.assert_array_equal(counts.numpy()[:-1], cnt)
    assert int(counts[-1]) == int((~valid).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_key_hashes_unpack_the_key(seed):
    rng = np.random.RandomState(seed)
    h1 = rng.randint(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    h2 = rng.randint(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    h1[:4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    h2[:4] = [0xFFFFFFFF, 0x80000000, 0, 0x7FFFFFFF]
    g1, g2 = t_wl.key_hashes(_pair_key(h1, h2))
    assert g1.dtype == g2.dtype == torch.int32
    assert torch.equal(g1, _i32(h1)) and torch.equal(g2, _i32(h2))


def test_graph_batch_csr_matches_edges_and_checks_endpoints():
    train, _ = generate_dataset(n_graphs=12, n_graphs_test=2,
                                r_vertices=(1, 9), random_state=3,
                                features=("nl", 4))
    graphs = normalize_input(train)
    b = grakel_torch.GraphBatch.from_graphs(graphs, device="cpu")
    N_pad, E = b.node_labels.shape[0], b.total_edges
    assert b.csr_offsets.shape == (N_pad + 1,)
    assert b.csr_targets.shape == (E,)
    off, tgt = t_wl.csr_from_edges(b.senders, b.receivers, b.edge_mask,
                                   N_pad)
    assert torch.equal(b.csr_offsets, off)
    assert torch.equal(b.csr_targets, tgt[:E])
    Gr = grakel_torch.Graph
    for bad in ([Gr.from_arrays(3, [0, 3], [1, 0])],        # sender == N
                [Gr.from_arrays(3, [0, 1], [1, -1])],       # receiver < 0
                [Gr.from_arrays(3, [], []),                 # past the last
                 Gr.from_arrays(3, [0, 1], [1, 3])]):
        with pytest.raises(ValueError, match="outside the batch"):
            grakel_torch.GraphBatch.from_graphs(bad, device="cpu")
    empty = grakel_torch.GraphBatch.from_graphs(
        [Gr.from_arrays(2, [], [])], device="cpu")
    assert empty.csr_targets.shape == (0,)
    assert int(empty.csr_offsets.abs().sum()) == 0


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
    ids, nu, counts = _compact_pairs(h1, h2, valid)
    jids, jnu, jcounts = j_wl.host_compact_counts(h1, h2, valid)
    assert nu == jnu
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(counts.numpy(), jcounts)


def test_compaction_orders_unsigned():
    h1 = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 0x80000000],
                  np.uint32)
    h2 = np.array([0, 1, 0xFFFFFFFF, 5, 0], np.uint32)
    valid = np.array([True, True, True, True, False])
    ids, nu, counts = _compact_pairs(h1, h2, valid)
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
    ids, _, counts = _compact_pairs(h1, h2, valid)
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


def _exact_wl_grams(fit, test, n_iter):
    """Exact WL-VH Grams (fit x fit, test x fit) in Python integers: each
    node's credential is its label and its out-neighbours' sorted labels,
    ids shared by all graphs, features counted per generation."""
    from collections import Counter
    graphs = normalize_input(list(fit) + list(test))
    feats = []
    for g in graphs:
        nbrs = [[] for _ in range(g.n)]
        for s, r in zip(g.senders.tolist(), g.receivers.tolist()):
            nbrs[s].append(r)
        feats.append((nbrs, [g.get_labels()[v] for v in range(g.n)],
                      Counter()))
    cur = [f[1] for f in feats]
    for it in range(n_iter + 1):
        for (_, _, c), labs in zip(feats, cur):
            c.update((it, lab) for lab in labs)
        mapping = {}
        cur = [[mapping.setdefault(
            (labs[v], tuple(sorted(labs[u] for u in nbrs[v]))),
            len(mapping)) for v in range(len(labs))]
            for (nbrs, _, _), labs in zip(feats, cur)]
    cs = [f[2] for f in feats]

    def dot(a, b):
        return sum(v * b[k] for k, v in a.items() if k in b)

    nf = len(fit)
    K = np.array([[dot(a, b) for b in cs[:nf]] for a in cs[:nf]], object)
    T = np.array([[dot(a, b) for b in cs[:nf]] for a in cs[nf:]], object)
    return K, T


@pytest.fixture(scope="module")
def wl_large():
    """Six unlabeled-like train graphs of 5802-6374 vertices (two labels)
    and two test graphs: WL-VH entries up to ~1.5e8 at n_iter = 5."""
    train, test = generate_dataset(
        n_graphs=8, n_graphs_test=2, r_vertices=(5500, 6500),
        r_connectivity=(0.001, 0.002), random_state=3, features=("nl", 2))
    return train, test, _exact_wl_grams(train, test, 5)


@pytest.mark.parametrize("call", ["fit_transform", "transform",
                                  "general_path"])
def test_wl_counts_exact_past_2_24(wl_large, call):
    """A WL-VH entry is at most (n_iter + 1) max_n^2; past 2^24 an f32
    sum of counts rounds, so the port sums in f64 there and its Grams and
    diagonals equal the exact integer Gram.  The general path (a base
    kernel with parameters) sums its f64 base Grams in f64."""
    train, test, (Kx, Tx) = wl_large
    assert Kx.max() > 2 ** 24 and Kx.max() < 2 ** 53
    with use_device("cpu"):
        if call == "general_path":
            kt = grakel_torch.WeisfeilerLehman(
                n_iter=5, base_graph_kernel=(grakel_torch.VertexHistogram,
                                             {"sparse": True}))
        else:
            kt = grakel_torch.WeisfeilerLehman(n_iter=5)
        K = kt.fit_transform(train)
        assert np.array_equal(K, Kx.astype(np.float64))
        assert np.array_equal(kt.diagonal(), np.diagonal(Kx).astype(float))
        if call != "fit_transform":
            T = kt.transform(test)
            assert np.array_equal(T, Tx.astype(np.float64))
