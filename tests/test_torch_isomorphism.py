"""grakel_torch's isomorphism layer against grakel_tpu on JAX-CPU: the
canonical codes of small graphlets (``ops.canonical``, K7's plain
version) bit for bit at every size, the connected-subset enumeration,
and ``canonical_labeling`` / ``canonical_form`` / ``is_isomorphic`` with
the two ``Graph`` methods on the cases of ``tests/test_isomorphism.py``.
All results are integers or bytes: equal, no tolerance."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grakel_torch
import grakel_tpu
from grakel_torch import isomorphism as tiso
from grakel_torch import use_device
from grakel_torch.ops import canonical as tcan
from grakel_torch.ops import consubg as tcs
from grakel_tpu import isomorphism as jiso
from grakel_tpu.ops import canonical as jcan
from grakel_tpu.ops import consubg as jcs
from jax_native_ref import jax_native  # noqa: F401 (fixture)

# the expected values come from grakel_tpu's native engine: load it
# first (see jax_native_ref)
pytestmark = pytest.mark.usefixtures("jax_native")


def rand_graph(n, p, seed):
    r = np.random.RandomState(seed)
    A = (r.rand(n, n) < p).astype(int)
    A = np.triu(A, 1)
    return A + A.T


def brute_iso(A, B):
    n = A.shape[0]
    return any((A[np.ix_(P, P)] == B).all()
               for P in map(np.array, itertools.permutations(range(n))))


def _graphlets(s, count, seed, directed=False):
    rng = np.random.RandomState(seed)
    A = (rng.rand(count, s, s) < rng.rand(count, 1, 1)).astype(int)
    if not directed:
        A = np.triu(A, 1)
        A = A | A.transpose(0, 2, 1)
    return list(A)


@pytest.mark.parametrize("s", range(1, 9))
@pytest.mark.parametrize("directed", [False, True])
def test_canonical_codes_bit_identical_to_jax(s, directed):
    """Random graphlets of every density (directed ones are symmetrized,
    self loops never read) through the port's ``canonical_codes`` on the
    CPU (the plain version) equal the JAX package's codes."""
    adjs = _graphlets(s, 400 if s < 8 else 80, 100 + s, directed)
    if directed:
        for a in adjs[:20]:
            np.fill_diagonal(a, 1)
    with use_device("cpu"):
        ours = tcan.canonical_codes(adjs)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, jcan.canonical_codes(adjs))


@pytest.mark.parametrize("s", range(2, 9))
def test_canonical_codes_plain_matches_codes_impl(s):
    """The plain version on the int64 masks equals ``_codes_impl`` on the
    flat 0/1 adjacency it replaces."""
    adjs = _graphlets(s, 200 if s < 8 else 40, 7 * s)
    masks = torch.from_numpy(tcan.adjacency_masks(adjs))
    flat = np.stack(adjs).reshape(len(adjs), s * s).astype(np.int32)
    ref = np.asarray(jcan._codes_impl(jnp.asarray(flat), s))
    np.testing.assert_array_equal(
        tcan.canonical_codes_plain(masks, s).numpy(), ref)


@pytest.mark.parametrize("s", range(2, 9))
def test_perm_table_lists_permutations_in_order(s):
    """K7's table: the s! permutations in itertools' lexicographic order,
    element i of each at bits 4 i .. 4 i + 3 of one uint32."""
    table = tcan.perm_table(s)
    perms = list(itertools.permutations(range(s)))
    assert table.dtype == np.uint32 and table.shape == (len(perms),)
    unpacked = [tuple(int(w >> (4 * i)) & 15 for i in range(s))
                for w in table.tolist()]
    assert unpacked == perms
    assert all(int(w) >> (4 * s) == 0 for w in table.tolist())


@pytest.mark.parametrize("s", range(2, 9))
def test_canonical_codes_walk_plain_equals_codes_impl(s):
    """K7's table walk (the key of each permutation, its minimum, packed
    into the code), in torch, equals the plain gather-and-min and the JAX
    package's ``_codes_impl``, on random graphlets with the empty and the
    complete graphlet among them."""
    adjs = _graphlets(s, 60 if s < 8 else 12, 3 * s + 1)
    adjs[0][:] = 0
    adjs[1][:] = 1 - np.eye(s, dtype=adjs[1].dtype)
    masks = torch.from_numpy(tcan.adjacency_masks(adjs))
    walk = tcan.canonical_codes_walk_plain(masks, s)
    np.testing.assert_array_equal(
        walk.numpy(), tcan.canonical_codes_plain(masks, s).numpy())
    flat = np.stack(adjs).reshape(len(adjs), s * s).astype(np.int32)
    np.testing.assert_array_equal(
        walk.numpy(), np.asarray(jcan._codes_impl(jnp.asarray(flat), s)))


def test_canonical_codes_isomorphism_classes():
    """Every permutation of a graphlet has its code; at s = 5 the codes
    of all graphs split into the 34 isomorphism classes."""
    rng = np.random.RandomState(5)
    A = _graphlets(6, 30, 9)
    perms = [a[np.ix_(p, p)] for a in A for p in
             (rng.permutation(6) for _ in range(4))]
    with use_device("cpu"):
        c = tcan.canonical_codes(A)
        cp = tcan.canonical_codes(perms)
    np.testing.assert_array_equal(np.repeat(c, 4), cp)
    every = []
    for bits in range(1 << 10):
        M = np.zeros((5, 5), int)
        M[np.triu_indices(5, 1)] = [(bits >> k) & 1 for k in range(10)]
        every.append(M + M.T)
    with use_device("cpu"):
        assert len(set(tcan.canonical_codes(every).tolist())) == 34


def test_canonical_codes_rejects_large_and_empty():
    with use_device("cpu"):
        assert tcan.canonical_codes([]).shape == (0,)
        with pytest.raises(ValueError):
            tcan.canonical_codes([np.zeros((9, 9))])


def test_canonical_codes_cuda_wrapper_refuses_cpu_tensors():
    masks = torch.from_numpy(tcan.adjacency_masks(_graphlets(5, 3, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        tcan.canonical_codes_cuda(masks, 5)


@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_connected_subsets_native_plain_and_jax_agree(k):
    for seed in range(6):
        A = rand_graph(9, 0.3, 400 + seed)
        G = {i: set(np.flatnonzero(A[i]).tolist()) for i in range(9)}
        ours = tcs.connected_subsets(G, k)
        assert ours == tcs.connected_subsets_plain(G, k)
        assert ours == jcs.connected_subsets(G, k)


def test_canonical_form_matches_jax_and_is_invariant():
    rng = np.random.RandomState(0)
    for t in range(60):
        n = rng.randint(2, 9)
        A = rand_graph(n, rng.rand() * 0.8 + 0.1, 1000 + t)
        p = rng.permutation(n)
        f = tiso.canonical_form(A)
        assert f == jiso.canonical_form(A)
        assert f == tiso.canonical_form(A[np.ix_(p, p)])


def test_vs_brute_force_pairs():
    gs = [rand_graph(6, 0.5, 3000 + i) for i in range(12)]
    for i in range(len(gs)):
        for j in range(i + 1, len(gs)):
            same = tiso.canonical_form(gs[i]) == tiso.canonical_form(gs[j])
            assert same == brute_iso(gs[i], gs[j])
            assert tiso.is_isomorphic(gs[i], gs[j]) == same \
                == jiso.is_isomorphic(gs[i], gs[j])


@pytest.mark.parametrize("directed", [False, True])
def test_native_and_plain_engines_agree(directed):
    """The native engine's labeling equals the JAX package's (the same
    source), and the plain Python engine gives an isomorphic relabeling
    and the same canonical form bytes."""
    for i in range(20):
        A = rand_graph(7, 0.4, 5000 + i)
        if directed:
            A = np.triu(A) + (np.tril(A) * (np.random.RandomState(i).rand(
                7, 7) < 0.5))
        n, src, dst = tiso._as_edges(A)
        c = tiso._rank_colors(None, n)
        pn = tiso.canonical_labeling(A, directed=directed)
        np.testing.assert_array_equal(
            pn, jiso.canonical_labeling(A, directed=directed))
        pp = tiso._canonical_py(n, src, dst, c, directed)
        np.testing.assert_array_equal(
            pp, jiso._canonical_py(n, src, dst, c, directed))
        inv = np.empty(n, int)
        inv[pn] = np.arange(n)
        inv2 = np.empty(n, int)
        inv2[pp] = np.arange(n)
        assert brute_iso(A[np.ix_(inv, inv)], A[np.ix_(inv2, inv2)])


def test_relabel_identity():
    rng = np.random.RandomState(3)
    for i in range(20):
        A = rand_graph(7, 0.4, 7000 + i)
        p = rng.permutation(7)
        B = A[np.ix_(p, p)]
        pa, pb = tiso.canonical_labeling(A), tiso.canonical_labeling(B)
        np.testing.assert_array_equal(pa, jiso.canonical_labeling(A))
        ia = np.empty(7, int)
        ia[pa] = np.arange(7)
        ib = np.empty(7, int)
        ib[pb] = np.arange(7)
        assert (A[np.ix_(ia, ia)] == B[np.ix_(ib, ib)]).all()


def test_colored_isomorphism():
    A = rand_graph(6, 0.5, 42)
    p = np.random.RandomState(1).permutation(6)
    B = A[np.ix_(p, p)]
    c1 = {i: i % 2 for i in range(6)}
    c2 = {int(np.where(p == i)[0][0]): i % 2 for i in range(6)}
    zero = {i: 0 for i in range(6)}
    for mod in (tiso, jiso):
        assert mod.is_isomorphic(A, B, c1, c2)
        assert not mod.is_isomorphic(A, B, c1, zero)
    assert tiso.canonical_form(A, c1) == jiso.canonical_form(A, c1)
    assert tiso.canonical_form(A, ["x", "y"] * 3) \
        == jiso.canonical_form(A, ["x", "y"] * 3)


def test_regular_graph_pruning():
    pet = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 5), (1, 6), (2, 7),
           (3, 8), (4, 9), (5, 7), (7, 9), (9, 6), (6, 8), (8, 5)]
    P = np.zeros((10, 10), int)
    for a, b in pet:
        P[a, b] = P[b, a] = 1
    q = np.random.RandomState(2).permutation(10)
    assert tiso.canonical_form(P) == tiso.canonical_form(P[np.ix_(q, q)]) \
        == jiso.canonical_form(P)
    K33 = np.zeros((6, 6), int)
    for a in range(3):
        for b in range(3, 6):
            K33[a, b] = K33[b, a] = 1
    prism = np.zeros((6, 6), int)
    for a, b in [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3),
                 (0, 3), (1, 4), (2, 5)]:
        prism[a, b] = prism[b, a] = 1
    assert tiso.canonical_form(K33) != tiso.canonical_form(prism)
    assert not tiso.is_isomorphic(K33, prism)


def test_graph_api_surface_matches_jax():
    A = rand_graph(8, 0.4, 11)
    p = np.random.RandomState(4).permutation(8)
    B = A[np.ix_(p, p)]
    labels = {i: "x" if i % 3 else "y" for i in range(8)}
    moved = {int(np.where(p == i)[0][0]): labels[i] for i in range(8)}
    out = []
    for mod in (grakel_torch, grakel_tpu):
        g1 = mod.Graph(A, labels, {})
        g2 = mod.Graph(B, moved, {})
        g3 = mod.Graph(B, {i: "x" for i in range(8)}, {})
        out.append((g1.isomorphic(g2), g1.isomorphic(g2, use_labels=True),
                    g1.isomorphic(g3, use_labels=True),
                    g1.canonical_labeling().tolist(),
                    g1.canonical_labeling(use_labels=True).tolist()))
    assert out[0] == out[1]
    assert out[0][:3] == (True, True, False)
    assert sorted(out[0][3]) == list(range(8))


def test_top_level_exports():
    for name in ("canonical_labeling", "canonical_form", "is_isomorphic"):
        assert name in grakel_torch.__all__
        assert getattr(grakel_torch, name) is getattr(tiso, name)
