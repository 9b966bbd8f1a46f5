"""grakel_torch's CUDA kernels on a card: each against its plain PyTorch
version, the wrappers' input checks and launch counts, and the kernels
through the public entry points against the same calls on the CPU.

Every test here needs an NVIDIA card and skips without one; on a
machine with a card run ``python -m pytest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset
from grakel_torch.kernels.base import normalize_input
from grakel_torch.ops import floyd_warshall as fw
from grakel_torch.batch import GraphBatch
from grakel_torch.graph import Graph
from grakel_torch.ops import canonical, hadamard, intersect, nh, wl
from grakel_torch.ops import gram as gram_ops
from grakel_torch.ops import random_walk as rw_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# counts below 9 give W' ~ 8 L, above the rectangular route limit (7 L):
# these calls take the CUDA-core K1; counts below 3 (W' <= 2 L) and the
# 1 x 1 case (W' = 3 L) take K1-tc
@pytest.mark.parametrize("n,m,L,hi,route", [
    (1, 1, 1, 9, "min_gram_tc"), (64, 64, 32, 9, "min_gram"),
    (65, 130, 33, 9, "min_gram"), (300, 257, 1000, 9, "min_gram"),
    (65, 130, 33, 3, "min_gram_tc"), (300, 257, 1000, 3, "min_gram_tc"),
    (37, 1001, 333, None, "min_gram"), (5, 3, 0, 9, "min_gram_tc")])
def test_min_gram_kernel_matches_plain(cuda, n, m, L, hi, route):
    integer = hi is not None
    rng = np.random.RandomState(n + m + L)
    A = rng.randint(0, hi, (n, L)) if integer else rng.rand(n, L)
    B = rng.randint(0, hi, (m, L)) if integer else rng.rand(m, L)
    A = torch.tensor(A, dtype=torch.float32, device=cuda)
    B = torch.tensor(B, dtype=torch.float32, device=cuda)
    counters = {"min_gram": intersect.min_gram_cuda,
                "min_gram_tc": intersect.min_gram_tc_cuda}
    before = {k: c.launches for k, c in counters.items()}
    K = intersect.min_intersection_gram(A, B)
    torch.cuda.synchronize()
    for k, c in counters.items():
        assert c.launches == before[k] + (k == route), k
    R = intersect.min_gram_plain(A, B)
    if integer:
        assert torch.equal(K, R)
    else:
        torch.testing.assert_close(K, R, rtol=1e-5, atol=1e-4)
    if L:   # the CUDA-core kernel on the same inputs, whatever the route
        K1 = intersect.min_gram_cuda(A, B)
        assert torch.equal(K1, R) if integer else torch.allclose(
            K1, R, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,m,L,hi,sym", [
    (1, 1, 3, 9, True), (128, 128, 64, 9, True), (300, 300, 77, 9, True),
    (129, 257, 50, 20, False), (4, 700, 333, 3, False),
    (1000, 37, 17, 150, False), (250, 250, 129, 9, True)])
def test_min_gram_tc_kernel_matches_threshold_plain(cuda, n, m, L, hi, sym):
    """K1-tc against its plain version exactly: ragged n, m and W', the
    symmetric block-triangle path, and the alpha / accumulate epilogue."""
    rng = np.random.RandomState(n * 7 + m + L)
    A = torch.tensor(rng.randint(0, hi, (n, L)), dtype=torch.float32,
                     device=cuda)
    A[: max(1, n // 10)] = 0          # all-zero rows
    A[:, ::7] = 0                     # all-zero columns
    B = A if sym else torch.tensor(rng.randint(0, hi, (m, L)),
                                   dtype=torch.float32, device=cuda)
    T = np.minimum(A.amax(0).cpu().numpy(), B.amax(0).cpu().numpy())
    cols = torch.from_numpy(intersect.threshold_columns(T)).to(cuda)
    EA = intersect.expand_thresholds(A, cols)
    EB = EA if sym else intersect.expand_thresholds(B, cols)
    assert EA.shape[1] % 16 == 0 and EA.shape[1] >= T.sum()
    R = intersect.min_gram_threshold_plain(A, B)
    assert torch.equal(R, intersect.min_gram_plain(A, B))
    before = intersect.min_gram_tc_cuda.launches
    K = intersect.min_gram_tc_cuda(EA, EB)
    torch.cuda.synchronize()
    assert intersect.min_gram_tc_cuda.launches == before + 1
    assert torch.equal(K, R)
    base = torch.tensor(rng.randint(0, 50, (n, m)), dtype=torch.float32,
                        device=cuda)
    out = base.clone()
    got = intersect.min_gram_tc_cuda(EA, EB, out=out, alpha=3.0)
    torch.cuda.synchronize()
    assert got is out and torch.equal(out, base + 3.0 * R)
    assert torch.equal(intersect.min_gram_tc_cuda(EA, EB, alpha=4.0),
                       4.0 * R)
    assert intersect.min_gram_tc_cuda.launches == before + 3


def _tc_counts(rng, R, n, L, hi, device):
    X = torch.tensor(rng.randint(0, hi, (R, n, L)), dtype=torch.float32,
                     device=device)
    X[:, : n // 10] = 0               # all-zero rows
    X[:, :, ::7] = 0                  # all-zero columns
    return X


# skinny and ragged n (one tile row of 64 and its neighbours) against
# ragged m, widths whose W' is no multiple of 32 (nor of 128, the stage)
@pytest.mark.parametrize("n,m,L,hi", [
    (1, 77, 5, 4), (63, 1001, 40, 3), (64, 130, 33, 5), (65, 65, 29, 4),
    (300, 257, 64, 9), (129, 129, 100, 3)])
def test_min_gram_tc_batched_weighted_every_tile(cuda, n, m, L, hi):
    """K1-tc against its plain version exactly, at every instantiation:
    R rounds in one launch (rect, and symmetric when n == m, the block
    triangle mirrored), weighted indicators (symmetric: weights on EA,
    EB the 0/1 indicators of the same counts), the alpha / out epilogue;
    the expansion kernel against its plain version bit for bit."""
    rng = np.random.RandomState(n * 13 + m + L)
    R = 3
    A = _tc_counts(rng, R, n, L, hi, cuda)
    B = _tc_counts(rng, R, m, L, hi, cuda)
    T = np.minimum(A.amax(1).cpu().numpy(), B.amax(1).cpu().numpy())
    w = rng.randint(1, 128, L)
    cols = torch.from_numpy(intersect.threshold_columns(T, w)).to(cuda)
    ne = intersect.threshold_expand_cuda.launches
    EA, EA01 = intersect.expand_thresholds(A, cols, indicators=True)
    EB = intersect.expand_thresholds(B, cols, weighted=False)
    assert intersect.threshold_expand_cuda.launches == ne + 2
    pa, pa01 = intersect.expand_thresholds_plain(A, cols, indicators=True)
    assert torch.equal(EA, pa) and torch.equal(EA01, pa01)
    assert torch.equal(EB, intersect.expand_thresholds_plain(
        B, cols, weighted=False))
    want = intersect._indicator_product_plain(EA, EB)
    assert torch.equal(want, intersect.min_gram_threshold_plain(A, B, w))
    base = torch.tensor(rng.randint(0, 50, (R, n, m)), dtype=torch.float32,
                        device=cuda)
    for tile in sorted(intersect.TC_TILES):
        before = intersect.min_gram_tc_cuda.launches
        K = intersect.min_gram_tc_cuda(EA, EB, tile=tile)
        out = base.clone()
        got = intersect.min_gram_tc_cuda(EA, EB, out=out, alpha=3.0,
                                         tile=tile)
        K2 = intersect.min_gram_tc_cuda(EA[1], EB[1], tile=tile)
        torch.cuda.synchronize()
        assert intersect.min_gram_tc_cuda.launches == before + 3
        assert torch.equal(K, want), tile
        assert got is out and torch.equal(out, base + 3.0 * want), tile
        assert torch.equal(K2, want[1]), tile
    if n != m:
        return
    # symmetric: A's weighted indicators against its own 0/1 ones
    wsym = intersect._indicator_product_plain(EA, EA01)
    for tile in sorted(intersect.TC_TILES):
        Ks = intersect.min_gram_tc_cuda(EA, EA01, symmetric=True, tile=tile)
        Ku = intersect.min_gram_tc_cuda(EA01, EA01, tile=tile)
        out = base.clone()
        intersect.min_gram_tc_cuda(EA, EA01, out=out, alpha=0.5,
                                   symmetric=True, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(Ks, wsym) and torch.equal(Ks, Ks.transpose(1, 2))
        assert torch.equal(Ku, intersect._indicator_product_plain(EA01, EA01))
        assert torch.equal(out, base + 0.5 * wsym), tile


def test_min_gram_tc_wrapper_refusals(cuda):
    E = torch.ones((2, 4, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E, E[0])                 # 3-D with 2-D
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E, E[:1].contiguous())   # round counts
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E[0], E[0][:3].contiguous(),
                                   symmetric=True)          # n != m
    with pytest.raises(ValueError, match="tile"):
        intersect.min_gram_tc_cuda(E, E, tile=9)            # no such tile
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E.view(torch.uint8), E)  # dtype
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E.cpu(), E.cpu())        # device
    X = torch.ones((4, 6), device=cuda)
    cols = torch.from_numpy(intersect.threshold_columns(
        np.full(6, 2), np.full(6, 9))).to(cuda)
    for bad in ((X.double(), cols), (X, cols.long()), (X.cpu(), cols.cpu()),
                (X.t(), cols), (X[None], cols), (X, cols[:, :6])):
        with pytest.raises(ValueError):
            intersect.threshold_expand_cuda(*bad)
    with pytest.raises(ValueError, match="weights"):
        intersect.min_intersection_gram(X, weights=np.full(6, 128),
                                        route="min_gram_tc")
    with pytest.raises(ValueError, match="weights"):
        intersect.threshold_columns(np.full(6, 2), np.full(6, 200))


def test_rounds_one_tc_launch_per_call(cuda):
    """min_intersection_gram_rounds(route=None) with every round on
    K1-tc: one expansion launch a side and ONE K1-tc launch that stores
    the stack, symmetric and rectangular, equal to the CPU run."""
    rng = np.random.RandomState(9)
    A = _tc_counts(rng, 3, 200, 256, 3, cuda)
    B = _tc_counts(rng, 3, 64, 256, 3, cuda)
    for Y in (None, B):
        n0 = (intersect.min_gram_tc_cuda.launches,
              intersect.threshold_expand_cuda.launches,
              intersect.min_gram_cuda.launches)
        K = intersect.min_intersection_gram_rounds(A, Y, route=None)
        torch.cuda.synchronize()
        assert (intersect.min_gram_tc_cuda.launches - n0[0],
                intersect.threshold_expand_cuda.launches - n0[1],
                intersect.min_gram_cuda.launches - n0[2]) == (
                    1, 1 if Y is None else 2, 0)
        Kc = intersect.min_intersection_gram_rounds(
            A.cpu(), None if Y is None else Y.cpu(), route=None)
        assert torch.equal(K.cpu(), Kc)


def test_pm_labeled_one_tc_launch_per_gram(cuda, monkeypatch):
    """Labeled PyramidMatch with every level on K1-tc (the route limits
    set past any W' / L): ONE K1-tc launch for the fit_transform Gram and
    one for the transform's (its levels' weights as indicator values), no
    K1, and the Grams equal the CPU's bit for bit."""
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", float("inf"))
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_RECT", float("inf"))
    train, test = generate_dataset(n_graphs=120, n_graphs_test=20,
                                   r_vertices=(5, 40), random_state=3,
                                   features=("nl", 5))
    train, test = normalize_input(train), normalize_input(test)
    k = grakel_torch.PyramidMatch(with_labels=True)
    n1, ntc = intersect.min_gram_cuda.launches, \
        intersect.min_gram_tc_cuda.launches
    K = k.fit_transform(train)
    assert intersect.min_gram_tc_cuda.launches == ntc + 1
    T = k.transform(test)
    assert intersect.min_gram_tc_cuda.launches == ntc + 2
    assert intersect.min_gram_cuda.launches == n1
    with use_device("cpu"):
        kc = grakel_torch.PyramidMatch(with_labels=True)
        Kc, Tc = kc.fit_transform(train), kc.transform(test)
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)


def _k1_inputs(seed, n, L, integer, device):
    """A [n, L]: counts 0..8 (integer) or uniform reals, with all-zero
    rows and columns."""
    rng = np.random.RandomState(seed)
    A = rng.randint(0, 9, (n, L)) if integer else rng.rand(n, L)
    A = torch.tensor(A, dtype=torch.float32, device=device)
    A[: max(1, n // 10)] = 0
    A[:, ::5] = 0
    return A


# every K1 instantiation at n = 1 and at n that are no multiple of a tile
# side (2000 = 15 x 128 + 80 = 62 x 32 + 16), at widths across the chunk
# boundaries (BK = 8) and the main path's (90 fused, 1728 labeled)
@pytest.mark.parametrize("L", [1, 6, 31, 33, 90, 1728])
@pytest.mark.parametrize("n", [1, 63, 65, 129, 2000])
def test_min_gram_k1_symmetric_and_rect_bit_identical(cuda, n, L):
    """K1 on integer inputs, bit for bit against the plain version, at
    every tile: the block triangle (B is A) and the full rectangle
    (B a copy), the mirrored half equal to the transpose, and the
    alpha / accumulate epilogue; one launch a call."""
    A = _k1_inputs(n * 31 + L, n, L, True, cuda)
    R = intersect.min_gram_plain(A, A)
    base = torch.tensor(np.random.RandomState(n).randint(0, 50, (n, n)),
                        dtype=torch.float32, device=cuda)
    for tile in sorted(intersect.K1_TILES):
        before = intersect.min_gram_cuda.launches
        K = intersect.min_gram_cuda(A, A, tile=tile)
        Kr = intersect.min_gram_cuda(A, A.clone(), tile=tile)
        out = base.clone()
        got = intersect.min_gram_cuda(A, A, out=out, alpha=3.0, tile=tile)
        K4 = intersect.min_gram_cuda(A, A.clone(), alpha=4.0, tile=tile)
        torch.cuda.synchronize()
        assert intersect.min_gram_cuda.launches == before + 4
        assert torch.equal(K, R) and torch.equal(Kr, R), tile
        assert torch.equal(K, K.T), tile
        assert got is out and torch.equal(out, base + 3.0 * R), tile
        assert torch.equal(K4, 4.0 * R), tile


@pytest.mark.parametrize("n,m,L", [(37, 1001, 333), (129, 65, 90),
                                   (2000, 3, 7), (300, 300, 1728)])
def test_min_gram_k1_rect_and_real_values(cuda, n, m, L):
    """Rectangular calls on integers (exact) and on reals (the f32 sum
    order differs from the plain version's: rtol 1e-5, atol 1e-4), at
    every tile; on reals the triangle still equals the rectangle
    exactly (the same sums in the same order)."""
    for integer in (True, False):
        A = _k1_inputs(n + L, n, L, integer, cuda)
        B = _k1_inputs(m + 2 * L, m, L, integer, cuda)
        R = intersect.min_gram_plain(A, B)
        for tile in sorted(intersect.K1_TILES):
            K = intersect.min_gram_cuda(A, B, tile=tile)
            if integer:
                assert torch.equal(K, R), tile
            else:
                torch.testing.assert_close(K, R, rtol=1e-5, atol=1e-4)
                Ks = intersect.min_gram_cuda(A, A, tile=tile)
                assert torch.equal(Ks, intersect.min_gram_cuda(
                    A, A.clone(), tile=tile)), tile


def test_min_gram_k1_default_tile_and_empty(cuda):
    """The default instantiation (ops.intersect.k1_tile) on the main
    path's shapes, and empty and zero-width inputs."""
    assert intersect.k1_tile(2000, 2000, True) in intersect.K1_TILES
    A = _k1_inputs(3, 500, 90, True, cuda)
    assert torch.equal(intersect.min_gram_cuda(A, A),
                       intersect.min_gram_plain(A, A))
    E = torch.zeros((0, 4), device=cuda)
    assert intersect.min_gram_cuda(E, A[:, :4].contiguous()).shape == (0, 500)
    Z = torch.zeros((5, 0), device=cuda)
    assert torch.equal(intersect.min_gram_cuda(Z, Z),
                       torch.zeros((5, 5), device=cuda))


def test_pm_unlabeled_one_k1_launch_per_gram(cuda, monkeypatch):
    """Unlabeled PyramidMatch with every level routed to K1 (the route
    limits set to 0, as on REDDIT-scale counts): one K1 launch for the
    fit_transform Gram and one for the transform's, no K1-tc, and the
    Grams equal the CPU's."""
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", 0.0)
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_RECT", 0.0)
    train, test = generate_dataset(n_graphs=150, n_graphs_test=20,
                                   r_vertices=(5, 60), random_state=8,
                                   features=("nl", 4))
    train, test = normalize_input(train), normalize_input(test)
    k = grakel_torch.PyramidMatch(with_labels=False)
    n1, ntc = intersect.min_gram_cuda.launches, \
        intersect.min_gram_tc_cuda.launches
    K = k.fit_transform(train)
    assert intersect.min_gram_cuda.launches == n1 + 1
    T = k.transform(test)
    assert intersect.min_gram_cuda.launches == n1 + 2
    assert intersect.min_gram_tc_cuda.launches == ntc
    with use_device("cpu"):
        kc = grakel_torch.PyramidMatch(with_labels=False)
        Kc, Tc = kc.fit_transform(train), kc.transform(test)
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)


def test_pm_levels_route_and_fold_on_card(cuda):
    """min_intersection_gram with host statistics, as PyramidMatch calls
    it, accumulating two levels into one result."""
    rng = np.random.RandomState(3)
    mats = [rng.randint(0, 9, (301, w)).astype(np.float32)
            for w in (40, 80)]
    acc, ref = None, None
    before = intersect.min_gram_tc_cuda.launches
    for w, M in zip((4.0, 3.0), mats):
        A = torch.from_numpy(M).to(cuda)
        acc = intersect.min_intersection_gram(
            A, A, count_max=(M.max(0), M.max(0)), out=acc, alpha=w)
        R = w * intersect.min_gram_plain(A, A)
        ref = R if ref is None else ref + R
    torch.cuda.synchronize()
    assert intersect.min_gram_tc_cuda.launches == before + 2
    assert torch.equal(acc, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_wl_hash_kernel_bit_identical(cuda, seed):
    rng = np.random.RandomState(seed)
    n, e = 5000, 20000
    args = [torch.tensor(rng.randint(0, 2 ** 31 - 1, n), dtype=torch.int32),
            torch.tensor(rng.randint(0, n, e), dtype=torch.int32),
            torch.tensor(rng.randint(0, n, e), dtype=torch.int32),
            torch.tensor(rng.rand(e) < 0.7)]
    before = wl.wl_hash_refine_cuda.launches
    h = wl.wl_hash_refine(*[a.to(cuda) for a in args])
    assert wl.wl_hash_refine_cuda.launches == before + 1
    p = wl.wl_hash_refine_plain(*args)
    assert torch.equal(h[0].cpu(), p[0]) and torch.equal(h[1].cpu(), p[1])


def test_wl_hash_csr_kernel_on_graph_batch(cuda):
    """K2 over a GraphBatch's CSR against the plain CSR version, three
    generations deep, keys included; one launch per generation."""
    train, _ = generate_dataset(n_graphs=300, n_graphs_test=2,
                                r_vertices=(1, 40), random_state=5,
                                features=("nl", 7))
    b = grakel_torch.GraphBatch.from_graphs(normalize_input(train),
                                            device=cuda)
    labels = b.node_labels
    for _ in range(3):
        before = wl.wl_hash_refine_cuda.launches
        key = wl._wl_hash_refine_csr(labels, b.csr_offsets, b.csr_targets)
        assert wl.wl_hash_refine_cuda.launches == before + 1
        pkey = wl.wl_hash_refine_csr_plain(
            labels.cpu(), b.csr_offsets.cpu(), b.csr_targets.cpu())
        assert torch.equal(key.cpu(), pkey)
        h1, h2 = wl.key_hashes(key.cpu())
        old = wl.wl_hash_refine_plain(labels.cpu(), b.senders.cpu(),
                                      b.receivers.cpu(), b.edge_mask.cpu())
        assert torch.equal(h1, old[0]) and torch.equal(h2, old[1])
        labels = wl.compact_key_ids(key, b.node_mask)[0]


def test_wrappers_check_inputs(cuda):
    A = torch.ones((4, 6), device=cuda)
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A.t(), A.t())          # not contiguous
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A.double(), A)          # wrong dtype
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A, torch.ones((4, 5), device=cuda))
    for bad in (torch.ones((4, 5), device=cuda),           # shape
                torch.ones((4, 4), device=cuda).double(),  # dtype
                torch.ones((4, 4), device=cuda).t(),       # not contiguous
                torch.ones((8, 4), device=cuda)[::2],      # not contiguous
                torch.ones((4, 4))):                       # device
        with pytest.raises(ValueError, match="out"):
            intersect.min_gram_cuda(A, A, out=bad)
    with pytest.raises(ValueError, match="tile"):
        intersect.min_gram_cuda(A, A, tile=9)
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A.cpu(), A.cpu())
    E = torch.ones((4, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E.float(), E)        # wrong dtype
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E[:, :24].contiguous(), E[:, :24]
                                   .contiguous())      # width % 16
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E, E, out=torch.ones((4, 5), device=cuda))
    with pytest.raises(ValueError):
        intersect.min_gram_tc_cuda(E.cpu(), E.cpu())
    i = torch.zeros(4, dtype=torch.int32, device=cuda)
    off = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        wl.wl_hash_refine_cuda(i.long(), off, i)
    with pytest.raises(ValueError):
        wl.wl_hash_refine_cuda(i, off, i.cpu())
    with pytest.raises(ValueError):
        wl.wl_hash_refine_cuda(i, off[:4], i)          # offsets [N]
    with pytest.raises(ValueError):
        wl.wl_hash_refine(i, i, i + 4, i.bool())       # endpoint == N


@pytest.mark.parametrize("name,kw", [
    ("WeisfeilerLehman", {"n_iter": 3}),
    ("WeisfeilerLehman", {"n_iter": 5, "normalize": True}),
    ("VertexHistogram", {}),
    ("PyramidMatch", {}), ("PyramidMatch", {"with_labels": False}),
    ("NeighborhoodHash", {"random_state": 0}),
    ("NeighborhoodHash", {"random_state": 1, "nh_type": "count_sensitive",
                          "R": 5, "bits": 6}),
    ("WeisfeilerLehmanOptimalAssignment", {"n_iter": 3}),
    ("WeisfeilerLehmanOptimalAssignment", {"n_iter": 5, "normalize": True})])
def test_entry_points_on_card_match_cpu(cuda, name, kw):
    train, test = generate_dataset(n_graphs=80, n_graphs_test=10,
                                   r_vertices=(5, 30), random_state=2,
                                   features=("nl", 6))
    # the same Graph objects on both sides: PyramidMatch caches each
    # graph's embedding in it, so both runs histogram the same vectors
    train, test = normalize_input(train), normalize_input(test)
    k = getattr(grakel_torch, name)(**kw)
    K, T = k.fit_transform(train), k.transform(test)
    with use_device("cpu"):
        kc = getattr(grakel_torch, name)(**kw)
        Kc, Tc = kc.fit_transform(train), kc.transform(test)
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)


def _fw_batch(seed, n, V, weighted, integer=False):
    rng = np.random.RandomState(seed)
    A = (rng.rand(n, V, V) < min(1.0, 3.0 / V)).astype(np.float32)
    if weighted:
        A *= rng.uniform(0.5, 2.0, (n, V, V)).astype(np.float32)
    if integer:
        A *= rng.randint(1, 5, (n, V, V)).astype(np.float32)
    A = np.triu(A, 1)
    A = A + A.transpose(0, 2, 1)
    M = np.zeros((n, V), bool)
    for g in range(n):
        M[g, :rng.randint(1, V + 1)] = True
    A[~(M[:, :, None] & M[:, None, :])] = rng.randint(0, 3)  # padding junk
    return torch.from_numpy(A), torch.from_numpy(M)


# route "tile" (V <= 128) at every instantiation boundary (T = 2 up to
# V = 24, 4 up to 64, 8 up to 128), n = 0 meaning 3 G + 1 graphs for the
# G graphs a block holds; route "blocked" (integral=True, integer
# weights) and route "per_k" (float weights) above
@pytest.mark.parametrize("n,V,weighted,integral", [
    (300, 16, False, False), (200, 56, True, False), (7, 8, False, False),
    (3, 128, True, False)]
    + [(0, V, w, False) for V in (1, 7, 24, 25, 31, 32, 33, 63, 64, 65,
                                  127, 128) for w in (False, True)]
    + [(5, 136, True, False), (4, 512, False, False), (1, 1000, True, False),
       (2, 129, True, False),
       (3, 129, False, True), (2, 200, False, True), (4, 512, False, True),
       (1, 1000, False, True)])
def test_floyd_warshall_kernel_bit_identical(cuda, n, V, weighted, integral):
    """K3 on every route against the plain version, bit for bit (the
    ShortestPath hash route keys on the distance bits); one launch a
    call whatever the route."""
    if n == 0:
        G = fw.fw_tile_config(1 << 20, V)[1]
        n = 3 * G + 1
        assert fw.fw_tile_config(n, V)[1] == G and (G == 1 or n % G)
    A, M = _fw_batch(n * 13 + V, n, V, weighted, integer=integral)
    A, M = A.to(cuda), M.to(cuda)
    route = fw.fw_route(V, integral)
    before = fw.floyd_warshall_cuda.launches
    by_route = fw.floyd_warshall_cuda.route_launches[route]
    S = fw.batched_floyd_warshall(A, M, integral=integral)
    torch.cuda.synchronize()
    assert fw.floyd_warshall_cuda.launches == before + 1
    assert fw.floyd_warshall_cuda.route_launches[route] == by_route + 1
    R = fw.floyd_warshall_plain(A, M)
    assert torch.equal(S.view(torch.int32), R.view(torch.int32))


def test_floyd_warshall_wrapper_checks_inputs(cuda):
    A = torch.zeros((2, 8, 8), device=cuda)
    M = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A.double(), M)                  # dtype
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A.transpose(1, 2), M)           # contiguous
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A, M[:, :4])                    # mask shape
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A, M.cpu())                     # device
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A, M, tile=(3, 1))              # no such T
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A, M, tile=(2, 64))             # 1024 threads


@pytest.mark.parametrize("spec,attrs,weighted", [
    ("shortest_path", {}, False),
    ({"name": "SP", "with_labels": False}, {}, False),
    ("shortest_path", {}, True),
    ("shortest_path", {"_DIRECT_MAX_WIDTH": 0}, False),
    ("shortest_path", {"_SPARSE_GRAM_MIN_REP": 0}, True),
    ([{"name": "WL", "n_iter": 2}, "SP"], {}, False),
    ([{"name": "CORE"}, "SP"], {}, False)], ids=str)
def test_shortest_path_on_card_matches_cpu(cuda, spec, attrs, weighted):
    """ShortestPath's Grams through GraphKernel on the card (K3 launched)
    equal the same calls on the CPU exactly, on every route."""
    train, test = generate_dataset(
        n_graphs=120, n_graphs_test=16, r_vertices=(5, 60),
        r_connectivity=(0.05, 0.2), random_state=4,
        r_weight_edges=(0.5, 2.0) if weighted else (1, 1),
        features=("nl", 9))
    out = []
    for dev in ("cuda", "cpu"):
        gk = grakel_torch.GraphKernel(kernel=spec)
        gk.initialize()
        for a, v in attrs.items():
            setattr(gk.kernel_, a, v)
        before = fw.floyd_warshall_cuda.launches
        with use_device(dev):
            K, T = gk.fit_transform(train), gk.transform(test)
            out.append((K, T, gk.diagonal()))
        assert (fw.floyd_warshall_cuda.launches > before) == (dev == "cuda")
    (K, T, d), (Kc, Tc, dc) = out
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)
    assert np.array_equal(d[0], dc[0]) and np.array_equal(d[1], dc[1])


@pytest.mark.parametrize("with_labels", [False, True])
def test_shortest_path_large_graphs_on_card_match_cpu(cuda, with_labels):
    """Unit-weight graphs past V = 128 take K3's blocked route on every
    call, and their count Grams (entries past 2^24, summed in f64)
    equal the CPU's exactly."""
    train, test = generate_dataset(
        n_graphs=24, n_graphs_test=4, r_vertices=(129, 260),
        r_connectivity=(0.01, 0.03), random_state=6, features=("nl", 3))
    out = []
    for dev in ("cuda", "cpu"):
        k = grakel_torch.ShortestPath(with_labels=with_labels)
        before = dict(fw.floyd_warshall_cuda.route_launches)
        with use_device(dev):
            out.append((k.fit_transform(train), k.transform(test),
                        k.diagonal()))
        after = fw.floyd_warshall_cuda.route_launches
        if dev == "cuda":
            assert after["blocked"] > before["blocked"]
            assert after["tile"] == before["tile"]
            assert after["per_k"] == before["per_k"]
    (K, T, d), (Kc, Tc, dc) = out
    assert K.max() > 2 ** 24
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)
    assert np.array_equal(d[0], dc[0]) and np.array_equal(d[1], dc[1])



@pytest.mark.parametrize("route", ["bfs", "host", "slab"])
@pytest.mark.parametrize("with_labels", [False, True])
def test_sp_stream_on_card_matches_cpu(cuda, route, with_labels):
    """ShortestPath in stream mode (``_STREAM_BYTES = 0``) on the card
    equals the same calls on the CPU bit for bit on every stream route,
    graphs past V = 64 included (f64 counts-Grams, unlabeled entries past
    2^24); only the slab route
    launches K3, once a slab an encoding of the counts."""
    train, test = generate_dataset(
        n_graphs=90, n_graphs_test=10, r_vertices=(5, 140),
        r_connectivity=(0.02, 0.1), random_state=12, features=("nl", 5))
    attrs = {"bfs": {}, "host": {"_BFS_DEVICE_MAX_W": 0},
             "slab": {"_STREAM_BFS": False}}[route]
    out = []
    for dev in ("cuda", "cpu"):
        k = grakel_torch.ShortestPath(with_labels=with_labels)
        k._STREAM_BYTES = 0
        for a, v in attrs.items():
            setattr(k, a, v)
        before = fw.floyd_warshall_cuda.launches
        with use_device(dev):
            out.append((k.fit_transform(train), k.transform(test),
                        k.diagonal()))
            assert k.X["stream"] and k._stream_plan(k.X)[0] == (
                "slab" if route == "slab" else "bfs")
        # each parse is counted once an (L, D) encoding: the fit graphs
        # again when the transform's labels extended L
        slabs = sum(len(p["counts"]) * -(-len(idxs) // k._slab_cap(
            M.shape[1])) for p in (k.X, k._Y)
            for idxs, _, _, M in p["buckets"])
        launched = fw.floyd_warshall_cuda.launches - before
        assert launched == (slabs if route == "slab" and dev == "cuda"
                            else 0)
    (K, T, d), (Kc, Tc, dc) = out
    assert K.dtype == np.float64 and (with_labels or K.max() > 2 ** 24)
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)
    assert np.array_equal(d[0], dc[0]) and np.array_equal(d[1], dc[1])
    assert np.array_equal(np.diagonal(K), d[0])


def test_sp_stream_slabs_within_budget(cuda, monkeypatch):
    """The slab route cuts each bucket into slabs of at most
    ``_slab_cap(V)`` graphs, none past ``_STREAM_SLAB_BYTES`` where the
    floor of 8 graphs does not bind, and launches K3 once a slab."""
    from grakel_torch.kernels import shortest_path as sp_mod
    train, _ = generate_dataset(
        n_graphs=201, n_graphs_test=1, r_vertices=(5, 60),
        r_connectivity=(0.05, 0.2), random_state=3, features=("nl", 4))
    seen = []
    real = sp_mod.batched_floyd_warshall

    def spy(A, M, integral=False):
        seen.append((A.shape[0], A.shape[1], A.nbytes, A.device.type))
        return real(A, M, integral)

    monkeypatch.setattr(sp_mod, "batched_floyd_warshall", spy)
    k = grakel_torch.ShortestPath()
    k._STREAM_BYTES = 0
    k._STREAM_BFS = False
    k._STREAM_SLAB_BYTES = 1 << 17     # 8 graphs at V = 64, 32 at 32
    before = fw.floyd_warshall_cuda.launches
    with use_device("cuda"):
        K = k.fit_transform(train)
    assert fw.floyd_warshall_cuda.launches - before == len(seen)
    caps = {M.shape[1]: k._slab_cap(M.shape[1])
            for _, _, _, M in k.X["buckets"]}
    assert len(seen) == sum(-(-len(idxs) // caps[M.shape[1]])
                            for idxs, _, _, M in k.X["buckets"])
    assert len(seen) > len(caps)
    for n, V, nbytes, dev in seen:
        assert dev == "cuda" and n <= caps[V]
        assert nbytes <= k._STREAM_SLAB_BYTES or n <= 8
    k2 = grakel_torch.ShortestPath()
    with use_device("cuda"):
        assert np.array_equal(K, k2.fit_transform(train))
    assert not k2.X["stream"]


def test_converters_feed_card_gram(cuda, tmp_path):
    """graph_from_csv's graphs, and graph_from_torch_geometric's from a
    data object whose tensors lie on the card, give a Gram on the card
    equal to the CPU's."""
    rng = np.random.RandomState(5)
    efiles, src, dst, member, off = [], [], [], [], 0
    for i in range(12):
        n = rng.randint(4, 12)
        lines = []
        for u in range(n):
            for v in range(u + 1, n):
                if rng.rand() < 0.35:
                    lines.append("%d,%d" % (u, v))
                    src += [off + u, off + v]
                    dst += [off + v, off + u]
        member += [i] * n
        off += n
        e = tmp_path / ("e%d.csv" % i)
        e.write_text("\n".join(lines) + "\n")
        efiles.append(str(e))
    csv_graphs = list(grakel_torch.graph_from_csv((efiles, False, None),
                                                  index_type=int))
    x = torch.tensor(np.eye(3)[rng.randint(0, 3, off)], device="cuda")
    data = type("Data", (), dict(
        edge_index=torch.tensor([src, dst], device="cuda"), x=x,
        edge_attr=None, y=torch.arange(12, device="cuda"),
        batch=torch.tensor(member, device="cuda")))()
    tg = grakel_torch.graph_from_torch_geometric(data, node_one_hot=True)
    assert tg["y"] == list(range(12))
    for graphs, make in (
            (csv_graphs, lambda: grakel_torch.ShortestPath(
                with_labels=False)),
            (tg["graph"], lambda: grakel_torch.ShortestPath()),
            (tg["graph"], lambda: grakel_torch.WeisfeilerLehman(n_iter=3))):
        Ks = []
        for dev in ("cuda", "cpu"):
            with use_device(dev):
                Ks.append(make().fit_transform(graphs))
        assert Ks[0].shape == (12, 12)
        assert np.array_equal(Ks[0], Ks[1])

def _nh_batch(seed, hub, device, pa=0):
    """A GraphBatch of random graphs with an edgeless graph (degree-0
    nodes), a hub of out-degree ``hub`` and ``pa`` preferential-attachment
    graphs of 30-150 vertices, with random int32 labels (high bits set
    too: the rounds mask them) and a fifth invalid."""
    rng = np.random.RandomState(seed)
    graphs = []
    for g in range(40 + pa):
        n = rng.randint(1, 30)
        if g == 0:
            s = r = np.zeros(0, np.int64)
        elif g == 1:
            n = hub + 1
            s = np.zeros(hub, np.int64)
            r = np.arange(1, hub + 1)
            s, r = np.concatenate([s, r]), np.concatenate([r, s])
        elif g >= 40:
            n = rng.randint(30, 151)
            ends, s, r = [0], [], []
            for v in range(1, n):
                for u in set(ends[i] for i in rng.randint(0, len(ends), 2)):
                    s += [v, u]
                    r += [u, v]
                    ends += [u, v]
        else:
            A = rng.rand(n, n) < 0.2
            np.fill_diagonal(A, False)
            s, r = np.nonzero(A)
        graphs.append(grakel_torch.Graph.from_arrays(n, s, r))
    b = grakel_torch.GraphBatch.from_graphs(graphs, node_label_enum={},
                                            device=device)
    N = b.node_mask.shape[0]
    lab = rng.randint(-2 ** 31, 2 ** 31 - 1, N)
    lab[rng.rand(N) < 0.5] %= 3          # repeated labels for the fold
    valid = (rng.rand(N) < 0.8) & b.node_mask.cpu().numpy()
    return (b, torch.tensor(lab, dtype=torch.int32, device=device),
            torch.tensor(valid, device=device))


def _k4_launches():
    return nh.nh_graph_cuda.launches, nh.nh_round_cuda.launches


def _plain_rounds(b, lab, valid, R, bits, cs):
    """nh_rounds_plain on the device of ``lab``."""
    d = lab.device
    return nh.nh_rounds_plain(lab, valid, b.node_graph_ids.to(d),
                              b.csr_offsets.to(d), b.csr_targets.to(d),
                              b.n_graphs, R, bits, cs)


@pytest.mark.parametrize("bits", [1, 4, 5, 8, 12])
@pytest.mark.parametrize("nh_type", ["simple", "count_sensitive"])
def test_nh_round_kernel_bit_identical(cuda, nh_type, bits, monkeypatch):
    """K4's routes through nh_rounds against nh_rounds_plain on the card
    and on the CPU, R = 1, 3, 5, with degree-0 nodes, a node of degree 64,
    preferential-attachment graphs and invalid labels: the graph route
    (one launch a call), the round route (one a round) and a batch that
    mixes them (the largest graphs on the round route)."""
    cs = nh_type == "count_sensitive"
    b, lab, valid = _nh_batch(bits, 64, cuda, pa=4)
    each = nh.k4_smem_bytes(b.n_nodes, b.n_edges, 1, bits)
    default, mixed = nh.K4_SMEM_BUDGET, int(np.sort(each)[-4])
    big = np.flatnonzero(each > mixed)
    assert 1 <= len(big) <= 3
    for R in (1, 3, 5):
        P = _plain_rounds(b, lab, valid, R, bits, cs)
        Pc = _plain_rounds(b, lab.cpu(), valid.cpu(), R, bits, cs)
        assert torch.equal(P.cpu(), Pc) and int(P.sum()) > 0
        for budget, want in ((default, (1, 0)), (0, (0, R)),
                             (mixed, (1, R))):
            monkeypatch.setattr(nh, "K4_SMEM_BUDGET", budget)
            _, rnd, _ = nh.nh_plan(b.n_nodes, b.n_edges, bits,
                                   nh.K4_CHUNK_NODES, budget)
            if budget == mixed:
                assert rnd.tolist() == big.tolist()
            before = _k4_launches()
            H = nh.nh_rounds(b, lab, valid, b.n_graphs, R, bits, cs)
            torch.cuda.synchronize()
            got = tuple(x - y for x, y in zip(_k4_launches(), before))
            assert got == want, (budget, got)
            assert H.dtype == torch.int32 and torch.equal(H, P)


@pytest.mark.parametrize("bits", [4, 8, 12])
@pytest.mark.parametrize("nh_type", ["simple", "count_sensitive"])
def test_nh_kernel_hub_fold_bit_identical(cuda, nh_type, bits):
    """Each K4 route with every node of degree >= 1 folded by a warp (hub
    degree 0), with none (no hub), and at the default, on a degree-200
    star and preferential-attachment graphs; the graph route writes every
    bin of its rows (the stack starts as garbage) and nothing else."""
    cs = nh_type == "count_sensitive"
    b, lab, valid = _nh_batch(bits + 7, 200, cuda, pa=6)
    R = 3
    P = _plain_rounds(b, lab, valid, R, bits, cs)
    chunks, rnd, _ = nh.nh_plan(b.n_nodes, b.n_edges, bits, 64)
    assert len(rnd) == 0 and len(chunks) > 2
    args = (lab, valid, b.node_graph_ids, b.csr_offsets, b.csr_targets)
    for hub in (0, None, 2 ** 31 - 1):
        H = torch.full_like(P, -7)
        before = _k4_launches()
        nh.nh_graph_cuda(*args, chunks, H, bits, cs, hub_degree=hub)
        torch.cuda.synchronize()
        assert torch.equal(H, P), hub
        G = torch.zeros_like(P)
        lr, vr = lab, valid
        for r in range(R):
            lr, vr = nh.nh_round_cuda(lr, vr, *args[2:], G[r], bits, cs,
                                      hub_degree=hub)
        torch.cuda.synchronize()
        assert torch.equal(G, P), hub
        assert tuple(x - y for x, y in zip(_k4_launches(), before)) == \
            (1, R)
    # a part of the table writes its chunks' rows only
    H = torch.full_like(P, -7)
    nh.nh_graph_cuda(*args, chunks[1:2], H, bits, cs)
    g0, g1 = chunks[1, :2]
    assert torch.equal(H[:, g0:g1], P[:, g0:g1])
    assert int((H[:, :g0] != -7).sum() + (H[:, g1:] != -7).sum()) == 0


def test_nh_round_kernel_labels_and_validity(cuda):
    """One K4 round's labels and validity against the plain round's
    (recovered with R = 1 from a one-node-a-graph layout); with a graph
    mask, only the marked graphs' nodes are relabeled and counted."""
    b, lab, valid = _nh_batch(3, 64, cuda)
    hist = torch.zeros((b.n_graphs, 1 << 8), dtype=torch.int32, device=cuda)
    new_lab, new_valid = nh.nh_round_cuda(
        lab, valid, b.node_graph_ids, b.csr_offsets, b.csr_targets, hist, 8,
        True)
    # every node its own graph: the plain histogram row of node v is the
    # one-hot of its new label when it stays valid
    N = lab.shape[0]
    own = torch.arange(N, dtype=torch.int32, device=cuda)
    P = nh.nh_rounds_plain(lab, valid, own, b.csr_offsets, b.csr_targets, N,
                           1, 8, True)[0]
    assert torch.equal(new_valid, P.sum(1) > 0)
    keep = new_valid.nonzero().flatten()
    assert torch.equal(P[keep].argmax(1).to(torch.int32), new_lab[keep])
    assert int((new_lab >> 8).abs().sum()) == 0
    mask = torch.zeros(b.n_graphs, dtype=torch.bool, device=cuda)
    mask[1::3] = True
    hm = torch.zeros_like(hist)
    ml, mv = nh.nh_round_cuda(lab, valid, b.node_graph_ids, b.csr_offsets,
                              b.csr_targets, hm, 8, True, graph_mask=mask)
    on = mask[b.node_graph_ids.clamp(max=b.n_graphs - 1).long()] \
        & b.node_mask
    assert torch.equal(ml[on], new_lab[on]) and torch.equal(mv[on],
                                                            new_valid[on])
    assert torch.equal(hm[mask], hist[mask]) and int(hm[~mask].abs().sum()) \
        == 0


def _fold_inputs(seed, R, n, m, device):
    rng = np.random.RandomState(seed)
    C = rng.randint(0, 9, (R, n, m)).astype(np.float32)
    va = rng.randint(0, 12, n).astype(np.float32)
    vb = rng.randint(0, 12, m).astype(np.float32)
    va[: n // 7] = 0                              # empty graphs: d <= 0
    return [torch.from_numpy(x).to(device) for x in (C, va, vb)]


def _symmetric(C):
    return torch.triu(C) + torch.triu(C, 1).transpose(1, 2)


@pytest.mark.parametrize("R,n,m,route", [
    (3, 1, 1, "pair"), (3, 31, 31, "pair"), (3, 33, 33, "pair"),
    (5, 100, 100, "pair"), (1, 257, 257, "pair"), (3, 40, 40, "rect"),
    (1, 37, 1001, "rect"), (3, 1001, 37, "rect"), (2, 1, 5, "rect"),
    (5, 66, 67, "rect"), (4, 129, 130, "rect"),
    (1, 1, 1, "triangle"), (3, 31, 31, "triangle"), (3, 33, 33, "triangle"),
    (1, 65, 65, "triangle"), (5, 100, 100, "triangle"),
    (3, 4110, 4110, "triangle"), (2, 258, 258, "triangle"),
    (4, 97, 97, "triangle")])
def test_jaccard_fold_kernel_bit_identical(cuda, R, n, m, route):
    """Each K5 route against jaccard_fold_plain on the card and on the
    CPU, bit for bit, R = 1 to 5, n and m off the tile and off 16-byte
    rows: pair (a non-symmetric stack too: the pair (i, j), (j, i)
    fold), rect, and triangle on symmetric stacks with one vertex-count
    vector, where it equals the unsymmetrized fold too and reads only
    the tiles on and above the diagonal (the others poisoned with NaN)."""
    C, va, vb = _fold_inputs(R * n + m, R, n, m, cuda)
    sym = route != "rect"
    if route == "triangle":
        C, vb = _symmetric(C), va
    elif sym:
        vb = va
    before = intersect.jaccard_fold_cuda.launches
    by_route = dict(intersect.jaccard_fold_cuda.route_launches)
    Cin = C
    if route == "triangle":
        t = intersect.K5_TILE
        i = torch.arange(n, device=cuda) // t
        below = i[:, None] > i[None, :]
        Cin = C.masked_fill(below, float("nan"))
    K = intersect.jaccard_fold_cuda(Cin, va, vb, sym,
                                    triangle=route == "triangle")
    torch.cuda.synchronize()
    assert intersect.jaccard_fold_cuda.launches == before + 1
    assert intersect.jaccard_fold_cuda.route_launches[route] == \
        by_route[route] + 1
    P = intersect.jaccard_fold_plain(C, va, vb, sym)
    Pc = intersect.jaccard_fold_plain(C.cpu(), va.cpu(), vb.cpu(), sym)
    assert torch.equal(K.view(torch.int32), P.view(torch.int32))
    assert torch.equal(K.cpu().view(torch.int32), Pc.view(torch.int32))
    if sym:
        assert torch.equal(K, K.T)
    if route == "triangle":
        U = intersect.jaccard_fold_plain(C, va, va, False)
        assert torch.equal(K.view(torch.int32), U.view(torch.int32))


@pytest.mark.parametrize("sym", [True, False])
def test_jaccard_gram_rounds_on_card(cuda, sym):
    """jaccard_gram_rounds on the card: one K1 call a round that routes
    to K1 and ONE K1-tc launch for the rounds that route to K1-tc, one K5
    launch, equal to the CPU run bit for bit."""
    rng = np.random.RandomState(4)
    A = torch.tensor(rng.randint(0, 4, (3, 300, 256)), dtype=torch.float32,
                     device=cuda)
    B = A if sym else torch.tensor(rng.randint(0, 4, (3, 77, 256)),
                                   dtype=torch.float32, device=cuda)
    va = A[0].sum(1) + 2
    vb = va if sym else B[0].sum(1)
    counters = (intersect.min_gram_cuda, intersect.min_gram_tc_cuda,
                intersect.jaccard_fold_cuda)
    before = [c.launches for c in counters]
    routes = dict(intersect.jaccard_fold_cuda.route_launches)
    K = intersect.jaccard_gram_rounds(A, B, va=va, vb=vb)
    torch.cuda.synchronize()
    got = [c.launches - b for c, b in zip(counters, before)]
    n_tc = sum(intersect.min_gram_route(
        A[r].amax(0).cpu().numpy(), B[r].amax(0).cpu().numpy(), True,
        sym) == "min_gram_tc" for r in range(3))
    assert got == [3 - n_tc, int(n_tc > 0), 1]
    route = "triangle" if sym else "rect"
    assert intersect.jaccard_fold_cuda.route_launches[route] == \
        routes[route] + 1
    Kc = intersect.jaccard_gram_rounds(A.cpu(), None if sym else B.cpu(),
                                       va=va.cpu(),
                                       vb=None if sym else vb.cpu())
    assert torch.equal(K.cpu(), Kc)


@pytest.mark.parametrize("integer,sym", [(True, True), (True, False),
                                         (False, False)])
def test_min_intersection_gram_rounds_on_card(cuda, integer, sym):
    """One K1 call a round by default, each adding into its slice of the
    zeroed stack, equal to R min_gram_plain calls: integers exactly,
    reals at K1's tolerance."""
    rng = np.random.RandomState(5)
    R, n, m, L = 3, 129, 65, 90
    A = rng.randint(0, 9, (R, n, L)) if integer else rng.rand(R, n, L)
    B = rng.randint(0, 9, (R, m, L)) if integer else rng.rand(R, m, L)
    A = torch.tensor(A, dtype=torch.float32, device=cuda)
    B = A if sym else torch.tensor(B, dtype=torch.float32, device=cuda)
    before = intersect.min_gram_cuda.launches
    K = intersect.min_intersection_gram_rounds(A, B)
    torch.cuda.synchronize()
    assert intersect.min_gram_cuda.launches == before + R
    for r in range(R):
        P = intersect.min_gram_plain(A[r], B[r])
        if integer:
            assert torch.equal(K[r], P)
        else:
            torch.testing.assert_close(K[r], P, rtol=1e-5, atol=1e-4)


def test_nh_path_launches_on_card(cuda):
    """NeighborhoodHash fit_transform on the card: one K4 launch a parse
    (the graph route), one K5 launch a Gram (the triangle route for the
    fit Gram, rect for the transform's), one K1 call a round that routes
    to K1 and ONE K1-tc launch a Gram for the rounds that route to
    K1-tc."""

    def want(Y, X, sym):
        tc = sum(intersect.min_gram_route(
            Y[r].amax(0).cpu().numpy(), X[r].amax(0).cpu().numpy(), True,
            sym) == "min_gram_tc" for r in range(X.shape[0]))
        return X.shape[0] - tc, int(tc > 0)

    train, test = generate_dataset(n_graphs=60, n_graphs_test=10,
                                   r_vertices=(5, 30), random_state=8,
                                   features=("nl", 6))
    counters = (nh.nh_graph_cuda, nh.nh_round_cuda,
                intersect.jaccard_fold_cuda, intersect.min_gram_cuda,
                intersect.min_gram_tc_cuda)
    for c in counters:
        c.launches = 0
    folds = intersect.jaccard_fold_cuda.route_launches
    for r in folds:
        folds[r] = 0
    k = grakel_torch.NeighborhoodHash(random_state=0, R=4)
    k.fit_transform(train)
    torch.cuda.synchronize()
    assert [c.launches for c in counters[:3]] == [1, 0, 1]
    X = k.X["hists"]
    fit = want(X, X, True)
    assert (counters[3].launches, counters[4].launches) == fit
    assert folds == {"rect": 0, "pair": 0, "triangle": 1}
    k.transform(test)
    assert [c.launches for c in counters[:3]] == [2, 0, 2]
    tr = want(k._Y["hists"], X, False)
    assert (counters[3].launches, counters[4].launches) == (
        fit[0] + tr[0], fit[1] + tr[1])
    assert folds == {"rect": 1, "pair": 0, "triangle": 1}


def test_nh_and_jaccard_wrappers_check_inputs(cuda):
    b, lab, valid = _nh_batch(0, 5, cuda)
    hist = torch.zeros((b.n_graphs, 256), dtype=torch.int32, device=cuda)
    args = [lab, valid, b.node_graph_ids, b.csr_offsets, b.csr_targets, hist]
    for i, bad in ((0, lab.long()), (1, valid.int()), (0, lab.cpu()),
                   (2, b.node_graph_ids[:-1]), (3, b.csr_offsets[:-1]),
                   (5, hist[:, :128]), (5, hist.t())):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            nh.nh_round_cuda(*a, 8, False)
    with pytest.raises(ValueError):
        nh.nh_round_cuda(*args, 31, False)                # bits
    with pytest.raises(ValueError):
        nh.nh_round_cuda(*[x.cpu() for x in args], 8, False)
    mask = torch.ones(b.n_graphs, dtype=torch.bool, device=cuda)
    for kw in ({"graph_mask": mask[:-1]}, {"graph_mask": mask.int()},
               {"nodes": (3, 2)}, {"nodes": (0, lab.shape[0] + 1)}):
        with pytest.raises(ValueError):
            nh.nh_round_cuda(*args, 8, False, **kw)
    chunks, _, _ = nh.nh_plan(b.n_nodes, b.n_edges, 8)
    H = torch.zeros((2, b.n_graphs, 256), dtype=torch.int32, device=cuda)
    for bad in (chunks[:, :5], chunks + [[0, 1, 0, 0, 0, 0]],
                chunks + [[0, 0, 0, lab.shape[0], 0, 0]],
                chunks + [[0, 0, 0, 0, 0, b.csr_targets.shape[0] + 1]]):
        with pytest.raises(ValueError):
            nh.nh_graph_cuda(*args[:5], bad, H, 8, False)
    for bad in (H[0], H[:, :, :128], H.long(), H.cpu()):
        with pytest.raises(ValueError):
            nh.nh_graph_cuda(*args[:5], chunks, bad, 8, False)
    with pytest.raises(ValueError):
        nh.nh_graph_cuda(*[x.cpu() for x in args[:5]], chunks, H, 8, False)
    C, va, vb = _fold_inputs(0, 2, 6, 5, cuda)
    for bad in ((C.double(), va, vb), (C, va[:-1], vb), (C, va, vb.cpu()),
                (C[:, :, :4], va, vb), (C[:0], va, vb),
                (C.transpose(1, 2), vb, va)):
        with pytest.raises(ValueError):
            intersect.jaccard_fold_cuda(*bad, False)
    with pytest.raises(ValueError):
        intersect.jaccard_fold_cuda(C, va, vb, True)      # 6 x 5
    S = C[:, :5, :5].contiguous()
    for vs, sym in (((vb, vb.clone()), True), ((vb, vb), False)):
        with pytest.raises(ValueError, match="triangle"):
            intersect.jaccard_fold_cuda(S, *vs, sym, triangle=True)
    with pytest.raises(ValueError):
        intersect.jaccard_fold_cuda(C.cpu(), va.cpu(), vb.cpu(), False)


# --------------------------------------------------------------------- #
# K6: HadamardCode's generation step
# --------------------------------------------------------------------- #

def _hc_batch(seed, hub, device):
    """Random graphs of 1-40 vertices, an edgeless one, self-loops, and
    with ``hub`` one graph whose vertex 0 links both ways to 250 others
    (out-degree 250: a warp's lanes loop over all of it)."""
    rng = np.random.RandomState(seed)
    graphs = [Graph.from_arrays(3, [], [])]
    for _ in range(60):
        n = rng.randint(1, 41)
        e = rng.randint(0, 3 * n)
        graphs.append(Graph.from_arrays(n, rng.randint(0, n, e),
                                        rng.randint(0, n, e)))
    if hub:
        others = np.arange(1, 251)
        graphs.insert(7, Graph.from_arrays(
            251, np.r_[np.zeros(250, int), others],
            np.r_[others, np.zeros(250, int)]))
    return GraphBatch.from_graphs(graphs, node_label_enum={}, device=device)


@pytest.mark.parametrize("D", [1, 2, 4, 8, 16, 32, 64, 128, 512, 1024])
@pytest.mark.parametrize("case", ["small", "wrap", "hub"])
def test_hadamard_step_kernel_bit_identical(cuda, D, case):
    """K6 against its plain version on the card, with and without the
    neighbour sum: codes of a few units, codes over the whole int32 range
    (the sums wrap), and a hub of out-degree 250."""
    b = _hc_batch(D, case == "hub", cuda)
    N = b.node_labels.shape[0]
    rng = np.random.RandomState(D + len(case))
    if case == "wrap":
        c = rng.randint(-2 ** 31, 2 ** 31, (N, D), dtype=np.int64)
    else:
        c = rng.randint(-3, 4, (N, D))
    codes = torch.tensor(c.astype(np.int32), device=cuda)
    tag = torch.tensor(rng.randint(0, 2 ** 31, N).astype(np.int32),
                       device=cuda)
    args = (codes, b.csr_offsets, b.csr_targets, tag)
    for propagate in (False, True):
        before = hadamard.hadamard_step_cuda.launches
        got, key = hadamard.hadamard_step_cuda(*args, propagate)
        torch.cuda.synchronize()
        assert hadamard.hadamard_step_cuda.launches == before + 1
        want, wkey = hadamard.hadamard_step_plain(*args, propagate)
        assert torch.equal(got, want) and torch.equal(key, wkey)
        assert (got is codes) == (not propagate)
    if case == "wrap":
        wide = codes.long().clone()
        s = torch.repeat_interleave(torch.arange(N, device=cuda),
                                    torch.diff(b.csr_offsets.long()))
        wide.index_add_(0, s, codes.long()[b.csr_targets.long()])
        assert (wide.abs() >= 2 ** 31).any()


def _k6_launches():
    return (hadamard.hadamard_graph_cuda.launches,
            hadamard.hadamard_step_cuda.launches)


def _hc_table(b, D, case, seed):
    """A table and row indices for ``b`` (padding rows on a zero row):
    codes of a few units, or one row a node over the whole int32 range
    ("wrap": the sums pass 2^31), and random tags."""
    N = b.node_labels.shape[0]
    n = b.total_nodes
    rng = np.random.RandomState(seed)
    if case == "wrap":
        table = rng.randint(-2 ** 31, 2 ** 31, (n + 1, D), dtype=np.int64)
        row = np.arange(N)
    else:
        table = rng.randint(-3, 4, (max(n // 4, 1) + 1, D))
        row = rng.randint(0, len(table) - 1, N)
    table[-1] = 0
    row[n:] = len(table) - 1
    tag = rng.randint(0, 2 ** 31, N)
    dev = b.csr_offsets.device
    return tuple(torch.tensor(a.astype(np.int32), device=dev)
                 for a in (table, np.minimum(row, len(table) - 1), tag))


@pytest.mark.parametrize("D", [1, 2, 8, 32, 64, 128, 1024])
@pytest.mark.parametrize("case", ["small", "wrap", "hub"])
def test_hadamard_graph_route_bit_identical(cuda, D, case):
    """``hadamard_generations`` on the card (K6's graph route, and its
    round route for graphs whose buffers do not fit a block: the hub's
    at D >= 128, most at D = 1024) against the plain multi-generation
    version on the card, n_iter 1, 2 and 5, every row of the key stack;
    the launches per route match the plan."""
    b = _hc_batch(D, case == "hub", cuda)
    table, row, tag = _hc_table(b, D, case, D + len(case))
    _, rnd, _ = hadamard.hc_plan(b.n_nodes, b.n_edges, D, row.shape[0])
    for n_iter in (1, 2, 5):
        want = hadamard.hadamard_generations_plain(
            table, row, b.csr_offsets, b.csr_targets, tag, n_iter)
        before = _k6_launches()
        got = hadamard.hadamard_generations(b, table, row, tag, n_iter)
        torch.cuda.synchronize()
        took = tuple(x - y for x, y in zip(_k6_launches(), before))
        assert took == (1, n_iter if len(rnd) else 0), (took, len(rnd))
        assert got.shape == (n_iter, row.shape[0]) and torch.equal(got, want)
    if case == "hub" and D >= 128:
        assert 7 in rnd.tolist()
    if D == 1024:
        assert len(rnd) > b.n_graphs // 2


@pytest.mark.parametrize("D", [4, 64])
def test_hadamard_generations_on_card(cuda, D, monkeypatch):
    """The budget moves graphs between K6's routes: none (every graph on
    the round route, the padding rows still on the graph route's one
    launch), a budget that sends the largest graphs (the hub's among
    them) to the round route and leaves graph-route graphs between them
    (a masked round route), and the default; the keys equal the CPU run
    of the plain version each time, and the caller's table and rows are
    untouched."""
    bc = _hc_batch(3, True, "cpu")
    bg = _hc_batch(3, True, cuda)
    table, row, tag = _hc_table(bc, D, "wrap", 11)
    want = hadamard.hadamard_generations(bc, table, row, tag, 5)
    each = hadamard.k6_smem_bytes(bg.n_nodes, bg.n_edges, D)
    mixed = int(np.sort(each)[-4])
    tg, rg, gg = (x.to(cuda) for x in (table, row, tag))
    for budget in (0, mixed, hadamard.K6_SMEM_BUDGET):
        monkeypatch.setattr(hadamard, "K6_SMEM_BUDGET", budget)
        _, rnd, _ = hadamard.hc_plan(bg.n_nodes, bg.n_edges, D,
                                     row.shape[0], budget)
        if budget == mixed:
            assert 7 in rnd.tolist() and 3 <= len(rnd) < rnd[-1] - rnd[0]
        before = _k6_launches()
        got = hadamard.hadamard_generations(bg, tg, rg, gg, 5)
        torch.cuda.synchronize()
        took = tuple(x - y for x, y in zip(_k6_launches(), before))
        assert took == (1, 5 if len(rnd) else 0), (budget, took)
        assert torch.equal(got.cpu(), want)
    assert torch.equal(tg.cpu(), table) and torch.equal(rg.cpu(), row)


def test_hadamard_round_route_node_range_and_out(cuda):
    """The round route over a node range with a graph mask writes the
    keys of the masked graphs' nodes only, from rows local to the range;
    a given ``out`` buffer is written there and nowhere else."""
    b = _hc_batch(5, True, cuda)
    N = b.node_labels.shape[0]
    rng = np.random.RandomState(6)
    codes = torch.tensor(rng.randint(-9, 10, (N, 32)).astype(np.int32),
                         device=cuda)
    tag = torch.full((N,), 32, dtype=torch.int32, device=cuda)
    want, wkey = hadamard.hadamard_step_plain(codes, b.csr_offsets,
                                              b.csr_targets, tag, True)
    g0, g1 = 5, 20
    lo, hi = int(b.node_offsets[g0]), int(b.node_offsets[g1])
    on = torch.zeros(b.n_graphs, dtype=torch.bool, device=cuda)
    on[g0:g1:2] = True
    key = torch.full((N,), -1, dtype=torch.int64, device=cuda)
    out = torch.full((hi - lo, 32), 7, dtype=torch.int32, device=cuda)
    nxt, k = hadamard.hadamard_step_cuda(
        codes[lo:hi].contiguous(), b.csr_offsets, b.csr_targets, tag, True,
        out=out, nodes=(lo, hi), graph_mask=on, gids=b.node_graph_ids,
        key=key)
    torch.cuda.synchronize()
    assert nxt is out and k is key
    gid = b.node_graph_ids.long()
    mine = b.node_mask & (gid >= g0) & (gid < g1) & (gid % 2 == g0 % 2)
    assert int(mine.sum()) > 0
    assert torch.equal(key[mine], wkey[mine])
    assert (key[~mine] == -1).all()
    local = mine[lo:hi]
    assert torch.equal(out[local], want[lo:hi][local])
    assert (out[~local] == 7).all()


def test_hadamard_wrapper_checks_inputs(cuda):
    b = _hc_batch(0, False, cuda)
    N = b.node_labels.shape[0]
    codes = torch.zeros((N, 8), dtype=torch.int32, device=cuda)
    tag = torch.full((N,), 8, dtype=torch.int32, device=cuda)
    args = [codes, b.csr_offsets, b.csr_targets, tag]
    for i, bad in ((0, codes.long()), (0, codes[:, :6].contiguous()),
                   (0, codes[:, ::2]), (0, codes[0]), (1, args[1][:-1]),
                   (2, args[2].long()), (3, tag[:-1]), (3, tag.cpu())):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            hadamard.hadamard_step_cuda(*a, True)
    for out in (codes, codes[:, :4].contiguous(), codes.long(),
                codes.cpu()):
        with pytest.raises(ValueError, match="out"):
            hadamard.hadamard_step_cuda(*args, True, out=out)
    with pytest.raises(ValueError):
        hadamard.hadamard_step_cuda(*[x.cpu() for x in args], False)
    for kw in ({"nodes": (0, N - 1)}, {"nodes": (2, 1)},
               {"graph_mask": torch.ones(b.n_graphs, dtype=torch.bool,
                                         device=cuda)},
               {"key": torch.empty(N, dtype=torch.int32, device=cuda)},
               {"key": torch.empty(N - 1, dtype=torch.int64, device=cuda)}):
        with pytest.raises(ValueError):
            hadamard.hadamard_step_cuda(*args, True, **kw)
    # the graph route's wrapper
    table, row, tag8 = _hc_table(b, 8, "small", 1)
    chunks, _, _ = hadamard.hc_plan(b.n_nodes, b.n_edges, 8, N)
    key = torch.empty((3, N), dtype=torch.int64, device=cuda)
    good = [table, row, tag8, b.csr_offsets, b.csr_targets, chunks, key]
    bad_chunks = chunks.copy()
    bad_chunks[0, 3] = N + 1
    for i, bad in ((0, table[:, :6].contiguous()), (0, table.long()),
                   (1, row[:-1]), (1, row.cpu()), (2, tag8[:-1]),
                   (3, b.csr_offsets[:-1]), (5, chunks[:, :4]),
                   (5, bad_chunks), (6, key[0]), (6, key.int()),
                   (6, key[:, :-1].contiguous()),
                   (6, torch.empty((0, N), dtype=torch.int64,
                                   device=cuda))):
        a = list(good)
        a[i] = bad
        with pytest.raises(ValueError):
            hadamard.hadamard_graph_cuda(*a)
    with pytest.raises(ValueError):
        hadamard.hadamard_generations(b, table, row, tag8.cpu(), 2)


@pytest.mark.parametrize("name,kw,k6", [
    ("HadamardCode", {"n_iter": 3}, 1),
    ("HadamardCode", {"n_iter": 5, "normalize": True}, 1),
    ("HadamardCode", {"n_iter": 2, "base_graph_kernel": "SP"}, 0),
    ("Propagation", {"random_state": 0}, 0),
    ("Propagation", {"random_state": 1, "M": "H", "normalize": True}, 0),
    ("PropagationAttr", {"random_state": 0}, 0),
    ("PropagationAttr", {"random_state": 2, "M": "L2", "w": 0.5}, 0)])
def test_hc_and_propagation_on_card_match_cpu(cuda, name, kw, k6):
    """The three classes on the card equal their CPU runs (the test split
    holds a label unseen at fit); HadamardCode's fast path launches K6's
    graph route once in fit_transform and once in transform and its round
    route never (the graphs fit a block), its host path (a ShortestPath
    base) none and K3 instead."""
    feats = ("na", 3) if name == "PropagationAttr" else ("nl", 6)
    train, test = generate_dataset(n_graphs=80, n_graphs_test=10,
                                   r_vertices=(5, 30), random_state=2,
                                   features=feats)
    if kw.get("base_graph_kernel") == "SP":
        kw = dict(kw, base_graph_kernel=(grakel_torch.ShortestPath, {}))
    k = getattr(grakel_torch, name)(**kw)
    hadamard.hadamard_graph_cuda.launches = 0
    hadamard.hadamard_step_cuda.launches = 0
    fw.floyd_warshall_cuda.launches = 0
    K = k.fit_transform(train)
    torch.cuda.synchronize()
    assert _k6_launches() == (k6, 0)
    T = k.transform(test)
    d = k.diagonal()
    torch.cuda.synchronize()
    assert _k6_launches() == (2 * k6, 0)
    if "base_graph_kernel" in kw:
        assert fw.floyd_warshall_cuda.launches > 0
    with use_device("cpu"):
        kc = getattr(grakel_torch, name)(**kw)
        Kc, Tc, dc = kc.fit_transform(train), kc.transform(test), \
            kc.diagonal()
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)
    assert all(np.array_equal(a, b) for a, b in zip(d, dc))


def _native_split(seed=4, n=60, held=10):
    return generate_dataset(n_graphs=n, n_graphs_test=held,
                            r_vertices=(5, 20), random_state=seed,
                            features=("nl", 5))


def _run_kernel(k, fit, tr):
    """fit_transform, diagonal, transform and both diagonals."""
    K = k.fit_transform(fit)
    d = k.diagonal()
    T = k.transform(tr)
    return (K, d, T) + tuple(np.atleast_1d(x) for x in k.diagonal())


@pytest.mark.parametrize("params", [
    {}, {"h": 2, "normalize": True}, {"h": 1}])
def test_oddsth_on_card_matches_cpu(cuda, params):
    """OddSth's integer Gram on the card (the shared columns'
    counts-Gram) equals the CPU run bit for bit, transform and diagonals
    too."""
    train, test = _native_split()
    got = _run_kernel(grakel_torch.OddSth(**params), train, test)
    with use_device("cpu"):
        ref = _run_kernel(grakel_torch.OddSth(**params), train, test)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_oddsth_exact_past_2_24_on_card(cuda):
    """Edgeless graphs put K[i, j] = n_0 n_i n_j past 2^24 and odd: the
    card's f64 Gram is the exact integer one."""
    ns = [261, 263, 259, 5]
    fit = [[np.zeros((n, n)), {v: 0 for v in range(n)}] for n in ns]
    K = grakel_torch.OddSth().fit_transform(fit)
    assert np.array_equal(K, [[ns[0] * a * b for b in ns] for a in ns])


@pytest.mark.parametrize("params,mult", [
    ({}, 64), ({"normalize": True, "r": 2}, 64), ({}, 3)])
def test_nspd_on_card_matches_cpu(cuda, params, mult, monkeypatch):
    """NSPD's f64 products on the card (the dense block of the fit Gram,
    lowered to columns of more than 3 graphs in one case so it holds
    many, and the transform's one product over the touched columns)
    equal the CPU run to rtol 1e-12; the test split holds unseen keys."""
    monkeypatch.setattr(grakel_torch.NeighborhoodSubgraphPairwiseDistance,
                        "_DENSE_COL_MULT", mult)
    train, test = _native_split(5)
    got = _run_kernel(grakel_torch.NeighborhoodSubgraphPairwiseDistance(
        **params), train, test)
    with use_device("cpu"):
        ref = _run_kernel(grakel_torch.NeighborhoodSubgraphPairwiseDistance(
            **params), train, test)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_subgraph_matching_on_card_matches_cpu(cuda):
    """SubgraphMatching runs on the host under a card's entry points:
    the same Grams as its CPU run, bit for bit."""
    train, test = _native_split(6, 8, 3)
    got = _run_kernel(grakel_torch.SubgraphMatching(k=3), train, test)
    with use_device("cpu"):
        ref = _run_kernel(grakel_torch.SubgraphMatching(k=3), train, test)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


# --------------------------------------------------------------------- #
# K7 (canonical codes), K8 (the pair CG solve), K9 (the spectral tile)
# --------------------------------------------------------------------- #

def _random_masks(s, count, seed):
    rng = np.random.RandomState(seed)
    A = (rng.rand(count, s, s) < rng.rand(count, 1, 1)).astype(np.int8)
    return torch.from_numpy(canonical.adjacency_masks(list(A)))


@pytest.mark.parametrize("s", range(2, 9))
def test_canonical_codes_kernel_bit_identical(cuda, s):
    """K7 at every size, graphlets of every density (every graph at s <=
    4; 20000 random ones above), against the plain gather-and-min: equal
    codes, one launch a call."""
    if s <= 4:
        nb = s * (s - 1) // 2
        adjs = []
        for bits in range(1 << nb):
            M = np.zeros((s, s), np.int8)
            M[np.triu_indices(s, 1)] = [(bits >> k) & 1 for k in range(nb)]
            adjs.append(M)
        masks = torch.from_numpy(canonical.adjacency_masks(adjs))
    else:
        masks = _random_masks(s, 20000 if s < 8 else 4000, s)
    before = canonical.canonical_codes_cuda.launches
    got = canonical.canonical_codes_cuda(masks.to(cuda), s)
    torch.cuda.synchronize()
    assert canonical.canonical_codes_cuda.launches == before + 1
    assert got.dtype == torch.int32
    want = canonical.canonical_codes_plain(masks, s)
    assert torch.equal(got.cpu().to(torch.int64), want)
    if s == 8:   # the table's other placement
        other = canonical.canonical_codes_cuda(
            masks.to(cuda), s, shared=not canonical.K7_S8_SHARED)
        assert torch.equal(other.cpu().to(torch.int64), want)


@pytest.mark.parametrize("s", range(2, 9))
def test_canonical_codes_kernel_edge_cases(cuda, s):
    """The empty and the complete graphlet, and batches that fill no
    whole warp or block (1, 31, 33, 257 graphlets), at every size and
    both table placements at s = 8: the codes of the plain version."""
    adjs = [np.zeros((s, s), np.int8), 1 - np.eye(s, dtype=np.int8)]
    rng = np.random.RandomState(s)
    adjs += list((rng.rand(255, s, s) < 0.5).astype(np.int8))
    masks = torch.from_numpy(canonical.adjacency_masks(adjs))
    want = canonical.canonical_codes_plain(masks, s)
    assert want[0] == 0 and want[1] == (1 << s * (s - 1) // 2) - 1
    for count in (1, 2, 31, 33, 257):
        for shared in ((True, False) if s == 8 else (None,)):
            got = canonical.canonical_codes_cuda(masks[:count].to(cuda), s,
                                                 shared=shared)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu().to(torch.int64), want[:count])


def test_canonical_codes_wrapper_checks(cuda):
    m = _random_masks(5, 10, 0).to(cuda)
    for bad in (m.to(torch.int32), m[::2], m.view(2, 5)):
        with pytest.raises(ValueError):
            canonical.canonical_codes_cuda(bad, 5)
    for s in (1, 9):
        with pytest.raises(ValueError):
            canonical.canonical_codes_cuda(m, s)
    assert canonical.canonical_codes_cuda(m[:0], 5).shape == (0,)
    with use_device(cuda):
        codes = canonical.canonical_codes([np.eye(4)[::-1]] * 3)
    assert codes.dtype == np.int64 and codes.shape == (3,)


def _cg_tables(seed, V1, V2, labels=0, directed=False, B=40, extra=0):
    """Sparse random graphs (mean degree ~3, so that lamda mu nu < 1 at
    lamda = 0.02 and CG converges), B of each bucket (the first fills its
    bucket, the others 1..V vertices), packed into two tables with
    ``cg_table`` (labeled: vertices sorted by label); pair k is (k, k),
    then ``extra`` random pairs of table rows reuse them.  Returns
    [Gx, Gy, nx, ny, ia, ib, Lx, Ly] CPU tensors (Lx, Ly None
    unlabeled)."""
    rng = np.random.RandomState(seed)
    nx = rng.randint(1, V1 + 1, B)
    ny = rng.randint(1, V2 + 1, B)
    nx[0], ny[0] = V1, V2

    def adj(n):
        out = []
        for k in n:
            M = (rng.rand(k, k) < min(0.2, 3.0 / k)).astype(np.float32)
            if not directed:
                M = np.triu(M, 1)
                M = M + M.T
            np.fill_diagonal(M, 0)
            out.append(M)
        return out
    ax, ay = adj(nx), adj(ny)
    lx, ly = [], []
    for b in range(B):
        lx.append(rng.randint(0, max(labels, 1), nx[b]))
        ly.append(rng.randint(0, max(labels, 1), ny[b]))
    A1, n1, L1 = rw_ops.cg_table(ax, V1, lx if labels else None)
    A2, n2, L2 = rw_ops.cg_table(ay, V2, ly if labels else None)
    ia = np.concatenate([np.arange(B), rng.randint(0, B, extra)])
    ib = np.concatenate([np.arange(B), rng.randint(0, B, extra)])
    t = lambda a: None if a is None else torch.from_numpy(a)
    return [t(x) for x in (A1, A2, n1, n2, ia.astype(np.int32),
                           ib.astype(np.int32), L1, L2)]


def _k8(args, lamda, device, **kw):
    """pair_cg_cuda on ``_cg_tables``'s arguments moved to ``device``."""
    c = lambda t: None if t is None else t.to(device)
    Gx, Gy, nx, ny, ia, ib, Lx, Ly = (c(t) for t in args)
    return rw_ops.pair_cg_cuda(Gx, Gy, nx, ny, ia, ib, lamda, Lx, Ly, **kw)


@pytest.mark.parametrize("V1,V2,labels,directed", [
    (8, 8, 0, False), (8, 16, 3, False), (16, 32, 0, True),
    (32, 32, 0, False), (32, 32, 5, True), (32, 16, 7, False),
    (16, 16, 4, False), (24, 32, 2, False),
    (64, 64, 0, False), (64, 64, 5, False), (128, 16, 0, True),
    (128, 128, 4, False), (256, 64, 3, False)])
def test_rw_cg_kernel_matches_plain(cuda, V1, V2, labels, directed):
    """K8 on the route its buckets take (warp up to 32 x 32, shared to 64
    x 64, global past) against the plain CG on the same tables and
    pairs, unlabeled and labeled, directed and not, at lamda = 0.02,
    where lamda mu nu < 1: f32 sums in another order, rtol 1e-4 on every
    pair (the iterates stay bounded, so rounding is not amplified; a
    directed pair may run all 20 steps without freezing).  The pairs
    freeze on different steps."""
    args = _cg_tables(V1 + 3 * V2 + labels, V1, V2, labels, directed,
                      extra=40)
    want, steps = rw_ops.pair_cg_plain(*args[:6], 0.02, *args[6:], labels,
                                       return_steps=True)
    assert len(set(steps.tolist())) > 1
    route = rw_ops.cg_route(V1, V2, bool(labels))
    assert (route == "warp") == (V1 <= 32 and V2 <= 32)
    before = dict(rw_ops.pair_cg_cuda.route_launches)
    got = _k8(args, 0.02, cuda)
    torch.cuda.synchronize()
    assert rw_ops.pair_cg_cuda.route_launches == {
        r: before[r] + (r == route) for r in before}
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("labels", [0, 3])
def test_rw_cg_warp_route_many_pairs(cuda, labels):
    """More pairs than the warp route's resident warps (each warp takes
    pairs from the atomic counter until none is left): every pair
    written, each to rtol 1e-4 of the plain CG; one launch."""
    args = _cg_tables(7 + labels, 16, 32, labels, B=50, extra=6000)
    want = rw_ops.pair_cg_plain(*args[:6], 0.02, *args[6:], labels)
    before = rw_ops.pair_cg_cuda.route_launches["warp"]
    got = _k8(args, 0.02, cuda)
    torch.cuda.synchronize()
    assert rw_ops.pair_cg_cuda.route_launches["warp"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("V1,V2,labels,directed,lamda", [
    (64, 64, 0, False, 0.05), (64, 64, 0, True, 0.1),
    (128, 16, 0, True, 0.1), (256, 64, 3, True, 0.1),
    (32, 32, 0, True, 0.1), (32, 16, 3, True, 0.1)])
def test_rw_cg_kernel_where_cg_diverges(cuda, V1, V2, labels, directed,
                                        lamda):
    """Where lamda mu nu passes 1 (RandomWalk()'s lamda = 0.1 on
    directed graphs) many pairs run all 20 steps unfrozen, and f32 CG
    may amplify rounding on them without limit: no f32 order of the
    sums, the JAX package's included, fixes their value (the plain
    version lies up to 100 % from its f64 evaluation at 64 x 64, lamda
    0.1).  rtol 1e-4 holds only for pairs that converge: K8 is held on
    the pairs whose plain CG froze and lies within 1e-5 relative of its
    f64 evaluation, the others at nothing.  Unfrozen pairs differed
    between K8 and the plain version by 1.03e-4 relative (here, lamda
    0.05) and by 2.4e-4 where the f32 plain lay within 1e-5 of f64
    (directed NCI1-scale pairs of 64 vertices, lamda 0.1)."""
    args = _cg_tables(V1 + 3 * V2 + labels, V1, V2, labels, directed)
    want, steps = rw_ops.pair_cg_plain(*args[:6], lamda, *args[6:], labels,
                                       return_steps=True)
    assert (steps == rw_ops.CG_ITERS).any()
    exact = rw_ops.pair_cg_plain(args[0].double(), args[1].double(),
                                 *args[2:6], lamda, *args[6:],
                                 labels).numpy()
    held = (steps < rw_ops.CG_ITERS).numpy() & (
        np.abs(want.numpy() - exact) <= 1e-5 * np.abs(exact))
    assert held.any()
    got = _k8(args, lamda, cuda).cpu().numpy()
    np.testing.assert_allclose(got[held], want.numpy()[held], rtol=1e-4,
                               atol=1e-4)


def test_rw_cg_wrapper_checks(cuda):
    Gx, Gy, nx, ny, ia, ib, Lx, Ly = (
        None if t is None else t.to(cuda) for t in _cg_tables(1, 8, 8, 2,
                                                               B=4))
    with pytest.raises(ValueError):
        rw_ops.pair_cg_cuda(Gx, Gy, nx.long(), ny, ia, ib, 0.1)
    with pytest.raises(ValueError):
        rw_ops.pair_cg_cuda(Gx, Gy, nx, ny, ia, ib.long(), 0.1)
    with pytest.raises(ValueError):
        rw_ops.pair_cg_cuda(Gx, Gy, nx, ny, ia, ib[:3], 0.1)
    with pytest.raises(ValueError):
        rw_ops.pair_cg_cuda(Gx, Gy, nx, ny, ia, ib, 0.1, Lx, None)
    with pytest.raises(ValueError):
        rw_ops.pair_cg_cuda(Gx[:, :4], Gy, nx, ny, ia, ib, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        rw_ops.pair_cg_cuda(Gx.cpu(), Gy.cpu(), nx.cpu(), ny.cpu(),
                            ia.cpu(), ib.cpu(), 0.1)
    big = torch.zeros((1, 4097, 4097), device=cuda)
    n = torch.ones(1, dtype=torch.int32, device=cuda)
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        rw_ops.pair_cg_cuda(big, big, n, n, z, z, 0.1)
    assert rw_ops.pair_cg_cuda(Gx, Gy, nx, ny, ia[:0], ib[:0],
                               0.1).shape == (0,)


def _spectra(rng, B, Vmax):
    """Random spectra with poles inside the range at lamda 0.1 (lamda mu
    nu up to ~4): per-graph f32 s2, mu lists of 1..Vmax eigenpairs."""
    n = rng.randint(1, Vmax + 1, B)
    n[0] = Vmax
    s2 = [(rng.rand(k) * 4).astype(np.float32) for k in n]
    mu = [(rng.randn(k) * 2.5).astype(np.float32) for k in n]
    return n, s2, mu


def _abs_scale(rows, cols, plan, lamda):
    """sum_ij |sx2 sy2 / den| of every pair, f64, in input order: what
    f64 sums in another order can differ by, relative."""
    sx, mx, _ = rw_ops.padded_spectra(rows, 0, len(plan.order_r))
    sy, my, _ = rw_ops.padded_spectra(cols, 0, len(plan.order_c))
    out = torch.zeros((sx.shape[0], sy.shape[0]), dtype=torch.float64,
                      device=sx.device)
    for i in range(sx.shape[1]):
        den = 1.0 - lamda * mx[:, i, None, None].double() * my[None].double()
        out += sx[:, i, None].double().abs() * (
            sy[None].double() / den).abs().sum(2)
    K = torch.empty_like(out)
    r = torch.from_numpy(plan.order_r).to(out.device)
    c = torch.from_numpy(plan.order_c).to(out.device)
    K[r[:, None], c[None, :]] = out
    return K


@pytest.mark.parametrize("nr,nc,Vmax,symmetric", [
    (300, 300, 64, True), (37, 300, 16, False), (1, 1, 8, True),
    (1, 70, 40, False), (70, 1, 40, False), (40, 40, 512, True),
    (9, 33, 512, False), (65, 65, 130, True)])
def test_rw_spectral_kernel_matches_plain(cuda, nr, nc, Vmax, symmetric):
    """K9's one launch over a plan's tiles against the plain plan Gram on
    spectra with poles inside the range, buckets 8 to 512 (eigenvalues
    past 64 taken in chunks), symmetric (exactly) and rectangular, a side
    of one graph: the same rounded terms, f64 sums in another order,
    within 1e-12 of each entry's sum of |terms| and to rtol 1e-10."""
    rng = np.random.RandomState(nr + nc + Vmax)
    n_r, s2r, mur = _spectra(rng, nr, Vmax)
    n_c, s2c, muc = (n_r, s2r, mur) if symmetric else _spectra(rng, nc,
                                                               Vmax)
    plan = rw_ops.spectral_plan(n_r, n_c, symmetric)
    rows = rw_ops.pack_spectra(s2r, mur, plan.order_r, "cpu")
    cols = rows if symmetric else rw_ops.pack_spectra(s2c, muc,
                                                      plan.order_c, "cpu")
    want = rw_ops.spectral_gram_plain(rows, cols, plan, 0.1)
    c = lambda spec: tuple(t.to(cuda) for t in spec)
    rows_d = c(rows)
    cols_d = rows_d if symmetric else c(cols)
    before = rw_ops.spectral_gram_cuda.launches
    got = rw_ops.spectral_gram_cuda(rows_d, cols_d, plan, 0.1)
    torch.cuda.synchronize()
    assert rw_ops.spectral_gram_cuda.launches == before + 1
    scale = _abs_scale(rows_d, cols_d, plan, 0.1).cpu()
    got = got.cpu()
    assert got.shape == (nr, nc)
    assert ((got - want).abs() <= 1e-12 * scale).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)
    if symmetric:
        assert torch.equal(got, got.T)


def test_rw_spectral_terms_bit_identical(cuda):
    """Graphs of one eigenpair make every Gram entry one term, s1 * (s2 /
    (1 - lam m1 m2)): K9 equals the plain version bit for bit, its split
    division (fast path, check, full division) giving __ddiv_rn's
    quotients.  Zero, f32-denormal, tiny and huge s2, eigenvalues that
    make a denominator exactly zero (0.5 * 2 * 1) or tiny, and 2000
    random ones."""
    rng = np.random.RandomState(3)
    s2 = [0.0, 1e-40, 1e-30, 1e-8, 0.5, 3.0, 50.0, 1e30]
    mu = [0.0, 1e-20, -1e-20, 0.5, -0.5, 1.0, 2.0, -2.0, 1.0000001, 1e20]
    grid = [(a, b) for a in s2 for b in mu]
    rand = list(zip(10.0 ** rng.uniform(-30, 3, 2000),
                    rng.choice([-1, 1], 2000) * 10.0 ** rng.uniform(
                        -20, 2, 2000)))
    pairs = grid + rand
    s2l = [np.array([a], np.float32) for a, _ in pairs]
    mul = [np.array([b], np.float32) for _, b in pairs]
    n = np.ones(len(pairs), np.int64)
    plan = rw_ops.spectral_plan(n[:len(grid)], n, False)
    rows = rw_ops.pack_spectra(s2l[:len(grid)], mul[:len(grid)],
                               plan.order_r, "cpu")
    cols = rw_ops.pack_spectra(s2l, mul, plan.order_c, "cpu")
    want = rw_ops.spectral_gram_plain(rows, cols, plan, 0.5)
    got = rw_ops.spectral_gram_cuda(tuple(t.to(cuda) for t in rows),
                                    tuple(t.to(cuda) for t in cols), plan,
                                    0.5).cpu()
    assert torch.isinf(want).any() and torch.isnan(want).any()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), int((~same).sum())


def test_rw_spectral_gram_wrapper_checks(cuda):
    rng = np.random.RandomState(0)
    n, s2, mu = _spectra(rng, 40, 20)
    plan = rw_ops.spectral_plan(n, None, True)
    spec = rw_ops.pack_spectra(s2, mu, plan.order_r, cuda)
    for bad_plan in (rw_ops.spectral_plan(n, None, True, 33),
                     plan._replace(tiles=plan.tiles + 8),
                     rw_ops.spectral_plan(n, n[:39], False)):
        with pytest.raises(ValueError):
            rw_ops.spectral_gram_cuda(spec, spec, bad_plan, 0.1)
    for bad in ((spec[0].double(), spec[1], spec[2]),
                (spec[0], spec[1], spec[2][:-1]),
                (spec[0], spec[1][:-1], spec[2])):
        with pytest.raises(ValueError):
            rw_ops.spectral_gram_cuda(bad, bad, plan, 0.1)
    for lamda in (2.0 ** 65, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="lamda"):
            rw_ops.spectral_gram_cuda(spec, spec, plan, lamda)
    before = rw_ops.spectral_gram_cuda.launches
    empty = rw_ops.spectral_plan([], None, True)
    none = rw_ops.pack_spectra([], [], empty.order_r, cuda)
    assert rw_ops.spectral_gram_cuda(none, none, empty, 0.1).shape == (0, 0)
    assert rw_ops.spectral_gram_cuda.launches == before


@pytest.mark.parametrize("params,data", [
    ({"k": 5, "sampling": {"n_samples": 150}, "random_state": 42}, "nci"),
    ({"k": 5}, "mutag"), ({"k": 7, "sampling": {"n_samples": 60},
                           "random_state": 1, "normalize": True}, "nci")])
def test_graphlet_sampling_on_card_matches_cpu(cuda, params, data):
    """GraphletSampling with K7 on the card (one launch a graphlet size
    and call) equals its CPU run bit for bit."""
    if data == "nci":
        train, test = generate_dataset(
            n_graphs=120, n_graphs_test=10, r_vertices=(10, 50),
            r_connectivity=(0.07, 0.15), random_state=1234,
            features=("nl", 37))
    else:
        from grakel_torch.datasets import read_data
        import os
        d = read_data("MUTAG", path=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "data")).data
        train, test = d[:40], d[40:50]
    before = canonical.canonical_codes_cuda.launches
    got = _run_kernel(grakel_torch.GraphletSampling(**params), train, test)
    assert canonical.canonical_codes_cuda.launches > before
    with use_device("cpu"):
        ref = _run_kernel(grakel_torch.GraphletSampling(**params), train,
                          test)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("name,params,kind", [
    ("RandomWalk", {}, "nci"), ("RandomWalk", {"lamda": 0.01}, "directed"),
    ("RandomWalkLabeled", {}, "mutag"),
    ("RandomWalk", {"p": 3}, "mutag"),
    ("RandomWalkLabeled", {"method_type": "baseline", "lamda": 0.01},
     "mutag_small")])
def test_random_walk_on_card_matches_cpu(cuda, name, params, kind):
    """RandomWalk's routes on the card against its CPU run: the spectral
    tile route (K9, one launch a Gram) to rtol 1e-10 (f64 sums in another
    order), the CG routes (K8; MUTAG's labeled pairs all on the warp
    route) and the library routes (f32) to rtol 1e-4."""
    import os
    from grakel_torch.datasets import read_data
    if kind in ("nci", "directed"):
        train, test = generate_dataset(
            n_graphs=300, n_graphs_test=20, r_vertices=(10, 50),
            r_connectivity=(0.07, 0.15), random_state=1234,
            features=("nl", 37))
        if kind == "directed":   # each edge kept in one direction
            rng = np.random.RandomState(0)
            one_way = []
            for g in train[:60]:
                U = np.triu(normalize_input([g])[0].get_adjacency_matrix(),
                            1)
                flip = rng.rand(*U.shape) < 0.5
                one_way.append([np.where(flip, U, 0)
                                + np.where(flip, 0, U).T,
                                {i: 0 for i in range(U.shape[0])}])
            train, test = one_way[:50], one_way[50:]
    else:
        d = read_data("MUTAG", path=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "data")).data
        train, test = (d[:60], d[60:80]) if kind == "mutag" else \
            (d[:6], d[6:9])
    counters = (rw_ops.pair_cg_cuda, rw_ops.spectral_gram_cuda)
    before = [c.launches for c in counters]
    warp = rw_ops.pair_cg_cuda.route_launches["warp"]
    got = _run_kernel(getattr(grakel_torch, name)(**params), train, test)
    launched = [c.launches - b for c, b in zip(counters, before)]
    warp = rw_ops.pair_cg_cuda.route_launches["warp"] - warp
    with use_device("cpu"):
        ref = _run_kernel(getattr(grakel_torch, name)(**params), train,
                          test)
    if kind == "nci":
        # one K9 launch a Gram: fit, transform, the transform's diagonal
        assert launched[1] == 3 and launched[0] == 0
        rtol = 1e-10
    else:
        assert launched[1] == 0
        assert (launched[0] > 0) == ("p" not in params
                                     and "method_type" not in params)
        if kind == "mutag" and launched[0]:
            assert warp == launched[0]    # MUTAG: buckets 16 and 32
        rtol = 1e-4
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)


# --------------------------------------------------------------------- #
# K10-K13: SvmTheta's one-class solve, LovaszTheta's DR step and cones
# --------------------------------------------------------------------- #

def _svm_slab(S, V, p, seed, cuda):
    """A slab as ``ops.svm_qp.one_class_alphas`` builds it: symmetric 0/1
    K [S, V, V] on graphs of 2..V vertices, the box u, s = n / 2 and the
    libsvm start a0."""
    rng = np.random.RandomState(seed)
    K = np.zeros((S, V, V), np.float32)
    u = np.zeros((S, V), np.float32)
    for g in range(S):
        n = rng.randint(2, V + 1)
        A = np.triu(rng.rand(n, n) < p, 1)
        K[g, :n, :n] = A | A.T
        u[g, :n] = 1.0
    s = 0.5 * u.sum(1)
    a0 = np.clip(s[:, None] - np.arange(V)[None, :], 0, 1).astype(
        np.float32) * u
    return [torch.from_numpy(x).to(cuda) for x in (K, u, s, a0)]


def _svm_bucket(S, V, p, seed, cuda):
    """A bucket of S graphs at padded size V as ``one_class_alphas`` builds
    it (:func:`_svm_slab`), graph 0 of one vertex and graph 1 with no
    edge, with its bit rows and start vectors: (Kb, K, u, s, a0, v0)."""
    from grakel_torch.ops import svm_qp
    K, u, s, a0 = _svm_slab(S, V, p, seed, cuda)
    K[:2] = 0
    u[0, 1:] = 0
    s[0] = 0.5
    a0[0] = 0
    a0[0, 0] = 0.5
    return (_bits(K, cuda), K, u, s, a0, svm_qp.bucket_start_vector(u))


# buckets past 256 graphs span slabs (each start vector seeded by its slab
# position); "block" past V = 64, and forced at V = 32 and 64
_SOLVE_GRID = [
    (37, 8, 0.5, None), (64, 32, 0.2, None), (20, 128, 0.1, None),
    (5, 256, 0.05, None), (16, 32, 0.3, "block"), (9, 64, 0.6, "block"),
    (50, 16, 0.3, None), (40, 64, 0.1, None), (300, 16, 0.25, None),
    (600, 64, 0.06, None), (300, 32, 0.15, "block")]


@pytest.mark.parametrize("S,V,p,route", _SOLVE_GRID)
def test_svm_lanczos_kernel_matches_plain(cuda, S, V, p, route):
    """K10 alone (the fused launch with Lanczos on and iters = 0) on the
    bit rows against ``lanczos_bits_plain`` (``lanczos_plain`` on the
    dense K, a slab at a time):
    the first three alphas and the shift from the coefficients (what the
    solve reads) to 1e-4; without reorthogonalization the later
    coefficients of two summation orders drift apart, the spectrum's ends
    do not."""
    from grakel_torch.ops import svm_qp
    Kb, K, u, s, a0, v0 = _svm_bucket(S, V, p, S + V, cuda)
    want = route or svm_qp.solve_route(V)
    before = (dict(svm_qp.lanczos_cuda.route_launches),
              svm_qp.fista_cuda.launches, svm_qp.solve_cuda.launches)
    al, be = svm_qp.lanczos_cuda(Kb, v0, route=route)
    assert svm_qp.lanczos_cuda.route_launches[want] == before[0][want] + 1
    assert (svm_qp.fista_cuda.launches, svm_qp.solve_cuda.launches) \
        == before[1:]
    pal, pbe = svm_qp.lanczos_bits_plain(Kb, v0)
    assert torch.isfinite(al).all() and torch.isfinite(be).all()
    torch.testing.assert_close(al[:, :3], pal[:, :3], rtol=1e-4, atol=1e-4)
    for got, ref in zip(svm_qp.spectral_shift(al, be),
                        svm_qp.spectral_shift(pal, pbe)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert (al[:2] == 0).all() and (be[:2] == 0).all()   # K = 0


@pytest.mark.parametrize("S,V,p,route", _SOLVE_GRID)
def test_svm_solve_kernel_matches_plain(cuda, S, V, p, route):
    """K10 and K11 in one launch against the plain composition
    (``one_class_solve_plain``: ``lanczos_plain`` a slab at a time, then
    ``spectral_shift`` + ``fista_plain``), K11's checks at their
    thresholds: the first three alphas and the shift to 1e-4, the
    tridiagonal's extremes within 1e-6 of the largest |eigenvalue| of f64
    ``eigvalsh``'s on the kernel's own coefficients, feasibility, K a and
    the objective (unique at the optimum of a convex QP) to 1e-4, and the
    alphas to 1e-3 of ``fista_plain`` on the kernel's own shift.  The one
    launch equals K10 alone and then K11 alone bit for bit."""
    from grakel_torch.ops import svm_qp
    Kb, K, u, s, a0, v0 = _svm_bucket(S, V, p, 3 * S + V, cuda)
    want = route or svm_qp.solve_route(V)
    before = {k: dict(c.route_launches) for k, c in (
        ("solve", svm_qp.solve_cuda), ("lanczos", svm_qp.lanczos_cuda),
        ("fista", svm_qp.fista_cuda))}
    a, lam, al, be = svm_qp.solve_cuda(Kb, v0, a0, u, s, route=route)
    for k, c in (("solve", svm_qp.solve_cuda),
                 ("lanczos", svm_qp.lanczos_cuda),
                 ("fista", svm_qp.fista_cuda)):
        assert c.route_launches[want] == before[k][want] + 1, k
    # the one launch is K10 alone, then K11 alone on its coefficients
    al1, be1 = svm_qp.lanczos_cuda(Kb, v0, route=route)
    a1, lam1 = svm_qp.fista_cuda(Kb, a0, u, s, al1, be1, route=route)
    for x, y in ((al, al1), (be, be1), (a, a1), (lam, lam1)):
        assert torch.equal(x, y)
    ref, pal, pbe = svm_qp.one_class_solve_plain(Kb, v0, a0, u, s)
    torch.testing.assert_close(al[:, :3], pal[:, :3], rtol=1e-4, atol=1e-4)
    scale, dadd, L = svm_qp.spectral_shift(pal, pbe)
    for got, f in zip(svm_qp.spectral_shift(al, be), (scale, dadd, L)):
        torch.testing.assert_close(got, f, rtol=1e-4, atol=1e-4)
    dmin, dmax = (x.to(cuda).float() for x in svm_qp.tridiagonal_extremes(
        al.double().cpu(), be.double().cpu()))
    big = float(torch.maximum(dmin.abs(), dmax.abs()).max().clamp_min(1))
    torch.testing.assert_close(lam[:, 0], dmin, rtol=0, atol=1e-6 * big)
    torch.testing.assert_close(lam[:, 1], dmax, rtol=0, atol=1e-6 * big)
    assert (a >= -1e-6).all() and (a <= u + 1e-6).all()
    torch.testing.assert_close(a.sum(1), s, rtol=1e-5, atol=1e-4)

    def kx(x):
        return scale[:, None] * torch.bmm(K, x[:, :, None])[:, :, 0] \
            + dadd[:, None] * x
    torch.testing.assert_close(kx(a), kx(ref), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close((a * kx(a)).sum(1), (ref * kx(ref)).sum(1),
                               rtol=1e-4, atol=1e-4)
    same_shift = svm_qp.fista_plain(
        K, a0, u, s, *svm_qp.shift_from_extremes(lam[:, 0], lam[:, 1]))
    torch.testing.assert_close(a, same_shift, rtol=1e-3, atol=1e-3)


def _bits(K, cuda):
    """The bit rows of a dense 0/1 K [S, V, V]."""
    from grakel_torch.ops import svm_qp
    S, V, _ = K.shape
    flat = torch.nonzero(K.flatten().cpu()).flatten().numpy()
    return svm_qp.adjacency_bits(flat, S, V, cuda)


@pytest.mark.parametrize("S,V,p,route", _SOLVE_GRID)
def test_svm_fista_kernel_matches_plain(cuda, S, V, p, route):
    """K11 alone (the launch with Lanczos off, reading the coefficients),
    the spectral shift inside, against its plain version
    (``spectral_shift`` + ``fista_plain``) on the same bucket: the
    constraints hold, the objective and K a (unique at the optimum of a
    convex QP) agree to 1e-4.  The tridiagonal's extremes are the f64
    Sturm bisection's, rounded to f32: within 1e-6 of the largest
    |eigenvalue| of f64 ``eigvalsh``'s and within 1e-4 of the plain
    version's f32 ``eigvalsh`` (cuSOLVER's batched Jacobi, off by up to
    ~2e-5 of it on the card).  The alphas agree to 1e-3 with
    ``fista_plain`` on the kernel's own shift (the shifted K is singular,
    so the minimizer may be a set, along which rounding drifts; a shift
    differing in its last bits moves the drift)."""
    from grakel_torch.ops import svm_qp
    K, u, s, a0 = _svm_slab(S, V, p, 3 * S + V, cuda)
    al, be = svm_qp.lanczos_plain(K, svm_qp.start_vector(u))
    before = dict(svm_qp.fista_cuda.route_launches)
    a, lam = svm_qp.fista_cuda(_bits(K, cuda), a0, u, s, al, be,
                               route=route)
    want = route or svm_qp.solve_route(V)
    assert want == ("warp" if V <= 64 else "block") or route
    assert svm_qp.fista_cuda.route_launches[want] == before[want] + 1
    lmin, lmax = svm_qp.tridiagonal_extremes(al, be)
    dmin, dmax = (x.to(cuda).float() for x in svm_qp.tridiagonal_extremes(
        al.double().cpu(), be.double().cpu()))
    big = float(torch.maximum(dmin.abs(), dmax.abs()).max().clamp_min(1))
    for got, f64, f32 in ((lam[:, 0], dmin, lmin), (lam[:, 1], dmax, lmax)):
        torch.testing.assert_close(got, f64, rtol=0, atol=1e-6 * big)
        torch.testing.assert_close(got, f32, rtol=0, atol=1e-4 * big)
    scale, dadd, L = svm_qp.spectral_shift(al, be)
    ref = svm_qp.fista_plain(K, a0, u, s, scale, dadd, L)
    assert (a >= -1e-6).all() and (a <= u + 1e-6).all()
    torch.testing.assert_close(a.sum(1), s, rtol=1e-5, atol=1e-4)

    def kx(x):
        return scale[:, None] * torch.bmm(K, x[:, :, None])[:, :, 0] \
            + dadd[:, None] * x
    torch.testing.assert_close(kx(a), kx(ref), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close((a * kx(a)).sum(1), (ref * kx(ref)).sum(1),
                               rtol=1e-4, atol=1e-4)
    same_shift = svm_qp.fista_plain(
        K, a0, u, s, *svm_qp.shift_from_extremes(lam[:, 0], lam[:, 1]))
    torch.testing.assert_close(a, same_shift, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ulps", [-3, -1, 0, 1, 3])
def test_svm_fista_shift_at_eig_tol_edge(cuda, ulps):
    """lambda_min within a few ulps of -1e-6, where the shift's condition
    flips: on diagonal tridiagonals (the eigenvalues are the f32 entries)
    K11's extremes equal them exactly and its shift equals the plain
    version's; the alphas solve the same QP as the plain FISTA (K a and
    the objective to 1e-4)."""
    from grakel_torch.ops import svm_qp
    K, u, s, a0 = _svm_slab(6, 16, 0.3, 11, cuda)
    edge = np.float32(-svm_qp._EIG_TOL)
    x = edge
    for _ in range(abs(ulps)):
        x = np.nextafter(x, np.float32(np.sign(ulps)), dtype=np.float32)
    al = np.zeros((6, 64), np.float32)
    al[:, 0] = x
    al[:, 1] = np.linspace(0.5, 3.0, 6)
    al = torch.from_numpy(al).to(cuda)
    be = torch.zeros_like(al)
    a, lam = svm_qp.fista_cuda(_bits(K, cuda), a0, u, s, al, be)
    assert (lam[:, 0] == float(x)).all() and (lam[:, 1] == al[:, 1]).all()
    want = svm_qp.spectral_shift(al, be)
    for got, ref in zip(svm_qp.shift_from_extremes(lam[:, 0], lam[:, 1]),
                        want):
        assert torch.equal(got, ref)
    scale, dadd, L = want
    ref = svm_qp.fista_plain(K, a0, u, s, scale, dadd, L)

    def kx(x):
        return scale[:, None] * torch.bmm(K, x[:, :, None])[:, :, 0] \
            + dadd[:, None] * x
    torch.testing.assert_close(kx(a), kx(ref), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close((a * kx(a)).sum(1), (ref * kx(ref)).sum(1),
                               rtol=1e-4, atol=1e-4)


def test_svm_wrappers_check_inputs(cuda):
    """The three wrappers of the one launch refuse what it cannot take (a
    CPU tensor, a dense K, wrong dtypes, shapes or m, route "warp" past V
    = 64, an unknown route) before launching; a CUDA tensor never takes
    the plain version; ``one_class_solve`` on CUDA tensors is the one
    launch."""
    from grakel_torch.ops import svm_qp
    Kb, K, u, s, a0, v0 = _svm_bucket(4, 16, 0.3, 0, cuda)
    counters = (svm_qp.solve_cuda, svm_qp.lanczos_cuda, svm_qp.fista_cuda)
    before = [c.launches for c in counters]
    al, be = svm_qp.lanczos_plain(K, v0)
    bad = [
        lambda: svm_qp.lanczos_cuda(Kb.cpu(), v0.cpu()),
        lambda: svm_qp.lanczos_cuda(K, v0),                 # dense K
        lambda: svm_qp.lanczos_cuda(Kb, v0.double()),
        lambda: svm_qp.lanczos_cuda(Kb, v0[:3]),
        lambda: svm_qp.lanczos_cuda(Kb, v0, route="shared"),
        lambda: svm_qp.solve_cuda(Kb, v0, a0, u, s[:3]),
        lambda: svm_qp.solve_cuda(Kb, v0, a0.cpu(), u, s),
        lambda: svm_qp.solve_cuda(Kb.long(), v0, a0, u, s),
        lambda: svm_qp.solve_cuda(Kb[:, :8], v0, a0, u, s),  # V not 16
        lambda: svm_qp.solve_cuda(Kb, v0, a0, u, s, m=0),
        lambda: svm_qp.solve_cuda(Kb, v0, a0, u, s, route="global"),
        lambda: svm_qp.fista_cuda(Kb, a0, u, s[:3], al, be),
        lambda: svm_qp.fista_cuda(K, a0, u, s, al, be),     # dense K
        lambda: svm_qp.fista_cuda(Kb, a0, u, s, al,
                                  be[:, :32].contiguous()),  # other m
        lambda: svm_qp.fista_cuda(Kb, a0, u, s, al[:3], be[:3]),
        lambda: svm_qp.fista_cuda(Kb, a0, u, s, al, be, route="shared"),
    ]
    Kb2, K2, u2, s2, a02, v02 = _svm_bucket(2, 128, 0.1, 0, cuda)
    al2, be2 = svm_qp.lanczos_plain(K2, v02)
    bad += [                                            # warp only to 64
        lambda: svm_qp.lanczos_cuda(Kb2, v02, route="warp"),
        lambda: svm_qp.solve_cuda(Kb2, v02, a02, u2, s2, route="warp"),
        lambda: svm_qp.fista_cuda(Kb2, a02, u2, s2, al2, be2, route="warp"),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert [c.launches for c in counters] == before
    svm_qp.one_class_solve(Kb, v0, a0, u, s)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]


def test_one_class_alphas_one_k11_launch_a_bucket(cuda, monkeypatch):
    """A bucket of several slabs (600 graphs at V = 16: three slabs, each
    start vector seeded by its slab position) takes one launch of K10
    and K11 together, as does the V = 64 bucket: two launches, each
    counted once on the fused wrapper, on K10 and on K11.  No dense K is
    built on the card (no f32 ``torch.zeros`` in ``ops.svm_qp``, no
    ``dense_from_bits``, no plain Lanczos; the int32 ``index_add_`` of
    the bit rows stays), and the card's alphas solve the CPU run's QPs
    (K a and the objective to 1e-4)."""
    from grakel_torch.ops import svm_qp
    rng = np.random.RandomState(7)
    adjm = []
    for n in list(rng.randint(9, 17, 600)) + list(rng.randint(33, 65, 40)):
        A = np.triu(rng.rand(n, n) < 0.2, 1).astype(float)
        adjm.append(A + A.T)
    zeros, plain = [], []

    class _Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        def zeros(self, *a, **kw):
            zeros.append((kw.get("dtype"), str(kw.get("device"))))
            return torch.zeros(*a, **kw)
    monkeypatch.setattr(svm_qp, "torch", _Torch())
    for name in ("dense_from_bits", "lanczos_plain", "fista_plain"):
        real = getattr(svm_qp, name)
        monkeypatch.setattr(svm_qp, name, lambda *a, _n=name, _r=real, **k:
                            plain.append(_n) or _r(*a, **k))
    counters = (svm_qp.solve_cuda, svm_qp.lanczos_cuda, svm_qp.fista_cuda)
    before = [c.launches for c in counters]
    got = svm_qp.one_class_alphas(adjm, device=cuda)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    assert plain == [] and zeros and all(
        d == torch.int32 for d, _ in zeros), (plain, zeros)
    monkeypatch.undo()
    ref = svm_qp.one_class_alphas(adjm, device="cpu")
    for A, a, r in zip(adjm, got, ref):
        K = (A > 1e-10).astype(float)
        me = np.linalg.eigvalsh(K)[0]
        if me < -1e-6:
            K = K / (-me) + np.eye(len(K))
        np.testing.assert_allclose(K @ a, K @ r, rtol=1e-4, atol=1e-4)
        assert abs(a @ K @ a - r @ K @ r) < 1e-4


def _dr_inputs(B, V, seed, cuda, n_max=None):
    """A DR state: edges E and sizes n (1 .. ``n_max``, default V) as
    ``lovasz_theta_batch`` pads them, random symmetric Y, X and the eigh
    of 2X - Y."""
    rng = np.random.RandomState(seed)
    n = rng.randint(1, (n_max or V) + 1, B)
    E = np.zeros((B, V, V), np.float32)
    for b in range(B):
        A = np.triu(rng.rand(n[b], n[b]) < 0.4, 1)
        E[b, :n[b], :n[b]] = A | A.T
    Y = rng.randn(B, V, V).astype(np.float32)
    X = rng.randn(B, V, V).astype(np.float32)
    Y, X = Y + Y.transpose(0, 2, 1), X + X.transpose(0, 2, 1)
    E, Y, X = (torch.from_numpy(x).to(cuda) for x in (E, Y, X))
    n = torch.from_numpy(n.astype(np.int32)).to(cuda)
    w, U = torch.linalg.eigh(2 * X - Y)
    return E, n, Y, X, w, U


@pytest.mark.parametrize("B,V,route", [
    (3, 4, None), (50, 16, None), (17, 64, None), (6, 128, None),
    (2, 256, None), (11, 16, "global"), (5, 128, "global"),
    (33, 4, None), (9, 8, None), (41, 32, None), (3, 4, "global"),
    (7, 32, "global"), (13, 64, "global"), (3, 100, None)])
def test_lovasz_dr_step_kernel_matches_plain(cuda, B, V, route):
    """K12 (in place) against the plain DR step on the same eigh: Y, X and
    R to 1e-4 (f32 length-V dot products in another order), on every
    tile size of route "tile" (blocks of several graphs, B not a
    multiple of them) and on route "global" (V = 100 and 256 take it)."""
    from grakel_torch.ops import lovasz_sdp
    E, n, Y, X, w, U = _dr_inputs(B, V, B + V, cuda)
    pY, pX, pR = lovasz_sdp.dr_step_plain(E, n, Y, X, w, U)
    Yk, Xk = Y.clone(), X.clone()
    before = dict(lovasz_sdp.dr_step_cuda.route_launches)
    R = lovasz_sdp.dr_step_cuda(lovasz_sdp.edge_bits(E), n, Yk, Xk, w, U,
                                route=route)
    want = route or lovasz_sdp.k12_route(V)
    assert lovasz_sdp.dr_step_cuda.route_launches[want] == before[want] + 1
    for got, ref in ((Yk, pY), (Xk, pX), (R, pR)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("V", [4, 16, 32, 64, 128])
@pytest.mark.parametrize("route", ["tile", "global"])
def test_lovasz_dr_step_kernel_padded_bucket(cuda, V, route):
    """K12 on a bucket whose graphs fill at most a quarter of its rows (a
    bucket past the sizes it was cut for): the padded rows and columns
    of X' are zero and R' = -Y' there, and Y', X', R' equal the plain
    step to 1e-4."""
    from grakel_torch.ops import lovasz_sdp
    E, n, Y, X, w, U = _dr_inputs(37, V, V + 7, cuda, n_max=max(1, V // 4))
    pY, pX, pR = lovasz_sdp.dr_step_plain(E, n, Y, X, w, U)
    Yk, Xk = Y.clone(), X.clone()
    R = lovasz_sdp.dr_step_cuda(lovasz_sdp.edge_bits(E), n, Yk, Xk, w, U,
                                route=route)
    for got, ref in ((Yk, pY), (Xk, pX), (R, pR)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    pad = torch.arange(V, device=cuda)[None, :] >= n[:, None]
    outside = pad[:, :, None] | pad[:, None, :]
    assert (Xk[outside] == 0).all()
    assert torch.equal(R[outside], -Yk[outside])


@pytest.mark.parametrize("S,d,m,route", [
    (1, 3, 2, None), (1000, 15, 8, None), (333, 113, 8, None),
    (70, 40, 5, None), (9, 1000, 8, None), (100, 33, 8, "global"),
    (5, 20, 32, None), (101, 51, 8, "shared"), (77, 51, 8, None),
    (66, 129, 8, None), (10, 500, 1, None)])
def test_lovasz_min_cone_kernel_matches_plain(cuda, S, d, m, route):
    """K13 against the plain cone loop on subsets shaped as LovaszTheta
    builds them (unit columns, the first repeated as padding): the far
    columns are the same choices (the distances are summed in the same
    order with one rounding a term), so t agrees to 1e-5 (the final
    norm and dot products in another order)."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(S + d)
    A = rng.randn(S, d, m).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    A[:, :, m // 2:] = A[:, :, :1]
    A = torch.from_numpy(A).to(cuda)
    before = dict(lovasz_sdp.min_cone_cuda.route_launches)
    t = lovasz_sdp.min_cone_cuda(A, route=route)
    want = route or lovasz_sdp.k13_route(d, m)
    assert lovasz_sdp.min_cone_cuda.route_launches[want] == before[want] + 1
    torch.testing.assert_close(t, lovasz_sdp.min_cone_plain(A), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("d,route", [(51, None), (128, None), (129, None),
                                     (20, "shared"), (20, "global"),
                                     (300, "global")])
def test_lovasz_min_cone_kernel_group_widths(cuda, m, d, route):
    """K13 on every group width (a subset on the next power of two at or
    above m lanes, 32 / that many a warp), 37 subsets (no multiple of a
    block's), d on both sides of the register route's limit (128) and
    every route: t against the plain cone loop to 1e-5, on subsets with
    exact ties (two distinct unit columns, the first repeated, as a
    2-subset of LovaszTheta; and a column and its mirror image about
    the first) and on subsets in general position, so the far columns
    are the same choices, each decided by the last bit of an in-order
    sum.  The plain loop runs on the CPU, in the same IEEE operations."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(m * 1000 + d)
    S = 37
    A = rng.randn(S, d, m).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    A[: S // 3, :, 2:] = A[: S // 3, :, :1]
    if m >= 3:
        A[S // 3: 2 * S // 3, :, 2] = -A[S // 3: 2 * S // 3, :, 1]
    plan = lovasz_sdp.k13_plan(d, m, route)
    assert plan[1] >= m and plan[1] & (plan[1] - 1) == 0
    before = dict(lovasz_sdp.min_cone_cuda.route_launches)
    t = lovasz_sdp.min_cone_cuda(torch.from_numpy(A).to(cuda), route=route)
    assert lovasz_sdp.min_cone_cuda.route_launches[plan[0]] \
        == before[plan[0]] + 1
    torch.testing.assert_close(
        t.cpu(), lovasz_sdp.min_cone_plain(torch.from_numpy(A)), rtol=1e-5,
        atol=1e-5)


def test_lovasz_min_cone_quotient_is_ieee_division(cuda):
    """K13 divides the centre's step by k + 2 as the product with the f32
    reciprocal of k + 2 and two fused corrections (subnormal quotients in
    f64, ties to even): bit for bit __fdiv_rn's quotient for every f32 x
    in [-2, 2] (the entries' differences of unit vectors) and every
    divisor 2 .. MEC_ITERS + 1."""
    from grakel_torch.ops import lovasz_sdp
    bad, seen, first = lovasz_sdp.min_cone_quotient_check(cuda)
    assert seen == 2 * (2 ** 30 + 1) * lovasz_sdp.MEC_ITERS
    assert bad == 0, first


def _eigh_close(M, w, U, cuda):
    """K14's (w, U) against torch.linalg.eigh on M: sorted eigenvalues and
    PSD projections to 1e-4 of the largest |eigenvalue|, U orthogonal to
    1e-4."""
    B, V = M.shape[0], M.shape[-1]
    lw, lU = torch.linalg.eigh(M)
    scale = float(lw.abs().max())
    torch.testing.assert_close(w.sort(-1).values, lw, rtol=0,
                               atol=1e-4 * scale)

    def psd(w, U):
        return (U * w.clamp_min(0)[:, None, :]) @ U.transpose(-1, -2)
    torch.testing.assert_close(psd(w, U), psd(lw, lU), rtol=0,
                               atol=1e-4 * scale)
    torch.testing.assert_close(U.transpose(-1, -2) @ U,
                               torch.eye(V, device=cuda).expand(B, V, V),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("B,V,kind", [
    (5, 2, "random"), (40, 4, "random"), (64, 16, "padded"),
    (100, 32, "random"), (30, 64, "psd_low_rank"), (12, 128, "padded"),
    (8, 64, "repeated")])
def test_lovasz_jacobi_eigh_kernel_matches_eigh(cuda, B, V, kind):
    """K14 against torch.linalg.eigh (its plain version): the sorted
    eigenvalues, the PSD projection U diag(max(w, 0)) U^T (unique even
    where eigenvalues repeat) and U's orthogonality, to 1e-4 of the
    largest |eigenvalue|; only the lower triangle is read."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(B + V)
    M = rng.randn(B, V, V).astype(np.float32)
    if kind == "psd_low_rank":       # a DR iterate near convergence
        M = M[:, :, :3] @ M[:, :, :3].transpose(0, 2, 1)
    elif kind == "repeated":
        Q = np.linalg.qr(M.astype(np.float64))[0]
        w = np.repeat(rng.randn(B, V // 8), 8, axis=1)
        M = ((Q * w[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32)
    else:
        M = M + M.transpose(0, 2, 1)
        if kind == "padded":
            M[:, V // 2:, :] = 0
            M[:, :, V // 2:] = 0
    M = torch.from_numpy(np.ascontiguousarray(M)).to(cuda)
    upper_garbage = M.clone()
    iu = torch.triu_indices(V, V, 1)
    upper_garbage[:, iu[0], iu[1]] = 7.0
    before = lovasz_sdp.jacobi_eigh_cuda.launches
    w, U = lovasz_sdp.jacobi_eigh_cuda(upper_garbage)
    assert lovasz_sdp.jacobi_eigh_cuda.launches == before + 1
    _eigh_close(M, w, U, cuda)
    # sym_eigh routes CUDA tensors of up to 128 rows to K14
    lovasz_sdp.sym_eigh(M)
    assert lovasz_sdp.jacobi_eigh_cuda.launches == before + 2


@pytest.mark.parametrize("B,V", [(40, 4), (33, 8), (64, 16), (50, 32),
                                 (30, 64), (12, 128)])
def test_lovasz_jacobi_eigh_warm_random_basis(cuda, B, V):
    """K14 started from a random orthogonal basis (its rows the U0 it
    takes) on random symmetric matrices with half their rows zero padded:
    still M's eigendecomposition (the sweeps run on U0^T M U0 and rotate
    U0)."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(B * V)
    M = rng.randn(B, V, V).astype(np.float32)
    M = M + M.transpose(0, 2, 1)
    M[:, V // 2:, :] = 0
    M[:, :, V // 2:] = 0
    Q = np.linalg.qr(rng.randn(B, V, V))[0].astype(np.float32)
    M = torch.from_numpy(M).to(cuda)
    U0 = torch.from_numpy(Q).to(cuda).transpose(-1, -2).contiguous() \
        .transpose(-1, -2)          # column-major, as K14 returns U
    sweeps = torch.zeros(B, dtype=torch.int32, device=cuda)
    before = lovasz_sdp.jacobi_eigh_cuda.launches
    w, U = lovasz_sdp.jacobi_eigh_cuda(M, U0, sweeps=sweeps)
    assert lovasz_sdp.jacobi_eigh_cuda.launches == before + 1
    assert (sweeps >= 1).all() and (sweeps <= lovasz_sdp.JACOBI_SWEEPS).all()
    _eigh_close(M, w, U, cuda)


@pytest.mark.parametrize("V", [16, 32, 64])
def test_lovasz_jacobi_eigh_warm_dr_state(cuda, V):
    """K14 on a DR reflection at step 150 started from step 149's
    eigenvectors, as the DR loop runs it on a card: eigh's
    eigendecomposition to 1e-4, each matrix in no more sweeps than from
    the identity; the padded rows stay exactly diagonal."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(V)
    B = 40
    ns = rng.randint(V // 2 + 1, V + 1, B)
    E = np.zeros((B, V, V), np.float32)
    for b in range(B):
        A = np.triu(rng.rand(ns[b], ns[b]) < 0.3, 1)
        E[b, :ns[b], :ns[b]] = A | A.T
    E = torch.from_numpy(E).to(cuda)
    n = torch.from_numpy(ns.astype(np.int32)).to(cuda)
    J, dvalid, keep, nvalid = lovasz_sdp._masks(E, n)
    Y = torch.zeros_like(E)
    X = lovasz_sdp.proj_affine(Y + J, dvalid, keep, nvalid)
    R, U = 2.0 * X - Y, None
    for k in range(149):
        w, U = lovasz_sdp.sym_eigh(
            R, U if k % lovasz_sdp.JACOBI_RESTART else None)
        Y, X, R = lovasz_sdp.dr_step(E, n, Y, X, w, U)
    warm = torch.zeros(B, dtype=torch.int32, device=cuda)
    cold = torch.zeros(B, dtype=torch.int32, device=cuda)
    w, Uw = lovasz_sdp.jacobi_eigh_cuda(R, U, sweeps=warm)
    _eigh_close(R, w, Uw, cuda)
    lovasz_sdp.jacobi_eigh_cuda(R, sweeps=cold)
    assert (warm <= cold).all(), (warm, cold)
    # valid eigenvectors have exactly zero padded entries, and the others
    # are the padded unit vectors with eigenvalue exactly 0
    pad = torch.arange(V, device=cuda)[None, :] >= n[:, None]
    Ut = Uw.transpose(-1, -2)           # eigenvector rows
    for b in range(B):
        p = pad[b]
        valid_rows = (Ut[b][:, p] == 0).all(1)
        assert int(valid_rows.sum()) == int((~p).sum())
        assert (w[b][~valid_rows] == 0).all()
        assert (Ut[b][~valid_rows][:, ~p] == 0).all()


@pytest.mark.parametrize("V,p", [(64, 0.05), (64, 0.3), (128, 0.03),
                                 (128, 0.3)])
def test_lovasz_jacobi_eigh_warm_dr_loop_stays_orthogonal(cuda, V, p,
                                                          monkeypatch):
    """The whole DR solve as ``_theta`` runs it on a card: its 301 K14
    calls start from the step before's eigenvectors but every
    JACOBI_RESTART-th step and theta's, which start from the identity;
    at the last DR step U is orthogonal to 1e-4 and still eigh's
    eigendecomposition of that step's reflection to 1e-4, also at the
    widest bucket K14 takes (sparse graphs drift the most)."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(V + int(100 * p))
    B = 48
    ns = rng.randint(V // 2 + 1, V + 1, B)
    E = np.zeros((B, V, V), np.float32)
    for b in range(B):
        A = np.triu(rng.rand(ns[b], ns[b]) < p, 1)
        E[b, :ns[b], :ns[b]] = A | A.T
    calls, real = [], lovasz_sdp.sym_eigh

    def spy(M, U0=None):
        w, U = real(M, U0)
        calls.append((M.clone(), U0 is None, w, U))
        return w, U
    monkeypatch.setattr(lovasz_sdp, "sym_eigh", spy)
    before = lovasz_sdp.jacobi_eigh_cuda.launches
    lovasz_sdp._theta(torch.from_numpy(E).to(cuda),
                      torch.from_numpy(ns.astype(np.int32)).to(cuda), 300,
                      1.0)
    assert lovasz_sdp.jacobi_eigh_cuda.launches == before + 301
    assert [k for k, c in enumerate(calls) if c[1]] == [
        k for k in range(300) if k % lovasz_sdp.JACOBI_RESTART == 0] + [300]
    M, _, w, U = calls[299]
    _eigh_close(M, w, U, cuda)


def test_lovasz_wrappers_check_inputs(cuda):
    from grakel_torch.ops import lovasz_sdp
    E, n, Y, X, w, U = _dr_inputs(2, 8, 0, cuda)
    Eb = lovasz_sdp.edge_bits(E)
    with pytest.raises(ValueError):
        lovasz_sdp.dr_step_cuda(Eb, n.long(), Y, X, w, U)
    with pytest.raises(ValueError):
        lovasz_sdp.dr_step_cuda(Eb.cpu(), n, Y, X, w, U)
    with pytest.raises(ValueError):                 # float edges, not bits
        lovasz_sdp.dr_step_cuda(E, n, Y, X, w, U)
    with pytest.raises(ValueError):
        lovasz_sdp.dr_step_cuda(Eb, n, Y, X, w, U, route="shared")
    Ym = torch.empty(2 * 64 + 1, device=cuda)[1:].view(2, 8, 8)
    Ym.copy_(Y)                                     # 4 bytes off 16
    with pytest.raises(ValueError):
        lovasz_sdp.dr_step_cuda(Eb, n, Ym, X, w, U)
    lovasz_sdp.dr_step_cuda(Eb, n, Ym, X.clone(), w, U, route="global")
    E3, n3, Y3, X3, w3, U3 = _dr_inputs(2, 12, 0, cuda)
    with pytest.raises(ValueError):                 # no tile at V = 12
        lovasz_sdp.dr_step_cuda(lovasz_sdp.edge_bits(E3), n3, Y3, X3, w3,
                                U3, route="tile")
    with pytest.raises(ValueError):
        lovasz_sdp.min_cone_cuda(torch.zeros(3, 129, 2, device=cuda),
                                 route="register")
    with pytest.raises(ValueError):
        lovasz_sdp.min_cone_cuda(torch.zeros(3, 4, 33, device=cuda))
    with pytest.raises(ValueError):
        lovasz_sdp.min_cone_cuda(torch.zeros(3, 4, 2, device=cuda).double())
    with pytest.raises(ValueError):
        lovasz_sdp.jacobi_eigh_cuda(torch.zeros(3, 5, 5, device=cuda))
    with pytest.raises(ValueError):
        lovasz_sdp.jacobi_eigh_cuda(torch.zeros(3, 256, 256, device=cuda))
    M = torch.zeros(3, 8, 8, device=cuda)
    w, U = lovasz_sdp.jacobi_eigh_cuda(M)
    with pytest.raises(ValueError):                 # the rows, not U
        lovasz_sdp.jacobi_eigh_cuda(M, U.contiguous() + 0.5)
    with pytest.raises(ValueError):
        lovasz_sdp.jacobi_eigh_cuda(M, U[:2])
    with pytest.raises(ValueError):
        lovasz_sdp.jacobi_eigh_cuda(M, U.double())
    with pytest.raises(ValueError):
        lovasz_sdp.jacobi_eigh_cuda(M, U, sweeps=torch.zeros(3, device=cuda))
    lovasz_sdp.jacobi_eigh_cuda(M, U)               # the layout it returns


def test_lovasz_theta_batch_on_card(cuda):
    """The card's SDP (301 K14 and 300 K12 launches) against its CPU run
    and the golden theta(C5) = sqrt(5)."""
    from grakel_torch.ops import lovasz_sdp
    rng = np.random.RandomState(5)
    B, V = 9, 16
    adjs = np.zeros((B, V, V), np.float32)
    ns = rng.randint(3, V + 1, B)
    for b in range(B):
        A = np.triu(rng.rand(ns[b], ns[b]) < 0.4, 1)
        adjs[b, :ns[b], :ns[b]] = A | A.T
    adjs[0] = 0
    for i in range(5):
        adjs[0, i, (i + 1) % 5] = adjs[0, (i + 1) % 5, i] = 1
    ns[0] = 5
    before = (lovasz_sdp.dr_step_cuda.launches,
              lovasz_sdp.jacobi_eigh_cuda.launches)
    t, S = lovasz_sdp.lovasz_theta_batch(adjs, ns, device=cuda)
    assert lovasz_sdp.dr_step_cuda.launches == before[0] + 300
    assert lovasz_sdp.jacobi_eigh_cuda.launches == before[1] + 301
    tc, Sc = lovasz_sdp.lovasz_theta_batch(adjs, ns, device="cpu")
    np.testing.assert_allclose(t, tc, atol=1e-4)
    np.testing.assert_allclose(S, Sc, atol=1e-4)
    assert abs(t[0] - np.sqrt(5)) < 1e-4


def _attributed(n_fit, n_tr):
    import os
    from grakel_torch.datasets import read_data
    d = read_data("Cuneiform", path=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data"),
        prefer_attr_nodes=True).data
    return d[:n_fit], d[n_fit:n_fit + n_tr]


@pytest.mark.parametrize("name,params,rtol", [
    ("SvmTheta", {"random_state": 3}, 2e-3),
    ("SvmTheta", {"random_state": 3, "normalize": True}, 2e-3),
    ("LovaszTheta", {"random_state": 3, "max_dim": 60}, 2e-2),
    ("GraphHopper", {}, 1e-10),
    ("GraphHopper", {"kernel_type": "gaussian", "normalize": True}, 0),
    ("MultiscaleLaplacian", {"random_state": 3}, 0)])
def test_theta_hopper_multiscale_on_card_match_cpu(cuda, name, params,
                                                   rtol):
    """The slice's classes on the card against their CPU runs.
    SvmTheta: the alphas come from K10 and K11 in f32, so its sampled
    features agree to the solver's 2e-3 (the JAX package's bound against
    libsvm).  LovaszTheta: the card's eigh differs from LAPACK's in the
    last bits and the cone iteration resolves exact ties by them, so a
    subset's cosine may move by ~1e-3: 2e-2.  GraphHopper: the linear
    Gram is one f64 GEMM on the card (1e-10), the gaussian one the host
    pair loop (equal); MultiscaleLaplacian runs on the host (equal)."""
    from grakel_torch.ops import lovasz_sdp, svm_qp
    if name in ("GraphHopper", "MultiscaleLaplacian"):
        train, test = _attributed(40, 10)
    else:
        train, test = generate_dataset(
            n_graphs=60, n_graphs_test=8, r_vertices=(10, 50),
            r_connectivity=(0.07, 0.15), random_state=1234,
            features=("nl", 37))
    counters = (svm_qp.lanczos_cuda, svm_qp.fista_cuda,
                lovasz_sdp.dr_step_cuda, lovasz_sdp.min_cone_cuda,
                svm_qp.solve_cuda)
    before = [c.launches for c in counters]
    got = _run_kernel(getattr(grakel_torch, name)(**params), train, test)
    launched = [c.launches - b for c, b in zip(counters, before)]
    if name == "SvmTheta":
        # K10 and K11 in one launch a size bucket, in fit and in transform
        nb = sum(len({svm_qp._pow2(g.get_adjacency_matrix().shape[0])
                      for g in normalize_input(part)})
                 for part in (train, test))
        assert launched == [nb, nb, 0, 0, nb]
    elif name == "LovaszTheta":
        assert launched[:2] == [0, 0] and launched[2] % 300 == 0 \
            and launched[2] > 0 and launched[3] == 2 and launched[4] == 0
    else:
        assert launched == [0, 0, 0, 0, 0]
    with use_device("cpu"):
        ref = _run_kernel(getattr(grakel_torch, name)(**params), train, test)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)


# --------------------------------------------------------------------- #
# K2's second reach and the multi-GPU layer on one card (a world of one)
# --------------------------------------------------------------------- #

def _random_csr(rng, n_labels_len, n_rows, max_deg):
    deg = rng.randint(0, max_deg + 1, n_rows)
    off = np.zeros(n_rows + 1, np.int32)
    np.cumsum(deg, out=off[1:])
    tgt = rng.randint(0, n_labels_len, int(off[-1])).astype(np.int32)
    return torch.from_numpy(off), torch.from_numpy(tgt)


@pytest.mark.parametrize("row0,n_rows", [(0, 6000), (1, 1499), (1500, 1500),
                                         (4500, 1500), (5999, 1), (17, 0)])
def test_wl_hash_rows_kernel_bit_identical(cuda, row0, n_rows):
    """K2 reach 2 against its plain version bit for bit, for row bases
    past 0, one launch a call; with row0 = 0 over every row it is reach
    1 (one launch of reach 1's own entry, the same keys)."""
    rng = np.random.RandomState(row0 + n_rows)
    N = 6000
    labels = torch.from_numpy(
        rng.randint(-2 ** 31, 2 ** 31 - 1, N).astype(np.int32))
    off, tgt = _random_csr(rng, N, n_rows, 40)
    want = wl.wl_hash_refine_csr_plain(labels, off, tgt, row0)
    before = wl.wl_hash_refine_rows_cuda.launches
    got = wl.wl_hash_refine_rows(labels.to(cuda), off.to(cuda),
                                 tgt.to(cuda), row0)
    torch.cuda.synchronize()
    assert wl.wl_hash_refine_rows_cuda.launches == before + 1
    assert got.shape == (n_rows,) and torch.equal(got.cpu(), want)
    if n_rows == N:
        r1 = wl.wl_hash_refine_cuda(labels.to(cuda), off.to(cuda),
                                    tgt.to(cuda))
        assert torch.equal(r1.cpu(), want)


def test_wl_hash_rows_wrapper_checks_inputs(cuda):
    labels = torch.zeros(10, dtype=torch.int32, device=cuda)
    off = torch.zeros(5, dtype=torch.int32, device=cuda)
    tgt = torch.zeros(0, dtype=torch.int32, device=cuda)
    for bad in ((labels, off, tgt, 7),             # rows past the labels
                (labels, off, tgt, -1),
                (labels.long(), off, tgt, 0),        # dtype
                (labels.cpu(), off, tgt, 0)):        # device
        with pytest.raises(ValueError):
            wl.wl_hash_refine_rows_cuda(*bad)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of one on NCCL (``make_mesh()`` with no group: a
    HashStore, no launcher), torn down after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from grakel_torch.parallel import make_mesh, mesh as mesh_mod
    mesh = make_mesh()
    assert (mesh.size, mesh.backend, mesh.device.type) == (1, "nccl", "cuda")
    yield mesh
    mesh_mod.shutdown()


def test_nccl_world_of_one_wl_paths_equal_wl(nccl_mesh):
    """distributed_wl_gram and LargeGraphWL (a 5000-vertex graph over a
    lowered threshold, on K2 reach 2) on a one-rank NCCL mesh equal
    WeisfeilerLehman on the card bit for bit."""
    from grakel_torch import WeisfeilerLehman
    from grakel_torch.parallel import LargeGraphWL, distributed_wl_gram
    from torch_parallel_cases import big_graph_arrays
    train, held = generate_dataset(n_graphs=330, n_graphs_test=30,
                                   r_vertices=(3, 30), random_state=3,
                                   features=("nl", 9))
    K0 = WeisfeilerLehman(n_iter=4).fit_transform(train)
    assert np.array_equal(distributed_wl_gram(train, 4, nccl_mesh), K0)
    s, r, lab = big_graph_arrays(5000, 4, 1, 9)
    graphs = [Graph.from_arrays(5000, s, r, node_labels=lab)] \
        + normalize_input(train)
    before = wl.wl_hash_refine_rows_cuda.launches
    fe = LargeGraphWL(n_iter=4, mesh=nccl_mesh, big_threshold=1000)
    K = fe.fit_transform(graphs)
    Kt = fe.transform(held)
    assert wl.wl_hash_refine_rows_cuda.launches - before == 8
    w = WeisfeilerLehman(n_iter=4)
    assert np.array_equal(K, w.fit_transform(graphs))
    assert np.array_equal(Kt, w.transform(held))


@pytest.mark.parametrize("name", ["vertex_histogram", "weisfeiler_lehman",
                                  "shortest_path"])
def test_graph_kernel_mesh_of_one_is_a_no_op(nccl_mesh, name):
    from grakel_torch import GraphKernel
    from grakel_torch.parallel import gram as pgram, mesh as pmesh
    train, held = generate_dataset(n_graphs=80, n_graphs_test=10,
                                   r_vertices=(3, 20), random_state=4,
                                   features=("nl", 5))
    k0, k1 = GraphKernel(kernel=name), GraphKernel(kernel=name,
                                                   mesh=nccl_mesh)
    calls = (pgram._ring.hops, pmesh.gather_blocks.calls)
    assert np.array_equal(k1.fit_transform(train), k0.fit_transform(train))
    assert np.array_equal(k1.transform(held), k0.transform(held))
    assert (pgram._ring.hops, pmesh.gather_blocks.calls) == calls


def test_launcher_ranks_across_cards(tmp_path):
    """The multi-GPU layer across cards: every case of the launcher in
    one rank a card (NCCL; ring hops over the cards' links), each result
    equal to the port's single-device result on the card (integer
    Grams exactly, float ones to rtol = atol = 1e-5) and each mesh case
    through the ring or the all-gathers.  Needs two or more cards."""
    import os
    import pickle
    import subprocess
    import sys
    import torch_parallel_cases as cases
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    tests = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(tests)
    out = str(tmp_path / "ranks.pkl")
    r = subprocess.run(
        [sys.executable, "-m", "grakel_torch.parallel.launch", "--ranks",
         str(n), "--device", "cuda", "--target",
         "torch_parallel_cases:run_case", "--cases",
         ",".join(cases.CASES + ("ring_inputs",)), "--out", out,
         "--timeout", "500"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join((root, tests))))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(out, "rb") as f:
        run = pickle.load(f)
    assert run["ranks"] == n and run["backend"] == "nccl"
    assert all(np.array_equal(a, cases.case_inputs("ring_inputs")[k])
               for k, a in run["results"]["ring_inputs"].items())
    for case in cases.CASES:
        coll = run["collectives"][case]
        assert coll["ring_hops"] + coll["all_gathers"] > 0, case
        got, pad = cases.strip_padding(case, run["results"][case])
        assert all(np.all(x == 0) for x in pad), case
        with use_device("cuda"):
            want = cases.run_case_single(case)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            if isinstance(a, list):          # histograms a generation
                assert a == b, case
            elif case in cases.EXACT_CASES:
                np.testing.assert_array_equal(a, b, err_msg=case)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=case)


# ---------------- K15 / K16: the C-SVC of cross_validate_Kfold_SVM ------ #

def _csvc_gram(n, seed, dup=0):
    """A seeded RBF Gram (full rank, well conditioned) with ``dup``
    duplicated rows, as f64 numpy."""
    rng = np.random.RandomState(seed)
    phi = rng.randn(n - dup, 4)
    if dup:
        phi = np.concatenate([phi, phi[rng.randint(0, n - dup, dup)]])
    sq = (phi ** 2).sum(1)
    return np.exp(-0.3 * (sq[:, None] + sq[None, :] - 2 * phi @ phi.T))


def _csvc_batch(n=120, seed=0, dup=6):
    """A plan mixing binary and multiclass fits of several sizes and Cs,
    a class of one sample among them, on one Gram."""
    from grakel_torch.ops import csvc
    K = _csvc_gram(n, seed, dup)
    rng = np.random.RandomState(seed + 1)
    fits, evals = [], []
    for size, k, C in ((40, 2, 1e-7), (60, 2, 1.0), (n - 10, 2, 1e3),
                       (50, 3, 0.1), (70, 5, 10.0), (30, 4, 1e5)):
        idx = rng.permutation(n)
        train, ev = idx[:size], idx[size:size + 10]
        y = rng.randint(0, k, size)
        y[:k] = np.arange(k)
        if k == 4:
            y[k:] = rng.randint(0, k - 1, size - k)   # class 3: one sample
        fits.append((0, train, y, C))
        evals.append(ev)
    return K, csvc.plan_fits(fits, evals)


def _csvc_inputs(K, plan, dev):
    import torch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    K64 = t(K)
    return (K64.float(), torch.diagonal(K64).contiguous(), t(plan.ids),
            t(plan.sign), t(plan.off), t(plan.C), t(plan.gram)), K64


def _csvc_route_launches(csvc, before, lens, warp_rows, block_rows):
    routes = set(csvc.k15_routes(lens, warp_rows, block_rows).tolist())
    for r, name in enumerate(csvc.ROUTES):
        assert csvc.smo_cuda.route_launches[name] == before[name] + (
            r in routes), name


@pytest.mark.parametrize("warp_rows,block_rows", [
    (None, None), (0, None), (0, 0), (192, None), (20, 55), (36, 36)])
def test_csvc_smo_kernel_bit_identical(cuda, warp_rows, block_rows):
    """Every route, alone and mixed, on binary and multiclass fits (a
    class of one sample, a C = 1e3 pair of 5,000-odd iterations through
    shrinking, the unshrink and the reconstruction), one launch a route,
    bit for bit."""
    from grakel_torch.ops import csvc
    K, plan = _csvc_batch()
    args, _ = _csvc_inputs(K, plan, cuda)
    before = dict(csvc.smo_cuda.route_launches)
    l0 = csvc.smo_cuda.launches
    got = csvc.smo_cuda(*args, warp_rows=warp_rows, block_rows=block_rows)
    torch.cuda.synchronize()
    want = csvc.smo_plain(*(a.cpu() for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    lens = np.diff(plan.off)
    _csvc_route_launches(csvc, before, lens, warp_rows, block_rows)
    assert csvc.smo_cuda.launches == l0 + len(csvc.smo_cuda.last_route)
    assert int(want[2].max()) > 1000


@pytest.mark.parametrize("threads", [32, 64, 640])
def test_csvc_smo_kernel_small_problems_and_block_sizes(cuda, threads):
    """Problems of l = 1 and 2 (one sample of a class, two samples) and
    of l = 3 / 7 / 33 / 64 / 65 (both sides of the warp route's default
    limit), on the warp route and at several block sizes of the block and
    global routes."""
    from grakel_torch.ops import csvc
    K = _csvc_gram(80, 3)
    rows = [np.array([5]), np.array([3, 9]), np.array([1, 2, 3]),
            np.arange(10, 17), np.arange(0, 33), np.arange(5, 69),
            np.arange(15, 80)]
    rng = np.random.RandomState(threads)
    signs = [np.array([1]), np.array([1, -1]), np.array([1, 1, -1]),
             np.array([1, -1, 1, -1, 1, 1, -1]),
             np.where(np.arange(33) % 3 == 0, 1, -1),
             np.where(rng.rand(64) < 0.5, 1, -1),
             np.where(rng.rand(65) < 0.4, 1, -1)]
    for sg in signs[-2:]:
        sg[:2] = (1, -1)
    off = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    K64 = t(K)
    args = (K64.float(), torch.diagonal(K64).contiguous(),
            t(np.concatenate(rows).astype(np.int32)),
            t(np.concatenate(signs).astype(np.int8)),
            t(off.astype(np.int32)),
            t(np.array([1.0, 0.5, 10.0, 1e-3, 100.0, 3.0, 1e4])),
            t(np.zeros(7, np.int32)))
    want = csvc.smo_plain(*(a.cpu() for a in args))
    for kw in (dict(threads=threads), dict(threads=threads, warp_rows=0),
               dict(threads=threads, warp_rows=0, block_rows=0)):
        got = csvc.smo_cuda(*args, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), kw
    assert set(csvc.k15_routes([64, 65]).tolist()) == {0, 1}


@pytest.mark.parametrize("threads", [None, 256, 512])
def test_csvc_smo_kernel_past_1000_rows(cuda, threads):
    """A 1,500-row problem (shrinking every 1,000 iterations, the block
    route at 4, 6 and 3 rows a thread) beside short ones."""
    from grakel_torch.ops import csvc
    K = _csvc_gram(1600, 21, dup=40)
    rng = np.random.RandomState(22)
    y = (K[:, :3].sum(1) + 0.3 * rng.randn(1600) > np.median(
        K[:, :3].sum(1))).astype(int)
    fits = [(0, np.arange(1500), y[:1500], 10.0),
            (0, np.arange(100, 400), y[100:400], 1.0)]
    plan = csvc.plan_fits(fits)
    args, _ = _csvc_inputs(K, plan, cuda)
    got = csvc.smo_cuda(*args, threads=threads)
    torch.cuda.synchronize()
    want = csvc.smo_plain(*(a.cpu() for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert csvc.smo_cuda.last_route["block"]["max_rows"] == 1500


def _vote_case(cuda, K, plan, groups):
    from grakel_torch.ops import csvc
    args, K64 = _csvc_inputs(K, plan, cuda)
    coef, rho, _ = csvc.smo_cuda(*args)
    models, mg = plan.models()
    vin = (K64, torch.from_numpy(plan.eval_ids).to(cuda), args[2], coef,
           args[4], rho, torch.from_numpy(models).to(cuda),
           torch.from_numpy(mg).to(cuda))
    before = csvc.vote_cuda.launches
    dec, pred = csvc.vote_cuda(*vin, groups=plan.vote_groups() if groups
                               else None)
    torch.cuda.synchronize()
    assert csvc.vote_cuda.launches == before + 1
    dec0, pred0 = csvc.vote_plain(*(v.cpu() for v in vin))
    assert torch.equal(dec.cpu(), dec0) and torch.equal(pred.cpu(), pred0)
    return coef


@pytest.mark.parametrize("chunk", [None, 7])
def test_csvc_vote_kernel_bit_identical(cuda, chunk, monkeypatch):
    """K16 on single models and on vote groups (the Cs of a split, up to
    30 classes: 435 pairs), rows of zero coefficient skipped, the group
    rows staged in one chunk or many."""
    from grakel_torch.ops import csvc
    if chunk:
        monkeypatch.setattr(csvc, "K16_CHUNK", chunk)
    K, plan = _csvc_batch(seed=4)
    _vote_case(cuda, K, plan, False)
    K = _csvc_gram(200, 9, dup=8)
    rng = np.random.RandomState(10)
    fits, evals = [], []
    for k in (2, 5, 30):
        idx = rng.permutation(200)
        tr, ev = idx[:150], idx[150:190]
        y = rng.randint(0, k, 150)
        y[:k] = np.arange(k)
        for C in (1e-3, 1.0, 100.0):
            fits.append((0, tr, y, C))
            evals.append(ev)
    plan = csvc.plan_fits(fits, evals)
    assert plan.groups[:, 1].tolist() == [3, 3, 3]
    for groups in (True, False):
        coef = _vote_case(cuda, K, plan, groups)
    assert bool((coef == 0).any()) and bool((coef != 0).any())


def test_csvc_wrappers_refuse_cpu_and_bad_inputs(cuda):
    from grakel_torch.ops import csvc
    K, plan = _csvc_batch(seed=2)
    args, K64 = _csvc_inputs(K, plan, cuda)
    with pytest.raises(ValueError):
        csvc.smo_cuda(*(a.cpu() for a in args))
    with pytest.raises(ValueError):                       # f64 Gram
        csvc.smo_cuda(K64, *args[1:])
    with pytest.raises(ValueError):                       # int64 ids
        csvc.smo_cuda(args[0], args[1], args[2].long(), *args[3:])
    with pytest.raises(ValueError):                       # C <= 0
        csvc.smo_cuda(*args[:5], torch.zeros_like(args[5]), args[6])
    with pytest.raises(ValueError):
        csvc.smo_cuda(*args, block_rows=10 ** 6)
    with pytest.raises(ValueError):
        csvc.smo_cuda(*args, warp_rows=0, threads=48)
    coef, rho, _ = csvc.smo_cuda(*args)
    models = torch.from_numpy(plan.models()[0]).to(cuda)
    ev = torch.from_numpy(plan.eval_ids).to(cuda)
    with pytest.raises(ValueError):
        csvc.vote_cuda(K64.cpu(), ev.cpu(), args[2].cpu(), coef.cpu(),
                       args[4].cpu(), rho.cpu(), models.cpu())
    with pytest.raises(ValueError):                       # f32 Gram
        csvc.vote_cuda(K64.float(), ev, args[2], coef, args[4], rho, models)


@pytest.mark.parametrize("where", ["gram", "diag", "vote"])
def test_csvc_wrappers_refuse_non_finite_grams(cuda, where):
    """NaN or infinity in a Gram the batch reads: ValueError before any
    launch (libsvm's loop would never end)."""
    from grakel_torch.ops import csvc
    K, plan = _csvc_batch(seed=3)
    args, K64 = _csvc_inputs(K, plan, cuda)
    coef, rho, _ = csvc.smo_cuda(*args)
    models = torch.from_numpy(plan.models()[0]).to(cuda)
    ev = torch.from_numpy(plan.eval_ids).to(cuda)
    l0, v0 = csvc.smo_cuda.launches, csvc.vote_cuda.launches
    Kf, diag = args[0].clone(), args[1].clone()
    with pytest.raises(ValueError, match="NaN or infinity"):
        if where == "gram":
            Kf[7, 9] = float("inf")
            csvc.smo_cuda(Kf, diag, *args[2:])
        elif where == "diag":
            diag[4] = float("nan")
            csvc.smo_cuda(Kf, diag, *args[2:])
        else:
            K64 = K64.clone()
            K64[int(plan.eval_ids[0]), 3] = float("nan")
            csvc.vote_cuda(K64, ev, args[2], coef, args[4], rho, models)
    assert (csvc.smo_cuda.launches, csvc.vote_cuda.launches) == (l0, v0)


def test_svc_on_card_matches_cpu(cuda):
    from grakel_torch.svm import SVC
    K = _csvc_gram(80, 7, dup=4)
    y = np.random.RandomState(7).randint(0, 3, 80)
    for C in (1e-3, 1.0, 1e4):
        with use_device("cpu"):
            a = SVC(C=C).fit(K[:60, :60], y[:60])
        with use_device("cuda"):
            b = SVC(C=C).fit(K[:60, :60], y[:60])
        for attr in ("support_", "n_support_", "n_iter_", "dual_coef_",
                     "intercept_"):
            assert np.array_equal(getattr(a, attr), getattr(b, attr)), attr
        assert np.array_equal(a.decision_function(K[60:, :60]),
                              b.decision_function(K[60:, :60]))
        assert np.array_equal(a.predict(K[60:, :60]), b.predict(K[60:, :60]))


@pytest.mark.parametrize("k,scoring", [(2, "accuracy"), (4, "f1_macro")])
def test_cross_validate_on_card_matches_cpu(cuda, k, scoring):
    from grakel_torch.ops import csvc
    K1, K2 = _csvc_gram(70, 11, dup=3), _csvc_gram(70, 12)
    y = np.random.RandomState(13).randint(0, k, 70)
    kw = dict(n_iter=2, n_splits=4, random_state=5, scoring=scoring,
              C_grid=10.0 ** np.arange(-2, 4))
    with use_device("cpu"):
        want = grakel_torch.cross_validate_Kfold_SVM([K1, [K1, K2]], y, **kw)
    l0, v0 = csvc.smo_cuda.launches, csvc.vote_cuda.launches
    with use_device("cuda"):
        got = grakel_torch.cross_validate_Kfold_SVM([K1, [K1, K2]], y, **kw)
    assert got == want
    stages = grakel_torch.cross_validate_Kfold_SVM.last["stages"]
    # one K15 launch a route a stage, one K16 launch a stage
    assert csvc.smo_cuda.launches == l0 + sum(len(s["route"])
                                              for s in stages)
    assert csvc.vote_cuda.launches == v0 + 2


@pytest.mark.parametrize("scoring", ["roc_auc", "average_precision",
                                     "top_k_accuracy", "matthews_corrcoef"])
@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1)])
def test_cross_validate_decision_scorers_on_card_match_cpu(cuda, k, seed,
                                                            scoring):
    """The scorers of K16's decision values (and MCC, of its votes) on
    the card equal the CPU route exactly, one K16 launch a stage; on three
    classes roc_auc raises scikit-learn's error after the first stage on
    both routes."""
    import warnings
    from grakel_torch.ops import csvc
    K = _csvc_gram(90, 20 + seed, dup=3)
    y = np.random.RandomState(30 + seed).randint(0, k, 90)
    kw = dict(n_iter=2, n_splits=3, random_state=5, scoring=scoring,
              C_grid=10.0 ** np.arange(-2, 3))

    def run():
        try:
            return grakel_torch.cross_validate_Kfold_SVM([K], y, **kw)
        except ValueError as e:
            return str(e)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with use_device("cpu"):
            want = run()
        l0, v0 = csvc.smo_cuda.launches, csvc.vote_cuda.launches
        with use_device("cuda"):
            got = run()
    assert got == want
    assert isinstance(got, str) == (k == 3 and scoring == "roc_auc")
    if isinstance(got, str):
        assert got == "multi_class must be in ('ovo', 'ovr')"
        assert csvc.vote_cuda.launches == v0 + 1
        return
    stages = grakel_torch.cross_validate_Kfold_SVM.last["stages"]
    assert csvc.smo_cuda.launches == l0 + sum(len(s["route"])
                                              for s in stages)
    assert csvc.vote_cuda.launches == v0 + 2


def test_svc_and_cross_validate_raise_before_any_launch(cuda):
    """A NaN or an infinity: scikit-learn's error on the host, and no
    K15 or K16 launch."""
    from grakel_torch.ops import csvc
    from grakel_torch.svm import SVC
    K = _csvc_gram(40, 5)
    y = np.arange(40) % 2
    for value in (float("nan"), float("inf")):
        Kb = K.copy()
        Kb[3, 3] = value
        l0, v0 = csvc.smo_cuda.launches, csvc.vote_cuda.launches
        with use_device("cuda"):
            with pytest.raises(ValueError, match="Input X contains"):
                SVC().fit(Kb, y)
            with pytest.raises(ValueError, match="Input X contains"):
                grakel_torch.cross_validate_Kfold_SVM(
                    [Kb], y, n_iter=1, n_splits=3, C_grid=[1.0],
                    random_state=0)
            clf = SVC().fit(K[:30, :30], y[:30])
            l1, v1 = csvc.smo_cuda.launches, csvc.vote_cuda.launches
            with pytest.raises(ValueError, match="Input X contains"):
                clf.predict(Kb[30:, :30] * np.where(
                    np.arange(30) == 2, value, 1.0))
        assert csvc.vote_cuda.launches == v1 == v0
        assert csvc.smo_cuda.launches == l1 == l0 + 1


def _k17_case(rng, m, n, dtype, sym):
    """K [m, n] in ``dtype`` and its f64 diagonals: a symmetric count
    Gram with zero self-kernels (0/0), or rectangular counts against
    real-valued diagonals with zero rows (x/0, 0/0)."""
    if sym:
        A = rng.randint(0, 4, (m, 7)).astype(np.float64)
        A[::5] = 0
        K = A @ A.T
        dr = dc = np.diagonal(K).copy()
    else:
        K = rng.randint(0, 50, (m, n)).astype(np.float64)
        K[::7, ::3] = 0
        dr = rng.uniform(0.5, 4000.0, m)
        dc = rng.uniform(0.5, 4000.0, n)
        dr[::7] = 0.0
    return K.astype(dtype), dr, dc


# off the tile (1024 columns a block) and off 16-byte rows, 1 x 1, empty
@pytest.mark.parametrize("m,n,sym", [
    (1, 1, True), (0, 0, True), (0, 5, False), (5, 0, False), (7, 7, True),
    (257, 257, True), (1024, 1024, True), (3, 1025, False),
    (1030, 3, False), (13, 2049, False), (301, 1031, False)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_normalize_kernel_bit_equal_to_numpy(cuda, m, n, sym, dtype):
    """K17 through ``normalize_gram`` equals its host route (numpy) bit
    for bit and stays on the card; one launch a nonempty Gram, none for
    an empty one."""
    rng = np.random.RandomState(m * 31 + n)
    K, dr, dc = _k17_case(rng, m, n, dtype, sym)
    want = gram_ops.normalize_gram(K, dr, dc)
    before = gram_ops.normalize_gram_cuda.launches
    got = gram_ops.normalize_gram(torch.from_numpy(K).to(cuda),
                                  torch.from_numpy(dr).to(cuda), dc)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float64
    assert tuple(got.shape) == (m, n)
    assert gram_ops.normalize_gram_cuda.launches == before + (m * n > 0)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_normalize_kernel_large_products_and_infinities(cuda, dtype):
    """Diagonal products far past 2^24 (to 2^60), real-valued diagonals,
    +-inf and NaN in K, x/0, a negative product (NaN) and an infinite
    diagonal, against numpy's ``nan_to_num`` bit for bit."""
    rng = np.random.RandomState(9)
    m, n = 67, 133
    K = rng.randint(0, 1 << 24, (m, n)).astype(dtype)
    dr = rng.uniform(1 << 20, 1 << 30, m)
    dc = rng.uniform(1 << 20, 1 << 30, n)
    K[0, :4] = [np.inf, -np.inf, np.nan, -5]
    dr[1] = 0.0
    K[1, :3] = [3, -3, 0]
    dr[2] = -4.0
    dc[5] = np.inf
    K[3, 5] = np.inf
    with np.errstate(all="ignore"):
        want = np.nan_to_num(K.astype(np.float64) / np.sqrt(np.outer(dr, dc)))
    got = gram_ops.normalize_gram(torch.from_numpy(K).to(cuda),
                                  torch.from_numpy(dr).to(cuda),
                                  torch.from_numpy(dc).to(cuda))
    got = got.cpu().numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, gram_ops.normalize_gram(K, dr, dc))
    big = np.finfo(np.float64).max
    assert list(got[0, :3]) == [big, -big, 0.0]
    assert list(got[1, :3]) == [big, -big, 0.0]
    assert not got[2].any() and got[3, 5] == 0.0


def test_gram_normalize_views_and_wrapper_checks(cuda):
    """``normalize_gram`` copies a view off 16-byte alignment or
    contiguity (a mesh's rectangular Gram is a slice); K17's wrapper
    refuses such views and what it does not take."""
    base = torch.arange(1, 64, dtype=torch.float32, device=cuda).view(7, 9)
    dr = torch.arange(1, 8, dtype=torch.float64, device=cuda)
    dc = torch.arange(1, 10, dtype=torch.float64, device=cuda)
    for K, r, c in ((base[1:], dr[1:], dc), (base.t(), dc, dr)):
        got = gram_ops.normalize_gram(K, r, c)
        want = gram_ops.normalize_gram(K.cpu(), r.cpu(), c.cpu())
        assert np.array_equal(got.cpu().numpy(), want)
    for K, r, c in ((base.cpu(), dr.cpu(), dc.cpu()), (base[1:], dr[1:], dc),
                    (base.t(), dc, dr), (base.half(), dr, dc),
                    (base, dr.float(), dc), (base, dr[:6], dc),
                    (base, dr, dc.cpu())):
        with pytest.raises(ValueError, match="normalize_gram_cuda"):
            gram_ops.normalize_gram_cuda(K, r, c)


@pytest.mark.parametrize("name", ["WeisfeilerLehman", "HadamardCode"])
def test_normalized_fast_paths_take_k17_and_match_cpu(cuda, name):
    """WL's and HadamardCode's fast paths with ``normalize=True``
    normalize on the card, one K17 launch a ``fit_transform`` and one a
    ``transform``, and equal their CPU runs bit for bit; without
    normalization K17 stays off."""
    train, test = generate_dataset(n_graphs=80, n_graphs_test=10,
                                   r_vertices=(5, 30), random_state=4,
                                   features=("nl", 6))
    k = getattr(grakel_torch, name)(n_iter=3, normalize=True)
    before = gram_ops.normalize_gram_cuda.launches
    K = k.fit_transform(train)
    assert gram_ops.normalize_gram_cuda.launches == before + 1
    T = k.transform(test)
    d = k.diagonal()
    assert gram_ops.normalize_gram_cuda.launches == before + 2
    with use_device("cpu"):
        kc = getattr(grakel_torch, name)(n_iter=3, normalize=True)
        Kc, Tc, dc = kc.fit_transform(train), kc.transform(test), \
            kc.diagonal()
    assert K.dtype == T.dtype == np.float64
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)
    assert all(np.array_equal(a, b) for a, b in zip(d, dc))
    getattr(grakel_torch, name)(n_iter=3).fit_transform(train)
    assert gram_ops.normalize_gram_cuda.launches == before + 2


def test_host_spans_stay_off_the_device_timeline(cuda):
    """A traced WL fit and CV on the card: the program's host spans
    (``profiling.host_span``) are host records only, and no device record
    carries their names (a range over device work would show there as an
    annotation).  WL's normalization runs on the card as K17, with no
    ``normalize`` span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    train, _ = generate_dataset(n_graphs=60, n_graphs_test=1,
                                r_vertices=(5, 15), random_state=3,
                                features=("nl", 4))
    kw = dict(n_iter=2, n_splits=3, random_state=0)
    with use_device("cuda"):
        K = grakel_torch.WeisfeilerLehman(
            n_iter=3, normalize=True).fit_transform(train)
        y = np.arange(K.shape[0]) % 2
        grakel_torch.cross_validate_Kfold_SVM([K], y, **kw)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            grakel_torch.WeisfeilerLehman(
                n_iter=3, normalize=True).fit_transform(train)
            grakel_torch.cross_validate_Kfold_SVM([K], y, **kw)
            torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("grakel_torch.")}
    assert host == {"grakel_torch." + n for n in (
        "parse", "batch", "cv.draws", "cv.check", "cv.plan", "cv.score")}
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert any("csvc_smo" in n for n in device)
    assert any("gram_normalize" in n for n in device)   # K17, no span
    assert [n for n in device if "grakel_torch." in n] == []
