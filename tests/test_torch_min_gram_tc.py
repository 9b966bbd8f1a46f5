"""The threshold-indicator route of grakel_torch's min-intersection Gram
(the CPU side of the tensor-core kernel K1-tc) against the port's
broadcast-min plain version and against grakel_tpu's threshold GEMM on
JAX-CPU, the route choice, and PyramidMatch's Grams on each route."""

import numpy as np
import pytest
import torch

import grakel_torch
from grakel_torch.ops import intersect
from grakel_torch.ops.intersect import (min_gram_plain, min_gram_route,
                                        min_gram_threshold_plain,
                                        min_intersection_gram,
                                        threshold_columns)
from grakel_tpu.ops.intersect import _min_gram_gemm
from grakel_tpu.ops.intersect import min_intersection_gram as j_min_gram


def _counts(seed, n, m, L, hi=9, zero_cols=(), zero_rows=()):
    rng = np.random.RandomState(seed)
    A = rng.randint(0, hi, (n, L)).astype(np.float32)
    B = rng.randint(0, hi, (m, L)).astype(np.float32)
    for c in zero_cols:
        A[:, c] = 0
        B[:, c] = 0
    for r in zero_rows:
        A[r] = 0
    return A, B


CASES = {
    "square": dict(n=40, m=40, L=25),
    "rect": dict(n=17, m=50, L=31),
    "ragged": dict(n=129, m=67, L=77, hi=5),
    "zero_columns": dict(n=30, m=21, L=40, zero_cols=range(0, 40, 3)),
    "zero_row": dict(n=12, m=9, L=13, zero_rows=(0, 5)),
    "one_by_one": dict(n=1, m=1, L=1),
    "large_counts": dict(n=9, m=11, L=6, hi=300),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_threshold_plain_equals_min_plain(case):
    A, B = map(torch.from_numpy, _counts(3, **CASES[case]))
    K = min_gram_threshold_plain(A, B)
    assert K.dtype == torch.float32 and K.shape == (A.shape[0], B.shape[0])
    assert torch.equal(K, min_gram_plain(A, B))
    assert torch.equal(min_gram_threshold_plain(A, A), min_gram_plain(A, A))


@pytest.mark.parametrize("case", ["square", "rect", "zero_columns",
                                  "zero_row", "large_counts"])
def test_threshold_plain_equals_jax_threshold_gemm(case):
    A, B = _counts(4, **CASES[case])
    got = min_gram_threshold_plain(torch.from_numpy(A), torch.from_numpy(B))
    T = int(max(A.max(), B.max(), 1))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_min_gram_gemm(A, B, T)))
    np.testing.assert_array_equal(got.numpy(), j_min_gram(A, B))


def test_threshold_plain_rejects_real_values():
    A = torch.full((3, 4), 0.5)
    with pytest.raises(ValueError):
        min_gram_threshold_plain(A, A)
    with pytest.raises(ValueError):
        min_gram_threshold_plain(-A.round(), A)


def test_threshold_columns_layout():
    cols = threshold_columns(np.array([2, 0, 3, 1]))
    assert cols.dtype == np.int32 and cols.shape == (2, 16)
    assert cols[0, :6].tolist() == [0, 0, 2, 2, 2, 3]
    assert cols[1, :6].tolist() == [1, 2, 1, 2, 3, 1]
    assert (cols[1, 6:] == np.iinfo(np.int32).max).all()
    assert threshold_columns(np.zeros(5)).shape == (2, 0)


# column statistics of PyramidMatch's level matrices at full size: the
# labeled NCI1-scale levels (widths 216..1728, counts <= 8; W' 1344..3308
# for fit_transform, 1056..2368 for the transform of a 10-fold split's
# 411 test graphs) and the unlabeled REDDIT-B-scale levels (widths 6..48,
# counts up to 3737, W' ~22.4k)
def _stats(width, w_expanded, top):
    rng = np.random.RandomState(width)
    mx = np.zeros(width)
    while mx.sum() < w_expanded:
        i = rng.randint(width)
        mx[i] = min(mx[i] + 1, top)
    return mx


@pytest.mark.parametrize("width,w_expanded", [
    (216, 1344), (432, 1640), (864, 2166), (1728, 3308)])
def test_route_labeled_levels_take_tensor_cores(width, w_expanded):
    mx = _stats(width, w_expanded, 8)
    assert min_gram_route(mx, mx, True, True) == "min_gram_tc"
    # the same statistics with real values take the CUDA-core kernel
    assert min_gram_route(mx, mx, False, True) == "min_gram"


@pytest.mark.parametrize("width,w_expanded,route", [
    (216, 1056, "min_gram_tc"), (432, 1271, "min_gram_tc"),
    (864, 1638, "min_gram_tc"), (1728, 2368, "min_gram_tc")])
def test_route_labeled_transform_levels(width, w_expanded, route):
    """A rectangular call expands both sides for a full product: its
    limit is lower, but every labeled transform level (the widest ratio
    4.9) is under it since the Hopper K1-tc (limit 7)."""
    mx = _stats(width, w_expanded, 8)
    assert min_gram_route(mx, mx, True, False) == route
    assert min_gram_route(mx, mx, True, True) == "min_gram_tc"


@pytest.mark.parametrize("width,w_expanded,top", [
    (6, 22400, 3737), (12, 22400, 2000), (24, 22400, 1500),
    (48, 22400, 800)])
def test_route_unlabeled_levels_take_cuda_cores(width, w_expanded, top):
    mx = _stats(width, w_expanded, top)
    for sym in (True, False):
        assert min_gram_route(mx, mx, True, sym) == "min_gram"


# the measured limits: W' <= 13 L when B is A and W' <= 7 L otherwise
# take K1-tc, wider expansions the CUDA-core K1
@pytest.mark.parametrize("top,extra,sym,route", [
    (13, 0, True, "min_gram_tc"), (13, 1, True, "min_gram"),
    (14, 0, True, "min_gram"), (20, 0, True, "min_gram"),
    (7, 0, False, "min_gram_tc"), (7, 1, False, "min_gram"),
    (7, 90, False, "min_gram"), (1, 0, False, "min_gram_tc")])
def test_route_limits_measured_against_k1(top, extra, sym, route):
    """100 columns with maxima ``top``, ``extra`` of them one more: W' =
    100 top + extra."""
    mx = np.full(100, float(top))
    mx[:extra] += 1
    assert min_gram_route(mx, mx, True, sym) == route


def test_route_count_limit():
    mx = np.array([2049.0, 1.0] + [0.0] * 998)
    for sym in (True, False):
        assert min_gram_route(mx, mx, True, sym) == "min_gram"
    mx[0] = 2048.0
    for sym in (True, False):
        assert min_gram_route(mx, mx, True, sym) == "min_gram_tc"
    # the smaller side's maxima bound the expansion
    assert min_gram_route(np.full(4, 8.0), np.full(4, 1.0), True,
                          False) == "min_gram_tc"


@pytest.mark.parametrize("ratio", [0.0, float("inf")])
@pytest.mark.parametrize("sym", [False, True])
def test_entry_folds_weight_and_accumulates(monkeypatch, ratio, sym):
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", ratio)
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_RECT", ratio)
    A, B = map(torch.from_numpy, _counts(5, 23, 23, 19))
    B = A if sym else B
    ref = min_gram_plain(A, B)
    assert torch.equal(min_intersection_gram(A, B), ref)
    assert torch.equal(min_intersection_gram(A, B, alpha=3.0), 3.0 * ref)
    out = torch.full((23, 23), 5.0)
    got = min_intersection_gram(
        A, B, count_max=(A.numpy().max(0), B.numpy().max(0)), out=out,
        alpha=4.0)
    assert got is out and torch.equal(out, 5.0 + 4.0 * ref)


@pytest.mark.parametrize("bad", ["negative", "fraction", "width"])
def test_entry_rejects_count_max_that_are_not_counts(bad):
    A = torch.from_numpy(_counts(7, 5, 5, 6)[0])
    mx = A.numpy().max(0)
    wrong = {"negative": mx - 20.0, "fraction": mx + 0.5,
             "width": mx[:5]}[bad]
    with pytest.raises(ValueError, match="count_max"):
        min_intersection_gram(A, A, count_max=(mx, wrong))


def test_entry_real_values_and_empty():
    rng = np.random.RandomState(6)
    A = torch.from_numpy(rng.rand(7, 5).astype(np.float32))
    assert torch.allclose(min_intersection_gram(A), min_gram_plain(A, A))
    E = torch.zeros((0, 5))
    assert min_intersection_gram(E, A).shape == (0, 7)
    Z = torch.zeros((4, 0))
    assert torch.equal(min_intersection_gram(Z), torch.zeros((4, 4)))


PM_KW = [{}, {"normalize": True}, {"with_labels": False},
         {"with_labels": False, "normalize": True}]


@pytest.mark.parametrize("kw", PM_KW, ids=str)
@pytest.mark.parametrize("ratio", [0.0, float("inf")],
                         ids=["cuda_core_route", "tensor_core_route"])
def test_pm_dense_grams_equal_on_each_route(monkeypatch, kw, ratio):
    """Every level through one route (the CUDA-core K1's plain version
    with ratio 0, the threshold product with ratio inf), with no device
    statistics read: the Grams equal grakel_tpu's."""
    from test_torch_pm import _pm_both, _pm_data

    def no_stats(*a):
        raise AssertionError("PyramidMatch read column stats back")

    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", ratio)
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_RECT", ratio)
    monkeypatch.setattr(intersect, "column_stats", no_stats)
    data = _pm_data(9, 26)
    (Kt, Tt, dt), (Kj, Tj, dj) = _pm_both(kw, data[:20], data[20:])
    np.testing.assert_array_equal(Kt, Kj)
    np.testing.assert_array_equal(Tt, Tj)
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a, b)


def test_pm_routes_follow_the_level_statistics(monkeypatch):
    """On small labeled data the count levels are narrow: every level
    takes the threshold route."""
    from test_torch_pm import _pm_data
    seen = []
    orig = intersect.min_gram_route

    def spy(*a):
        seen.append(orig(*a))
        return seen[-1]

    monkeypatch.setattr(intersect, "min_gram_route", spy)
    with grakel_torch.use_device("cpu"):
        grakel_torch.PyramidMatch().fit_transform(_pm_data(10, 12))
    assert seen == ["min_gram_tc"] * 4


# ---- the weighted and batched forms of the threshold route ---------- #

def test_threshold_columns_write_weights_as_values():
    """With weights, a third row holds each expanded column's value: the
    weight of its source column (0 on the padding); the first two rows
    are the unweighted layout; weights past 127 are refused."""
    T = np.array([2, 0, 3, 1])
    w = np.array([5, 9, 127, 1])
    cols = threshold_columns(T, w)
    assert cols.dtype == np.int32 and cols.shape == (3, 16)
    np.testing.assert_array_equal(cols[:2], threshold_columns(T))
    assert cols[2, :6].tolist() == [5, 5, 127, 127, 127, 1]
    assert (cols[2, 6:] == 0).all()
    for bad in (np.array([5, 9, 128, 1]), np.array([-1, 1, 1, 1]),
                np.array([1.5, 1, 1, 1]), np.array([1, 1, 1])):
        with pytest.raises(ValueError, match="weights"):
            threshold_columns(T, bad)
    # rounds: one set of columns a round, padded to the widest round
    Tr = np.array([[2, 0, 3, 1], [1, 1, 1, 30]])
    cr = threshold_columns(Tr, w)
    assert cr.shape == (2, 3, 48)
    np.testing.assert_array_equal(cr[0, :, :16], cols)
    assert (cr[0, 1, 16:] == np.iinfo(np.int32).max).all()
    assert (cr[0, 2, 16:] == 0).all()
    np.testing.assert_array_equal(cr[1], threshold_columns(Tr[1], w))


@pytest.mark.parametrize("sym", [False, True])
def test_weighted_threshold_plain_equals_jax_level_sum(monkeypatch, sym):
    """Levels of different widths concatenated, each column weighted by
    its level's integer weight: the plain weighted threshold Gram equals
    sum_p w_p times the JAX package's Gram of level p, exactly."""
    rng = np.random.RandomState(21)
    widths, wts = (7, 12, 19), (1, 4, 127)
    la = [rng.randint(0, 6, (23, w)).astype(np.float32) for w in widths]
    lb = la if sym else [rng.randint(0, 6, (17, w)).astype(np.float32)
                         for w in widths]
    A, B = np.concatenate(la, 1), np.concatenate(lb, 1)
    w = np.concatenate([np.full(x, c) for x, c in zip(widths, wts)])
    At = torch.from_numpy(A)
    got = min_gram_threshold_plain(At, At if sym else torch.from_numpy(B), w)
    exp = sum(c * np.asarray(j_min_gram(a, b), np.float64)
              for c, a, b in zip(wts, la, lb))
    np.testing.assert_array_equal(got.numpy(), exp)
    # the entry point, both routes, and into out with alpha
    Bt = None if sym else torch.from_numpy(B)
    for ratio in (0.0, float("inf")):
        monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", ratio)
        monkeypatch.setattr(intersect, "_TC_MAX_RATIO_RECT", ratio)
        K = min_intersection_gram(At, Bt, weights=w)
        out = torch.full(K.shape, 3.0)
        min_intersection_gram(At, Bt, weights=w, out=out, alpha=2.0)
        np.testing.assert_array_equal(K.numpy(), exp)
        np.testing.assert_array_equal(out.numpy(), 3.0 + 2.0 * exp)
    with pytest.raises(ValueError, match="weights"):
        min_intersection_gram(At, weights=np.full(A.shape[1], 128))


@pytest.mark.parametrize("sym", [False, True])
def test_batched_threshold_plain_equals_jax_per_round(sym):
    """The batched plain version (rounds of different expanded widths,
    padded to the widest) equals the JAX package's Gram of each round."""
    rng = np.random.RandomState(22)
    R, n, m, L = 3, 19, 26, 15
    A = rng.randint(0, 7, (R, n, L)).astype(np.float32)
    A[1] = np.minimum(A[1], 1)        # a narrow round beside wide ones
    B = A if sym else rng.randint(0, 7, (R, m, L)).astype(np.float32)
    At = torch.from_numpy(A)
    got = min_gram_threshold_plain(At, At if sym else torch.from_numpy(B))
    assert got.shape == (R, n, n if sym else m)
    for r in range(R):
        np.testing.assert_array_equal(got[r].numpy(),
                                      np.asarray(j_min_gram(A[r], B[r])))


def test_expand_thresholds_plain_forms():
    """Weighted values, the 0/1 indicators beside them, and the batched
    form (each round its own columns) agree with a direct comparison."""
    rng = np.random.RandomState(23)
    X = torch.from_numpy(rng.randint(0, 5, (2, 9, 6)).astype(np.float32))
    T = np.array([[4, 0, 2, 1, 3, 4], [1, 1, 1, 1, 1, 0]])
    w = np.array([3, 1, 7, 2, 9, 1])
    cols = torch.from_numpy(threshold_columns(T, w))
    E, E01 = intersect.expand_thresholds(X, cols, indicators=True)
    assert E.dtype == E01.dtype == torch.int8 and E.shape == (2, 9, 16)
    for r in range(2):
        c = cols[r]
        hit = X[r][:, c[0].long()] >= c[1]
        assert torch.equal(E01[r], hit.to(torch.int8))
        assert torch.equal(E[r], (hit * c[2]).to(torch.int8))
        assert torch.equal(intersect.expand_thresholds(X[r], c[:2]), E01[r])
        assert torch.equal(intersect.expand_thresholds(X[r], c), E[r])
    assert torch.equal(intersect.expand_thresholds(X, cols, weighted=False),
                       E01)


@pytest.mark.parametrize("R,n,m,sym,tile", [
    (3, 4110, 4110, True, 3),      # NH's fit rounds: 3 x 305 blocks
    (1, 4110, 4110, True, 3),      # PM's fused labeled Gram
    (3, 64, 4110, False, 2),       # NH's transform: 64-row tiles
    (1, 411, 3699, False, 0),      # PM's transform of a 10-fold split
    (1, 4110, 4110, False, 3),     # a large rectangle
    (1, 100, 100, True, 1),        # a small symmetric call
    (1, 1, 1, False, 1)])
def test_tc_tile_fills_the_card(R, n, m, sym, tile):
    assert intersect.tc_tile(R, n, m, sym) == tile


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 256, 257, 4110])
@pytest.mark.parametrize("tile", sorted(intersect.TC_TILES))
def test_tc_symmetric_grid_covers_each_pair_once(n, tile):
    """The symmetric grid's block -> tile decoding of csrc/min_gram_tc.cu,
    in Python: every block a distinct tile that holds an entry on or
    above the diagonal, every such tile once; with the kernel's masks
    (direct: row <= col; mirrored: row < col) each Gram entry is written
    exactly once."""
    import math
    bm, bn = intersect.TC_TILES[tile]
    f = bn // bm
    tn, tm = -(-n // bm), -(-n // bn)
    per = f * tm * (tm + 1) // 2 - (f * tm - tn)
    tiles = set()
    for q in range(per):
        c = int((math.sqrt(8.0 * q / f + 1.0) - 1.0) / 2.0)
        while f * c * (c + 1) // 2 > q:
            c -= 1
        while f * (c + 1) * (c + 2) // 2 <= q:
            c += 1
        tiles.add((q - f * c * (c + 1) // 2, c))
    assert len(tiles) == per
    want = {(bi, bj) for bi in range(tn) for bj in range(tm)
            if bi * bm <= min(bj * bn + bn, n) - 1}
    assert tiles == want
    if n <= 257:
        hits = np.zeros((n, n), int)
        for bi, bj in tiles:
            r = np.arange(bi * bm, min(bi * bm + bm, n))[:, None]
            c = np.arange(bj * bn, min(bj * bn + bn, n))[None, :]
            direct = (r <= c)
            hits[np.broadcast_to(r, direct.shape)[direct],
                 np.broadcast_to(c, direct.shape)[direct]] += 1
            up = (r < c)
            hits[np.broadcast_to(c, up.shape)[up],
                 np.broadcast_to(r, up.shape)[up]] += 1
        assert (hits == 1).all()


def test_rounds_mixed_routes_equal_jax(monkeypatch):
    """Rounds routed apart: the K1-tc rounds in one batched call, the K1
    rounds one call each, all in one stack equal to the JAX rounds."""
    from grakel_tpu.ops.intersect import min_intersection_gram_rounds as jr
    rng = np.random.RandomState(24)
    A = rng.randint(0, 5, (4, 21, 30)).astype(np.float32)
    A[2] *= 10.0                       # its W' / L passes the limit
    monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", 6.0)
    seen = []
    orig = intersect._threshold_gram

    def spy(A3, *a, **k):
        seen.append(A3.shape[0])
        return orig(A3, *a, **k)

    monkeypatch.setattr(intersect, "_threshold_gram", spy)
    got = intersect.min_intersection_gram_rounds(torch.from_numpy(A),
                                                 route=None)
    assert seen == [3]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jr(A))[:, :21, :21])
