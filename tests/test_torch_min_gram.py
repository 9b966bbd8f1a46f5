"""PyramidMatch's fused K1 group and the entry's K1 route in grakel_torch
on the CPU, against grakel_tpu on JAX-CPU: which levels join the one K1
call, the weighted concatenation against the Pallas kernel in interpret
mode, the Gram against the JAX package's per-level sum on each route
(fit and transform, labeled and unlabeled, with truncated level widths),
the f64 route past 2^24, and the entry's ``route`` / ``out`` / ``alpha``
semantics."""

import numpy as np
import pytest
import torch

import grakel_torch
import grakel_tpu
from grakel_torch import use_device
from grakel_torch.kernels import pyramid_match as pm_mod
from grakel_torch.ops import intersect
from grakel_torch.ops.intersect import (k1_tile, min_gram_plain,
                                        min_intersection_gram)
from grakel_tpu.ops.intersect import min_intersection_gram as j_min_gram


def _histograms(pm, seed, sizes, labels=None):
    """Level histograms of graphs with ``sizes`` vertices: embeddings drawn
    uniformly from a seeded RandomState, vertex labels (when ``labels``, a
    label -> index dict) drawn from its keys."""
    rng = np.random.RandomState(seed)
    Us = [(n, rng.rand(n, pm.d)) for n in sizes]
    if labels is None:
        return pm._histograms(Us)
    keys = sorted(labels)
    Ls = [{v: keys[rng.randint(len(keys))] for v in range(n)} for n in sizes]
    return pm._histograms(Us, Ls, labels)


def _pair(labeled, rect, L=4, d=3):
    """(torch PM, JAX PM, px, py): fit histograms px and, when ``rect``,
    transform histograms py; labeled transform data has one label more
    than the fit data, so its level widths are truncated to the fit's."""
    kt = grakel_torch.PyramidMatch(L=L, d=d, with_labels=labeled)
    kj = grakel_tpu.PyramidMatch(L=L, d=d, with_labels=labeled)
    fit_labels = {"a": 0, "b": 1, "c": 2} if labeled else None
    px = _histograms(kt, 1, [5, 9, 14, 7, 20, 3, 11], fit_labels)
    if not rect:
        return kt, kj, px, px
    tr_labels = dict(fit_labels, z=3) if labeled else None
    return kt, kj, px, _histograms(kt, 2, [6, 13, 8, 17], tr_labels)


def _route_by_width(cut):
    """A min_gram_route stand-in: levels of width <= cut take K1."""
    def route(max_a, max_b, integer, symmetric):
        return "min_gram" if len(max_a) <= cut else "min_gram_tc"
    return route


ROUTES = {"all_k1": 0.0, "all_tc": float("inf"), "mixed": 20}


def _force(monkeypatch, route):
    if route == "mixed":
        monkeypatch.setattr(intersect, "min_gram_route",
                            _route_by_width(ROUTES[route]))
    else:
        monkeypatch.setattr(intersect, "_TC_MAX_RATIO_SYM", ROUTES[route])
        monkeypatch.setattr(intersect, "_TC_MAX_RATIO_RECT", ROUTES[route])


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("rect", [False, True], ids=["fit", "transform"])
@pytest.mark.parametrize("labeled", [False, True],
                         ids=["unlabeled", "labeled"])
def test_fused_group_equals_jax_per_level_sum(monkeypatch, labeled, rect,
                                              route):
    """The K1 group (weighted, concatenated, one call) with the K1-tc
    levels added in their epilogues equals the JAX package's per-level
    intersections combined in f64, exactly."""
    _force(monkeypatch, route)
    kt, kj, px, py = _pair(labeled, rect)
    with use_device("cpu"):
        got = kt._combined_gram(px, py).numpy()
    exp = kj._combine(kj._intersections(px, py))
    assert got.shape == exp.shape == (len(py), len(px))
    assert np.array_equal(got, exp)


def _spy(monkeypatch):
    calls = []
    orig = pm_mod.min_intersection_gram

    def spy(A, B=None, *a, **k):
        w = k.get("weights")
        calls.append({"L": A.shape[1], "route": k.get("route"),
                      "alpha": k.get("alpha", 1.0),
                      "out": k.get("out") is not None,
                      "sym": B is A,
                      "weights": None if w is None else list(w)})
        return orig(A, B, *a, **k)

    monkeypatch.setattr(pm_mod, "min_intersection_gram", spy)
    return calls


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("rect", [False, True], ids=["fit", "transform"])
def test_levels_joining_the_k1_group(monkeypatch, route, rect):
    """Every level the route sends to K1 joins one K1 call whose width is
    the sum of theirs (weights folded into the matrix, alpha 1, made
    first); every other level joins one K1-tc call whose width is the sum
    of theirs, each column carrying its level's weight (alpha 1), added
    into that result."""
    _force(monkeypatch, route)
    calls = _spy(monkeypatch)
    kt, _, px, py = _pair(True, rect)
    with use_device("cpu"):
        kt._combined_gram(px, py)
    widths = [3 * 3 * 2 ** j for j in range(4)]   # d * labels * cells
    k1 = [w for w in widths if route == "all_k1"
          or (route == "mixed" and w <= ROUTES["mixed"])]
    tc = [w for w in widths if w not in k1]
    scale = 2 ** 3
    weights = [round(c * scale) for c in kt._level_coeffs()]
    want = []
    if k1:
        want.append({"L": sum(k1), "route": "min_gram", "alpha": 1.0,
                     "out": False, "sym": not rect, "weights": None})
    if tc:
        want.append({"L": sum(tc), "route": "min_gram_tc", "alpha": 1.0,
                     "out": bool(k1), "sym": not rect,
                     "weights": [weights[widths.index(w)] for w in tc
                                 for _ in range(w)]})
    assert calls == want


def test_f64_route_keeps_per_level_calls(monkeypatch):
    """With the 2^24 bound lowered so that it applies, every level is its
    own call with no weight and the levels fold in f64: the Gram still
    equals the JAX package's."""
    monkeypatch.setattr(grakel_torch.PyramidMatch, "_F32_EXACT", 1)
    calls = _spy(monkeypatch)
    kt, kj, px, py = _pair(False, True)
    with use_device("cpu"):
        got = kt._combined_gram(px, py).numpy()
    assert [c["route"] for c in calls] == [None] * 4
    assert all(c["alpha"] == 1.0 and not c["out"] for c in calls)
    assert np.array_equal(got, kj._combine(kj._intersections(px, py)))


@pytest.mark.parametrize("rect", [False, True], ids=["fit", "transform"])
@pytest.mark.parametrize("labeled", [False, True],
                         ids=["unlabeled", "labeled"])
def test_weighted_concatenation_matches_pallas_interpret(labeled, rect):
    """The matrix PyramidMatch hands K1 (each level scaled by its integer
    weight, concatenated along L) through the plain version equals the
    JAX Pallas kernel in interpret mode on the same matrix."""
    kt, _, px, py = _pair(labeled, rect)
    scale = 2 ** (kt.L - 1)
    weights = [round(c * scale) for c in kt._level_coeffs()]

    def stacked(p, q):
        return np.concatenate(
            [w * kt._level_matrix(p, j, min(p[0][j].size, q[0][j].size))
             for j, w in enumerate(weights)], axis=1)

    Wa, Wb = stacked(py, px), stacked(px, py)
    exp = j_min_gram(Wa, Wb, force_pallas=True)
    got = min_gram_plain(torch.from_numpy(Wa), torch.from_numpy(Wb))
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("route", ["min_gram", "min_gram_tc"])
@pytest.mark.parametrize("sym", [False, True])
def test_entry_route_out_and_alpha_on_cpu(monkeypatch, route, sym):
    """``route`` names the kernel; the result is alpha * K, or out +=
    alpha * K into the given ``out``.  The K1 route reads no column
    statistics."""
    rng = np.random.RandomState(11)
    A = torch.from_numpy(rng.randint(0, 7, (13, 10)).astype(np.float32))
    B = A if sym else torch.from_numpy(
        rng.randint(0, 7, (9, 10)).astype(np.float32))
    ref = min_gram_plain(A, B)
    if route == "min_gram":
        def no_stats(*a):
            raise AssertionError("the K1 route read column statistics")
        monkeypatch.setattr(intersect, "column_stats", no_stats)
    assert torch.equal(min_intersection_gram(A, B, route=route), ref)
    assert torch.equal(min_intersection_gram(A, B, route=route, alpha=2.0),
                       2.0 * ref)
    out = torch.full(ref.shape, 7.0)
    got = min_intersection_gram(A, B, route=route, out=out, alpha=3.0)
    assert got is out and torch.equal(out, 7.0 + 3.0 * ref)


def test_entry_route_rejects():
    A = torch.rand(4, 5)
    with pytest.raises(ValueError, match="route"):
        min_intersection_gram(A, A, route="cdist")
    with pytest.raises(ValueError, match="integer"):
        min_intersection_gram(A, A, route="min_gram_tc")
    # real values through the K1 route, like the Pallas kernel's callers
    assert torch.allclose(min_intersection_gram(A, route="min_gram"),
                          min_gram_plain(A, A))


@pytest.mark.parametrize("n,m,sym,tile", [
    (2000, 2000, True, 0),     # the unlabeled PM call: 528 blocks
    (4110, 4110, True, 0),     # labeled fit levels
    (411, 3699, False, 1),     # transform of a 10-fold split: 406 blocks
    (1984, 1984, True, 1),     # 31 tiles a side: 496 blocks
    (1985, 1985, True, 0),     # 32 tiles a side: 528 blocks
    (1, 1, True, 1), (1, 10 ** 6, False, 0)])
def test_k1_tile_choice(n, m, sym, tile):
    assert k1_tile(n, m, sym) == tile


@pytest.mark.parametrize("rect", [False, True], ids=["fit", "transform"])
def test_heavy_level_weights_fold_apart(monkeypatch, rect):
    """L = 9: the deepest levels' integer weights pass 127, the largest
    int8 indicator value, so those levels take a K1-tc call each with
    the weight as alpha, after one weighted call over the others; the
    Gram still equals the JAX package's exactly."""
    _force(monkeypatch, "all_tc")
    calls = _spy(monkeypatch)
    kt, kj, px, py = _pair(True, rect, L=9, d=2)
    with use_device("cpu"):
        got = kt._combined_gram(px, py).numpy()
    np.testing.assert_array_equal(got, kj._combine(
        kj._intersections(px, py)))
    weights = [round(c * 2 ** 8) for c in kt._level_coeffs()]
    heavy = [w for w in weights if w > 127]
    assert heavy and len(calls) == 1 + len(heavy)
    assert calls[0]["weights"] is not None and calls[0]["alpha"] == 1.0
    assert max(calls[0]["weights"]) <= 127
    assert [c["alpha"] for c in calls[1:]] == [float(w) for w in heavy]
    assert all(c["weights"] is None and c["out"] for c in calls[1:])
