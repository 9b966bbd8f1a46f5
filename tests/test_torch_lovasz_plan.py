"""The host side of K12 and K13 (``grakel_torch/ops/lovasz_sdp.py``):
K12's routes and register tiles, the edges' bit rows it reads, K13's
lane groups and shared memory, and a numpy model of K13's argmax within
a group.  CPU only; the kernels themselves are held against their plain
versions in ``tests/test_torch_cuda.py`` on a card.
"""

import numpy as np
import pytest
import torch

from grakel_torch.ops import lovasz_sdp, svm_qp


# ----------------------------------------------------------------- K12
@pytest.mark.parametrize("V", [4, 8, 16, 32, 64, 128])
def test_k12_tile_covers_each_entry_once(V):
    """Route "tile" at a bucket size: (V / R)^2 threads a graph, each an
    R x R tile; the tiles cover every (i, j) once and the diagonal only
    in the tiles with ti == tj; a tile's R columns lie in one word of a
    bit row; a block is a whole number of warps, at most 256 threads
    (the kernels' launch bound)."""
    assert lovasz_sdp.k12_route(V) == "tile"
    R, T, G, threads = lovasz_sdp.k12_tile(V)
    assert R in (2, 4, 8) and V % R == 0 and T == (V // R) ** 2
    assert threads == T * G and threads % 32 == 0 and threads <= 256
    S = V // R
    seen = np.zeros((V, V), int)
    for t in range(T):
        ti, tj = divmod(t, S)
        i0, j0 = ti * R, tj * R
        seen[i0:i0 + R, j0:j0 + R] += 1
        assert j0 // 32 == (j0 + R - 1) // 32
        diag = any(i0 + a == j0 + b for a in range(R) for b in range(R))
        assert diag == (ti == tj)
    assert (seen == 1).all()


@pytest.mark.parametrize("V", [1, 2, 3, 12, 100, 256, 4096])
def test_k12_route_global_off_the_tiles(V):
    """Sizes off the tile table (not a power of two from 4 to 128) take
    route "global"."""
    assert lovasz_sdp.k12_route(V) == "global"
    with pytest.raises(KeyError):
        lovasz_sdp.k12_tile(V)


@pytest.mark.parametrize("V", [1, 4, 16, 31, 32, 33, 64, 100, 128])
def test_edge_bits_match_edges(V):
    """``edge_bits`` against E > 0 (negative and zero entries are no
    edge), bit j % 32 of word j // 32, word 31 set giving a negative
    int32; the layout of ``svm_qp.adjacency_bits`` and the inverse of
    ``svm_qp.dense_from_bits``."""
    rng = np.random.RandomState(V)
    B = 5
    E = rng.choice([-1.0, 0.0, 0.0, 1.0, 2.5], size=(B, V, V))
    E = E.astype(np.float32)
    if V > 31:
        E[0, :, 31] = 1.0
    Eb = lovasz_sdp.edge_bits(torch.from_numpy(E))
    W = (V + 31) // 32
    assert Eb.dtype == torch.int32 and tuple(Eb.shape) == (B, V, W)
    assert Eb.is_contiguous()
    words = Eb.numpy().view(np.uint32).astype(np.int64)
    j = np.arange(V)
    bits = (words[:, :, j // 32] >> (j % 32)) & 1
    np.testing.assert_array_equal(bits, (E > 0).astype(np.int64))
    if V > 31:
        assert (Eb[0, :, 0] < 0).all()
    flat = np.flatnonzero(E > 0)
    ref = svm_qp.adjacency_bits(flat, B, V, "cpu")
    assert torch.equal(Eb, ref)
    assert torch.equal(svm_qp.dense_from_bits(Eb, V),
                       torch.from_numpy((E > 0).astype(np.float32)))


def _dr_state(B, V, seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, V + 1, B)
    E = np.zeros((B, V, V), np.float32)
    for b in range(B):
        A = np.triu(rng.rand(n[b], n[b]) < 0.4, 1)
        E[b, :n[b], :n[b]] = A | A.T
    Y = rng.randn(B, V, V).astype(np.float32)
    X = rng.randn(B, V, V).astype(np.float32)
    Y, X = Y + Y.transpose(0, 2, 1), X + X.transpose(0, 2, 1)
    w, U = np.linalg.eigh(2 * X - Y)
    return [torch.from_numpy(x) for x in (
        E, n.astype(np.int32), Y, X, w.astype(np.float32),
        U.astype(np.float32))]


def test_dr_step_on_the_cpu_is_the_plain_step():
    """On CPU tensors ``dr_step`` is the plain step, with or without the
    bit rows, and K12's wrapper refuses them."""
    E, n, Y, X, w, U = _dr_state(4, 16, 0)
    want = lovasz_sdp.dr_step_plain(E, n, Y, X, w, U)
    for Eb in (None, lovasz_sdp.edge_bits(E)):
        got = lovasz_sdp.dr_step(E, n, Y, X, w, U, Eb=Eb)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        lovasz_sdp.dr_step_cuda(lovasz_sdp.edge_bits(E), n, Y, X, w, U)


def test_theta_packs_no_bits_on_the_cpu(monkeypatch):
    """The DR loop packs the edges' bit rows only for a card: on the CPU
    it never calls ``edge_bits`` and equals the plain loop."""
    E, n = _dr_state(3, 8, 1)[:2]
    want = lovasz_sdp._theta(E, n, 20, 1.0)

    def refuse(E):
        raise AssertionError("edge_bits called on the CPU")
    monkeypatch.setattr(lovasz_sdp, "edge_bits", refuse)
    got = lovasz_sdp._theta(E, n, 20, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ----------------------------------------------------------------- K13
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("d", [3, 8, 51, 57, 128])
def test_k13_plan_register_route(d, m):
    """Up to d = 128 the register route: a subset on the next power of
    two at or above m lanes (32 / that many a warp), each lane's column
    padded to the first register width at or above d, the block's
    centres and columns within a block's shared memory."""
    route, group, reg_d, smem = lovasz_sdp.k13_plan(d, m)
    assert route == lovasz_sdp.k13_route(d, m) == "register"
    assert group == 1 << (m - 1).bit_length() and group // 2 < m <= group
    assert reg_d == min(r for r in lovasz_sdp.K13_REG_D if r >= d)
    assert reg_d % 4 == 0
    slot = lovasz_sdp.k13_slot(d, m, group, route)
    _check_slot(slot, reg_d + (d * m + 3) // 4 * 4, group)
    assert smem == 4 * (32 // group) * slot * 4 <= lovasz_sdp.K13_SMEM_MAX
    # the path's shape: 56 + 408 floats, padded to 8 banks past 32 x 15
    assert lovasz_sdp.k13_plan(51, 8) == ("register", 8, 56, 4 * 4 * 488 * 4)


def _check_slot(slot, unpadded, group):
    """A slot is its centre and columns padded by fewer than 32 floats to
    start ``group`` banks (four below a group of four) past a multiple of
    32 floats from the slot before; a group of 32 is not padded."""
    assert slot % 4 == 0 and unpadded <= slot < unpadded + 32
    if group == 32:
        assert slot == unpadded
    else:
        assert slot % 32 == max(group, 4)


@pytest.mark.parametrize("m", [1, 2, 8, 17, 32])
@pytest.mark.parametrize("d", [129, 300, 1000, 8192])
def test_k13_plan_past_the_register_route(d, m):
    """Past d = 128: route "shared" while the block's columns and centres
    fit ``K13_SMEM_BUDGET`` at the group of m, else "global", whose
    group widens till the centres fit a block; every route can be asked
    for where its slots fit, "register" only up to d = 128."""
    route, group, reg_d, smem = lovasz_sdp.k13_plan(d, m)
    g0 = 1 << (m - 1).bit_length()
    fits = lovasz_sdp.k13_smem(d, m, g0, "shared") \
        <= lovasz_sdp.K13_SMEM_BUDGET
    assert route == ("shared" if fits else "global") and reg_d == 0
    assert group >= g0 and smem <= lovasz_sdp.K13_SMEM_MAX
    c = (d + 3) // 4 * 4
    slot = lovasz_sdp.k13_slot(d, m, group, route)
    _check_slot(slot, c + (0 if route == "global" else (d * m + 3) // 4 * 4),
                group)
    assert smem == 4 * (32 // group) * slot * 4
    assert group == g0 or lovasz_sdp.k13_smem(d, m, group // 2, route) \
        > lovasz_sdp.K13_SMEM_MAX
    with pytest.raises(ValueError):
        lovasz_sdp.k13_plan(d, m, "register")
    with pytest.raises(ValueError):
        lovasz_sdp.k13_plan(d, m, "warp")


def test_k13_plan_overrides_at_the_path_shape():
    """At the path's shape (d = 51, m = 8) each route can be asked for:
    four subsets a warp on every one; the shared route stages the
    columns, the global route the centres only."""
    plans = {r: lovasz_sdp.k13_plan(51, 8, r)
             for r in ("register", "shared", "global")}
    assert {p[1] for p in plans.values()} == {8}
    assert plans["shared"][3] == 4 * 4 * (52 + 408 + 28) * 4
    assert plans["global"][3] == 4 * 4 * (52 + 20) * 4


def _group_argmax(vals, g):
    """K13's argmax in a group of g lanes, as the kernel's butterfly runs
    it: xor offsets g / 2, ..., 1, the larger value first and the smaller
    index on a tie; every lane's (value, index) after the rounds."""
    best = list(vals)
    arg = list(range(len(vals)))
    o = g // 2
    while o:
        nb, na = best[:], arg[:]
        for lane in range(len(vals)):
            ov, oi = best[lane ^ o], arg[lane ^ o]
            if ov > best[lane] or (ov == best[lane] and oi < arg[lane]):
                nb[lane], na[lane] = ov, oi
        best, arg = nb, na
        o //= 2
    return best, arg


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 17, 32])
def test_k13_group_argmax_is_the_first_largest(m):
    """The butterfly within a group of g lanes (lanes m .. g - 1 carry
    -inf) leaves every lane of the group the first index of the largest
    distance, ``np.argmax``'s and ``torch.argmax``'s choice, also
    through exact ties."""
    g = 1 << (m - 1).bit_length()
    rng = np.random.RandomState(m)
    for _ in range(200):
        d2 = rng.randint(0, 4, m).astype(np.float32)   # many ties
        vals = list(d2) + [-np.inf] * (g - m)
        best, arg = _group_argmax(vals, g)
        want = int(np.argmax(d2))
        assert want == int(torch.argmax(torch.from_numpy(d2)))
        assert arg == [want] * g and best == [d2[want]] * g


def test_min_cone_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        lovasz_sdp.min_cone_cuda(torch.zeros(3, 51, 8))


# ------------------------------------------------- K13's exact quotient
def _rn32(v):
    """The exact rational ``v`` rounded to f32, to nearest, ties to
    even, subnormals included."""
    from fractions import Fraction
    if v == 0:
        return np.float32(0.0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    q = max(e - 23, -149)
    s = a / Fraction(2) ** q
    n, rem = divmod(s.numerator, s.denominator)
    if 2 * rem > s.denominator or (2 * rem == s.denominator and n & 1):
        n += 1
    r = np.float32(n * 2.0 ** q)
    return -r if v < 0 else r


def _fma32(a, b, c):
    from fractions import Fraction
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _fma64(a, b, c):
    from fractions import Fraction
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _cone_quotient_model(x, den, r):
    """``cone_quotient`` of ``csrc/lovasz.cu`` operation by operation:
    numpy's IEEE f32 / f64 products and conversions, exact fused
    multiply-adds."""
    x, den, r = np.float32(x), np.float32(den), np.float32(r)
    if abs(x) >= np.float32(2.0 ** -100):
        q = x * r
        q = _fma32(_fma32(-den, q, x), r, q)
        return _fma32(_fma32(-den, q, x), r, q)
    if x == 0:
        return x * r
    xd, dd, rd = float(x), float(den), float(r)
    rd = _fma64(rd, _fma64(-dd, rd, 1.0), rd)
    rd = _fma64(rd, _fma64(-dd, rd, 1.0), rd)
    q = xd * rd
    q = _fma64(_fma64(-dd, q, xd), rd, q)
    qf = np.float32(q)
    if abs(qf) <= np.float32(2.0 ** -126):
        e = _fma64(-float(qf), dd, xd)
        if 2.0 * abs(e) == dd * 2.0 ** -149:
            mq = int(np.array([abs(qf)], np.float32).view(np.uint32)[0])
            up = (e > 0) == (x > 0)
            if mq & 1:
                mq = mq + 1 if up else mq - 1
                qf = np.array([mq], np.uint32).view(np.float32)[0]
                qf = -qf if x < 0 else qf
    return qf


def _bits(v):
    return int(np.array([v], np.float32).view(np.uint32)[0])


def test_cone_quotient_model_is_ieee_division():
    """A model of K13's quotient (the f32 reciprocal of k + 2 and two
    fused corrections; subnormal-range x in f64 with the ties rounded to
    even) against numpy's IEEE f32 division, bit for bit, for every
    divisor 2 .. 401 of the 400 steps: x at the ends of [-2, 2], +-0,
    the smallest and largest subnormals, both sides of the 2^-100 switch,
    random normal and subnormal x, and x / den on an exact subnormal tie
    for every even divisor.  (The card checks every f32 in [-2, 2]:
    ``min_cone_quotient_check``.)"""
    rng = np.random.RandomState(16)
    tiny = np.float32(2.0 ** -100)
    xs = [2.0, -2.0, 1.0, 0.0, -0.0, 2.0 ** -149, -(2.0 ** -149),
          2.0 ** -126 - 2.0 ** -149, 2.0 ** -126, float(tiny),
          float(np.nextafter(tiny, np.float32(0))), -float(tiny)]
    xs += list(rng.choice([-1, 1], 16) * 2.0 ** rng.uniform(-99, 1, 16))
    xs += list(rng.choice([-1, 1], 8) * 2.0 ** rng.uniform(-149, -100, 8))
    xs = np.array(xs, np.float32)
    dens = np.arange(2, lovasz_sdp.MEC_ITERS + 2, dtype=np.float32)
    rcp = lovasz_sdp.cone_reciprocals(lovasz_sdp.MEC_ITERS)
    assert rcp.dtype == np.float32 and len(rcp) == len(dens)
    pairs = [(x, k) for x in xs for k in range(len(dens))]
    for den in range(2, lovasz_sdp.MEC_ITERS + 2, 2):
        for n in (1, 3, 2 * den + 1):   # x / den = (n / 2) 2^-149, a tie
            x = np.float32(n * (den // 2) * 2.0 ** -149)
            pairs += [(x, den - 2), (-x, den - 2)]
    for x, k in pairs:
        want = x / dens[k]
        got = _cone_quotient_model(x, dens[k], rcp[k])
        assert _bits(got) == _bits(want), (float(x), float(dens[k]))
