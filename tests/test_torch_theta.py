"""SvmTheta and LovaszTheta of grakel_torch against grakel_tpu on JAX-CPU,
with their device programs' plain versions (K10-K13) against the JAX
code each replaces.

Tolerances and what they rest on:

* the plain one-class solve (K10 + K11) against
  ``grakel_tpu.ops.svm_qp.one_class_alphas``: rtol 1e-4 / atol 1e-5 on
  the JAX package's own test graphs (``tests/test_common.py``); on a
  degenerate QP (the shifted K is singular by construction, so the
  minimizer may be a set) two f32 trajectories drift apart along the
  set, and there the unique quantities are compared: K a and the
  objective;
* against the libsvm oracle ``grakel_tpu.kernels.svm_theta._svm_alphas``
  at the JAX test's bound, 2e-3 on the sampled features;
* the DR solve: theta and S to atol 1e-4 (f32, 300 iterations, LAPACK
  eigh in both packages in another build), and theta(C5) = sqrt(5);
* the cone loop: the Badoiu-Clarkson iteration meets exact ties, so
  the far column is decided by the last bit of the squared distances.
  The plain version sums them in order with one rounding a term, the
  order XLA-CPU takes for up to 17 rows, so the cosines agree to 1e-6
  there (the final normalization is summed in another order);
* the classes at rtol 1e-5 with the same random_state (the draw
  streams must end in the same generator state), on the alphas or the
  SDP of the JAX package (each half is held apart above, as the JAX
  package's parity tests do), and end to end at the solvers' bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grakel_torch
import grakel_tpu
from grakel_torch import GraphKernel, tools, use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.ops import lovasz_sdp, svm_qp
from grakel_tpu import tools as jtools
from grakel_tpu.kernels import lovasz_theta as jlov
from grakel_tpu.kernels.svm_theta import _svm_alphas
from grakel_tpu.ops import lovasz_sdp as jsdp
from grakel_tpu.ops import svm_qp as jsvm


def _sym(n, p, rng):
    A = (rng.rand(n, n) < p).astype(float)
    A = np.triu(A, 1)
    return A + A.T


def _common_graphs(seed):
    """The JAX package's test set for the solve (tests/test_common.py
    test_svm_qp_matches_libsvm): 12 random graphs and two zero ones."""
    rng = np.random.RandomState(seed)
    adjm = [_sym(rng.randint(2, 35), rng.choice([0.1, 0.3, 0.6]), rng)
            for _ in range(12)]
    return adjm + [np.zeros((5, 5)), np.zeros((1, 1))]


def _shifted(A):
    K = (A > 1e-10).astype(float)
    np.fill_diagonal(K, 0)
    me = np.linalg.eigvalsh(K)[0]
    if me < 0 and abs(me) > 1e-6:
        K = K / (-me)
        K[np.diag_indices_from(K)] += 1.0
    return K


# ------------------------------------------------------------------ tools
@pytest.mark.parametrize("n,rng_", [(1, (1, 1)), (5, (2, 8)), (9, (2, 8)),
                                    (40, (2, 8)), (3, (3, 6)), (12, (1, 4))])
def test_distribute_samples_matches_jax(n, rng_):
    for ns in (1, 7, 50, 333):
        assert tools.distribute_samples(n, rng_, ns) == \
            jtools.distribute_samples(n, rng_, ns)


def test_dict_tools_match_jax():
    d = {1: "a", 2: [3, 4], 3: "a"}
    assert tools.inv_dict(d) == jtools.inv_dict(d)
    a, b = {}, {}
    tools.nested_dict_add(a, 5, "x", "y", "z")
    jtools.nested_dict_add(b, 5, "x", "y", "z")
    assert a == b
    assert tools.nested_dict_get(a, "x", "y", "z") == 5
    assert tools.nested_dict_get(a, "x", "q", default=-1) == -1
    M = np.random.RandomState(0).rand(6, 6)
    for op in (">", "<", ">=", "<=", "=="):
        assert tools.matrix_to_dict(M, op, 0.5) == \
            jtools.matrix_to_dict(M, op, 0.5)
    pq, jq = tools.priority_dict(), jtools.priority_dict()
    for k, v in ((0, 3.0), (1, 1.0), (2, 2.0), (1, 5.0), (3, 0.5)):
        pq[k], jq[k] = v, v
    assert list(pq) == list(jq) == [3, 2, 0, 1]


# ---------------------------------------------------------- K10 and K11
def _jax_lanczos(K, v0, m=64):
    """The Lanczos loop of grakel_tpu.ops.svm_qp._build_solver (:93-110),
    from the unnormalized start vector."""
    S, V = v0.shape
    K, v0 = jnp.asarray(K), jnp.asarray(v0)

    def mv(x):
        return jnp.einsum("svw,sw->sv", K, x,
                          preferred_element_type=jnp.float32)

    nrm = jnp.sqrt(jnp.sum(v0 * v0, axis=1, keepdims=True))
    v0 = v0 * jnp.where(nrm > 0, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)

    def lstep(j, carry):
        v_prev, v_cur, beta_prev, al, be = carry
        w = mv(v_cur)
        aj = jnp.sum(v_cur * w, axis=1)
        w = w - aj[:, None] * v_cur - beta_prev[:, None] * v_prev
        bj = jnp.sqrt(jnp.sum(w * w, axis=1))
        invb = jnp.where(bj > 1e-6, 1.0 / jnp.maximum(bj, 1e-30), 0.0)
        v_next = w * invb[:, None]
        bj = jnp.where(bj > 1e-6, bj, 0.0)
        return v_cur, v_next, bj, al.at[:, j].set(aj), be.at[:, j].set(bj)

    z = jnp.zeros((S, m), jnp.float32)
    _, _, _, al, be = jax.lax.fori_loop(
        0, m, lstep, (jnp.zeros((S, V), jnp.float32), v0,
                      jnp.zeros(S, jnp.float32), z, z))
    return np.asarray(al), np.asarray(be)


def _jax_fista(K, a0, u, s, scale, dadd, L, iters=300):
    """The FISTA loop of grakel_tpu.ops.svm_qp._build_solver (:112-150)
    on given shift and step."""
    K, a0, u, s, scale, dadd, L = (jnp.asarray(x) for x in
                                   (K, a0, u, s, scale, dadd, L))

    def Kx(x):
        return scale[:, None] * jnp.einsum(
            "svw,sw->sv", K, x, preferred_element_type=jnp.float32) \
            + dadd[:, None] * x

    def project(v):
        def bstep(_, lh):
            lo, hi = lh
            mid = 0.5 * (lo + hi)
            tot = jnp.sum(jnp.clip(v - mid[:, None], 0.0, u), axis=1)
            over = tot > s
            return jnp.where(over, mid, lo), jnp.where(over, hi, mid)
        lo, hi = jax.lax.fori_loop(0, 30, bstep, (jnp.min(v, axis=1) - 1.0,
                                                  jnp.max(v, axis=1)))
        return jnp.clip(v - (0.5 * (lo + hi))[:, None], 0.0, u)

    def fstep(_, carry):
        a, y, t = carry
        an = project(y - Kx(y) / L[:, None])
        tn = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        return an, an + ((t - 1.0) / tn) * (an - a), tn

    a, _, _ = jax.lax.fori_loop(0, iters, fstep, (a0, a0, jnp.float32(1.0)))
    return np.asarray(a)


def _slab(adjm, V):
    """K, u, s, a0 of one slab, as one_class_alphas builds it."""
    S = len(adjm)
    K = np.zeros((S, V, V), np.float32)
    u = np.zeros((S, V), np.float32)
    for g, A in enumerate(adjm):
        n = A.shape[0]
        K[g, :n, :n] = A > 1e-10
        np.fill_diagonal(K[g], 0)
        u[g, :n] = 1
    s = 0.5 * u.sum(1)
    a0 = np.clip(s[:, None] - np.arange(V)[None, :], 0, 1).astype(
        np.float32) * u
    return K, u, s.astype(np.float32), a0


@pytest.mark.parametrize("seed", [3, 4])
def test_lanczos_plain_matches_jax_loop(seed):
    """K10's plain version against the JAX Lanczos loop on the slabs of
    the JAX test set: the first steps to 1e-5 and the tridiagonal's
    extremal eigenvalues (all the solve reads) to 1e-4."""
    adjm = _common_graphs(seed)
    for V in sorted({svm_qp._pow2(A.shape[0]) for A in adjm}):
        K, u, s, a0 = _slab([A for A in adjm
                             if svm_qp._pow2(A.shape[0]) == V], V)
        v0 = svm_qp.start_vector(torch.from_numpy(u))
        al, be = svm_qp.lanczos_plain(torch.from_numpy(K), v0)
        jal, jbe = _jax_lanczos(K, v0.numpy())
        np.testing.assert_allclose(al[:, :4], jal[:, :4], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(be[:, :4], jbe[:, :4], rtol=1e-5,
                                   atol=1e-5)
        for got, ref in zip(
                svm_qp.spectral_shift(al, be),
                svm_qp.spectral_shift(torch.from_numpy(jal),
                                      torch.from_numpy(jbe))):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_fista_plain_matches_jax_loop(seed):
    """K11's plain version against the JAX FISTA loop on the same shift:
    the alphas to rtol 1e-4 / atol 1e-5."""
    adjm = _common_graphs(seed)
    for V in sorted({svm_qp._pow2(A.shape[0]) for A in adjm}):
        K, u, s, a0 = _slab([A for A in adjm
                             if svm_qp._pow2(A.shape[0]) == V], V)
        tK, tu = torch.from_numpy(K), torch.from_numpy(u)
        shift = svm_qp.spectral_shift(
            *svm_qp.lanczos_plain(tK, svm_qp.start_vector(tu)))
        a = svm_qp.fista_plain(tK, torch.from_numpy(a0), tu,
                               torch.from_numpy(s), *shift)
        ja = _jax_fista(K, a0, u, s, *(x.numpy() for x in shift))
        np.testing.assert_allclose(a.numpy(), ja, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4])
def test_one_class_alphas_match_jax(seed):
    """The port's plain route against grakel_tpu's one_class_alphas:
    rtol 1e-4 / atol 1e-5; on the zero matrices the result is libsvm's
    initial point clip(n/2 - i, 0, 1) by construction (every feasible
    point is optimal), up to the f32 projection's rounding."""
    adjm = _common_graphs(seed)
    got = svm_qp.one_class_alphas(adjm, device="cpu")
    ref = jsvm.one_class_alphas(adjm)
    for A, a, r in zip(adjm, got, ref):
        assert a.dtype == np.float64 and a.shape == (A.shape[0],)
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-5)
    for a in got[-2:]:   # to the f32 bisection's last bits
        n = a.shape[0]
        np.testing.assert_allclose(
            a, np.clip(0.5 * n - np.arange(n), 0, 1), rtol=0, atol=1e-6)


def test_one_class_alphas_degenerate_qp_unique_parts():
    """A QP whose minimizer is a set (an edge and an isolated vertex:
    only a_1 + a_2 enters the objective): the two packages may stop at
    different points of the set, but K a and the objective are unique."""
    A = np.zeros((3, 3))
    A[1, 2] = A[2, 1] = 1
    rng = np.random.RandomState(3)
    adjm = [A] + [_sym(rng.randint(2, 8), 0.4, rng) for _ in range(6)]
    got = svm_qp.one_class_alphas(adjm, device="cpu")
    ref = jsvm.one_class_alphas(adjm)
    for A, a, r in zip(adjm, got, ref):
        K = _shifted(A)
        np.testing.assert_allclose(K @ a, K @ r, rtol=1e-4, atol=1e-4)
        assert abs(a @ K @ a - r @ K @ r) < 1e-5
        assert abs(a.sum() - 0.5 * A.shape[0]) < 1e-5


def test_one_class_alphas_against_libsvm():
    """The port against the libsvm oracle on the JAX package's own test
    (tests/test_common.py test_svm_qp_matches_libsvm, the same random
    stream): the box and sum constraints, an objective never worse than
    libsvm's, and the sampled features to its 2e-3 on the IMDB-B-shaped
    batch."""
    rng = np.random.RandomState(3)
    adjm = [_sym(rng.randint(2, 35), rng.choice([0.1, 0.3, 0.6]), rng)
            for _ in range(12)]
    adjm += [np.zeros((5, 5)), np.zeros((1, 1))]
    for A, a in zip(adjm, svm_qp.one_class_alphas(adjm, device="cpu")):
        r = _svm_alphas(A)
        K = _shifted(A)
        assert a.min() >= -1e-6 and a.max() <= 1 + 1e-6
        assert abs(a.sum() - 0.5 * A.shape[0]) < 1e-4 * max(A.shape[0], 1)
        assert 0.5 * a @ K @ a <= 0.5 * r @ K @ r + 1e-5
    imdb = [_sym(rng.randint(12, 29), 0.5, rng) for _ in range(16)]
    for A, a in zip(imdb, svm_qp.one_class_alphas(imdb, device="cpu")):
        k1 = grakel_torch.SvmTheta(random_state=0)
        k1.initialize()
        k2 = grakel_torch.SvmTheta(random_state=0)
        k2.initialize()
        np.testing.assert_allclose(k1._levels(A, a),
                                   k2._levels(A, _svm_alphas(A)),
                                   rtol=2e-3, atol=2e-3)


def test_one_class_alphas_bucket_of_several_slabs_matches_jax():
    """300 graphs of one size bucket (V = 16: two slabs of K10's plain
    version, each graph's start vector seeded by its slab position, and
    one call of K11's for the bucket) against grakel_tpu's
    one_class_alphas: K a and the objective, unique where the alphas need
    not be (the shifted K is singular by construction), to the degenerate
    test's 1e-4 / 1e-5, and the constraints."""
    rng = np.random.RandomState(12)
    adjm = [_sym(rng.randint(9, 17), rng.choice([0.15, 0.3, 0.5]), rng)
            for _ in range(300)]
    calls = []
    real = svm_qp.one_class_fista_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    svm_qp.one_class_fista_plain = spy
    try:
        got = svm_qp.one_class_alphas(adjm, device="cpu")
    finally:
        svm_qp.one_class_fista_plain = real
    assert calls == [(300, 16, 1)]
    ref = jsvm.one_class_alphas(adjm)
    for A, a, r in zip(adjm, got, ref):
        K = _shifted(A)
        np.testing.assert_allclose(K @ a, K @ r, rtol=1e-4, atol=1e-4)
        assert abs(a @ K @ a - r @ K @ r) < 1e-5
        assert abs(a.sum() - 0.5 * A.shape[0]) < 1e-5
        assert a.min() >= -1e-6 and a.max() <= 1 + 1e-6


def test_one_class_alphas_slab_seeding_matches_jax_lanczos():
    """The slabs of a bucket past 256 graphs seed each graph's Lanczos
    start vector by its position in its slab (the JAX program's g):
    the port's per-slab K10 coefficients equal the JAX Lanczos loop's on
    the same slabs: the start vectors equal the JAX program's formula
    (:86-88) to 1e-6 and the shift from the coefficients equals the JAX
    loop's to 1e-4."""
    rng = np.random.RandomState(5)
    adjm = [_sym(rng.randint(5, 9), 0.4, rng) for _ in range(260)]
    seen = []
    real = svm_qp.lanczos_plain

    def spy(K, v0, *a, **kw):
        seen.append((K.clone(), v0.clone()))
        return real(K, v0, *a, **kw)
    svm_qp.lanczos_plain = spy
    try:
        svm_qp.one_class_alphas(adjm, device="cpu")
    finally:
        svm_qp.lanczos_plain = real
    assert [K.shape[0] for K, _ in seen] == [256, 4]
    for (K, v0), sl in zip(seen, (slice(0, 256), slice(256, 260))):
        _, u, _, _ = _slab(adjm[sl], 8)
        S, V = u.shape
        jv0 = jnp.cos(1.372954 * jnp.arange(V, dtype=jnp.float32)[None, :]
                      + 0.718281 * jnp.arange(S, dtype=jnp.float32)[:, None]
                      ) * u
        np.testing.assert_allclose(v0.numpy(), np.asarray(jv0), rtol=1e-6,
                                   atol=1e-6)
        al, be = svm_qp.lanczos_plain(K, v0)
        jal, jbe = _jax_lanczos(K.numpy(), v0.numpy())
        for got, ref in zip(svm_qp.spectral_shift(al, be),
                            svm_qp.spectral_shift(torch.from_numpy(jal),
                                                  torch.from_numpy(jbe))):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _bucket(adjm, V):
    """Kb (bit rows), u, s, a0 of one size bucket, as one_class_alphas
    builds them."""
    K, u, s, a0 = _slab(adjm, V)
    Kb = svm_qp.adjacency_bits(np.flatnonzero(K), len(adjm), V, "cpu")
    return Kb, *(torch.from_numpy(x) for x in (u, s, a0))


def test_bucket_start_vector_matches_jax_slab_positions():
    """The start vectors of a 600-graph V = 16 bucket (three slabs of
    256, 256 and 88), built a slab at a time and concatenated as the
    card's one launch a bucket takes them, equal the JAX program's
    formula (:86-88) at each graph's position within its slab, g = b mod
    256, to 1e-6."""
    rng = np.random.RandomState(21)
    adjm = [_sym(rng.randint(9, 17), 0.3, rng) for _ in range(600)]
    _, u, _, _ = _bucket(adjm, 16)
    v0 = svm_qp.bucket_start_vector(u)
    assert svm_qp._slab_cap(16) == 256 and v0.shape == (600, 16)
    g = (np.arange(600) % 256).astype(np.float32)
    jv0 = jnp.cos(1.372954 * jnp.arange(16, dtype=jnp.float32)[None, :]
                  + 0.718281 * jnp.asarray(g)[:, None]) * u.numpy()
    np.testing.assert_allclose(v0.numpy(), np.asarray(jv0), rtol=1e-6,
                               atol=1e-6)


def test_one_class_solve_plain_on_bits_matches_alphas_and_jax():
    """The plain composition on a bucket's bit rows (K10's plain version
    a slab at a time on their dense K, then the shift and FISTA), what
    the card's one launch a bucket is held to, equals the CPU route of
    one_class_alphas exactly on a 600-graph V = 16 bucket of three slabs
    and an 8-vertex bucket with a zero-edge and a 1-vertex graph, and
    against grakel_tpu's one_class_alphas K a and the objective agree to
    the several-slab test's 1e-4 / 1e-5, with the constraints."""
    rng = np.random.RandomState(22)
    big = [_sym(rng.randint(9, 17), rng.choice([0.15, 0.3, 0.5]), rng)
           for _ in range(600)]
    small = [np.zeros((5, 5)), np.zeros((1, 1))] + [
        _sym(rng.randint(2, 9), 0.4, rng) for _ in range(20)]
    adjm = small + big
    got = svm_qp.one_class_alphas(adjm, device="cpu")
    for part, V, at in ((small, 8, 0), (big, 16, len(small))):
        Kb, u, s, a0 = _bucket(part, V)
        v0 = svm_qp.bucket_start_vector(u)
        a, al, be = svm_qp.one_class_solve_plain(Kb, v0, a0, u, s)
        assert al.shape == be.shape == (len(part), 64)
        for k, A in enumerate(part):
            np.testing.assert_array_equal(
                a[k, :A.shape[0]].numpy().astype(np.float64), got[at + k])
    ref = jsvm.one_class_alphas(adjm)
    for A, a, r in zip(adjm, got, ref):
        K = _shifted(A)
        np.testing.assert_allclose(K @ a, K @ r, rtol=1e-4, atol=1e-4)
        assert abs(a @ K @ a - r @ K @ r) < 1e-5
        assert abs(a.sum() - 0.5 * A.shape[0]) < 1e-5
        assert a.min() >= -1e-6 and a.max() <= 1 + 1e-6


def _jax_shift(al, be):
    """The spectral shift of grakel_tpu.ops.svm_qp._build_solver
    (:109-123) on given Lanczos coefficients."""
    al, be = jnp.asarray(al), jnp.asarray(be)
    S, m = al.shape
    r = jnp.arange(m)
    T = jnp.zeros((S, m, m), jnp.float32)
    T = T.at[:, r, r].set(al)
    T = T.at[:, r[:-1], r[1:]].set(be[:, :m - 1])
    T = T.at[:, r[1:], r[:-1]].set(be[:, :m - 1])
    ev = jnp.linalg.eigvalsh(T)
    lmin, lmax = ev[:, 0], ev[:, -1]
    cond = lmin < -1e-6
    scale = jnp.where(cond, -1.0 / jnp.where(cond, lmin, -1.0), 1.0)
    dadd = jnp.where(cond, 1.0, 0.0)
    L = 1.05 * scale * jnp.maximum(lmax, 0.0) + dadd + 1e-3
    return [np.asarray(x) for x in (scale, dadd, L)]


@pytest.mark.parametrize("ulps", [-4, -1, 0, 1, 4])
def test_spectral_shift_at_eig_tol_edge_matches_jax(ulps):
    """lambda_min within a few ulps of -1e-6, where the shift's condition
    flips: the port's spectral_shift (its extremes and
    shift_from_extremes) equals the JAX program's exactly on diagonal
    tridiagonals (whose eigenvalues are their f32 entries), and on ones
    with a coupling of 1e-7 to 1e-5."""
    x = np.float32(-1e-6)
    for _ in range(abs(ulps)):
        x = np.nextafter(x, np.float32(np.sign(ulps)), dtype=np.float32)
    rng = np.random.RandomState(abs(ulps))
    al = np.zeros((4, 64), np.float32)
    al[:, 0] = x
    al[:, 1:] = rng.rand(4, 63).astype(np.float32) + 0.5
    be = np.zeros((4, 64), np.float32)
    be[2:, 5:20] = np.float32([[1e-7], [1e-5]])
    got = svm_qp.spectral_shift(torch.from_numpy(al), torch.from_numpy(be))
    ref = _jax_shift(al, be)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    lmin, _ = svm_qp.tridiagonal_extremes(torch.from_numpy(al[:2]),
                                          torch.from_numpy(be[:2]))
    assert (lmin.numpy() == x).all()
    assert bool(got[1][0] == 1.0) == bool(x < np.float32(-1e-6))


def test_fista_momenta_match_jax_program():
    """K11's momenta, computed once on the host, equal the JAX FISTA
    loop's (t - 1) / t' sequence (:142-147) bit for bit."""
    def step(t, _):
        tn = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        return tn, (t - 1.0) / tn
    _, ref = jax.lax.scan(step, jnp.float32(1.0), None, length=300)
    got = svm_qp.fista_momenta(300)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("V", [8, 16, 32, 64, 128, 256])
def test_adjacency_bits_round_trip(V):
    """K11's bit rows of K (one index_add_ of each one's bit) give back
    the dense 0/1 K, bit 31 of a word included."""
    rng = np.random.RandomState(V)
    K = (rng.rand(7, V, V) < 0.3).astype(np.float32)
    K[:, :, -1] = 1
    Kb = svm_qp.adjacency_bits(np.flatnonzero(K), 7, V, "cpu")
    assert Kb.dtype == torch.int32 and Kb.shape == (7, V, (V + 31) // 32)
    np.testing.assert_array_equal(svm_qp.dense_from_bits(Kb, V).numpy(), K)


def test_one_class_fista_plain_route_by_slab():
    """one_class_fista_plain (the CPU route's K11 part): spectral_shift
    and fista_plain on the dense K of the bit rows, a slab of 256 graphs
    at a time, equal to the
    plain version over the whole bucket at once (the solve is per
    graph)."""
    rng = np.random.RandomState(2)
    adjm = [_sym(rng.randint(5, 9), 0.4, rng) for _ in range(300)]
    K, u, s, a0 = (torch.from_numpy(x) for x in _slab(adjm, 8))
    al, be = svm_qp.lanczos_plain(K, svm_qp.start_vector(u))
    Kb = svm_qp.adjacency_bits(np.flatnonzero(K.numpy()), 300, 8, "cpu")
    a = svm_qp.one_class_fista_plain(Kb, a0, u, s, al, be, 50)
    ref = svm_qp.fista_plain(K, a0, u, s, *svm_qp.spectral_shift(al, be),
                             50)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- K12 and K13
def test_dr_step_plain_matches_jax_body():
    """K12's plain version against the DR body of _theta_impl (:58-66),
    the eigh shared: Y' = Y + Z - X, X' = proj_affine(Y' + J) and the
    next reflection 2X' - Y', to 1e-5."""
    rng = np.random.RandomState(0)
    B, V = 6, 16
    n = rng.randint(1, V + 1, B)
    E = np.zeros((B, V, V), np.float32)
    mask = np.zeros((B, V, V), np.float32)
    for b in range(B):
        E[b, :n[b], :n[b]] = _sym(n[b], 0.4, rng)
        mask[b, :n[b], :n[b]] = 1
    Y = rng.randn(B, V, V).astype(np.float32)
    X = rng.randn(B, V, V).astype(np.float32)
    Y, X = Y + Y.transpose(0, 2, 1), X + X.transpose(0, 2, 1)
    w, U = np.linalg.eigh(2 * X - Y)
    w, U = w.astype(np.float32), U.astype(np.float32)
    tY, tX, tR = lovasz_sdp.dr_step_plain(
        *(torch.from_numpy(x) for x in (E, n.astype(np.int32), Y, X, w, U)))

    eye = jnp.eye(V)[None]
    dvalid = eye * mask
    keep = (E > 0) | (dvalid > 0)
    nvalid = jnp.maximum(jnp.sum(dvalid, axis=(-2, -1), keepdims=True), 1.0)
    Z = (U * jnp.maximum(w, 0.0)[..., None, :]) @ jnp.swapaxes(U, -1, -2)
    jY = Y + Z - X
    Xk = jnp.where(keep, jY + mask, 0.0)
    tr = jnp.sum(Xk * eye, axis=(-2, -1), keepdims=True)
    jX = Xk + (1.0 - tr) / nvalid * dvalid
    for got, ref in ((tY, jY), (tX, jX), (tR, 2.0 * jX - jY)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def _goldens():
    def cyc(n):
        A = np.zeros((n, n), np.float32)
        for i in range(n):
            A[i, (i + 1) % n] = A[(i + 1) % n, i] = 1
        return A
    c7 = np.cos(np.pi / 7)
    return [(cyc(5), np.sqrt(5)), (cyc(7), (1 + c7) / c7),
            (np.zeros((6, 6), np.float32), 1.0),
            (1 - np.eye(6, dtype=np.float32), 6.0)]


def test_lovasz_theta_batch_matches_jax_and_goldens():
    """theta and the snapped dual slack S against grakel_tpu's
    lovasz_theta_batch (atol 1e-4), and closed-form goldens: theta(C5) =
    sqrt(5), theta(C7), the empty and the complete graph."""
    rng = np.random.RandomState(1)
    for V, B in ((8, 9), (16, 7), (32, 3)):
        ns = rng.randint(2, V + 1, B)
        adjs = np.zeros((B, V, V), np.float32)
        for b in range(B):
            adjs[b, :ns[b], :ns[b]] = _sym(ns[b], 0.4, rng)
        t, S = lovasz_sdp.lovasz_theta_batch(adjs, ns, device="cpu")
        jt, jS = jsdp.lovasz_theta_batch(adjs, ns)
        np.testing.assert_allclose(t, jt, atol=1e-4)
        np.testing.assert_allclose(S, jS, atol=1e-4)
    for A, want in _goldens():
        n = A.shape[0]
        adjs = np.zeros((1, 8, 8), np.float32)
        adjs[0, :n, :n] = A
        t, _ = lovasz_sdp.lovasz_theta_batch(adjs, [n], device="cpu")
        assert abs(t[0] - want) < 1e-4, (want, t[0])


def test_theta_cpu_route_ignores_the_start_basis(monkeypatch):
    """On the CPU the DR loop's eigendecomposition is torch.linalg.eigh
    (the plain version), which takes no start basis: sym_eigh with and
    without one, and _theta (which passes each step's basis on) and the
    same loop on torch.linalg.eigh alone, give the same values bit for
    bit."""
    rng = np.random.RandomState(3)
    M = rng.randn(5, 16, 16).astype(np.float32)
    M = torch.from_numpy(M + M.transpose(0, 2, 1))
    w, U = lovasz_sdp.sym_eigh(M)
    w2, U2 = lovasz_sdp.sym_eigh(M, U)
    assert torch.equal(w, w2) and torch.equal(U, U2)
    ns = rng.randint(3, 17, 5)
    adjs = np.zeros((5, 16, 16), np.float32)
    for b in range(5):
        adjs[b, :ns[b], :ns[b]] = _sym(ns[b], 0.4, rng)
    E = torch.from_numpy(adjs)
    n = torch.from_numpy(ns.astype(np.int32))
    t, S = lovasz_sdp._theta(E, n, 40, 1.0)
    monkeypatch.setattr(lovasz_sdp, "sym_eigh",
                        lambda M, U0=None: torch.linalg.eigh(M))
    t2, S2 = lovasz_sdp._theta(E, n, 40, 1.0)
    assert torch.equal(t, t2) and torch.equal(S, S2)


def _dr_reflections(adjs, ns, iters):
    """The plain DR loop in numpy f64 (eigh each step): the reflections R
    [iters, B, V, V] and each step's eigenvectors."""
    B, V, _ = adjs.shape
    valid = np.arange(V)[None, :] < ns[:, None]
    J = (valid[:, :, None] & valid[:, None, :]).astype(np.float64)
    dvalid = np.eye(V)[None] * valid[:, None, :]
    keep = (adjs > 0) | (dvalid > 0)
    nvalid = np.maximum(valid.sum(1), 1)[:, None, None]

    def proj_affine(M):
        X = np.where(keep, M, 0.0)
        tr = np.trace(X, axis1=1, axis2=2)[:, None, None]
        return X + (1.0 - tr) / nvalid * dvalid
    Y = np.zeros((B, V, V))
    Rs, Us = [], []
    for _ in range(iters):
        X = proj_affine(Y + J)
        R = 2 * X - Y
        w, U = np.linalg.eigh(R)
        Rs.append(R)
        Us.append(U)
        Y = Y + (U * np.maximum(w, 0)[:, None, :]) @ U.transpose(0, 2, 1) \
            - X
    return Rs, Us


def test_warm_start_model_leaves_small_off_diagonal_mass():
    """A model of K14's warm start on the plain DR loop (numpy, test side
    only): the reflection R_k rotated into step k-1's eigenvectors, B =
    U^T R_k U, is nearly diagonal, its off-diagonal share of the mass
    far below the identity start's (which is the whole R's), and falling
    as the loop settles.  A Jacobi sweep squares that share, so a few
    sweeps reach the f32 stop where a cold start needs many."""
    rng = np.random.RandomState(0)
    B, V = 12, 16
    ns = rng.randint(8, V + 1, B)
    adjs = np.zeros((B, V, V))
    for b in range(B):
        adjs[b, :ns[b], :ns[b]] = _sym(ns[b], 0.3, rng)
    Rs, Us = _dr_reflections(adjs, ns, 300)

    def off_share(M):
        off = M - np.diagonal(M, axis1=1, axis2=2)[:, :, None] * np.eye(V)
        return np.sqrt((off ** 2).sum((1, 2)) / (M ** 2).sum((1, 2)))
    warm = {k: off_share(Us[k - 1].transpose(0, 2, 1) @ Rs[k] @ Us[k - 1])
            for k in (2, 10, 50, 150, 299)}
    cold = {k: off_share(Rs[k]) for k in warm}
    for k in warm:
        assert (warm[k] < 0.5 * cold[k]).all(), (k, warm[k], cold[k])
    assert warm[150].max() < 1e-2 and warm[299].max() < 1e-3
    assert warm[299].max() < warm[10].max()


@pytest.mark.parametrize("d,m,ties", [(3, 8, True), (9, 8, True),
                                      (17, 8, True), (17, 5, False),
                                      (40, 8, False)])
def test_min_cone_plain_matches_jax(d, m, ties):
    """K13's plain version against _min_cone_jit: with exact ties (two
    distinct points, the first repeated as padding, as a 2-subset of
    LovaszTheta is) up to 17 rows, where XLA-CPU sums the distances in
    the same order, and on points in general position at any d, to
    1e-6."""
    rng = np.random.RandomState(d + m)
    A = rng.randn(200, d, m).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    if ties:
        A[:, :, 2:] = A[:, :, :1]
    t = lovasz_sdp.min_cone_plain(torch.from_numpy(A)).numpy()
    jt = np.asarray(jlov._min_cone_jit(A, 400))[:200]
    np.testing.assert_allclose(t, jt, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- classes
@pytest.fixture(scope="module")
def graphs():
    """Unlabeled random graphs of 4-16 vertices (the labelling has at most
    17 rows), fit 20, transform 8."""
    rng = np.random.RandomState(0)
    gs = [[_sym(n, 0.35, rng), {i: "a" for i in range(n)}]
          for n in rng.randint(4, 17, 28)]
    return gs[:20], gs[20:]


def _run(k, fit, tr):
    K = k.fit_transform(fit)
    d0 = k.diagonal()
    T = k.transform(tr)
    xd, yd = k.diagonal()
    np.testing.assert_array_equal(d0, xd)
    return K, T, xd, yd


def _pair(name, params, fit, tr, share=None):
    """(port on the CPU, grakel_tpu) outputs and both fitted kernels;
    ``share`` installs the JAX package's half on the port's kernel."""
    kt = getattr(grakel_torch, name)(**params)
    kj = getattr(grakel_tpu, name)(**params)
    if share:
        share(kt)
    with use_device("cpu"):
        got = _run(kt, fit, tr)
    return got, _run(kj, fit, tr), kt, kj


def _jax_alphas(k):
    k._alphas_batch = jsvm.one_class_alphas


def _jax_sdp(k):
    """The port's per-bucket SDP taken from grakel_tpu (its LovaszTheta
    parse, :155-172)."""
    def sdp(adjm):
        buckets = {}
        for i, A in enumerate(adjm):
            V = max(4, 1 << (max(A.shape[0] - 1, 1)).bit_length())
            buckets.setdefault(V, []).append(i)
        th, sl = [None] * len(adjm), [None] * len(adjm)
        for V, idxs in buckets.items():
            batch = np.zeros((len(idxs), V, V), np.float32)
            ns = [adjm[i].shape[0] for i in idxs]
            for b, i in enumerate(idxs):
                batch[b, :ns[b], :ns[b]] = np.abs(adjm[i]) > 1e-10
            t, S = jsdp.lovasz_theta_batch(batch, ns)
            for b, i in enumerate(idxs):
                th[i] = float(t[b])
                sl[i] = np.asarray(S[b][:ns[b], :ns[b]], np.float64)
        return th, sl
    k._sdp = sdp


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("name,params,share", [
    ("SvmTheta", {"random_state": 3}, _jax_alphas),
    ("SvmTheta", {"random_state": 5, "n_samples": 20,
                  "subsets_size_range": (3, 5)}, _jax_alphas),
    ("LovaszTheta", {"random_state": 3, "max_dim": 16}, _jax_sdp),
    ("LovaszTheta", {"random_state": 8, "max_dim": 16, "n_samples": 30,
                     "subsets_size_range": (2, 4)}, _jax_sdp)])
def test_theta_classes_match_jax(graphs, name, params, share, normalize):
    """fit_transform, transform and the diagonals at rtol 1e-5 on the
    JAX package's solver half (alphas / SDP), the same random_state:
    the host draws agree exactly (the generators end in the same
    state)."""
    fit, tr = graphs
    got, ref, kt, kj = _pair(name, dict(params, normalize=normalize), fit,
                             tr, share)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)
    st, sj = kt.random_state_.get_state(), kj.random_state_.get_state()
    assert st[0] == sj[0] and np.array_equal(st[1], sj[1]) \
        and st[2:] == sj[2:]


@pytest.mark.parametrize("name,params,rtol", [
    ("SvmTheta", {"random_state": 3}, 2e-3),
    ("LovaszTheta", {"random_state": 3, "max_dim": 16}, 1e-2)])
def test_theta_classes_end_to_end(graphs, name, params, rtol):
    """The port's own solvers end to end against grakel_tpu: SvmTheta to
    the solve's 2e-3 (the JAX package's bound against libsvm), Lovasz-
    Theta to 1e-2 (the SDP's last bits decide the cone iteration's ties,
    which move a subset's cosine by up to ~1e-3)."""
    fit, tr = graphs
    got, ref, _, _ = _pair(name, params, fit, tr)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("cls,names", [
    ("LovaszTheta", ("lovasz_theta", "lovasz-theta", "LOVT")),
    ("SvmTheta", ("svm_theta", "svm-theta", "SVMT")),
    ("MultiscaleLaplacian", ("multiscale_laplacian", "ML")),
    ("GraphHopper", ("graph_hopper", "GH"))])
def test_graph_kernel_resolves_aliases(cls, names):
    for name in names:
        gk = GraphKernel(kernel={"name": name}, random_state=1)
        gk.initialize()
        assert type(gk.kernel_).__name__ == cls
        if cls != "GraphHopper":
            assert gk.kernel_.random_state == 1


@pytest.mark.parametrize("name,params", [
    ("SvmTheta", {"random_state": 3}),
    ("LovaszTheta", {"random_state": 3, "max_dim": 16})])
def test_theta_state_carry(graphs, name, params):
    """A fitted grakel_tpu kernel's state (features, labelling rows, the
    generator after fit) carried into the port: the transform equals the
    JAX package's on the JAX package's solver half."""
    fit, tr = graphs
    kj = getattr(grakel_tpu, name)(**params)
    kj.fit(fit)
    state = {"X": kj.X, "random_state": kj.random_state_.get_state()}
    if name == "LovaszTheta":
        state["d"] = kj.d_
    kt = kernel_from_state(name, params, state)
    (_jax_alphas if name == "SvmTheta" else _jax_sdp)(kt)
    with use_device("cpu"):
        T = kt.transform(tr)
    np.testing.assert_allclose(T, kj.transform(tr), rtol=1e-5, atol=1e-12)
