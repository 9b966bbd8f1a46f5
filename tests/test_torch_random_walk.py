"""grakel_torch's RandomWalk and RandomWalkLabeled against grakel_tpu on
JAX-CPU, route by route, and the plain versions of K8 (the pair CG
solve) and K9 (the spectral tile) against the JAX programs they replace.

Tolerances, each with its reason:

* the host moment route (rho <= 0.9) is the same numpy f64 arithmetic:
  equal;
* the f32 device routes (CG, p-step, the spectral exponential and
  p-step forms, the dense baselines) sum in another order, and the
  baselines solve or exponentiate with other routines than XLA's: rtol
  1e-4, atol 1e-4 (observed up to ~4e-6 relative);
* the spectral tile route (rho > 0.9): where lamda mu nu passes 1 the
  denominators cross zero; the JAX program rounds them in f32 and is off
  by up to ~2 % on the NCI1-scale graphs, while the port evaluates the
  closed form in f64.  Both are held against an f64 numpy evaluation of
  the closed form on the same f32 spectra: the port to rtol 1e-9, and
  never farther from it than the JAX package.
"""

import os

import jax
import numpy as np
import pytest
import torch

import grakel_torch
import grakel_tpu
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.ops import random_walk as trw
from grakel_tpu.kernels import random_walk as jrw

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def mutag():
    return read_data("MUTAG", path=DATA).data


@pytest.fixture(scope="module")
def nci():
    """NCI1-scale graphs (the generator of bench.py, 10-50 vertices): rho
    is ~6 at lamda = 0.1, the spectral tile route."""
    return generate_dataset(n_graphs=48, n_graphs_test=8,
                            r_vertices=(10, 50), r_connectivity=(0.07, 0.15),
                            random_state=1234, features=("nl", 37))


def _directed(data, seed):
    """Each undirected edge kept in one direction, picked at random."""
    rng = np.random.RandomState(seed)
    out = []
    for g in data:
        A = grakel_torch.Graph(*g[:2]).get_adjacency_matrix() \
            if not hasattr(g, "get_adjacency_matrix") \
            else g.get_adjacency_matrix()
        U = np.triu(A, 1)
        flip = rng.rand(*A.shape) < 0.5
        out.append([np.where(flip, U, 0) + np.where(flip, 0, U).T,
                    {i: 0 for i in range(A.shape[0])}, {}])
    return out


def _run(mod, name, params, fit, tr):
    k = getattr(mod, name)(**params)
    with use_device("cpu"):
        K = k.fit_transform(fit)
        T = k.transform(tr)
        xd, yd = k.diagonal()
    return k, (K, T, xd, yd)


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# --------------------------------------------------------------------- #
# every route through the classes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name,params,n_fit", [
    ("RandomWalk", {"p": 3}, 12),
    ("RandomWalk", {"p": 2, "kernel_type": "exponential"}, 12),
    ("RandomWalk", {"kernel_type": "exponential"}, 12),
    ("RandomWalk", {"method_type": "baseline", "lamda": 0.01}, 6),
    ("RandomWalk", {"method_type": "baseline", "lamda": 0.01,
                    "kernel_type": "exponential"}, 6),
    ("RandomWalk", {"method_type": "baseline", "p": 3}, 6),
    ("RandomWalkLabeled", {}, 20),
    ("RandomWalkLabeled", {"normalize": True}, 12),
    ("RandomWalkLabeled", {"p": 3}, 12),
    ("RandomWalkLabeled", {"method_type": "baseline", "lamda": 0.01}, 6),
    ("RandomWalkLabeled", {"method_type": "baseline", "lamda": 0.01,
                           "kernel_type": "exponential"}, 6)], ids=str)
def test_device_routes_match_jax(mutag, name, params, n_fit):
    fit, tr = mutag[:n_fit], mutag[n_fit:n_fit + 5]
    _, ours = _run(grakel_torch, name, params, fit, tr)
    _, ref = _run(grakel_tpu, name, params, fit, tr)
    _close(ours, ref)


@pytest.mark.parametrize("lamda,which", [(0.1, "mutag"), (0.01, "nci")])
def test_unlabeled_cg_on_directed_graphs_matches_jax(mutag, nci, lamda,
                                                     which):
    """Directed adjacencies have no spectral closed form: the pair CG
    route (K8's plain version).  On the NCI1-scale graphs lamda = 0.1
    makes the walk series diverge and CG gives no meaningful value in
    either package, so they run at 0.01."""
    data = mutag[:16] if which == "mutag" else nci[0][:16]
    fit, tr = _directed(data[:12], 0), _directed(data[12:], 1)
    params = {"lamda": lamda}
    k, ours = _run(grakel_torch, "RandomWalk", params, fit, tr)
    _, ref = _run(grakel_tpu, "RandomWalk", params, fit, tr)
    assert k._spectral_log == []        # never the spectral path
    _close(ours, ref)


@pytest.mark.parametrize("lamda", [0.01, 0.1])
def test_moment_route_equals_jax(mutag, nci, lamda):
    """rho <= 0.9: f64 moment features on the host, the same numpy."""
    data = mutag if lamda == 0.1 else nci[0]
    fit, tr = data[:20], data[20:26]
    k, ours = _run(grakel_torch, "RandomWalk", {"lamda": lamda}, fit, tr)
    _, ref = _run(grakel_tpu, "RandomWalk", {"lamda": lamda}, fit, tr)
    assert [c["route"] for c in k._spectral_log] == ["moments"] * 3
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def _closed_form(rows, cols, lamda):
    K = np.zeros((len(rows), len(cols)))
    for a, x in enumerate(rows):
        for b, y in enumerate(cols):
            s1, m1 = (np.asarray(x[k], np.float64) for k in ("s2", "mu"))
            s2, m2 = (np.asarray(y[k], np.float64) for k in ("s2", "mu"))
            K[a, b] = (s1[:, None] * s2[None, :]
                       / (1 - lamda * m1[:, None] * m2[None, :])).sum()
    return K


@pytest.mark.parametrize("normalize", [False, True])
def test_spectral_tile_route_against_closed_form(nci, normalize,
                                                 monkeypatch):
    """The tile route on NCI1-scale graphs, a plan of tiles of 8 graphs
    (the fit Gram's 21 tiles on or above the diagonal of the size-ordered
    Gram, mirrored in plan order): the port to rtol 1e-9 of the f64
    closed form, and no farther from it than the JAX package on any
    entry."""
    train, test = nci
    monkeypatch.setattr(grakel_torch.RandomWalk, "_SPEC_TILE", 8)
    params = {"normalize": normalize}
    k, ours = _run(grakel_torch, "RandomWalk", params, train, test)
    _, ref = _run(grakel_tpu, "RandomWalk", params, train, test)
    log = k._spectral_log
    assert {c["route"] for c in log} == {"tile"} and log[0]["rho"] > 1
    assert log[0]["tiles"] > 3
    K = _closed_form(k.X, k.X, 0.1)
    T = _closed_form(k._Y, k.X, 0.1)
    xd, yd = np.diagonal(K), np.diagonal(_closed_form(k._Y, k._Y, 0.1))
    if normalize:
        with np.errstate(invalid="ignore"):   # self-kernels below zero
            K = K / np.sqrt(np.outer(xd, xd))
            T = T / np.sqrt(np.outer(yd, xd))
    for a, b, exact in zip(ours, ref, (K, T, xd, yd)):
        # NaN where a normalization pairs self-kernels of opposite sign
        # (the series diverges); the same entries in all three
        np.testing.assert_allclose(a, exact, rtol=1e-9, atol=0)
        assert np.array_equal(np.isnan(b), np.isnan(exact))
        ok = np.isnan(exact) | (np.abs(a - exact)
                                <= np.abs(b - exact) + 1e-9 * np.abs(exact))
        assert ok.all()


def test_large_graphs_moments_only(mutag):
    """A graph over _EIG_MAX_N vertices takes 40 power iterations and the
    walk moments: the moment route while rho <= 0.9, the pair CG route
    (a 1024 bucket) above, as in the JAX package."""
    rng = np.random.RandomState(3)
    n = 530
    A = (rng.rand(n, n) < 4.0 / n).astype(float)
    A = np.triu(A, 1)
    big = [A + A.T, {v: "C" for v in range(n)}, {}]
    fit, tr = mutag[:3] + [big], mutag[3:5]
    for lamda, route in ((0.005, "moments"), (0.035, "cg")):
        k, ours = _run(grakel_torch, "RandomWalk", {"lamda": lamda}, fit, tr)
        _, ref = _run(grakel_tpu, "RandomWalk", {"lamda": lamda}, fit, tr)
        assert k._spectral_log[0]["route"] == route
        assert k.X[3].get("moments_only")
        _close(ours, ref)


def test_graph_kernel_rw_and_rwl_match_jax(mutag):
    fit, tr = mutag[:10], mutag[10:14]
    for spec in ("RW", {"name": "RWL", "lamda": 0.05},
                 {"name": "random_walk", "p": 2}):
        out = []
        for mod in (grakel_torch, grakel_tpu):
            gk = mod.GraphKernel(kernel=spec, normalize=True)
            with use_device("cpu"):
                out.append((gk.fit_transform(fit), gk.transform(tr)))
        _close(*out)
    from grakel_torch.graph_kernels import _registry
    reg = _registry()
    assert reg["RW"] is grakel_torch.RandomWalk
    assert reg["RWL"] is grakel_torch.RandomWalkLabeled


# --------------------------------------------------------------------- #
# the plain versions of K8 and K9 against the JAX programs
# --------------------------------------------------------------------- #

def _pairs(seed, B, V1, V2, labels=0, directed=False):
    rng = np.random.RandomState(seed)
    nx = rng.randint(1, V1 + 1, B)
    ny = rng.randint(1, V2 + 1, B)
    nx[0], ny[0] = V1, V2

    def adj(V, n):
        A = np.zeros((B, V, V), np.float32)
        for b in range(B):
            # mean degree ~3: lamda mu nu stays below 1 at lamda = 0.05,
            # where CG converges (above, both packages' CG is chaotic)
            p = min(0.2, 3.0 / max(n[b], 1))
            M = (rng.rand(n[b], n[b]) < p).astype(np.float32)
            if not directed:
                M = np.triu(M, 1)
                M = M + M.T
            np.fill_diagonal(M, 0)
            A[b, :n[b], :n[b]] = M
        return A
    Ax, Ay = adj(V1, nx), adj(V2, ny)
    Lx = np.full((B, V1), -1, np.int32)
    Ly = np.full((B, V2), -2, np.int32)
    if labels:
        for b in range(B):
            Lx[b, :nx[b]] = rng.randint(0, labels, nx[b])
            Ly[b, :ny[b]] = rng.randint(0, labels, ny[b])
    return Ax, Ay, nx.astype(np.int32), ny.astype(np.int32), Lx, Ly


def _mask(n, V):
    return (np.arange(V)[None, :] < n[:, None]).astype(np.float32)


def _identity(B):
    """The pair list (k, k): a batch of pairs as two tables."""
    k = torch.arange(B, dtype=torch.int32)
    return k, k


@pytest.mark.parametrize("V1,V2,directed", [(8, 16, False), (32, 32, False),
                                            (16, 64, True)])
def test_pair_cg_plain_matches_cg_geometric(V1, V2, directed):
    Ax, Ay, nx, ny, _, _ = _pairs(V1 + V2, 24, V1, V2, directed=directed)
    lamda = 0.05
    ref = jax.vmap(lambda a, b, c, d: jrw._pair_cg_geometric(
        a, b, c, d, lamda))(Ax, Ay, _mask(nx, V1), _mask(ny, V2))
    ours = trw.pair_cg_plain(*(torch.from_numpy(x) for x in
                               (Ax, Ay, nx, ny)), *_identity(24), lamda)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("V1,V2,L", [(16, 16, 3), (32, 16, 7), (64, 64, 5)])
def test_pair_cg_plain_labeled_matches_cg_labeled(V1, V2, L):
    Ax, Ay, nx, ny, Lx, Ly = _pairs(V1 * V2 + L, 16, V1, V2, labels=L)
    lamda = 0.05
    ref = jax.vmap(lambda a, b, c, d, e, f: jrw._pair_cg_labeled(
        a, b, c, d, e, f, L, lamda))(Ax, Ay, Lx, Ly, _mask(nx, V1),
                                     _mask(ny, V2))
    t = [torch.from_numpy(x) for x in (Ax, Ay, nx, ny, Lx, Ly)]
    ours = trw.pair_cg_plain(t[0], t[1], t[2], t[3], *_identity(16), lamda,
                             t[4], t[5], L)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_pair_cg_freezes_and_guards_as_jax():
    """A pair of edgeless graphs converges in one step (then freezes); a
    1 x 1 pair is exact; the value equals the JAX program's."""
    B, V = 3, 8
    Ax = np.zeros((B, V, V), np.float32)
    Ay = np.zeros((B, V, V), np.float32)
    nx = np.array([1, 5, 8], np.int32)
    ny = np.array([1, 3, 8], np.int32)
    ours = trw.pair_cg_plain(*(torch.from_numpy(x) for x in
                               (Ax, Ay, nx, ny)), *_identity(B), 0.1)
    np.testing.assert_array_equal(ours.numpy(), (nx * ny).astype(np.float32))
    ref = jax.vmap(lambda a, b, c, d: jrw._pair_cg_geometric(a, b, c, d, 0.1)
                   )(Ax, Ay, _mask(nx, V), _mask(ny, V))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_spectral_tile_plain_against_closed_form_and_jax(nci):
    """On the NCI1-scale spectra at lamda = 0.1 (poles inside the range):
    the plain version to rtol 1e-12 of numpy's f64 closed form, no
    farther from it than ``_rw_spectral_tile`` on any entry."""
    with use_device("cpu"):
        k = grakel_torch.RandomWalk().fit(nci[0])
    items = k.X
    V = max(trw.bucket(it["n"]) for it in items)
    s2 = np.zeros((len(items), V), np.float32)
    mu = np.zeros((len(items), V), np.float32)
    n = np.array([it["n"] for it in items], np.int32)
    for a, it in enumerate(items):
        s2[a, :it["n"]] = it["s2"]
        mu[a, :it["n"]] = it["mu"]
    exact = _closed_form(items, items, 0.1)
    t = [torch.from_numpy(x) for x in (s2, mu, n)]
    ours = trw.spectral_tile_plain(t[0], t[1], t[2], t[0], t[1], t[2], 0.1)
    assert ours.dtype == torch.float64
    ref = np.asarray(jrw._rw_spectral_tile(s2, mu, s2, mu, 0.1),
                     np.float64)
    np.testing.assert_allclose(ours.numpy(), exact, rtol=1e-12, atol=0)
    err_ours = np.abs(ours.numpy() - exact)
    err_jax = np.abs(ref - exact)
    assert err_jax.max() > 1e3 * err_ours.max()
    assert (err_ours <= err_jax + 1e-12 * np.abs(exact)).all()
    # the plain Gram over a plan of 8-graph tiles: the same terms, summed
    # over other paddings, so held as the tile route is (rtol 1e-9)
    plan = trw.spectral_plan(n, None, True, 8)
    spec = trw.pack_spectra([it["s2"] for it in items],
                            [it["mu"] for it in items], plan.order_r, "cpu")
    gram = trw.spectral_gram(spec, spec, plan, 0.1)
    np.testing.assert_allclose(gram.numpy(), exact, rtol=1e-9, atol=0)


@pytest.mark.parametrize("mu,exponential", [((1.0, 0.1, 0.01), False),
                                            (None, True)])
def test_pair_spectral_and_pstep_match_jax(mu, exponential):
    Ax, Ay, nx, ny, Lx, Ly = _pairs(5, 12, 16, 8, labels=3)
    rng = np.random.RandomState(1)
    ux, wx = rng.rand(12, 16).astype(np.float32), rng.randn(12, 16).astype(
        np.float32)
    uy, wy = rng.rand(12, 8).astype(np.float32), rng.randn(12, 8).astype(
        np.float32)
    mu_t = mu or (1.0,)
    ref = jax.vmap(lambda a, b, c, d: jrw._pair_spectral(
        a, b, c, d, 0.1, mu_t, exponential))(ux, wx, uy, wy)
    ours = trw.pair_spectral(*(torch.from_numpy(x) for x in
                               (ux, wx, uy, wy)), 0.1, mu_t, exponential)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    if mu is None:
        return
    bx, by = _mask(nx, 16), _mask(ny, 8)
    t = {k: torch.from_numpy(v) for k, v in
         dict(Ax=Ax, Ay=Ay, nx=nx, ny=ny, Lx=Lx, Ly=Ly).items()}
    ref = jax.vmap(lambda a, b, c, d: jrw._pair_pstep(a, b, c, d, mu))(
        Ax, Ay, bx, by)
    np.testing.assert_allclose(
        trw.pair_pstep(t["Ax"], t["Ay"], t["nx"], t["ny"], mu).numpy(),
        np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref = jax.vmap(lambda a, b, c, d, e, f: jrw._pair_pstep_labeled(
        a, b, c, d, e, f, 3, mu))(Ax, Ay, Lx, Ly, bx, by)
    np.testing.assert_allclose(
        trw.pair_pstep_labeled(t["Ax"], t["Ay"], t["Lx"], t["Ly"], t["nx"],
                               t["ny"], mu).numpy(),
        np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_k8_routes_and_smem():
    """The shared route holds every matrix of a pair up to 64 x 64; a
    larger bucket takes the global route."""
    assert trw.cg_route(64, 64, True) == "shared"
    assert trw.cg_route(64, 128, False) == "global"
    assert trw.cg_route(512, 16, False) == "global"
    assert trw.k8_smem_bytes(64, 64, False) == 8704 + 4 * 7 * 4096
    assert trw.k8_smem_bytes(64, 64, True) <= trw.K8_SMEM_MAX
    assert [trw.bucket(n) for n in (1, 8, 9, 16, 17, 33, 65)] \
        == [8, 8, 16, 16, 32, 64, 128]


def test_k8_global_grid_fits_its_scratch():
    """The global route's grid: every pair a block up to the resident
    blocks, then fewer blocks (each looping over more pairs) once their
    scratch slots would pass a quarter of the free memory; at least
    one."""
    free = 80 << 30
    assert trw.k8_global_grid(40, 128, 128, free) == 40
    assert trw.k8_global_grid(10 ** 5, 128, 128, free) \
        == trw.K8_GLOBAL_BLOCKS
    for V in (2048, 4096):
        grid = trw.k8_global_grid(10 ** 5, V, V, free)
        assert 1 <= grid < trw.K8_GLOBAL_BLOCKS
        assert grid * 20 * V * V <= trw.K8_SCRATCH_SHARE * free
    assert trw.k8_global_grid(7, 4096, 4096, 1 << 20) == 1


def test_kernel_wrappers_refuse_cpu_tensors():
    Ax, Ay, nx, ny, Lx, Ly = (torch.from_numpy(x) for x in
                              _pairs(2, 4, 8, 8, labels=2))
    with pytest.raises(ValueError, match="CUDA"):
        trw.pair_cg_cuda(Ax, Ay, nx, ny, *_identity(4), 0.1)
    plan = trw.spectral_plan([3, 1, 2], None, True)
    spec = trw.pack_spectra([np.ones(n) for n in (3, 1, 2)],
                            [np.ones(n) for n in (3, 1, 2)], plan.order_r,
                            "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        trw.spectral_gram_cuda(spec, spec, plan, 0.1)


# --------------------------------------------------------------------- #
# K9's tile plan and K8's graph tables
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("symmetric,nr,nc,tile", [
    (True, 1, 1, 32), (True, 70, 70, 32), (True, 45, 45, 8),
    (False, 5, 70, 32), (False, 33, 1, 8), (False, 40, 17, 7)])
def test_spectral_plan_covers_every_pair_once(symmetric, nr, nc, tile):
    """Graphs in ascending size (stable); tiles of at most ``tile`` a side,
    heaviest first; with K9's write rule (symmetric: a <= b in plan
    positions and its mirror) every pair of the Gram is written once."""
    rng = np.random.RandomState(nr + nc + tile)
    n_r = rng.randint(1, 60, nr)
    n_c = n_r if symmetric else rng.randint(1, 60, nc)
    plan = trw.spectral_plan(n_r, None if symmetric else n_c, symmetric,
                             tile)
    for order, n in ((plan.order_r, n_r), (plan.order_c, n_c)):
        assert sorted(order) == list(range(len(n)))
        key = list(zip(n[order], order))
        assert key == sorted(key)
    t = plan.tiles
    assert t.dtype == np.int32 and t.shape[1] == 4
    assert ((t[:, 1] - t[:, 0] >= 1) & (t[:, 1] - t[:, 0] <= tile)).all()
    assert ((t[:, 3] - t[:, 2] >= 1) & (t[:, 3] - t[:, 2] <= tile)).all()
    work = ((t[:, 1] - t[:, 0]) * (t[:, 3] - t[:, 2])
            * n_r[plan.order_r][t[:, 1] - 1] * n_c[plan.order_c][t[:, 3] - 1])
    assert (np.diff(work) <= 0).all()
    count = np.zeros((nr, nc), np.int64)
    for r0, r1, c0, c1 in t:
        a, b = np.meshgrid(np.arange(r0, r1), np.arange(c0, c1),
                           indexing="ij")
        a, b = a.ravel(), b.ravel()
        if symmetric:
            a, b = a[a <= b], b[a <= b]
            off = a != b
            np.add.at(count, (plan.order_c[b[off]], plan.order_r[a[off]]), 1)
        np.add.at(count, (plan.order_r[a], plan.order_c[b]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("order", ["as_generated", "largest_first"])
def test_spectral_gram_plain_against_closed_form(nci, symmetric, order):
    """The plain Gram over a plan of 8-graph tiles on the NCI1-scale
    spectra (poles inside the range at lamda 0.1) equals the f64 closed
    form to rtol 1e-9, as the tile route's test holds it, symmetric (and
    then exactly symmetric) and rectangular.  ``largest_first`` feeds the
    graphs in descending size, so plan order reverses input order: a
    mirror taken in input order instead of plan order fails there."""
    with use_device("cpu"):
        items = grakel_torch.RandomWalk().fit(nci[0]).X
    if order == "largest_first":
        items = sorted(items, key=lambda it: -it["n"])
    rows = items if symmetric else items[5:18]
    cols = items
    plan = trw.spectral_plan([it["n"] for it in rows],
                             [it["n"] for it in cols], symmetric, 8)
    if order == "largest_first":
        assert (plan.order_r[:len(rows) // 2]
                > plan.order_r[len(rows) // 2:].max()).all()
    pack = lambda its, o: trw.pack_spectra(
        [it["s2"] for it in its], [it["mu"] for it in its], o, "cpu")
    spec_r = pack(rows, plan.order_r)
    spec_c = spec_r if symmetric else pack(cols, plan.order_c)
    K = trw.spectral_gram_plain(spec_r, spec_c, plan, 0.1).numpy()
    assert K.shape == (len(rows), len(cols))
    np.testing.assert_allclose(K, _closed_form(rows, cols, 0.1), rtol=1e-9,
                               atol=0)
    if symmetric:
        assert np.array_equal(K, K.T)


def _tables(seed, G1, G2, V1, V2, labels, B):
    """Two random graph tables (mean degree ~3; labels unsorted in [0,
    labels)) and B pairs of their rows, as numpy arrays and the per-graph
    lists they came from."""
    rng = np.random.RandomState(seed)

    def graphs(G, V):
        adjs, labs = [], []
        for _ in range(G):
            n = rng.randint(1, V + 1)
            M = (rng.rand(n, n) < min(0.2, 3.0 / n)).astype(np.float32)
            M = np.triu(M, 1)
            adjs.append(M + M.T)
            labs.append(rng.randint(0, max(labels, 1), n))
        return adjs, labs
    gx, gy = graphs(G1, V1), graphs(G2, V2)
    ia = rng.randint(0, G1, B).astype(np.int32)
    ib = rng.randint(0, G2, B).astype(np.int32)
    return gx, gy, ia, ib


@pytest.mark.parametrize("labels", [0, 4])
def test_pair_cg_plain_tables_equal_batch_bit_for_bit(labels, monkeypatch):
    """The table-and-index plain CG gathers its pairs and runs the batched
    loop: bit for bit the batched loop on the gathered pairs, in one
    chunk and in chunks of 7 pairs (a label a chunk lacks adds exact
    zeros)."""
    gx, gy, ia, ib = _tables(labels + 1, 9, 7, 16, 32, labels, 40)
    lab = lambda g: g[1] if labels else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    A1, n1, L1 = (t(a) for a in trw.cg_table(gx[0], 16, lab(gx)))
    A2, n2, L2 = (t(a) for a in trw.cg_table(gy[0], 32, lab(gy)))
    ia_t, ib_t = t(ia), t(ib)
    a, b = ia_t.long(), ib_t.long()
    want = trw.pair_cg_batch(A1[a], A2[b], n1[a], n2[b], 0.05,
                             None if L1 is None else L1[a],
                             None if L2 is None else L2[b], labels)
    for chunk in (trw.CG_PLAIN_CHUNK, 7):
        monkeypatch.setattr(trw, "CG_PLAIN_CHUNK", chunk)
        got = trw.pair_cg_plain(A1, A2, n1, n2, ia_t, ib_t, 0.05, L1, L2,
                                labels)
        assert torch.equal(got, want)
    empty = torch.zeros(0, dtype=torch.int32)
    assert trw.pair_cg_plain(A1, A2, n1, n2, empty, empty, 0.05, L1, L2,
                             labels).shape == (0,)


@pytest.mark.parametrize("case", ["random", "x_holds_more", "y_holds_more"])
def test_label_sorted_tables_match_cg_labeled(case):
    """Each graph's vertices sorted by label at packing (``cg_table``:
    labels contiguous and ascending, the adjacency permuted to match):
    the plain CG on the tables equals the JAX package's
    ``_pair_cg_labeled`` on the unsorted padded pairs, to the labeled
    test's rtol 1e-5, also where x holds labels y lacks or the reverse."""
    L = 3
    gx, gy, ia, ib = _tables(11 + len(case), 12, 10, 16, 32, L, 30)
    extra = {"x_holds_more": gx, "y_holds_more": gy}.get(case)
    if extra is not None:
        for labs in extra[1]:
            labs[:(len(labs) + 1) // 2] = L    # a label only this side has
    n_labels = L + (extra is not None)
    A1, n1, L1 = trw.cg_table(gx[0], 16, gx[1])
    A2, n2, L2 = trw.cg_table(gy[0], 32, gy[1])
    for g, (adj, labs) in enumerate(zip(*gx)):
        k = len(labs)
        perm = np.argsort(labs, kind="stable")
        assert (np.diff(L1[g, :k]) >= 0).all() and (L1[g, k:] == -1).all()
        assert np.array_equal(A1[g, :k, :k], adj[np.ix_(perm, perm)])
        assert n1[g] == k and not A1[g, k:].any()
    t = torch.from_numpy
    ours = trw.pair_cg_plain(t(A1), t(A2), t(n1), t(n2), t(ia), t(ib), 0.05,
                             t(L1), t(L2), n_labels)

    def padded(g, idx, V, fill):
        A = np.zeros((len(idx), V, V), np.float32)
        Lb = np.full((len(idx), V), fill, np.int32)
        m = np.zeros((len(idx), V), np.float32)
        for b, i in enumerate(idx):
            k = len(g[1][i])
            A[b, :k, :k] = g[0][i]
            Lb[b, :k] = g[1][i]
            m[b, :k] = 1
        return A, Lb, m
    Ax, Lx, bx = padded(gx, ia, 16, -1)
    Ay, Ly, by = padded(gy, ib, 32, -2)
    ref = jax.vmap(lambda a, b, c, d, e, f: jrw._pair_cg_labeled(
        a, b, c, d, e, f, n_labels, 0.05))(Ax, Ay, Lx, Ly, bx, by)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_cg_route_is_warp_exactly_up_to_32():
    """K8's warp route takes every pair of buckets up to 32 x 32 and no
    other; the block routes split the rest by shared memory."""
    for V1 in (1, 8, 16, 31, 32, 33, 64, 128):
        for V2 in (8, 32, 33, 64):
            for labeled in (False, True):
                route = trw.cg_route(V1, V2, labeled)
                assert (route == "warp") == (V1 <= 32 and V2 <= 32)
                if route != "warp":
                    assert route == ("shared" if trw.k8_smem_bytes(
                        V1, V2, labeled) <= trw.K8_SMEM_MAX else "global")
