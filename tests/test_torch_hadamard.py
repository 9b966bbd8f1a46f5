"""grakel_torch's HadamardCode against grakel_tpu on JAX-CPU: the plain
row hash and generation step equal the JAX programs (``_row_hash`` and
the ``segment_sum`` step of ``_device_run``) bit for bit, int32 wrap
included, and the kernel's Grams, transforms and diagonals equal the JAX
package's exactly on both paths (VertexHistogram base on the device,
any other base on the host); past 2^24 they equal the exact integer
Gram."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import hadamard

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.batch import GraphBatch
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.estimator import NotFittedError
from grakel_torch.kernels.base import normalize_input
from grakel_torch.ops import hadamard as hc_ops
from grakel_torch.ops import wl as wl_ops
from grakel_tpu.batch import GraphBatch as JGraphBatch
from grakel_tpu.kernels.base import normalize_input as jax_normalize_input
from grakel_tpu.kernels.hadamard_code import _row_hash as jax_row_hash

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _unsigned(key):
    """(h1, h2) of int64 compaction keys as u32 numpy arrays."""
    return tuple(h.numpy().view(np.uint32) for h in wl_ops.key_hashes(key))


def _codes(seed, n, D, big):
    rng = np.random.RandomState(seed)
    if big:   # the full int32 range, both signs
        return rng.randint(-2 ** 31, 2 ** 31, (n, D), dtype=np.int64) \
            .astype(np.int32)
    return rng.randint(-40, 41, (n, D)).astype(np.int32)


@pytest.mark.parametrize("D,pad,big", [(1, 0, True), (2, 0, False),
                                       (8, 8, True), (32, 0, False),
                                       (64, 64, True), (16, 1008, False)])
def test_row_hash_plain_bit_identical_to_jax(D, pad, big):
    """Per-node tags (the fit dimension on X rows, the transform one on Y
    rows) and rows zero-padded from D to D + pad columns."""
    n = 300
    codes = np.pad(_codes(D + pad, n, D, big), ((0, 0), (0, pad)))
    tags = np.where(np.arange(n) < 170, D, 2 * D + pad).astype(np.uint32)
    key = hc_ops.row_hash_plain(torch.from_numpy(codes),
                                torch.from_numpy(tags.view(np.int32)))
    assert key.dtype == torch.int64 and key.shape == (n,)
    j1, j2 = jax_row_hash(jnp.asarray(codes), jnp.asarray(tags), D + pad)
    h1, h2 = _unsigned(key)
    np.testing.assert_array_equal(h1, np.asarray(j1))
    np.testing.assert_array_equal(h2, np.asarray(j2))
    # the tag takes part: the same rows under another tag hash apart
    other = hc_ops.row_hash_plain(torch.from_numpy(codes),
                                  torch.from_numpy((tags + 1).view(np.int32)))
    assert not torch.equal(key, other)


def _coo(seed, n, e):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, n, e).astype(np.int32)
    r = rng.randint(0, n, e).astype(np.int32)
    ev = rng.rand(e) < 0.8
    s[:10] = r[:10]                     # self-loops
    return s, r, ev


@pytest.mark.parametrize("D,big", [(1, True), (4, False), (64, True)])
def test_hadamard_step_plain_matches_jax_segment_sum(D, big):
    """One propagating generation against ``c + segment_sum(...)`` of the
    JAX program: int32 adds that wrap (codes over the full int32 range
    overflow on most rows), then the row hash of the new rows."""
    n, e = 257, 1500
    codes = _codes(D, n, D, big)
    s, r, ev = _coo(D, n, e)
    off, tgt = wl_ops.csr_from_edges(*map(torch.from_numpy, (s, r, ev)), n)
    tags = np.full(n, D, np.uint32)
    got, key = hc_ops.hadamard_step_plain(
        torch.from_numpy(codes), off, tgt,
        torch.from_numpy(tags.view(np.int32)), True)
    assert got.dtype == torch.int32
    c = jnp.asarray(codes)
    gathered = jnp.where(jnp.asarray(ev)[:, None], c[jnp.asarray(r)],
                         jnp.int32(0))
    want = c + jax.ops.segment_sum(gathered, jnp.asarray(s), num_segments=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if big:
        wide = codes.astype(np.int64).copy()
        np.add.at(wide, s[ev], codes[r[ev]].astype(np.int64))
        assert (np.abs(wide) >= 2 ** 31).any()     # the sums did wrap
    j1, j2 = jax_row_hash(want, jnp.asarray(tags), D)
    h1, h2 = _unsigned(key)
    np.testing.assert_array_equal(h1, np.asarray(j1))
    np.testing.assert_array_equal(h2, np.asarray(j2))
    same, key0 = hc_ops.hadamard_step_plain(
        torch.from_numpy(codes), off, tgt,
        torch.from_numpy(tags.view(np.int32)), False)
    assert torch.equal(same, torch.from_numpy(codes))
    assert torch.equal(key0, hc_ops.row_hash_plain(
        torch.from_numpy(codes), torch.from_numpy(tags.view(np.int32))))


@pytest.mark.parametrize("n_iter", [1, 4])
def test_hadamard_generations_match_jax_device_run(data, n_iter):
    """The keys of every generation over a GraphBatch equal the hash
    pairs of the JAX kernel's ``_device_run`` over its batch, with the
    transform's padded codes and two dimension tags."""
    train, test = data
    kj = grakel_tpu.HadamardCode(n_iter=n_iter)
    kj.fit(train)
    Xj, Yj = kj.X, jax_normalize_input(test)
    enum_t = kj._collect_labels(Yj, extend=True, enum=dict(kj._enum))
    Dx, Dt = kj._hdim(len(kj._enum)), kj._hdim(len(enum_t))
    assert Dt > Dx or Dt == Dx
    D = max(Dx, Dt)
    cx, _ = kj._initial_codes(Xj, kj._enum, D)
    cy, _ = kj._initial_codes(Yj, enum_t, D)
    codes = np.concatenate([cx, cy])
    jb = JGraphBatch.from_graphs(list(Xj) + list(Yj), node_label_enum={})
    N_pad = int(jb.node_labels.shape[0])
    dims = np.full(N_pad, Dt, np.uint32)
    dims[:len(cx)] = Dx
    want = list(kj._device_run(None, codes, dims, jb))
    tb = GraphBatch.from_graphs(normalize_input(list(train) + list(test)),
                                node_label_enum={}, device="cpu")
    assert tb.node_labels.shape[0] == N_pad
    # a table of one row a node, the padding rows one zero row
    table = np.zeros((len(codes) + 1, D), np.int32)
    table[:len(codes)] = codes
    row = np.minimum(np.arange(N_pad), len(codes)).astype(np.int32)
    got = hc_ops.hadamard_generations(
        tb, torch.from_numpy(table), torch.from_numpy(row),
        torch.from_numpy(dims.view(np.int32)), n_iter)
    assert got.shape == (n_iter, N_pad) and got.dtype == torch.int64
    assert len(want) == n_iter
    valid = tb.node_mask.numpy()
    for key, (j1, j2) in zip(got, want):
        h1, h2 = _unsigned(key)
        np.testing.assert_array_equal(h1[valid], np.asarray(j1)[valid])
        np.testing.assert_array_equal(h2[valid], np.asarray(j2)[valid])


def _table_inputs(seed, graphs, D, Dx, big):
    """Initial codes of ``graphs`` as a table and row indices, the
    padding rows on a zero row: with ``Dx`` < D the first half of the
    graphs takes rows of width Dx zero-padded to D (the fit graphs of a
    transform) and tag Dx, the rest (and the padding) width and tag D;
    with ``big`` the codes span the whole int32 range."""
    rng = np.random.RandomState(seed)
    n = sum(g.n for g in graphs)
    nx = sum(g.n for g in graphs[:len(graphs) // 2]) if Dx < D else 0
    T = max(n // 3, 2)
    table = np.zeros((2 * T + 1, D), np.int32)
    table[:T, :Dx] = _codes(seed, T, Dx, big)
    table[T:2 * T] = _codes(seed + 1, T, D, big)
    row = np.concatenate([rng.randint(0, T, nx),
                          rng.randint(T, 2 * T, n - nx)]).astype(np.int32)
    tags = np.full(n, D, np.uint32)
    tags[:nx] = Dx
    return table, row, tags


@pytest.mark.parametrize("D,Dx,n_iter,big", [
    (1, 1, 5, True), (2, 1, 3, False), (4, 4, 2, True), (8, 2, 1, True),
    (16, 16, 4, False), (32, 8, 5, True), (64, 64, 5, True),
    (64, 32, 4, True), (128, 128, 3, False), (256, 64, 2, True),
    (1024, 1024, 2, True), (1024, 512, 1, False)])
def test_hadamard_generations_plain_bit_identical_to_jax(D, Dx, n_iter,
                                                          big):
    """The plain multi-generation version on a table and row indices
    equals the JAX kernel's ``_device_run`` + ``_row_hash`` on the
    materialised codes bit for bit, over every row of the batch (padding
    included): fit tags (one dimension) and transform tags (Dx < D,
    zero-padded rows), codes of a few units or over the whole int32
    range (the sums wrap)."""
    train, _ = generate_dataset(n_graphs=14 if D < 512 else 6,
                                n_graphs_test=1, r_vertices=(0, 25),
                                r_connectivity=(0.05, 0.4),
                                random_state=D + n_iter, features=("nl", 3))
    graphs = normalize_input(train)
    table, row, tags = _table_inputs(D + Dx, graphs, D, Dx, big)
    jb = JGraphBatch.from_graphs(jax_normalize_input(train),
                                 node_label_enum={})
    N_pad = int(jb.node_labels.shape[0])
    dims = np.full(N_pad, D, np.uint32)
    dims[:len(tags)] = tags
    kj = grakel_tpu.HadamardCode(n_iter=n_iter)
    want = list(kj._device_run(None, table[row], dims, jb))
    tb = GraphBatch.from_graphs(graphs, node_label_enum={}, device="cpu")
    assert tb.node_labels.shape[0] == N_pad
    full = np.full(N_pad, len(table) - 1, np.int32)
    full[:len(row)] = row
    got = hc_ops.hadamard_generations_plain(
        torch.from_numpy(table), torch.from_numpy(full), tb.csr_offsets,
        tb.csr_targets, torch.from_numpy(dims.view(np.int32)), n_iter)
    assert got.shape == (n_iter, N_pad) and len(want) == n_iter
    for key, (j1, j2) in zip(got, want):
        h1, h2 = _unsigned(key)
        np.testing.assert_array_equal(h1, np.asarray(j1))
        np.testing.assert_array_equal(h2, np.asarray(j2))
    if big and n_iter > 1:
        wide = table[row].astype(np.int64)
        np.add.at(wide, tb.senders.numpy()[tb.edge_mask.numpy()],
                  table[row][tb.receivers.numpy()[tb.edge_mask.numpy()]])
        assert (np.abs(wide) >= 2 ** 31).any()     # the sums did wrap


# --------------------------------------------------------------------- #
# K6's plan: what the CPU can hold the routes to
# --------------------------------------------------------------------- #

def _shapes(seed, G, nmax):
    rng = np.random.RandomState(seed)
    nv = rng.randint(0, nmax + 1, G)
    ne = np.where(nv > 0, rng.randint(0, 4 * nmax + 1, G), 0)
    ne[rng.rand(G) < 0.1] = 0                         # edgeless graphs
    return nv, ne


def _check_plan(nv, ne, D, n_rows, budget):
    """The plan's invariants: every graph in exactly one chunk or on the
    round route, chunks of whole consecutive graphs within the budget,
    the padding rows in edgeless chunks, the largest chunk's bytes."""
    chunks, rnd, smem = hc_ops.hc_plan(nv, ne, D, n_rows, budget)
    G = len(nv)
    node_at = np.r_[0, np.cumsum(nv)]
    edge_at = np.r_[0, np.cumsum(ne)]
    assert chunks.dtype == np.int32 and chunks.shape[1] == 6
    g0, g1, v0, v1, e0, e1 = chunks.astype(np.int64).T
    data = g0 < G
    owner = np.zeros(G, np.int64)
    for a, b in zip(g0[data], g1[data]):
        assert a < b
        owner[a:b] += 1
    owner[rnd] += 1
    assert (owner == 1).all()
    route = np.array([hc_ops.hc_route(a, b, D, budget) for a, b in
                      zip(nv.tolist(), ne.tolist())])
    assert (route[rnd] == "round").all()
    assert np.flatnonzero(route == "round").tolist() == rnd.tolist()
    assert (v0[data] == node_at[g0[data]]).all()
    assert (v1[data] == node_at[g1[data]]).all()
    assert (e0[data] == edge_at[g0[data]]).all()
    assert (e1[data] == edge_at[g1[data]]).all()
    each = hc_ops.k6_smem_bytes(v1 - v0, e1 - e0, D)
    assert (each[data] <= budget).all()
    assert smem == (int(each.max()) if len(each) else 0)
    sizes = (v1 - v0)[data]
    assert (sizes[:-1] >= sizes[1:]).all()        # largest chunks first
    # the padding rows: edgeless chunks after the graphs', once each
    assert (g0[~data] == G).all() and (g1[~data] == G).all()
    assert (e0[~data] == e1[~data]).all()
    pad = np.zeros(n_rows, np.int64)
    for a, b in zip(v0[~data], v1[~data]):
        pad[a:b] += 1
    assert (pad[:node_at[-1]] == 0).all() and (pad[node_at[-1]:] == 1).all()
    return chunks, rnd


@pytest.mark.parametrize("seed,G,nmax,D,budget", [
    (0, 300, 50, 64, hc_ops.K6_SMEM_BUDGET), (1, 200, 300, 64, 96 * 1024),
    (2, 400, 60, 1, 8 * 1024), (3, 100, 40, 1024, 96 * 1024),
    (4, 150, 120, 8, 24 * 1024), (5, 50, 2000, 32, 200 * 1024),
    (6, 1, 10, 2, 4096), (7, 80, 30, 128, 0)])
def test_hc_plan_invariants(seed, G, nmax, D, budget):
    """Random batches (edgeless and empty graphs among them) at widths
    1-1024 and budgets from none (every graph on the round route) to
    200 KB: the plan's invariants hold, and the chunks are not much
    emptier than the budget allows (the mean chunk of several graphs
    holds at least a third of it)."""
    nv, ne = _shapes(seed, G, nmax)
    chunks, rnd = _check_plan(nv, ne, D, int(nv.sum()) + 1 + seed * 37,
                              budget)
    if budget == 0:
        assert len(rnd) == G
    g0, g1, v0, v1, e0, e1 = chunks.astype(np.int64).T
    multi = (g0 < G) & (g1 - g0 > 1)
    if multi.sum() > 3:
        each = hc_ops.k6_smem_bytes(v1 - v0, e1 - e0, D)[multi]
        assert each.mean() >= budget / 3


def test_hc_plan_mixes_routes():
    """A graph too large for the budget takes the round route alone, the
    graphs around it stay on the graph route, and the chunk on either
    side of it ends there; the same graph under a larger budget is a
    chunk of its own."""
    nv = np.array([30, 40, 300, 20, 45, 3000, 10, 0, 25])
    ne = np.array([90, 100, 1200, 40, 0, 9000, 12, 0, 70])
    D = 64
    assert hc_ops.hc_route(300, 1200, D) == "round"
    assert hc_ops.hc_route(45, 0, D) == "graph"
    chunks, rnd = _check_plan(nv, ne, D, int(nv.sum()) + 5,
                              hc_ops.K6_SMEM_BUDGET)
    assert rnd.tolist() == [2, 5]
    spans = sorted((a, b) for a, b in chunks[:, :2].tolist() if a < 9)
    assert spans == [(0, 2), (3, 5), (6, 9)]
    chunks, rnd = _check_plan(nv, ne, D, int(nv.sum()) + 5, 200 * 1024)
    assert rnd.tolist() == [5]
    assert [2, 3] in chunks[:, :2].tolist()       # 158 KB: a chunk alone


def test_hc_plan_chunks_are_closed(data):
    """What the graph route relies on, emulated with the plain version:
    each chunk's graphs (a rebased slice of the CSR) give their rows'
    keys of the whole batch, the padding chunks' rows keep one key in
    every generation, and the round route's graphs give theirs from their
    own node range."""
    train, test = data
    b = GraphBatch.from_graphs(normalize_input(list(train) + list(test)),
                               node_label_enum={}, device="cpu")
    N = b.node_labels.shape[0]
    D, n_iter = 16, 4
    table = torch.from_numpy(_codes(3, 40, D, True))
    row = torch.from_numpy(np.random.RandomState(4).randint(0, 40, N)
                           .astype(np.int32))
    tag = torch.from_numpy(np.random.RandomState(5).randint(
        0, 2 ** 31, N).astype(np.int32))
    off, tgt = b.csr_offsets, b.csr_targets
    want = hc_ops.hadamard_generations_plain(table, row, off, tgt, tag,
                                             n_iter)
    budget = int(np.sort(hc_ops.k6_smem_bytes(b.n_nodes, b.n_edges, D))[-3])
    chunks, rnd = _check_plan(b.n_nodes, b.n_edges, D, N, budget)
    assert 1 <= len(rnd) <= 2
    got = torch.zeros_like(want)
    spans = [tuple(c) for c in chunks[:, 2:].tolist()]
    spans += [(int(b.node_offsets[g]), int(b.node_offsets[g + 1]),
               int(off[b.node_offsets[g]]), int(off[b.node_offsets[g + 1]]))
              for g in rnd]
    for v0, v1, e0, e1 in spans:
        sub_off = off[v0:v1 + 1] - e0
        sub_tgt = tgt[e0:e1] - v0
        assert ((sub_tgt >= 0) & (sub_tgt < v1 - v0)).all()
        got[:, v0:v1] = hc_ops.hadamard_generations_plain(
            table, row[v0:v1], sub_off, sub_tgt, tag[v0:v1], n_iter)
        if e0 == e1:
            assert (want[:, v0:v1] == want[0, v0:v1]).all()
    assert torch.equal(got, want)


# --------------------------------------------------------------------- #
# the kernel against grakel_tpu
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def data():
    """Train labels 0-4, the test split plants the unseen label 5."""
    return generate_dataset(n_graphs=40, n_graphs_test=8, r_vertices=(3, 14),
                            random_state=13, features=("nl", 6))


@pytest.fixture(scope="module")
def mutag():
    return read_data("MUTAG", path=DATA).data


def _base(mod, base):
    if base is None:
        return None
    name, params = base
    return (getattr(mod, name), dict(params))


def _both(fit, tr, base=None, **kw):
    """Fit / transform / both diagonals on grakel_tpu and on the port
    under use_device('cpu')."""
    out = []
    for mod in (grakel_tpu, grakel_torch):
        k = mod.HadamardCode(base_graph_kernel=_base(mod, base), **kw)
        with use_device("cpu"):
            K = k.fit_transform(fit)
            d = k.diagonal()
            T = k.transform(tr)
            xd, yd = k.diagonal()
        out.append((np.asarray(K), np.asarray(d), np.asarray(T),
                    np.asarray(xd), np.asarray(yd)))
    return out


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("n_iter", [1, 2, 3, 5])
@pytest.mark.parametrize("normalize", [False, True])
def test_hc_vh_grams_equal(data, n_iter, normalize):
    j, t = _both(*data, n_iter=n_iter, normalize=normalize)
    _assert_equal(t, j)


@pytest.mark.parametrize("base", [("ShortestPath", {}),
                                  ("VertexHistogram", {"sparse": True})],
                         ids=["SP", "VH-params"])
@pytest.mark.parametrize("normalize", [False, True])
def test_hc_host_path_grams_equal(data, base, normalize):
    j, t = _both(*data, base=base, n_iter=3, normalize=normalize)
    _assert_equal(t, j)


def test_hc_mutag_planted_label_equal(mutag):
    """MUTAG split, and a transform set whose first vertex carries a
    label unseen at fit (the JAX package's parity test)."""
    j, t = _both(mutag[:60], mutag[60:80], n_iter=3)
    _assert_equal(t, j)
    tr = []
    for edges, nl, el in mutag[30:36]:
        nl2 = dict(nl)
        nl2[next(iter(nl2))] = 999
        tr.append([edges, nl2, el])
    j, t = _both(mutag[:30], tr, n_iter=2)
    _assert_equal(t, j)


def test_hc_dimension_grows_at_transform():
    """Eight fit labels give D = 8; a ninth at transform gives 16, so the
    transform's rows (tag 16) never equal the fit's (tag 8): the
    transform Gram is all zeros, in both packages."""
    train, test = generate_dataset(n_graphs=30, n_graphs_test=6,
                                   r_vertices=(12, 20), random_state=4,
                                   features=("nl", 9))
    j, t = _both(train, test, n_iter=3)
    _assert_equal(t, j)
    with use_device("cpu"):
        k = grakel_torch.HadamardCode(n_iter=3).fit(train)
        assert k._hdim(len(k._enum)) == 8
        T = k.transform(test)
    assert T.shape == (6, 24) and not T.any()
    # without the ninth label the dimensions agree and rows meet
    j, t = _both(train, train[:5], n_iter=3)
    _assert_equal(t, j)
    assert t[2].all()


def test_hc_string_labels_equal(mutag):
    """String labels: the enumeration follows a per-graph ``set``'s
    iteration order, which both packages walk the same way."""
    sm = [[e, {k: "atom-%d" % v for k, v in nl.items()}, el]
          for e, nl, el in mutag]
    tr = [[e, {k: ("new" if k == 0 else v) for k, v in nl.items()}, el]
          for e, nl, el in sm[60:70]]
    j, t = _both(sm[:40], tr, n_iter=3)
    _assert_equal(t, j)
    j, t = _both(sm[:40], tr, base=("ShortestPath", {}), n_iter=2)
    _assert_equal(t, j)


def test_hc_fit_then_diagonal_and_transform(data):
    train, test = data
    kj = grakel_tpu.HadamardCode(n_iter=3).fit(train)
    with use_device("cpu"):
        kt = grakel_torch.HadamardCode(n_iter=3).fit(train)
        assert np.array_equal(kt.diagonal(), kj.diagonal())
        assert np.array_equal(kt.transform(test), kj.transform(test))
        kt2 = grakel_torch.HadamardCode(n_iter=3).fit(train)
        T = kt2.transform(test)     # before any diagonal: fit's from rect
        assert np.array_equal(kt2.diagonal()[0], kj.diagonal()[0])
    assert np.array_equal(T, kj.transform(test))


def test_hc_checks():
    A = np.array([[0, 1], [1, 0]], float)
    with use_device("cpu"):
        with pytest.raises(ValueError, match="requires node labels"):
            grakel_torch.HadamardCode().fit_transform([[A]])
        with pytest.raises(NotFittedError):
            grakel_torch.HadamardCode().transform([[A, {0: 1, 1: 1}]])
        with pytest.raises(NotFittedError):
            grakel_torch.HadamardCode().diagonal()
        for bad in ({"n_iter": 0}, {"n_iter": 2.0},
                    {"base_graph_kernel": "VH"}):
            with pytest.raises(TypeError):
                grakel_torch.HadamardCode(**bad).fit([[A, {0: 1, 1: 1}]])


@pytest.mark.parametrize("spec", [
    "hadamard_code", "HC", {"name": "HC", "n_iter": 2},
    [{"name": "hadamard_code", "n_iter": 2}, "SP"],
    [{"name": "HC", "n_iter": 2}, {"name": "VH", "sparse": True}]], ids=str)
def test_hc_graph_kernel_names(data, spec):
    train, test = data
    out = []
    for mod in (grakel_tpu, grakel_torch):
        gk = mod.GraphKernel(kernel=spec, normalize=True)
        with use_device("cpu"):
            out.append((gk.fit_transform(train), gk.transform(test)))
    assert type(gk.kernel_) is grakel_torch.HadamardCode
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _graph_arrays(graphs):
    return [(g.n, g.senders, g.receivers, g.weights, dict(g.node_labels))
            for g in graphs]


@pytest.mark.parametrize("base", [None, ("ShortestPath", {})],
                         ids=["VH", "SP"])
def test_hc_state_carry(data, base):
    """A JAX-fitted HadamardCode transforms new graphs (one with a label
    unseen at fit) on the port to the JAX package's transform Gram."""
    train, test = data
    kj = grakel_tpu.HadamardCode(
        n_iter=3, base_graph_kernel=_base(grakel_tpu, base)).fit(train)
    state = {"enum": dict(kj._enum), "graphs": _graph_arrays(kj.X)}
    Tj = kj.transform(test)
    params = {"n_iter": 3, "base_graph_kernel": _base(grakel_torch, base)}
    with use_device("cpu"):
        kt = kernel_from_state("HadamardCode", params, state)
        Tt = kt.transform(test)
    assert np.array_equal(Tt, Tj)


# --------------------------------------------------------------------- #
# count width: exact past 2^24
# --------------------------------------------------------------------- #

def _hdim(nl):
    return 1 << max(nl - 1, 0).bit_length()


def _enumerate(graphs, enum):
    for g in graphs:
        for v in set(g.get_labels().values()):
            enum.setdefault(v, len(enum))
    return enum


def _exact_hc_grams(fit, test, n_iter):
    """Exact HadamardCode Grams (fit x fit, test x fit) in int64 numpy:
    Hadamard rows, int64 neighbour sums (no wrap at these sizes), a
    generation's feature is the (dimension tag, code row) pair."""
    gx, gy = normalize_input(fit), normalize_input(test)
    enum = _enumerate(gx, {})
    enum_t = _enumerate(gy, dict(enum))
    Dx, Dt = _hdim(len(enum)), _hdim(len(enum_t))
    D = max(Dx, Dt)
    codes, tags, gid, send, recv, off = [], [], [], [], [], 0
    for i, (g, en, d) in enumerate([(g, enum, Dx) for g in gx]
                                   + [(g, enum_t, Dt) for g in gy]):
        H = hadamard(_hdim(len(en))).astype(np.int64)
        rows = H[[en[g.get_labels()[v]] for v in range(g.n)]]
        codes.append(np.pad(rows, ((0, 0), (0, D - rows.shape[1]))))
        tags.append(np.full(g.n, d))
        gid.append(np.full(g.n, i))
        send.append(g.senders.astype(np.int64) + off)
        recv.append(g.receivers.astype(np.int64) + off)
        off += g.n
    c = np.concatenate(codes)
    tags, gid = np.concatenate(tags), np.concatenate(gid)
    send, recv = np.concatenate(send), np.concatenate(recv)
    n = len(gx) + len(gy)
    K = np.zeros((n, n), np.int64)
    for it in range(n_iter):
        if it:
            new = c.copy()
            np.add.at(new, send, c[recv])
            c = new
        _, ids = np.unique(np.column_stack([tags, c]), axis=0,
                           return_inverse=True)
        C = np.zeros((n, int(ids.max()) + 1), np.int64)
        np.add.at(C, (gid, ids.reshape(-1)), 1)
        K += C @ C.T
    nx = len(gx)
    return K[:nx, :nx], K[nx:, :nx]


@pytest.fixture(scope="module")
def hc_large():
    """Six train graphs of 5802-6374 vertices, all labeled 0 (D = 1):
    entries up to ~1.9e8 at n_iter = 5."""
    train, _ = generate_dataset(
        n_graphs=8, n_graphs_test=2, r_vertices=(5500, 6500),
        r_connectivity=(0.001, 0.002), random_state=3, features=("nl", 2))
    fit, tr = train[:4], train[4:]
    return fit, tr, _exact_hc_grams(fit, tr, 5)


@pytest.mark.parametrize("call", ["fit_transform", "transform"])
def test_hc_counts_exact_past_2_24(hc_large, call):
    """An entry is at most n_iter max_n^2; past 2^24 an f32 sum of counts
    rounds, so the port sums in f64 there, and its Grams and diagonals
    equal the exact integer Gram (the JAX package stays f32)."""
    fit, tr, (Kx, Tx) = hc_large
    assert Kx.max() > 2 ** 24 and Tx.max() > 2 ** 24
    with use_device("cpu"):
        k = grakel_torch.HadamardCode(n_iter=5)
        if call == "fit_transform":
            K = k.fit_transform(fit)
            assert K.dtype == np.float64
            assert np.array_equal(K, Kx.astype(np.float64))
            assert np.array_equal(k.diagonal(), np.diagonal(Kx))
        else:
            T = k.fit(fit).transform(tr)
            assert np.array_equal(T, Tx.astype(np.float64))
            xd, _ = k.diagonal()
            assert np.array_equal(xd, np.diagonal(Kx))
