"""grakel_torch's NeighborhoodHash against grakel_tpu on JAX-CPU: the
plain hashing rounds equal the JAX program ``_nh_rounds`` exactly, the
Jaccard Gram ``jaccard_gram_rounds`` equals the JAX function bit for bit,
``min_intersection_gram_rounds`` equals the Pallas kernel (interpret
mode) round by round, and the kernel's Grams match the JAX package's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.batch import GraphBatch
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.graph import Graph
from grakel_torch.ops import hadamard, intersect, nh
from grakel_tpu.datasets import read_data as jax_read_data
from grakel_tpu.kernels.neighborhood_hash import _nh_rounds as jax_nh_rounds
from grakel_tpu.ops import intersect as jintersect

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _graphs(seed, n_graphs=14):
    """Random directed graphs of 1-15 vertices with both edge directions
    mostly present, an edgeless graph (isolated vertices) and a hub of
    degree 40 (counts o past 2^bits / bits), as port Graphs."""
    rng = np.random.RandomState(seed)
    out = []
    for g in range(n_graphs):
        n = rng.randint(1, 16)
        if g == 0:
            s = r = np.zeros(0, np.int32)
        elif g == 1:
            n = 41
            s = np.zeros(40, np.int32)
            r = np.arange(1, 41, dtype=np.int32)
            s, r = np.concatenate([s, r]), np.concatenate([r, s])
        else:
            A = rng.rand(n, n) < 0.3
            np.fill_diagonal(A, False)
            s, r = np.nonzero(A)
        out.append(Graph.from_arrays(n, s, r, None,
                                     {v: 0 for v in range(n)}))
    return out


def _round_inputs(seed, bits):
    """A port batch on the CPU with random labels below 2^bits, a fifth of
    them invalid (unseen at fit: label 0, as the kernel parses them)."""
    rng = np.random.RandomState(seed)
    graphs = _graphs(seed)
    b = GraphBatch.from_graphs(graphs, node_label_enum={}, device="cpu")
    N = b.node_mask.shape[0]
    # few distinct labels so that count_sensitive sees repeated ones
    lab = rng.randint(0, min(1 << bits, 5), N).astype(np.int64)
    valid = (rng.rand(N) < 0.8) & b.node_mask.numpy()
    lab[~valid] = 0
    return b, lab, valid


@pytest.mark.parametrize("bits", [6, 8])
@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("nh_type", ["simple", "count_sensitive"])
def test_nh_rounds_plain_equals_jax(nh_type, R, bits):
    b, lab, valid = _round_inputs(R * 10 + bits, bits)
    cs = nh_type == "count_sensitive"
    ref = np.asarray(jax_nh_rounds(
        jnp.asarray(lab.astype(np.uint32)), jnp.asarray(valid),
        jnp.asarray(b.node_mask.numpy()),
        jnp.asarray(b.node_graph_ids.numpy()),
        jnp.asarray(b.senders.numpy()), jnp.asarray(b.receivers.numpy()),
        jnp.asarray(b.edge_mask.numpy()), b.n_graphs, R, bits, cs))
    lab_t = torch.from_numpy(lab.astype(np.int32))
    valid_t = torch.from_numpy(valid)
    got = nh.nh_rounds_plain(lab_t, valid_t, b.node_graph_ids,
                             b.csr_offsets, b.csr_targets, b.n_graphs, R,
                             bits, cs)
    assert got.dtype == torch.int32
    assert got.shape == ref.shape == (R, b.n_graphs, 1 << bits)
    assert np.array_equal(got.numpy(), ref)
    # the dispatcher takes the plain version on the CPU
    assert torch.equal(nh.nh_rounds(b, lab_t, valid_t, b.n_graphs, R, bits,
                                    cs), got)
    assert got.sum() > 0


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_rot_plain_matches_jax_rot(bits):
    from grakel_tpu.kernels.neighborhood_hash import _rot
    rng = np.random.RandomState(bits)
    x = rng.randint(0, 1 << 20, 500).astype(np.uint32)
    d = rng.randint(0, 70, 500).astype(np.uint32)
    ref = np.asarray(_rot(jnp.asarray(x), jnp.asarray(d),
                          jnp.uint32(bits), jnp.uint32((1 << bits) - 1)))
    got = nh.rot_plain(torch.from_numpy(x.astype(np.int64)),
                       torch.from_numpy(d.astype(np.int64)), bits)
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


def _hists(seed, R, n, m, L, zero_rows):
    """Integer histograms A [R, n, L], B [R, m, L] and vertex counts at
    least their row sums, with ``zero_rows`` empty graphs (no vertex)."""
    rng = np.random.RandomState(seed)
    A = rng.randint(0, 5, (R, n, L)).astype(np.float32)
    B = rng.randint(0, 5, (R, m, L)).astype(np.float32)
    A[:, rng.rand(n) < 0.3] = 0        # poisoned graphs: no valid node
    va = A[0].sum(1) + rng.randint(0, 4, n)
    vb = B[0].sum(1) + rng.randint(0, 4, m)
    A[:, :zero_rows] = 0
    va[:zero_rows] = 0
    B[:, :zero_rows] = 0
    vb[:zero_rows] = 0
    return A, B, va.astype(np.float64), vb.astype(np.float64)


def _jax_jaccard(A, B, va, vb, sym):
    n, m = A.shape[1], (A if B is None else B).shape[1]
    out = jintersect.jaccard_gram_rounds(A, B, va=va, vb=vb,
                                         symmetrize=sym)
    return np.asarray(out)[:n, :m]


@pytest.mark.parametrize("sym", [True, False])
def test_jaccard_gram_rounds_bit_equal_seed0(sym):
    """R = 3, 70 x 50, L = 64 with empty graphs: the port's fold is
    XLA-CPU's order of IEEE operations, so the Grams are equal bit for
    bit, symmetric and rectangular."""
    A, B, va, vb = _hists(0, 3, 70, 50, 64, 3)
    if sym:
        ref = _jax_jaccard(A, None, va, None, True)
        At = torch.from_numpy(A)
        got = intersect.jaccard_gram_rounds(At, At, va=va, vb=va)
    else:
        ref = _jax_jaccard(A, B, va, vb, False)
        got = intersect.jaccard_gram_rounds(
            torch.from_numpy(A), torch.from_numpy(B), va=va, vb=vb)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed,R,n,m,L,zero,sym", [
    (1, 1, 33, 33, 16, 0, True), (2, 5, 40, 40, 128, 2, True),
    (3, 2, 17, 90, 256, 1, False), (4, 4, 64, 9, 8, 0, False),
    (5, 3, 25, 25, 32, 0, False)])
def test_jaccard_gram_rounds_matches_jax(seed, R, n, m, L, zero, sym):
    A, B, va, vb = _hists(seed, R, n, m, L, zero)
    if sym:
        ref = _jax_jaccard(A, None, va, None, True)
        At = torch.from_numpy(A)
        got = intersect.jaccard_gram_rounds(At, va=va)
    else:
        ref = _jax_jaccard(A, B, va, vb, False)
        got = intersect.jaccard_gram_rounds(
            torch.from_numpy(A), torch.from_numpy(B), va=va, vb=vb)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_jaccard_fold_plain_symmetrizes_and_checks():
    """The fold of a non-symmetric stack with symmetrize is (K + K^T) / 2
    of the unsymmetrized fold; jaccard_gram_rounds refuses non-counts,
    a non-square symmetrization and zero rounds."""
    rng = np.random.RandomState(9)
    C = torch.from_numpy(rng.randint(0, 4, (2, 6, 6)).astype(np.float32))
    va = torch.full((6,), 9.0)
    K = intersect.jaccard_fold_plain(C, va, va, False)
    Ks = intersect.jaccard_fold_plain(C, va, va, True)
    assert torch.equal(Ks, (K + K.T) * 0.5) and torch.equal(Ks, Ks.T)
    A = torch.from_numpy(rng.rand(2, 6, 5).astype(np.float32))
    with pytest.raises(ValueError, match="integer"):
        intersect.jaccard_gram_rounds(A)
    with pytest.raises(ValueError, match="n == m"):
        intersect.jaccard_gram_rounds(A.floor(), A[:, :4].floor(),
                                      symmetrize=True)
    with pytest.raises(ValueError, match="round"):
        intersect.jaccard_gram_rounds(torch.zeros(0, 3, 4))
    empty = intersect.jaccard_gram_rounds(torch.zeros(2, 0, 4),
                                          torch.zeros(2, 3, 4))
    assert empty.shape == (0, 3)


@pytest.mark.parametrize("integer,sym,route", [
    (True, True, "min_gram"), (True, False, "min_gram"),
    (False, False, "min_gram"), (True, True, None), (True, False, None),
    (False, True, None)])
def test_min_intersection_gram_rounds_vs_pallas(integer, sym, route):
    """Each round equals the Pallas kernel in interpret mode, sliced to
    [:n, :m]: integers exactly, reals at K1's tolerance; the stack comes
    back unpadded."""
    rng = np.random.RandomState(int(integer) * 4 + int(sym) * 2)
    R, n, m, L = 3, 19, 23, 40
    A = rng.randint(0, 6, (R, n, L)) if integer else rng.rand(R, n, L)
    B = rng.randint(0, 6, (R, m, L)) if integer else rng.rand(R, m, L)
    A, B = A.astype(np.float32), B.astype(np.float32)
    ref = np.asarray(jintersect.min_intersection_gram_rounds(
        A, None if sym else B, force_pallas=True))
    At = torch.from_numpy(A)
    got = intersect.min_intersection_gram_rounds(
        At, None if sym else torch.from_numpy(B), route=route)
    mm = n if sym else m
    assert got.shape == (R, n, mm) and got.dtype == torch.float32
    ref = ref[:, :n, :mm]
    if integer:
        assert np.array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_min_intersection_gram_rounds_edges(monkeypatch):
    with pytest.raises(ValueError, match="R, n, L"):
        intersect.min_intersection_gram_rounds(torch.zeros(3, 4))
    for route in ("bogus", "min_gram_tc"):
        with pytest.raises(ValueError, match="route"):
            intersect.min_intersection_gram_rounds(torch.zeros(1, 2, 3),
                                                   route=route)
    out = intersect.min_intersection_gram_rounds(torch.zeros(2, 0, 3),
                                                 torch.ones(2, 4, 3))
    assert out.shape == (2, 0, 4)
    # route=None routes each round on the caller's count maxima, read from
    # nothing on the device, as on the maxima it reads itself
    A = torch.tensor([[[1., 2.], [0., 3.]], [[2., 0.], [1., 1.]]])
    ref = intersect.min_intersection_gram_rounds(A)
    assert torch.equal(intersect.min_intersection_gram_rounds(
        A, route=None), ref)
    mx = A.amax(1).numpy()

    def no_read(*_):
        raise AssertionError("count_max given: nothing to read")

    monkeypatch.setattr(intersect, "_round_stats", no_read)
    assert torch.equal(intersect.min_intersection_gram_rounds(
        A, route=None, count_max=(mx, mx)), ref)
    assert torch.equal(ref[0], torch.tensor([[3., 2.], [2., 3.]]))


# --------------------------------------------------------------------- #
# the kernel against grakel_tpu
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def mutag():
    t = read_data("MUTAG", path=DATA).data
    j = jax_read_data("MUTAG", path=DATA).data
    return (t[:60], t[60:80]), (j[:60], j[60:80])


@pytest.mark.parametrize("params", [
    {"random_state": 42}, {"random_state": 42, "nh_type": "count_sensitive"},
    {"random_state": 7, "R": 5, "bits": 6}],
    ids=["simple", "count_sensitive", "R5-bits6"])
@pytest.mark.parametrize("via", ["kernel", "GraphKernel"])
def test_neighborhood_hash_matches_grakel_tpu(mutag, params, via):
    """tests/test_parity.py's parameters and tolerance on MUTAG (fit 60,
    transform 20)."""
    (tf, tt), (jf, jt) = mutag
    kj = grakel_tpu.NeighborhoodHash(**params)
    Kj, Tj = kj.fit_transform(jf), kj.transform(jt)
    with use_device("cpu"):
        if via == "kernel":
            kt = grakel_torch.NeighborhoodHash(**params)
        else:
            kt = grakel_torch.GraphKernel(
                kernel=dict(params, name="NH"))
        Kt, Tt = kt.fit_transform(tf), kt.transform(tt)
        assert kt.diagonal() == (1.0, 1.0)
    assert Kt.shape == (60, 60) and Tt.shape == (20, 60)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nh_type", ["simple", "count_sensitive"])
def test_neighborhood_hash_unseen_labels_bit_equal(nh_type):
    """Generated graphs whose transform split carries a label unseen at
    fit (poisoning its nodes and their neighbours), with more labels
    than 2^bits (the collision warning and draw): the Grams equal the JAX
    package's bit for bit."""
    train, test = generate_dataset(n_graphs=40, n_graphs_test=9,
                                   r_vertices=(1, 14), random_state=3,
                                   features=("nl", 12))
    kw = {"random_state": 5, "nh_type": nh_type, "bits": 3, "R": 4}
    with pytest.warns(UserWarning, match="Collisions"):
        kj = grakel_tpu.NeighborhoodHash(**kw)
        Kj, Tj = kj.fit_transform(train), kj.transform(test)
    with use_device("cpu"), pytest.warns(UserWarning, match="Collisions"):
        kt = grakel_torch.NeighborhoodHash(**kw)
        Kt, Tt = kt.fit_transform(train), kt.transform(test)
    assert kt._labels_hash_dict == kj._labels_hash_dict
    assert np.array_equal(Kt, Kj) and np.array_equal(Tt, Tj)
    assert Kt.dtype == np.float64


def test_neighborhood_hash_checks():
    with use_device("cpu"):
        for bad in ({"R": 0}, {"nh_type": "x"}, {"bits": 0}):
            with pytest.raises(TypeError):
                grakel_torch.NeighborhoodHash(**bad).fit(_tiny())
        with pytest.raises(grakel_torch.estimator.NotFittedError):
            grakel_torch.NeighborhoodHash().diagonal()
        k = grakel_torch.NeighborhoodHash(random_state=0)
        assert k.fit(_tiny()).diagonal() == 1.0
        with pytest.raises(ValueError, match="label"):
            k.transform([[np.ones((2, 2))]])


def _tiny():
    A = np.array([[0, 1, 1], [1, 0, 0], [1, 0, 0]], float)
    return [[A, {0: "a", 1: "b", 2: "a"}], [A, {0: "b", 1: "b", 2: "c"}]]


@pytest.mark.parametrize("nh_type", ["simple", "count_sensitive"])
def test_neighborhood_hash_state_carry(nh_type):
    """kernel_from_state("NeighborhoodHash") with the JAX kernel's label
    hash and fit graphs: the port's transform equals the JAX one."""
    train, test = generate_dataset(n_graphs=30, n_graphs_test=6,
                                   r_vertices=(2, 12), random_state=11,
                                   features=("nl", 6))
    params = {"random_state": 3, "nh_type": nh_type}
    kj = grakel_tpu.NeighborhoodHash(**params).fit(train)
    Tj = kj.transform(test)
    graphs = [(g.n, g.senders, g.receivers, g.weights, dict(g.node_labels))
              for g in grakel_torch.kernels.base.normalize_input(train)]
    with use_device("cpu"):
        kt = kernel_from_state("NeighborhoodHash", params,
                               {"labels_hash": kj._labels_hash_dict,
                                "graphs": graphs})
        Tt = kt.transform(test)
    assert np.array_equal(Tt, Tj)


def test_kernel_wrappers_refuse_cpu_tensors():
    """K4's (both routes), K5's (every route) and K6's (both routes, the
    round route with and without propagation) wrappers take CUDA tensors
    only: on CPU tensors they
    raise before building anything (their callers take the plain
    versions there)."""
    b, lab, valid = _round_inputs(0, 8)
    hist = torch.zeros((b.n_graphs, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        nh.nh_round_cuda(torch.from_numpy(lab.astype(np.int32)),
                         torch.from_numpy(valid), b.node_graph_ids,
                         b.csr_offsets, b.csr_targets, hist, 8, False)
    chunks, _, _ = nh.nh_plan(b.n_nodes, b.n_edges, 8)
    with pytest.raises(ValueError, match="CUDA"):
        nh.nh_graph_cuda(torch.from_numpy(lab.astype(np.int32)),
                         torch.from_numpy(valid), b.node_graph_ids,
                         b.csr_offsets, b.csr_targets, chunks,
                         hist[None], 8, False)
    C = torch.zeros((2, 3, 3))
    for tri in (False, True):
        v = torch.ones(3)
        with pytest.raises(ValueError, match="CUDA"):
            intersect.jaccard_fold_cuda(C, v, v, True, triangle=tri)
    assert torch.equal(intersect.jaccard_gram_rounds(C), torch.zeros(3, 3))
    codes = torch.zeros((b.node_labels.shape[0], 4), dtype=torch.int32)
    tag = torch.full((codes.shape[0],), 4, dtype=torch.int32)
    for propagate in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            hadamard.hadamard_step_cuda(codes, b.csr_offsets, b.csr_targets,
                                        tag, propagate)
    chunks, _, _ = hadamard.hc_plan(b.n_nodes, b.n_edges, 4, codes.shape[0])
    with pytest.raises(ValueError, match="CUDA"):
        hadamard.hadamard_graph_cuda(
            codes, torch.arange(codes.shape[0], dtype=torch.int32), tag,
            b.csr_offsets, b.csr_targets, chunks,
            torch.empty((3, codes.shape[0]), dtype=torch.int64))


# --------------------------------------------------------------------- #
# K5's triangle route and K4's routes: what the CPU can hold them to
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,R,n,L", [
    (11, 1, 1, 8), (12, 3, 31, 64), (13, 3, 70, 256), (14, 5, 45, 16),
    (15, 2, 33, 128)])
def test_jaccard_fold_symmetric_counts_need_no_mirror(seed, R, n, L):
    """The identity K5's triangle route relies on: on the counts of one
    symmetric min-intersection call with one vertex-count vector, the
    symmetrized fold equals the plain one bit for bit (acc_ij == acc_ji,
    (x + x) * 0.5 == x), and both equal the JAX function's Gram."""
    A, _, va, _ = _hists(seed, R, n, n, L, min(2, n - 1))
    At = torch.from_numpy(A)
    C = intersect.min_intersection_gram_rounds(At)
    assert torch.equal(C, C.transpose(1, 2))
    v = torch.from_numpy(va.astype(np.float32))
    sym = intersect.jaccard_fold_plain(C, v, v, True)
    tri = intersect.jaccard_fold_plain(C, v, v, False)
    assert torch.equal(sym.view(torch.int32), tri.view(torch.int32))
    ref = _jax_jaccard(A, None, va, None, True)
    assert np.array_equal(tri.numpy().view(np.int32), ref.view(np.int32))
    assert np.array_equal(
        intersect.jaccard_gram_rounds(At, va=va).numpy(), ref)


def _pa_graph(rng, n, m):
    """A preferential-attachment graph of n vertices, each new vertex
    linked to m earlier ones drawn by degree; both edge directions."""
    ends, s, r = [0], [], []
    for v in range(1, n):
        for u in set(ends[i] for i in rng.randint(0, len(ends), m)):
            s += [v, u]
            r += [u, v]
            ends += [u, v]
    return n, np.array(s, np.int64), np.array(r, np.int64)


def _hub_batch(seed, bits):
    """A star whose centre has degree 200 and a few preferential-attachment
    graphs, labeled by vertex degree through a random bits-wide hash, a
    few nodes poisoned (labels unseen at fit): a CPU GraphBatch, the
    labels, their validity."""
    rng = np.random.RandomState(seed)
    graphs = [(201, np.r_[np.zeros(200, np.int64), np.arange(1, 201)],
               np.r_[np.arange(1, 201), np.zeros(200, np.int64)])]
    graphs += [_pa_graph(rng, int(rng.randint(20, 120)), 2)
               for _ in range(4)]
    b = GraphBatch.from_graphs(
        [Graph.from_arrays(n, s, r) for n, s, r in graphs],
        node_label_enum={}, device="cpu")
    deg = np.diff(b.csr_offsets.numpy()).astype(np.int64)
    lut = rng.randint(0, 1 << bits, deg.max() + 1)
    valid = b.node_mask.numpy() & (rng.rand(deg.shape[0]) > 0.02)
    lab = np.where(valid, lut[deg], 0)
    return b, lab, valid


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("nh_type", ["simple", "count_sensitive"])
def test_nh_rounds_plain_equals_jax_on_hubs(nh_type, bits):
    """A 200-degree star centre and degree-labeled preferential-attachment
    graphs with poisoned nodes: the plain rounds equal the JAX program's
    histograms exactly (the hub case K4 folds with a warp)."""
    b, lab, valid = _hub_batch(bits, bits)
    cs, R = nh_type == "count_sensitive", 3
    ref = np.asarray(jax_nh_rounds(
        jnp.asarray(lab.astype(np.uint32)), jnp.asarray(valid),
        jnp.asarray(b.node_mask.numpy()),
        jnp.asarray(b.node_graph_ids.numpy()),
        jnp.asarray(b.senders.numpy()), jnp.asarray(b.receivers.numpy()),
        jnp.asarray(b.edge_mask.numpy()), b.n_graphs, R, bits, cs))
    got = nh.nh_rounds_plain(torch.from_numpy(lab.astype(np.int32)),
                             torch.from_numpy(valid), b.node_graph_ids,
                             b.csr_offsets, b.csr_targets, b.n_graphs, R,
                             bits, cs)
    assert np.array_equal(got.numpy(), ref)
    assert got[:, 0].sum() > 0 and (~valid & b.node_mask.numpy()).any()


def _check_plan(n_nodes, n_edges, bits, chunk_nodes, budget):
    chunks, rnd, smem = nh.nh_plan(n_nodes, n_edges, bits, chunk_nodes,
                                   budget)
    n = len(n_nodes)
    node_at = np.r_[0, np.cumsum(n_nodes)]
    edge_at = np.r_[0, np.cumsum(n_edges)]
    cover = np.zeros(n, np.int64)
    for g0, g1, v0, v1, e0, e1 in chunks.tolist():
        cover[g0:g1] += 1
        assert (v0, v1, e0, e1) == (node_at[g0], node_at[g1], edge_at[g0],
                                    edge_at[g1])
        cost = int(nh.k4_smem_bytes(v1 - v0, e1 - e0, g1 - g0, bits))
        assert cost <= budget and cost <= smem
        assert v1 - v0 <= chunk_nodes or g1 - g0 == 1
        assert all(nh.nh_route(n_nodes[g], n_edges[g], bits, budget)
                   == "graph" for g in range(g0, g1))
    cover[rnd] += 1
    assert (cover == 1).all()
    assert all(nh.nh_route(n_nodes[g], n_edges[g], bits, budget) == "round"
               for g in rnd)
    if len(chunks):
        assert smem == max(int(nh.k4_smem_bytes(
            c[3] - c[2], c[5] - c[4], c[1] - c[0], bits)) for c in chunks)
    return chunks, rnd


@pytest.mark.parametrize("case", ["nci1", "mixed", "bits12", "bits14",
                                  "empty_graphs", "tight"])
def test_nh_plan_covers_each_graph_once_within_budget(case):
    """K4's planner: every graph lies in exactly one graph-route chunk or
    on the round route; a chunk holds a run of consecutive graphs with
    its node and edge ranges, within the node target (or a single graph)
    and the shared-memory budget; a graph over the budget, or any graph
    at large bits, takes the round route."""
    rng = np.random.RandomState(len(case))
    bits, chunk_nodes, budget = 8, nh.K4_CHUNK_NODES, nh.K4_SMEM_BUDGET
    n_nodes = rng.randint(10, 51, 300)
    if case == "mixed":
        n_nodes[[0, 17, 18, 299]] = [6000, 5500, 6400, 7000]
    if case == "empty_graphs":
        n_nodes[rng.rand(300) < 0.3] = 0
    if case == "tight":
        chunk_nodes, budget = 40, 12 * 1024
    if case.startswith("bits"):
        bits = int(case[4:])
    n_edges = (n_nodes * rng.uniform(1, 9, 300)).astype(np.int64)
    chunks, rnd = _check_plan(n_nodes, n_edges, bits, chunk_nodes, budget)
    if case == "mixed":
        assert rnd.tolist() == [0, 17, 18, 299]
    elif case == "bits14":
        assert len(chunks) == 0 and len(rnd) == 300
    else:
        assert len(rnd) == 0 and len(chunks) > 1
    if case == "bits12":
        assert (chunks[:, 1] - chunks[:, 0]).max() <= 2


def test_nh_route_by_shape():
    assert nh.nh_route(50, 200, 8) == "graph"
    assert nh.nh_route(3782, 8763, 8) == "graph"      # REDDIT-B's largest
    assert nh.nh_route(5500, 40000, 8) == "round"
    assert nh.nh_route(50, 200, 14) == "round"        # 2 x 2^14 counters
    assert nh.nh_route(1 << 16, 0, 1, budget=1 << 30) == "round"
    assert nh.k4_smem_bytes(10, 30, 2, 8) == 16 * -(-(4096 + 144 + 64) // 16)
    empty = nh.nh_plan(np.zeros(0, np.int64), np.zeros(0, np.int64), 8)
    assert empty[0].shape == (0, 6) and empty[1].size == 0 and empty[2] == 0


def test_nh_plan_chunks_are_self_contained():
    """The plain rounds of each chunk alone (its node and edge ranges,
    rebased) give the chunk's rows of the whole batch's histograms: the
    ranges the graph route stages hold every edge of their graphs."""
    train, _ = generate_dataset(n_graphs=70, n_graphs_test=2,
                                r_vertices=(1, 40), random_state=21,
                                features=("nl", 5))
    graphs = grakel_torch.kernels.base.normalize_input(train)
    b = GraphBatch.from_graphs(graphs, node_label_enum={}, device="cpu")
    rng = np.random.RandomState(2)
    N = b.node_mask.shape[0]
    lab = torch.from_numpy(rng.randint(0, 7, N).astype(np.int32))
    valid = b.node_mask & torch.from_numpy(rng.rand(N) < 0.9)
    chunks, rnd, _ = nh.nh_plan(b.n_nodes, b.n_edges, 6, chunk_nodes=64)
    assert len(rnd) == 0 and len(chunks) > 3
    for cs in (False, True):
        full = nh.nh_rounds_plain(lab, valid, b.node_graph_ids,
                                  b.csr_offsets, b.csr_targets, b.n_graphs,
                                  3, 6, cs)
        for g0, g1, v0, v1, e0, e1 in chunks.tolist():
            part = nh.nh_rounds_plain(
                lab[v0:v1], valid[v0:v1], b.node_graph_ids[v0:v1] - g0,
                b.csr_offsets[v0:v1 + 1] - e0, b.csr_targets[e0:e1] - v0,
                g1 - g0, 3, 6, cs)
            assert torch.equal(part, full[:, g0:g1])


def test_graph_batch_refuses_edges_between_graphs():
    """K4's graph route holds whole graphs in a block: GraphBatch refuses
    an edge that leaves its graph, even when it stays in the batch."""
    Gr = Graph.from_arrays
    for bad in ([Gr(3, [0, 1], [1, 3]), Gr(2, [0], [1])],
                [Gr(2, [], []), Gr(3, [0, 2], [-1, 0])],
                [Gr(2, [2], [0]), Gr(2, [0], [1])]):
        with pytest.raises(ValueError, match="its graph"):
            GraphBatch.from_graphs(bad, device="cpu")
    ok = GraphBatch.from_graphs([Gr(3, [0, 1], [1, 2]), Gr(2, [1], [0])],
                                device="cpu")
    assert ok.csr_targets.tolist() == [1, 2, 3]
