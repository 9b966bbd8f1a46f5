"""grakel_torch.parallel.large_graph and K2's second reach on the CPU.

The edge-partitioned paths run in P gloo ranks (P = 3 and 4) through
``python -m grakel_torch.parallel.launch --device cpu`` as in
``tests/test_torch_parallel.py``, on inputs made from numpy seeds
(``torch_parallel_cases.case_inputs``). References: the JAX package's
single-device refinement (``grakel_tpu.ops.wl.wl_hash_refine`` +
``host_compact`` a generation, as ``tests/test_parallel.py`` holds its
mesh version) and its single-device ``WeisfeilerLehman`` Gram, which
that file holds equal to ``large_graph_wl_gram`` and ``LargeGraphWL`` on
its mesh (the JAX package's mesh version of these paths compiles for
tens of seconds a call); and the port's single-device WL. The Grams are
integer counts and match exactly; the histograms and label ids too. In
process: K2's second reach against its first over four row blocks, the
partition's checks and a world of one.
"""

import numpy as np
import pytest
import torch

from grakel_tpu import WeisfeilerLehman as JaxWL
from grakel_tpu import Graph as JaxGraph
from grakel_tpu.ops import wl as j_wl
import grakel_torch
from grakel_torch import WeisfeilerLehman, use_device
from grakel_torch import parallel as tpar
from grakel_torch.estimator import NotFittedError
from grakel_torch.ops import wl as t_wl
from grakel_torch.parallel.large_graph import _EdgePartition

import torch_parallel_cases as cases
from test_torch_parallel import RANKS, run_launcher

CASES = ("edge_partitioned", "large_graph_wl_gram", "large_graph_frontend")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return run_launcher(str(tmp_path_factory.mktemp("launch")), RANKS,
                        CASES)


def _graphs(case, Graph):
    return cases.graph_list(cases.case_inputs(case), Graph)


def jax_features(g, n_iter):
    """Per-generation {id: count} and the final ids of one graph by the
    JAX package's single-device refinement: ``wl_hash_refine`` and
    ``host_compact`` (ids ranked by hash pair)."""
    enum = {}
    labels = np.array([enum.setdefault(g.get_labels()[v], len(enum))
                       for v in range(g.n)], np.int32)
    valid = np.ones(g.n, bool)
    send, recv = np.asarray(g.senders), np.asarray(g.receivers)
    feats = [_hist(labels)]
    for _ in range(n_iter):
        h1, h2 = j_wl.wl_hash_refine(labels, send, recv,
                                     np.ones(len(send), bool))
        labels, _ = j_wl.host_compact(np.asarray(h1), np.asarray(h2), valid)
        feats.append(_hist(labels))
    return feats, labels


def _hist(ids):
    u, c = np.unique(np.asarray(ids), return_counts=True)
    return {int(a): int(b) for a, b in zip(u, c)}


@pytest.mark.parametrize("P", RANKS)
def test_edge_partitioned_features_match_single_device(port_runs, P):
    run = port_runs[P]
    assert run["collectives"]["edge_partitioned"]["all_gathers"] == 6
    feats, final = run["results"]["edge_partitioned"]
    n_iter = cases.case_inputs("edge_partitioned")["n_iter"]
    jf, jl = jax_features(_graphs("edge_partitioned", JaxGraph)[0], n_iter)
    with use_device("cpu"):
        pf, pl = cases.run_case_single("edge_partitioned")
    assert len(feats) == n_iter + 1
    # generation 0 enumerates in order of appearance in both packages
    assert feats == jf == pf
    np.testing.assert_array_equal(final, jl)
    np.testing.assert_array_equal(final, pl)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("case", ["large_graph_wl_gram",
                                  "large_graph_frontend"])
def test_large_graph_gram_matches_wl(port_runs, case, P):
    run = port_runs[P]
    # the big graph refined edge-partitioned: two all-gathers a
    # generation a call
    assert run["collectives"][case]["all_gathers"] > 0
    got = run["results"][case]
    inp = cases.case_inputs(case)
    n_iter = inp["n_iter"]
    jg = _graphs(case, JaxGraph)
    with use_device("cpu"):
        single = cases.run_case_single(case)
    if case == "large_graph_wl_gram":
        want = (np.asarray(JaxWL(n_iter=n_iter).fit_transform(jg)),)
        got, single = (got,), (single,)
    else:
        m = inp["n_fit"]
        jw = JaxWL(n_iter=n_iter)
        jw.fit(jg[:m])
        want = (np.asarray(JaxWL(n_iter=n_iter).fit_transform(jg)),
                np.asarray(jw.transform(jg[m:])))
    for a, b, c in zip(got, want, single):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 1])
def test_reach2_plain_over_four_blocks_equals_reach1(seed):
    """K2's second reach (plain version), over each of four row blocks
    against the gathered labels, equals its first reach over the whole
    graph's CSR bit for bit, and the JAX package's hash."""
    n = 2999 + seed
    s, r, _ = cases.big_graph_arrays(n, 3, seed, 7)
    rng = np.random.RandomState(seed)
    g = grakel_torch.Graph.from_arrays(n, s, r)
    labels = rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    whole = _EdgePartition(g, 1)
    off1, tgt1 = whole.rank_csr(0, "cpu")
    want = t_wl.wl_hash_refine_csr_plain(torch.from_numpy(labels), off1,
                                         tgt1)
    part = _EdgePartition(g, 4)
    glob = np.zeros(part.N_pad, np.int32)
    glob[:n] = labels
    blocks = [t_wl.wl_hash_refine_rows(torch.from_numpy(glob),
                                       *part.rank_csr(p, "cpu"),
                                       p * part.npd) for p in range(4)]
    got = torch.cat(blocks)
    assert got.shape == (part.N_pad,) and got.dtype == torch.int64
    assert torch.equal(got[:n], want)
    j1, j2 = j_wl.wl_hash_refine(labels, s, r, np.ones(len(s), bool))
    h1, h2 = t_wl.key_hashes(got[:n])
    np.testing.assert_array_equal(h1.numpy().view(np.uint32), np.asarray(j1))
    np.testing.assert_array_equal(h2.numpy().view(np.uint32), np.asarray(j2))


def test_edge_partition_checks_edges_and_blocks():
    g = grakel_torch.Graph.from_arrays(10, np.array([0, 9, 3]),
                                       np.array([1, 0, 3]))
    part = _EdgePartition(g, 3)
    assert (part.npd, part.N_pad) == (4, 12)
    assert part.node_valid.sum() == 10 and not part.node_valid[10:].any()
    off, tgt = part.rank_csr(2, "cpu")     # rows 8-11: node 9 -> 0
    assert off.tolist() == [0, 0, 1, 1, 1] and tgt.tolist() == [0]
    bad = grakel_torch.Graph.from_arrays(4, np.array([0]), np.array([4]))
    with pytest.raises(ValueError, match="receiver"):
        _EdgePartition(bad, 2)


def test_large_graph_frontend_world_of_one_and_not_fitted():
    import torch.distributed as dist
    fe = tpar.LargeGraphWL(n_iter=2, big_threshold=1000)
    with pytest.raises(NotFittedError):
        fe.transform(cases.mesh_test_graphs(2))
    with pytest.raises(NotFittedError):
        fe.diagonal()
    assert not dist.is_initialized()
    graphs = _graphs("large_graph_frontend", grakel_torch.Graph)
    try:
        with use_device("cpu"):
            mesh = tpar.make_mesh()
            fe.mesh = mesh
            K = fe.fit_transform(graphs)
            K0 = WeisfeilerLehman(n_iter=2).fit_transform(graphs)
            assert np.array_equal(K, K0)
            assert np.array_equal(fe.diagonal(), np.diagonal(K0))
    finally:
        tpar.mesh.shutdown()
