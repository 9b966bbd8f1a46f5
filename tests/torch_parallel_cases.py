"""The cases that the parallel tests run in launcher ranks.

``python -m grakel_torch.parallel.launch --target
torch_parallel_cases:run_case`` imports this module in every rank (with
this directory on ``PYTHONPATH``), so it imports ``torch``, numpy and
the port only: no rank imports JAX, the JAX package or the suite's
conftest.  The tests make the JAX package's references from the same
numpy-seeded inputs (:func:`case_inputs`) in their own process.
"""

import numpy as np

# the kernel names of the JAX package's mesh frontend test
KERNEL_NAMES = ("vertex_histogram", "edge_histogram", "shortest_path",
                "propagation", "odd_sth", "weisfeiler_lehman",
                "weisfeiler_lehman_optimal_assignment",
                "neighborhood_subgraph_pairwise_distance")
FRAMEWORK_SPEC = [{"name": "core_framework"}, {"name": "weisfeiler_lehman"},
                  {"name": "vertex_histogram"}]

# the cases whose results are integer counts (compared exactly)
EXACT_CASES = frozenset(
    ["sharded_counts_gram", "framework", "mesh_auto", "distributed_wl",
     "edge_partitioned", "large_graph_wl_gram", "large_graph_frontend"]
    + ["kernel:" + k for k in ("vertex_histogram", "edge_histogram",
                               "shortest_path", "weisfeiler_lehman",
                               "weisfeiler_lehman_optimal_assignment")])

CASES = (("ring_gram", "ring_rect_gram", "sharded_counts_gram",
          "sharded_counts_gram_rect")
         + tuple("kernel:" + k for k in KERNEL_NAMES)
         + ("framework", "mesh_auto", "distributed_wl", "edge_partitioned",
            "large_graph_wl_gram", "large_graph_frontend"))


def mesh_test_graphs(n=30, seed=7):
    """GraKeL-style [A, node labels, edge labels] graphs of 5-14
    vertices, 4 node labels, 3 edge labels."""
    rng = np.random.RandomState(seed)
    graphs = []
    for _ in range(n):
        m = rng.randint(5, 15)
        A = (rng.rand(m, m) < 0.3).astype(float)
        A = np.triu(A, 1)
        A = A + A.T
        nl = {v: int(rng.randint(0, 4)) for v in range(m)}
        el = {(u, v): int((u + v) % 3)
              for u in range(m) for v in range(m) if A[u, v]}
        graphs.append([A, nl, el])
    return graphs


def big_graph_arrays(n, deg, seed, n_labels):
    """A random undirected graph of ``n`` vertices: (senders, receivers)
    of both directions of ``deg * n`` uniform draws without self-loops
    or repeats, and ``n_labels`` vertex labels v % n_labels."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, deg * n)
    dst = rng.randint(0, n, deg * n)
    keep = src != dst
    s = np.concatenate([src[keep], dst[keep]]).astype(np.int64)
    r = np.concatenate([dst[keep], src[keep]]).astype(np.int64)
    pairs = np.unique(s * n + r)
    return ((pairs // n).astype(np.int32), (pairs % n).astype(np.int32),
            {v: int(v % n_labels) for v in range(n)})


def case_inputs(case):
    """The inputs of ``case``, from numpy seeds only (numpy arrays and
    GraKeL-style graphs, or (n, senders, receivers, labels) tuples for
    the big graphs), the same in every rank and in the tests."""
    if case == "ring_inputs":
        return {**case_inputs("ring_gram"), **case_inputs("ring_rect_gram")}
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "ring_gram":
        return {"phi": rng.randn(24, 56).astype(np.float32)}
    if case == "ring_rect_gram":
        return {"y": rng.rand(24, 37).astype(np.float32),
                "x": rng.rand(36, 37).astype(np.float32)}
    if case == "sharded_counts_gram":
        n_graphs, n_labels, n_items = 13, 7, 500
        return {"gids": rng.randint(0, n_graphs, n_items).astype(np.int32),
                "labels": rng.randint(0, n_labels, n_items).astype(np.int32),
                "weights": np.ones(n_items, np.float32),
                "valid": rng.rand(n_items) < 0.9,
                "n_graphs": n_graphs, "n_labels": n_labels}
    if case == "sharded_counts_gram_rect":
        out = {"n_y": 9, "n_x": 13, "n_labels": 11}
        for side, n, cnt in (("y", 9, 300), ("x", 13, 400)):
            out[side] = (rng.randint(0, n, cnt).astype(np.int32),
                         rng.randint(0, 11, cnt).astype(np.int32),
                         rng.rand(cnt).astype(np.float32),
                         rng.rand(cnt) < 0.85)
        return out
    if case.startswith("kernel:") or case == "framework":
        return {"graphs": mesh_test_graphs()}
    if case == "mesh_auto":
        return {"graphs": mesh_test_graphs(12)}
    if case == "distributed_wl":
        return {"graphs": mesh_test_graphs(19, seed=5), "n_iter": 3}
    if case == "edge_partitioned":
        return {"big": (200,) + big_graph_arrays(200, 3, 7, 4),
                "n_iter": 3}
    if case == "large_graph_wl_gram":
        return {"big": (400,) + big_graph_arrays(400, 4, 0, 4),
                "graphs": mesh_test_graphs(24, seed=0), "n_iter": 3,
                "big_threshold": 100}
    if case == "large_graph_frontend":
        return {"big": (3000,) + big_graph_arrays(3000, 3, 3, 5),
                "graphs": mesh_test_graphs(30, seed=3), "n_iter": 2,
                "big_threshold": 1000, "n_fit": 18}
    raise ValueError("unknown case %r" % case)


def graph_list(inp, Graph):
    """The case's graphs, the big one (when given) first, as ``Graph``
    objects of the package ``Graph`` belongs to."""
    out = []
    if "big" in inp:
        n, s, r, labels = inp["big"]
        out.append(Graph.from_arrays(n, s, r, np.ones(len(s), np.float32),
                                     labels, {}))
    return out + [Graph(*g) for g in inp.get("graphs", [])]


def run_case(case, mesh):
    """Run ``case`` over ``mesh`` with the port; returns numpy results.
    ``ring_inputs`` returns the rings' numpy inputs as they are after
    both rings ran on them."""
    from grakel_torch import Graph, GraphKernel, VertexHistogram
    from grakel_torch import parallel as par
    inp = case_inputs(case)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if case == "ring_gram":
        return host(par.ring_gram(mesh, inp["phi"]))
    if case == "ring_rect_gram":
        return host(par.ring_rect_gram(mesh, inp["y"], inp["x"]))
    if case == "ring_inputs":
        par.ring_gram(mesh, inp["phi"])
        par.ring_rect_gram(mesh, inp["y"], inp["x"])
        return inp
    if case == "sharded_counts_gram":
        lg, lb, lw, lv, rows = par.shard_batch(
            inp["gids"], inp["labels"], inp["weights"], inp["valid"],
            inp["n_graphs"], mesh.size)
        return host(par.sharded_counts_gram(mesh, lg, lb, lw, lv, rows,
                                            inp["n_labels"]))
    if case == "sharded_counts_gram_rect":
        *ya, ry = par.shard_batch(*inp["y"], inp["n_y"], mesh.size)
        *xb, rx = par.shard_batch(*inp["x"], inp["n_x"], mesh.size)
        return host(par.sharded_counts_gram_rect(mesh, ya, xb, ry, rx,
                                                 inp["n_labels"]))
    if case.startswith("kernel:"):
        k = GraphKernel(kernel=case[7:], random_state=0, mesh=mesh)
        g = inp["graphs"]
        return k.fit_transform(g[:20]), k.transform(g[20:])
    if case == "framework":
        return GraphKernel(kernel=FRAMEWORK_SPEC, mesh=mesh).fit_transform(
            inp["graphs"][:20])
    if case == "mesh_auto":
        k = VertexHistogram()
        k.mesh = "auto"
        return k.fit_transform(inp["graphs"])
    if case == "distributed_wl":
        return par.distributed_wl_gram(graph_list(inp, Graph),
                                       inp["n_iter"], mesh)
    if case == "edge_partitioned":
        return par.edge_partitioned_wl_features(
            graph_list(inp, Graph)[0], inp["n_iter"], mesh)
    if case == "large_graph_wl_gram":
        return par.large_graph_wl_gram(graph_list(inp, Graph),
                                       inp["n_iter"], mesh,
                                       big_threshold=inp["big_threshold"])
    if case == "large_graph_frontend":
        graphs = graph_list(inp, Graph)
        fe = par.LargeGraphWL(n_iter=inp["n_iter"], mesh=mesh,
                              big_threshold=inp["big_threshold"])
        K = fe.fit_transform(graphs)
        m = inp["n_fit"]
        Kt = fe.fit(graphs[:m]).transform(graphs[m:])
        return K, Kt
    raise ValueError("unknown case %r" % case)


def run_case_single(case):
    """``case``'s result on one device (the ambient one), with no mesh:
    the reference each mesh result is held against (the padded
    sharded-counts Grams unpadded; see :func:`strip_padding`)."""
    import torch
    from grakel_torch import (Graph, GraphKernel, VertexHistogram,
                              WeisfeilerLehman)
    from grakel_torch.device import resolve_device
    from grakel_torch.ops import gram, wl
    from grakel_torch.parallel.large_graph import (
        _EdgePartition, _histogram, _initial_labels)
    inp = case_inputs(case)
    dev = resolve_device()
    host = lambda t: t.cpu().numpy()  # noqa: E731
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    if case == "ring_gram":
        return host(gram.gram_gemm(inp["phi"]))
    if case == "ring_rect_gram":
        return host(gram.gram_rect(inp["y"], inp["x"]))
    if case == "sharded_counts_gram":
        return host(gram.coo_counts_gram(
            t(inp["gids"]), inp["labels"], inp["weights"], inp["valid"],
            inp["n_graphs"], inp["n_labels"]))
    if case == "sharded_counts_gram_rect":
        (gy, ly, wy, vy), (gx, lx, wx, vx) = inp["y"], inp["x"]
        return host(gram.coo_counts_gram_rect(
            t(gy), ly, wy, vy, t(gx), lx, wx, vx, inp["n_y"], inp["n_x"],
            inp["n_labels"]))
    if case.startswith("kernel:"):
        k = GraphKernel(kernel=case[7:], random_state=0)
        g = inp["graphs"]
        return k.fit_transform(g[:20]), k.transform(g[20:])
    if case == "framework":
        return GraphKernel(kernel=FRAMEWORK_SPEC).fit_transform(
            inp["graphs"][:20])
    if case == "mesh_auto":
        return VertexHistogram().fit_transform(inp["graphs"])
    graphs = graph_list(inp, Graph)
    if case == "edge_partitioned":
        # K2's first reach over the whole graph's CSR, compacted
        g = graphs[0]
        csr = _EdgePartition(g, 1).rank_csr(0, dev)
        labels = t(_initial_labels(g, {}))
        valid = torch.ones(g.n, dtype=torch.bool, device=dev)
        feats = [_histogram(host(labels), np.ones(g.n, bool))]
        for _ in range(inp["n_iter"]):
            labels = wl.compact_key_ids(wl._wl_hash_refine_csr(labels, *csr),
                                        valid)[0]
            feats.append(_histogram(host(labels), np.ones(g.n, bool)))
        return feats, host(labels)
    K = WeisfeilerLehman(n_iter=inp["n_iter"]).fit_transform(graphs)
    if case != "large_graph_frontend":
        return K
    m = inp["n_fit"]
    k = WeisfeilerLehman(n_iter=inp["n_iter"])
    k.fit(graphs[:m])
    return K, k.transform(graphs[m:])


def strip_padding(case, result):
    """(the real block of a mesh result, its padding blocks): the
    sharded-counts Grams carry P * rows rows and columns, the padding
    ones zero; other results have no padding."""
    inp = case_inputs(case)
    if case == "sharded_counts_gram":
        n = inp["n_graphs"]
        return result[:n, :n], (result[n:], result[:, n:])
    if case == "sharded_counts_gram_rect":
        ny, nx = inp["n_y"], inp["n_x"]
        return result[:ny, :nx], (result[ny:], result[:, nx:])
    return result, ()
