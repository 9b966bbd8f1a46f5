"""grakel_torch.parallel against grakel_tpu.parallel on the CPU.

The port's side runs in P gloo ranks (P = 3: uneven graph blocks and
padding rows; P = 4) through ``python -m grakel_torch.parallel.launch
--device cpu --target torch_parallel_cases:run_case`` as a subprocess,
so no rank imports this module, the suite's conftest or JAX; each
launcher call runs every case once. This process computes the references
from the same numpy-seeded inputs
(``torch_parallel_cases.case_inputs``): the JAX package's result on
``make_mesh(P)`` over conftest's virtual CPU devices, and the port's
single-device result. Where the JAX package's mesh program takes tens of
seconds of XLA compiles a call (the WL, NSPD and CoreFramework
frontends), the JAX reference is its single-device result, which
``tests/test_parallel.py`` holds equal to its mesh result. Integer-count
Grams must match exactly (the inputs are small, so the JAX f32 sums are
exact); float Grams at rtol = atol = 1e-5, as the JAX package's mesh
tests hold them.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import grakel_tpu
from grakel_tpu import parallel as jpar
import grakel_torch
from grakel_torch import use_device
from grakel_torch import parallel as tpar
from grakel_torch.ops.gram import active_mesh, use_mesh

import torch_parallel_cases as cases

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CASES = [c for c in cases.CASES if c not in (
    "edge_partitioned", "large_graph_wl_gram", "large_graph_frontend")]
RANKS = (3, 4)
# JAX mesh programs that compile for tens of seconds a call: held
# against the JAX single-device result instead
JAX_SINGLE = {"kernel:weisfeiler_lehman",
              "kernel:neighborhood_subgraph_pairwise_distance", "framework"}


def run_launcher(tmp_dir, ranks, names):
    """Start one launcher call per rank count (all at once), wait for
    them, and return {P: {case: result}}."""
    procs = {}
    for P in ranks:
        out = os.path.join(tmp_dir, "p%d.pkl" % P)
        cmd = [sys.executable, "-m", "grakel_torch.parallel.launch",
               "--ranks", str(P), "--device", "cpu", "--target",
               "torch_parallel_cases:run_case", "--cases", ",".join(names),
               "--out", out, "--init-method",
               "file://" + os.path.join(tmp_dir, "rdzv%d" % P),
               "--timeout", "280"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join((ROOT, TESTS)),
                   OMP_NUM_THREADS="1")
        procs[P] = (subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    out)
    res = {}
    for P, (p, out) in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, (P, stdout[-2000:], stderr[-4000:])
        with open(out, "rb") as f:
            got = pickle.load(f)
        assert got["ranks"] == P and got["backend"] == "gloo"
        res[P] = got
    return res


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return run_launcher(str(tmp_path_factory.mktemp("launch")), RANKS,
                        CASES + ["ring_inputs"])


def through_the_mesh(run, case):
    """``case``'s result from a launcher run, after checking that it went
    through the mesh: ring hops between the ranks."""
    assert run["collectives"][case]["ring_hops"] > 0, (case, run["ranks"])
    return run["results"][case]


def _np(x):
    return x if isinstance(x, (tuple, list)) else (x,)


@functools.lru_cache(maxsize=None)
def jax_result(case, P):
    """The JAX package's result of ``case`` on ``make_mesh(P)`` (its
    single-device result for the cases in JAX_SINGLE)."""
    from grakel_tpu import GraphKernel, VertexHistogram
    inp = cases.case_inputs(case)
    mesh = None if case in JAX_SINGLE else jpar.make_mesh(P)
    if case == "ring_gram":
        return np.asarray(jpar.ring_gram(mesh, inp["phi"]))
    if case == "ring_rect_gram":
        return np.asarray(jpar.ring_rect_gram(mesh, inp["y"], inp["x"]))
    if case == "sharded_counts_gram":
        lg, lb, lw, lv, rows = jpar.shard_batch(
            inp["gids"], inp["labels"], inp["weights"], inp["valid"],
            inp["n_graphs"], P)
        return np.asarray(jpar.sharded_counts_gram(mesh, lg, lb, lw, lv,
                                                   rows, inp["n_labels"]))
    if case == "sharded_counts_gram_rect":
        *ya, ry = jpar.shard_batch(*inp["y"], inp["n_y"], P)
        *xb, rx = jpar.shard_batch(*inp["x"], inp["n_x"], P)
        return np.asarray(jpar.sharded_counts_gram_rect(
            mesh, ya, xb, ry, rx, inp["n_labels"]))
    if case.startswith("kernel:"):
        k = GraphKernel(kernel=case[7:], random_state=0, mesh=mesh)
        g = inp["graphs"]
        return (np.asarray(k.fit_transform(g[:20])),
                np.asarray(k.transform(g[20:])))
    if case == "framework":
        return np.asarray(GraphKernel(kernel=cases.FRAMEWORK_SPEC)
                          .fit_transform(inp["graphs"][:20]))
    if case == "mesh_auto":
        k = VertexHistogram()
        k.mesh = "auto"
        return np.asarray(k.fit_transform(inp["graphs"]))
    if case == "distributed_wl":
        return jpar.distributed_wl_gram(
            cases.graph_list(inp, grakel_tpu.Graph), inp["n_iter"], mesh)
    raise ValueError(case)


@functools.lru_cache(maxsize=None)
def port_single(case):
    """The port's single-device result of ``case``, on the CPU."""
    with use_device("cpu"):
        return cases.run_case_single(case)


def assert_match(got, want, exact, what):
    for a, b in zip(_np(got), _np(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=what)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_mesh_case_matches_jax_and_single_device(port_runs, case, P):
    got = through_the_mesh(port_runs[P], case)
    want = jax_result(case, P)
    exact = case in cases.EXACT_CASES   # integer counts
    assert_match(got, want, exact, "%s, P = %d, against the JAX package"
                 % (case, P))
    got, pad = cases.strip_padding(case, got)
    assert all(np.all(x == 0) for x in pad), (case, P)
    assert_match(got, port_single(case), exact,
                 "%s, P = %d, against the port's single device" % (case, P))
    if case in ("ring_gram", "ring_rect_gram"):
        inp = cases.case_inputs(case)
        a, b = ((inp["phi"], inp["phi"]) if case == "ring_gram"
                else (inp["y"], inp["x"]))
        np.testing.assert_allclose(got, a @ b.T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P", RANKS)
def test_shard_batch_equals_jax(P):
    inp = cases.case_inputs("sharded_counts_gram")
    args = (inp["gids"], inp["labels"], inp["weights"], inp["valid"],
            inp["n_graphs"], P)
    got, want = tpar.shard_batch(*args), jpar.shard_batch(*args)
    assert got[-1] == want[-1]
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for side in ("y", "x"):
        r = cases.case_inputs("sharded_counts_gram_rect")
        n = r["n_" + side]
        for a, b in zip(tpar.shard_batch(*r[side], n, P),
                        jpar.shard_batch(*r[side], n, P)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", RANKS)
def test_rings_leave_their_input_alone(port_runs, P):
    """The hops write into the ring's own buffers, never into the
    caller's: a float32 numpy input on a CPU mesh shares its memory
    with the rank's block."""
    got = through_the_mesh(port_runs[P], "ring_inputs")
    want = cases.case_inputs("ring_inputs")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launcher_runs_on_the_card_unless_asked(tmp_path):
    """With no ``--device`` the launcher's ranks take the card; without
    one they raise, and no rank falls back to gloo on the CPU."""
    out = str(tmp_path / "r.pkl")
    r = subprocess.run(
        [sys.executable, "-m", "grakel_torch.parallel.launch", "--ranks",
         "1", "--target", "torch_parallel_cases:run_case", "--cases",
         "ring_gram", "--out", out, "--init-method",
         "file://" + str(tmp_path / "rdzv"), "--timeout", "100"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join((ROOT, TESTS)),
                 CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"))
    assert r.returncode != 0 and not os.path.exists(out)
    assert "use_device" in r.stderr, r.stderr[-2000:]


# --------------------------------------------------------------------- #
# in-process cases: a world of one, and what must raise
# --------------------------------------------------------------------- #

@pytest.fixture
def cpu_world_of_one():
    """A gloo world of one in this process (a HashStore: no port), torn
    down after the test."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with use_device("cpu"):
        mesh = tpar.make_mesh()
    yield mesh
    tpar.mesh.shutdown()


def test_world_of_one_gives_single_device_grams(cpu_world_of_one):
    mesh = cpu_world_of_one
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
    assert mesh.device == torch.device("cpu") and mesh.shape == {"g": 1}
    from grakel_torch import GraphKernel, WeisfeilerLehman
    graphs = cases.mesh_test_graphs()
    with use_device("cpu"):
        K0 = WeisfeilerLehman(n_iter=3).fit_transform(graphs)
        calls = tpar.mesh.gather_blocks.calls
        K1 = tpar.distributed_wl_gram(graphs, 3, mesh)
        # the world of one still gathers (a copy) every generation
        assert tpar.mesh.gather_blocks.calls - calls == 4
        assert K1.dtype == K0.dtype and np.array_equal(K1, K0)
        phi = np.random.RandomState(0).rand(7, 5).astype(np.float32)
        np.testing.assert_allclose(tpar.ring_gram(mesh, phi).numpy(),
                                   phi @ phi.T, rtol=1e-6)
        # a mesh of one rank is a no-op for the kernels' Gram funnel
        with use_mesh(mesh):
            assert active_mesh() is None
        for name in ("vertex_histogram", "weisfeiler_lehman"):
            k0 = GraphKernel(kernel=name)
            k1 = GraphKernel(kernel=name, mesh=mesh)
            assert k1.get_params()["mesh"] is mesh
            hops, calls = tpar.gram._ring.hops, tpar.mesh.gather_blocks.calls
            assert np.array_equal(k1.fit_transform(graphs[:20]),
                                  k0.fit_transform(graphs[:20]))
            assert np.array_equal(k1.transform(graphs[20:]),
                                  k0.transform(graphs[20:]))
            assert k1.kernel_.mesh is mesh
            assert (tpar.gram._ring.hops, tpar.mesh.gather_blocks.calls) \
                == (hops, calls)
        from grakel_torch import VertexHistogram
        k = VertexHistogram()
        k.mesh = "auto"
        assert k._resolved_mesh() is None
        assert np.array_equal(k.fit_transform(graphs),
                              VertexHistogram().fit_transform(graphs))
        # a gloo mesh is handed no tensor of another device type: it
        # raises rather than moving the data
        with pytest.raises(ValueError, match="mesh"):
            tpar.ring_gram(mesh, torch.ones((2, 3), device="meta"))
        with pytest.raises(ValueError, match="mesh"):
            tpar.mesh.gather_blocks(mesh, torch.ones(3, device="meta"))


def test_cuda_mesh_without_card_raises(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="use_device"):
            tpar.make_mesh(**kw)
    assert not dist.is_initialized()     # no gloo world was made instead
    k = grakel_torch.VertexHistogram()
    k.mesh = "auto"
    with pytest.raises(RuntimeError, match="use_device"):
        k.fit_transform(cases.mesh_test_graphs(3))


def test_distributed_init_needs_an_address(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.distributed_init() is False


def test_mesh_argument_is_accepted_and_resolved():
    from grakel_torch import GraphKernel, Kernel
    assert Kernel.mesh is None
    assert "mesh" in GraphKernel().get_params()
    k = grakel_torch.VertexHistogram()
    k.mesh = "bogus"
    with pytest.raises(ValueError, match="mesh"):
        k._resolved_mesh()
    assert set(tpar.__all__) >= set(jpar.__all__)
