"""GraphHopper of grakel_torch against grakel_tpu on JAX-CPU.

The hopper tensors are exact integer path counts in both packages (the
all-sources recurrences for unweighted graphs, the per-source Dijkstra
and DP for weighted ones), so they are held equal.  The Grams: the
linear node kernel's is one f64 GEMM of the explicit features (the
port's on the kernel's device, the JAX package's in numpy), the other
node kernels' the same host pair loop; all at rtol 1e-5, normalize off
and on, with fit_transform, transform and both diagonals (the diagonal
is the untruncated pair loop in both).
"""

import os

import numpy as np
import pytest

import grakel_torch
import grakel_tpu
from grakel_torch import use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import read_data
from grakel_torch.kernels import graph_hopper as tgh
from grakel_tpu.datasets import read_data as jax_read_data
from grakel_tpu.kernels import graph_hopper as jgh

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def cuneiform():
    """Cuneiform's real node attributes: fit 30, transform 10."""
    d = read_data("Cuneiform", path=DATA, prefer_attr_nodes=True).data
    j = jax_read_data("Cuneiform", path=DATA, prefer_attr_nodes=True).data
    return d[:30], d[30:40], j[:30], j[30:40]


def _weighted(seed, count):
    """Connected-ish graphs with integer edge weights 1-3 (the weighted
    route) and 2-d attributes, some disconnected."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        n = rng.randint(3, 10)
        A = np.triu(rng.rand(n, n) < 0.4, 1) * rng.randint(1, 4, (n, n))
        A = (A + A.T).astype(float)
        out.append([A, {i: list(rng.randn(2)) for i in range(n)}])
    return out


def _both(params, fit, tr, jfit, jtr):
    out = []
    for mod, f, t in ((grakel_torch, fit, tr), (grakel_tpu, jfit, jtr)):
        k = mod.GraphHopper(**params)
        with use_device("cpu"):
            K = k.fit_transform(f)
            d0 = k.diagonal()
            T = k.transform(t)
            xd, yd = k.diagonal()
        np.testing.assert_array_equal(d0, xd)
        out.append((K, T, xd, yd))
    return out


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("kernel_type", [
    "linear", "gaussian", ("gaussian", 0.3), "bridge"])
def test_graph_hopper_matches_jax(cuneiform, kernel_type, normalize):
    fit, tr, jfit, jtr = cuneiform
    if kernel_type != "linear":     # the host pair loop: a smaller fit
        fit, jfit = fit[:12], jfit[:12]
    got, ref = _both({"kernel_type": kernel_type, "normalize": normalize},
                     fit, tr, jfit, jtr)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kernel_type", ["linear", "gaussian"])
def test_graph_hopper_weighted_route_matches_jax(kernel_type):
    g = _weighted(3, 14)
    got, ref = _both({"kernel_type": kernel_type}, g[:10], g[10:], g[:10],
                     g[10:])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


def test_graph_hopper_tensors_equal_jax(cuneiform):
    """The unweighted all-sources tensor and the weighted per-source DP
    against the JAX package's, exactly; the two routes agree with each
    other on an unweighted graph."""
    fit = cuneiform[0]
    for x in fit[:8]:
        g = grakel_torch.Graph(*x)
        A = g.get_adjacency_matrix()
        spm, _ = g.build_shortest_path_matrix()
        for width in (int(spm[np.isfinite(spm)].max()) + 1, 9):
            M = tgh._hopper_tensor(A, spm, width)
            np.testing.assert_array_equal(
                M, jgh.GraphHopper._hopper_tensor(A, spm, width))
            np.testing.assert_array_equal(
                M, tgh._weighted_tensor(A, A.shape[0], width))
    rng = np.random.RandomState(0)
    dag = np.triu(rng.rand(7, 7) < 0.5, 1).astype(int)
    dist = np.arange(7)
    for a, b in zip(tgh.od_vectors_dag(dag, dist),
                    jgh.od_vectors_dag(dag, dist)):
        np.testing.assert_array_equal(a, b)


def test_graph_hopper_input_checks():
    with use_device("cpu"):
        with pytest.raises(ValueError, match="node attributes"):
            grakel_torch.GraphHopper().fit_transform([[np.ones((3, 3))]])
        with pytest.raises(ValueError):
            grakel_torch.GraphHopper(kernel_type="cosine").fit([])
        with pytest.raises(TypeError):
            grakel_torch.GraphHopper(kernel_type=3).fit([])


def test_graph_hopper_state_carry(cuneiform):
    """A fitted grakel_tpu GraphHopper's tensors and diameter bound
    carried into the port: transform equals the JAX package's."""
    fit, tr, jfit, jtr = cuneiform
    kj = grakel_tpu.GraphHopper().fit(jfit)
    kt = kernel_from_state("GraphHopper", {}, {
        "X": kj.X, "max_diam": kj._max_diam})
    with use_device("cpu"):
        T = kt.transform(tr)
    np.testing.assert_allclose(T, kj.transform(jtr), rtol=1e-5, atol=1e-12)
