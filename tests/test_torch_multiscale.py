"""MultiscaleLaplacian of grakel_torch against grakel_tpu on JAX-CPU.

Both packages run the same host numpy f64 linear algebra (batched inv,
eig and eigvals) on the same draws of the numpy RandomState, so the
Grams are held to rtol 1e-5 (they agree to rounding), the generators
must end in the same state, with fit_transform, transform and both
diagonals, normalize off and on.
"""

import os

import numpy as np
import pytest

import grakel_torch
import grakel_tpu
from grakel_torch import use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import read_data
from grakel_tpu.datasets import read_data as jax_read_data

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def cuneiform():
    d = read_data("Cuneiform", path=DATA, prefer_attr_nodes=True).data
    j = jax_read_data("Cuneiform", path=DATA, prefer_attr_nodes=True).data
    return d[:24], d[24:30], j[:24], j[24:30]


def _run(k, fit, tr):
    K = k.fit_transform(fit)
    d0 = k.diagonal()
    T = k.transform(tr)
    xd, yd = k.diagonal()
    np.testing.assert_array_equal(d0, xd)
    return K, T, xd, yd


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("params", [
    {"random_state": 3}, {"random_state": 0, "L": 1, "P": 4,
                          "n_samples": 20},
    {"random_state": 5, "L": 2, "gamma": 0.1, "heta": 0.2}])
def test_multiscale_laplacian_matches_jax(cuneiform, params, normalize):
    fit, tr, jfit, jtr = cuneiform
    kt = grakel_torch.MultiscaleLaplacian(normalize=normalize, **params)
    kj = grakel_tpu.MultiscaleLaplacian(normalize=normalize, **params)
    with use_device("cpu"):
        got = _run(kt, fit, tr)
    ref = _run(kj, jfit, jtr)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)
    st, sj = kt.random_state_.get_state(), kj.random_state_.get_state()
    assert np.array_equal(st[1], sj[1]) and st[2:] == sj[2:]


def test_multiscale_laplacian_input_checks():
    with use_device("cpu"):
        with pytest.raises(ValueError, match="node attributes"):
            grakel_torch.MultiscaleLaplacian().fit([[np.ones((3, 3))]])
        for bad in ({"gamma": -1}, {"heta": "x"}, {"L": -1}, {"P": 0},
                    {"n_samples": 0}):
            with pytest.raises(TypeError):
                grakel_torch.MultiscaleLaplacian(**bad).fit([])


def test_multiscale_laplacian_state_carry(cuneiform):
    """A fitted grakel_tpu kernel's FLG terms and per-level bases carried
    into the port: transform equals the JAX package's."""
    fit, tr, jfit, jtr = cuneiform
    kj = grakel_tpu.MultiscaleLaplacian(random_state=3).fit(jfit)
    kt = kernel_from_state("MultiscaleLaplacian", {"random_state": 3}, {
        "X": kj.X, "data_level": kj._data_level})
    with use_device("cpu"):
        T = kt.transform(tr)
    np.testing.assert_allclose(T, kj.transform(jtr), rtol=1e-5, atol=1e-12)
