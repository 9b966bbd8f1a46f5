"""grakel_torch stands alone: it imports neither jax, grakel_tpu nor
scikit-learn, never falls back to the CPU on its own, and carries its
own copies of the scikit-learn conventions it uses."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import grakel_torch
from grakel_torch import VertexHistogram, WeisfeilerLehman, use_device
from grakel_torch.device import current_device, resolve_device
from grakel_torch.estimator import NotFittedError, check_random_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "grakel_tpu", "sklearn")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "grakel_torch")):
        out += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return sorted(out)


def test_import_pulls_in_no_jax_or_grakel_tpu():
    code = ("import sys, pkgutil, importlib, grakel_torch\n"
            "for m in pkgutil.walk_packages(grakel_torch.__path__, "
            "'grakel_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\n"
            "print(','.join(bad))\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _tiny():
    A = np.array([[0, 1, 1], [1, 0, 0], [1, 0, 0]], float)
    return [[A, {0: "a", 1: "b", 2: "a"}], [A, {0: "b", 1: "b", 2: "a"}]]


def test_no_cuda_without_use_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_device"):
        WeisfeilerLehman().fit_transform(_tiny())
    with pytest.raises(RuntimeError, match="use_device"):
        VertexHistogram().fit_transform(_tiny())
    with use_device("cpu"):
        K = WeisfeilerLehman(n_iter=2).fit_transform(_tiny())
    assert K.shape == (2, 2)
    k = VertexHistogram()
    k.device = "cpu"
    assert k.fit_transform(_tiny()).shape == (2, 2)


def test_device_resolution_order(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert current_device() is None
    with use_device("cpu"):
        assert resolve_device() == torch.device("cpu")
        assert resolve_device("meta") == torch.device("meta")
        with use_device(None):
            with pytest.raises(RuntimeError):
                resolve_device()
        assert current_device() == torch.device("cpu")
    assert current_device() is None
    with pytest.raises(RuntimeError):
        resolve_device()


def test_estimator_conventions():
    assert issubclass(NotFittedError, ValueError)
    assert issubclass(NotFittedError, AttributeError)
    with use_device("cpu"), pytest.raises(NotFittedError):
        WeisfeilerLehman().transform(_tiny())
    wl = WeisfeilerLehman(n_iter=3, normalize=True)
    p = wl.get_params()
    assert p == {"base_graph_kernel": None, "n_iter": 3, "n_jobs": None,
                 "normalize": True, "verbose": False}
    assert wl.set_params(n_iter=2) is wl and wl.n_iter == 2
    with pytest.raises(ValueError):
        wl.set_params(bogus=1)
    rs = np.random.RandomState(3)
    assert check_random_state(rs) is rs
    assert check_random_state(None) is np.random.mtrand._rand
    assert check_random_state(7).randint(1000) == \
        np.random.RandomState(7).randint(1000)
    with pytest.raises(ValueError):
        check_random_state("seed")
    assert "WeisfeilerLehman(" in repr(wl)
    assert grakel_torch.__all__
