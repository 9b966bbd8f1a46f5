"""The import check: whole top-level names; the references load nothing
of grakel_torch, JAX or the JAX package; the harness loads no JAX; a
checkout of the benchmark alone cannot run."""

import json
import os
import shutil
import subprocess
import sys

from bench_port.importcheck import FORBIDDEN, forbidden_loaded
from bench_port.manifest import ROOT

_REF = """
import json, sys
import numpy as np
from bench_port.manifest import Manifest
from bench_port import svm_ref
from bench_port.graphs import make_dataset
man = Manifest()
fit, _ = make_dataset(dict(man.config("wl_nci1")["data"], graphs=40,
                           held_out=2), 3)
K = man.reference("wl_nci1").gram(fit, {"n_iter": 5, "normalize": True})
man.reference("sp_nci1").gram(fit, {})
y = np.arange(40) % 2
svm_ref.cross_validate(K, y, 1, 3, 0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_top_level_names():
    mods = {"grakel_torch": 1, "grakel_torch.ops": 1, "jaxlib.xla": 1,
            "grakel_tpu_like": 1, "flaxen": 1, "numpy": 1}
    assert forbidden_loaded(modules=mods) == ["jaxlib"]
    assert forbidden_loaded(modules={"grakel_tpu.kernels": 1}) == \
        ["grakel_tpu"]


def test_references_load_nothing_of_the_program_or_jax():
    loaded = _loaded(_REF)
    assert not loaded & (FORBIDDEN | {"grakel_torch"})


def test_harness_modules_load_no_jax():
    loaded = _loaded("import bench_port.run, bench_port.trace, "
                     "bench_port.control, json, sys; print(json.dumps("
                     "sorted({m.split('.')[0] for m in sys.modules})))")
    assert not loaded & (FORBIDDEN | {"grakel_torch"})


def test_a_checkout_of_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("from bench_port.run import run_cell; "
            "print(run_cell('wl_nci1.fit', 1, 0.1, 0, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0 and "grakel_torch" in out.stderr
    assert not out.stdout.strip()
    cli = subprocess.run([sys.executable, "-m", "bench_port.run",
                          "--workload", "wl_nci1.fit", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert cli.returncode != 0 and not cli.stdout.strip()
