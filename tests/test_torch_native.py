"""grakel_torch's native host engines (``grakel_torch/native``): the
port's own build of the C++ sources, held bit for bit against
grakel_tpu.native's on the same inputs, and against the plain Python
versions; the build under concurrent first use and when it fails."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import grakel_tpu.native as jn
import grakel_torch.native as tn
from grakel_torch import _build
from jax_native_ref import jax_native  # noqa: F401 (fixture)

# the expected values come from grakel_tpu's native engine: load it
# first (see jax_native_ref)
pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graphs(seed, count, lo=5, hi=20, p=0.25, directed=False):
    """(n, senders, receivers, labels) of random graphs from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        n = rng.randint(lo, hi + 1)
        A = rng.rand(n, n) < p
        np.fill_diagonal(A, False)
        if not directed:
            A = np.triu(A, 1)
            A = A | A.T
        s, r = np.nonzero(A)
        out.append((n, s.astype(np.int32), r.astype(np.int32),
                    rng.randint(0, 4, n)))
    return out


def _csr(graphs):
    """Batch CSR: node_off, adj_off, adj (local targets), labels."""
    node_off = np.zeros(len(graphs) + 1, np.int64)
    node_off[1:] = np.cumsum([g[0] for g in graphs])
    degs, adj, labs = [], [], []
    for n, s, r, lab in graphs:
        order = np.argsort(s, kind="stable")
        adj.append(r[order])
        degs.append(np.bincount(s, minlength=n))
        labs.append(lab)
    adj_off = np.zeros(int(node_off[-1]) + 1, np.int64)
    adj_off[1:] = np.cumsum(np.concatenate(degs))
    return (node_off, adj_off, np.concatenate(adj).astype(np.int32),
            np.concatenate(labs).astype(np.int64))


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (set, frozenset)):
        return a == b
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clique_values_bit_equal_to_jax_and_python(seed):
    rng = np.random.RandomState(seed)
    for nv in (0, 1, 9, 17):
        cv = rng.rand(nv) + 0.5
        ce = rng.choice([-1.0, 0.0, 0.0, 0.7, 1.0, 2.0], size=(nv, nv))
        ce = np.triu(ce, 1)
        ce = ce + ce.T
        for kmax in (1, 3, 5):
            got = tn.clique_values(cv, ce, kmax)
            assert _same(got, jn.clique_values(cv, ce, kmax))
            tv = np.zeros(kmax + 1)
            tn._clique_values_py(nv, kmax, cv, ce, tv)
            assert np.array_equal(got, tv)


def test_ap_hash_batch_bit_equal_to_jax_and_python():
    rng = np.random.RandomState(3)
    strs = ["", "a", "0,1|1,2.", "héllo wörld", "x" * 1000] + [
        "".join(chr(rng.randint(32, 0x250)) for _ in range(rng.randint(60)))
        for _ in range(50)]
    got = tn.ap_hash_batch(strs)
    assert _same(got, jn.ap_hash_batch(strs))
    assert got.tolist() == [tn._ap_hash_py(s.encode("utf-8")) for s in strs]
    assert _same(tn.ap_hash_batch([]), jn.ap_hash_batch([]))


@pytest.mark.parametrize("R,D", [(0, 0), (1, 2), (3, 4)])
def test_nspd_hash_graph_bit_equal_to_jax(R, D):
    for n, s, r, lab in _graphs(4 + R, 12) + [(1, np.zeros(0, np.int32),
                                               np.zeros(0, np.int32),
                                               np.zeros(1, int))]:
        enc = np.unique(s.astype(np.int64) * n + r)
        es, ed = (enc // n).astype(np.int32), (enc % n).astype(np.int32)
        vl = [str(x) for x in lab]
        el = [str((a + b) % 3) for a, b in zip(es, ed)]
        args = (n, s, r, es, ed, vl, el, R, D)
        assert _same(tn.nspd_hash_graph(*args), jn.nspd_hash_graph(*args))


@pytest.mark.parametrize("directed", [False, True])
def test_canonical_labeling_bit_equal_to_jax(directed):
    for n, s, r, lab in _graphs(7, 15, 1, 9, 0.4, directed):
        args = (n, s, r, lab.astype(np.int32), directed)
        assert _same(tn.canonical_labeling_native(*args),
                     jn.canonical_labeling_native(*args))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_connected_subsets_equal_to_jax(k):
    for n, s, r, _ in _graphs(8, 8, 3, 10, 0.3):
        G = {v: set() for v in range(n)}
        for a, b in zip(s, r):
            G[int(a)].add(int(b))
        assert tn.connected_subsets_native(G, k) == \
            jn.connected_subsets_native(G, k)


@pytest.mark.parametrize("h", [-1, 1, 3])
def test_odd_sth_decompose_bit_equal_to_jax(h):
    node_off, adj_off, adj, labs = _csr(_graphs(9, 20))
    ids = labs * 7919 - 3
    got = tn.odd_sth_decompose_native(node_off, adj_off, adj, labs, ids, h)
    assert _same(got, jn.odd_sth_decompose_native(node_off, adj_off, adj,
                                                  labs, ids, h))


def test_sp_bfs_counts_bit_equal_to_jax():
    node_off, adj_off, adj, labs = _csr(_graphs(10, 20))
    labs = labs.astype(np.int32)
    got = tn.sp_bfs_counts_native(node_off, adj_off, adj, labs, 4, 64)
    assert _same(got, jn.sp_bfs_counts_native(node_off, adj_off, adj, labs,
                                              4, 64))
    with pytest.raises(ValueError):
        tn.sp_bfs_counts_native(node_off, adj_off, adj, labs, 4, 2)


def test_native_builds_once_under_concurrent_first_use(tmp_path):
    """Two processes building into one empty directory at once: both
    load a whole library and compute with it; one library file."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import numpy as np\n"
            "from grakel_torch import _build, native\n"
            "_build.NATIVE_DIR = %r\n"
            "print(native.clique_values(np.ones(3), np.ones((3, 3)), 3))\n"
            % (ROOT, str(tmp_path)))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["[3.", "3.", "1.", "0.]"]
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and libs[0].startswith("libgrakel_native_")


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", str(src))
    monkeypatch.setattr(_build, "NATIVE_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="native build failed") as e:
        _build.build_native()
    assert "undeclared_name" in str(e.value)


def test_native_builds_without_openmp(tmp_path, monkeypatch):
    """The sources compile without -fopenmp (the build a compiler that
    refuses it takes), and the engines give the same results."""
    monkeypatch.setattr(_build, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_openmp_flags", lambda gxx: [])
    path = _build.build_native()
    # named by the flags used: never taken for an OpenMP build
    sources = sorted(glob.glob(os.path.join(_build.NATIVE_SRC, "*.cpp")))
    assert _build._digest(sources, _build.GXX_FLAGS) in path
    assert _build._digest(sources, _build.GXX_FLAGS + ["-fopenmp"]) \
        not in path
    import ctypes
    lib = ctypes.CDLL(path)
    tn._declare(lib)
    monkeypatch.setattr(tn, "_lib", lib)
    node_off, adj_off, adj, labs = _csr(_graphs(11, 10))
    assert _same(tn.odd_sth_decompose_native(node_off, adj_off, adj, labs,
                                             labs, -1),
                 jn.odd_sth_decompose_native(node_off, adj_off, adj, labs,
                                             labs, -1))
    assert _same(tn.sp_bfs_counts_native(node_off, adj_off, adj,
                                         labs.astype(np.int32), 4, 64),
                 jn.sp_bfs_counts_native(node_off, adj_off, adj,
                                         labs.astype(np.int32), 4, 64))


def test_have_native_true_here_and_as_jax():
    assert tn.have_native() is True
    assert tn.have_native() == jn.have_native()


def test_have_native_false_when_the_build_fails(tmp_path, monkeypatch):
    """A query only: False when the engines cannot build, and the engines
    still raise with the compiler's output."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", str(src))
    monkeypatch.setattr(_build, "NATIVE_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(tn, "_lib", None)
    assert tn.have_native() is False
    with pytest.raises(RuntimeError, match="native build failed"):
        tn.clique_values(np.ones(3), np.ones((3, 3)), 3)


def test_no_module_picks_a_route_by_have_native():
    """No module of grakel_torch reads have_native: the engines raise
    when they cannot build, and no path falls back on Python."""
    import ast
    pkg = os.path.join(ROOT, "grakel_torch")
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                used = (isinstance(node, ast.Name) and node.id == "have_native"
                        or isinstance(node, ast.Attribute)
                        and node.attr == "have_native"
                        or isinstance(node, ast.alias)
                        and node.name == "have_native")
                assert not used, "%s:%d reads have_native" % (
                    os.path.relpath(path, ROOT), node.lineno)
