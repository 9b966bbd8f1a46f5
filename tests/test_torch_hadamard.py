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
    padded = np.zeros((N_pad, D), np.int32)
    padded[:len(codes)] = codes
    got = list(hc_ops.hadamard_generations(
        tb, torch.from_numpy(padded), torch.from_numpy(dims.view(np.int32)),
        n_iter))
    assert len(got) == len(want) == n_iter
    valid = tb.node_mask.numpy()
    for key, (j1, j2) in zip(got, want):
        h1, h2 = _unsigned(key)
        np.testing.assert_array_equal(h1[valid], np.asarray(j1)[valid])
        np.testing.assert_array_equal(h2[valid], np.asarray(j2)[valid])


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
