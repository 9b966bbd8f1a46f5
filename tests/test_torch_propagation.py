"""grakel_torch's Propagation and PropagationAttr against grakel_tpu on
JAX-CPU: the host hashing pipeline (same numpy operations, same
RandomState draw order, the unseen-label branch with its two kept
quirks, the label-column order of a ``set`` with string labels) and the
device counts-Gram give Grams, transforms and diagonals exactly equal to
the JAX package's; past 2^24 they equal the exact integer Gram."""

import os

import numpy as np
import pytest

import grakel_tpu
import grakel_torch
from grakel_torch import use_device
from grakel_torch.convert import kernel_from_state
from grakel_torch.datasets import generate_dataset, read_data
from grakel_torch.estimator import NotFittedError

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def mutag():
    return read_data("MUTAG", path=DATA).data


@pytest.fixture(scope="module")
def cuneiform():
    return read_data("Cuneiform", path=DATA, prefer_attr_nodes=True).data


def _unseen(graphs, label=999):
    """Each graph with its first vertex relabeled ``label``."""
    out = []
    for edges, nl, el in graphs:
        nl2 = dict(nl)
        nl2[next(iter(nl2))] = label
        out.append([edges, nl2, el])
    return out


def _both(name, fit, tr, **kw):
    """fit_transform, diagonal, transform and both diagonals on
    grakel_tpu and on the port under use_device('cpu')."""
    out = []
    for mod in (grakel_tpu, grakel_torch):
        k = getattr(mod, name)(**kw)
        with use_device("cpu"):
            K = k.fit_transform(fit)
            d = k.diagonal()
            T = k.transform(tr)
            xd, yd = k.diagonal()
        out.append([np.asarray(x) for x in (K, d, T, xd, yd)])
    return out


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("M,t_max", [("TV", 5), ("H", 3), ("TV", 1)])
@pytest.mark.parametrize("normalize", [False, True])
def test_propagation_grams_equal(mutag, M, t_max, normalize):
    j, t = _both("Propagation", mutag[:60], mutag[60:80], random_state=11,
                 M=M, t_max=t_max, normalize=normalize)
    _assert_equal(t, j)


@pytest.mark.parametrize("M", ["TV", "H"])
def test_propagation_unseen_label_branch_equal(mutag, M):
    """Transform graphs with a label unseen at fit: old and new vertices
    hash apart, extra projection entries are drawn each round."""
    j, t = _both("Propagation", mutag[:30], _unseen(mutag[30:36]),
                 random_state=5, M=M)
    _assert_equal(t, j)


def test_propagation_generated_data_equal():
    train, test = generate_dataset(n_graphs=40, n_graphs_test=8,
                                   r_vertices=(3, 14), random_state=13,
                                   features=("nl", 6))
    j, t = _both("Propagation", train, test, random_state=0)
    _assert_equal(t, j)


def test_propagation_string_labels_equal(mutag):
    """String labels: the P column of each label (and so the projection
    entry it meets) follows the iteration order of a ``set`` built by
    the same operations in both packages; a fresh string label at
    transform takes the unseen-label branch."""
    sm = [[e, {k: "atom-%d" % v for k, v in nl.items()}, el]
          for e, nl, el in mutag]
    j, t = _both("Propagation", sm[:40], sm[40:60], random_state=2)
    _assert_equal(t, j)
    j, t = _both("Propagation", sm[:40], _unseen(sm[60:70], "fresh"),
                 random_state=2)
    _assert_equal(t, j)
    kj = grakel_tpu.Propagation(random_state=2).fit(sm[:40])
    with use_device("cpu"):
        kt = grakel_torch.Propagation(random_state=2).fit(sm[:40])
    assert list(kt._enum_labels) == list(kj._enum_labels)


def _intersection(x, y):
    return sum(min(x[k], y[k]) for k in x.keys() & y.keys())


def test_propagation_custom_metric_equal(mutag):
    """A metric other than the default dot takes the host pairwise loop
    in both packages."""
    j, t = _both("Propagation", mutag[:25], mutag[25:35], random_state=7,
                 metric=_intersection, t_max=3)
    _assert_equal(t, j)
    j, t = _both("Propagation", mutag[:25], _unseen(mutag[25:30]),
                 random_state=7, metric=_intersection, t_max=3)
    _assert_equal(t, j)


def test_propagation_user_transition_equal(mutag):
    """A user transition matrix as the fourth element of a graph."""
    rng = np.random.RandomState(3)
    items = []
    for edges, nl, el in mutag[:30]:
        g = grakel_torch.Graph(edges, nl)
        n = g.n
        T = rng.rand(n, n) * (rng.rand(n, n) < 0.4)
        items.append([edges, nl, el, T])
    j, t = _both("Propagation", items[:22], items[22:], random_state=4)
    _assert_equal(t, j)


@pytest.mark.parametrize("M", ["L1", "L2"])
@pytest.mark.parametrize("normalize", [False, True])
def test_propagation_attr_equal(cuneiform, M, normalize):
    j, t = _both("PropagationAttr", cuneiform[:30], cuneiform[30:40],
                 random_state=3, M=M, normalize=normalize)
    _assert_equal(t, j)


def test_propagation_attr_generated_equal():
    train, test = generate_dataset(n_graphs=30, n_graphs_test=6,
                                   r_vertices=(3, 12), random_state=8,
                                   features=("na", 3))
    j, t = _both("PropagationAttr", train, test, random_state=1, w=0.5)
    _assert_equal(t, j)


def test_propagation_fit_then_diagonal_and_transform(mutag):
    kj = grakel_tpu.Propagation(random_state=9).fit(mutag[:40])
    with use_device("cpu"):
        kt = grakel_torch.Propagation(random_state=9).fit(mutag[:40])
        assert np.array_equal(kt.diagonal(), kj.diagonal())
        assert np.array_equal(kt.transform(mutag[40:50]),
                              kj.transform(mutag[40:50]))


def test_propagation_checks(mutag, cuneiform):
    with use_device("cpu"):
        with pytest.raises(NotFittedError):
            grakel_torch.Propagation().transform(mutag[:2])
        for bad in ({"M": "L1"}, {"t_max": 0}, {"w": -1},
                    {"metric": 3}):
            with pytest.raises(TypeError):
                grakel_torch.Propagation(**bad).fit(mutag[:3])
        with pytest.raises(TypeError):
            grakel_torch.PropagationAttr(M="TV").fit(cuneiform[:3])
        with pytest.raises(ValueError):
            grakel_torch.Propagation().fit([])
        k = grakel_torch.PropagationAttr(random_state=0).fit(cuneiform[:5])
        flat = [[e, {v: a[:1] for v, a in nl.items()}, el]
                for e, nl, el in cuneiform[5:7]]
        with pytest.raises(ValueError, match="same dimension"):
            k.transform(flat)
        A = np.ones((3, 3))
        with pytest.raises(TypeError, match="same dimension"):
            grakel_torch.Propagation().fit(
                [[A, {0: 1, 1: 1, 2: 1}, {}, np.ones((2, 2))]])


@pytest.mark.parametrize("spec", [
    "propagation", "PR", "PK", {"name": "PK", "t_max": 3, "M": "H"}],
    ids=str)
def test_propagation_graph_kernel_names(mutag, spec):
    out = []
    for mod in (grakel_tpu, grakel_torch):
        gk = mod.GraphKernel(kernel=spec, random_state=6, normalize=True)
        with use_device("cpu"):
            out.append((gk.fit_transform(mutag[:30]),
                        gk.transform(mutag[30:40])))
    assert type(gk.kernel_) is grakel_torch.Propagation
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("spec", ["propagation_attr", "PRA"])
def test_propagation_attr_graph_kernel_names(cuneiform, spec):
    out = []
    for mod in (grakel_tpu, grakel_torch):
        gk = mod.GraphKernel(kernel=spec, random_state=6)
        with use_device("cpu"):
            out.append((gk.fit_transform(cuneiform[:20]),
                        gk.transform(cuneiform[20:30])))
    assert type(gk.kernel_) is grakel_torch.PropagationAttr
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _state(k):
    st = {"u": k._u, "b": k._b, "hd": k._hd, "X": k.X,
          "random_state": k.random_state_.get_state()}
    if k.attr_:
        st["dim"] = k._dim
    else:
        st.update(enum_labels=k._enum_labels, parent_labels=k._parent_labels)
    return st


@pytest.mark.parametrize("name,unseen", [("Propagation", False),
                                         ("Propagation", True),
                                         ("PropagationAttr", False)])
def test_propagation_state_carry(mutag, cuneiform, name, unseen):
    """A JAX-fitted kernel's projections, offsets, bucket dicts, label
    columns, fit bags and generator state carried into the port
    transform new graphs to the JAX package's Gram (the unseen-label
    branch draws from the carried generator)."""
    if name == "Propagation":
        fit = mutag[:30]
        tr = _unseen(mutag[30:38]) if unseen else mutag[30:38]
    else:
        fit, tr = cuneiform[:25], cuneiform[25:35]
    params = {"random_state": 12, "normalize": True}
    kj = getattr(grakel_tpu, name)(**params).fit(fit)
    state = _state(kj)
    Tj = kj.transform(tr)
    with use_device("cpu"):
        kt = kernel_from_state(name, params, state)
        Tt = kt.transform(tr)
    assert np.array_equal(Tt, Tj)


# --------------------------------------------------------------------- #
# count width: exact past 2^24
# --------------------------------------------------------------------- #

def _bag_dot(a, b, t_max):
    from grakel_tpu.kernels.propagation import _bag_counter
    total = 0
    for t in range(t_max):
        x, y = _bag_counter(a[t]), _bag_counter(b[t])
        total += sum(int(x[k]) * int(y[k]) for k in x.keys() & y.keys())
    return total


@pytest.fixture(scope="module")
def prop_large():
    """Four fit and two transform graphs of 5802-6374 vertices, all
    labeled 0, and the exact Grams of their bags, computed by the JAX
    package's hashing with the same seed (the transform's with a label
    unseen at fit on one graph, so the unseen-label branch runs)."""
    train, test = generate_dataset(
        n_graphs=8, n_graphs_test=2, r_vertices=(5500, 6500),
        r_connectivity=(0.001, 0.002), random_state=3, features=("nl", 2))
    fit, tr = train[:4], test
    kj = grakel_tpu.Propagation(random_state=0).fit(fit)
    kj._method_calling = 3
    by = kj.parse_input(tr)
    bx = kj.X
    K = np.array([[_bag_dot(a, b, 5) for b in bx] for a in bx], object)
    T = np.array([[_bag_dot(a, b, 5) for b in bx] for a in by], object)
    return fit, tr, K, T


@pytest.mark.parametrize("call", ["fit_transform", "transform"])
def test_propagation_counts_exact_past_2_24(prop_large, call):
    """A round adds at most m_x m_y to an entry; past 2^24 an f32 sum of
    counts rounds, so the port sums in f64 there, and its Grams and
    diagonals equal the exact integer Gram (the JAX package stays f32)."""
    fit, tr, Kx, Tx = prop_large
    assert Kx.max() > 2 ** 24 and Tx.max() > 2 ** 24
    with use_device("cpu"):
        k = grakel_torch.Propagation(random_state=0)
        if call == "fit_transform":
            K = k.fit_transform(fit)
            assert K.dtype == np.float64
            assert np.array_equal(K, Kx.astype(np.float64))
            assert np.array_equal(k.diagonal(), np.diagonal(Kx))
        else:
            T = k.fit(fit).transform(tr)
            assert np.array_equal(T, Tx.astype(np.float64))
            xd, yd = k.diagonal()
            assert np.array_equal(xd, np.diagonal(Kx))
            assert np.array_equal(
                yd, [_bag_dot(b, b, 5) for b in k._Y])
