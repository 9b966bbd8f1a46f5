"""grakel_torch.svm.SVC (K15 / K16's plain versions on the CPU) against
scikit-learn's ``SVC(kernel="precomputed")`` at its defaults: the same
libsvm path, so the same support vectors, iteration counts and
predictions, and the coefficients and decision values to the last bits.
"""

import numpy as np
import pytest
import torch
from sklearn.svm import SVC as SkSVC

from grakel_torch import use_device
from grakel_torch.estimator import NotFittedError
from grakel_torch.ops import csvc
from grakel_torch.svm import SVC

CS = [1e-7, 1e-3, 0.1, 1.0, 100.0, 1e5]


def _gram(n, seed, k, dup=0, single=False):
    """A seeded PSD Gram (an RBF kernel on random points, ``dup`` of them
    repeated: tied rows) and ``k``-class labels; ``single``: the last
    class has one sample."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    y[:k] = np.arange(k)
    if single:
        y[k:] = rng.randint(0, k - 1, n - k)
    phi = rng.randn(n, 4) + 0.8 * y[:, None]
    if dup:
        src = rng.randint(0, n - dup, dup)
        phi[n - dup:], y[n - dup:] = phi[src], y[src]
    sq = (phi ** 2).sum(1)
    return np.exp(-0.25 * (sq[:, None] + sq[None, :] - 2 * phi @ phi.T)), y


def _both(K, y, n_fit, **kw):
    with use_device("cpu"):
        ours = SVC(**kw).fit(K[:n_fit, :n_fit], y[:n_fit])
    ref = SkSVC(kernel="precomputed", **kw).fit(K[:n_fit, :n_fit], y[:n_fit])
    return ours, ref


def _assert_same(ours, ref, Kt):
    for attr in ("classes_", "support_", "n_support_", "n_iter_"):
        np.testing.assert_array_equal(getattr(ours, attr),
                                      getattr(ref, attr), err_msg=attr)
    for attr in ("dual_coef_", "intercept_"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr),
                                   rtol=1e-12, atol=0, err_msg=attr)
    np.testing.assert_array_equal(ours.predict(Kt), ref.predict(Kt))
    np.testing.assert_allclose(ours.decision_function(Kt),
                               ref.decision_function(Kt), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("k", [2, 3, 5])
def test_svc_matches_sklearn(k, C):
    K, y = _gram(48, 10 * k, k, dup=4)
    ours, ref = _both(K, y, 36, C=C)
    _assert_same(ours, ref, K[36:, :36])


@pytest.mark.parametrize("k", [2, 4])
def test_svc_class_of_one_sample(k):
    K, y = _gram(40, 3, k, single=True)
    ours, ref = _both(K, y, 40, C=10.0)
    _assert_same(ours, ref, K[:12])


@pytest.mark.parametrize("C", [0.01, 1.0, 100.0])
def test_svc_matches_sklearn_on_a_graph_kernel(C):
    """A normalized WL Gram of MUTAG graphs: entries shared by many
    pairs, so libsvm's tie rules decide the path."""
    import os
    from grakel_torch import WeisfeilerLehman
    from grakel_torch.datasets import read_data
    b = read_data("MUTAG", path=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "data"))
    with use_device("cpu"):
        K = WeisfeilerLehman(n_iter=3, normalize=True).fit_transform(
            b.data[:90])
    y = np.asarray(b.target)[:90]
    ours, ref = _both(np.asarray(K, np.float64), y, 70, C=C)
    _assert_same(ours, ref, np.asarray(K, np.float64)[70:, :70])


def test_svc_long_run_with_shrinking_and_string_labels():
    """Duplicated rows at a large C: thousands of iterations, several
    shrinking rounds and the unshrink; string labels."""
    K, y = _gram(70, 5, 2, dup=10)
    labels = np.array(["neg", "pos"])[y]
    ours, ref = _both(K, labels, 70, C=1e4)
    assert ref.n_iter_[0] > 2 * 70
    _assert_same(ours, ref, K[:20])


def test_svc_errors():
    K, y = _gram(20, 1, 2)
    with use_device("cpu"):
        with pytest.raises(ValueError, match="greater than one"):
            SVC().fit(K, np.zeros(20, int))
        with pytest.raises(ValueError, match="precomputed"):
            SVC(kernel="rbf").fit(K, y)
        with pytest.raises(ValueError, match="square"):
            SVC().fit(K[:, :10], y)
        with pytest.raises(ValueError):
            SVC(C=0.0).fit(K, y)
        with pytest.raises(NotFittedError):
            SVC().predict(K)
        clf = SVC().fit(K, y)
        with pytest.raises(ValueError, match="number of samples at training"):
            clf.predict(K[:, :5])


def test_svc_runs_on_the_ambient_device_and_never_falls_back():
    K, y = _gram(20, 2, 2)
    with use_device("cpu"):
        clf = SVC().fit(K, y)
    assert clf.device_.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="use_device"):
            SVC().fit(K, y)


@pytest.mark.parametrize("smem_rows,warp_rows", [
    (0, 0), (20, 0), (35, 0), (10 ** 4, 0), (35, 2), (35, 20),
    (4096, 192), (0, 35)],
    ids=["0", "20", "35", "10000", "35-w2", "35-w20", "4096-w192", "0-w35"])
def test_k15_routes_split_problems_by_threshold(smem_rows, warp_rows):
    """Each size takes its route (warp up to ``warp_rows``, block up to
    the block limit ``smem_rows``, global past it), one launch a route,
    its problems C descending then rows descending, and each block or
    global problem its own aligned slot of the route's scratch."""
    lens = np.array([35, 7, 20, 21, 1, 2, 35, 0])
    C = np.array([1.0, 10.0, 1.0, 1e3, 0.1, 10.0, 1.0, 1.0])
    block = min(smem_rows, csvc.K15_BLOCK_ROWS)
    route = csvc.k15_routes(lens, warp_rows, block)
    np.testing.assert_array_equal(
        route, np.where(lens <= warp_rows, 0, np.where(lens <= block, 1, 2)))
    launches = csvc.k15_launches(lens, C, route)
    assert [L["route"] for L in launches] == [
        csvc.ROUTES[r] for r in sorted(set(route.tolist()))]
    per_row = {"warp": 0, "block": csvc.BLOCK_SCRATCH_BYTES,
               "global": csvc.GLOBAL_ROW_BYTES}
    for L in launches:
        o = L["order"].astype(np.int64)
        assert sorted(o) == np.nonzero(route == csvc.ROUTES.index(
            L["route"]))[0].tolist()
        key = list(zip(-C[o], -lens[o], o))
        assert key == sorted(key)
        assert L["cap"] == lens[o].max()
        ends = L["soff"] + lens[o] * per_row[L["route"]]
        assert (L["soff"] % 8 == 0).all() and (ends[:-1] <= L["soff"][1:]).all()
        assert L["scratch"] >= ends.max()
        T = L["threads"]
        assert T % 32 == 0
        if L["route"] == "block":
            R = L["rows_per_thread"]
            assert R in csvc.K15_BLOCK_R and T * R >= L["cap"]
            assert T <= csvc.K15_BLOCK_MAX_THREADS[R]
            prev = csvc.K15_BLOCK_R[csvc.K15_BLOCK_R.index(R) - 1]
            assert R == 1 or T * prev < L["cap"]
            assert L["smem"] >= L["cap"] * csvc.BLOCK_ROW_BYTES
        if L["route"] == "warp":
            assert L["smem"] == T // 32 * csvc.k15_warp_bytes(L["cap"])


def test_k15_block_shape_and_route_limits():
    assert csvc.k15_block_shape(3329) == (512, 8)
    assert csvc.k15_block_shape(3699) == (512, 8)
    assert csvc.k15_block_shape(4096) == (512, 8)
    assert csvc.k15_block_shape(3000) == (512, 6)
    assert csvc.k15_block_shape(2560) == (640, 4)
    assert csvc.k15_block_shape(3329, 448) == (448, 8)
    assert csvc.k15_block_shape(170) == (64, 3)
    assert csvc.k15_block_shape(1, 32) == (32, 1)
    for cap, T in ((3329, 256), (4097, 512), (100, 48), (100, 2048),
                   (3329, 640), (3329, 576), (100, 1024), (3000, 576)):
        with pytest.raises(ValueError):
            csvc.k15_block_shape(cap, T)
    with pytest.raises(ValueError):
        csvc.k15_routes([5], warp_rows=csvc.K15_WARP_MAX_ROWS + 1)
    with pytest.raises(ValueError):
        csvc.k15_routes([5], block_rows=csvc.K15_BLOCK_ROWS + 1)
    # a warp route block holds its problems within 96 KB
    for cap in (1, 18, 64, 128, csvc.K15_WARP_MAX_ROWS):
        w = csvc.k15_warps(cap)
        assert 1 <= w <= csvc.K15_WARPS
        assert w == 1 or w * csvc.k15_warp_bytes(cap) <= 96 * 1024
    assert csvc.k15_warp_bytes(csvc.K15_WARP_MAX_ROWS) <= 227 * 1024 - 8192


def _split_fits(K, y, seed, k_list=(2, 3, 6), Cs=(1e-3, 1.0, 100.0)):
    """The Cs of three splits, as a CV stage plans them: train and eval
    arrays shared by the Cs of a split."""
    rng = np.random.RandomState(seed)
    n = K.shape[0]
    fits, evals = [], []
    for k in k_list:
        idx = rng.permutation(n)
        tr, ev = idx[:2 * n // 3], idx[2 * n // 3:]
        lab = rng.randint(0, k, tr.shape[0])
        lab[:k] = np.arange(k)
        for C in Cs:
            fits.append((0, tr, lab, C))
            evals.append(ev)
    return fits, evals


def test_k16_vote_groups_and_compacted_rows():
    """A vote group is a split's Cs; its rows are the fit's training ids
    in grouped order, each problem's rows an ascending run of them; the
    compaction keeps each problem's nonzero rows in order."""
    K, y = _gram(60, 8, 3)
    fits, evals = _split_fits(K, y, 1)
    fits.append((0, fits[-1][1], fits[-1][2], 5.0))   # same split, new eval
    evals.append(evals[-1][:4])
    plan = csvc.plan_fits(fits, evals)
    groups, uni, upos = plan.vote_groups()
    np.testing.assert_array_equal(groups[:, :2], [[0, 3], [3, 3], [6, 3],
                                                  [9, 1]])
    for g, (f0, nf, u0, ul) in enumerate(groups):
        meta = plan.fits[f0]
        np.testing.assert_array_equal(
            uni[u0:u0 + ul], np.asarray(fits[f0][1])[meta["perm"]])
        for f in range(f0, f0 + nf):
            assert plan.fits[f]["group"] == g
            q0, q1 = plan.fits[f]["pair0"], plan.fits[f]["pair0"] + \
                plan.fits[f]["n_pairs"]
            for q in range(q0, q1):
                r = np.arange(plan.off[q], plan.off[q + 1])
                assert (np.diff(upos[r]) > 0).all()
                np.testing.assert_array_equal(uni[u0 + upos[r]], plan.ids[r])
    coef = torch.from_numpy(np.random.RandomState(2).randn(plan.ids.shape[0])
                            * (np.random.RandomState(3).rand(
                                plan.ids.shape[0]) < 0.4))
    off = torch.from_numpy(plan.off)
    cu, cc, coff = csvc.k16_compact(coef, off, torch.from_numpy(upos))
    for q in range(plan.n_problems):
        r = np.arange(plan.off[q], plan.off[q + 1])
        nz = r[coef.numpy()[r] != 0]
        np.testing.assert_array_equal(cu[coff[q]:coff[q + 1]].numpy(),
                                      upos[nz])
        np.testing.assert_array_equal(cc[coff[q]:coff[q + 1]].numpy(),
                                      coef.numpy()[nz])


def _k16_blocks_loop(groups, models, E, threads=csvc.K16_THREADS):
    """K16's block plan, one group at a time."""
    out = []
    for g, (m0, mg, _, _) in enumerate(groups):
        e_end = models[m0 + 1, 2] if m0 + 1 < len(models) else E
        pts = int(e_end - models[m0, 2])
        k = int(models[m0, 1])
        npair = k * (k - 1) // 2
        if pts <= 0 or npair <= 0:
            continue
        per = (threads if mg * npair == 1
               else min(max(threads // (mg * npair), 1), csvc.K16_POINTS))
        for s in range(0, pts, per):
            out.append((g, s, min(per, pts - s)))
    return np.array(out, np.int32).reshape(-1, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k16_blocks_vectorised_equals_the_loop(seed):
    K, y = _gram(90, seed, 3)
    fits, evals = _split_fits(K, y, seed, k_list=(2, 5, 30 if seed else 3),
                              Cs=(0.1, 1.0) if seed == 2 else (1.0,))
    evals[1] = evals[1][:0]                   # a model without eval points
    plan = csvc.plan_fits(fits, evals)
    models, _ = plan.models()
    for groups in (plan.groups, csvc.k16_single_groups(
            plan.off.astype(np.int64), models)[0]):
        np.testing.assert_array_equal(
            csvc.k16_blocks(groups, models, plan.eval_ids.shape[0]),
            _k16_blocks_loop(groups, models, plan.eval_ids.shape[0]))


def test_k16_single_groups_cover_each_model():
    K, y = _gram(50, 4, 4)
    plan = csvc.plan_fits([(0, np.arange(50), y, 1.0),
                           (0, np.arange(10, 40), y[10:40], 2.0)])
    models, _ = plan.models()
    groups, upos = csvc.k16_single_groups(plan.off.astype(np.int64), models)
    for m, (m0, mg, r0, rl) in enumerate(groups):
        assert (m0, mg) == (m, 1)
        np.testing.assert_array_equal(upos[r0:r0 + rl], np.arange(rl))


def test_k15_plain_is_one_solver_whatever_the_batch():
    """A problem solved in a batch of others (lockstep, padding, other
    sizes and Cs) gives what it gives alone, and what libsvm gives."""
    K, y = _gram(60, 9, 3, dup=5)
    fits = [(0, np.arange(40), y[:40], 1.0), (0, np.arange(10, 60),
                                               y[10:60], 1e3),
            (0, np.arange(0, 60, 2), y[0:60:2], 0.01)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    Kt = t(K)
    args = lambda plan: (Kt.float(), torch.diagonal(Kt).contiguous(),
                         t(plan.ids), t(plan.sign), t(plan.off), t(plan.C),
                         t(plan.gram))
    plan = csvc.plan_fits(fits)
    coef, rho, iters = csvc.smo_plain(*args(plan))
    for f, fit in enumerate(fits):
        one = csvc.plan_fits([fit])
        c1, r1, i1 = csvc.smo_plain(*args(one))
        q0, q1 = plan.fits[f]["pair0"], plan.fits[f]["pair0"] + 3
        assert torch.equal(coef[plan.off[q0]:plan.off[q1]], c1)
        assert torch.equal(rho[q0:q1], r1) and torch.equal(iters[q0:q1], i1)
        ref = SkSVC(kernel="precomputed", C=fit[3]).fit(
            K[np.ix_(fit[1], fit[1])], fit[2])
        np.testing.assert_array_equal(i1.numpy(), ref.n_iter_)


def _non_finite(K, case):
    K = K.copy()
    if case == "nan_row":
        K[3, :] = np.nan
        K[:, 3] = np.nan
    elif case == "inf_diag":
        K[3, 3] = np.inf
    elif case == "neg_inf":
        K[2, 7] = -np.inf
    else:                       # NaN and infinity: NaN's message first
        K[1, 1] = np.inf
        K[8, 2] = np.nan
    return K


@pytest.mark.parametrize("case", ["nan_row", "inf_diag", "neg_inf",
                                  "nan_and_inf"])
def test_svc_fit_rejects_a_non_finite_gram_as_sklearn(case, monkeypatch):
    """scikit-learn's message, raised on the host before the solver
    starts (the dispatcher is never reached)."""
    K, y = _gram(12, 4, 2)
    K = _non_finite(K, case)
    with pytest.raises(ValueError) as ref:
        SkSVC(kernel="precomputed").fit(K, y)

    def no_solve(*a, **k):
        raise AssertionError("the solver started on a non-finite Gram")

    monkeypatch.setattr(csvc, "smo", no_solve)
    with use_device("cpu"), pytest.raises(ValueError) as ours:
        SVC().fit(K, y)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("method", ["predict", "decision_function"])
def test_svc_predict_rejects_a_non_finite_gram_as_sklearn(method, value,
                                                          monkeypatch):
    K, y = _gram(20, 6, 3)
    ref = SkSVC(kernel="precomputed").fit(K[:12, :12], y[:12])
    with use_device("cpu"):
        ours = SVC().fit(K[:12, :12], y[:12])
    Kt = K[12:, :12].copy()
    Kt[2, 5] = value
    with pytest.raises(ValueError) as want:
        getattr(ref, method)(Kt)
    monkeypatch.setattr(csvc, "vote", lambda *a, **k: 1 / 0)
    with pytest.raises(ValueError) as got:
        getattr(ours, method)(Kt)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("where", ["gram", "diag", "vote"])
def test_csvc_dispatchers_refuse_a_non_finite_gram(where):
    """The plain route refuses NaN or infinity in any Gram the batch
    reads (libsvm's loop would never end); a bad Gram no problem reads
    does not matter."""
    K, y = _gram(30, 5, 3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    Ks = t(np.stack([K, K]))
    plan = csvc.plan_fits([(0, np.arange(20), y[:20], 1.0)],
                          [np.arange(20, 30)])
    Kf, diag = Ks.float(), torch.diagonal(Ks, dim1=1, dim2=2).contiguous()
    args = (t(plan.ids), t(plan.sign), t(plan.off), t(plan.C), t(plan.gram))
    Kf[1, 4, 4] = np.nan                          # Gram 1: no problem's
    coef, rho, _ = csvc.smo(Kf, diag, *args)
    models, mg = plan.models()
    vin = (t(plan.eval_ids), args[0], coef, args[2], rho, t(models), t(mg))
    Ks[1, 0, 0] = np.inf
    csvc.vote(Ks, *vin)
    with pytest.raises(ValueError, match="NaN or infinity"):
        if where == "gram":
            Kf[0, 3, 5] = np.inf
            csvc.smo(Kf, diag, *args)
        elif where == "diag":
            diag[0, 2] = np.nan
            csvc.smo(Kf, diag, *args)
        else:
            Ks[0, 25, 3] = np.nan
            csvc.vote(Ks, *vin)
