"""Interop utilities: a precomputed-kernel pipeline transformer, K-Fold
SVM cross-validation, and converters from networkx / pandas / csv /
torch-geometric into grakel_torch graph inputs.

The counterpart of ``grakel_tpu/utils.py`` (API parity with the
reference ``grakel.utils``, utils.py:26-801), without scikit-learn:
:class:`KMTransformer` stands on :mod:`grakel_torch.estimator`, and a
scikit-learn ``Bunch`` is read through its ``mat`` attribute by duck
typing; :func:`cross_validate_Kfold_SVM` on the port's own splitters
(:mod:`grakel_torch.model_selection`), scorers
(:mod:`grakel_torch.metrics`) and C-SVC (:mod:`grakel_torch.svm`, K15
and K16 on a card).  ``networkx`` and ``pandas`` are imported by the
converters that read them, never at module import.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .device import resolve_device
from .estimator import BaseEstimator, NotFittedError, check_random_state
from .graph import Graph
from .profiling import host_span

__all__ = ["KMTransformer", "cross_validate_Kfold_SVM",
           "graph_from_networkx", "graph_from_pandas", "graph_from_csv",
           "graph_from_torch_geometric"]


def _valid_matrix(K, transform=False):
    try:
        if hasattr(K, "toarray"):
            K = K.toarray()
        M = np.asarray(K, dtype=float)
        ok = M.ndim == 2
    except Exception:
        ok, M = False, None
    return (ok, M) if transform else ok


class KMTransformer(BaseEstimator):
    """Index into a precomputed kernel matrix inside sklearn-style
    pipelines (reference utils.py:26-141): ``fit(idx)`` keeps the row
    indices, ``fit_transform(idx)`` returns ``K[idx][:, idx]`` and
    ``transform(idx2)`` ``K[idx2][:, idx]``."""

    def __init__(self, K=None):
        self.K = K
        self._initialized = {"K": False}

    def initialize(self):
        if not self._initialized["K"]:
            if self.K is None:
                M = np.array([[1.0]])
            else:
                K = self.K
                if isinstance(K, dict) or hasattr(K, "mat"):
                    # a scikit-learn Bunch (a dict with attribute access)
                    try:
                        K = K.mat
                    except AttributeError:
                        raise ValueError(
                            "If in an sklearn Bunch K must be under mat")
                flag, M = _valid_matrix(K, transform=True)
                if not flag:
                    raise ValueError("The provided K cannot be converted "
                                     "to a two dimensional np.array.")
            self.K_ = M
            self._initialized["K"] = True

    def _check_indices(self, X):
        if any(x < 0 or x > self.K_.shape[0] for x in X):
            raise ValueError("index out of bounds of the kernel matrix")

    def fit(self, X, y=None):
        self.initialize()
        self._check_indices(X)
        self.X = np.array(X)
        return self

    def fit_transform(self, X, y=None):
        self.fit(X)
        return self.K_[self.X, :][:, self.X]

    def transform(self, X):
        if not hasattr(self, "X"):
            raise NotFittedError("This KMTransformer instance is not "
                                 "fitted yet; call fit first")
        self._check_indices(X)
        return self.K_[X, :][:, self.X]

    def set_params(self, **params):
        super().set_params(**params)
        self._initialized["K"] = False
        return self


# --------------------------------------------------------------------- #
class _NonFinite:
    """The NaN and infinite entries of a Gram, to find the first block of
    the reference's loop that holds one."""

    def __init__(self, M):
        r, c = np.nonzero(~np.isfinite(M))
        self.r, self.c, self.n = r, c, M.shape[0]
        self.nan = np.isnan(M[r, c])
        self.any = bool(r.size)

    def message(self, fit, ev):
        """scikit-learn's message for the first of the fit block
        ``M[fit, fit]`` and the eval block ``M[ev, fit]`` that holds NaN
        or infinity (NaN first within a block), else None."""
        if not self.any:
            return None
        from .svm import INF_MESSAGE, NAN_MESSAGE
        cols = np.zeros(self.n, bool)
        cols[fit] = True
        for rows in (fit, ev):
            m = np.zeros(self.n, bool)
            m[rows] = True
            hit = m[self.r] & cols[self.c]
            if hit.any():
                return NAN_MESSAGE if self.nan[hit].any() else INF_MESSAGE
        return None


def _plan_stage(fits, evals):
    """The K15 / K16 plan of a stage's fits (a list of (gram index, train
    ids, labels, C) with its eval ids) and K16's model table: (plan,
    models, model grams).  Host work only."""
    from .ops import csvc
    plan = csvc.plan_fits(fits, evals)
    return (plan,) + plan.models()


def _solve_stage(planned, grams, dev, want_dec=False):
    """Every fit of a stage (``planned``, from :func:`_plan_stage`) in one
    K15 launch and one K16 launch on ``dev``.
    Returns (plan, coef on ``dev``, and rho, iters, pred and, with
    ``want_dec``, K16's decision values (else None) as host arrays), plus
    the stage's record: its problems, iterations and
    active rows summed over the problems, the iterations of its longest
    problem, largest problem and, on a
    card, K15's routes; with ``cross_validate_Kfold_SVM.keep_last`` set,
    also its plan and the kernels' inputs and outputs on ``dev``."""
    import torch
    from .ops import csvc
    Kf, diag, K64 = grams
    plan, models, mgram = planned
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    smo_in = (Kf, diag, t(plan.ids), t(plan.sign), t(plan.off), t(plan.C),
              t(plan.gram))
    work = torch.zeros(plan.n_problems, dtype=torch.int64, device=dev)
    coef, rho, iters = csvc.smo(*smo_in, work=work)
    vote_in = (K64, t(plan.eval_ids), smo_in[2], coef, smo_in[4], rho,
               t(models), t(mgram))
    dec, pred = csvc.vote(*vote_in, groups=plan.vote_groups())
    iters_h = iters.cpu().numpy()
    record = {"problems": plan.n_problems, "max_rows": plan.max_rows,
              "iterations": int(iters_h.astype(np.int64).sum()),
              "max_iterations": int(iters_h.max(initial=0)),
              "active_rows": int(work.sum()),
              "route": (dict(csvc.smo_cuda.last_route)
                        if dev.type == "cuda" and plan.n_problems else None)}
    if cross_validate_Kfold_SVM.keep_last:
        record.update(plan=plan, smo_inputs=smo_in,
                      smo_out=(coef, rho, iters), vote_inputs=vote_in,
                      vote_out=(dec, pred))
    return (plan, coef, rho.cpu().numpy(), iters_h, pred.cpu().numpy(),
            dec.cpu().numpy() if want_dec else None), record


def cross_validate_Kfold_SVM(K, y, n_iter=10, n_splits=10, C_grid=None,
                             random_state=None, scoring="accuracy",
                             fold_reduce=None):
    """Repeated K-Fold CV of precomputed-kernel SVMs with inner model
    selection: ``grakel_tpu.utils.cross_validate_Kfold_SVM``, the same
    signature, draws and scores (reference utils.py:144-230).

    ``K`` is a list whose elements are kernel matrices or iterables of
    kernel matrices (a per-element grid of variants).  Every outer fold
    picks the first (variant, C) with the strictly highest score on a
    single 90/10 split of its training block, refits that model on the
    whole block and scores the held-out fold; each iteration's fold
    scores are collapsed with ``fold_reduce`` (default ``np.mean``).
    ``C_grid`` defaults to ``10 ** [-7, -5, ..., 5] / len(y)``;
    ``scoring`` is a name :func:`grakel_torch.metrics.get_scorer` knows
    or a callable ``scorer(estimator, X, y)``, which receives a fitted
    :class:`grakel_torch.svm.SVC`.  A named scorer reads each fit's
    predictions or, for ``"roc_auc"``, ``"average_precision"`` and
    ``"top_k_accuracy"``, its decision values as
    ``SVC.decision_function`` gives them, both from the stage's K16
    output; a fit whose score is NaN is never picked, and a fold whose
    inner fits all score NaN raises ``TypeError`` as the JAX function
    does.  Returns one list of ``n_iter`` reduced scores per element of
    ``K``.

    Every draw comes from ``check_random_state(random_state)`` in the
    JAX function's order (the ``n_iter`` KFold shuffles, then a
    ShuffleSplit a (element, iteration, fold)), and, as scikit-learn's
    ``SVC.fit`` draws a libsvm seed from numpy's global generator, one
    ``randint`` a fit from it, so ``random_state=None`` gives the same
    folds too.  No draw depends on a fit, so all are taken first; then
    every inner fit runs in one K15 launch and its predictions in one
    K16 launch, and every refit likewise (two launches each a call).
    Runs on the ambient device (:func:`grakel_torch.use_device`), else
    the card; each distinct Gram is uploaded once, f32 for libsvm's Q and
    f64 for the diagonal and the predictions.

    Like scikit-learn's ``SVC``, a fit or an evaluation whose Gram block
    holds NaN or infinity raises ``ValueError`` with scikit-learn's
    message: the first such fit in the JAX function's loop order decides
    it (its fit block, then its eval block; NaN before infinity), checked
    on the host before any launch."""
    import torch
    from .metrics import _DecisionScorer, _PredictScorer, get_scorer
    from .model_selection import KFold, ShuffleSplit
    from .svm import SVC, _decision_scores

    y = np.asarray(y)
    if C_grid is None:
        Cs = (10.0 ** np.arange(-7, 7, 2)) / y.shape[0]
    else:
        Cs = np.asarray(C_grid, dtype=float).reshape(-1)
    if fold_reduce is None:
        fold_reduce = np.mean
    elif not callable(fold_reduce):
        raise ValueError("fold_reduce should be a callable")
    rng = check_random_state(random_state)
    scorer = get_scorer(scoring)

    def variants_of(ks):
        ok, M = _valid_matrix(ks, transform=True)
        if ok:
            return [M]
        if hasattr(ks, "__iter__"):
            checked = [_valid_matrix(k, transform=True) for k in ks]
            if checked and all(ok for ok, _ in checked):
                return [M for _, M in checked]
        raise ValueError("Not a valid object for kernel matrix/ces")

    grids = [variants_of(ks) for ks in K]
    n = y.shape[0]
    with host_span("cv.draws"):
        folds = [list(KFold(n_splits=n_splits, shuffle=True,
                            random_state=rng).split(y))
                 for _ in range(n_iter)]
        global_rng = check_random_state(None)
        seed_max = np.iinfo("i").max
        inner = []                 # [element][iteration][fold]
        for variants in grids:
            per_iter = []
            for splits in folds:
                per_fold = []
                for train, _ in splits:
                    pos_tr, pos_val = next(iter(ShuffleSplit(
                        n_splits=1, test_size=0.1,
                        random_state=rng).split(train)))
                    per_fold.append((train[pos_tr], train[pos_val]))
                    for _ in range(len(variants) * len(Cs) + 1):
                        global_rng.randint(seed_max)
                per_iter.append(per_fold)
            inner.append(per_iter)

    dev = resolve_device()
    with host_span("cv.check"):
        mats, index = [], {}
        for variants in grids:
            for M in variants:
                if id(M) not in index:
                    if M.shape[0] < n or M.shape[1] < n:
                        raise IndexError("a kernel matrix of shape %s for "
                                         "%d labels" % (M.shape, n))
                    index[id(M)] = len(mats)
                    mats.append(np.ascontiguousarray(M[:n, :n]))
        gid = [[index[id(M)] for M in variants] for variants in grids]
        # a Gram's NaN and infinite entries: the fits and evaluations that
        # read one raise scikit-learn's error below, before any launch;
        # the others never read them, so the upload holds 0 in their place
        bad = [_NonFinite(M) for M in mats]
        up = [np.where(np.isfinite(M), M, 0.0) if b.any else M
              for M, b in zip(mats, bad)]
        up = np.stack(up) if up else np.zeros((0, n, n))
    K64 = torch.from_numpy(up).to(dev)
    grams = (K64.float(), torch.diagonal(K64, dim1=1, dim2=2).contiguous(),
             K64)
    records = []

    def scores_of(fits, evals, planned=None):
        if planned is None:
            with host_span("cv.plan"):
                planned = _plan_stage(fits, evals)
        by_name = isinstance(scorer, _PredictScorer)
        by_dec = isinstance(scorer, _DecisionScorer)
        (plan, coef, rho, iters, pred, dec), rec = _solve_stage(
            planned, grams, dev, want_dec=by_dec)
        records.append(rec)
        if not by_name:
            # a callable scorer gets a fitted SVC, which predicts on the
            # device
            coef_h = coef.cpu().numpy()
            return [scorer(SVC(C=C)._set_solution(plan, f, coef_h, rho,
                                                  iters, dev, tr.shape[0]),
                           mats[g][np.ix_(ev, tr)], y[ev])
                    for f, ((g, tr, _, C), ev) in enumerate(zip(fits,
                                                                evals))]
        d0 = planned[1][:, 3]            # each fit's first decision value
        out = []
        with host_span("cv.score"):
            for f, ev in enumerate(evals):
                classes = plan.fits[f]["classes"]
                scorer.check_classes(classes)
                e0, e1 = plan.eval_off[f], plan.eval_off[f + 1]
                if not by_dec:
                    out.append(scorer.score(y[ev], classes[pred[e0:e1]]))
                    continue
                # the fit's [points, pairs] block of K16's output
                npair = plan.fits[f]["n_pairs"]
                block = dec[d0[f]:d0[f] + (e1 - e0) * npair].reshape(
                    e1 - e0, npair)
                y_score = _decision_scores(block, classes.shape[0])
                out.append(scorer.score_dec(
                    y[ev], scorer.oriented(classes, y_score)))
        return out

    def pick(keys, scores):
        best = {}
        for key, s in zip(keys, scores):
            b = best.setdefault(key[:3], (-np.inf, None))
            if s > b[0]:
                best[key[:3]] = (s, key[3:])
        return best

    with host_span("cv.plan"):
        fits1, evals1, keys = [], [], []
        for e, variants in enumerate(grids):
            for t, splits in enumerate(folds):
                for f in range(len(splits)):
                    sub_tr, sub_val = inner[e][t][f]
                    for v in range(len(variants)):
                        for C in Cs:
                            fits1.append((gid[e][v], sub_tr, y[sub_tr], C))
                            evals1.append(sub_val)
                            keys.append((e, t, f, v, C))
        # with a non-finite Gram, its errors come before any plan's
        planned1 = None if any(b.any for b in bad) \
            else _plan_stage(fits1, evals1)

    scores1 = None
    if planned1 is None:
        # the reference's order: a fold's inner fits (each its fit block,
        # then its eval block), then its refit on the chosen variant
        fail, n1 = None, len(fits1)
        for x, (g, tr, _, _) in enumerate(fits1):
            fail = bad[g].message(tr, evals1[x])
            if fail is not None:
                n1 = keys.index(keys[x][:3] + (0, Cs[0]))
                break
        refit = {}
        for key in keys[:n1]:
            e, t, f = key[:3]
            if key[3:] == (0, Cs[0]):
                train, test = folds[t][f]
                refit[(e, t, f)] = [bad[g].message(train, test)
                                    for g in gid[e]]
        best = None
        for fk, ms in refit.items():
            if all(m is None for m in ms):
                continue
            if len(set(ms)) > 1 and best is None:
                # which refit raises depends on the chosen variant: the
                # inner fits before the failing fold, whose blocks are
                # finite, decide it
                scores1 = scores_of(fits1[:n1], evals1[:n1])
                best = pick(keys[:n1], scores1)
            m = ms[0] if len(set(ms)) == 1 else ms[best[fk][1][0]]
            if m is not None:
                raise ValueError(m)
        if fail is not None:
            raise ValueError(fail)
    if scores1 is None:
        scores1 = scores_of(fits1, evals1, planned1)
    with host_span("cv.plan"):
        best = pick(keys, scores1)
        fits2, evals2 = [], []
        for e, variants in enumerate(grids):
            for t, splits in enumerate(folds):
                for f, (train, test) in enumerate(splits):
                    v, C = best[(e, t, f)][1]
                    fits2.append((gid[e][v], train, y[train], C))
                    evals2.append(test)
        planned2 = _plan_stage(fits2, evals2)
    scores2 = iter(scores_of(fits2, evals2, planned2))
    cross_validate_Kfold_SVM.last = {"stages": records, "device": dev}
    results = []
    for e in range(len(grids)):
        per_iter = []
        for splits in folds:
            per_iter.append(fold_reduce([next(scores2) for _ in splits]))
        results.append(per_iter)
    return results


# the last call's stages (see _solve_stage); keep_last keeps their
# tensors too (the smoke reads them), else they go with the call
cross_validate_Kfold_SVM.last = None
cross_validate_Kfold_SVM.keep_last = False


# --------------------------------------------------------------------- #
def graph_from_networkx(X, node_labels_tag=None, edge_labels_tag=None,
                        edge_weight_tag=None, as_Graph=False,
                        val_node_labels=None, val_edge_labels=None):
    """networkx graphs -> grakel_torch inputs (generator; reference
    utils.py:233-360, networkx >= 2 semantics)."""
    if not hasattr(X, "__iter__"):
        raise ValueError("X must be an iterable")
    for G in X:
        graph_object = {}
        nl = ({} if (node_labels_tag is not None
                     or val_node_labels is not None) else None)
        el = ({} if (edge_labels_tag is not None
                     or val_edge_labels is not None) else None)
        for u in G.nodes():
            graph_object[u] = {}
            if node_labels_tag is not None:
                nl[u] = G.nodes[u][node_labels_tag]
            elif val_node_labels is not None:
                nl[u] = val_node_labels
            for v in G.neighbors(u):
                if edge_weight_tag is not None:
                    graph_object[u][v] = G.edges[(u, v)][edge_weight_tag]
                else:
                    graph_object[u][v] = 1.0
                if edge_labels_tag is not None:
                    el[(u, v)] = G.edges[(u, v)][edge_labels_tag]
                elif val_edge_labels is not None:
                    el[(u, v)] = val_edge_labels
        if as_Graph:
            yield Graph(graph_object, nl, el)
        else:
            yield [graph_object, nl, el]


def graph_from_pandas(edge_df, node_df=None, directed=False,
                      as_Graph=False):
    """pandas edge/node DataFrames -> {graph_id: input} dict
    (reference utils.py:362-519).

    edge_df = (DataFrame, graph_col, (src_col, dst_col), weight_col|None,
    label_col | [attr_cols] | None); node_df = (DataFrame, graph_col,
    label_col | [attr_cols] | None) with node id = row index."""
    from pandas import DataFrame

    graphs = defaultdict(lambda: {"graph": defaultdict(dict),
                                  "node_label": None, "edge_label": None})
    known_nodes = node_df is not None
    if known_nodes:
        if not (isinstance(node_df, tuple) and len(node_df) == 3
                and isinstance(node_df[0], DataFrame)):
            raise ValueError("node_df must be (DataFrame, graph_col, "
                             "labels_col|attr_cols|None)")
        df, gtag, labs = node_df
        for index, row in df.iterrows():
            g = graphs[row[gtag]]
            g["graph"][index] = {}
            if labs is not None:
                if g["node_label"] is None:
                    g["node_label"] = {}
                if isinstance(labs, list):
                    g["node_label"][index] = np.array(
                        [row[c] for c in labs])
                else:
                    g["node_label"][index] = row[labs]

    if not (isinstance(edge_df, tuple) and len(edge_df) == 5
            and isinstance(edge_df[0], DataFrame)
            and isinstance(edge_df[2], tuple) and len(edge_df[2]) == 2):
        raise ValueError("edge_df must be (DataFrame, graph_col, "
                         "(src, dst), weight_col|None, "
                         "labels_col|attr_cols|None)")
    df, gtag, (src_c, dst_c), w_c, labs = edge_df
    for index, row in df.iterrows():
        gidx = row[gtag]
        if known_nodes and gidx not in graphs:
            raise ValueError("graph index %r missing from node_df" % gidx)
        g = graphs[gidx]
        src, dst = row[src_c], row[dst_c]
        w = row[w_c] if w_c is not None else 1.0
        g["graph"][src][dst] = w
        if not directed:
            g["graph"][dst][src] = w
        if labs is not None:
            if g["edge_label"] is None:
                g["edge_label"] = {}
            lab = (np.array([row[c] for c in labs])
                   if isinstance(labs, list) else row[labs])
            g["edge_label"][(src, dst)] = lab
            if not directed:
                g["edge_label"][(dst, src)] = lab

    out = {}
    for gidx, g in graphs.items():
        item = [dict(g["graph"]), g["node_label"], g["edge_label"]]
        out[gidx] = Graph(*item) if as_Graph else item
    return out


def graph_from_csv(edge_files, node_files=None, index_type=str,
                   directed=False, sep=",", as_Graph=False):
    """csv files (one graph per file) -> generator of inputs
    (reference utils.py:522-696).

    edge_files = (iter(path), weight_flag, attributes_flag);
    node_files = (iter(path), attributes_flag) or None."""
    if not isinstance(index_type, type):
        raise ValueError("index_type must be a class `type` object")
    if not (isinstance(edge_files, tuple) and len(edge_files) == 3):
        raise ValueError("edge_files must be (iterable of paths, "
                         "weight_flag, attributes_flag)")
    efiles, weight_flag, e_attr_flag = edge_files
    if node_files is not None:
        nfiles, n_attr_flag = node_files
        nfiles = list(nfiles)
    else:
        nfiles = None

    for i, epath in enumerate(efiles):
        ed = defaultdict(dict)
        el = {} if e_attr_flag is not None else None
        with open(epath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(sep)
                u, v = index_type(parts[0]), index_type(parts[1])
                pos = 2
                w = 1.0
                if weight_flag:
                    w = float(parts[pos])
                    pos += 1
                ed[u][v] = w
                if not directed:
                    ed[v][u] = w
                if e_attr_flag is True:
                    lab = np.array([float(x) for x in parts[pos:]])
                elif e_attr_flag is False:
                    lab = parts[pos]
                else:
                    lab = None
                if lab is not None:
                    el[(u, v)] = lab
                    if not directed:
                        el[(v, u)] = lab
        nl = None
        if nfiles is not None:
            nl = {}
            with open(nfiles[i]) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split(sep)
                    u = index_type(parts[0])
                    ed.setdefault(u, {})
                    if n_attr_flag is True:
                        nl[u] = np.array([float(x) for x in parts[1:]])
                    elif n_attr_flag is False:
                        nl[u] = parts[1]
        item = [dict(ed), nl, el]
        yield Graph(*item) if as_Graph else item


def _tensor_rows(mat, decode_one_hot):
    """torch feature tensor (any device) -> list of per-row labels:
    argmax ints when the rows are one-hot codes, raw numpy vectors
    otherwise."""
    arr = mat.detach().cpu().numpy()
    if decode_one_hot:
        return arr.argmax(axis=1).tolist()
    return list(arr)


def graph_from_torch_geometric(data, node_one_hot=False,
                               edge_one_hot=False, ignore_y=False):
    """torch_geometric ``Data`` / batched ``Batch`` -> grakel_torch input.

    Capability parity with reference utils.py:699-801: a single ``Data``
    yields ``{"graph": Graph, "y": int}``; a batched object is split back
    into its member graphs via the ``batch`` vector and yields
    ``{"graph": [Graph, ...], "y": [int, ...]}`` (node ids stay in the
    batch-global index space).  ``node_one_hot`` / ``edge_one_hot``
    decode one-hot feature rows to integer labels; otherwise features
    pass through as numpy attribute vectors.  Only attribute access is
    required of ``data``, so any namespace with the right fields works;
    its tensors may lie on any device (they are read to the host).
    """
    ei = data.edge_index.detach().cpu().numpy()
    pairs = [(int(u), int(v)) for u, v in zip(ei[0], ei[1])]
    x_feat = getattr(data, "x", None)
    e_feat = getattr(data, "edge_attr", None)
    node_vals = (_tensor_rows(x_feat, node_one_hot)
                 if x_feat is not None else None)
    edge_vals = (_tensor_rows(e_feat, edge_one_hot)
                 if e_feat is not None else None)
    y = getattr(data, "y", None)

    membership = getattr(data, "batch", None)
    if membership is None:
        node_labels = (dict(enumerate(node_vals))
                       if node_vals is not None else {})
        edge_labels = (dict(zip(pairs, edge_vals))
                       if edge_vals is not None else {})
        out = {"graph": Graph(pairs, node_labels, edge_labels)}
        if not ignore_y and y is not None:
            out["y"] = int(y.item())
        return out

    member = membership.detach().cpu().numpy().astype(np.int64)
    src_g, dst_g = member[ei[0]], member[ei[1]]
    crossing = np.flatnonzero(src_g != dst_g)
    if crossing.size:
        u, v = pairs[int(crossing[0])]
        raise ValueError("edge (%d, %d) connects vertices of two "
                         "different graphs" % (u, v))
    out = defaultdict(list)
    for gid in np.unique(member).tolist():
        e_rows = np.flatnonzero(src_g == gid)
        g_pairs = [pairs[i] for i in e_rows]
        nl = el = None
        if node_vals is not None:
            nl = {int(v): node_vals[v]
                  for v in np.flatnonzero(member == gid)}
        if edge_vals is not None:
            el = {pairs[i]: edge_vals[i] for i in e_rows}
        out["graph"].append(Graph(g_pairs, nl, el))
        if not ignore_y and y is not None:
            out["y"].append(int(y[gid].item()))
    return out
