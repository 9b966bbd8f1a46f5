"""Plain reference of GraKeL's model selection,
``cross_validate_Kfold_SVM`` on a precomputed Gram, for two classes.

The protocol (GraKeL's ``utils.cross_validate_Kfold_SVM``): ``n_iter``
K-fold shuffles of the samples (scikit-learn's ``KFold(shuffle=True)``
on one ``RandomState``), then, for each iteration and fold, one 90/10
``ShuffleSplit`` of the fold's training block from the same
``RandomState``; each C of the grid is fitted on the 90 and scored on
the 10, the first C with the strictly highest accuracy is refitted on
the whole training block and scored on the held-out fold.  The result is
every fold's accuracy, unreduced.

The C-SVC is libsvm's ``Solver`` as scikit-learn bundles it (tol 1e-3,
shrinking on): Q entries ``(float)(y_i y_j K_ij)`` from a float32 copy
of the Gram, ``G``, ``G_bar`` and ``alpha`` in float64, WSS3 with TAU =
1e-12 and ties to the last index, shrinking every ``min(l, 1000)``
iterations with libsvm's swaps, one unshrink, gradient reconstruction
and ``rho`` over the free variables.  It runs every problem of a stage
at once, in lockstep, in torch float64 on the Gram's device.  A sample
is class 0 when its decision value ``sum coef K - rho`` is above 0.
``q_dtype`` and ``vote_dtype`` let a control run Q and the decision
values in lower precisions.

A frozen copy, here, of libsvm's steps; it imports nothing of
grakel_torch.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

__all__ = ["folds", "smo", "cross_validate", "C_GRID"]

TAU = 1e-12
EPS = 1e-3
LOWER, UPPER, FREE = 0, 1, 2
_INF = float("inf")


def C_GRID(n):
    """GraKeL's default grid, 10^(-7, -5, ..., 5) / n."""
    return (10.0 ** np.arange(-7, 7, 2)) / n


# --------------------------------------------------------------------- #
# scikit-learn's draws
# --------------------------------------------------------------------- #

def folds(n, n_iter, n_splits, random_state):
    """[iteration][fold] = (train, test, inner train, inner validation),
    each an int64 index array, drawn as GraKeL's function draws them."""
    rng = np.random.RandomState(random_state)
    outer = []
    for _ in range(n_iter):
        order = np.arange(n)
        rng.shuffle(order)
        sizes = np.full(n_splits, n // n_splits, dtype=int)
        sizes[:n % n_splits] += 1
        start, per = 0, []
        for size in sizes:
            mask = np.zeros(n, dtype=bool)
            mask[order[start:start + size]] = True
            start += size
            per.append((np.flatnonzero(~mask), np.flatnonzero(mask)))
        outer.append(per)
    out = []
    for per in outer:
        row = []
        for train, test in per:
            m = train.shape[0]
            n_test = ceil(0.1 * m)
            perm = rng.permutation(m)
            row.append((train, test, train[perm[n_test:]],
                        train[perm[:n_test]]))
        out.append(row)
    return out


# --------------------------------------------------------------------- #
# libsvm's Solver, every problem of a stage in lockstep
# --------------------------------------------------------------------- #

class _Batch:
    """The live problems' solver state, one row a problem, padded to the
    longest problem (positions past a problem's ``l`` are never read);
    ``ids`` are rows and columns of the Gram."""

    ROWS = ("ids", "y", "QD", "G", "Gb", "a", "st", "act")
    PROBLEMS = ("l", "C", "active", "unshrink", "it", "pid", "inact",
                "valid")

    def __init__(self, Kq, diag, problems, C):
        dev = Kq.device
        self.Kq = Kq
        lens = torch.tensor([p[0].shape[0] for p in problems], device=dev)
        P, L = len(problems), max(int(lens.max()), 1)
        self.pos = torch.arange(L, device=dev)
        self.pos1 = self.pos + 1
        self.valid = self.pos[None, :] < lens[:, None]
        ids = np.zeros((P, L), np.int64)
        y = np.ones((P, L))
        for k, (rows, sign) in enumerate(problems):
            ids[k, :rows.shape[0]] = rows
            y[k, :rows.shape[0]] = sign
        self.ids = torch.from_numpy(ids).to(dev)
        self.y = torch.from_numpy(y).to(dev)
        self.QD = diag[self.ids]
        f64 = dict(dtype=torch.float64, device=dev)
        self.G = torch.full((P, L), -1.0, **f64)
        self.Gb = torch.zeros((P, L), **f64)
        self.a = torch.zeros((P, L), **f64)
        self.st = torch.full((P, L), LOWER, dtype=torch.int8, device=dev)
        self.act = self.pos.repeat(P, 1)
        self.l = lens
        self.C = torch.as_tensor(C, **f64).clone()
        self.active = lens.clone()
        self.inact = self.valid.clone()
        # on the host, so that no iteration waits for the card to know
        # which problems shrink: each problem's countdown, rows and the
        # widest active set
        self.lh = np.array([p[0].shape[0] for p in problems], np.int64)
        self.counter = np.minimum(self.lh, 1000) + 1
        self.W = max(int(self.lh.max()), 1)
        self.unshrink = torch.zeros(P, dtype=torch.bool, device=dev)
        self.it = torch.zeros(P, dtype=torch.int64, device=dev)
        self.pid = torch.arange(P, device=dev)

    def keep(self, m, mh):
        for f in self.ROWS + self.PROBLEMS:
            setattr(self, f, getattr(self, f)[m])
        self.counter, self.lh = self.counter[mh], self.lh[mh]
        self.W = max(int(self.active.max()), 1) if mh.any() else 1

    def set_active(self, S, a):
        self.active[S] = a
        self.inact[S] = self.pos[None, :] < a[:, None]
        self.W = max(int(self.active.max()), 1)

    def q(self, ids, y, rows):
        """Q[p, k] = (float)(y_r y_k K[ids_r, ids_k]) as f64, for the row
        position ``rows[p]`` of each problem, over every column."""
        r = rows[:, None]
        k = self.Kq[ids.gather(1, r), ids]
        return torch.where(y.gather(1, r) * y > 0, k, -k).double()


def _last(mask, pos1):
    """The last True position of each row, -1 when none."""
    return torch.where(mask, pos1, 0).amax(1) - 1


def _select(b):
    """libsvm's ``select_working_set`` for every live problem, over the
    widest active set's columns: (found, i, j, Q row i over them)."""
    W = b.W
    G, y, st, inact = (x[:, :W] for x in (b.G, b.y, b.st, b.inact))
    pos1 = b.pos1[:W]
    up = y > 0
    not_up, not_low = st != UPPER, st != LOWER
    Iup = inact & torch.where(up, not_up, not_low)
    Ilow = inact & torch.where(up, not_low, not_up)
    yG = y * G
    vA = torch.where(Iup, -yG, -_INF)
    Gmax = vA.amax(1)
    i = _last(Iup & (vA == Gmax[:, None]), pos1)
    Gmax = torch.where(i >= 0, Gmax, -_INF)
    Gmax2 = torch.where(Ilow, yG, -_INF).amax(1)
    gd = Gmax[:, None] + yG
    ok = Ilow & (gd > 0)
    ic = i.clamp(min=0)[:, None]
    Qi = b.q(b.ids[:, :W], y, ic[:, 0])
    QD = b.QD[:, :W]
    quad = (QD.gather(1, ic) + QD) - y * ((2.0 * y.gather(1, ic)) * Qi)
    quad = torch.where(quad > 0, quad, TAU)
    obj = torch.where(ok, -(gd * gd) / quad, _INF)
    j = _last(ok & (obj == obj.amin(1)[:, None]), pos1)
    found = ~(Gmax + Gmax2 < EPS) & (j >= 0)
    return found, i, j, Qi


def _reconstruct(b, S):
    """libsvm's ``reconstruct_gradient`` for the problems ``S``, one at a
    time (it runs at most a few times a problem)."""
    for p in S.tolist():
        a, l = int(b.active[p]), int(b.l[p])
        if a == l:
            continue
        G = b.Gb[p, a:l] + (-1.0)
        free = torch.nonzero(b.st[p, :a] == FREE).reshape(-1)
        if free.shape[0]:
            rows = b.ids[p, a:l]
            cols = b.ids[p, free]
            sgn = b.y[p, a:l][:, None] * b.y[p, free][None, :]
            k = b.Kq[rows[:, None], cols[None, :]]
            Q = torch.where(sgn > 0, k, -k).double()
            terms = torch.cat([G[:, None], b.a[p, free][None, :] * Q], 1)
            # libsvm sums in order; a card's scan may round the last bit
            # otherwise, which moves no choice that is not a tie
            G = torch.cumsum(terms, 1)[:, -1]
        b.G[p, a:l] = G


def _shrink(b, S):
    """libsvm's ``do_shrinking`` for the problems ``S``."""
    G, y, st, inact = b.G[S], b.y[S], b.st[S], b.inact[S]
    up = y > 0
    not_up, not_low = st != UPPER, st != LOWER
    yG = y * G
    Gmax1 = torch.where(inact & torch.where(up, not_up, not_low), -yG,
                        -_INF).amax(1)
    Gmax2 = torch.where(inact & torch.where(up, not_low, not_up), yG,
                        -_INF).amax(1)
    un = ~b.unshrink[S] & (Gmax1 + Gmax2 <= EPS * 10)
    if un.any():
        U = S[un]
        b.unshrink[U] = True
        _reconstruct(b, U)
        b.set_active(U, b.l[U])
        G, inact = b.G[S], b.inact[S]
    act = b.active[S]
    shr = inact & (((st == UPPER) & torch.where(
        up, -G > Gmax1[:, None], -G > Gmax2[:, None])) | ((st == LOWER) & (
            torch.where(up, G > Gmax2[:, None], G > Gmax1[:, None]))))
    na = act - shr.sum(1)
    # libsvm's two-pointer loop swaps the k-th shrunk position below the
    # new active size with the k-th unshrunk one above it, from the end
    left = shr & (b.pos[None, :] < na[:, None])
    right = ~shr & inact & (b.pos[None, :] >= na[:, None])
    if left.any():
        P, L = shr.shape
        dev = shr.device
        rl = torch.cumsum(left.long(), 1) - 1
        rr = torch.flip(torch.cumsum(torch.flip(right.long(), [1]), 1),
                        [1]) - 1
        byrank_l = torch.zeros((P, L), dtype=torch.long, device=dev)
        byrank_r = torch.zeros((P, L), dtype=torch.long, device=dev)
        pl, kl = torch.nonzero(left, as_tuple=True)
        pr, kr = torch.nonzero(right, as_tuple=True)
        byrank_l[pl, rl[pl, kl]] = kl
        byrank_r[pr, rr[pr, kr]] = kr
        perm = b.pos.repeat(P, 1)
        perm[pl, kl] = byrank_r[pl, rl[pl, kl]]
        perm[pr, kr] = byrank_l[pr, rr[pr, kr]]
        for f in _Batch.ROWS:
            x = getattr(b, f)
            x[S] = x[S].gather(1, perm)
    b.set_active(S, na)


def _rho(b, S):
    """libsvm's ``calculate_rho`` for the problems ``S`` (active = l)."""
    G, y, st, valid = b.G[S], b.y[S], b.st[S], b.inact[S]
    yG = y * G
    up = y > 0
    to_ub = valid & (((st == UPPER) & ~up) | ((st == LOWER) & up))
    to_lb = valid & (((st == UPPER) & up) | ((st == LOWER) & ~up))
    free = valid & (st == FREE)

    def last_extreme(m, big):
        v = torch.where(m, yG, big)
        e = v.amin(1) if big > 0 else v.amax(1)
        k = _last(m & (v == e[:, None]), b.pos1)
        return torch.where(k >= 0,
                           yG.gather(1, k.clamp(min=0)[:, None])[:, 0], big)

    ub = last_extreme(to_ub, _INF)
    lb = last_extreme(to_lb, -_INF)
    nfree = free.sum(1)
    terms = torch.cat([torch.zeros((G.shape[0], 1), dtype=torch.float64,
                                   device=G.device),
                       torch.where(free, yG, 0.0)], 1)
    # libsvm's sum in order: sequential, on the host
    sfree = torch.cumsum(terms.cpu(), 1)[:, -1].to(G.device)
    return torch.where(nfree > 0, sfree / nfree.clamp(min=1).double(),
                       (ub + lb) / 2)


def _pair(b, found, i, j, Qi):
    """The working pairs' values, fetched to the host in one copy: (i, j)
    stacked, and a float64 [P, 13] array of found, G_i, G_j, alpha_i,
    alpha_j, QD_i, QD_j, y_i, y_j, Q_ij, C, status_i, status_j."""
    # a problem that found no pair may hold -1: its values go unread
    ij = torch.stack([i, j], 1).clamp(min=0)
    vals = torch.cat([found.double()[:, None]]
                     + [x.gather(1, ij).double()
                        for x in (b.G, b.a, b.QD, b.y)]
                     + [Qi.gather(1, ij[:, 1:]), b.C[:, None],
                        b.st.gather(1, ij).double()], 1)
    return ij, vals.cpu().numpy()


def _update(v):
    """libsvm's update of alpha_i and alpha_j, per problem, in float64 on
    the host (the same IEEE operations in the same order): (new alphas
    [P, 2], their change, new statuses, whether each left or reached the
    upper bound, whether it was there)."""
    _, Gi, Gj, ai, aj, QDi, QDj, yi, yj, qij, C, sti, stj = v.T
    Ci = Cj = C
    QDs = QDi + QDj
    # y_i != y_j
    quad = QDs + 2.0 * qij
    quad = np.where(quad <= 0, TAU, quad)
    delta = ((-Gi) - Gj) / quad
    diff = ai - aj
    ai1, aj1 = ai + delta, aj + delta
    pos = diff > 0
    c = pos & (aj1 < 0)
    ai1, aj1 = np.where(c, diff, ai1), np.where(c, 0.0, aj1)
    c = ~pos & (ai1 < 0)
    ai1, aj1 = np.where(c, 0.0, ai1), np.where(c, -diff, aj1)
    hi = diff > Ci - Cj
    c = hi & (ai1 > Ci)
    ai1, aj1 = np.where(c, Ci, ai1), np.where(c, Ci - diff, aj1)
    c = ~hi & (aj1 > Cj)
    ai1, aj1 = np.where(c, Cj + diff, ai1), np.where(c, Cj, aj1)
    # y_i == y_j
    quad = QDs - 2.0 * qij
    quad = np.where(quad <= 0, TAU, quad)
    delta = (Gi - Gj) / quad
    s = ai + aj
    ai2, aj2 = ai - delta, aj + delta
    over = s > Ci
    c = over & (ai2 > Ci)
    ai2, aj2 = np.where(c, Ci, ai2), np.where(c, s - Ci, aj2)
    c = ~over & (aj2 < 0)
    ai2, aj2 = np.where(c, s, ai2), np.where(c, 0.0, aj2)
    over = s > Cj
    c = over & (aj2 > Cj)
    ai2, aj2 = np.where(c, s - Cj, ai2), np.where(c, Cj, aj2)
    c = ~over & (ai2 < 0)
    ai2, aj2 = np.where(c, 0.0, ai2), np.where(c, s, aj2)
    differ = yi != yj
    anew = np.stack([np.where(differ, ai1, ai2),
                     np.where(differ, aj1, aj2)], 1)
    da = anew - np.stack([ai, aj], 1)
    new_st = np.where(anew >= C[:, None], UPPER,
                      np.where(anew <= 0, LOWER, FREE))
    was_up = np.stack([sti, stj], 1) == UPPER
    return anew, da, new_st, was_up != (new_st == UPPER), was_up


def _step(b, i, j, Qi, ij, v):
    """One SMO update of every live problem on its pair (i, j); ``Qi``
    holds Q row i over the first columns, at least every active one;
    ``ij`` and ``v`` are :func:`_pair`'s."""
    W = Qi.shape[1]
    dev = Qi.device
    anew, da, new_st, changed, was_up = _update(v)
    Qj = b.q(b.ids[:, :W], b.y[:, :W], j)
    up = torch.from_numpy(np.concatenate([anew, da, new_st], 1)).to(dev)
    G = b.G[:, :W]
    b.G[:, :W] = torch.where(b.inact[:, :W],
                             G + (Qi * up[:, 2:3] + Qj * up[:, 3:4]), G)
    b.a.scatter_(1, ij, up[:, :2].contiguous())
    b.st.scatter_(1, ij, up[:, 4:6].to(torch.int8))
    # G_bar runs over every row: Q rows i and j over the full width
    for k, r in ((0, i), (1, j)):
        if changed[:, k].any():
            ch = torch.from_numpy(changed[:, k]).to(dev)
            u = torch.from_numpy(was_up[:, k]).to(dev)
            t = b.C[:, None] * b.q(b.ids, b.y, r)
            b.Gb = torch.where(b.valid & (ch & u)[:, None], b.Gb - t,
                               torch.where(b.valid & (ch & ~u)[:, None],
                                           b.Gb + t, b.Gb))
    b.it += 1


def smo(Kq, diag, problems, C):
    """libsvm's C-SVC solution of each problem: ``problems`` a list of
    (Gram row ids int64 [l], signs +1 / -1 [l]), ``C`` [P]; ``Kq`` the
    Gram in Q's precision, ``diag`` its f64 diagonal, both on one device.
    Returns (coef, alpha_i y_i in each problem's row order, a list of f64
    tensors; rho f64 [P]; iterations int64 [P])."""
    dev = Kq.device
    P = len(problems)
    rho = torch.zeros(P, dtype=torch.float64, device=dev)
    iters = torch.zeros(P, dtype=torch.int64, device=dev)
    coef = [None] * P
    b = _Batch(Kq, diag, problems, C)

    def finish(D):
        rho[b.pid[D]] = _rho(b, D)
        iters[b.pid[D]] = b.it[D]
        for p in D.tolist():
            l = int(b.l[p])
            c = torch.zeros(l, dtype=torch.float64, device=dev)
            c[b.act[p, :l]] = b.a[p, :l] * b.y[p, :l]
            coef[int(b.pid[p])] = c

    on_dev = lambda idx: torch.from_numpy(idx).to(dev)  # noqa: E731
    while b.l.shape[0]:
        b.counter -= 1
        H = np.flatnonzero(b.counter == 0)
        if H.size:
            b.counter[H] = np.minimum(b.lh[H], 1000)
            _shrink(b, on_dev(H))
        found, i, j, Qi = _select(b)
        ij, v = _pair(b, found, i, j, Qi)
        fh = v[:, 0] > 0
        if not fh.all():
            R2 = np.flatnonzero(~fh)
            _reconstruct(b, on_dev(R2))
            b.set_active(on_dev(R2), b.l[on_dev(R2)])
            found, i, j, Qi = _select(b)
            ij, v = _pair(b, found, i, j, Qi)
            fh = v[:, 0] > 0
            b.counter[R2[fh[R2]]] = 1
            if not fh.all():
                finish(on_dev(np.flatnonzero(~fh)))
                b.keep(found, fh)
                i, j, Qi, ij, v = i[found], j[found], Qi[found], \
                    ij[found], v[fh]
        if b.l.shape[0]:
            _step(b, i, j, Qi, ij, v)
    return coef, rho, iters


# --------------------------------------------------------------------- #
# the protocol
# --------------------------------------------------------------------- #

def _stage(Kq, Kv, diag, y, fits):
    """Accuracy of each fit (train ids, eval ids, C): the binary problem
    of class 0's samples (+1) then class 1's (-1), each in training
    order; a sample is class 0 where its decision value is above 0."""
    classes = np.unique(y)
    if classes.shape[0] != 2:
        raise ValueError("the reference covers two classes, got %d"
                         % classes.shape[0])
    problems = []
    for train, _, _ in fits:
        first = y[train] == classes[0]
        rows = np.concatenate([train[first], train[~first]])
        sign = np.where(np.arange(rows.shape[0]) < first.sum(), 1.0, -1.0)
        problems.append((rows, sign))
    coef, rho, _ = smo(Kq, diag, problems, [f[2] for f in fits])
    rho = rho.cpu().numpy()
    out = []
    for (rows, _), (_, ev, _), c, r in zip(problems, fits, coef, rho):
        e = torch.from_numpy(ev).to(Kv.device)
        d = (Kv[e][:, torch.from_numpy(rows).to(Kv.device)]
             @ c.to(Kv.dtype)).double().cpu().numpy() - r
        pred = np.where(d > 0, classes[0], classes[1])
        out.append(float(np.mean(y[ev] == pred)))
    return out


def cross_validate(K, y, n_iter, n_splits, random_state, device="cpu",
                   q_dtype=torch.float32, vote_dtype=torch.float64):
    """Every fold's accuracy, [n_iter][n_splits], of GraKeL's protocol at
    the default C grid on the Gram ``K`` (numpy f64) and labels ``y``."""
    y = np.asarray(y)
    n = y.shape[0]
    K64 = torch.from_numpy(np.ascontiguousarray(K[:n, :n], np.float64)
                           ).to(device)
    Kq = K64.to(q_dtype)
    Kv = K64.to(vote_dtype)
    diag = torch.diagonal(K64).contiguous()
    Cs = C_GRID(n)
    plan = folds(n, n_iter, n_splits, random_state)
    inner = [(tr_in, val, C) for per in plan
             for (_, _, tr_in, val) in per for C in Cs]
    s1 = _stage(Kq, Kv, diag, y, inner)
    refits, k = [], 0
    for per in plan:
        for train, test, _, _ in per:
            best, bc = -np.inf, None
            for C in Cs:
                if s1[k] > best:
                    best, bc = s1[k], C
                k += 1
            refits.append((train, test, bc))
    s2 = _stage(Kq, Kv, diag, y, refits)
    return [s2[t * n_splits:(t + 1) * n_splits] for t in range(n_iter)]
