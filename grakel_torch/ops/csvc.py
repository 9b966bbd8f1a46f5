"""Batched C-SVC training and prediction on a precomputed Gram: libsvm's
``Solver`` (the one scikit-learn 1.9 bundles) on every binary problem of
many fits at once, and its one-vs-one vote.

The counterpart of what ``grakel_tpu/utils.py:132-135`` runs on the host
through ``sklearn.svm.SVC(kernel="precomputed", C=C)`` (tol 1e-3,
shrinking on, no class or sample weights).

Planning (:func:`plan_fits`, host, numpy).  A fit is (Gram index, the
Gram ids of its training samples in training order, their labels, C).
Its classes are the sorted distinct labels; its samples are grouped by
class, stably (libsvm's ``svm_group_classes``); each pair of classes i <
j, in order, is one binary problem: class i's samples (sign +1) then
class j's (sign -1), each a row id into the Gram.  Every problem of
every fit of a call is packed into one batch: int32 row ids, int8
signs, int32 row offsets, an f64 C and an int32 Gram index a problem.

The solver (K15, :func:`smo`).  Per problem, libsvm's SMO: ``G``,
``G_bar`` and ``alpha`` in f64, Q entries ``(float)(y_i y_j K_ij)``
read from an f32 copy of the Gram through the row ids (the f32 value of
K with its sign flipped, exactly the cast libsvm makes), the f64
diagonal as ``QD``; WSS3 working-set selection with TAU = 1e-12, ties to
the last index; shrinking every ``min(l, 1000)`` iterations with
libsvm's swaps, its one unshrink at ``Gmax1 + Gmax2 <= 10 eps`` and its
gradient reconstruction (summing over the free variables in index
order, through the row or the column of Q as libsvm picks); ``rho`` from
a sequential sum over the free variables.  Returns each problem's signed
coefficients ``alpha_i y_i`` in its row order, ``rho`` and the iteration
count.  Every operation is an IEEE f64 operation in libsvm's order (no
fused multiply-add), so the solution is libsvm's bit for bit.

The vote (K16, :func:`vote`).  For each (eval point, pair): the
decision value, a sequential f64 sum of ``coef * K[point, row]`` over
the pair's rows in order (rows whose coefficient is 0 skipped: libsvm's
sum runs over the support vectors of the fit's classes and adds ``0 *
K`` for those the pair does not use, which changes nothing for a finite
Gram), minus ``rho``; then libsvm's vote: ``> 0`` votes for class i,
else for class j, and the first class with the most votes wins.

Each has a plain version in torch f64 on the CPU (:func:`smo_plain`,
:func:`vote_plain`: the same steps, batched over the problems in
lockstep) and a CUDA wrapper (:func:`smo_cuda`, :func:`vote_cuda`,
``csrc/csvc.cu``) that launches once a call and counts on its
``.launches``; the dispatchers take the plain version for CPU tensors
and the wrapper for CUDA ones, which launches or raises.  K15 keeps a
problem's rows (42 bytes each) in shared memory up to ``smem_rows``
rows (:func:`k15_smem_rows`) and in a global scratch past it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Plan", "plan_fits", "smo", "smo_plain", "smo_cuda", "vote",
           "vote_plain", "vote_cuda", "k15_smem_rows", "k15_threads",
           "k15_routes",
           "k16_blocks", "ROW_BYTES", "TAU"]

TAU = 1e-12
EPS = 1e-3               # libsvm's stopping tolerance, scikit-learn's tol
LOWER, UPPER, FREE = 0, 1, 2
ROW_BYTES = 42           # G, G_bar, alpha, QD (f64), row id, slot (int32),
                         # sign, status (int8)
_SMEM_BYTES = 227 * 1024 - 2048   # an H100 block's opt-in shared memory,
                                   # less the reductions' static arrays
_INF = float("inf")
K16_THREADS = 256


def k15_smem_rows():
    """The most rows a problem may have for K15 to keep it in shared
    memory (an H100's 227 KB a block)."""
    return _SMEM_BYTES // ROW_BYTES


def k15_threads(max_rows):
    """K15's threads a block for a launch whose largest problem has
    ``max_rows`` rows: about eight rows a thread, 32 to 512."""
    t = 32
    while t < 512 and t * 8 < max_rows:
        t *= 2
    return t


def k15_routes(lens, smem_rows):
    """K15's route a problem of ``lens`` rows: shared memory up to
    ``smem_rows`` rows, a global scratch past it.  Returns (on_global
    bool [P], byte offsets into the scratch (-1 on the shared route),
    the scratch's bytes, the rows the launch's shared memory holds: the
    longest problem on the shared route)."""
    lens = np.asarray(lens, np.int64)
    on_global = lens > smem_rows
    soff = np.full(lens.shape[0], -1, np.int64)
    need = (lens[on_global] * ROW_BYTES + 7) // 8 * 8
    soff[on_global] = np.cumsum(need) - need
    smem = int(lens[~on_global].max()) if (~on_global).any() else 0
    return on_global, soff, int(need.sum()), smem


# --------------------------------------------------------------------- #
# planning
# --------------------------------------------------------------------- #

def _segments(starts, lengths):
    """The concatenation of ``arange(s, s + n)`` over the segments."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    shift = np.repeat(np.asarray(starts, np.int64)
                      - (np.cumsum(lengths) - lengths), lengths)
    return np.arange(total, dtype=np.int64) + shift


@dataclass
class Plan:
    """A batch of C-SVC fits as binary problems (see the module
    docstring).  Per problem: ``off`` [P + 1] row offsets, ``C`` [P],
    ``gram`` [P]; per row: ``ids`` (Gram row ids), ``pos`` (positions in
    the fit's training order), ``sign``; per fit: ``classes``,
    ``counts``, ``perm`` (the grouped order), ``pair0`` (first problem),
    ``gram`` and, when eval points were given, ``eval_ids``."""
    ids: np.ndarray
    pos: np.ndarray
    sign: np.ndarray
    off: np.ndarray
    C: np.ndarray
    gram: np.ndarray
    fits: list
    eval_off: np.ndarray
    eval_ids: np.ndarray

    @property
    def n_problems(self):
        return self.off.shape[0] - 1

    @property
    def max_rows(self):
        return int(np.diff(self.off).max()) if self.n_problems else 0

    def models(self):
        """K16's model table, int64 [M, 4] rows (first problem, classes,
        first eval point, first decision value), and each fit's Gram
        index, int32 [M]."""
        npair = np.array([f["n_pairs"] for f in self.fits], np.int64)
        pts = np.diff(self.eval_off)
        table = np.zeros((len(self.fits), 4), np.int64)
        if self.fits:
            table[:, 0] = [f["pair0"] for f in self.fits]
            table[:, 1] = [f["classes"].shape[0] for f in self.fits]
            table[:, 2] = self.eval_off[:-1]
            table[:, 3] = np.cumsum(pts * npair) - pts * npair
        return table, np.array([f["gram"] for f in self.fits], np.int32)


def plan_fits(fits, evals=None):
    """Pack ``fits``, a list of (gram index, train ids, labels, C), into a
    :class:`Plan`; ``evals`` (optional) gives each fit's eval Gram ids.
    Raises ``ValueError`` for a fit of fewer than two classes (libsvm's
    message) or a C that is not positive."""
    ids, pos, sign, lens, Cs, grams, meta = [], [], [], [], [], [], []
    pair0 = 0
    for g, train, labels, C in fits:
        train = np.asarray(train, np.int64)
        classes, codes = np.unique(np.asarray(labels), return_inverse=True)
        k = classes.shape[0]
        if k < 2:
            raise ValueError("The number of classes has to be greater than "
                             "one; got %d class" % k)
        if not C > 0:
            raise ValueError("C must be a float in the range (0.0, inf), "
                             "got %r" % (C,))
        codes = codes.reshape(-1)
        perm = np.argsort(codes, kind="stable")
        counts = np.bincount(codes, minlength=k)
        starts = np.cumsum(counts) - counts
        ii, jj = np.triu_indices(k, 1)
        seg_start = np.stack([starts[ii], starts[jj]], 1).reshape(-1)
        seg_len = np.stack([counts[ii], counts[jj]], 1).reshape(-1)
        rows = perm[_segments(seg_start, seg_len)]
        pos.append(rows)
        ids.append(train[rows])
        sign.append(np.repeat(np.tile(np.array([1, -1], np.int8),
                                      ii.shape[0]), seg_len))
        lens.append(counts[ii] + counts[jj])
        Cs.append(np.full(ii.shape[0], float(C)))
        grams.append(np.full(ii.shape[0], int(g), np.int32))
        meta.append({"classes": classes, "counts": counts, "perm": perm,
                     "pair0": pair0, "n_pairs": int(ii.shape[0]),
                     "gram": int(g)})
        pair0 += int(ii.shape[0])
    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    lens = cat(lens, np.int64)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if off[-1] >= 2 ** 31:
        raise ValueError("plan_fits: %d rows in one batch; at most 2^31 - 1"
                         % off[-1])
    if evals is None:
        evals = [np.zeros(0, np.int64)] * len(fits)
    ev = [np.asarray(e, np.int64).reshape(-1) for e in evals]
    eval_off = np.concatenate([[0], np.cumsum([e.shape[0] for e in ev])]
                              ).astype(np.int64)
    return Plan(ids=cat(ids, np.int32), pos=cat(pos, np.int64),
                sign=cat(sign, np.int8), off=off.astype(np.int32),
                C=cat(Cs, np.float64), gram=cat(grams, np.int32), fits=meta,
                eval_off=eval_off, eval_ids=cat(ev, np.int32))


# --------------------------------------------------------------------- #
# K15 plain: libsvm's Solver, batched over the problems in lockstep
# --------------------------------------------------------------------- #

class _Batch:
    """The live problems' solver state, one row a problem, padded to the
    longest problem (positions past a problem's ``l`` are never read).
    ``ids`` index the rows of the Grams stacked as one [g n, n] matrix,
    ``col`` their columns."""

    ROWS = ("ids", "col", "y", "QD", "G", "Gb", "a", "st", "act")
    PROBLEMS = ("l", "C", "active", "counter", "unshrink", "it", "work",
                "pid", "inact", "valid")

    def __init__(self, Kf, diag, ids, sign, off, C, gram):
        self.n = Kf.shape[-1]
        self.Kf = Kf.reshape(-1, self.n)
        lens = (off[1:] - off[:-1]).long()
        P = lens.shape[0]
        L = max(int(lens.max()), 1) if P else 1
        self.pos = torch.arange(L)
        self.pos1 = self.pos + 1
        self.valid = self.pos[None, :] < lens[:, None]
        flat = off[:-1].long()[:, None] + self.pos[None, :]
        flat = torch.where(self.valid, flat, torch.zeros_like(flat))
        self.col = torch.where(self.valid, ids.long()[flat],
                               torch.zeros_like(flat))
        self.ids = self.col + gram.long()[:, None] * self.n
        self.y = torch.where(self.valid, sign.double()[flat],
                             torch.ones((), dtype=torch.float64))
        self.QD = diag.reshape(-1)[self.ids]
        self.G = torch.full((P, L), -1.0, dtype=torch.float64)
        self.Gb = torch.zeros((P, L), dtype=torch.float64)
        self.a = torch.zeros((P, L), dtype=torch.float64)
        self.st = torch.full((P, L), LOWER, dtype=torch.int8)
        self.act = self.pos.repeat(P, 1)
        self.l = lens
        self.C = C.double().clone()
        self.active = lens.clone()
        self.inact = self.valid.clone()
        self.counter = torch.clamp(lens, max=1000) + 1
        self.unshrink = torch.zeros(P, dtype=torch.bool)
        self.it = torch.zeros(P, dtype=torch.int64)
        self.work = torch.zeros(P, dtype=torch.int64)
        self.pid = torch.arange(P)

    def keep(self, m):
        for f in self.ROWS + self.PROBLEMS:
            setattr(self, f, getattr(self, f)[m])

    def set_active(self, S, a):
        self.active[S] = a
        self.inact[S] = self.pos[None, :] < a[:, None]

    def q(self, ids, col, y, rows):
        """Q[p, k] = (float)(y_r y_k K[ids_r, ids_k]) as f64, for the row
        position ``rows[p]`` of each problem, over every column."""
        r = rows[:, None]
        k = self.Kf[ids.gather(1, r), col]
        return torch.where(y.gather(1, r) * y > 0, k, -k).double()


def _last(mask, pos1):
    """The last True position of each row, -1 when none."""
    return torch.where(mask, pos1, 0).amax(1) - 1


def _select(b, S):
    """libsvm's ``select_working_set`` for the problems ``S`` (None:
    every live problem): (found, i, j, Q row i)."""
    pick = (lambda x: x) if S is None else (lambda x: x[S])
    G, y, st, inact = pick(b.G), pick(b.y), pick(b.st), pick(b.inact)
    up = y > 0
    not_up, not_low = st != UPPER, st != LOWER
    Iup = inact & torch.where(up, not_up, not_low)
    Ilow = inact & torch.where(up, not_low, not_up)
    yG = y * G
    vA = torch.where(Iup, -yG, -_INF)
    Gmax = vA.amax(1)
    i = _last(Iup & (vA == Gmax[:, None]), b.pos1)
    Gmax = torch.where(i >= 0, Gmax, -_INF)
    Gmax2 = torch.where(Ilow, yG, -_INF).amax(1)
    gd = Gmax[:, None] + yG
    ok = Ilow & (gd > 0)
    ic = i.clamp(min=0)[:, None]
    Qi = b.q(pick(b.ids), pick(b.col), y, ic[:, 0])
    QD = pick(b.QD)
    quad = (QD.gather(1, ic) + QD) - y * ((2.0 * y.gather(1, ic)) * Qi)
    quad = torch.where(quad > 0, quad, TAU)
    obj = torch.where(ok, -(gd * gd) / quad, _INF)
    j = _last(ok & (obj == obj.amin(1)[:, None]), b.pos1)
    found = ~(Gmax + Gmax2 < EPS) & (j >= 0)
    return found, i, j, Qi


def _reconstruct(b, S, chunk=1 << 22):
    """libsvm's ``reconstruct_gradient`` for the problems ``S``, one at a
    time (it runs at most a few times a problem)."""
    for p in S.tolist():
        a, l = int(b.active[p]), int(b.l[p])
        if a == l:
            continue
        G = b.Gb[p, a:l] + (-1.0)
        free = torch.nonzero(b.st[p, :a] == FREE).reshape(-1)
        nf = int(free.shape[0])
        if nf:
            by_row = nf * l > 2 * a * (l - a)
            rows, rcol = b.ids[p, a:l], b.col[p, a:l]
            cols, ccol = b.ids[p, free], b.col[p, free]
            sgn = b.y[p, a:l][:, None] * b.y[p, free][None, :]
            alpha = b.a[p, free][None, :]
            step = max(1, chunk // nf)
            parts = []
            for r0 in range(0, l - a, step):
                sl = slice(r0, r0 + step)
                if by_row:
                    k = b.Kf[rows[sl, None], ccol[None, :]]
                else:
                    k = b.Kf[cols[None, :], rcol[sl, None]]
                Q = torch.where(sgn[sl] > 0, k, -k).double()
                terms = torch.cat([G[sl, None], alpha * Q], 1)
                parts.append(torch.cumsum(terms, 1)[:, -1])
            G = torch.cat(parts)
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
        rl = torch.cumsum(left.long(), 1) - 1
        rr = torch.flip(torch.cumsum(torch.flip(right.long(), [1]), 1),
                        [1]) - 1
        byrank_l = torch.zeros((P, L), dtype=torch.long)
        byrank_r = torch.zeros((P, L), dtype=torch.long)
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
        # min (max) with ties to the last element, as `(x<y)?x:y` folds
        v = torch.where(m, yG, big)
        e = v.amin(1) if big > 0 else v.amax(1)
        k = _last(m & (v == e[:, None]), b.pos1)
        return torch.where(k >= 0, yG.gather(1, k.clamp(min=0)[:, None])[:, 0],
                           big)

    ub = last_extreme(to_ub, _INF)
    lb = last_extreme(to_lb, -_INF)
    nfree = free.sum(1)
    terms = torch.cat([torch.zeros((G.shape[0], 1), dtype=torch.float64),
                       torch.where(free, yG, 0.0)], 1)
    sfree = torch.cumsum(terms, 1)[:, -1]
    return torch.where(nfree > 0, sfree / nfree.clamp(min=1).double(),
                       (ub + lb) / 2)


def _step(b, i, j, Qi):
    """One SMO update of every live problem on its pair (i, j)."""
    ij = torch.stack([i, j], 1)
    Gij, aij, QDij, yij = (x.gather(1, ij) for x in (b.G, b.a, b.QD, b.y))
    Gi, Gj, ai, aj = Gij[:, 0], Gij[:, 1], aij[:, 0], aij[:, 1]
    Qj = b.q(b.ids, b.col, b.y, j)
    qij = Qi.gather(1, j[:, None])[:, 0]
    Ci = Cj = C = b.C
    QDs = QDij[:, 0] + QDij[:, 1]
    # y_i != y_j
    quad = QDs + 2.0 * qij
    quad = torch.where(quad <= 0, TAU, quad)
    delta = ((-Gi) - Gj) / quad
    diff = ai - aj
    ai1, aj1 = ai + delta, aj + delta
    pos = diff > 0
    c = pos & (aj1 < 0)
    ai1, aj1 = torch.where(c, diff, ai1), torch.where(c, 0.0, aj1)
    c = ~pos & (ai1 < 0)
    ai1, aj1 = torch.where(c, 0.0, ai1), torch.where(c, -diff, aj1)
    hi = diff > Ci - Cj
    c = hi & (ai1 > Ci)
    ai1, aj1 = torch.where(c, Ci, ai1), torch.where(c, Ci - diff, aj1)
    c = ~hi & (aj1 > Cj)
    ai1, aj1 = torch.where(c, Cj + diff, ai1), torch.where(c, Cj, aj1)
    # y_i == y_j
    quad = QDs - 2.0 * qij
    quad = torch.where(quad <= 0, TAU, quad)
    delta = (Gi - Gj) / quad
    s = ai + aj
    ai2, aj2 = ai - delta, aj + delta
    over = s > Ci
    c = over & (ai2 > Ci)
    ai2, aj2 = torch.where(c, Ci, ai2), torch.where(c, s - Ci, aj2)
    c = ~over & (aj2 < 0)
    ai2, aj2 = torch.where(c, s, ai2), torch.where(c, 0.0, aj2)
    over = s > Cj
    c = over & (aj2 > Cj)
    ai2, aj2 = torch.where(c, s - Cj, ai2), torch.where(c, Cj, aj2)
    c = ~over & (ai2 < 0)
    ai2, aj2 = torch.where(c, 0.0, ai2), torch.where(c, s, aj2)
    differ = yij[:, 0] != yij[:, 1]
    anew = torch.stack([torch.where(differ, ai1, ai2),
                        torch.where(differ, aj1, aj2)], 1)
    da = anew - aij
    b.G = torch.where(b.inact, b.G + (Qi * da[:, :1] + Qj * da[:, 1:]), b.G)
    b.a.scatter_(1, ij, anew)
    was_up = b.st.gather(1, ij) == UPPER
    new_st = torch.where(anew >= C[:, None], UPPER,
                         torch.where(anew <= 0, LOWER, FREE)).to(torch.int8)
    b.st.scatter_(1, ij, new_st)
    changed = was_up != (new_st == UPPER)
    if changed.any():
        for k, Q in ((0, Qi), (1, Qj)):
            ch = changed[:, k]
            if ch.any():
                t = C[:, None] * Q
                u = was_up[:, k]
                b.Gb = torch.where(b.valid & (ch & u)[:, None], b.Gb - t,
                                   torch.where(b.valid & (ch & ~u)[:, None],
                                               b.Gb + t, b.Gb))
    b.it += 1
    b.work += b.active


def smo_plain(Kf, diag, ids, sign, off, C, gram=None, work=None):
    """K15's plain version: libsvm's C-SVC solver on every problem of the
    batch, in torch f64 on the CPU, the problems in lockstep.  Kf f32
    [n, n] (or [g, n, n], one Gram a ``gram`` index), diag f64 [n] (or
    [g, n]); ids int32 [R] row ids, sign int8 [R] (+1 / -1), off int32
    [P + 1], C f64 [P], gram int32 [P] (default all 0).  Returns (coef
    f64 [R], the signed coefficients alpha_i y_i in row order; rho f64
    [P]; iterations int32 [P]).  ``work`` (int64 [P], optional) receives
    each problem's active rows summed over its iterations."""
    P = off.shape[0] - 1
    R = int(off[-1]) if P else 0
    coef = torch.zeros(R, dtype=torch.float64)
    rho = torch.zeros(P, dtype=torch.float64)
    iters = torch.zeros(P, dtype=torch.int32)
    if P == 0:
        return coef, rho, iters
    if gram is None:
        gram = torch.zeros(P, dtype=torch.int32)
    b = _Batch(Kf, diag, ids, sign, off, C, gram)
    offs = off[:-1].long()

    def finish(D):
        rho[b.pid[D]] = _rho(b, D)
        iters[b.pid[D]] = b.it[D].to(torch.int32)
        if work is not None:
            work[b.pid[D]] = b.work[D]
        for p in D.tolist():
            l = int(b.l[p])
            base = int(offs[b.pid[p]])
            coef[base + b.act[p, :l]] = b.a[p, :l] * b.y[p, :l]

    while b.l.shape[0]:
        b.counter -= 1
        hit = b.counter == 0
        if hit.any():
            H = torch.nonzero(hit).reshape(-1)
            b.counter[H] = torch.clamp(b.l[H], max=1000)
            _shrink(b, H)
        found, i, j, Qi = _select(b, None)
        if not found.all():
            R2 = torch.nonzero(~found).reshape(-1)
            _reconstruct(b, R2)
            b.set_active(R2, b.l[R2])
            f2, i2, j2, Q2 = _select(b, R2)
            b.counter[R2[f2]] = 1
            i[R2], j[R2], Qi[R2] = i2, j2, Q2
            found[R2] = f2
            if not f2.all():
                done = ~found
                finish(torch.nonzero(done).reshape(-1))
                b.keep(found)
                i, j, Qi = i[found], j[found], Qi[found]
        if b.l.shape[0]:
            _step(b, i, j, Qi)
    return coef, rho, iters


# --------------------------------------------------------------------- #
# K16 plain: decision values and the one-vs-one vote
# --------------------------------------------------------------------- #

def vote_plain(K, eval_ids, ids, coef, off, rho, models, gram=None):
    """K16's plain version.  K f64 [n_rows, n_cols] (or [g, n_rows,
    n_cols]); eval_ids int32 [E], the Gram rows of every model's eval
    points; ids int32 [R] / coef f64 [R] / off int32 [P + 1] / rho f64
    [P], the problems' rows (Gram columns) and K15's solution; models
    int64 [M, 4]: (first problem, classes, first eval point, first
    decision value) a model; gram int32 [M] (default 0).  Returns (dec
    f64 [sum of points x pairs], each model's [points, pairs] block
    row-major; pred int32 [E], each point's class index)."""
    models = models.cpu()
    M = models.shape[0]
    E = eval_ids.shape[0]
    pred = torch.zeros(E, dtype=torch.int32)
    if M == 0:
        return torch.zeros(0, dtype=torch.float64), pred
    last = models[-1]
    n_last = int(last[1]) * (int(last[1]) - 1) // 2
    e_end = torch.cat([models[1:, 2], torch.tensor([E])])
    dec = torch.zeros(int(last[3]) + (int(e_end[-1]) - int(last[2]))
                      * n_last, dtype=torch.float64)
    Kg = K if K.dim() == 3 else K[None]
    for m in range(M):
        q0, k, e0, d0 = (int(x) for x in models[m])
        e1 = int(e_end[m])
        npair = k * (k - 1) // 2
        if e1 == e0 or npair == 0:
            continue
        G = Kg[0 if gram is None else int(gram[m])]
        rows = G[eval_ids[e0:e1].long()]                    # [pts, cols]
        lens = (off[q0 + 1:q0 + npair + 1] - off[q0:q0 + npair]).long()
        Lm = int(lens.max())
        pos = torch.arange(Lm)
        valid = pos[None, :] < lens[:, None]
        flat = off[q0:q0 + npair].long()[:, None] + pos[None, :]
        flat = torch.where(valid, flat, torch.zeros_like(flat))
        c = torch.where(valid, coef[flat], torch.zeros((), dtype=coef.dtype))
        cols = ids.long()[flat]
        kv = rows[:, cols]                                  # [pts, pairs, L]
        terms = torch.where(c != 0, c[None] * kv, torch.zeros_like(kv))
        terms = torch.cat([torch.zeros(terms.shape[:2] + (1,),
                                       dtype=torch.float64), terms], 2)
        s = torch.cumsum(terms, 2)[:, :, -1]
        d = s - rho[q0:q0 + npair][None, :]
        dec[d0:d0 + d.numel()] = d.reshape(-1)
        ii, jj = np.triu_indices(k, 1)
        pos_vote = d > 0
        votes = torch.zeros((e1 - e0, k), dtype=torch.int64)
        votes.index_add_(1, torch.from_numpy(ii), pos_vote.long())
        votes.index_add_(1, torch.from_numpy(jj), (~pos_vote).long())
        pred[e0:e1] = votes.argmax(1).to(torch.int32)
    return dec, pred


# --------------------------------------------------------------------- #
# K15 / K16 on a card
# --------------------------------------------------------------------- #

def _check(ok, name, what):
    if not ok:
        raise ValueError("%s: need %s" % (name, what))


def smo_cuda(Kf, diag, ids, sign, off, C, gram=None, smem_rows=None,
             threads=None, work=None):
    """K15 (``csrc/csvc.cu``): :func:`smo_plain` on a card, every problem
    of the batch in ONE launch, a block a problem.  The same arguments,
    contiguous on one CUDA device, and ``off``, ``C`` and ``gram`` also
    readable on the host (they are fetched once); ``smem_rows``
    (default :func:`k15_smem_rows`) is the most rows a problem keeps in
    shared memory, past which it runs on a global scratch;
    ``threads`` (default :func:`k15_threads`) the block size; ``work``
    (int64 [P] on the device, optional) receives each problem's active
    rows summed over its iterations.  Counts on
    ``smo_cuda.launches`` and ``smo_cuda.route_launches`` (a launch
    counts on each route one of its problems took)."""
    from .. import _build
    name = "smo_cuda"
    dev = Kf.device
    P = off.shape[0] - 1 if off.dim() == 1 else -1
    Kg = Kf if Kf.dim() == 3 else Kf[None]
    dg = diag if diag.dim() == 2 else diag[None]
    _check(dev.type == "cuda", name, "CUDA tensors (a CPU tensor takes "
           "smo_plain)")
    _check(Kg.dim() == 3 and Kg.dtype == torch.float32
           and Kg.shape[1] == Kg.shape[2] and Kg.is_contiguous(), name,
           "a contiguous f32 Gram [n, n] or stack [g, n, n]")
    n = Kg.shape[1]
    _check(dg.dtype == torch.float64 and tuple(dg.shape) == tuple(Kg.shape[:2])
           and dg.is_contiguous(), name, "a contiguous f64 diagonal [n] "
           "(or [g, n]) beside the Gram")
    _check(P >= 0 and off.dtype == torch.int32 and C.dtype == torch.float64
           and tuple(C.shape) == (P,), name,
           "int32 off [P + 1] and f64 C [P]")
    for t in (diag, ids, sign, off, C) + (() if gram is None else (gram,)):
        _check(t.device == dev and t.is_contiguous(), name,
               "every tensor contiguous on the Gram's device")
    R = ids.shape[0]
    _check(ids.dtype == torch.int32 and sign.dtype == torch.int8
           and tuple(sign.shape) == (R,), name, "int32 ids and int8 sign "
           "[R]")
    if gram is None:
        gram = torch.zeros(P, dtype=torch.int32, device=dev)
    _check(gram.dtype == torch.int32 and tuple(gram.shape) == (P,), name,
           "int32 gram [P]")
    _check(work is None or (work.dtype == torch.int64 and work.device == dev
                            and tuple(work.shape) == (P,)), name,
           "work int64 [P] on the device")
    coef = torch.empty(R, dtype=torch.float64, device=dev)
    rho = torch.empty(P, dtype=torch.float64, device=dev)
    iters = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return coef, rho, iters
    host_off = off.cpu().numpy().astype(np.int64)
    lens = np.diff(host_off)
    _check(host_off[0] == 0 and (lens >= 0).all() and host_off[-1] == R,
           name, "off ascending from 0 to len(ids)")
    _check(bool((C.cpu() > 0).all()), name, "every C > 0")
    g_host = gram.cpu().numpy()
    _check(((g_host >= 0) & (g_host < Kg.shape[0])).all(), name,
           "gram indices into the stack")
    limit = k15_smem_rows() if smem_rows is None else int(smem_rows)
    _check(0 <= limit <= k15_smem_rows(), name, "smem_rows <= %d"
           % k15_smem_rows())
    on_global, soff, scratch_bytes, smem = k15_routes(lens, limit)
    scratch = torch.empty(max(scratch_bytes, 8), dtype=torch.uint8,
                          device=dev)
    soff_t = torch.from_numpy(soff).to(dev)
    T = k15_threads(int(lens.max())) if threads is None else int(threads)
    _check(T % 32 == 0 and 32 <= T <= 1024, name,
           "threads a multiple of 32, 32..1024")
    _build.launch("grakel_csvc_smo", dev, Kg.data_ptr(), n, dg.data_ptr(),
                  ids.data_ptr(), sign.data_ptr(), off.data_ptr(),
                  C.data_ptr(), gram.data_ptr(), P, smem, scratch.data_ptr(),
                  soff_t.data_ptr(), T, coef.data_ptr(), rho.data_ptr(),
                  iters.data_ptr(), None if work is None else work.data_ptr())
    smo_cuda.launches += 1
    if (~on_global).any():
        smo_cuda.route_launches["shared"] += 1
    if on_global.any():
        smo_cuda.route_launches["global"] += 1
    smo_cuda.last_route = {"shared": int((~on_global).sum()),
                           "global": int(on_global.sum()), "threads": T,
                           "smem_rows": smem}
    return coef, rho, iters


smo_cuda.launches = 0
smo_cuda.route_launches = {"shared": 0, "global": 0}
smo_cuda.last_route = None


def k16_blocks(models, E):
    """K16's block plan: int32 [B, 3] rows (model, first point within
    the model, points), each block at most ``K16_THREADS // pairs``
    points (at least one) of one model."""
    models = np.asarray(models, np.int64).reshape(-1, 4)
    M = models.shape[0]
    e_end = np.concatenate([models[1:, 2], [E]]) if M else np.zeros(0)
    out = []
    for m in range(M):
        k = int(models[m, 1])
        npair = k * (k - 1) // 2
        pts = int(e_end[m] - models[m, 2])
        if pts <= 0 or npair <= 0:
            continue
        per = max(1, K16_THREADS // npair)
        starts = np.arange(0, pts, per)
        out.append(np.stack([np.full(starts.shape, m), starts,
                             np.minimum(per, pts - starts)], 1))
    if not out:
        return np.zeros((0, 3), np.int32)
    return np.concatenate(out).astype(np.int32)


def vote_cuda(K, eval_ids, ids, coef, off, rho, models, gram=None):
    """K16 (``csrc/csvc.cu``): :func:`vote_plain` on a card in ONE
    launch, a thread a (point, pair) and then a thread a point for the
    vote.  The same arguments, contiguous on one CUDA device (``models``
    also on the host).  Counts on ``vote_cuda.launches``."""
    from .. import _build
    name = "vote_cuda"
    dev = K.device
    _check(dev.type == "cuda", name, "CUDA tensors (a CPU tensor takes "
           "vote_plain)")
    Kg = K if K.dim() == 3 else K[None]
    _check(Kg.dim() == 3 and Kg.dtype == torch.float64 and Kg.is_contiguous(),
           name, "a contiguous f64 Gram [rows, cols] or stack [g, rows, "
           "cols]")
    host_models = models.cpu().numpy().astype(np.int64).reshape(-1, 4)
    M = host_models.shape[0]
    E = eval_ids.shape[0]
    P = off.shape[0] - 1
    _check(eval_ids.dtype == torch.int32 and ids.dtype == torch.int32
           and coef.dtype == torch.float64 and off.dtype == torch.int32
           and rho.dtype == torch.float64 and tuple(rho.shape) == (P,)
           and tuple(coef.shape) == tuple(ids.shape), name,
           "int32 eval_ids, ids and off, f64 coef and rho")
    if gram is None:
        gram = torch.zeros(M, dtype=torch.int32, device=dev)
    for t in (eval_ids, ids, coef, off, rho, gram):
        _check(t.device == dev and t.is_contiguous(), name,
               "every tensor contiguous on the Gram's device")
    if M:
        npair = host_models[:, 1] * (host_models[:, 1] - 1) // 2
        _check(((host_models[:, 0] + npair) <= P).all()
               and (host_models[:, 2] <= E).all(), name,
               "models inside the problems and eval points")
        last = host_models[-1]
        n_dec = int(last[3] + (E - last[2]) * npair[-1])
    else:
        n_dec = 0
    dec = torch.empty(n_dec, dtype=torch.float64, device=dev)
    pred = torch.empty(E, dtype=torch.int32, device=dev)
    blocks = k16_blocks(host_models, E)
    if blocks.shape[0] == 0:
        return dec, pred
    bl = torch.from_numpy(blocks).to(dev)
    md = torch.from_numpy(host_models).to(dev)
    _build.launch("grakel_csvc_vote", dev, Kg.data_ptr(), Kg.shape[1],
                  Kg.shape[2], eval_ids.data_ptr(), ids.data_ptr(),
                  coef.data_ptr(), off.data_ptr(), rho.data_ptr(),
                  md.data_ptr(), gram.data_ptr(), bl.data_ptr(),
                  int(blocks.shape[0]), K16_THREADS, dec.data_ptr(),
                  pred.data_ptr())
    vote_cuda.launches += 1
    return dec, pred


vote_cuda.launches = 0


# --------------------------------------------------------------------- #
# dispatchers
# --------------------------------------------------------------------- #

def smo(Kf, diag, ids, sign, off, C, gram=None, work=None):
    """K15 on the Gram's device: :func:`smo_plain` for CPU tensors,
    :func:`smo_cuda` (one launch) for CUDA ones."""
    if Kf.device.type == "cpu":
        return smo_plain(Kf, diag, ids, sign, off, C, gram, work)
    if Kf.device.type != "cuda":
        raise ValueError("smo: unsupported device %s" % Kf.device)
    return smo_cuda(Kf, diag, ids, sign, off, C, gram, work=work)


def vote(K, eval_ids, ids, coef, off, rho, models, gram=None):
    """K16 on the Gram's device: :func:`vote_plain` for CPU tensors,
    :func:`vote_cuda` (one launch) for CUDA ones."""
    if K.device.type == "cpu":
        return vote_plain(K, eval_ids, ids, coef, off, rho, models, gram)
    if K.device.type != "cuda":
        raise ValueError("vote: unsupported device %s" % K.device)
    return vote_cuda(K, eval_ids, ids, coef, off, rho, models, gram)
