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
Consecutive fits that share the Gram, the grouped training rows and the
eval points (the Cs of one split) form a vote group
(:meth:`Plan.vote_groups`).

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
fused multiply-add), so the solution is libsvm's bit for bit.  On a
card each problem takes a route by its rows (:func:`k15_routes`): a warp
(its Q in shared memory) up to ``K15_WARP_ROWS``, a block (its rows in
shared memory) up to ``K15_BLOCK_ROWS``, a global scratch past it; one
launch a route (:func:`k15_launches`).

The vote (K16, :func:`vote`).  For each (eval point, pair): the
decision value, a sequential f64 sum of ``coef * K[point, row]`` over
the pair's rows in order (rows whose coefficient is 0 skipped: libsvm's
sum runs over the support vectors of the fit's classes and adds ``0 *
K`` for those the pair does not use, which changes nothing for a finite
Gram), minus ``rho``; then libsvm's vote: ``> 0`` votes for class i,
else for class j, and the first class with the most votes wins.  On a
card a block stages ``K[eval points, group rows]`` once for every model
and pair of its vote group and sums each pair's nonzero rows
(compacted, in order) from shared memory (:func:`k16_blocks`).

Each has a plain version in torch f64 on the CPU (:func:`smo_plain`,
:func:`vote_plain`: the same steps, batched over the problems in
lockstep) and a CUDA wrapper (:func:`smo_cuda`, :func:`vote_cuda`,
``csrc/csvc.cu``) that counts each launch on its ``.launches``; the
dispatchers take the plain version for CPU tensors and the wrapper for
CUDA ones, which launches or raises.  Every one of them first refuses a
Gram or diagonal that holds NaN or infinity (one reduction over the
Grams the batch reads): libsvm's loop would never end on one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Plan", "plan_fits", "smo", "smo_plain", "smo_cuda", "vote",
           "vote_plain", "vote_cuda", "k15_routes", "k15_launches",
           "k15_block_shape", "k15_threads", "k15_warps", "k15_warp_bytes",
           "k16_blocks", "k16_compact", "k16_single_groups",
           "require_finite", "ROUTES", "K15_WARP_ROWS", "K15_BLOCK_ROWS",
           "TAU"]

TAU = 1e-12
EPS = 1e-3               # libsvm's stopping tolerance, scikit-learn's tol
LOWER, UPPER, FREE = 0, 1, 2
ROUTES = ("warp", "block", "global")
K15_WARP_ROWS = 64       # the warp route's most rows (measured: PERF.md)
K15_WARP_MAX_ROWS = 192  # a warp's Q and rows within one block's memory
K15_BLOCK_ROWS = 4096    # the block route's most rows (8 rows a thread
                         # at 512 threads)
K15_ROWS_PER_THREAD = 4  # the block route's default rows a thread
K15_BLOCK_R = (1, 2, 3, 4, 6, 8)   # its kernels' rows a thread, and
K15_BLOCK_MAX_THREADS = {1: 640, 2: 640, 3: 640, 4: 640, 6: 512, 8: 512}
                         # their launch bounds (96, 128 registers)
K15_WARPS = 4            # the warp route's problems a block, at most
WARP_ROW_BYTES = 40      # G, alpha, G_bar, QD (f64), a rank (int32),
                         # slot (int16), sign, status; beside 4 l^2 of Q
BLOCK_ROW_BYTES = 24     # G, alpha (f64), row id (int32), slot (int16),
                         # sign, status (int8)
BLOCK_SCRATCH_BYTES = 16  # G_bar (f64) and a rank (int32) a row, global
GLOBAL_ROW_BYTES = 42    # the global route's row: G, G_bar, alpha, QD,
                         # row id, slot, sign, status
_INF = float("inf")
K16_THREADS = 256
K16_CHUNK = 256          # group rows a K16 block stages at a time
K16_POINTS = 24          # eval points a K16 block stages (48 KB)


def require_finite(name, *tensors):
    """Raise ``ValueError`` unless every entry of ``tensors`` (the Grams
    a batch reads and their diagonal) is finite: one reduction, one
    fetch."""
    ok = None
    for t in tensors:
        f = torch.isfinite(t).all()
        ok = f if ok is None else ok & f
    if ok is not None and not bool(ok):
        raise ValueError("%s: the Gram holds NaN or infinity; libsvm's "
                         "solver has no end on a non-finite Gram" % name)


def _used_grams(Kg, gram_host):
    """The Grams of the stack ``Kg`` that the indices ``gram_host``
    name (the whole stack when every one is named)."""
    used = np.unique(np.asarray(gram_host, np.int64))
    if used.shape[0] == Kg.shape[0]:
        return Kg
    return Kg[torch.from_numpy(used).to(Kg.device)]


def k15_threads(max_rows):
    """The global route's threads a block for a launch whose largest
    problem has ``max_rows`` rows: about eight rows a thread, 32 to
    512."""
    t = 32
    while t < 512 and t * 8 < max_rows:
        t *= 2
    return t


def k15_block_shape(cap, threads=None):
    """The block route's (threads, rows a thread R) for a launch whose
    largest problem has ``cap`` rows: R the least of ``K15_BLOCK_R`` with
    R threads >= cap, within that kernel's most threads
    (``K15_BLOCK_MAX_THREADS``: its launch bound, which leaves it
    registers enough not to spill); threads (default about ``cap /
    K15_ROWS_PER_THREAD``, lowered to the bound) a multiple of 32."""
    cap = max(int(cap), 1)
    least = lambda T: next((r for r in K15_BLOCK_R if r * T >= cap), None)
    if threads is None:
        T = -(-cap // K15_ROWS_PER_THREAD)
        T = min(K15_BLOCK_MAX_THREADS[1], max(32, (T + 31) // 32 * 32))
        while least(T) and T > K15_BLOCK_MAX_THREADS[least(T)]:
            T = K15_BLOCK_MAX_THREADS[least(T)]
    else:
        T = int(threads)
    R = least(T)
    if T % 32 or T < 32 or R is None or T > K15_BLOCK_MAX_THREADS[R]:
        raise ValueError("k15_block_shape: %d rows at %d threads: threads "
                         "a multiple of 32 with R threads >= rows for R in "
                         "%s and at most %s threads at R" % (
                             cap, T, K15_BLOCK_R, K15_BLOCK_MAX_THREADS))
    return T, R


def k15_warp_bytes(cap):
    """One warp-route problem's shared bytes at ``cap`` rows."""
    q = (4 * cap * cap + 15) // 16 * 16
    return q + (WARP_ROW_BYTES * cap + 15) // 16 * 16


def k15_warps(cap):
    """The warp route's problems a block at ``cap`` rows: up to
    ``K15_WARPS``, within 96 KB of shared memory (at least one)."""
    return int(max(1, min(K15_WARPS,
                          (96 * 1024) // k15_warp_bytes(max(cap, 1)))))


def k15_routes(lens, warp_rows=None, block_rows=None):
    """K15's route a problem of ``lens`` rows: 0 (warp) up to
    ``warp_rows`` (default ``K15_WARP_ROWS``), 1 (block) up to
    ``block_rows`` (default ``K15_BLOCK_ROWS``), 2 (global) past it.
    Returns int8 [P]."""
    lens = np.asarray(lens, np.int64)
    w = K15_WARP_ROWS if warp_rows is None else int(warp_rows)
    b = K15_BLOCK_ROWS if block_rows is None else int(block_rows)
    if not (0 <= w <= K15_WARP_MAX_ROWS and 0 <= b <= K15_BLOCK_ROWS):
        raise ValueError("k15_routes: warp_rows <= %d and block_rows <= %d"
                         % (K15_WARP_MAX_ROWS, K15_BLOCK_ROWS))
    return np.where(lens <= w, 0, np.where(lens <= b, 1, 2)).astype(np.int8)


def k15_launches(lens, C, route, threads=None):
    """K15's launches, one a route that some problem takes: a dict each
    with the route's name, ``order`` (its problems, C descending, then
    rows descending: the longest runs start first), ``cap`` (its most
    rows), ``threads``, ``rows_per_thread`` (block route), ``smem``
    (dynamic shared bytes), ``soff`` (each launched problem's byte
    offset into its scratch) and ``scratch`` (its bytes).  ``threads``
    sets the block and global routes' block size."""
    lens = np.asarray(lens, np.int64)
    C = np.asarray(C, np.float64)
    route = np.asarray(route)
    out = []
    for r, name in enumerate(ROUTES):
        sel = np.nonzero(route == r)[0]
        if not sel.size:
            continue
        order = sel[np.lexsort((-lens[sel], -C[sel]))]
        cap = int(lens[order].max())
        L = {"route": name, "order": order.astype(np.int32), "cap": cap,
             "rows_per_thread": 0}
        if r == 0:
            wpb = k15_warps(cap)
            L.update(threads=32 * wpb, smem=wpb * k15_warp_bytes(cap),
                     need=np.zeros(order.shape[0], np.int64))
        elif r == 1:
            T, R = k15_block_shape(cap, threads)
            L.update(threads=T, rows_per_thread=R,
                     smem=(BLOCK_ROW_BYTES * cap + 15) // 16 * 16,
                     need=lens[order] * BLOCK_SCRATCH_BYTES)
        else:
            T = k15_threads(cap) if threads is None else int(threads)
            L.update(threads=T, smem=0,
                     need=(lens[order] * GLOBAL_ROW_BYTES + 7) // 8 * 8)
        need = L.pop("need")
        L["soff"] = (np.cumsum(need) - need).astype(np.int64)
        L["scratch"] = int(need.sum())
        out.append(L)
    return out


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
    the fit's training order), ``upos`` (positions in the fit's grouped
    order), ``sign``; per fit: ``classes``, ``counts``, ``perm`` (the
    grouped order), ``pair0`` (first problem), ``gram``, ``group`` (its
    vote group) and, when eval points were given, ``eval_ids``."""
    ids: np.ndarray
    pos: np.ndarray
    upos: np.ndarray
    sign: np.ndarray
    off: np.ndarray
    C: np.ndarray
    gram: np.ndarray
    fits: list
    eval_off: np.ndarray
    eval_ids: np.ndarray
    groups: np.ndarray
    uni: np.ndarray

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

    def vote_groups(self):
        """K16's vote groups: (int64 [G, 4] rows (first fit, fits, offset
        of the group's rows in ``uni``, their count), ``uni`` int32: each
        group's Gram ids in grouped order, ``upos`` int32 [R]: each
        problem row's position among its group's rows)."""
        return self.groups, self.uni, self.upos


def plan_fits(fits, evals=None):
    """Pack ``fits``, a list of (gram index, train ids, labels, C), into a
    :class:`Plan`; ``evals`` (optional) gives each fit's eval Gram ids.
    Raises ``ValueError`` for a fit of fewer than two classes (libsvm's
    message) or a C that is not positive.  Consecutive fits on the same
    Gram with equal train ids, labels and eval ids share a vote group."""
    ids, pos, upos, sign, lens, Cs, grams, meta = [], [], [], [], [], [], \
        [], []
    pair0 = 0
    same, prev = [], None
    for g, train, labels, C in fits:
        train_in = train
        train = np.asarray(train, np.int64)
        labels = np.asarray(labels)
        classes, codes = np.unique(labels, return_inverse=True)
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
        grouped = _segments(seg_start, seg_len)
        rows = perm[grouped]
        pos.append(rows)
        upos.append(grouped)
        ids.append(train[rows])
        sign.append(np.repeat(np.tile(np.array([1, -1], np.int8),
                                      ii.shape[0]), seg_len))
        lens.append(counts[ii] + counts[jj])
        Cs.append(np.full(ii.shape[0], float(C)))
        grams.append(np.full(ii.shape[0], int(g), np.int32))
        meta.append({"classes": classes, "counts": counts, "perm": perm,
                     "pair0": pair0, "n_pairs": int(ii.shape[0]),
                     "gram": int(g)})
        same.append(prev is not None and int(g) == prev[0]
                    and (train_in is prev[1] or np.array_equal(train,
                                                                prev[2]))
                    and np.array_equal(labels, prev[3]))
        prev = (int(g), train_in, train, labels)
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
    evals = list(evals)
    ev = [np.asarray(e, np.int64).reshape(-1) for e in evals]
    eval_off = np.concatenate([[0], np.cumsum([e.shape[0] for e in ev])]
                              ).astype(np.int64)
    # vote groups: runs of fits that read the same Gram entries
    lead = [f for f in range(len(fits)) if not (
        same[f] and (evals[f] is evals[f - 1]
                     or np.array_equal(ev[f], ev[f - 1])))]
    bounds = np.array(lead + [len(fits)], np.int64)
    uni = [fits[f][1] for f in lead]
    uni = [np.asarray(u, np.int64)[m["perm"]] for u, m in
           zip(uni, (meta[f] for f in lead))]
    ulen = np.array([u.shape[0] for u in uni], np.int64)
    groups = np.zeros((len(lead), 4), np.int64)
    if lead:
        groups[:, 0] = bounds[:-1]
        groups[:, 1] = np.diff(bounds)
        groups[:, 2] = np.cumsum(ulen) - ulen
        groups[:, 3] = ulen
    for gi, f in enumerate(lead):
        for f2 in range(f, int(bounds[gi + 1])):
            meta[f2]["group"] = gi
    return Plan(ids=cat(ids, np.int32), pos=cat(pos, np.int64),
                upos=cat(upos, np.int32), sign=cat(sign, np.int8),
                off=off.astype(np.int32), C=cat(Cs, np.float64),
                gram=cat(grams, np.int32), fits=meta, eval_off=eval_off,
                eval_ids=cat(ev, np.int32), groups=groups,
                uni=cat(uni, np.int32))


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
    every live problem), over the widest active set's columns: (found,
    i, j, Q row i over those columns)."""
    pick = (lambda x: x) if S is None else (lambda x: x[S])
    W = max(int(pick(b.active).max()), 1)
    G, y, st, inact = (pick(x)[:, :W] for x in (b.G, b.y, b.st, b.inact))
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
    Qi = b.q(pick(b.ids)[:, :W], pick(b.col)[:, :W], y, ic[:, 0])
    QD = pick(b.QD)[:, :W]
    quad = (QD.gather(1, ic) + QD) - y * ((2.0 * y.gather(1, ic)) * Qi)
    quad = torch.where(quad > 0, quad, TAU)
    obj = torch.where(ok, -(gd * gd) / quad, _INF)
    j = _last(ok & (obj == obj.amin(1)[:, None]), pos1)
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
    """One SMO update of every live problem on its pair (i, j); ``Qi``
    holds Q row i over the first columns, at least every active one."""
    W = Qi.shape[1]
    ij = torch.stack([i, j], 1)
    Gij, aij, QDij, yij = (x.gather(1, ij) for x in (b.G, b.a, b.QD, b.y))
    Gi, Gj, ai, aj = Gij[:, 0], Gij[:, 1], aij[:, 0], aij[:, 1]
    Qj = b.q(b.ids[:, :W], b.col[:, :W], b.y[:, :W], j)
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
    G = b.G[:, :W]
    b.G[:, :W] = torch.where(b.inact[:, :W],
                             G + (Qi * da[:, :1] + Qj * da[:, 1:]), G)
    b.a.scatter_(1, ij, anew)
    was_up = b.st.gather(1, ij) == UPPER
    new_st = torch.where(anew >= C[:, None], UPPER,
                         torch.where(anew <= 0, LOWER, FREE)).to(torch.int8)
    b.st.scatter_(1, ij, new_st)
    changed = was_up != (new_st == UPPER)
    if changed.any():
        # G_bar runs over every row: Q rows i and j over the full width
        for k, r in ((0, i), (1, j)):
            ch = changed[:, k]
            if ch.any():
                t = C[:, None] * b.q(b.ids, b.col, b.y, r)
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
    each problem's active rows summed over its iterations.  Raises
    ``ValueError`` when a Gram the batch reads, or its diagonal, holds
    NaN or infinity."""
    P = off.shape[0] - 1
    R = int(off[-1]) if P else 0
    g_host = np.zeros(1, np.int64) if gram is None else gram.numpy()
    require_finite("smo_plain",
                   _used_grams(Kf if Kf.dim() == 3 else Kf[None], g_host),
                   _used_grams(diag if diag.dim() == 2 else diag[None],
                               g_host))
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
            # the problems that found no pair select again on every row;
            # the others' selections do not change
            R2 = torch.nonzero(~found).reshape(-1)
            _reconstruct(b, R2)
            b.set_active(R2, b.l[R2])
            found, i, j, Qi = _select(b, None)
            b.counter[R2[found[R2]]] = 1
            if not found.all():
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
    row-major; pred int32 [E], each point's class index).  Raises
    ``ValueError`` when a Gram the models read holds NaN or infinity."""
    models = models.cpu()
    M = models.shape[0]
    require_finite("vote_plain", _used_grams(
        K if K.dim() == 3 else K[None],
        np.zeros(1, np.int64) if gram is None else gram.cpu().numpy()[:M]))
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


def smo_cuda(Kf, diag, ids, sign, off, C, gram=None, warp_rows=None,
             block_rows=None, threads=None, work=None):
    """K15 (``csrc/csvc.cu``): :func:`smo_plain` on a card, one launch a
    route (:func:`k15_routes`: a warp a problem up to ``warp_rows``
    rows, a block a problem up to ``block_rows``, a block on a global
    scratch past it).  The same arguments, contiguous on one CUDA device,
    and ``off``, ``C`` and ``gram`` also readable on the host (they are
    fetched once); ``threads`` sets the block and global routes' block
    size (default :func:`k15_block_shape`, :func:`k15_threads`); ``work``
    (int64 [P] on the device, optional) receives each problem's active
    rows summed over its iterations.  Refuses a Gram or diagonal that
    the batch reads and that holds NaN or infinity.  Counts on
    ``smo_cuda.launches`` (one a launch) and ``smo_cuda.route_launches``;
    ``smo_cuda.last_route`` keeps the last call's launches."""
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
    C_host = C.cpu().numpy()
    _check(bool((C_host > 0).all()), name, "every C > 0")
    g_host = gram.cpu().numpy()
    _check(((g_host >= 0) & (g_host < Kg.shape[0])).all(), name,
           "gram indices into the stack")
    require_finite(name, _used_grams(Kg, g_host), _used_grams(dg, g_host))
    try:
        plan = k15_launches(lens, C_host, k15_routes(lens, warp_rows,
                                                     block_rows), threads)
    except ValueError as e:
        raise ValueError("%s: %s" % (name, e)) from None
    for L in plan:
        scratch = torch.empty(max(L["scratch"], 8), dtype=torch.uint8,
                              device=dev)
        order = torch.from_numpy(L["order"]).to(dev)
        soff = torch.from_numpy(L["soff"]).to(dev)
        _build.launch("grakel_csvc_smo", dev, ROUTES.index(L["route"]),
                      Kg.data_ptr(), n, dg.data_ptr(), ids.data_ptr(),
                      sign.data_ptr(), off.data_ptr(), C.data_ptr(),
                      gram.data_ptr(), order.data_ptr(), len(L["order"]),
                      L["cap"], L["threads"], scratch.data_ptr(),
                      soff.data_ptr(), coef.data_ptr(), rho.data_ptr(),
                      iters.data_ptr(),
                      None if work is None else work.data_ptr())
        smo_cuda.launches += 1
        smo_cuda.route_launches[L["route"]] += 1
    smo_cuda.last_route = {L["route"]: {
        "problems": len(L["order"]), "max_rows": L["cap"],
        "threads": L["threads"], "rows_per_thread": L["rows_per_thread"],
        "smem": L["smem"]} for L in plan}
    return coef, rho, iters


smo_cuda.launches = 0
smo_cuda.route_launches = {r: 0 for r in ROUTES}
smo_cuda.last_route = None


def k16_blocks(groups, models, E, threads=K16_THREADS):
    """K16's block plan, vectorised: int32 [B, 3] rows (vote group,
    first point, points).  A group's points (its first model's) go in
    runs of ``threads // (models x pairs)`` points (1 to
    ``K16_POINTS``, the points a block stages), or of ``threads`` points
    for a group of one binary model (read straight from the Gram); a
    group without points or pairs gets no block."""
    groups = np.asarray(groups, np.int64).reshape(-1, 4)
    models = np.asarray(models, np.int64).reshape(-1, 4)
    if not groups.shape[0]:
        return np.zeros((0, 3), np.int32)
    e_end = np.concatenate([models[1:, 2], [E]])
    lead = groups[:, 0]
    pts = e_end[lead] - models[lead, 2]
    k = models[lead, 1]
    npair = k * (k - 1) // 2
    combos = groups[:, 1] * npair
    per = np.where(combos == 1, threads,
                   np.clip(threads // np.maximum(combos, 1), 1, K16_POINTS))
    nb = np.where((pts > 0) & (npair > 0), -(-pts // per), 0)
    g = np.repeat(np.arange(groups.shape[0]), nb)
    first = (np.arange(int(nb.sum())) - np.repeat(np.cumsum(nb) - nb, nb)) \
        * per[g]
    return np.stack([g, first, np.minimum(per[g], pts[g] - first)],
                    1).astype(np.int32)


def k16_single_groups(host_off, host_models):
    """Vote groups of one model each, its problems' rows concatenated:
    (groups int64 [M, 4], each row's position among its model's rows
    int32 [R]); the group rows are ``ids`` itself."""
    M = host_models.shape[0]
    R = int(host_off[-1])
    npair = host_models[:, 1] * (host_models[:, 1] - 1) // 2
    r0 = host_off[host_models[:, 0]]
    r1 = host_off[host_models[:, 0] + npair]
    groups = np.stack([np.arange(M), np.ones(M, np.int64), r0, r1 - r0], 1)
    upos = np.zeros(R, np.int64)
    rows = _segments(r0, r1 - r0)
    upos[rows] = rows - np.repeat(r0, r1 - r0)
    return groups.astype(np.int64), upos.astype(np.int32)


def k16_compact(coef, off, upos):
    """Each problem's rows of nonzero coefficient, in order, on the
    coefficients' device: (their positions among the group's rows
    ``upos`` int32, their coefficients f64, int32 offsets [P + 1])."""
    nz = torch.nonzero(coef != 0).reshape(-1)
    return (upos[nz].contiguous(), coef[nz].contiguous(),
            torch.searchsorted(nz, off.long()).to(torch.int32))


def vote_cuda(K, eval_ids, ids, coef, off, rho, models, gram=None,
              groups=None):
    """K16 (``csrc/csvc.cu``): :func:`vote_plain` on a card in ONE
    launch, a block a run of eval points of one vote group: it stages
    the Gram entries of its points at the group's rows once for every
    model and pair of the group, sums each pair's nonzero rows from
    there, then votes.  The same arguments, contiguous on one CUDA
    device (``models`` and ``off`` also on the host); ``groups`` (host
    arrays from :meth:`Plan.vote_groups`) names the models that share
    rows and eval points, default a group a model.  Refuses a Gram that
    the models read and that holds NaN or infinity.  Counts on
    ``vote_cuda.launches``."""
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
    g_host = gram.cpu().numpy()[:M]
    if M:
        npair = host_models[:, 1] * (host_models[:, 1] - 1) // 2
        _check(((host_models[:, 0] + npair) <= P).all()
               and (host_models[:, 2] <= E).all(), name,
               "models inside the problems and eval points")
        _check(((g_host >= 0) & (g_host < Kg.shape[0])).all(), name,
               "gram indices into the stack")
        last = host_models[-1]
        n_dec = int(last[3] + (E - last[2]) * npair[-1])
    else:
        n_dec = 0
    require_finite(name, _used_grams(Kg, g_host))
    dec = torch.empty(n_dec, dtype=torch.float64, device=dev)
    pred = torch.empty(E, dtype=torch.int32, device=dev)
    host_off = off.cpu().numpy().astype(np.int64)
    if groups is None:
        gtab, upos = k16_single_groups(host_off, host_models)
        uni = ids
    else:
        gtab, uni, upos = groups
        gtab = np.asarray(gtab, np.int64).reshape(-1, 4)
        _check(upos.shape[0] == ids.shape[0] and gtab[:, 1].sum() == M,
               name, "groups covering every model, a position a row")
        uni = torch.from_numpy(np.ascontiguousarray(uni, np.int32)).to(dev)
    blocks = k16_blocks(gtab, host_models, E)
    if blocks.shape[0] == 0:
        return dec, pred
    cu, cc, coff = k16_compact(coef, off, torch.from_numpy(
        np.ascontiguousarray(upos, np.int32)).to(dev))
    cur = torch.empty(max(n_dec, 1), dtype=torch.int32, device=dev)
    # the points a staging block holds (a one-pair model's block stages
    # nothing)
    k = host_models[gtab[blocks[:, 0], 0], 1]
    staged = blocks[:, 2][gtab[blocks[:, 0], 1] * (k * (k - 1) // 2) > 1]
    per = int(staged.max()) if staged.size else 1
    bl = torch.from_numpy(blocks).to(dev)
    md = torch.from_numpy(host_models).to(dev)
    gd = torch.from_numpy(gtab).to(dev)
    _build.launch("grakel_csvc_vote", dev, Kg.data_ptr(), Kg.shape[1],
                  Kg.shape[2], eval_ids.data_ptr(), uni.data_ptr(),
                  cu.data_ptr(), cc.data_ptr(), coff.data_ptr(),
                  rho.data_ptr(), md.data_ptr(), gram.data_ptr(),
                  gd.data_ptr(), bl.data_ptr(), int(blocks.shape[0]),
                  K16_THREADS, K16_CHUNK, per, dec.data_ptr(),
                  cur.data_ptr(), pred.data_ptr())
    vote_cuda.launches += 1
    return dec, pred


vote_cuda.launches = 0


# --------------------------------------------------------------------- #
# dispatchers
# --------------------------------------------------------------------- #

def smo(Kf, diag, ids, sign, off, C, gram=None, work=None):
    """K15 on the Gram's device: :func:`smo_plain` for CPU tensors,
    :func:`smo_cuda` (one launch a route) for CUDA ones.  Either refuses
    a non-finite Gram or diagonal with ``ValueError``."""
    if Kf.device.type == "cpu":
        return smo_plain(Kf, diag, ids, sign, off, C, gram, work)
    if Kf.device.type != "cuda":
        raise ValueError("smo: unsupported device %s" % Kf.device)
    return smo_cuda(Kf, diag, ids, sign, off, C, gram, work=work)


def vote(K, eval_ids, ids, coef, off, rho, models, gram=None, groups=None):
    """K16 on the Gram's device: :func:`vote_plain` for CPU tensors,
    :func:`vote_cuda` (one launch; ``groups`` as there) for CUDA ones.
    Either refuses a non-finite Gram with ``ValueError``."""
    if K.device.type == "cpu":
        return vote_plain(K, eval_ids, ids, coef, off, rho, models, gram)
    if K.device.type != "cuda":
        raise ValueError("vote: unsupported device %s" % K.device)
    return vote_cuda(K, eval_ids, ids, coef, off, rho, models, gram, groups)
