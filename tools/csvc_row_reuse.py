"""How often libsvm's working pair reuses a Q row it read lately.

Runs ``grakel_torch.ops.csvc.smo_plain`` (libsvm's SMO step for step, on
the CPU) on a few binary problems and counts, over every iteration's two
Q rows (i and j), the share found among the last 2, 4 or 8 rows read,
the list emptied at each shrink or reconstruction (K15 keeps rows by
position, and those move there).  It says whether a cache of recent Q
rows in shared memory would spare K15's block route a Gram gather.

    python tools/csvc_row_reuse.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from grakel_torch import WeisfeilerLehman, use_device  # noqa: E402
from grakel_torch.datasets import read_data  # noqa: E402
from grakel_torch.ops import csvc  # noqa: E402


def trace(K, y, C):
    """The (i, j) of each iteration of one binary fit, with a marker at
    each shrink or reconstruction."""
    seq = []
    step, shrink, rec = csvc._step, csvc._shrink, csvc._reconstruct

    def on_step(b, i, j, Qi):
        seq.append((int(i[0]), int(j[0])))
        return step(b, i, j, Qi)

    def on_move(fn):
        def wrapped(b, S):
            seq.append(None)
            return fn(b, S)
        return wrapped

    csvc._step = on_step
    csvc._shrink, csvc._reconstruct = on_move(shrink), on_move(rec)
    try:
        plan = csvc.plan_fits([(0, np.arange(K.shape[0]), y, C)])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        K64 = t(K)
        csvc.smo_plain(K64.float(), torch.diagonal(K64).contiguous(),
                       t(plan.ids), t(plan.sign), t(plan.off), t(plan.C),
                       t(plan.gram))
    finally:
        csvc._step, csvc._shrink, csvc._reconstruct = step, shrink, rec
    return seq


def reuse(seq, size):
    recent, hits, reads = [], 0, 0
    for pair in seq:
        if pair is None:
            recent = []
            continue
        for r in pair:
            reads += 1
            if r in recent:
                hits += 1
                recent.remove(r)
            recent.insert(0, r)
            del recent[size:]
    return hits / max(reads, 1)


def main():
    rng = np.random.RandomState(0)
    phi = rng.randn(600, 6)
    sq = (phi ** 2).sum(1)
    K = np.exp(-0.1 * (sq[:, None] + sq[None, :] - 2 * phi @ phi.T))
    y = (phi[:, 0] + 0.5 * phi[:, 1] + 0.8 * rng.randn(600) > 0).astype(int)
    b = read_data("MUTAG", path=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tests", "data"))
    with use_device("cpu"):
        Km = np.asarray(WeisfeilerLehman(n_iter=5, normalize=True)
                        .fit_transform(b.data), np.float64)
    ym = np.asarray(b.target)
    for name, KK, yy, C in (("RBF, 600 rows, C = 1", K, y, 1.0),
                            ("RBF, 600 rows, C = 100", K, y, 100.0),
                            ("MUTAG WL, C = 10", Km, ym, 10.0),
                            ("MUTAG WL, C = 1e3", Km, ym, 1e3)):
        seq = trace(KK, yy, C)
        its = sum(p is not None for p in seq)
        print("%s: %d iterations, rows found among the last 2 / 4 / 8: "
              "%s" % (name, its, " / ".join("%.3f" % reuse(seq, n)
                                            for n in (2, 4, 8))))


if __name__ == "__main__":
    main()
