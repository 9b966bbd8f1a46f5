"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped (``device="cpu"``), small sizes,
each fault the cells can have planted in the program."""

import numpy as np
import pytest
import torch

from bench_port.run import run_cell

SMALL = {"data": {"graphs": 60, "held_out": 2}}
CV_SMALL = {"n_iter": 2, "n_splits": 3}
SEED = 2 ** 31 + 11


def _run(cell):
    mix = CV_SMALL if cell.endswith(".cv") else None
    res, _ = run_cell(cell, SEED, 0.2, 0, device="cpu",
                      config_override=SMALL, mix_override=mix)
    return res


@pytest.mark.parametrize("cell", ["wl_nci1.fit", "sp_nci1.fit",
                                  "wl_nci1.cv"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res["checks"])[-1] in ("gram_err", "fold_gap")
    assert list(res)[-1] == "checks"


def _wrap_output(monkeypatch, cls, change):
    orig = cls.fit_transform

    def fit_transform(self, X, y=None):
        return change(self, X, orig)

    monkeypatch.setattr(cls, "fit_transform", fit_transform)


def _altered(self, X, orig):
    K = np.array(orig(self, X), np.float64)
    K[3, 5] += 1e-6 if self.normalize else 1.0
    return K


def _half(self, X, orig):
    X = list(X)
    K = np.asarray(orig(self, X[:len(X) // 2]), np.float64)
    return np.tile(K, (2, 2))


@pytest.mark.parametrize("fault", ["state_unchanged", "altered", "half"])
@pytest.mark.parametrize("cell,cls", [("wl_nci1.fit", "WeisfeilerLehman"),
                                      ("sp_nci1.fit", "ShortestPath")])
def test_fit_faults_are_not_correct(monkeypatch, cell, cls, fault):
    import grakel_torch
    from grakel_torch.kernels import shortest_path
    from grakel_torch.ops import wl
    if fault == "state_unchanged" and cls == "WeisfeilerLehman":
        # a refinement that keeps every vertex's label
        monkeypatch.setattr(wl, "_wl_hash_refine_csr",
                            lambda labels, off, tgt: labels.long())
    elif fault == "state_unchanged":
        # all-pairs shortest paths that never relax a path past one edge
        def direct(A, M, integral=False):
            V = A.shape[1]
            S = torch.where(A > 0, A, torch.full_like(A, float("inf")))
            return torch.where(torch.eye(V, dtype=torch.bool)[None],
                               torch.zeros_like(S), S)
        monkeypatch.setattr(shortest_path, "batched_floyd_warshall", direct)
    else:
        _wrap_output(monkeypatch, getattr(grakel_torch, cls),
                     _altered if fault == "altered" else _half)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["gram_err"]["value"] > \
        res["checks"]["gram_err"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "altered", "half"])
def test_cv_faults_are_not_correct(monkeypatch, fault):
    from grakel_torch import metrics
    from grakel_torch.ops import csvc
    if fault == "state_unchanged":
        # a solver whose steps leave every alpha at 0
        def frozen(Kf, diag, ids, sign, off, C, gram=None, work=None):
            P = off.shape[0] - 1
            return (torch.zeros(int(off[-1]), dtype=torch.float64),
                    torch.zeros(P, dtype=torch.float64),
                    torch.zeros(P, dtype=torch.int32))
        monkeypatch.setattr(csvc, "smo", frozen)
    elif fault == "altered":
        # one held-out fold's score a call (20 test points at 60 graphs
        # in 3 splits; the inner validation sets hold 4)
        orig = metrics._PredictScorer.score
        seen = []

        def score(self, y_true, y_pred):
            s = orig(self, y_true, y_pred)
            if len(y_true) != 20:
                return s
            seen.append(1)
            return s + 0.05 if len(seen) % 6 == 1 else s
        monkeypatch.setattr(metrics._PredictScorer, "score", score)
    else:
        # the second half of each stage's eval points left out: they take
        # the first half's predictions
        orig = csvc.vote

        def vote(*args, **kw):
            dec, pred = orig(*args, **kw)
            pred = pred.clone()
            h = pred.shape[0] // 2
            pred[h:2 * h] = pred[:h]
            return dec, pred
        monkeypatch.setattr(csvc, "vote", vote)
    res = _run("wl_nci1.cv")
    assert not res["correct"]
    assert res["checks"]["fold_gap"]["value"] > \
        res["checks"]["fold_gap"]["limit"]
