"""The control of a cell's comparison: the plain reference, put in the
program's place and computed in the precision below the one the
configuration states, must come out as not correct.

    python -m bench_port.control --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, one JSON line with each number the cell compares
(as :mod:`bench_port.run` compares the program's answers), its limit,
and whether the control fails the comparison.  The controls:

- ``wl_nci1``: the Gram normalized in float32 (the configuration states
  float64), the counts exact (``configs/wl_nci1.py: control``);
- ``sp_nci1``: the exact counts rounded as a bfloat16 Gram would hold
  them (``configs/sp_nci1.py: control``);
- the ``cv`` mix: its Gram is the configuration's control, and the SVMs
  take Q from a bfloat16 copy of it (libsvm's is float32) and their
  decision values in float32 (float64).

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from bench_port import graphs as graph_data
from bench_port.manifest import ROOT, Manifest
from bench_port.run import cv_inputs

__all__ = ["control_numbers", "main"]


def control_numbers(workload, seed, device="cuda", root=ROOT,
                    config_override=None, mix_override=None):
    """{name: (control's number, limit)} of ``workload`` at ``seed``."""
    import torch

    from bench_port import svm_ref
    man = Manifest(root)
    cell, cfg, mix, ref = man.resolve(workload, config_override,
                                      mix_override)
    params = cfg["kernel"]["params"]
    fit, _ = graph_data.make_dataset(cfg["data"], seed)
    R = ref.gram(fit, params, device)
    C = np.asarray(ref.control(fit, params, device), np.float64)
    out = {"gram_err": (float(np.abs(C - R).max()),
                        cfg["limits"]["gram_err"])}
    if mix["entry"] == "cross_validate_Kfold_SVM":
        y, rs = cv_inputs(cfg, fit, seed)
        want = np.asarray(svm_ref.cross_validate(
            R, y, mix["n_iter"], mix["n_splits"], rs, device))
        got = np.asarray(svm_ref.cross_validate(
            C, y, mix["n_iter"], mix["n_splits"], rs, device,
            q_dtype=torch.bfloat16, vote_dtype=torch.float32))
        out["fold_gap"] = (float(np.abs(got - want).sum()),
                           mix["limits"]["fold_gap"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        nums = control_numbers(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": {k: {"value": v, "limit": lim}
                                      for k, (v, lim) in nums.items()},
                          "control_fails": any(v > lim for v, lim in
                                               nums.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
