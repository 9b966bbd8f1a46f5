"""K15's (libsvm's SMO, ``csrc/csvc.cu``) device time an iteration of its
chain, in us: its kernel records (``csvc_smo``) a CV call, over the
iterations of each stage's longest problem summed over the call's stages
(``max_iterations`` of the program's ``cross_validate_Kfold_SVM.last``
records).  Every call of a window runs the same protocol on the same
Gram and ``random_state``, so the last call's record stands for each.
This takes K15's seed-dependent amount of work out of ``k15_ms.cv``.
None without the record or the field."""

import sys


def _chain_iterations():
    pkg = sys.modules.get("grakel_torch")
    last = getattr(getattr(pkg, "cross_validate_Kfold_SVM", None), "last",
                   None)
    try:
        iters = [s["max_iterations"] for s in last["stages"]]
    except (TypeError, KeyError):
        return None
    return sum(iters) or None


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    s = t.seconds(lambda name: "csvc_smo" in name)
    iters = _chain_iterations()
    if s <= 0 or iters is None:
        return None
    return 1e6 * s / len(run.calls) / iters
