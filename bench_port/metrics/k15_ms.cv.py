"""K15's (libsvm's SMO, ``csrc/csvc.cu``) device time a CV call, in ms:
the profiler's kernel records whose names hold ``csvc_smo``, summed over
the window and divided by the calls."""


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    s = t.seconds(lambda name: "csvc_smo" in name)
    return 1e3 * s / len(run.calls) if s > 0 else None
