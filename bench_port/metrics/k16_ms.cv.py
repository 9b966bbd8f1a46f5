"""K16's (the one-vs-one vote, ``csvc_vote``) device time a CV call, in
ms: its kernel records summed over the window and divided by the
calls."""


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    s = t.seconds(lambda name: "csvc_vote" in name)
    return 1e3 * s / len(run.calls) if s > 0 else None
