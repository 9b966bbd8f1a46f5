"""Device-to-host copy time a call, in ms: the profiler's ``Memcpy DtoH``
records in the window, summed and divided by the calls.  The Gram's
``.cpu()`` is nearly all of it (67.6 MB of float32 at NCI1's 4110
graphs); the small reads a call makes are in it too."""


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    s = t.seconds(lambda name: "Memcpy DtoH" in name)
    return 1e3 * s / len(run.calls) if s > 0 else None
