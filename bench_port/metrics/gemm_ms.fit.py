"""Device time a call in matrix products, in ms: the profiler's kernel
records whose names hold ``gemm`` (the counts-Grams of ``ops/gram.py``,
float32 with TF32 off), summed over the window and divided by the
calls."""


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    s = t.seconds(lambda name: "gemm" in name.lower())
    return 1e3 * s / len(run.calls) if s > 0 else None
