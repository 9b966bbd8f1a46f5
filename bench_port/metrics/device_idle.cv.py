"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the card: 1 - (union of the profiler's device activity intervals)
/ (the window's length)."""


def read(run):
    t = run.timeline
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
