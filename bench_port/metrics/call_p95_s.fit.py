"""The 95th percentile of the window's call times, host clock around each
call (the call and the wait for its device work), in seconds.  A
statistic of the entry point beside the cell's mean; no bound."""

import numpy as np


def read(run):
    d = [b - a for a, b in run.calls]
    return float(np.percentile(d, 95)) if d else None
