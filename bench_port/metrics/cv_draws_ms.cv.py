"""Host time a CV call in its random draws, in ms: the self time of the
program's ``grakel_torch.cv.draws`` spans (the KFold and ShuffleSplit
draws and the draws of numpy's global generator), summed over the window
and divided by the calls."""

from bench_port.spans import self_ms


def read(run):
    return self_ms(run, ("cv.draws",))
