"""Host time a CV call in scoring its fits, in ms: the self time of the
program's ``grakel_torch.cv.score`` spans (each stage's scorers, on the
predictions fetched from K16), summed over the window and divided by the
calls."""

from bench_port.spans import self_ms


def read(run):
    return self_ms(run, ("cv.score",))
