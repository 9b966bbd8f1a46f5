"""Host time a fit call in the Gram's float64 normalization, in ms: the
self time of the program's ``grakel_torch.normalize`` spans
(``ops.gram.normalize_gram``), summed over the window and divided by
the calls."""

from bench_port.spans import self_ms


def read(run):
    return self_ms(run, ("normalize",))
