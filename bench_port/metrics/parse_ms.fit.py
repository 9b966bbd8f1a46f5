"""Host time a fit call in turning the input into the program's own form,
in ms: the self time of the program's ``grakel_torch.parse`` spans (the
kernel's host-only ``parse_input``: WL's graphs, SP's V-buckets) and
``grakel_torch.batch`` spans (``GraphBatch``'s numpy build, ending
before its upload), summed over the window and divided by the calls."""

from bench_port.spans import self_ms


def read(run):
    return self_ms(run, ("parse", "batch"))
