"""The program's host spans on a traced window's timeline.

``grakel_torch`` names each stage of host work it runs with a
``record_function`` range ``grakel_torch.<stage>`` while a torch profiler
records (``grakel_torch.profiling.host_span``); they are host records of
:class:`bench_port.trace.Timeline`.  A span's self time is its length
less the part of it that spans inside it cover.
"""

from __future__ import annotations

__all__ = ["PREFIX", "self_ms"]

PREFIX = "grakel_torch."


def _covered(intervals):
    """The length of the union of the (start, end) ``intervals``."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_ms(run, names):
    """The self time of the program's spans named ``grakel_torch.<n>``
    for ``n`` in ``names``, summed over the window and divided by its
    calls, in ms; None without a timeline or without such a span."""
    t = run.timeline
    if t is None or not run.calls:
        return None
    spans = [e for e in t.host if e[0].startswith(PREFIX)
             and e[1] >= t.t0 and e[2] <= t.t1]
    # spans are in the timeline's order (start, then the longer first):
    # a span's children come after it and end no later
    total, found = 0.0, False
    for i, (name, a, b) in enumerate(spans):
        if name[len(PREFIX):] not in names:
            continue
        found = True
        kids = []
        for _, c, d in spans[i + 1:]:
            if c >= b:
                break
            if d <= b:
                kids.append((c, d))
        total += (b - a) - _covered(kids)
    return total / 1e3 / len(run.calls) if found else None
