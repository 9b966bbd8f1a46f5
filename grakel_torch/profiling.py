"""Lightweight tracing/observability.

* :class:`StageTimer` — wall-time per named pipeline stage, queryable
  and printable; used with ``with timer.stage("parse"): ...``;
* :func:`trace` — context manager around ``torch.profiler`` writing a
  TensorBoard-loadable trace (host and, with a card, CUDA activity)
  when a directory is given.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Accumulating per-stage wall timers."""

    def __init__(self):
        self.times = OrderedDict()
        self.counts = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        total = sum(self.times.values())
        lines = ["%-24s %8.3fs  x%-4d %5.1f%%" % (
            k, v, self.counts[k], 100.0 * v / total if total else 0.0)
            for k, v in self.times.items()]
        return "\n".join(lines + ["%-24s %8.3fs" % ("total", total)])

    def __repr__(self):
        return "StageTimer(\n%s\n)" % self.report()


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace via ``torch.profiler`` when ``log_dir`` is given; no-op
    otherwise.  Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
