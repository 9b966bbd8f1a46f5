"""Lightweight tracing/observability.

* :class:`StageTimer` — wall-time per named pipeline stage, queryable
  and printable (``verbose`` prints it); ``with timer.stage("gram"):
  ...`` times a stage that launches device work;
* :func:`host_span` — a stage of host work only: timed on a
  :class:`StageTimer` when one is given and, while a torch profiler
  records, a ``record_function`` range ``grakel_torch.<name>`` on the
  profiler's clock, the clock of the device's records, so that an idle
  gap of the device carries the name of the host stage that held it.

A host span encloses no kernel launch, no copy and no ``.cpu()``: a
``record_function`` range over device work shows on the device's
timeline too, as an annotation from its first device record to its last,
and would read as device activity there.  Stages over device work keep a
timer-only ``stage``.

The spans, one a name where the work happens (``cv.plan`` and
``cv.score`` once a stage of the CV):

* ``parse``: ``Kernel.fit`` / ``transform`` of a kernel whose
  ``parse_input`` is host work only (``Kernel._host_parse``:
  ShortestPath's V-buckets, ShortestPathAttr, the vertex and edge
  histograms, WeisfeilerLehman's ``normalize_input``).  NeighborhoodHash,
  HadamardCode, GraphletSampling, LovaszTheta, SvmTheta and PyramidMatch
  launch device work in their parse, and the other kernels' parses are
  not held to host work, so theirs stays a timer-only stage;
* ``batch``: ``GraphBatch.from_graphs``' numpy build, ending before its
  upload;
* ``normalize``: the host route of ``ops.gram.normalize_gram`` (a numpy
  array or a CPU tensor) and the base class's normalization of a fit's
  Gram, float64 on the host.  A CUDA Gram is normalized on its card by
  K17 (``ops.gram.normalize_gram_cuda``), which opens no span: WL's fit
  times it as the timer-only stage ``normalize``, and the kernel's own
  profiler record gives its device time;
* ``cv.draws``, ``cv.check``, ``cv.plan``, ``cv.score``:
  ``utils.cross_validate_Kfold_SVM``'s splitter draws, its Grams' finite
  check and stack, each stage's fit lists and K15 / K16 plan, and each
  stage's scorers.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import torch
from torch.profiler import record_function

__all__ = ["StageTimer", "host_span", "SPAN_PREFIX"]

SPAN_PREFIX = "grakel_torch."


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
def host_span(name, timer=None):
    """The host stage ``name``: its wall time added to ``timer`` (a
    :class:`StageTimer`, or None) and, while a torch profiler records, a
    ``record_function("grakel_torch." + name)`` range; with no profiler,
    no range is made.  Enclose host work only (see the module
    docstring)."""
    timed = timer.stage(name) if timer is not None \
        else contextlib.nullcontext()
    traced = record_function(SPAN_PREFIX + name) \
        if torch.autograd._profiler_enabled() else contextlib.nullcontext()
    with timed, traced:
        yield
