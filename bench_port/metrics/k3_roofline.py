"""K3's share of its roofline, in %: the least time the H100 could take
for all-pairs shortest paths on the call's graphs, over K3's kernel time
a call (the profiler's records of its kernels, ``fw_tile``,
``fw_init``, ``fw_step``, ``fw_pivot``, ``fw_panel``, ``fw_rest``).

Counted from the graphs' own vertex counts V (no padding to buckets):
bytes, each graph's f32 V x V adjacency read once and its distances
written once, 8 V^2; operations, V^3 min-plus steps of an add and a
minimum, 2 V^3.  The bound is the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s, float32 off the tensor cores (``peaks.json``:
the H100 SXM datasheet at its 700 W limit; the run's
``device.power_limit_w`` gives the card's own)."""

import re

import numpy as np

K3 = re.compile(r"(^|[^A-Za-z0-9_])fw_(tile|init|step|pivot|panel|rest)\b")


def bytes_and_ops(sizes):
    V = np.asarray(sizes, np.float64)
    return float((8 * V ** 2).sum()), float((2 * V ** 3).sum())


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    k3 = t.seconds(lambda name: K3.search(name) is not None) / len(run.calls)
    if k3 <= 0:
        return None
    nbytes, ops = bytes_and_ops(run.stats["sizes"])
    least = max(nbytes / run.peaks["hbm_bytes_per_s"],
                ops / run.peaks["fp32_flops_per_s"])
    return 100.0 * least / k3
