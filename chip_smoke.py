"""Smoke run of grakel_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``grakel_torch/csrc`` and drives its
main paths through the public entry points, at full data size:

* WL-VH: ``WeisfeilerLehman(n_iter=5)`` (VertexHistogram base)
  ``fit_transform`` on the 4110-graph NCI1-scale set of ``bench.py``
  (``generate_dataset``, seed 1234, 37 labels), then ``transform`` of
  held-out graphs.  Its Grams must equal the same calls under
  ``use_device("cpu")`` and its diagonal must equal ``diagonal()``;
* PyramidMatch (``with_labels=False``, L=4, d=6) ``fit_transform`` on a
  2000-graph REDDIT-B-scale stand-in (the heavy-tailed generator of
  ``tools/full_bench.py``, copied below), and labeled PyramidMatch on the
  NCI1-scale set.  Each Gram must equal the level Grams recomputed with
  the plain min-intersection from the same histograms, combined the same
  way.

Every kernel's launch count is set to 0 just before a path and read just
after it; a kernel of a path that launched no time in that run fails the
smoke.  Each path then runs again, warm (WL-VH 5 times, each PM path
twice; median reported), and once more under ``torch.profiler`` for its
device busy time, idle share and longest device activities.  Then each
kernel is held against its plain PyTorch version on the card at the
shapes the paths gave it (integer inputs exactly; the ragged
real-valued K1 case to rtol=1e-5, atol=1e-4, the f32 sum order
differing), and timed with CUDA events beside its bound (the larger of
bytes over 3.35 TB/s and operations over 67 TFLOP/s fp32, NVIDIA's H100
SXM figures), its plain version and, for K1, ``torch.cdist(p=1)`` as a
library yardstick (sum_l min(a, b) = (sum a + sum b - |a - b|_1) / 2).

Output, on separate lines: the card, the build, a ``{"paths": ...}``
JSON line, a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name
and power limit, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result line, without a CUDA card, outside the
repository, or when any check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_GRAPHS, N_LABELS, SEED, N_HELD = 4110, 37, 1234, 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
REDDIT_B = dict(n_graphs=2000, median=304, mean=429.63, vmax=3782,
                edge_ratio=1.1585)


def heavy_tailed_graphs(n_graphs, median, mean, vmax, edge_ratio, seed):
    """REDDIT-shaped stand-in (copy of tools/full_bench.py
    _heavy_tailed_graphs without its COLLAB branch): lognormal sizes
    truncated at the published maximum, a preferential-attachment tree
    plus uniform extra edges up to ``edge_ratio * n``.  Returns
    (n, src, dst) COO graphs, undirected, both directions."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(max(2.0 * np.log(mean / median), 1e-4))
    sizes = np.minimum(np.maximum(rng.lognormal(
        np.log(median), sigma, n_graphs), 6).astype(np.int64), vmax)
    for _ in range(8):
        err = mean / max(sizes.mean(), 1.0)
        if abs(err - 1.0) < 0.005:
            break
        sizes = np.minimum(np.maximum(
            (sizes * err).astype(np.int64), 6), vmax)
    out = []
    for n in sizes:
        n = int(n)
        parents = np.zeros(n, np.int64)
        if n > 1:
            draws = rng.randint(0, 2 * n, n)
            ends = np.zeros(2 * n, np.int64)
            ne = 0
            for v in range(1, n):
                p = int(ends[draws[v] % ne]) if ne else 0
                parents[v] = p
                ends[ne] = v
                ends[ne + 1] = p
                ne += 2
        s = np.arange(1, n, dtype=np.int64)
        d = parents[1:]
        extra = int(max(0, round(edge_ratio * n) - (n - 1)))
        if extra:
            es = rng.randint(0, n, extra)
            ed = rng.randint(0, n, extra)
            keep = es != ed
            s = np.concatenate([s, es[keep]])
            d = np.concatenate([d, ed[keep]])
        lo = np.minimum(s, d)
        hi = np.maximum(s, d)
        pairs = np.unique(lo * np.int64(vmax + 1) + hi)
        lo = (pairs // (vmax + 1)).astype(np.int32)
        hi = (pairs % (vmax + 1)).astype(np.int32)
        out.append((n, np.concatenate([lo, hi]), np.concatenate([hi, lo])))
    return out


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        print("%s: %s" % ("ok  " if ok else "FAIL", what), flush=True)
        if not ok:
            self.failed.append(what)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events
    around ``reps`` back-to-back calls, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled(fn):
    """Run ``fn()`` once under torch.profiler.  Returns (wall s, device
    busy ms = union of the CUDA activity intervals, {activity name: ms})
    or (wall s, None, {}) when the profiler saw no CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    if not spans:
        return wall, None, {}
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e3, by_name


def warm_runs(fn, reps):
    """Wall seconds of ``reps`` more runs of ``fn()`` (warm: kernels
    built, allocator and cuBLAS set up), their median, and one more run
    under torch.profiler: its wall, device busy time, idle share and
    the device activities that took longest."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall, busy, by_name = profiled(fn)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"warm_s": walls, "warm_median_s": float(np.median(walls)),
            "profiled": {"wall_s": wall, "device_busy_ms": busy,
                         "device_idle_share": None if busy is None
                         else 1.0 - busy / (1e3 * wall),
                         "top_device_ms": {k[:80]: v for k, v in top}}}


def level_grams(pm, min_gram):
    """Recompute a dense PyramidMatch fit Gram from its histograms: each
    level through ``min_gram``, combined with the integer weights
    2^(L-1) c_p as PyramidMatch does.  Returns (K f64 numpy, level
    matrices on the card)."""
    import torch
    cs = pm._level_coeffs()
    scale = float(2 ** max(pm.L - 1, 0))
    acc, mats = None, []
    for j in range(pm.L):
        w = pm.X[0][j].size
        A = torch.from_numpy(pm._level_matrix(pm.X, j, w)).cuda()
        mats.append(A)
        Kj = min_gram(A, A) * float(round(cs[j] * scale))
        acc = Kj if acc is None else acc + Kj
    return (acc.double() / scale).cpu().numpy(), mats


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import grakel_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: grakel_torch is not importable next to this "
              "script (%s); run it from the repository" % e,
              file=sys.stderr)
        return 2
    from grakel_torch import (Graph, PyramidMatch, WeisfeilerLehman,
                              use_device, _build)
    from grakel_torch.batch import GraphBatch
    from grakel_torch.datasets import generate_dataset
    from grakel_torch.kernels.base import normalize_input
    from grakel_torch.ops import intersect, wl as wl_ops

    check = Checks()
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0].strip() if smi else "nvidia-smi: no output"
    print("device: %s (torch %s, CUDA %s); %s"
          % (kind, torch.__version__, torch.version.cuda, smi), flush=True)

    t0 = time.perf_counter()
    lib_path, nvcc_out = _build.build(verbose=True)
    _build.load_library()
    build_s = time.perf_counter() - t0
    print("build: %.2f s -> %s" % (build_s, os.path.relpath(lib_path, HERE)),
          flush=True)
    for line in nvcc_out.splitlines():   # ptxas: registers, smem, spills
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    counters = {"min_gram": intersect.min_gram_cuda,
                "wl_hash_refine": wl_ops.wl_hash_refine_cuda}

    def run_path(name, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: c.launches for k, c in counters.items()}
        print("path %s: %.3f s, launches %s" % (name, secs, launches),
              flush=True)
        return out, secs, launches

    paths = {}

    # ---------------- WL-VH h=5, NCI1-scale ---------------------------- #
    train, held = generate_dataset(
        n_graphs=N_GRAPHS + N_HELD, n_graphs_test=N_HELD,
        r_vertices=(10, 50), r_connectivity=(0.07, 0.15),
        random_state=SEED, features=("nl", N_LABELS))

    def wl_path():
        wl = WeisfeilerLehman(n_iter=5, normalize=False)
        t = time.perf_counter()
        K = wl.fit_transform(train)
        t_fit = time.perf_counter() - t
        d = wl.diagonal()
        t = time.perf_counter()
        Kt = wl.transform(held)
        return K, d, Kt, t_fit, time.perf_counter() - t

    (K, d, Kt, t_fit, t_tr), secs, launches = run_path("wl_vh", wl_path)
    paths["wl_vh_h5_nci1scale"] = {"graphs": N_GRAPHS, "held_out": N_HELD,
                                   "wall_s": secs,
                                   "fit_transform_s_first": t_fit,
                                   "transform_s": t_tr,
                                   "launches": launches}
    check(launches["wl_hash_refine"] > 0, "WL-VH launched K2 (%d)"
          % launches["wl_hash_refine"])
    check(K.shape == (N_GRAPHS, N_GRAPHS) and np.isfinite(K).all()
          and Kt.shape == (N_HELD, N_GRAPHS) and np.isfinite(Kt).all(),
          "WL-VH Grams finite, shapes %s %s" % (K.shape, Kt.shape))
    check(np.array_equal(np.diagonal(K), d), "WL-VH diag(K) == diagonal()")

    def wl_fit():
        return WeisfeilerLehman(n_iter=5, normalize=False).fit_transform(
            train)

    paths["wl_vh_h5_nci1scale"].update(warm_runs(wl_fit, 5))
    check(np.array_equal(K, wl_fit()), "WL-VH repeat run identical")
    with use_device("cpu"):
        wl_c = WeisfeilerLehman(n_iter=5, normalize=False)
        t = time.perf_counter()
        Kc = wl_c.fit_transform(train)
        Ktc = wl_c.transform(held)
        paths["wl_vh_h5_nci1scale"]["cpu_s"] = time.perf_counter() - t
    check(np.array_equal(K, Kc) and np.array_equal(Kt, Ktc),
          "WL-VH Grams == use_device('cpu') Grams")
    del Kc, Ktc

    # ---------------- PM unlabeled, REDDIT-B-scale ---------------------- #
    coo = heavy_tailed_graphs(seed=SEED, **REDDIT_B)

    def reddit():
        # fresh Graph objects: PyramidMatch caches embeddings in them
        return [Graph.from_arrays(n, s, r) for n, s, r in coo]

    def pm_run(graphs, **kw):
        pm = PyramidMatch(L=4, d=6, **kw)
        return pm, pm.fit_transform(graphs())

    pm_mats = []   # the level matrices the PM paths gave K1
    for key, name, graphs, kw in (
            ("pm_unlabeled_redditb", "pm_unlabeled", reddit,
             {"with_labels": False}),
            ("pm_labeled_nci1scale", "pm_labeled", lambda: train,
             {"with_labels": True})):
        (pm, Kp), secs, launches = run_path(
            name, lambda g=graphs, k=kw: pm_run(g, **k))
        n = len(graphs())
        paths[key] = {"graphs": n, "wall_s": secs, "launches": launches,
                      "stages_s": dict(pm.timer_.times)}
        check(launches["min_gram"] > 0, "%s launched K1 (%d)"
              % (name, launches["min_gram"]))
        Kref, mats = level_grams(pm, intersect.min_gram_plain)
        check(Kp.shape == (n, n) and np.isfinite(Kp).all()
              and np.array_equal(Kp, Kref),
              "%s Gram == plain level Grams combined" % name)
        paths[key].update(warm_runs(lambda g=graphs, k=kw: pm_run(g, **k),
                                    2))
        pm_mats += mats
    paths["pm_unlabeled_redditb"]["max_vertices"] = int(max(
        n for n, _, _ in coo))
    print(json.dumps({"paths": paths}), flush=True)

    # ---------------- K1 against its plain version ---------------------- #
    def k1_case(A, B, integer):
        n, L = A.shape
        m = B.shape[0]
        K = intersect.min_gram_cuda(A, B)
        R = intersect.min_gram_plain(A, B)
        torch.cuda.synchronize()
        err = float((K - R).abs().max()) if K.numel() else 0.0
        ok = torch.equal(K, R) if integer else torch.allclose(
            K, R, rtol=1e-5, atol=1e-4)
        check(ok, "K1 %dx%dx%d %s vs plain, max abs err %g"
              % (n, m, L, "integer" if integer else "real", err))
        big = n * m * L > 1e9
        t_ops = 2.0 * n * m * L / FP32_OPS_PER_S
        t_bytes = 4.0 * (n * L + m * L + n * m) / HBM_BYTES_PER_S
        return {"n": n, "m": m, "L": L, "max_abs_err": err,
                "ms": cuda_ms(lambda: intersect.min_gram_cuda(A, B),
                              5 if big else 50),
                "plain_ms": cuda_ms(lambda: intersect.min_gram_plain(A, B),
                                    1 if big else 5),
                "library_ms": cuda_ms(lambda: torch.cdist(A, B, p=1),
                                      3 if big else 20),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    k1 = [k1_case(A, A, True) for A in pm_mats]
    rng = np.random.RandomState(SEED)
    ragged = k1_case(torch.from_numpy(rng.rand(37, 333).astype(np.float32))
                     .cuda(),
                     torch.from_numpy(rng.rand(1001, 333).astype(np.float32))
                     .cuda(), False)

    # ---------------- K2 against its plain version ---------------------- #
    batch = GraphBatch.from_graphs(normalize_input(train),
                                   node_label_enum={}, device="cuda")
    labs = batch.node_labels
    k2_err = 0
    for gen in range(3):
        args = (labs, batch.senders, batch.receivers, batch.edge_mask)
        h = wl_ops.wl_hash_refine_cuda(*args)
        p = wl_ops.wl_hash_refine_plain(*args)
        torch.cuda.synchronize()
        k2_err = max(k2_err, int((h[0] != p[0]).sum() + (h[1] != p[1]).sum()))
        labs = wl_ops.compact_ids(h[0], h[1], batch.node_mask)[0]
    check(k2_err == 0, "K2 bit-identical to plain on generations 0-2 "
          "(%d differing hashes)" % k2_err)
    N, E = labs.shape[0], batch.senders.shape[0]
    args = (labs, batch.senders, batch.receivers, batch.edge_mask)
    k2_bytes = 4 * N + 9 * E + 8 * N   # labels, edges+mask in; h1, h2 out
    _, busy, _ = profiled(lambda: [wl_ops.wl_hash_refine_cuda(*args)
                                   for _ in range(50)])
    k2 = {"nodes": N, "edges": E,
          "device_ms": None if busy is None else busy / 50,
          "ms": cuda_ms(lambda: wl_ops.wl_hash_refine_cuda(*args), 200, 5),
          "plain_ms": cuda_ms(lambda: wl_ops.wl_hash_refine_plain(*args), 20),
          "bound_ms": 1e3 * k2_bytes / HBM_BYTES_PER_S, "bound_by": "bytes"}

    def total(key):
        return sum(c[key] for c in k1)

    t_ops = sum(2.0 * c["n"] * c["m"] * c["L"] for c in k1) / FP32_OPS_PER_S
    t_bytes = sum(4.0 * ((c["n"] + c["m"]) * c["L"] + c["n"] * c["m"])
                  for c in k1) / HBM_BYTES_PER_S
    kernels = [
        {"name": "min_gram", "route": "cuda",
         "source": "grakel_torch/csrc/min_gram.cu",
         "replaces": "grakel_tpu/ops/intersect.py:55",
         "launches": paths["pm_unlabeled_redditb"]["launches"]["min_gram"]
         + paths["pm_labeled_nci1scale"]["launches"]["min_gram"],
         "max_abs_err": max(c["max_abs_err"] for c in k1 + [ragged]),
         "ms": total("ms"), "kernel_ms": total("ms"),
         "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": total("library_ms"),
         "summed_over": "one call per PM level of both PM paths",
         "shapes": k1, "ragged_real_check": ragged},
        {"name": "wl_hash_refine", "route": "cuda",
         "source": "grakel_torch/csrc/wl_hash.cu",
         "replaces": "grakel_tpu/ops/wl.py:71",
         "launches": paths["wl_vh_h5_nci1scale"]["launches"][
             "wl_hash_refine"],
         "max_abs_err": k2_err, "ms": k2["ms"], "kernel_ms": k2["ms"],
         "device_ms": k2["device_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shapes": [k2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print("nvidia-smi: %s" % smi, flush=True)
    if check.failed:
        print("chip_smoke: %d check(s) failed: %s"
              % (len(check.failed), "; ".join(check.failed)),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
