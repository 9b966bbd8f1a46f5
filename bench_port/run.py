"""Run one cell of the benchmark once and print its result line.

    python -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``grakel_torch``.  The run

1. makes the cell's data from ``--seed`` (:mod:`bench_port.graphs`),
2. sets up the cell's driver (the mix's ``entry``) and warms it up with
   the calls the window makes, all of which counts as ``setup_s``,
3. calls the entry point back to back, a new estimator each call, for
   ``--seconds`` seconds (a closed loop of one caller); with ``--trace
   1`` under torch.profiler,
4. reads the device's peak memory, frees the program's state, works the
   answers out again with the configuration's plain reference and
   compares them (the numbers compared, each beside its limit, end the
   standard error and the result line),
5. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
   per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
   ``checks`` last.

It exits with another code than 0, and prints no result, without a card
(or with fewer than the cell asks for), without ``grakel_torch``, or when
JAX, its libraries or the JAX package are loaded once the window has
closed.
"""

from __future__ import annotations

import os
import time


def _process_age():
    """Seconds since this process started (its start time in
    /proc/self/stat against /proc/uptime), or 0 where they cannot be
    read."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from bench_port import graphs as graph_data  # noqa: E402
from bench_port.importcheck import forbidden_loaded  # noqa: E402
from bench_port.manifest import ROOT, Manifest  # noqa: E402

__all__ = ["run_cell", "main", "DRIVERS", "cv_inputs"]


def _cache_dirs(root):
    """Every build and kernel cache the run may fill, at fixed paths
    inside the checkout (the program keeps its own nvcc build under
    ``build/kernels`` there)."""
    base = os.path.join(root, "build", "bench_port_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def cv_inputs(cfg, fit, seed):
    """The CV's class labels (:func:`graphs.class_labels`) and its
    ``random_state``, both from the seed."""
    y = graph_data.class_labels(fit, cfg["data"], seed)
    rs = int(np.random.default_rng([seed, 3]).integers(2 ** 31 - 1))
    return y, rs


def _kernel(cfg):
    import grakel_torch
    spec = cfg["kernel"]
    return getattr(grakel_torch, spec["class"])(**spec["params"])


# --------------------------------------------------------------------- #
# drivers: one a mix's "entry"
# --------------------------------------------------------------------- #

class FitDriver:
    """``fit_transform`` of the configuration's fit graphs, a new kernel
    each call.  Keeps ``rows_kept`` rows of each call's Gram, drawn from
    the seed, and the last call's whole Gram; the reference's Gram must
    match them within ``gram_err``."""

    def __init__(self, cfg, mix, fit, seed, ref, device):
        self.cfg, self.mix, self.fit, self.seed = cfg, mix, fit, seed
        self.ref, self.device = ref, device
        self.kept, self.last = [], None

    def setup(self):
        pass

    def call(self):
        return _kernel(self.cfg).fit_transform(self.fit)

    def keep(self, k, K):
        n = len(self.fit)
        if getattr(K, "shape", None) != (n, n):
            self.kept.append((None, None))
            return
        rows = np.random.default_rng([self.seed, 2, k]).choice(
            n, min(self.mix["rows_kept"], n), replace=False)
        self.kept.append((rows, np.array(K[rows], np.float64)))
        self.last = K

    def check(self):
        R = self.ref.gram(self.fit, self.cfg["kernel"]["params"],
                          self.device)
        err = float("inf") if self.last is None else float(
            np.abs(np.asarray(self.last, np.float64) - R).max())
        for rows, got in self.kept:
            err = max(err, float("inf") if rows is None
                      else float(np.abs(got - R[rows]).max()))
        return {"gram_err": (err, self.cfg["limits"]["gram_err"])}


class CVDriver:
    """``cross_validate_Kfold_SVM([K], y)`` on the Gram of the
    configuration's kernel over its fit graphs (made in set-up by the
    program) and the labels and ``random_state`` of :func:`cv_inputs`, at
    the mix's protocol, each fold's
    score kept (``fold_reduce=list``).  The reference works the Gram out
    again (``gram_err``) and then every fold's score (``fold_gap``: the
    largest over the calls of the summed absolute gaps)."""

    def __init__(self, cfg, mix, fit, seed, ref, device):
        self.cfg, self.mix, self.fit, self.seed = cfg, mix, fit, seed
        self.ref, self.device = ref, device
        self.y, self.rs = cv_inputs(cfg, fit, seed)
        self.kept = []

    def setup(self):
        self.K = _kernel(self.cfg).fit_transform(self.fit)

    def call(self):
        from grakel_torch import cross_validate_Kfold_SVM
        return cross_validate_Kfold_SVM(
            [self.K], self.y, n_iter=self.mix["n_iter"],
            n_splits=self.mix["n_splits"], random_state=self.rs,
            scoring=self.mix["scoring"], fold_reduce=list)

    def keep(self, k, out):
        self.kept.append(out)

    def check(self):
        from bench_port import svm_ref
        R = self.ref.gram(self.fit, self.cfg["kernel"]["params"],
                          self.device)
        gram_err = float(np.abs(np.asarray(self.K, np.float64) - R).max()) \
            if np.shape(self.K) == R.shape else float("inf")
        self.K = None
        want = np.asarray(svm_ref.cross_validate(
            R, self.y, self.mix["n_iter"], self.mix["n_splits"], self.rs,
            self.device), np.float64)
        gap = 0.0 if self.kept else float("inf")
        for out in self.kept:
            try:
                got = np.asarray(out[0], np.float64)
                g = float(np.abs(got - want).sum()) \
                    if got.shape == want.shape else float("inf")
            except (TypeError, ValueError, IndexError):
                g = float("inf")
            gap = max(gap, g) if np.isfinite(g) else float("inf")
        return {"gram_err": (gram_err, self.cfg["limits"]["gram_err"]),
                "fold_gap": (gap, self.mix["limits"]["fold_gap"])}


DRIVERS = {"fit_transform": FitDriver, "cross_validate_Kfold_SVM": CVDriver}


# --------------------------------------------------------------------- #
# the run
# --------------------------------------------------------------------- #

def Run(**kw):
    """What a per-layer metric's ``read(run)`` reads: the window's calls
    on the host clock (``calls``, (start, end) seconds), the profiler's
    ``timeline`` (:class:`bench_port.trace.Timeline`, or None), the data's
    ``stats`` (with ``sizes``, each graph's vertex count), the
    configuration ``cfg``, the mix ``mix`` and the published ``peaks``."""
    return SimpleNamespace(**kw)


def _window(driver, seconds, traced, sync):
    """Call back to back for ``seconds``; returns (calls, failed, first
    error)."""
    from contextlib import nullcontext
    mark = nullcontext
    if traced:
        from torch.profiler import record_function

        from bench_port.trace import CALL
        mark = lambda: record_function(CALL)  # noqa: E731
    calls, failed, err = [], 0, None
    t0 = time.perf_counter()
    while not calls or calls[-1][1] - t0 < seconds:
        a = time.perf_counter()
        try:
            with mark():
                out = driver.call()
                sync()
        except Exception:          # a call that raises counts as failed
            failed += 1
            err = err or traceback.format_exc()
            out = None
        b = time.perf_counter()
        calls.append((a, b))
        driver.keep(len(calls) - 1, out)
        del out
    return calls, failed, err


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(workload, seed, seconds, trace, device="cuda", root=ROOT,
             config_override=None, mix_override=None):
    """One run of ``workload``; returns (result dict, checks
    {name: (value, limit)}).  ``device="cpu"`` (tests only) runs the
    program under ``grakel_torch.use_device("cpu")`` with no card and no
    profiler; the overrides update the configuration's and the mix's
    JSON (tests run small sizes)."""
    man = Manifest(root)
    cell, cfg, mix, ref = man.resolve(workload, config_override,
                                      mix_override)
    phases = [("start", T_START), ("manifest", time.perf_counter())]
    import torch
    import grakel_torch
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.zeros(1, device="cuda")
    phases.append(("torch, grakel_torch, CUDA context", time.perf_counter()))
    fit, _ = graph_data.make_dataset(cfg["data"], seed)
    stats = graph_data.stats(fit)
    stats["sizes"] = [len(g[1]) for g in fit]
    phases.append(("data", time.perf_counter()))
    with grakel_torch.use_device(device):
        driver = DRIVERS[mix["entry"]](cfg, mix, fit, seed, ref, device)
        driver.setup()
        phases.append(("driver set-up", time.perf_counter()))
        for _ in range(mix.get("warm_calls", 1)):
            driver.call()
            sync()
            phases.append(("warm call", time.perf_counter()))
        setup_s = time.perf_counter() - T_START
        timeline = None
        if trace and cuda:
            from bench_port.trace import profile
            box = {}
            timeline = profile(lambda: box.update(zip(
                ("calls", "failed", "err"),
                _window(driver, seconds, True, sync))))
            calls, failed, err = box["calls"], box["failed"], box["err"]
        else:
            calls, failed, err = _window(driver, seconds, False, sync)
    if err:
        sys.stderr.write("first failed call:\n" + err)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
           if cuda else 0}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    metrics = {}
    if trace and timeline is not None:
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
        run = Run(calls=calls, timeline=timeline, stats=stats, cfg=cfg,
                  mix=mix, peaks=_peaks(root))
        for m in man.metrics("per_layer", workload):
            v = man.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    elif not trace:
        per_call = (calls[-1][1] - calls[0][0]) / len(calls)
        for m in man.metrics("end_to_end", workload):
            v = setup_s if m["name"] == "setup_s" else (
                per_call if m["name"] == mix["metric"] else None)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the reference runs once the window has closed and the program's
    # state is freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    phases.append(("window, trace", time.perf_counter()))
    checks = driver.check()
    phases.append(("reference", time.perf_counter()))
    d = [b - a for a, b in calls]
    sys.stderr.write("phases (s): %s\ncalls: %d, first %.4f s, median %.4f "
                     "s, last %.4f s\ncall s: %s\n" % (", ".join(
                         "%s %.3f" % (k, b - a) for (_, a), (k, b) in
                         zip(phases, phases[1:])), len(d), d[0],
                         float(np.median(d)), d[-1],
                         " ".join("%.4f" % x for x in d)))
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and timeline is not None:
        result["breakdown"] = timeline.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def _peaks(root):
    with open(os.path.join(root, "bench_port", "peaks.json")) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number of 0 or more")
    cell = Manifest().cell(args.workload)
    _cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write("bench_port: the cell %s needs %d CUDA card(s); "
                         "torch sees %s\n" % (
                             args.workload, cell["chips"],
                             torch.cuda.device_count()
                             if torch.cuda.is_available() else 0))
        return 3
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              args.trace)
    bad = forbidden_loaded()
    if bad:
        sys.stderr.write("bench_port: modules of JAX or of the JAX package "
                         "were loaded: %s\n" % ", ".join(bad))
        return 4
    for k, (v, lim) in checks.items():
        sys.stderr.write("check %s = %r (limit %r)\n" % (k, v, lim))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
