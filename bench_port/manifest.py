"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

- a configuration: its ``file`` (``configs/<name>.json``: the kernel, the
  data, the limits of its comparison) and its plain reference beside it
  (``configs/<name>.py``, with ``gram(graphs, params, device, dtype)``);
- a traffic mix: ``mixes/<traffic>.json``, the parameters that
  :mod:`bench_port.run`'s drivers read (``entry`` names the driver);
- a per-layer metric: ``metrics/<name>.py``, with ``read(run)``.

A later cell, configuration or metric is added as such files and
entries, without an edit to any file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os

__all__ = ["ROOT", "HERE", "Manifest", "load_module"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_module(path, name):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it
    names; raises ``KeyError`` for a name it does not hold and
    ``FileNotFoundError`` for a file that is not there."""

    def __init__(self, root=ROOT):
        self.root = root
        self.here = os.path.join(root, "bench_port")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)

    def _named(self, key, name):
        for entry in self.doc[key]:
            if entry["name"] == name:
                return entry
        raise KeyError("BENCHMARK.json has no %s named %r" % (key, name))

    def cell(self, name):
        return self._named("workloads", name)

    def config(self, name):
        """The configuration's JSON, with ``entry`` its manifest entry."""
        entry = self._named("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            cfg = json.load(f)
        cfg["entry"] = entry
        return cfg

    def reference(self, name):
        """The plain reference module beside the configuration's file."""
        entry = self._named("configs", name)
        path = os.path.splitext(os.path.join(self.root, entry["file"]))[0] \
            + ".py"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return load_module(path, "bench_port_ref_" + name.replace(".", "_")
                           .replace("-", "_"))

    def mix(self, traffic):
        with open(os.path.join(self.here, "mixes", traffic + ".json")) as f:
            return json.load(f)

    def metrics(self, key, cell):
        """The ``key`` ("end_to_end" or "per_layer") metrics ``cell``
        reports: those whose ``workloads`` list it, or, without the key,
        whose moved metric (per-layer) or every one (end-to-end) it
        reports."""
        e2e = [m["name"] for m in self.doc["end_to_end"]
               if cell in m.get("workloads", [cell])]
        out = []
        for m in self.doc[key]:
            if "workloads" in m:
                ok = cell in m["workloads"]
            else:
                ok = key == "end_to_end" or m["moves"] in e2e
            if ok:
                out.append(m)
        return out

    def resolve(self, workload, config_override=None, mix_override=None):
        """(cell, configuration, mix, reference module) of ``workload``;
        the overrides update the configuration's and the mix's JSON, a
        dict value updating that key's dict (tests run small sizes)."""
        cell = self.cell(workload)
        cfg = self.config(cell["config"])
        mix = self.mix(cell["traffic"])
        for d, o in ((cfg, config_override), (mix, mix_override)):
            for k, v in (o or {}).items():
                d[k] = dict(d[k], **v) if isinstance(v, dict) else v
        return cell, cfg, mix, self.reference(cell["config"])

    def reader(self, metric):
        """The per-layer metric's ``read(run)``."""
        path = os.path.join(self.here, "metrics", metric + ".py")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        mod = load_module(path, "bench_port_metric_"
                          + metric.replace(".", "_").replace("-", "_"))
        return mod.read
