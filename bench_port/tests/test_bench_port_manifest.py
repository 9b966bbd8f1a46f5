"""Every file ``BENCHMARK.json`` names is found by its name, the manifest
keeps the benchmark's contract, and a cell added as files alone (a mix,
an entry, a metric reader) is found and runs."""

import json
import os
import re
import shutil

import pytest

from bench_port.manifest import ROOT, Manifest
from bench_port.run import DRIVERS, run_cell

MAN = Manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_named_file_is_found():
    for c in MAN.doc["configs"]:
        cfg = MAN.config(c["name"])
        assert c["file"].startswith("bench_port/configs/")
        ref = MAN.reference(c["name"])
        assert callable(ref.gram) and callable(ref.control)
        assert cfg["kernel"]["class"] and "gram_err" in cfg["limits"]
    for w in MAN.doc["workloads"]:
        mix = MAN.mix(w["traffic"])
        assert mix["entry"] in DRIVERS
        assert mix["metric"] in [m["name"] for m in MAN.doc["end_to_end"]]
    for m in MAN.doc["per_layer"]:
        assert callable(MAN.reader(m["name"]))
    with pytest.raises(KeyError):
        MAN.cell("no_such.cell")


def test_manifest_keeps_the_contract():
    d = MAN.doc
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    for p in d["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p)) and ".." not in p
    assert all(not w.startswith("/") for w in d["command"])
    names = set()
    for key, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
        for e in d[key]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    assert {w["config"] for w in d["workloads"]} == \
        {c["name"] for c in d["configs"]}
    assert len({(w["config"], w["traffic"]) for w in d["workloads"]}) == \
        len(d["workloads"])
    metric_names = set()
    for key in ("end_to_end", "per_layer"):
        for m in d[key]:
            assert NAME.match(m["name"]) and m["name"] not in metric_names
            metric_names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert m["moves"] in [e["name"] for e in d["end_to_end"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in d["workloads"]:
        e2e = [m["name"] for m in MAN.metrics("end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert MAN.metrics("per_layer", w["name"])
    cells = len(d["workloads"])
    four = sum(w["chips"] == 4 for w in d["workloads"])
    assert four <= max(1, cells // 4)
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(d)) <= 64 * 1024


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = json.loads(json.dumps(MAN.doc))
    (root / "bench_port" / "mixes" / "fit_twice.json").write_text(
        json.dumps(dict(MAN.mix("fit"), warm_calls=2, rows_kept=3)))
    (root / "bench_port" / "metrics" / "calls.fit_twice.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    doc["workloads"].append({"name": "wl_nci1.fit_twice",
                             "config": "wl_nci1", "traffic": "fit_twice",
                             "chips": 1, "why": "a cell of files alone"})
    doc["end_to_end"][0]["workloads"].append("wl_nci1.fit_twice")
    doc["per_layer"].append({"name": "calls.fit_twice", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry point", "moves": "gram_fit_s",
                             "workloads": ["wl_nci1.fit_twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    man = Manifest(str(root))
    assert man.cell("wl_nci1.fit_twice")["traffic"] == "fit_twice"
    assert man.mix("fit_twice")["rows_kept"] == 3
    assert [m["name"] for m in man.metrics("per_layer",
                                           "wl_nci1.fit_twice")] == \
        ["calls.fit_twice"]
    assert man.reader("calls.fit_twice")
    res, _ = run_cell("wl_nci1.fit_twice", 5, 0.1, 0, device="cpu",
                      root=str(root),
                      config_override={"data": {"graphs": 30,
                                                "held_out": 2}})
    assert res["correct"]
    assert set(res["metrics"]) == {"gram_fit_s", "setup_s"}
