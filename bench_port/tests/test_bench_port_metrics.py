"""The metric arithmetic on a canned profiler timeline and canned kernel
records, and the K2 and K3 counts on tiny graphs."""

import json

import numpy as np
import pytest

from bench_port.manifest import Manifest
from bench_port.run import Run
from bench_port.trace import CALL, WINDOW, Timeline

MAN = Manifest()
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"
DEVICE = [
    ("void (anonymous namespace)::wl_hash_csr(int const*, int)", 100, 110),
    (GEMM, 120, 150),
    ("Memcpy DtoH (Device -> Pageable)", 150, 170),
    ("void (anonymous namespace)::fw_tile<4>(float const*)", 200, 205),
    ("void (anonymous namespace)::fw_step(float*, long long)", 203, 210),
    ("void (anonymous namespace)::csvc_smo_block<8, 512>(float const*)",
     205, 209),
    ("(anonymous namespace)::csvc_vote(double const*, int)", 209, 210),
    (CALL, 100, 210),                 # an annotation, not device work
    ("void late_kernel()", 360, 380),  # after the window
]
HOST = [(WINDOW, 50, 350), (CALL, 60, 220), (CALL, 230, 340),
        ("aten::copy_", 140, 175), ("aten::mm", 115, 121)]


@pytest.fixture
def timeline():
    return Timeline(DEVICE, HOST)


def test_busy_idle_and_gaps(timeline):
    assert timeline.window_s == 300e-6
    assert timeline.intervals() == [(100, 110), (120, 170), (200, 210)]
    assert timeline.busy_s == pytest.approx(70e-6, abs=1e-15)
    assert timeline.gaps() == [(50, 100), (110, 120), (170, 200),
                               (210, 350)]
    assert timeline.host_at([75, 115, 185, 280, 345]) == [
        "in a call, after its start", "aten::mm",
        "in a call, after aten::copy_", "in a call, after its start",
        "between calls"]
    b = timeline.breakdown()
    assert b["device_ops"][0] == [GEMM, pytest.approx(30e-6)]
    assert all(name != CALL for name, _ in b["device_ops"])
    idle = dict(b["idle_gaps"])
    assert idle["in a call, after its start"] == pytest.approx(50e-6 + 140e-6)
    assert sum(idle.values()) == pytest.approx(230e-6)
    json.dumps(b)


def test_window_needs_its_span():
    with pytest.raises(ValueError):
        Timeline(DEVICE, [(CALL, 0, 1)])


def _run(timeline, **stats):
    with open(MAN.here + "/peaks.json") as f:
        peaks = json.load(f)
    return Run(calls=[(0.0, 1.0), (1.0, 2.5)], timeline=timeline,
               stats=stats, cfg={"kernel": {"params": {"n_iter": 5}}},
               mix={}, peaks=peaks)


def test_readers_on_canned_records(timeline):
    run = _run(timeline, vertices=10, directed_edges=20, sizes=[3, 4])
    read = lambda name: MAN.reader(name)(run)  # noqa: E731
    assert read("call_p95_s.fit") == pytest.approx(np.percentile([1, 1.5], 95))
    assert read("call_p95_s.cv") == read("call_p95_s.fit")
    assert read("device_idle.fit") == pytest.approx(100 * (1 - 70 / 300))
    assert read("device_idle.cv") == read("device_idle.fit")
    assert read("gemm_ms.fit") == pytest.approx(1e3 * 30e-6 / 2)
    assert read("gram_fetch_ms.fit") == pytest.approx(1e3 * 20e-6 / 2)
    assert read("k15_ms.cv") == pytest.approx(1e3 * 4e-6 / 2)
    assert read("k16_ms.cv") == pytest.approx(1e3 * 1e-6 / 2)
    k2_bytes = 5 * (4 * 10 + 4 * 11 + 8 * 10 + 4 * 20)
    assert read("k2_roofline") == pytest.approx(
        100 * k2_bytes / 3.35e12 / 5e-6)
    least = max(8 * (9 + 16) / 3.35e12, 2 * (27 + 64) / 67e12)
    assert read("k3_roofline") == pytest.approx(100 * least / 6e-6)


def test_readers_find_nothing_and_say_so():
    empty = Timeline([], [(WINDOW, 0, 10)])
    run = _run(empty, vertices=10, directed_edges=20, sizes=[3])
    for m in MAN.doc["per_layer"]:
        if not m["name"].startswith("call_p95"):
            assert MAN.reader(m["name"])(run) is None, m["name"]
    assert MAN.reader("k2_roofline")(_run(None, vertices=1)) is None


def test_k2_and_k3_counts_by_hand():
    k2 = MAN.reader("k2_roofline").__globals__["bytes_needed"]
    # a path of 3 vertices: 4 directed edges; one refinement reads 3
    # labels and 4 offsets, writes 3 keys, reads 4 targets
    assert k2(3, 4, 1) == 4 * 3 + 4 * 4 + 8 * 3 + 4 * 4
    assert k2(3, 4, 5) == 5 * k2(3, 4, 1)
    k3 = MAN.reader("k3_roofline").__globals__["bytes_and_ops"]
    # V = 2 and 3: adjacency read and distances written, 4 bytes each
    assert k3([2, 3]) == (8 * 4 + 8 * 9, 2 * 8 + 2 * 27)
