"""The readers of the program's host spans and of its K15 record, on
canned timelines: self time under a nested span, None without the span
or the record, and the idle gaps labeled by the span that held them."""

import types

import pytest

from bench_port.manifest import Manifest
from bench_port.run import Run
from bench_port.spans import self_ms
from bench_port.trace import CALL, WINDOW, Timeline

MAN = Manifest()
SMO = "void (anonymous namespace)::csvc_smo_block<8, 512>(float const*)"
DEVICE = [("wl_hash", 100, 110), (SMO, 300, 330), (SMO, 700, 720)]
HOST = [
    (WINDOW, 0, 1000), (CALL, 10, 490), (CALL, 500, 990),
    # call 1: parse with a batch inside it, then normalize
    ("grakel_torch.parse", 20, 90), ("grakel_torch.batch", 40, 60),
    ("grakel_torch.normalize", 200, 280),
    # call 2: the CV's spans, a plan with a nested check
    ("grakel_torch.cv.draws", 510, 530), ("grakel_torch.cv.plan", 540, 640),
    ("grakel_torch.cv.check", 560, 600), ("grakel_torch.cv.score", 650, 690),
    ("aten::to", 95, 99),
    # outside the window: not read
    ("grakel_torch.parse", 1100, 1500),
]


def _run(timeline):
    return Run(calls=[(0.0, 1.0), (1.0, 2.0)], timeline=timeline, stats={},
               cfg={}, mix={}, peaks={})


@pytest.fixture
def run():
    return _run(Timeline(DEVICE, HOST))


def test_self_time_takes_the_nested_spans_out(run):
    # parse 70 us less its batch's 20, over 2 calls
    assert self_ms(run, ("parse",)) == pytest.approx(50e-3 / 2)
    assert self_ms(run, ("batch",)) == pytest.approx(20e-3 / 2)
    assert self_ms(run, ("cv.plan",)) == pytest.approx(60e-3 / 2)
    assert self_ms(run, ("cv.plan", "cv.check")) == pytest.approx(
        100e-3 / 2)
    assert self_ms(run, ("no.such",)) is None
    assert self_ms(_run(None), ("parse",)) is None


def test_span_readers_on_a_canned_window(run):
    read = lambda name: MAN.reader(name)(run)  # noqa: E731
    assert read("parse_ms.fit") == pytest.approx(70e-3 / 2)
    assert read("normalize_ms.fit") == pytest.approx(80e-3 / 2)
    assert read("cv_draws_ms.cv") == pytest.approx(20e-3 / 2)
    assert read("cv_plan_ms.cv") == pytest.approx(100e-3 / 2)
    assert read("cv_score_ms.cv") == pytest.approx(40e-3 / 2)


@pytest.mark.parametrize("name", ["parse_ms.fit", "normalize_ms.fit",
                                  "cv_draws_ms.cv", "cv_plan_ms.cv",
                                  "cv_score_ms.cv"])
def test_span_readers_without_their_spans(name):
    bare = Timeline(DEVICE, [e for e in HOST
                             if not e[0].startswith("grakel_torch.")])
    assert MAN.reader(name)(_run(bare)) is None
    assert MAN.reader(name)(_run(None)) is None


def _with_record(monkeypatch, last):
    import grakel_torch
    monkeypatch.setattr(grakel_torch.cross_validate_Kfold_SVM, "last", last)


def test_k15_per_iteration_reads_the_longest_problems(run, monkeypatch):
    _with_record(monkeypatch, {"stages": [
        {"iterations": 900, "max_iterations": 40},
        {"iterations": 90, "max_iterations": 10}]})
    # 50 us of csvc_smo over 2 calls, over 40 + 10 chain iterations
    assert MAN.reader("k15_us_per_iter.cv")(run) == pytest.approx(
        50 / 2 / 50)


@pytest.mark.parametrize("last", [
    None, {"stages": [{"iterations": 900}]},
    {"stages": [{"iterations": 0, "max_iterations": 0}]}])
def test_k15_per_iteration_without_its_record(run, monkeypatch, last):
    _with_record(monkeypatch, last)
    assert MAN.reader("k15_us_per_iter.cv")(run) is None


def test_k15_per_iteration_without_kernel_records(monkeypatch):
    _with_record(monkeypatch, {"stages": [{"max_iterations": 5}]})
    bare = Timeline([("wl_hash", 100, 110)], HOST)
    assert MAN.reader("k15_us_per_iter.cv")(_run(bare)) is None


def test_idle_gaps_take_the_name_of_the_span_that_held_them(run):
    t = run.timeline
    assert t.host_at([30, 50, 240, 520, 580, 620, 670]) == [
        "grakel_torch.parse", "grakel_torch.batch",
        "grakel_torch.normalize", "grakel_torch.cv.draws",
        "grakel_torch.cv.check", "grakel_torch.cv.plan",
        "grakel_torch.cv.score"]
    # each gap goes to what the host ran at its midpoint
    idle = dict(t.breakdown()["idle_gaps"])
    assert idle == pytest.approx({
        "grakel_torch.batch": 100e-6,           # (0, 100), at 50
        "grakel_torch.normalize": 190e-6,       # (110, 300), at 205
        "grakel_torch.cv.draws": 370e-6,        # (330, 700), at 515
        "in a call, after grakel_torch.cv.score": 280e-6})  # (720, 1000)


def test_span_readers_are_in_the_manifest():
    names = {m["name"]: m for m in MAN.doc["per_layer"]}
    for name in ("parse_ms.fit", "normalize_ms.fit", "cv_draws_ms.cv",
                 "cv_plan_ms.cv", "cv_score_ms.cv"):
        assert names[name]["source"] == "program_span"
    assert names["k15_us_per_iter.cv"]["source"] == "program_counter"
    assert types.FunctionType is type(MAN.reader("k15_us_per_iter.cv"))
