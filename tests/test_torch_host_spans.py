"""Where grakel_torch's host spans (``grakel_torch.profiling.host_span``)
fall: the WL and SP fits and the CV leave each of their spans a fixed
number of times a call, no torch operation runs inside a span (the CPU
stand-in for "no launch or copy inside a span"), and the CV's stage
records count the iterations of each stage's longest problem."""

from collections import Counter

import numpy as np
import pytest

import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset
from grakel_torch.profiling import SPAN_PREFIX


def _graphs(n=24, seed=3):
    train, _ = generate_dataset(n_graphs=n, n_graphs_test=1,
                                r_vertices=(4, 10), random_state=seed,
                                features=("nl", 3))
    return train


def _profiled(fn, calls=2):
    from torch.profiler import ProfilerActivity, profile
    with use_device("cpu"), profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(calls):
            fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in p.events()]


def _spans(events):
    return [e for e in events if e[0].startswith(SPAN_PREFIX)]


def _torch_ops_inside(events):
    """(op, span) for every aten record that lies inside a span."""
    return [(a[0], s[0]) for s in _spans(events) for a in events
            if a[0].startswith("aten::") and s[1] <= a[1] and a[2] <= s[2]]


def _wl_fit():
    grakel_torch.WeisfeilerLehman(n_iter=3, normalize=True).fit_transform(
        _graphs())


def _sp_fit():
    grakel_torch.ShortestPath().fit_transform(_graphs())


def _cv():
    graphs = _graphs(40, 5)
    with use_device("cpu"):
        K = grakel_torch.WeisfeilerLehman(n_iter=2).fit_transform(graphs)
    y = np.arange(len(graphs)) % 2
    return lambda: grakel_torch.cross_validate_Kfold_SVM(
        [K], y, n_iter=2, n_splits=2, random_state=0)


# each entry point's spans, and how many of each a call leaves
CASES = {
    "wl_fit": (lambda: _wl_fit, {"parse": 1, "batch": 1, "normalize": 1}),
    "sp_fit": (lambda: _sp_fit, {"parse": 1}),
    "cv": (_cv, {"cv.draws": 1, "cv.check": 1, "cv.plan": 2,
                 "cv.score": 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_point_leaves_its_spans_once_a_call(case):
    make, per_call = CASES[case]
    events = _profiled(make(), calls=2)
    got = Counter(e[0][len(SPAN_PREFIX):] for e in _spans(events))
    assert got == {k: 2 * v for k, v in per_call.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_torch_operation_inside_a_span(case):
    make, _ = CASES[case]
    events = _profiled(make(), calls=1)
    assert _spans(events)
    assert _torch_ops_inside(events) == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_span_without_a_profiler(case, monkeypatch):
    from grakel_torch import profiling

    def refuse(name):
        raise AssertionError("record_function entered for " + name)

    monkeypatch.setattr(profiling, "record_function", refuse)
    make, _ = CASES[case]
    fn = make()
    with use_device("cpu"):
        fn()


# the kernels whose parse is host work only (grakel_torch.profiling)
HOST_PARSE = ["EdgeHistogram", "ShortestPath", "ShortestPathAttr",
              "VertexHistogram", "WeisfeilerLehman"]


def test_host_parse_kernels_are_the_documented_ones():
    from grakel_torch import kernels
    assert sorted(name for name in kernels.__all__
                  if getattr(kernels, name)._host_parse) == HOST_PARSE


@pytest.mark.parametrize("name", HOST_PARSE)
def test_host_parse_fit_and_transform_open_parse_only_over_host_work(name):
    """A kernel that declares a host-only parse opens ``parse`` in fit
    and in transform, with no torch operation inside."""
    from grakel_torch import kernels
    feats = ("na", 3) if name == "ShortestPathAttr" else ("nl", 3, "el", 2)
    train, test = generate_dataset(n_graphs=12, n_graphs_test=4,
                                   r_vertices=(3, 8), random_state=7,
                                   features=feats)
    k = getattr(kernels, name)()

    def fit_and_transform():
        k.fit(train)
        k.transform(test)

    events = _profiled(fit_and_transform, calls=1)
    names = Counter(e[0] for e in _spans(events))
    assert names[SPAN_PREFIX + "parse"] == 2
    assert not [op for op, span in _torch_ops_inside(events)
                if span == SPAN_PREFIX + "parse"]


def test_device_parse_stays_a_timer_stage():
    """NeighborhoodHash's parse launches device work: timed, no span."""
    k = grakel_torch.NeighborhoodHash()
    events = _profiled(lambda: k.fit_transform(_graphs()), calls=1)
    assert SPAN_PREFIX + "parse" not in {e[0] for e in _spans(events)}
    assert k.timer_.counts["parse"] == 1


def test_wl_verbose_reports_its_stages(capsys):
    graphs = _graphs()
    k = grakel_torch.WeisfeilerLehman(n_iter=2, normalize=True,
                                      verbose=True)
    with use_device("cpu"):
        k.fit_transform(graphs[:16])
        k.transform(graphs[16:])
    err = capsys.readouterr().err
    assert err.count("[WeisfeilerLehman] stages:") == 2
    assert list(k.timer_.counts) == ["parse", "gram", "normalize",
                                     "parse_y", "gram_y", "normalize_y"]


def test_cv_stage_records_count_the_longest_problem():
    from grakel_torch.utils import cross_validate_Kfold_SVM as cv
    run = _cv()
    cv.keep_last = True
    try:
        with use_device("cpu"):
            run()
        stages = cv.last["stages"]
    finally:
        cv.keep_last = False
    assert len(stages) == 2
    for s in stages:
        iters = s["smo_out"][2].numpy()
        assert s["max_iterations"] == int(iters.max()) > 0
        assert s["max_iterations"] <= s["iterations"] == int(iters.sum())
