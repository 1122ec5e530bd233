"""The span readers (``harness/spans.py`` and the ``serve_*`` metrics that
read the program's spans) on span rows and device intervals built by
hand, each against an answer worked out here: the clock mapping, idle time
inside views with a view that straddles the stretch's edge, idle time by
the innermost open span, gap labels, a view's self time; and a program
without these spans (the parent's) reads nothing."""

from types import SimpleNamespace

import pytest

from harness import spans as S
from harness.cell import SpanSink
from harness.spec import metric_reader


def _row(name, start, dur, sid, parent=None, **attrs):
    return {"name": name, "start_s": start, "dur_s": dur, "span_id": sid,
            "parent_id": parent, "trace_id": "t" + sid, **attrs}


def _ctx(rows):
    sink = SpanSink()
    for r in rows:
        sink(r)
    return SimpleNamespace(spans=sink)


VIEWS = [
    _row("serve.view", 0.0, 0.020, "v1"),
    _row("serve.rays", 0.000, 0.001, "r1", "v1"),
    _row("serve.image", 0.019, 0.0005, "i1", "v1"),
    _row("serve.view", 1.0, 0.030, "v2"),
    _row("serve.rays", 1.000, 0.002, "r2", "v2"),
    _row("serve.image", 1.028, 0.001, "i2", "v2"),
    _row("serve.view", 2.0, 0.0001, "v3"),  # a pose-cache hit: no rays
    _row("serve.rays", 3.0, 0.005, "r9", "elsewhere"),  # not a view's
    _row("serve.handoff", 0.0185, 0.0001, "h1", "v1"),
    _row("serve.handoff", 1.027, 0.0003, "h2", "v2"),
    _row("serve.handoff", 2.0, 0.0002, "h3", "v3"),
] + [_row("serve.queue", 0.001 * i, 0.005, f"q{i}", "v1",
          behind_s=0.001 * i) for i in range(20)]


def test_view_host_ms_is_the_median_of_rays_plus_image():
    # views 1 and 2: 1.5 and 3.0 ms; the hit and the stray rays count not
    assert metric_reader("serve_view_host_ms")(_ctx(VIEWS)) == \
        pytest.approx(2.25)


def test_handoff_ms_is_the_median_handoff():
    assert metric_reader("serve_handoff_ms")(_ctx(VIEWS)) == \
        pytest.approx(0.2)


def test_queue_behind_p95_ms():
    # behind 0 .. 19 ms: numpy's 95th percentile of 20 values, 18.05
    assert metric_reader("serve_queue_behind_p95_ms")(_ctx(VIEWS)) == \
        pytest.approx(18.05)


@pytest.mark.parametrize("name", ["serve_view_host_ms", "serve_handoff_ms",
                                  "serve_queue_behind_p95_ms"])
def test_a_program_without_the_spans_reads_nothing(name):
    """The spans a program had before ``serve.view``: a queue wait with no
    ``behind_s``, a batch, a dispatch, a scatter."""
    old = [_row("serve.queue", 0.0, 0.005, "q"),
           _row("serve.batch", 0.005, 0.01, "b", "q"),
           _row("serve.dispatch", 0.005, 0.001, "d", "b"),
           _row("serve.scatter", 0.016, 0.0001, "s", "q")]
    assert metric_reader(name)(_ctx(old)) is None


def test_place_maps_the_tracer_clock_onto_the_trace():
    # perf_counter 12.5 s; the Unix clock reads 1.7e18 ns + 2.5e9 there
    # (offset 1.7e18 - 10e9 ns); the trace started at 1.7e18 + 2.0e9 ns:
    # the span starts 0.5 s = 500,000 µs into the trace and lasts 2 ms
    offset = 1_700_000_000_000_000_000 - 10_000_000_000
    start = 1_700_000_000_000_000_000 + 2_000_000_000
    (s, e, row), = S.place([_row("serve.view", 12.5, 0.002, "v")], offset,
                           start)
    assert (s, e) == (pytest.approx(500_000.0), pytest.approx(502_000.0))
    assert row["span_id"] == "v"


def _placed(*spans):
    return [(s, e, {"name": n}) for n, s, e in spans]


def test_idle_in_views_clips_a_view_at_the_stretch_edges():
    # stretch 0-100 µs, busy 10-20 and 50-60: idle 0-10, 20-50, 60-100;
    # views -30..30 (straddles the start), 55-80, 90-130 (straddles the
    # end): idle inside a view 10 + 10 + 20 + 10 = 50 µs
    busy = [(10, 20), (50, 60)]
    views = _placed(("serve.view", -30, 30), ("serve.view", 55, 80),
                    ("serve.view", 90, 130), ("serve.queue", 35, 45))
    assert S.idle_in_views_us((0, 100), busy, views) == pytest.approx(50.0)


def test_idle_by_span_takes_the_innermost_open_span():
    # one view 0-100 holding a queue wait 5-40; another request's rays
    # 30-35; busy 10-20; stretch 0-120
    placed = _placed(("serve.view", 0, 100), ("serve.queue", 5, 40),
                     ("serve.rays", 30, 35))
    got = S.idle_by_span((0, 120), [(10, 20)], placed)
    assert got == {"serve.view": pytest.approx(65.0),
                   "serve.queue": pytest.approx(20.0),
                   "serve.rays": pytest.approx(5.0),
                   S.NO_REQUEST: pytest.approx(20.0)}
    assert sum(got.values()) == pytest.approx(110.0)  # all the idle time


def test_gaps_are_labelled_by_the_innermost_open_span():
    placed = _placed(("serve.view", 0, 1000), ("serve.queue", 100, 400))
    gaps = [(200, 300), (500, 700), (2000, 2500)]
    assert S.label_gaps(gaps, placed) == [
        ["serve.queue", 1e-4], ["serve.view", 2e-4], ["host idle", 5e-4]]


def test_view_self_time_is_what_no_child_covers():
    # view 0-10 s; children 1-3 and 2-5 (overlapping), 8-12 (past its
    # end), and a grandchild that does not count: covered 4 + 2
    rows = [_row("serve.view", 0.0, 10.0, "v"),
            _row("serve.rays", 1.0, 2.0, "a", "v"),
            _row("serve.queue", 2.0, 3.0, "b", "v"),
            _row("serve.handoff", 8.0, 4.0, "c", "v"),
            _row("serve.dispatch", 6.0, 1.0, "d", "b")]
    assert S.view_self_s(rows) == [pytest.approx(4.0)]


def test_probes_bound_and_fit_the_device_lag():
    # span 100-300 around a kernel the trace places at 1000-1150: the lag
    # lies in 850-900; span 400-600, kernel 1310-1480: 880-910; together
    # 880-900, at the kernels' mean start 1155
    t, lag = S.lag_at([(100, 300, 1000, 1150), (400, 600, 1310, 1480)])
    assert (t, lag) == (pytest.approx(1155.0), pytest.approx(890.0))
    # bounds -10..50 and 150..200 cannot both hold: the lag moved
    assert S.lag_at([(0, 100, 50, 90), (200, 300, 400, 450)])[1] is None
    fit = S.lag_fit([(0.0, 100.0), (1000.0, 200.0)])
    assert fit(500.0) == pytest.approx(150.0)
    assert S.shift([(500.0, 600.0)], fit) == [
        (pytest.approx(350.0), pytest.approx(440.0))]
