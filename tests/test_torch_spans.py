"""The port's spans of a served view and of a training step
(``obs/trace.py``, ``serve/engine.py``, ``serve/batcher.py``,
``train/trainer.py``).

A view rendered through ``RenderEngine.render_view`` and a
``MicroBatcher`` is one trace rooted at ``serve.view`` (or under the HTTP
handler's ``serve.request``), whose spans tile its latency; ``serve.queue``
carries ``behind_s``, the part of its wait the worker spent on other
batches; a ``record_function`` inside a span lands inside that span once
``wall_offset_ns`` maps the span onto the profiler's clock;
``Trainer.step`` runs under ``train.step``; and a disabled tracer writes
nothing and changes no image.

Each test installs its own emitter, metrics registry and tracer and
restores the process's after (the tracer is reset by ``monkeypatch``)."""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.rays import pose_spherical
from nerf_replication_tpu_torch.obs import emit as port_emit
from nerf_replication_tpu_torch.obs import metrics as port_metrics
from nerf_replication_tpu_torch.obs import trace as port_trace
from nerf_replication_tpu_torch.obs.schema import validate_row
from nerf_replication_tpu_torch.serve import MicroBatcher, RenderEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
NEAR, FAR = 2.0, 6.0
BBOX = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
SERVE_OPTS = [
    "network.nerf.W", "32", "network.nerf.D", "4",
    "network.nerf.skips", "[1]",
    "task_arg.render_step_size", "0.25",
    "task_arg.max_march_samples", "64",
    "task_arg.march_chunk_size", "64",
    "task_arg.march_coarse_block", "4",
    "task_arg.march_coarse_cap", "3",
    "task_arg.march_fused_block", "64",
    "task_arg.march_fused", "full",
    "serve.buckets", "[64]", "serve.max_batch_rays", "64",
    "serve.cache_entries", "0",
]
VIEW_SPANS = {"serve.view", "serve.rays", "serve.queue", "serve.batch",
              "serve.dispatch", "serve.device", "serve.render",
              "serve.scatter", "serve.handoff", "serve.image"}


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def obs(monkeypatch):
    """A null emitter whose rows a tap collects, fresh metrics, and the
    process tracer restored after; yields the rows."""
    rows = []
    monkeypatch.setattr(port_emit, "_active", port_emit.NullEmitter())
    monkeypatch.setattr(port_metrics, "_registry",
                        port_metrics.MetricsRegistry())
    monkeypatch.setattr(port_trace, "_tracer",
                        port_trace.Tracer(enabled=False))
    port_emit.add_row_tap(rows.append)
    try:
        yield rows
    finally:
        port_emit.remove_row_tap(rows.append)


def _spans(rows):
    return [r for r in rows if r["kind"] == "span"]


@pytest.fixture(scope="module")
def engine():
    from nerf_replication_tpu_torch.models import init_params_for, make_network

    cfg = make_cfg(LEGO, SERVE_OPTS)
    net = make_network(cfg)
    init_params_for(cfg)(net, torch.Generator().manual_seed(0))
    grid = np.zeros((16, 16, 16), bool)
    grid[4:12, 4:12, 4:12] = True
    return RenderEngine(cfg, net, near=NEAR, far=FAR, grid=grid, bbox=BBOX,
                        device="cpu", warmup_families=("full",))


def _view(engine, batcher, theta=30.0):
    def via(rays, near, far):
        fut = batcher.submit(rays, near, far)
        batcher.pump()
        return fut.result(5.0)

    return engine.render_view(pose_spherical(theta, -30.0, 4.0), 6, 8, 8.0,
                              via=via)


def _self_s(view, children):
    """The view's duration less the union of its children's intervals."""
    cover, end = 0.0, view["start_s"]
    for s in sorted(children, key=lambda r: r["start_s"]):
        a = max(s["start_s"], end)
        b = s["start_s"] + s["dur_s"]
        if b > a:
            cover += b - a
            end = b
    return view["dur_s"] - cover


@pytest.mark.parametrize("root", [None, "serve.request"])
def test_view_through_the_batcher_is_one_trace(obs, engine, root):
    """Every span of the view shares its trace; each chain ends at
    ``serve.view`` (under ``serve.request`` when the HTTP handler's span
    is current); the view's direct children cover it but for a sliver."""
    trs = port_trace.configure_tracing(enabled=True)
    batcher = MicroBatcher(engine, start=False)
    if root is None:
        _view(engine, batcher)
    else:
        with trs.span(root):
            _view(engine, batcher)
    spans = _spans(obs)
    assert all(validate_row(r) == [] for r in spans)
    assert len({s["trace_id"] for s in spans}) == 1
    names = [s["name"] for s in spans]
    assert set(names) == VIEW_SPANS | ({root} if root else set())
    assert sorted(names) == sorted(set(names))  # one of each
    by_id = {s["span_id"]: s for s in spans}
    view = next(s for s in spans if s["name"] == "serve.view")
    if root is None:
        assert view["parent_id"] is None
    else:
        assert by_id[view["parent_id"]]["name"] == root
    for s in spans:
        if s["name"] in VIEW_SPANS - {"serve.view"}:
            p = s
            while p["parent_id"] != view["span_id"]:
                p = by_id[p["parent_id"]]
    kids = [s for s in spans if s["parent_id"] == view["span_id"]]
    assert {s["name"] for s in kids} == VIEW_SPANS - {
        "serve.view", "serve.dispatch", "serve.device"}
    assert 0.0 <= _self_s(view, kids) < 0.2 * view["dur_s"]
    queue = next(s for s in spans if s["name"] == "serve.queue")
    assert queue["behind_s"] == 0.0  # the worker was idle
    assert view["n_rays"] == 48


class _BusyEngine:
    """The batcher's engine surface: a render that, the first time, lets
    another request in (``submit_during``) and then takes ``render_s`` on
    the fake clock."""

    def __init__(self, clock, render_s):
        self.clock, self.render_s = clock, render_s
        self.options = SimpleNamespace(
            max_batch_rays=64, max_delay_s=0.0, request_timeout_s=5.0,
            shed_queue_depths=[4, 8, 16, 32])
        self.near, self.far = NEAR, FAR
        self.n_requests = 0
        self.submit_during = None

    def render_flat(self, flat, family):
        if self.submit_during is not None:
            self.submit_during()
            self.submit_during = None
        self.clock.advance(self.render_s)
        return {"rgb_map_f": flat[:, :3]}, {
            "occupancy": flat.shape[0] / 64, "bucket_rays": 64}


def _rays(n):
    return np.tile(np.float32([0.0, 0.0, 4.0, 0.0, 0.0, -1.0]), (n, 1))


@pytest.mark.parametrize("render_s", [0.25, 0.0375])
def test_behind_s_is_the_wait_behind_another_batch(obs, render_s):
    """Under a fake clock: a request submitted to an idle worker reads
    ``behind_s`` 0; one submitted while the worker renders a batch that
    advances the clock by X reads X (the 10 ms the worker then waits
    before its cut are the batch edge's)."""
    clock = FakeClock()
    port_trace.configure_tracing(enabled=True, clock=clock)
    eng = _BusyEngine(clock, render_s)
    batcher = MicroBatcher(eng, start=False, clock=clock)
    first = batcher.submit(_rays(8), NEAR, FAR)
    later = []
    eng.submit_during = lambda: later.append(
        batcher.submit(_rays(8), NEAR, FAR))
    assert batcher.pump() == 1 and len(later) == 1
    clock.advance(0.01)  # the worker idles before the next cut
    assert batcher.pump() == 1
    first.result(1.0)
    later[0].result(1.0)
    queues = [s for s in _spans(obs) if s["name"] == "serve.queue"]
    assert [q["behind_s"] for q in queues] == [0.0,
                                               pytest.approx(render_s)]
    assert queues[1]["dur_s"] == pytest.approx(render_s + 0.01)
    renders = [s for s in _spans(obs) if s["name"] == "serve.render"]
    assert renders[0]["dur_s"] == pytest.approx(render_s)


def test_busy_intervals_are_kept_only_while_a_request_can_wait(obs):
    """A busy interval that ended more than twice the request timeout
    before the newest is forgotten; a wait sums its overlaps."""
    clock = FakeClock()
    port_trace.configure_tracing(enabled=True, clock=clock)
    batcher = MicroBatcher(_BusyEngine(clock, 1.0), start=False,
                           clock=clock)
    for _ in range(4):
        batcher.submit(_rays(4), NEAR, FAR)
        batcher.pump()
        clock.advance(3.0)  # 4 s a batch; the timeout is 5 s
    assert list(batcher._busy) == [(104.0, 105.0), (108.0, 109.0),
                                   (112.0, 113.0)]
    assert batcher._behind_s(104.5, 112.5) == pytest.approx(2.0)


def test_handoff_runs_from_the_result_to_the_client(obs):
    """``serve.handoff`` starts at ``set_result`` on the tracer's clock,
    ends when ``result()`` returns, parents to the submitting request and
    is recorded once; a failed future records none."""
    from nerf_replication_tpu_torch.serve.batcher import ServeFuture

    clock = FakeClock()
    trs = port_trace.configure_tracing(enabled=True, clock=clock)
    with trs.span("serve.view") as view:
        fut = ServeFuture(4, port_trace.current_ctx())
    fut.set_result({"ok": 1})
    clock.advance(0.002)
    assert fut.result(1.0) == {"ok": 1} and fut.result(1.0) == {"ok": 1}
    bad = ServeFuture(4, view.context)
    bad.set_exception(ValueError("x"))
    with pytest.raises(ValueError):
        bad.result(1.0)
    hand = [s for s in _spans(obs) if s["name"] == "serve.handoff"]
    assert len(hand) == 1
    assert hand[0]["parent_id"] == view.context.span_id
    assert (hand[0]["start_s"], hand[0]["dur_s"]) == (100.0,
                                                      pytest.approx(0.002))
    assert hand[0]["stage"] == "handoff"


def test_profiler_event_maps_inside_its_span(obs):
    """A ``record_function`` inside a span, placed on the tracer's clock
    through ``wall_offset_ns`` and the trace's start, lies inside the
    span within 50 µs at both ends."""
    trs = port_trace.configure_tracing(enabled=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with trs.span("probe"):
                with torch.profiler.record_function("probe_op"):
                    time.sleep(0.002)
    offset = port_trace.wall_offset_ns()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [e for e in prof.events() if e.name == "probe_op"]
    spans = [s for s in _spans(obs) if s["name"] == "probe"]
    assert len(ops) == len(spans) == 3
    for e, s in zip(ops, spans):
        start = s["start_s"] * 1e9 + offset
        end = start + s["dur_s"] * 1e9
        assert t0 + e.time_range.start * 1e3 >= start - 50e3
        assert t0 + e.time_range.end * 1e3 <= end + 50e3


def test_wall_offset_takes_the_tightest_pair(monkeypatch):
    """Of the paired readings, the one whose two counter reads lie closest
    gives the offset, against their mean."""
    counter = iter([0, 50, 1000, 1010, 2000, 2030])
    walls = iter([10_000, 11_000, 12_000])
    monkeypatch.setattr(port_trace.time, "perf_counter_ns",
                        lambda: next(counter))
    monkeypatch.setattr(port_trace.time, "time_ns", lambda: next(walls))
    assert port_trace.wall_offset_ns(3) == 11_000 - 1005


def _trainer():
    from nerf_replication_tpu_torch.bench import synthetic_bank
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.loss import make_loss
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    cfg = make_cfg(LEGO, ["network.nerf.W", "32", "network.nerf.D", "3",
                          "network.nerf.skips", "[1]",
                          "network.xyz_encoder.freq", "4",
                          "network.dir_encoder.freq", "2",
                          "task_arg.N_rays", "32", "task_arg.N_samples", "8",
                          "task_arg.N_importance", "8",
                          "task_arg.precrop_iters", "0"])
    net = make_network(cfg)
    tr = Trainer(cfg, net, make_loss(cfg, net))
    return tr, make_train_state(cfg, net, "cpu"), synthetic_bank(
        torch, "cpu", n=1024)


def test_trainer_step_runs_under_one_span_a_step(obs):
    """``step`` emits one ``train.step`` carrying its step count;
    ``multi_step(k)`` emits k, one per step, in order."""
    trs = port_trace.configure_tracing(enabled=True)
    tr, state, bank = _trainer()
    state, _ = tr.step(state, *bank)
    state, _ = tr.multi_step(state, *bank, k_steps=3)
    steps = [s for s in _spans(obs) if s["name"] == "train.step"]
    assert [s["step"] for s in steps] == [0, 1, 2, 3] and state.step == 4
    assert all(validate_row(s) == [] and s["parent_id"] is None
               and s["dur_s"] > 0 for s in steps)
    assert trs.n_spans == 4


def test_disabled_tracer_writes_nothing_and_changes_no_image(obs, engine):
    """With tracing off no span row is written (and the batcher keeps no
    busy interval); the image is bitwise the one rendered with it on."""
    batcher = MicroBatcher(engine, start=False)
    off, _ = _view(engine, batcher, theta=75.0)
    tr, state, bank = _trainer()
    tr.step(state, *bank)
    assert _spans(obs) == [] and len(batcher._busy) == 0
    port_trace.configure_tracing(enabled=True)
    on, _ = _view(engine, MicroBatcher(engine, start=False), theta=75.0)
    assert _spans(obs) and np.array_equal(off, on)
