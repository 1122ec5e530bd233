"""The port's runtime sanitizers (``analysis/sanitizer.py``) on the CPU.

* ``LockOrderRecorder`` against the JAX package's recorder on the same
  scripted acquisitions: the two-thread inversion (the same cycle, error
  and row), RLock re-entrancy, ``instrument`` names and the ``lock_order``
  row (valid under both schemas).
* ``sanitizer``'s compile budget through the port's ``CompileTracker``
  and through an engine's ``total_compiles``.
* ``syncs``: refused without CUDA (never silently unarmed), and torch's
  sync debug mode restored on every exit (a stand-in ``torch.cuda`` here;
  the card's own check is tests/test_torch_cuda_sanitizer.py).
* The live serving stack of tests/test_torch_scale.py on the port: a
  worker-threaded ``MicroBatcher`` behind an ``InProcessReplica`` and a
  ``Router``, a ``TieredResidencyManager`` over three scenes, their locks
  recorded while client threads send routed requests — nothing compiled
  or captured, the observed lock order acyclic, the row valid.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_helpers import BBOX, FAR, NEAR, box_grid, both_cfgs, nets
from test_torch_scale import STACK_OPTS

from nerf_replication_tpu.analysis import LockOrderError as JaxLockOrderError
from nerf_replication_tpu.analysis import LockOrderRecorder as JaxRecorder
from nerf_replication_tpu_torch.analysis import (
    LockOrderError,
    LockOrderRecorder,
    SanitizerError,
    sanitizer,
)


class _Tap:
    def __init__(self):
        self.rows = []

    def emit(self, kind, **fields):
        self.rows.append({"kind": kind, **fields})


def _threads(*fns):
    for fn in fns:
        th = threading.Thread(target=fn, daemon=True)
        th.start()
        th.join()


def _inversion(rec_cls):
    rec = rec_cls()
    a = rec.wrap("A", threading.Lock())
    b = rec.wrap("B", threading.Lock())

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    _threads(t1, t2)
    try:
        rec.assert_acyclic()
        err = None
    except AssertionError as exc:
        err = exc
    tap = _Tap()
    row = rec.emit(emitter=tap, source="unit")
    return rec, err, row, tap.rows


def test_recorder_inversion_equals_jax():
    port, perr, prow, prows = _inversion(LockOrderRecorder)
    jax, jerr, jrow, jrows = _inversion(JaxRecorder)
    assert isinstance(perr, LockOrderError)
    assert isinstance(jerr, JaxLockOrderError)
    msg = str(perr)
    assert "A -> B" in msg and "B -> A" in msg
    assert msg.split(" observed")[0] == str(jerr).split(" observed")[0]
    assert set(port.edges) == set(jax.edges) == {("A", "B"), ("B", "A")}
    assert prow == jrow and prow["acyclic"] is False and prow["cycle"]
    assert prows == jrows and prows[0]["kind"] == "lock_order"
    assert port.n_acquires == jax.n_acquires == 4


def test_recorder_rlock_reentrancy_equals_jax():
    out = []
    for rec_cls in (LockOrderRecorder, JaxRecorder):
        rec = rec_cls()
        r = rec.wrap("R", threading.RLock())
        other = rec.wrap("O", threading.Lock())
        with r:
            with r:  # re-entrant: balanced for release, no self-edge
                with other:
                    pass
        rec.assert_acyclic()
        out.append((dict.fromkeys(rec.edges), rec.n_acquires,
                    rec.emit(emitter=_Tap(), source="unit")))
    assert out[0] == out[1]
    assert set(out[0][0]) == {("R", "O")}


def test_instrument_names_and_row_valid():
    from nerf_replication_tpu.obs.schema import validate_row as jax_valid
    from nerf_replication_tpu_torch.obs.schema import (
        SCHEMA_VERSION,
        validate_row,
    )

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition()

    rows = []
    for rec_cls in (LockOrderRecorder, JaxRecorder):
        box = Box()
        rec = rec_cls()
        rec.instrument(box, "_lock", "_cond")
        rec.instrument(box, "_lock")  # already wrapped: left as it is
        with box._lock:
            with box._cond:
                box._cond.notify_all()  # the Condition API forwards
        rec.assert_acyclic()
        tap = _Tap()
        rows.append(rec.emit(emitter=tap, source="unit"))
        full = {"v": SCHEMA_VERSION, "t": 0.0, **tap.rows[0]}
        assert validate_row(full) == [] and jax_valid(full) == [], full
    assert rows[0] == rows[1]
    assert set(rows[0]["locks"]) == {"Box._lock", "Box._cond"}
    assert rows[0]["n_edges"] == 1 and rows[0]["acyclic"] is True


def test_compile_budget_through_the_port_tracker():
    from nerf_replication_tpu_torch.obs import CompileTracker

    tracker = CompileTracker()
    tracker.note_compile("warm", 0.1, phase="capture")  # outside
    with sanitizer(tracker, syncs=None) as probe:
        pass
    assert probe.compiles == 0 and probe.compile_names == {}
    with sanitizer(tracker, syncs=None, allow_compiles=1) as probe:
        tracker.note_compile("route_4096_full", 0.2, phase="capture")
    assert probe.compiles == 1
    assert probe.compile_names == {"route_4096_full": 1}
    with pytest.raises(SanitizerError, match="train_step"):
        with sanitizer(tracker, syncs=None, name="replays"):
            tracker.note_compile("train_step", 0.3, phase="capture")


def test_compile_budget_through_an_engine_count():
    """Anything with ``total_compiles()`` is a tracker (the engine has no
    per-name counts)."""
    class Engine:
        n = 0

        def total_compiles(self):
            return self.n

    engine = Engine()
    with sanitizer(engine, syncs=None) as probe:
        pass
    assert probe.compiles == 0
    with pytest.raises(SanitizerError, match="1 compile"):
        with sanitizer(engine, syncs=None):
            engine.n += 1


def test_syncs_refused_without_cuda():
    assert not torch.cuda.is_available()
    for mode in ("error", "warn"):
        with pytest.raises(SanitizerError, match="needs CUDA"):
            with sanitizer(None, syncs=mode):
                pass
    with pytest.raises(SanitizerError, match="needs CUDA"):
        with sanitizer(None):  # the default arms the guard
            pass
    with pytest.raises(SanitizerError, match="not one of"):
        with sanitizer(None, syncs="loud"):
            pass


def test_sync_mode_restored_on_every_exit(monkeypatch):
    """With a stand-in for torch's switch: the region runs at the asked
    mode and the previous mode comes back after a clean exit, a raise
    inside the region and a compile-budget failure."""
    state = {"mode": 0, "seen": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])

    def set_mode(mode):
        state["mode"] = mode
        state["seen"].append(mode)

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    with sanitizer(None, syncs="warn"):
        assert state["mode"] == "warn"
    with pytest.raises(RuntimeError, match="synchronizing"):
        with sanitizer(None):
            assert state["mode"] == "error"
            raise RuntimeError("called a synchronizing CUDA operation")
    from nerf_replication_tpu_torch.obs import CompileTracker

    tracker = CompileTracker()
    with pytest.raises(SanitizerError):
        with sanitizer(tracker):
            tracker.note_compile("late", 0.1)
    assert state["seen"] == ["warn", 0, "error", 0, "error", 0]


def test_live_stack_zero_compiles_and_acyclic_locks():
    """The port's counterpart of JAX's live-stack gate on the CPU: a
    worker-threaded batcher (real clock, real thread), a tiered residency
    ladder and a router in one process, their locks recorded while four
    client threads send routed requests — zero compiles, acyclic order,
    three locks in a valid row, every reply the direct render's."""
    from nerf_replication_tpu_torch.fleet import (
        SceneData,
        SceneRecord,
        SceneRegistry,
        TieredResidencyManager,
    )
    from nerf_replication_tpu_torch.obs.schema import validate_row
    from nerf_replication_tpu_torch.scale import InProcessReplica, Router
    from nerf_replication_tpu_torch.serve import MicroBatcher, RenderEngine
    from test_torch_helpers import sample_rays

    _, pcfg = both_cfgs(STACK_OPTS)
    _, _, pnet = nets()
    engine = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=box_grid(16),
                          bbox=BBOX, device="cpu")
    batcher = MicroBatcher(engine)
    replica = InProcessReplica("r0", engine, batcher)
    router = Router(heartbeat_timeout_s=30.0)
    router.register(replica)
    router.sweep()

    def loader(record):
        return SceneData(scene_id=record.scene_id,
                         params={"w": torch.full((256,), 1.0)})

    registry = SceneRegistry(SceneRecord(scene_id=s) for s in ("a", "b", "c"))
    mgr = TieredResidencyManager(
        registry, loader, budget_bytes=3000, staging_budget_bytes=8192,
        verify_checksums=False)
    recorder = LockOrderRecorder()
    recorder.instrument(batcher, "_cond")
    recorder.instrument(mgr, "_cond")
    recorder.instrument(router, "_lock")

    sizes = [37, 48, 64, 5, 60, 17, 33, 64]
    replies = {}
    try:
        router.submit(sample_rays(64), NEAR, FAR).result(timeout=60.0)

        def client(k):
            for i in range(k, len(sizes), 4):
                fut = router.submit(sample_rays(sizes[i], seed=i), NEAR, FAR)
                replies[i] = fut.result(timeout=60.0)

        with sanitizer(engine, syncs=None) as probe:
            clients = [threading.Thread(target=client, args=(k,),
                                        daemon=True) for k in range(4)]
            for th in clients:
                th.start()
            mgr.prefetch("b")
            for i in range(4):
                data = mgr.acquire("a" if i % 2 else "c")
                mgr.release(data.scene_id)
            mgr.sweep()
            router.sweep()
            for th in clients:
                th.join(timeout=120.0)
        assert probe.compiles == 0 and engine.total_compiles() == 0
    finally:
        batcher.close(drain=False)

    assert sorted(replies) == list(range(len(sizes)))
    for i, n in enumerate(sizes):
        direct = engine.render_request(sample_rays(n, seed=i), NEAR, FAR,
                                       emit=False)
        np.testing.assert_allclose(replies[i]["rgb_map_f"],
                                   direct["rgb_map_f"], rtol=0, atol=1e-6)
    recorder.assert_acyclic()
    tap = _Tap()
    row = recorder.emit(emitter=tap, source="tier1")
    assert row["acyclic"] is True and row["n_locks"] >= 3
    assert {"MicroBatcher._cond", "TieredResidencyManager._cond",
            "Router._lock"} <= set(row["locks"])
    assert validate_row({"v": 1, "t": 0.0, **tap.rows[0]}) == [], row
