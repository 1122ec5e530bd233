"""Port parity of the fleet's control plane (``fleet/store.py``,
``fleet/ladder.py``, ``fleet/qos.py``, ``fleet/publish.py``), the
counterparts of ``tests/test_control_plane.py``, on the CPU.

* The sharded store: a round trip of ``write_sharded`` with lazy page-in,
  write-through of ``register`` — the port's store and JAX's on the same
  registry agree on every record and counter.
* The staging ladder: one scripted event sequence (demote and re-promote,
  the staging budget's own LRU, TTL sweeps, manual evictions) drives the
  JAX and the port ``TieredResidencyManager``: outcomes, both tiers after
  every event, ``stats()`` and the ``scene_load`` / ``scene_evict`` rows
  equal. Through the engine, a demoted scene re-promotes from staging (no
  disk load) and renders bitwise what it rendered before.
* QoS: one admission script (a fake clock) through both
  ``QosController`` s — the same levels, denials, ``Retry-After`` and rows;
  the weighted-fair pop of both batchers over one submission script cuts
  the same batches; the tenant breaker opens for its tenant alone.
* Publish: a hot swap under traffic renders version N+1 bitwise as a
  dedicated engine does, with no route build; a torn N+1 is contained
  (N keeps serving); the drain parks new acquires and a drain timeout
  refunds; a concurrent publish is refused.
"""

import threading
import time

import numpy as np
import pytest
import torch

from test_torch_fleet import (
    ROUTES,
    SERVE,
    _engine,
    _grid,
    _rays,
    _scene_tensors,
    _torn_dir,
)
from test_torch_helpers import BBOX, FAR, LEGO, NEAR, nets

from nerf_replication_tpu_torch import fleet as pf
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.resil import BreakerOpenError
from nerf_replication_tpu_torch.serve import MicroBatcher

CFG = SERVE + ROUTES["full"]


@pytest.fixture(scope="module")
def weights():
    return nets()


def _registry(mod, n):
    return mod.SceneRegistry(mod.SceneRecord(f"s{i:03d}",
                                             checkpoint=f"/c/s{i:03d}")
                             for i in range(n))


# -- sharded store ------------------------------------------------------------


def test_store_round_trip_and_lazy_page_in_match_jax(tmp_path):
    import nerf_replication_tpu.fleet as jf

    out = {}
    for name, mod in (("jax", jf), ("port", pf)):
        root = str(tmp_path / name)
        mod.write_sharded(_registry(mod, 10), root, shard_size=4)
        store = mod.SceneStore(root, max_loaded_shards=2)
        seen = [store.get(f"s{i:03d}").checkpoint for i in (0, 5, 9, 1)]
        with pytest.raises(mod.UnknownSceneError):
            store.get("nope")
        out[name] = (seen, store.ids(), len(store), store.stats())
    assert out["port"] == out["jax"]
    assert out["port"][3]["page_ins"] == 4
    assert out["port"][3]["shard_evictions"] == 2


def test_store_register_writes_through_its_shard(tmp_path):
    root = str(tmp_path / "store")
    pf.write_sharded(_registry(pf, 6), root, shard_size=3)
    store = pf.SceneStore(root)
    store.register(pf.SceneRecord("s004", checkpoint="/c/v2", epoch=2))
    store.register(pf.SceneRecord("new", checkpoint="/c/new"))
    again = pf.SceneStore(root)
    assert again.get("s004").checkpoint == "/c/v2"
    assert "new" not in again and store.get("new").checkpoint == "/c/new"
    assert len(store) == 7


# -- the staging ladder -------------------------------------------------------

LADDER = {
    "demote": ({"budget": 2.0, "staging": 4.0},
               [("lease", "a"), ("lease", "b"), ("lease", "c"),
                ("lease", "a"), ("lease", "d"), ("lease", "b")]),
    "staging_budget": ({"budget": 1.0, "staging": 2.0},
                       [("lease", "a"), ("lease", "b"), ("lease", "c"),
                        ("lease", "a"), ("lease", "b")]),
    "ttl": ({"budget": 4.0, "staging": 4.0, "resident_ttl_s": 20.0,
             "staging_ttl_s": 30.0},
            [("lease", "a"), ("lease", "b"), ("sweep", 5.0),
             ("sweep", 25.0), ("lease", "a"), ("sweep", 1000.0),
             ("lease", "b")]),
    "manual": ({"budget": 4.0, "staging": 4.0},
               [("acquire", "a"), ("evict", "a"), ("release", "a"),
                ("evict", "a"), ("lease", "a"), ("drop", "a"),
                ("lease", "a")]),
}


def _run_ladder(pkg, as_array, name, monkeypatch):
    import importlib

    residency = importlib.import_module(pkg + ".residency")
    ladder = importlib.import_module(pkg + ".ladder")
    registry = importlib.import_module(pkg + ".registry")
    kw, events = LADDER[name]
    rows = []

    class Rec:
        def emit(self, kind, **fields):
            fields.pop("load_s", None)
            rows.append((kind, fields))

    monkeypatch.setattr(residency, "get_emitter", lambda: Rec())
    datas = {s: residency.SceneData(s, params={"w": as_array(i)})
             for i, s in enumerate("abcd")}
    t0 = time.monotonic()
    mgr = ladder.TieredResidencyManager(
        registry.SceneRegistry(registry.SceneRecord(s) for s in "abcd"),
        lambda rec: datas[rec.scene_id],
        budget_bytes=int(4000 * kw["budget"]),
        staging_budget_bytes=int(4000 * kw["staging"]),
        staging_ttl_s=kw.get("staging_ttl_s", 0.0),
        resident_ttl_s=kw.get("resident_ttl_s", 0.0),
        verify_checksums=False)
    trail = []
    for op, arg in events:
        if op == "lease":
            with mgr.lease(arg) as d:
                out = float(d.params["w"][0])
        elif op == "acquire":
            out = mgr.acquire(arg).scene_id
        elif op == "release":
            out = mgr.release(arg)
        elif op == "evict":
            out = mgr.evict(arg)
        elif op == "drop":
            out = mgr.evict(arg, drop_staged=True)
        else:
            out = mgr.sweep(now=t0 + arg)
        trail.append((op, arg, out, mgr.resident_ids(), mgr.staged_ids()))
    stats = mgr.stats()
    stats.pop("pose_caches")
    return trail, stats, rows


@pytest.mark.parametrize("script", list(LADDER))
def test_ladder_decisions_and_rows_match_jax(script, monkeypatch):
    jax_side = _run_ladder("nerf_replication_tpu.fleet",
                           lambda i: np.full((1000,), i, np.float32),
                           script, monkeypatch)
    port_side = _run_ladder("nerf_replication_tpu_torch.fleet",
                            lambda i: torch.full((1000,), float(i)),
                            script, monkeypatch)
    assert port_side == jax_side
    assert port_side[1]["loads"] == (port_side[1]["disk_loads"]
                                     + port_side[1]["repromotions"])


def test_demote_then_repromote_renders_bitwise_and_skips_disk(weights):
    _, _, pnet = weights
    engine = _engine(make_cfg(LEGO, CFG), pnet)
    datas = {s: pf.SceneData(s, _scene_tensors(pnet, i),
                             torch.from_numpy(_grid(i)),
                             torch.from_numpy(BBOX), NEAR, FAR)
             for i, s in enumerate("abc")}
    one = sum(v.numel() * 4 for v in datas["a"].params.values()) + 4096 + 24
    disk = {"n": 0}

    def loader(rec):
        disk["n"] += 1
        return datas[rec.scene_id]

    mgr = pf.TieredResidencyManager(
        pf.SceneRegistry(pf.SceneRecord(s) for s in "abc"), loader,
        budget_bytes=int(one * 1.5), staging_budget_bytes=int(one * 4),
        verify_checksums=False)
    engine.attach_fleet(mgr)
    rays = _rays(40)
    first = engine.render_request(rays, NEAR, FAR, scene="a")
    engine.render_request(rays, NEAR, FAR, scene="b")  # demotes a
    assert mgr.resident_ids() == ["b"] and "a" in mgr.staged_ids()
    again = engine.render_request(rays, NEAR, FAR, scene="a")
    assert disk["n"] == 2 and mgr.stats()["repromotions"] == 1
    for k in first:
        if k != "tier":
            np.testing.assert_array_equal(first[k], again[k], err_msg=k)


# -- QoS ----------------------------------------------------------------------


def _qos_script(mod, monkeypatch):
    import importlib

    qos_mod = importlib.import_module(mod + ".qos")
    rows = []

    class Rec:
        def emit(self, kind, **fields):
            rows.append((kind, fields))

    monkeypatch.setattr(qos_mod, "get_emitter", lambda: Rec())
    t = [0.0]
    qos = qos_mod.QosController(
        [qos_mod.TenantPolicy("t", rate=10.0, burst=2.0, weight=3.0)],
        clock=lambda: t[0], dump_after_denies=100)
    out = []
    for dt, tenant in ((0, "t"), (0, "t"), (0, "t"), (0.05, "t"),
                       (0.06, "t"), (0, None), (0.3, "t"), (0, "x")):
        t[0] += dt
        try:
            out.append(("ok", round(qos.admit(tenant), 9)))
        except qos_mod.TenantQuotaError as err:
            out.append(("deny", err.tenant, round(err.retry_after_s, 9),
                        str(err)))
    return out, qos.stats(), rows, qos.weight("t"), qos.weight(None)


def test_token_bucket_admission_matches_jax(monkeypatch):
    port_side = _qos_script("nerf_replication_tpu_torch.fleet", monkeypatch)
    jax_side = _qos_script("nerf_replication_tpu.fleet", monkeypatch)
    assert port_side == jax_side
    assert [o[0] for o in port_side[0]].count("deny") == 2


class _FakeEngine:
    """What a batcher reads of an engine; records each batch's requests."""

    def __init__(self, options):
        self.options = options
        self.near, self.far = NEAR, FAR
        self.n_requests = 0
        self.batches = []

    def _is_default_scene(self, s):
        return s is None

    def require_scene(self, s):
        pass

    def prefetch_scene(self, s):
        return False

    def render_flat(self, rays, family="full", scene=None):
        self.batches.append(rays[:, 0].tolist())
        n = rays.shape[0]
        return ({"rgb_map_f": np.zeros((n, 3), np.float32)},
                {"occupancy": 1.0, "bucket_rays": n, "buckets": [n]})


def test_weighted_fair_pop_matches_jax():
    """One submission script (a hog and a weighted mouse) through both
    batchers: the same batches, in the same order."""
    from nerf_replication_tpu.fleet.qos import QosController as JQos
    from nerf_replication_tpu.fleet.qos import TenantPolicy as JPol
    from nerf_replication_tpu.serve import MicroBatcher as JBatcher
    from nerf_replication_tpu.serve.engine import ServeOptions as JOpt

    from nerf_replication_tpu_torch.serve.engine import ServeOptions

    cuts = {}
    for name, batcher_cls, qos_cls, pol, opt in (
            ("jax", JBatcher, JQos, JPol, JOpt),
            ("port", MicroBatcher, pf.QosController, pf.TenantPolicy,
             ServeOptions)):
        eng = _FakeEngine(opt(max_batch_rays=256,
                              shed_queue_depths=(50, 60, 70, 80)))
        qos = qos_cls([pol("hog", weight=1.0, rate=1e6, burst=1e6),
                       pol("mouse", weight=4.0, rate=1e6, burst=1e6)])
        b = batcher_cls(eng, start=False, qos=qos)
        tag = iter(range(100))

        def sub(tenant, n=64):
            rays = np.zeros((n, 6), np.float32)
            rays[:, 0] = next(tag)
            return b.submit(rays, NEAR, FAR, tenant=tenant)

        for _ in range(4):
            sub("hog")
        b.pump()
        for t in ("mouse", "hog", "hog", "mouse", "hog", "hog", "hog"):
            sub(t, 32 if t == "mouse" else 64)
        while b.queue_depth():
            b.pump()
        cuts[name] = [sorted(set(x)) for x in eng.batches]
    assert cuts["port"] == cuts["jax"]
    assert len(cuts["port"]) >= 3


def test_quota_denial_and_the_tenant_breaker(weights, monkeypatch):
    """A denied submission never queues and opens no breaker; failing
    single-tenant batches open that tenant's breaker alone."""
    _, _, pnet = weights
    engine = _engine(make_cfg(LEGO, CFG), pnet)
    qos = pf.QosController([pf.TenantPolicy("hog", rate=0.001, burst=1.0)],
                           breaker_threshold=2, breaker_cooldown_s=60.0)
    batcher = MicroBatcher(engine, start=False, qos=qos)
    ok = batcher.submit(_rays(32), NEAR, FAR, tenant="hog")
    with pytest.raises(pf.TenantQuotaError) as exc:
        batcher.submit(_rays(32), NEAR, FAR, tenant="hog")
    assert exc.value.retry_after_s > 0 and batcher.queue_depth() == 1
    assert batcher.pump() == 1 and ok.result(5.0)["tier"] == "full"
    assert qos.breaker("hog").snapshot()["state"] == "closed"

    real = engine.render_flat
    boom = {"on": True}

    def flaky(*args, **kw):
        if boom["on"]:
            raise RuntimeError("tenant-attributable dispatch failure")
        return real(*args, **kw)

    monkeypatch.setattr(engine, "render_flat", flaky)
    for _ in range(2):
        f = batcher.submit(_rays(32), NEAR, FAR, tenant="bad")
        batcher.pump()
        with pytest.raises(RuntimeError):
            f.result(5.0)
    assert qos.breaker("bad").snapshot()["state"] == "open"
    with pytest.raises(BreakerOpenError):
        batcher.submit(_rays(32), NEAR, FAR, tenant="bad")
    assert batcher.breaker.snapshot()["state"] == "closed"
    boom["on"] = False
    f = batcher.submit(_rays(32), NEAR, FAR, tenant="good")
    batcher.pump()
    assert f.result(5.0)["tier"] == "full"


# -- publish ------------------------------------------------------------------


def _versioned(pnet, **kw):
    """Scene ``a`` whose weights are the record's ``epoch``-th version."""
    def loader(rec):
        return pf.SceneData(rec.scene_id,
                            _scene_tensors(pnet, int(rec.epoch or 1)),
                            torch.from_numpy(_grid(1)),
                            torch.from_numpy(BBOX), NEAR, FAR)

    return pf.TieredResidencyManager(
        pf.SceneRegistry([pf.SceneRecord("a", epoch=1)]), loader,
        budget_bytes=1 << 24, staging_budget_bytes=1 << 24,
        **{"verify_checksums": False, **kw})


def test_publish_under_traffic_renders_n_plus_1_with_no_route_build(
        weights):
    from nerf_replication_tpu_torch.models import make_network

    _, _, pnet = weights
    cfg = make_cfg(LEGO, CFG)
    engine = _engine(cfg, pnet)
    mgr = _versioned(pnet)
    engine.attach_fleet(mgr)
    pub = pf.ScenePublisher(mgr, drain_timeout_s=30.0)
    builds = engine.stats()["route_builds"]
    batcher = MicroBatcher(engine)
    rays = _rays(40)
    stop = threading.Event()

    def traffic():
        while not stop.is_set():
            batcher.submit(rays, NEAR, FAR, scene="a").result(30.0)

    before = batcher.submit(rays, NEAR, FAR, scene="a").result(30.0)
    th = threading.Thread(target=traffic)
    th.start()
    try:
        row = pub.publish(pf.SceneRecord("a", epoch=2))
    finally:
        stop.set()
        th.join(timeout=30.0)
    after = batcher.submit(rays, NEAR, FAR, scene="a").result(30.0)
    batcher.close()
    assert row["status"] == "ok" and pub.version("a") == 2
    assert engine.stats()["route_builds"] == builds
    for version, out in ((1, before), (2, after)):
        net = make_network(cfg)
        net.load_state_dict(_scene_tensors(pnet, version))
        ref = _engine(cfg, net, _grid(1)).render_request(rays, NEAR, FAR)
        np.testing.assert_array_equal(out["rgb_map_f"], ref["rgb_map_f"])


def test_torn_next_version_is_contained(weights, tmp_path):
    _, _, pnet = weights
    mgr = _versioned(pnet, verify_checksums=True)
    pub = pf.ScenePublisher(mgr)
    with mgr.lease("a"):
        pass
    with pytest.raises(pf.SceneLoadError, match="torn"):
        pub.publish(pf.SceneRecord("a", checkpoint=_torn_dir(tmp_path),
                                   epoch=2))
    assert pub.version("a") == 1 and pub.stats()["failed_publishes"] == 1
    with mgr.lease("a") as data:
        assert torch.equal(data.params["fine.rgb_linear.bias"],
                           _scene_tensors(pnet, 1)["fine.rgb_linear.bias"])
    assert mgr.registry.get("a").epoch == 1


def test_publish_drain_parks_acquires_and_a_timeout_refunds(weights):
    _, _, pnet = weights
    mgr = _versioned(pnet)
    pub = pf.ScenePublisher(mgr, drain_timeout_s=30.0)
    mgr.acquire("a")  # the in-flight batch's pin
    with pytest.raises(pf.ScenePublishError, match="drain"):
        pub.publish(pf.SceneRecord("a", epoch=2), drain_timeout_s=0.2)
    assert pub.version("a") == 1
    done, parked = {}, {}
    th = threading.Thread(target=lambda: done.setdefault(
        "row", pub.publish(pf.SceneRecord("a", epoch=3))))
    th.start()
    deadline = time.monotonic() + 5.0
    while "a" not in mgr._publishing and time.monotonic() < deadline:
        time.sleep(0.005)

    def late():
        with mgr.lease("a") as data:
            parked["bias"] = data.params["fine.rgb_linear.bias"].clone()

    th2 = threading.Thread(target=late)
    th2.start()
    time.sleep(0.2)
    assert th.is_alive() and "bias" not in parked
    mgr.release("a")
    th.join(timeout=10.0)
    th2.join(timeout=10.0)
    assert done["row"]["status"] == "ok" and done["row"]["drain_ms"] > 100.0
    assert torch.equal(parked["bias"],
                       _scene_tensors(pnet, 3)["fine.rgb_linear.bias"])
    assert pub.version("a") == 2


def test_concurrent_publish_is_refused(weights):
    _, _, pnet = weights
    mgr = _versioned(pnet)
    pub = pf.ScenePublisher(mgr, drain_timeout_s=10.0)
    mgr.acquire("a")
    th = threading.Thread(
        target=lambda: pub.publish(pf.SceneRecord("a", epoch=2)))
    th.start()
    deadline = time.monotonic() + 5.0
    while "a" not in mgr._publishing and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(pf.ScenePublishError, match="in flight"):
        pub.publish(pf.SceneRecord("a", epoch=9))
    mgr.release("a")
    th.join(timeout=10.0)
    assert pub.version("a") == 2
