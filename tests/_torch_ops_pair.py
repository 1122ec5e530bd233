"""Shared set-up of the ops-layer parity tests (tests/test_torch_alerts.py,
test_torch_scale.py, test_torch_scale_loop.py, test_torch_placement.py,
test_torch_fleet_obs.py).

The alert engine, incident correlator, capacity ledger and ``scale/`` are
host Python in both packages, so a test runs ONE scripted scenario against
each side — the JAX package and the port — and asserts that the decoded
outputs are ``==``, floats exact. :class:`Side` is one package's modules;
:func:`isolated` gives a side fresh process-wide state (active emitter,
row taps, metrics registry, tracer, flight recorder): a
:class:`~nerf_replication_tpu_torch.obs.emit.NullEmitter` is active (row
taps fire, nothing reaches disk), and nothing is left behind;
:func:`run_both` runs a scenario on each side in turn.

Rows are compared without their wall-clock stamp ``t`` (``strip``)."""

import importlib
import os
import sys
from contextlib import contextmanager

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

JAX_PKG = "nerf_replication_tpu"
PORT_PKG = "nerf_replication_tpu_torch"


class FakeClock:
    """Injectable clock shared by everything under one scenario."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Side:
    """One package's ops modules, and the rows its scenario emitted."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.obs = importlib.import_module(f"{pkg}.obs")
        self.emit = importlib.import_module(f"{pkg}.obs.emit")
        self.metrics = importlib.import_module(f"{pkg}.obs.metrics")
        self.trace = importlib.import_module(f"{pkg}.obs.trace")
        self.resil = importlib.import_module(f"{pkg}.resil")
        self.flight = importlib.import_module(f"{pkg}.resil.flight")
        self.scale = importlib.import_module(f"{pkg}.scale")
        self.fleet_metrics = importlib.import_module(
            f"{pkg}.scale.fleet_metrics")
        self.rows: list[dict] = []

    def fake_replica(self, rid, load=0, scenes=(), capabilities=None):
        """The replica surface with scripted load / scenes / liveness,
        wearing this side's ``ReplicaState`` and error."""
        return FakeReplica(self, rid, load=load, scenes=scenes,
                           capabilities=capabilities)


class FakeReplica:
    def __init__(self, side, rid, load=0, scenes=(), capabilities=None):
        self.side = side
        self.replica_id = str(rid)
        self.state = side.scale.ReplicaState.READY
        self._load = load
        self.scenes = list(scenes)
        self.beat_ok = True
        self.fail_submit = False  # accepting, but dies mid-submit
        self.submits = []
        self.drains = 0
        self.drain_failures = 0
        if capabilities is not None:
            self.capabilities = tuple(capabilities)

    def accepting(self):
        return self.state == self.side.scale.ReplicaState.READY

    def load(self):
        return self._load

    def heartbeat(self):
        if not self.beat_ok:
            raise RuntimeError("beat down")
        return {"replica": self.replica_id, "state": self.state, "ok": True,
                "load": self._load, "scenes": self.scenes,
                "warm_source": "disk", "total_compiles": 0}

    def submit(self, rays, near, far, scene=None, tenant=None):
        if not self.accepting() or self.fail_submit:
            raise self.side.scale.ReplicaUnavailableError(
                f"{self.replica_id} {self.state}")
        self.submits.append(scene)
        return f"future:{self.replica_id}"

    def drain(self, timeout_s=60.0):
        self.state = self.side.scale.ReplicaState.RETIRED
        self.drains += 1
        return self.drain_failures

    def kill(self):
        self.state = self.side.scale.ReplicaState.DEAD


@contextmanager
def isolated(side: Side):
    """``side`` with a fresh NullEmitter, metrics registry and tracer
    (off), a tap collecting its rows into ``side.rows``, and no flight
    recorder; every one restored afterwards."""
    saved_active = side.emit._active
    saved_taps = list(side.emit._row_taps)
    saved_listeners = list(side.flight._dump_listeners)
    side.emit._active = side.emit.NullEmitter()
    side.emit._row_taps.clear()
    side.metrics.reset_metrics()
    side.trace.configure_tracing(enabled=False)
    side.resil.uninstall_flight_recorder()
    side.rows = []
    side.emit.add_row_tap(side.rows.append)
    try:
        yield side
    finally:
        side.emit._row_taps[:] = saved_taps
        side.flight._dump_listeners[:] = saved_listeners
        side.emit._active = saved_active
        side.metrics.reset_metrics()
        side.trace.configure_tracing(enabled=False)
        side.resil.uninstall_flight_recorder()


def strip(rows, drop=("t",)):
    """Rows without their wall-clock fields (``t`` by default)."""
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def run_both(scenario, *args, **kwargs):
    """``scenario(side, *args, **kwargs)`` on the JAX side, then on the
    port; returns ``(jax_result, port_result)``."""
    out = []
    for pkg in (JAX_PKG, PORT_PKG):
        with isolated(Side(pkg)) as side:
            out.append(scenario(side, *args, **kwargs))
    return tuple(out)
