"""The port's resilience primitives (``nerf_replication_tpu_torch/resil``)
against the JAX package's, which is the oracle: seeded fault plans fire
the same hits, the retry ladder writes the same ``retry`` rows, each
package verifies the other's checksum sidecars, the circuit breaker runs
the same state cycle under an injected clock, the ``nan_loss`` injection
poisons the caller's copy only, and the SIGTERM guard only sets its flag.

Rows compare exactly once the wall-clock fields (``t``, ``wall_s``) are
dropped."""

import json
import os
import signal

import pytest

import nerf_replication_tpu.resil as jres
from nerf_replication_tpu.obs import emit as jax_emit
from nerf_replication_tpu_torch import resil as pres
from nerf_replication_tpu_torch.obs import emit as port_emit
from nerf_replication_tpu_torch.obs.schema import validate_row

_CLOCK_FIELDS = ("t", "wall_s")


def _rows(path, kind=None):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert validate_row(r) == [], r
    return [{k: v for k, v in r.items() if k not in _CLOCK_FIELDS}
            for r in rows if kind is None or r["kind"] == kind]


@pytest.fixture
def telem(tmp_path, monkeypatch):
    """Both packages' process emitters routed at scratch files (restored
    after the test, JAX's NullEmitter included): ``(port, jax)`` paths."""
    paths = (str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl"))
    ems = (port_emit.Emitter(paths[0]), jax_emit.Emitter(paths[1]))
    monkeypatch.setattr(port_emit, "_active", ems[0])
    monkeypatch.setattr(jax_emit, "_active", ems[1])
    yield paths
    for em in ems:
        em.close()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_fault_catalog_equals_jax():
    assert pres.FAULT_POINTS == jres.FAULT_POINTS
    assert pres.FAULT_KINDS == jres.FAULT_KINDS
    for mod in (pres, jres):
        with pytest.raises(ValueError, match="unknown fault point"):
            mod.FaultSpec("not.a.point", "io_error")
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultSpec("artifact.load", "segfault")


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_fires_the_same_hits(seed):
    """The same specs and seed give the same injections, hit for hit, in
    both packages (the probability stream is ``random.Random(seed)``)."""
    specs = [("artifact.load", "io_error", {"times": None, "prob": 0.5}),
             ("checkpoint.save", "kill", {"after": 2, "times": 2}),
             ("serve.dispatch", "latency", {"prob": 0.3, "times": 3}),
             ("train.loss", "nan_loss", {"after": 4})]
    order = ["artifact.load", "serve.dispatch", "checkpoint.save",
             "train.loss"] * 12

    def schedule(mod):
        plan = mod.FaultPlan(seed=seed)
        for point, kind, kw in specs:
            plan.add(point, kind, **kw)
        fired = [getattr(plan.hit(p), "kind", None) for p in order]
        return fired, plan.injected(), plan.counts()

    assert schedule(pres) == schedule(jres)


def test_with_retry_writes_the_same_rows(telem):
    def drive(mod):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        naps = []
        out = mod.with_retry(flaky, point="artifact.load", attempts=3,
                             sleep=naps.append)
        with pytest.raises(OSError, match="gone"):
            mod.with_retry(lambda: (_ for _ in ()).throw(OSError("gone")),
                           point="occupancy.load", attempts=2,
                           sleep=naps.append)
        with pytest.raises(mod.SimulatedKill):
            mod.with_retry(lambda: (_ for _ in ()).throw(
                mod.SimulatedKill("checkpoint.save")),
                point="checkpoint.save", sleep=naps.append)
        return out, naps

    assert drive(pres) == drive(jres) == ("ok", [0.05, 0.1, 0.05])
    port, jax = (_rows(p, "retry") for p in telem)
    assert [r["status"] for r in port] == ["retry", "retry", "ok", "retry",
                                           "exhausted"]
    assert port == jax


@pytest.mark.parametrize("writer,reader", [(pres, jres), (jres, pres)])
def test_each_package_verifies_the_others_sidecars(tmp_path, writer, reader):
    path = str(tmp_path / "artifact.bin")
    with open(path, "wb") as fh:
        fh.write(os.urandom(4096))
    assert reader.verify_checksum(path) is None  # no sidecar yet
    assert writer.write_checksum(path) == reader.file_sha256(path)
    assert reader.verify_checksum(path) is True
    tree = tmp_path / "tree"
    (tree / "sub").mkdir(parents=True)
    (tree / "a.bin").write_bytes(b"abc")
    (tree / "sub" / "b.bin").write_bytes(b"defg")
    writer.write_tree_checksum(str(tree))
    assert reader.verify_tree_checksum(str(tree)) is True
    with open(path, "r+b") as fh:  # tear both
        fh.truncate(1024)
    (tree / "sub" / "b.bin").write_bytes(b"de")
    assert reader.verify_checksum(path) is False
    assert reader.verify_tree_checksum(str(tree)) is False


def test_breaker_cycle_equals_jax(telem):
    """Failures, a cooldown, a failed probe, a second cooldown and a good
    probe: the same states, snapshots, retry-after and breaker rows."""

    def drive(mod):
        clock = FakeClock()
        br = mod.CircuitBreaker(threshold=3, cooldown_s=5.0, clock=clock)
        seen = []

        def look():
            seen.append((br.state, br.allow(), br.degrade_steps(),
                         round(br.retry_after_s(), 9)))

        look()
        for _ in range(3):
            br.record_failure()
            look()
        clock.advance(5.1)
        look()
        br.record_failure()  # the half-open probe fails: open again
        look()
        clock.advance(2.0)
        look()
        clock.advance(3.5)
        look()
        br.record_success()
        look()
        return seen, br.snapshot()

    assert drive(pres) == drive(jres)
    port, jax = (_rows(p, "breaker") for p in telem)
    assert [r["state"] for r in port] == ["open", "half_open", "open",
                                          "half_open", "closed"]
    assert port == jax


def test_breaker_from_cfg_reads_the_resil_block():
    from nerf_replication_tpu_torch.config import make_cfg

    from test_torch_helpers import LEGO

    cfg = make_cfg(LEGO, ["resil.breaker_threshold", "2",
                          "resil.breaker_cooldown_s", "0.5"])
    br = pres.CircuitBreaker.from_cfg(cfg, clock=FakeClock())
    assert (br.threshold, br.cooldown_s) == (2, 0.5)


def test_nan_loss_injection_poisons_the_copy_only(telem):
    """The injected NaN lands in the copy the guard returns; the caller's
    stats (the host copy the loop read) and nothing else change, and the
    fault row is the JAX package's."""

    def drive(mod):
        clean = {"loss": 0.25, "psnr": 12.0}
        plan = mod.FaultPlan().add("train.loss", "nan_loss", after=1)
        with mod.injecting(plan):
            assert mod.check_finite(clean, step=1) == clean
            with pytest.raises(mod.DivergenceError) as err:
                mod.check_finite(clean, step=2)
        return clean, err.value.step, plan.injected()

    assert drive(pres) == drive(jres) == ({"loss": 0.25, "psnr": 12.0}, 2, 1)
    port, jax = (_rows(p, "fault") for p in telem)
    assert [(r["point"], r["fault"], r["injected"]) for r in port] == [
        ("train.loss", "nan_loss", True)]
    assert port == jax


def test_a_nan_in_the_wild_is_reported_as_detected(telem):
    for mod in (pres, jres):
        with pytest.raises(mod.DivergenceError):
            mod.check_finite({"loss": float("nan")}, step=17)
    port, jax = (_rows(p, "fault") for p in telem)
    assert [(r["fault"], r["injected"], r["step"]) for r in port] == [
        ("nan_loss", False, 17)]
    assert port == jax


def test_injecting_uninstalls_across_a_kill(telem):
    plan = pres.FaultPlan().add("serve.flush", "kill")
    with pytest.raises(pres.SimulatedKill):
        with pres.injecting(plan):
            pres.fault_point("serve.flush")
    assert pres.active() is None
    (row,) = _rows(telem[0], "fault")
    assert (row["point"], row["injected"], row["hit"]) == (
        "serve.flush", True, 1)


def test_preemption_guard_only_sets_its_event():
    guard = pres.PreemptionGuard.install()
    assert guard is not None and not guard.triggered
    try:
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered  # the flag; no exception, no exit
        guard.clear()
        assert not guard.triggered
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not guard._on_signal
