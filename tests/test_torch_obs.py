"""The port's telemetry layer (``nerf_replication_tpu_torch/obs``) against
the JAX package's: the row schema, the config hash, a tiny port fit's
``telemetry.jsonl`` read by JAX's ``validate_row`` and by
``scripts/tlm_report.py``, the emitter, compile rows of a kernel build,
memory rows, and the profiler window on the CPU.

Host values compare exactly; timestamps, wall times and run ids are not
compared."""

import ctypes
import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_helpers import LEGO, ROOT

from nerf_replication_tpu.config import make_cfg as jax_make_cfg
from nerf_replication_tpu.obs import schema as jax_schema
from nerf_replication_tpu.obs.emit import config_hash as jax_config_hash
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene
from nerf_replication_tpu_torch.obs import emit as emit_mod
from nerf_replication_tpu_torch.obs import schema

LEGO_HASH = os.path.join(ROOT, "configs", "nerf", "lego_hash.yaml")


def _opts(root, out, extra=()):
    return [
        "scene", "procedural",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "task_arg.N_rays", "64", "task_arg.N_samples", "8",
        "task_arg.N_importance", "8", "task_arg.chunk_size", "256",
        "task_arg.precrop_iters", "0",
        "network.nerf.W", "32", "network.nerf.D", "2",
        "network.nerf.skips", "[1]", "network.xyz_encoder.freq", "4",
        "network.dir_encoder.freq", "2", "ep_iter", "5", "train.epoch", "2",
        "log_interval", "1", "eval_ep", "1", "save_ep", "1",
        "save_latest_ep", "1",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        *extra,
    ]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_obs"))
    generate_scene(root, "procedural", H=16, W=16, n_train=3, n_test=1)
    return root


@pytest.fixture(scope="module")
def port_run(scene, tmp_path_factory):
    """One tiny CPU fit (2 epochs of 5 steps, validating every epoch):
    ``(cfg, telemetry rows)``."""
    from nerf_replication_tpu_torch.train.trainer import fit

    out = str(tmp_path_factory.mktemp("obs_run"))
    cfg = make_cfg(LEGO, _opts(scene, out))
    fit(cfg, device="cpu", log=lambda s: None)
    return cfg, _rows(os.path.join(cfg.record_dir, "telemetry.jsonl"))


# optional fields the port's rows add to JAX's: the torch version, and the
# span attributes of spans the JAX package has not (serve.queue's wait
# behind other batches, train.step's step count)
PORT_ONLY = {"run_meta": {"torch_version"}, "span": {"behind_s", "step"}}


def test_row_kinds_equal_jax_except_torch_version():
    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION
    assert set(schema.ROW_KINDS) == set(jax_schema.ROW_KINDS)
    for kind, (req, opt) in schema.ROW_KINDS.items():
        jreq, jopt = jax_schema.ROW_KINDS[kind]
        assert req == jreq, kind
        extra = PORT_ONLY.get(kind, set())
        assert extra <= set(opt) and not extra & set(jopt), kind
        opt = {k: v for k, v in opt.items() if k not in extra}
        assert opt == jopt, kind


def test_fit_rows_validate_under_both_schemas(port_run):
    """Every row of a port fit passes the port's validate_row and, once
    run_meta's torch_version is dropped, JAX's; the run has the JAX fit's
    kinds, and step rows carry the dispatch/block split."""
    _, rows = port_run
    for row in rows:
        assert schema.validate_row(row) == [], row
        jrow = {k: v for k, v in row.items() if k != "torch_version"}
        assert jax_schema.validate_row(jrow) == [], row
    kinds = [r["kind"] for r in rows]
    assert kinds[0] == "run_meta"
    for kind in ("step", "epoch", "memory", "heartbeat", "eval", "sample"):
        assert kind in kinds, kind
    meta = rows[0]
    assert meta["component"] == "train" and meta["platform"] in ("cpu", "gpu")
    assert meta["torch_version"] == torch.__version__
    steps = [r for r in rows if r["kind"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, 11))
    assert all(r["dispatch_s"] >= 0 and r["block_s"] >= 0 for r in steps)
    assert [r["epoch"] for r in rows if r["kind"] == "epoch"] == [0, 1]
    assert [r["prefix"] for r in rows if r["kind"] == "eval"] == ["val"] * 2


@pytest.mark.parametrize("config,extra", [
    (LEGO, []),
    (LEGO, ["network.nerf.W", "32", "task_arg.N_rays", "64"]),
    (LEGO_HASH, ["task_arg.ngp_training", "true"]),
])
def test_config_hash_equals_jax(config, extra):
    assert emit_mod.config_hash(make_cfg(config, extra)) == \
        jax_config_hash(jax_make_cfg(config, extra))


def test_tlm_report_summarises_a_port_run(port_run):
    cfg, _ = port_run
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "tlm_report.py"),
         str(cfg.record_dir), "--json"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout)
    text = json.dumps(summary)
    assert "step" in text and summary, summary


def test_emitter_roundtrip_and_chief_guard(tmp_path):
    """The chief writes stamped rows that read back; a non-chief writes
    nothing; taps see both, and a raising tap is dropped."""
    seen, raised = [], []

    def bad(row):
        raised.append(row)
        raise RuntimeError("tap fault")

    emit_mod.add_row_tap(seen.append)
    emit_mod.add_row_tap(bad)
    try:
        path = str(tmp_path / "t" / "telemetry.jsonl")
        with emit_mod.Emitter(path, chief=True) as em:
            em.emit("heartbeat", wall_s=1.5, step=3)
        other = str(tmp_path / "other.jsonl")
        emit_mod.Emitter(other, chief=False).emit("heartbeat", wall_s=2.0)
        emit_mod.NullEmitter().emit("heartbeat", wall_s=3.0)
    finally:
        emit_mod.remove_row_tap(seen.append)
        emit_mod.remove_row_tap(bad)
    (row,) = _rows(path)
    assert {k: row[k] for k in ("v", "kind", "wall_s", "step")} == {
        "v": schema.SCHEMA_VERSION, "kind": "heartbeat", "wall_s": 1.5,
        "step": 3}
    assert not os.path.exists(other)
    assert [r["wall_s"] for r in seen] == [1.5, 3.0]
    assert len(raised) == 1  # dropped after its first fault
    assert emit_mod.is_chief()


_FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"; src="$a"
done
exec gcc -shared -fPIC -x c -o "$out" "$src"
"""

_FAKE_SOURCE = """
int nrt_fake(int x) { return x + 1; }
const char *nrt_error_string(int e) { return "fake"; }
"""


@pytest.fixture
def fake_kernels(tmp_path, monkeypatch):
    """``ops.kernels`` pointed at one C source built by a stand-in nvcc
    (gcc): the build/load/checksum path of the kernel libraries on the
    CPU. Yields ``(kernels, telemetry path)``."""
    from nerf_replication_tpu_torch.obs.hooks import CompileTracker
    from nerf_replication_tpu_torch.ops import kernels

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text(_FAKE_SOURCE)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "HEADERS", ())
    monkeypatch.setattr(kernels, "SOURCES", {"fake": "fake.cu"})
    monkeypatch.setattr(kernels, "ARGTYPES",
                        {"fake": {"nrt_fake": [ctypes.c_int]}})
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "builds", 0)
    monkeypatch.setattr(kernels, "compiles", CompileTracker())
    telem = str(tmp_path / "telemetry.jsonl")
    em = emit_mod.Emitter(telem, chief=True)
    monkeypatch.setattr(emit_mod, "_active", em)
    yield kernels, telem
    em.close()


def test_kernel_build_and_load_are_compile_rows(fake_kernels):
    """A forced build is one ``build`` and one ``load`` compile row with
    their wall times, and the library gets its checksum sidecar; a second
    process's view (a fresh library table) loads it without a build."""
    kernels, telem = fake_kernels
    assert kernels.load("fake").nrt_fake(4) == 5
    assert kernels.builds == 1
    assert kernels.compiles.counts() == {"kernel_fake": 2}
    kernels._libs.clear()
    kernels.load("fake")
    assert kernels.builds == 1
    rows = [r for r in _rows(telem) if r["kind"] == "compile"]
    assert [(r["name"], r["phase"], r["n_compiles"]) for r in rows] == [
        ("kernel_fake", "build", 1), ("kernel_fake", "load", 2),
        ("kernel_fake", "load", 3)]
    assert all(r["wall_s"] >= 0 for r in rows)
    lib = kernels._lib_path("fake")
    assert os.path.exists(lib + ".sha256")


def test_torn_kernel_library_is_rebuilt(fake_kernels):
    """A library whose bytes no longer match its sidecar is reported
    (``artifact.load`` checksum fault) and rebuilt, never loaded."""
    kernels, telem = fake_kernels
    kernels.build_all()  # built, not loaded: the tear comes from elsewhere
    lib = kernels._lib_path("fake")
    with open(lib, "r+b") as fh:
        fh.truncate(os.path.getsize(lib) // 2)
    assert kernels.load("fake").nrt_fake(1) == 2
    assert kernels.builds == 2
    (fault,) = [r for r in _rows(telem) if r["kind"] == "fault"]
    assert (fault["point"], fault["fault"], fault["injected"]) == (
        "artifact.load", "checksum", False)


def test_memory_row_and_timed_call_on_the_cpu(tmp_path, monkeypatch):
    from nerf_replication_tpu_torch.obs.hooks import sample_memory, timed_call

    telem = str(tmp_path / "telemetry.jsonl")
    em = emit_mod.Emitter(telem, chief=True)
    monkeypatch.setattr(emit_mod, "_active", em)
    sample_memory(step=7, epoch=1)
    em.close()
    (row,) = _rows(telem)
    assert row["kind"] == "memory" and row["step"] == 7
    assert row["devices"] == [] and row["host_rss_bytes"] > 0
    out, dispatch_s, block_s = timed_call(lambda x: x + 1, 2, block=True)
    assert out == 3 and dispatch_s >= 0 and block_s >= 0
    assert timed_call(lambda: 0)[2] is None


def _trace_names(path):
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


@pytest.mark.parametrize("start,num,burst", [(2, 3, 1), (3, 4, 2)])
def test_profile_window_traces_exactly_its_steps(tmp_path, start, num,
                                                 burst):
    """Ticked before every burst and once after the last, the window
    traces the bursts that start in [start, start + num) and no other (a
    burst is the host's seam: JAX's window opens at the first burst that
    starts at or past ``start``)."""
    from nerf_replication_tpu_torch.obs import ProfileWindow, annotate

    win = ProfileWindow(start, num, str(tmp_path / "prof"), chief=True)
    x = torch.ones(8, 8)
    step = 0
    while step < 12:
        win.tick(step)
        with annotate(f"step_{step}"):
            for _ in range(burst):
                x = x @ x * 0.1
        step += burst
    win.tick(step)
    assert win.done and not win.active
    traced = sorted(int(n[5:]) for n in _trace_names(win.trace_path)
                    if n.startswith("step_"))
    first = -(-start // burst) * burst
    assert traced == list(range(first, start + num, burst))


@pytest.mark.parametrize("config", ["lego", "lego_hash_ngp"])
def test_fit_writes_the_profile_window(scene, tmp_path, config):
    """``train.profile`` in both trainers: a Chrome trace in
    ``<record_dir>/profile`` holding exactly the windowed steps'
    dispatches (the refusal this replaces raised NotImplementedError)."""
    from nerf_replication_tpu_torch.train.trainer import fit

    opts = _opts(scene, str(tmp_path), [
        "train.profile.start_step", "3", "train.profile.num_steps", "4",
        "eval_ep", "100", "train.epoch", "2"])
    if config == "lego":
        cfg = make_cfg(LEGO, opts)
    else:
        cfg = make_cfg(LEGO_HASH, opts + [
            "task_arg.ngp_training", "true", "task_arg.ngp_grid_res", "16",
            "task_arg.ngp_warmup_steps", "2", "task_arg.N_samples", "16",
            "task_arg.max_march_samples", "16",
            "network.xyz_encoder.log2_hashmap_size", "12"])
    state = fit(cfg, device="cpu", log=lambda s: None)
    assert state.step == 10
    trace = os.path.join(str(cfg.record_dir), "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert sum(1 for e in events if e.get("name") == "train/step_dispatch"
               and e.get("cat") == "user_annotation") == 4


def test_run_evaluate_writes_run_meta_and_eval_rows(port_run, monkeypatch,
                                                    tmp_path):
    from nerf_replication_tpu_torch.run import run_evaluate

    cfg, _ = port_run
    monkeypatch.chdir(tmp_path)  # no baked grid here: the chunked render

    class Args:
        cfg_file = LEGO
        device = "cpu"

    result = run_evaluate(cfg, Args)
    rows = _rows(os.path.join(cfg.record_dir, "telemetry.jsonl"))
    meta = [r for r in rows if r["kind"] == "run_meta"][-1]
    assert meta["component"] == "evaluate"
    (ev,) = [r for r in rows[rows.index(meta):] if r["kind"] == "eval"]
    assert ev["prefix"] == "evaluate" and ev["n_images"] == 1
    assert ev["metrics"]["psnr"] == result["psnr"]
    for row in rows:
        assert schema.validate_row(row) == [], row
