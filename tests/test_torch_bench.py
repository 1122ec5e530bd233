"""The port's bench entry point (``python -m nerf_replication_tpu_torch.bench``)
on the CPU at the root bench's smoke overrides (64 rays, 2 steps a window,
``scan_steps 1``): one JSON result line from the median of three timed
windows, the defaults read from ``BENCH_DEFAULTS.json``, and a non-zero exit
with no result line when the run fails."""

import json
import os
import subprocess
import sys

from test_torch_helpers import ROOT

SMOKE = {"BENCH_N_RAYS": "64", "BENCH_STEPS": "2", "BENCH_SCAN_STEPS": "1"}


def _bench(tmp_path, **env):
    full = {k: v for k, v in os.environ.items()
            if k != "PYTHONPATH" and not k.startswith("BENCH_")}
    full.update(SMOKE, **env)
    full["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.bench",
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path), env=full)


def test_bench_prints_one_result_line(tmp_path):
    with open(os.path.join(ROOT, "BENCH_DEFAULTS.json")) as f:
        defaults = json.load(f)
    res = _bench(tmp_path, BENCH_TAG="cpu_smoke")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "train_rays_per_sec" and rec["unit"] == "rays/s"
    assert len(rec["windows"]) == 3
    assert sorted(rec["windows"])[1] == rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / (1024 / 0.222), 2)
    assert rec["n_rays"] == 64 and rec["scan_steps"] == 1
    assert rec["steps_per_window"] == 2 and rec["device"] == "cpu"
    assert rec["dtype"] == defaults["dtype"]
    assert rec["config"] == defaults["config"] and rec["tag"] == "cpu_smoke"


def test_bench_exits_nonzero_on_failure(tmp_path):
    """A config that does not exist, and a device that is not there: no
    result line, a non-zero exit (no fallback number)."""
    res = _bench(tmp_path, BENCH_CONFIG="no_such_config.yaml")
    assert res.returncode != 0 and res.stdout.strip() == ""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(SMOKE, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.bench"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr
