"""The port's graftlint CLI (``python -m
nerf_replication_tpu_torch.tools.graftlint``): the port tree lints clean
against ``nerf_replication_tpu_torch/analysis/graftlint_baseline.json`` in
a process that never imports torch or JAX; a seeded hazard exits 1 and
names its rule; JSON output, the ``lint_run`` row (valid under the port's
schema and the JAX package's), write-baseline then clean, ``--changed``
and per-rule times.
"""

import json
import os
import subprocess
import sys

import pytest

from nerf_replication_tpu_torch.analysis import RULES
from nerf_replication_tpu_torch.tools import graftlint as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a captured step that reads the loss on the host
HAZARD = (
    "import torch\n"
    "def step(x):\n"
    "    return x.sum().item()\n"
    "def warm(aot, x):\n"
    "    aot.register('step', step, (x,))\n"
)
BLOCKING = (
    "import threading\nimport time\n\n"
    "class Slow:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n\n"
    "    def tick(self):\n"
    "        with self._lock:\n"
    "            time.sleep(0.1)\n"
)

_GATE = """
import json, sys
from nerf_replication_tpu_torch.tools.graftlint import main
rc = main(["--telemetry", sys.argv[1]])
heavy = sorted(m for m in ("torch", "jax", "nerf_replication_tpu")
               if m in sys.modules)
print(json.dumps({"rc": rc, "heavy": heavy}))
"""


def test_port_tree_lints_clean_without_torch_or_jax(tmp_path):
    """THE gate: the port package and chip_smoke.py produce no finding
    beyond the committed baseline, in a process whose lint imported
    neither torch nor JAX (nor the JAX package); its lint_run row says
    so."""
    telem = tmp_path / "lint.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", _GATE, str(telem)],
                         capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.strip().splitlines()
    verdict = json.loads(out[-1])
    assert verdict == {"rc": 0, "heavy": []}, "\n".join(out)
    assert "0 new finding(s)" in res.stdout
    row = json.loads(telem.read_text().splitlines()[-1])
    assert row["kind"] == "lint_run" and row["exit_code"] == 0
    assert row["n_new"] == 0 and row["baseline_path"] == os.path.join(
        "nerf_replication_tpu_torch", "analysis", "graftlint_baseline.json")


def test_seeded_hazard_exits_nonzero(tmp_path, capsys):
    bad = tmp_path / "seeded.py"
    bad.write_text(HAZARD)
    rc = cli.main([str(bad), "--no-telemetry"])
    out = capsys.readouterr().out
    assert rc == 1 and "host-sync" in out and "captured `step`" in out


def test_json_format_and_lint_run_row(tmp_path, capsys):
    from nerf_replication_tpu.obs.schema import validate_row as jax_valid
    from nerf_replication_tpu_torch.obs.schema import validate_row

    bad = tmp_path / "seeded.py"
    bad.write_text(HAZARD)
    telem = tmp_path / "telemetry.jsonl"
    rc = cli.main([str(bad), "--format", "json", "--telemetry", str(telem)])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert report["n_new"] == 1 and report["new"][0]["rule"] == "host-sync"
    assert report["new"][0]["line"] == 3
    assert set(report["rules"]) == set(RULES)
    rows = [json.loads(line) for line in telem.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["kind"] == "lint_run"
    assert validate_row(rows[0]) == [] and jax_valid(rows[0]) == []
    assert rows[0]["n_new"] == 1 and rows[0]["exit_code"] == 1
    assert rows[0]["new_rule_counts"] == {"host-sync": 1}


def test_write_baseline_then_clean(tmp_path, capsys):
    bad = tmp_path / "seeded.py"
    bad.write_text(HAZARD)
    baseline = tmp_path / "baseline.json"
    assert cli.main([str(bad), "--baseline", str(baseline),
                     "--write-baseline"]) == 0
    capsys.readouterr()
    assert cli.main([str(bad), "--baseline", str(baseline),
                     "--no-telemetry"]) == 0
    assert "1 baselined" in capsys.readouterr().out
    # --no-baseline ignores it
    assert cli.main([str(bad), "--baseline", str(baseline),
                     "--no-baseline", "--no-telemetry"]) == 1


def test_changed_mode_lints_only_the_diff(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "seeded.py"
    bad.write_text(BLOCKING)
    monkeypatch.setattr(cli, "changed_paths", lambda base, root: [str(bad)])
    rc = cli.main(["--changed", "--no-telemetry", "--no-baseline"])
    out = capsys.readouterr().out
    assert rc == 1 and "blocking-under-lock" in out
    monkeypatch.setattr(cli, "changed_paths", lambda base, root: [])
    assert cli.main(["--changed", "--no-telemetry"]) == 0
    assert "no changed" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--changed", "--write-baseline", "--no-telemetry"])


def test_changed_paths_keep_to_the_scan(tmp_path):
    """``changed_paths`` reads ``git diff --name-only`` and keeps the port
    package and chip_smoke.py (not the JAX package, not tests)."""
    def git(*args):
        subprocess.run(["git", *args], cwd=tmp_path, check=True,
                       capture_output=True)

    for rel in ("nerf_replication_tpu_torch/a.py", "chip_smoke.py",
                "nerf_replication_tpu/b.py", "tests/test_c.py"):
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        (tmp_path / rel).write_text("x = 1\n")
    git("init", "-q")
    git("add", "-A")
    git("-c", "user.name=t", "-c", "user.email=t@t", "commit", "-qm", "0")
    for rel in ("nerf_replication_tpu_torch/a.py", "chip_smoke.py",
                "nerf_replication_tpu/b.py", "tests/test_c.py"):
        (tmp_path / rel).write_text("x = 2\n")
    got = cli.changed_paths("HEAD", str(tmp_path))
    assert sorted(os.path.relpath(p, tmp_path) for p in got) == [
        "chip_smoke.py", os.path.join("nerf_replication_tpu_torch", "a.py")]


def test_json_reports_per_rule_wall_time(tmp_path, capsys):
    from nerf_replication_tpu_torch.analysis import CONCURRENCY_RULE_IDS

    bad = tmp_path / "seeded.py"
    bad.write_text(BLOCKING)
    rc = cli.main([str(bad), "--format", "json", "--no-telemetry",
                   "--no-baseline"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    times = report["rule_times_s"]
    assert set(CONCURRENCY_RULE_IDS) <= set(times)
    assert all(t >= 0 for t in times.values())
    assert report["new_rule_counts"] == {"blocking-under-lock": 1}
    assert report["duration_s"] > 0
