"""At small sizes on the CPU, the program's entry for each cell (the
trainer's step, the engine behind the micro-batcher) agrees with the
plain reference, run end to end through the harness, and a run's last
line has the contract's keys."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from harness.cell import run_serve, run_train

from conftest import BENCH_DIR, ROOT
from tiny_cells import cells_of_kind, tiny_serve, tiny_train

TRAIN = cells_of_kind("train_loop")
SERVE = cells_of_kind("viewer_open")
CPU = torch.device("cpu")


def _check_line(result, cell, trace):
    keys = list(result)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        keys)
    assert keys[-1] == "checks"
    assert set(result["metrics"]) <= {
        m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"}
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(result)
    for name, (value, limit) in result["checks"].items():
        assert isinstance(value, float) and isinstance(limit, float)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("trace", [False, True])
def test_train_cell_agrees_with_the_reference(name, trace):
    cell = tiny_train(name)
    r = run_train(torch, CPU, cell, 2**31 + 11, 0.3, trace,
                  time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    n = r["where"]["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_err"] < 1e-4
    _check_line(r, cell, trace)


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("trace", [False, True])
def test_serve_cell_agrees_with_the_reference(name, trace):
    cell = tiny_serve(name)
    r = run_serve(torch, CPU, cell, 2**31 + 12, 2.0, trace,
                  time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["where"]["requests_compared"] >= 4
    assert r["where"]["compiles_in_window"] == 0
    assert r["where"]["pose_cache_hits"] == 0
    for name_, (value, _) in r["checks"].items():
        assert value < 1e-5, name_
    _check_line(r, cell, trace)


def test_entry_refuses_without_a_card_or_the_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = ["--workload", TRAIN[0], "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    out = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark")
    out = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""
