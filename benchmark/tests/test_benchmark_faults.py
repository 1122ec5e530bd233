"""``correct`` comes out false when the timed path is broken underneath
(each fault a cell can have on one card), and when the control (the
reference in the precision below the configuration's) takes the
program's place. The harness's look for a card is skipped: the runs are
on the CPU at small sizes."""

import time

import pytest
import torch

from harness.cell import run_serve, run_train
from harness.spec import load_benchmark
from harness.train_cell import TrainRun
from reference import compare

from tiny_cells import tiny_serve, tiny_train

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
TRAIN = [n for n in CELLS if n.endswith(".train")]
SERVE = [n for n in CELLS if n.endswith(".serve")]
CPU = torch.device("cpu")
CONTROL = {"bfloat16": "fp8_e4m3", "float32": "tf32"}


def _train(name):
    return run_train(torch, CPU, tiny_train(name), 2**31 + 21, 0.3, False,
                     time.perf_counter())


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from nerf_replication_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "optimizer_step", lambda opt: None)
    r = _train(name)
    assert not r["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(name, monkeypatch):
    from nerf_replication_tpu_torch.datasets import sampling
    from nerf_replication_tpu_torch.train import step_core

    def half(gen, rays, rgbs, n_rays, index_pool=None):
        r, c = sampling.sample_rays(gen, rays, rgbs, n_rays, index_pool)
        return r[: n_rays // 2], c[: n_rays // 2]

    monkeypatch.setattr(step_core, "sample_rays", half)
    r = _train(name)
    assert not r["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails(name):
    cell = tiny_train(name, dtype=None)
    run = TrainRun(torch, CPU, cell, 2**31 + 22, time.perf_counter())
    run.make_inputs()
    ref = run.reference()
    control = run.reference(CONTROL[run.spec["compute_dtype"]])
    numbers = compare.train_numbers(control, ref)["numbers"]
    ok, _ = compare.judge(numbers, cell.config["limits"]["train"])
    assert not ok


@pytest.mark.parametrize("name", SERVE)
def test_answer_altered_where_it_is_produced(name, monkeypatch):
    from nerf_replication_tpu_torch.serve import engine

    real = engine.RenderEngine._render_bucket

    def altered(self, rays, bucket, family, warm=False, scene=None):
        out = real(self, rays, bucket, family, warm=warm, scene=scene)
        if not warm and rays.shape[0]:
            out["rgb_map_f"] = out["rgb_map_f"].copy()
            out["rgb_map_f"][0] += 0.05
        return out

    monkeypatch.setattr(engine.RenderEngine, "_render_bucket", altered)
    r = run_serve(torch, CPU, tiny_serve(name), 2**31 + 23, 2.0, False,
                  time.perf_counter())
    assert not r["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_control_fails(name):
    from harness.serve_cell import ServeRun
    from harness.traffic import viewer_schedule

    cell = tiny_serve(name)
    run = ServeRun(torch, CPU, cell, 2**31 + 24, time.perf_counter())
    run.make_inputs()
    gaps = {"rgb_gap": 0.0, "acc_gap": 0.0, "depth_gap": 0.0}
    for req in viewer_schedule(cell.traffic, run.seed, 2.0)[:4]:
        ref = run.reference_maps(req)
        ctl = run.reference_maps(req, CONTROL[run.serve["compute_dtype"]])
        gaps["rgb_gap"] = max(gaps["rgb_gap"],
                              float((ctl["rgb"] - ref["rgb"]).abs().max()))
        gaps["acc_gap"] = max(gaps["acc_gap"],
                              float((ctl["acc"] - ref["acc"]).abs().max()))
        gaps["depth_gap"] = max(gaps["depth_gap"], float(
            (ctl["depth"] - ref["depth"]).abs().max()) / run.spec["far"])
    ok, _ = compare.judge(gaps, cell.config["limits"]["serve"])
    assert not ok
