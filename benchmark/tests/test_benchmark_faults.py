"""``correct`` comes out false when the timed path is broken underneath
(each fault a cell can have on one card), and when the control (the
reference in the precision below the configuration's) takes the
program's place. The harness's look for a card is skipped: the runs are
on the CPU at small sizes. Each cell's family names where its faults are
planted in the program."""

import time

import pytest
import torch

from harness.cell import run_serve, run_train
from harness.train_cell import TrainRun
from reference import compare

from tiny_cells import cells_of_kind, plant, tiny_serve, tiny_train

TRAIN = cells_of_kind("train_loop")
SERVE = cells_of_kind("viewer_open")
CPU = torch.device("cpu")
CONTROL = {"bfloat16": "fp8_e4m3", "float32": "tf32"}


def _train_with(name, fault, monkeypatch):
    cell = tiny_train(name)
    plant(monkeypatch, cell, fault)
    return run_train(torch, CPU, cell, 2**31 + 21, 0.3, False,
                     time.perf_counter())


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged(name, monkeypatch):
    r = _train_with(name, "state_unchanged", monkeypatch)
    assert not r["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(name, monkeypatch):
    r = _train_with(name, "half_batch", monkeypatch)
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
    cell = tiny_serve(name)
    plant(monkeypatch, cell, "answer_altered")
    r = run_serve(torch, CPU, cell, 2**31 + 23, 2.0, False,
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
