"""Data-parallel fits and sharded eval of the port on two gloo ranks on the
CPU (``_torch_parallel_ranks``: spawned processes, a ``FileStore`` under
``tmp_path``), on a 16x16 procedural scene.

* A 2-rank lego fit: PSNR rises, the ranks end bitwise equal, only the
  chief writes checkpoints, scalars and telemetry; its validation under
  ``eval.sharded`` (every rank renders its slice) equals a one-process
  ``Trainer.val`` of the same weights.
* A checkpoint from 2 ranks resumes in one process, and one from one
  process resumes on 2 ranks (JAX ``test_checkpoint_restores_across_
  topology``).
* SIGTERM to one rank stops both at the same step (the flag agreed by a
  MAX at the burst boundary), and the resumed run ends bitwise where the
  uninterrupted one does.
* ``train --test`` with ``eval.sharded`` on 2 ranks scores what one process
  scores; the sharded video's frames are the one-process gate's.
* A 2-rank NGP fit: grid EMA and weights bitwise equal across ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import LEGO, LEGO_HASH, run_ranks

from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_dp"))
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=1)
    return root


def _opts(root, out, extra=()):
    return [
        "scene", "procedural", "exp_name", "dp",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "task_arg.N_rays", "64", "task_arg.N_samples", "8",
        "task_arg.N_importance", "8", "task_arg.chunk_size", "100",
        "task_arg.precrop_iters", "3", "network.nerf.W", "32",
        "network.nerf.D", "3", "network.nerf.skips", "[1]",
        "network.xyz_encoder.freq", "4", "network.dir_encoder.freq", "2",
        "ep_iter", "10", "log_interval", "1", "eval_ep", "100",
        "save_ep", "1", "save_latest_ep", "1", "train.epoch", "2",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        *extra,
    ]


def _fit2(tmp, root, out, extra=(), sigterm=None, cfg_file=LEGO):
    payload = {"cfg_file": cfg_file, "opts": _opts(root, out, extra)}
    if sigterm is not None:
        payload["sigterm"] = sigterm
    return run_ranks("fit", 2, tmp, payload)


def _cfg(root, out, extra=()):
    return make_cfg(LEGO, _opts(root, out, extra))


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, scene):
    """2 ranks, 2 epochs of 10 steps (precrop pool for 3), validation at
    the end under ``eval.sharded``."""
    tmp = tmp_path_factory.mktemp("dp_run")
    out = str(tmp / "out")
    res = _fit2(str(tmp / "job"), scene, out,
                ["eval_ep", "2", "eval.sharded", "true"])
    return res, out, scene


def test_two_rank_fit_learns_replicated_and_only_the_chief_writes(dp_run):
    res, out, _ = dp_run
    r0, r1 = res
    assert r0["step"] == r1["step"] == 20
    assert [s for s, _, _ in r0["rows"]] == list(range(1, 21))
    assert r0["rows"] == r1["rows"]  # the reduced stats, on both ranks
    psnr = [p for _, _, p in r0["rows"]]
    assert np.mean(psnr[-5:]) > np.mean(psnr[:5]) + 0.5
    assert _same(r0["weights"], r1["weights"])
    assert r0["writes"]["checkpoint"] > 0 and r0["writes"]["scalars"] > 0
    assert r0["writes"]["telemetry"] > 0
    assert r1["writes"] == {"checkpoint": 0, "scalars": 0, "telemetry": 0}
    with open(os.path.join(_cfg(dp_run[2], out).record_dir,
                           "telemetry.jsonl")) as f:
        meta = [json.loads(line) for line in f][0]
    assert meta["process_index"] == 0 and meta["process_count"] == 2


def test_sharded_validation_equals_one_process_val(dp_run, scene):
    """The fit's validation rendered each view over both ranks (the chief
    scored it): its PSNR is a one-process ``Trainer.val`` of the final
    weights (rtol 1e-4, as JAX's ``test_trainer_val_uses_sequence_parallel
    _gate``)."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.evaluators import make_evaluator
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    res, out, _ = dp_run
    with open(os.path.join(_cfg(scene, out).result_dir, "summary.json")) as f:
        sharded = json.load(f)
    cfg = make_cfg(LEGO, _opts(scene, str(out) + "_one", [
        "eval.sharded", "true"]))
    net = make_network(cfg)
    state = make_train_state(cfg, net, "cpu")
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in res[0]["weights"].items()})
    loss = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")(cfg, net)
    trainer = Trainer(cfg, net, loss, make_evaluator(cfg))
    one = trainer.val(state, 1, make_dataset(cfg, "test"),
                      log=lambda s: None)
    assert trainer._val_render[1].mesh is None  # one process: unsharded
    np.testing.assert_allclose(sharded["psnr"], one["psnr"], rtol=1e-4)


def test_checkpoint_restores_across_topology(dp_run, scene, tmp_path):
    """The 2-rank checkpoint resumes in one process (epoch 2 → step 30);
    a one-process checkpoint resumes on 2 ranks, which end bitwise equal."""
    import shutil

    from nerf_replication_tpu_torch.train.trainer import fit

    _, out, _ = dp_run
    one = str(tmp_path / "one")
    shutil.copytree(os.path.join(out, "trained"),
                    os.path.join(one, "trained"))
    state = fit(make_cfg(LEGO, _opts(scene, one, ["train.epoch", "3"])),
                device="cpu", log=lambda s: None)
    assert state.step == 30
    assert all(torch.isfinite(p).all() for p in state.network.parameters())
    back = str(tmp_path / "back")
    fit(make_cfg(LEGO, _opts(scene, back, ["train.epoch", "1"])),
        device="cpu", log=lambda s: None)
    r0, r1 = _fit2(str(tmp_path / "job"), scene, back)
    assert r0["step"] == r1["step"] == 20
    assert [s for s, _, _ in r0["rows"]] == list(range(11, 21))
    assert _same(r0["weights"], r1["weights"])


def test_sigterm_on_one_rank_stops_both_and_resume_matches(dp_run, scene,
                                                           tmp_path):
    """SIGTERM to rank 1 after step 13: both ranks stop after step 13 and
    the chief flushes ``latest.pt`` mid-epoch; the resumed 2-rank run ends
    bitwise on the uninterrupted run's weights."""
    out = str(tmp_path / "out")
    stopped = _fit2(str(tmp_path / "a"), scene, out, sigterm=(1, 13))
    assert [r["step"] for r in stopped] == [13, 13]
    blob = torch.load(os.path.join(_cfg(scene, out).trained_model_dir,
                                   "latest.pt"), weights_only=False)
    assert blob["step"] == 13 and blob["epoch_it"] == 3
    resumed = _fit2(str(tmp_path / "b"), scene, out)
    assert [r["step"] for r in resumed] == [20, 20]
    # the uninterrupted run validated under eval.sharded (no state change)
    assert _same(resumed[0]["weights"], dp_run[0][0]["weights"])
    assert _same(resumed[1]["weights"], dp_run[0][0]["weights"])


def test_train_test_sharded_equals_one_process(dp_run, scene, tmp_path):
    """``train --test`` with ``eval.sharded`` on 2 ranks (each view's rays
    over both; the chief scores) against one process."""
    from nerf_replication_tpu_torch.train.__main__ import main

    _, out, _ = dp_run
    sums = {}
    for label in ("two", "one"):
        opts = _opts(scene, out, ["eval.sharded", "true", "result_dir",
                                  str(tmp_path / label)])
        argv = ["--cfg_file", LEGO, "--device", "cpu", "--test", *opts]
        if label == "two":
            assert run_ranks("main", 2, str(tmp_path / "job"),
                             {"module": "train", "argv": argv}) == [0, 0]
        else:
            assert main(argv) == 0
        with open(os.path.join(make_cfg(LEGO, opts).result_dir,
                               "summary.json")) as f:
            sums[label] = json.load(f)
    np.testing.assert_allclose(sums["two"]["psnr"], sums["one"]["psnr"],
                               rtol=1e-4)
    np.testing.assert_allclose(sums["two"]["ssim"], sums["one"]["ssim"],
                               rtol=1e-4)


def test_sharded_video_frames_are_the_gate_render(dp_run, scene, tmp_path):
    """``render_video`` under ``eval.sharded`` on 2 ranks: the chief's AVI
    holds the frames of the same poses through the one-process gate."""
    from nerf_replication_tpu_torch.render_video import (
        GateSession,
        spiral_frames,
    )
    from nerf_replication_tpu_torch.utils.video import read_avi

    _, out, _ = dp_run
    opts = _opts(scene, out, ["eval.sharded", "true", "task_arg.video_frames",
                              "2", "task_arg.accelerated_renderer", "false",
                              "result_dir", str(tmp_path / "video")])
    assert run_ranks("main", 2, str(tmp_path / "job"), {
        "module": "render_video",
        "argv": ["--cfg_file", LEGO, "--device", "cpu", *opts]}) == [0, 0]
    frames, _ = read_avi(os.path.join(make_cfg(LEGO, opts).result_dir,
                                      "video.avi"))
    session = GateSession(make_cfg(LEGO, opts), LEGO, "cpu")
    assert session.render.mesh is None
    cam = session.cam
    ref = spiral_frames(session, int(cam.H), int(cam.W), float(cam.focal),
                        n_frames=2)
    assert len(frames) == 2
    for a, b in zip(frames, ref):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_ngp_two_rank_fit_stays_replicated(scene, tmp_path):
    """lego_hash with ``ngp_training`` on 2 ranks (32 rays each): warm then
    march steps, finite losses, grid EMA and weights bitwise equal across
    the ranks."""
    extra = ["network.xyz_encoder.num_levels", "4",
             "network.xyz_encoder.log2_hashmap_size", "10",
             "network.xyz_encoder.desired_resolution", "64",
             "network.nerf.D", "2", "task_arg.render_step_size", "0.08",
             "task_arg.max_march_samples", "24", "task_arg.march_chunk_size",
             "128", "task_arg.ngp_grid_res", "16", "task_arg.ngp_training",
             "true", "task_arg.ngp_warmup_steps", "4",
             "task_arg.ngp_warmup_max", "4", "task_arg.ngp_warmup_samples",
             "16", "task_arg.precrop_iters", "0",
             "task_arg.ngp_grid_decay", "0.1"]  # carves within 20 steps
    r0, r1 = _fit2(str(tmp_path / "job"), scene, str(tmp_path / "out"),
                   extra, cfg_file=LEGO_HASH)
    assert r0["step"] == r1["step"] == 20
    assert all(np.isfinite(loss) for _, loss, _ in r0["rows"])
    assert np.array_equal(r0["grid"], r1["grid"])
    assert float((r0["grid"] > 1.0).mean()) < 1.0  # the grid carved
    assert _same(r0["weights"], r1["weights"])
