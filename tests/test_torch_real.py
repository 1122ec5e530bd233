"""Port parity of the real-capture path (``datasets/real.py``,
``datasets/rays.ndc_rays_np``) and of the native ray bank
(``native/raybank.cpp``).

* ``ndc_rays_np`` bitwise JAX's.
* On a 24 x 24 procedural scene written as one ``transforms.json``
  (``procedural.write_real_capture``) the port's dataset equals JAX's
  bitwise: train and test splits, plain rays (through the native bank
  builder) and NDC rays; a capture mixing frame sizes with per-frame
  intrinsics; the NDC bound check of ``from_cfg``.
* The native bank (g++ at first use) bitwise the numpy builder, RGB and
  RGBA frames.
* ``capture.yaml`` trains on the CPU through ``fit`` for a few steps.
"""

import json
import os

import numpy as np
import pytest

from test_torch_helpers import ROOT

from nerf_replication_tpu.datasets.real import Dataset as JaxDataset
from nerf_replication_tpu.datasets.rays import ndc_rays_np as jax_ndc
from nerf_replication_tpu_torch.datasets.procedural import (
    generate_scene,
    write_real_capture,
)
from nerf_replication_tpu_torch.datasets.rays import (
    get_rays_np,
    ndc_rays_np,
    pose_spherical,
)
from nerf_replication_tpu_torch.datasets.real import Dataset

CAPTURE = os.path.join(ROOT, "configs", "real", "capture.yaml")
CAPTURE_NDC = os.path.join(ROOT, "configs", "real", "capture_ndc.yaml")


@pytest.fixture(scope="module")
def capture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("real"))
    scene = generate_scene(root, scene="myscene", H=24, W=24, n_train=7,
                           n_test=2)
    write_real_capture(scene)
    return root


def test_ndc_rays_match_jax():
    o, d = get_rays_np(20, 30, 25.0, pose_spherical(30.0, -10.0, 4.0))
    for fl_y in (None, 27.0):
        for a, b in zip(ndc_rays_np(20, 30, 25.0, 1.0, o, d, fl_y=fl_y),
                        jax_ndc(20, 30, 25.0, 1.0, o, d, fl_y=fl_y)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndc", [False, True])
def test_dataset_matches_jax(capture_root, ndc):
    for split in ("train", "test"):
        kw = dict(data_root=capture_root, scene="myscene", split=split,
                  test_hold=4, ndc=ndc)
        j, p = JaxDataset(**kw), Dataset(**kw)
        for name in ("rays", "rgbs", "poses"):
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name),
                                          err_msg=f"{split} {name}")
        assert (p.H, p.W, p.focal, p.near, p.far, p.n_images) == \
            (j.H, j.W, j.focal, j.near, j.far, j.n_images)
        # a pinhole capture takes the bank builder (C++: g++ is here)
        assert p.bank_builder == ("per_frame" if ndc else "native")
        b, c = p.image_batch(0), j.image_batch(0)
        np.testing.assert_array_equal(b["rays"], c["rays"])


def test_mixed_resolution_intrinsics_match_jax(tmp_path):
    from nerf_replication_tpu_torch.utils.image import write_png

    H = W = 16
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    big = np.repeat(np.repeat(small, 2, axis=0), 2, axis=1)
    write_png(str(tmp_path / "a.png"), small)
    write_png(str(tmp_path / "b.png"), big)
    c2w = np.eye(4)
    c2w[2, 3] = 4.0
    meta = {"w": W, "h": H, "fl_x": 20.0, "fl_y": 21.0, "cx": 8.0, "cy": 7.5,
            "frames": [
                {"file_path": "a.png", "transform_matrix": c2w.tolist()},
                {"file_path": "a.png", "transform_matrix": c2w.tolist()},
                {"file_path": "b.png", "transform_matrix": c2w.tolist(),
                 "fl_x": 40.0, "fl_y": 42.0, "cx": 16.0, "cy": 15.0},
                {"file_path": "b.png", "transform_matrix": c2w.tolist()}]}
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump(meta, f)
    for ratio in (1.0, 0.5):
        kw = dict(data_root=str(tmp_path), split="train", test_hold=4,
                  input_ratio=ratio)
        j, p = JaxDataset(**kw), Dataset(**kw)
        np.testing.assert_array_equal(p.rays, j.rays)
        np.testing.assert_array_equal(p.rgbs, j.rgbs)
        assert p.focal == j.focal and p.n_images == 3
        assert p.bank_builder == "per_frame"


def test_ndc_config_requires_zero_one_bounds(capture_root):
    from nerf_replication_tpu_torch.config import make_cfg

    opts = ["scene", "myscene", "train_dataset.data_root", capture_root,
            "test_dataset.data_root", capture_root]
    with pytest.raises(ValueError, match="ndc=true requires"):
        Dataset.from_cfg(make_cfg(CAPTURE_NDC, opts + [
            "task_arg.near", "2.0", "task_arg.far", "6.0"]), "train")
    ds = Dataset.from_cfg(make_cfg(CAPTURE_NDC, opts), "train")
    assert (ds.near, ds.far) == (0.0, 1.0)


@pytest.mark.parametrize("channels", [3, 4])
def test_native_bank_is_bitwise_numpy(channels):
    from nerf_replication_tpu_torch import native

    assert native.native_available()  # g++ is here
    rng = np.random.default_rng(channels)
    poses = np.stack([pose_spherical(t, -30.0, 4.0)
                      for t in (0.0, 33.0, 90.0, -170.0)]).astype(np.float32)
    imgs = rng.integers(0, 256, (4, 40, 36, channels)).astype(np.uint8)
    got = native.build_ray_bank(poses, imgs, 37.3)
    ref = native._build_ray_bank_numpy(poses, imgs, 37.3)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_capture_trains_on_the_cpu(capture_root, tmp_path):
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(CAPTURE, [
        "scene", "myscene", "train_dataset.data_root", capture_root,
        "test_dataset.data_root", capture_root,
        "network.nerf.W", "32", "network.nerf.D", "3",
        "network.nerf.skips", "[1]", "task_arg.N_rays", "64",
        "task_arg.N_samples", "8", "task_arg.N_importance", "8",
        "ep_iter", "5", "train.epoch", "1", "eval_ep", "100",
        "save_latest_ep", "1",
        "result_dir", str(tmp_path / "result"),
        "trained_model_dir", str(tmp_path / "model"),
        "trained_config_dir", str(tmp_path / "config"),
        "record_dir", str(tmp_path / "record")])
    state = fit(cfg, log=lambda *_: None, device="cpu")
    assert state.step == 5
    assert os.path.exists(os.path.join(cfg.trained_model_dir, "latest.pt"))
