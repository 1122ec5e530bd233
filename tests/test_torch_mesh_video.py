"""Port parity of the offline products of a checkpoint: the mesh
(``utils/mesh.py``, ``run --type mesh``) and the 360° video
(``render_video.py``, ``utils/video.py``).

* ``marching_tetrahedra`` vertices and faces bitwise JAX's on a sphere's
  distance field, and on empty and full grids; ``write_ply`` bytes equal
  JAX's and read back (``read_ply``).
* ``sample_density_grid`` of the port network against JAX's on the same
  parameters (W 32 D 3, 12³ points, chunks of 500): within 1e-5 of the
  largest σ (float32 products in another order).
* ``run --type mesh`` on the CPU writes a PLY with faces.
* The spiral's poses bitwise those the JAX CLI hands its engine.
* The AVI writer round trip (the port's reader and OpenCV's, bitwise), and
  ``render_video`` on a tiny CPU checkpoint writes ``video_frames`` frames
  equal to the engine's renders of the same poses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_helpers import LEGO, ROOT, nets

from nerf_replication_tpu.utils import mesh as jmesh
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene
from nerf_replication_tpu_torch.utils import mesh as pmesh
from nerf_replication_tpu_torch.utils.video import read_avi, write_avi

BBOX = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)


def _sphere_field(res=20):
    c = np.linspace(-1.5, 1.5, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (1.0 - np.sqrt(x * x + y * y + z * z)).astype(np.float32) * 50


@pytest.mark.parametrize("kind", ["sphere", "empty", "full"])
def test_marching_tetrahedra_bitwise_jax(kind, tmp_path):
    grid = {"sphere": _sphere_field(),
            "empty": np.zeros((8, 8, 8), np.float32),
            "full": np.full((8, 8, 8), 100.0, np.float32)}[kind]
    v, f = pmesh.marching_tetrahedra(grid, 10.0, BBOX)
    jv, jf = jmesh.marching_tetrahedra(grid, 10.0, BBOX)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert (len(f) > 100) == (kind == "sphere")
    p = pmesh.write_ply(str(tmp_path / "p.ply"), v, f)
    j = jmesh.write_ply(str(tmp_path / "j.ply"), jv, jf)
    assert open(p, "rb").read() == open(j, "rb").read()
    rv, rf = pmesh.read_ply(p)
    np.testing.assert_array_equal(rv, v)
    np.testing.assert_array_equal(rf, f)


def test_density_grid_matches_jax():
    extra = ["network.nerf.W", "32", "network.nerf.D", "3",
             "network.nerf.skips", "[1]"]
    jnet, params, pnet = nets(extra=extra, seed=3)
    ref = jmesh.sample_density_grid(params, jnet, BBOX, 12, batch=500)
    got = pmesh.sample_density_grid(pnet, BBOX, 12, batch=500)
    assert got.shape == ref.shape == (12, 12, 12)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_mesh"))
    generate_scene(root, "procedural", H=16, W=16, n_train=2, n_test=1)
    return root


def _opts(root, out, extra=()):
    return ["scene", "procedural",
            "train_dataset.data_root", root, "test_dataset.data_root", root,
            "train_dataset.H", "16", "train_dataset.W", "16",
            "test_dataset.H", "16", "test_dataset.W", "16",
            "task_arg.N_samples", "8", "task_arg.N_importance", "8",
            "task_arg.chunk_size", "256",
            "network.nerf.W", "32", "network.nerf.D", "3",
            "network.nerf.skips", "[1]",
            "trained_model_dir", os.path.join(out, "trained"),
            "trained_config_dir", os.path.join(out, "config"),
            "record_dir", os.path.join(out, "record"),
            "result_dir", os.path.join(out, "result"), *extra]


def test_mesh_cli_writes_a_ply(scene, tmp_path):
    opts = _opts(scene, str(tmp_path), ["resolution", "16", "level", "0.5"])
    res = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.run", "--type",
         "mesh", "--device", "cpu", "--cfg_file", LEGO, *opts],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    path = os.path.join(make_cfg(LEGO, opts).result_dir, "mesh.ply")
    assert f"mesh saved to {path}" in res.stdout
    v, f = pmesh.read_ply(path)
    assert len(f) > 0 and np.isfinite(v).all()
    assert (np.abs(v) <= 1.5 + 1e-6).all()


def test_spiral_poses_bitwise_jax():
    from render_video import spiral_frames as jax_spiral

    from nerf_replication_tpu_torch.render_video import spiral_poses

    seen = []

    class Engine:
        def render_view(self, c2w, H, W, focal):
            seen.append(np.asarray(c2w))
            return np.zeros((H, W, 3), np.uint8), {}

    class Renderer:
        render_accelerated = None

        def report_truncation(self):
            return 0

    jax_spiral(Renderer(), None, 2, 2, 1.0, 2.0, 6.0, n_frames=12,
               progress=False, engine=Engine())
    mine = spiral_poses(12)
    assert len(seen) == len(mine) == 12
    for a, b in zip(mine, seen):
        np.testing.assert_array_equal(a, b)


def test_avi_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (13, 17, 3)).astype(np.uint8)
              for _ in range(4)]
    path = write_avi(str(tmp_path / "v.avi"), frames, fps=24)
    back, fps = read_avi(path)
    assert fps == 24 and len(back) == 4
    for a, b in zip(back, frames):
        np.testing.assert_array_equal(a, b)
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    n = 0
    while True:
        ok, f = cap.read()
        if not ok:
            break
        np.testing.assert_array_equal(f[..., ::-1], frames[n])
        n += 1
    assert n == 4


def test_render_video_writes_its_frames(scene, tmp_path):
    from nerf_replication_tpu_torch.render_video import (
        render_360_video,
        spiral_poses,
        video_engine,
    )

    cfg = make_cfg(LEGO, _opts(scene, str(tmp_path),
                               ["task_arg.video_frames", "3"]))
    engine, cam = video_engine(cfg, None, device="cpu")
    path = render_360_video(cfg, device="cpu", engine=(engine, cam))
    frames, fps = read_avi(path)
    assert path.endswith("video.avi") and fps == 30 and len(frames) == 3
    engine.cache.clear()
    for frame, c2w in zip(frames, spiral_poses(3)):
        ref, meta = engine.render_view(c2w, 16, 16, float(cam.focal))
        assert not meta["cache_hit"]
        np.testing.assert_array_equal(frame, ref)
    rows = open(os.path.join(cfg.record_dir, "telemetry.jsonl")).read()
    assert '"prefix": "video"' in rows
