"""Port parity of the COLMAP model I/O (``utils/colmap.py``), the COLMAP
tools (``tools/colmap2nerf.py``, ``tools/colmap_stats.py``) and the sweep
records (``utils/sweeps.py``) against the JAX package's module and
scripts.

* JAX's six ``tests/test_colmap_model.py`` scenarios run on the port's
  module and tools.
* A model written by either package reads back bitwise in the other, and
  the files are the same bytes.
* ``colmap_stats --json`` prints JAX's JSON; ``colmap2nerf`` writes JAX's
  ``transforms.json`` for the same model and JPEG frames in every field
  but ``sharpness``, which is ``cv2.Laplacian(gray, CV_64F).var()`` of the
  port decoder's grayscale (JAX reads its grayscale through OpenCV); a
  missing ``colmap`` or ``ffmpeg`` binary names itself.
* ``latest_points`` / ``best_point`` give JAX's outputs on JAX's rows.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from test_colmap_model import _assert_models_equal, _model
from test_torch_helpers import ROOT

from nerf_replication_tpu.utils import colmap as jcm
from nerf_replication_tpu_torch.tools import colmap2nerf, colmap_stats
from nerf_replication_tpu_torch.utils import colmap as pcm

CAPTURE = os.path.join(ROOT, "tests", "data", "jpeg", "capture")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_model():
    """JAX's fixture model as the port's dataclasses."""
    cams, ims, pts = _model()
    return ({k: pcm.Camera(c.id, c.model, c.width, c.height, c.params)
             for k, c in cams.items()},
            {k: pcm.Image(i.id, i.qvec, i.tvec, i.camera_id, i.name, i.xys,
                          i.point3D_ids) for k, i in ims.items()},
            {k: pcm.Point3D(p.id, p.xyz, p.rgb, p.error, p.image_ids,
                            p.point2D_idxs) for k, p in pts.items()})


# -- JAX's scenarios on the port's module -------------------------------------


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_model_roundtrip(tmp_path, ext):
    model = _port_model()
    d = str(tmp_path / "sparse")
    pcm.write_model(*model, d, ext=ext)
    _assert_models_equal(model, pcm.read_model(d, ext=ext))
    _assert_models_equal(model, pcm.read_model(d))


def test_cross_format_equivalence(tmp_path):
    model = _port_model()
    d_bin, d_txt = str(tmp_path / "b"), str(tmp_path / "t")
    pcm.write_model(*model, d_bin, ext=".bin")
    pcm.write_model(*pcm.read_model(d_bin), d_txt, ext=".txt")
    _assert_models_equal(model, pcm.read_model(d_txt))


def test_missing_points3D_reads_empty(tmp_path):
    cams, ims, pts = _port_model()
    d = str(tmp_path / "sparse")
    pcm.write_model(cams, ims, pts, d, ext=".bin")
    os.remove(os.path.join(d, "points3D.bin"))
    c2, i2, p2 = pcm.read_model(d)
    assert p2 == {} and c2.keys() == cams.keys() and i2.keys() == ims.keys()


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        R = pcm.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcm.qvec2rotmat(q))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        np.testing.assert_array_equal(pcm.rotmat2qvec(R), jcm.rotmat2qvec(R))
        np.testing.assert_allclose(pcm.rotmat2qvec(R), q, atol=1e-12)


def test_colmap_stats_prints_jax_json(tmp_path, capsys):
    """JAX's stats scenario (an unmatched keypoint planted) through the
    port's tool, and its ``--json`` line equal to JAX's script's."""
    model = _port_model()
    im3 = model[1][3]
    if len(im3.point3D_ids) == 0:
        im3.xys = np.array([[1.0, 2.0]])
        im3.point3D_ids = np.array([-1], np.int64)
    else:
        im3.point3D_ids[0] = -1
    d = str(tmp_path / "sparse")
    pcm.write_model(*model, d, ext=".bin")
    s = colmap_stats.model_stats(d)
    assert s["n_cameras"] == 2 and s["n_images"] == 3 and s["n_points3D"] == 2
    n_valid = sum(int(np.sum(im.point3D_ids != -1))
                  for im in model[1].values())
    assert s["obs_per_image"]["mean"] * s["n_images"] == n_valid
    colmap_stats.main([d, "--json"])
    ours = capsys.readouterr().out
    _jax_script("colmap_stats").main([d, "--json"])
    assert ours == capsys.readouterr().out
    colmap_stats.main([d])
    text = capsys.readouterr().out
    _jax_script("colmap_stats").main([d])
    assert text == capsys.readouterr().out
    assert "reprojection error" in text


def test_colmap2nerf_reads_written_models(tmp_path):
    model = _port_model()
    for ext in (".bin", ".txt"):
        d = str(tmp_path / ext.lstrip("."))
        pcm.write_model(*model, d, ext=ext)
        cams, ims = colmap2nerf.parse_model(d)
        assert set(cams) == set(model[0]) and cams[1]["model"] == "PINHOLE"
        by_name = {t[0]: t for t in ims}
        assert set(by_name) == {im.name for im in model[1].values()}
        name, cam_id, qvec, tvec = by_name["frame_0002.png"]
        assert cam_id == model[1][2].camera_id
        np.testing.assert_allclose(qvec, model[1][2].qvec)
        np.testing.assert_allclose(tvec, model[1][2].tvec)


# -- across the packages -------------------------------------------------------


def test_models_cross_read_bitwise(tmp_path):
    """Each package reads the other's files to the same model, and both
    write the same bytes, in both encodings."""
    jmodel, pmodel = _model(), _port_model()
    for ext in (".bin", ".txt"):
        dj, dp = str(tmp_path / f"j{ext}"), str(tmp_path / f"p{ext}")
        jcm.write_model(*jmodel, dj, ext=ext)
        pcm.write_model(*pmodel, dp, ext=ext)
        _assert_models_equal(pmodel, jcm.read_model(dp))
        _assert_models_equal(jmodel, pcm.read_model(dj))
        for f in sorted(os.listdir(dj)):
            with open(os.path.join(dj, f), "rb") as a, \
                    open(os.path.join(dp, f), "rb") as b:
                assert a.read() == b.read(), f


def _capture_model(d):
    """A COLMAP text model of the committed capture's cameras (its
    ``transforms.json`` poses as world->camera), written by the port."""
    with open(os.path.join(CAPTURE, "transforms.json")) as f:
        meta = json.load(f)
    cam = pcm.Camera(1, "PINHOLE", meta["w"], meta["h"], np.array(
        [meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"]], np.float64))
    images = {}
    for i, fr in enumerate(meta["frames"]):
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # NeRF -> COLMAP camera axes
        w2c = np.linalg.inv(c2w)
        images[i + 1] = pcm.Image(i + 1, pcm.rotmat2qvec(w2c[:3, :3]),
                                  w2c[:3, 3], 1,
                                  os.path.basename(fr["file_path"]))
    pcm.write_model({1: cam}, images, {}, d, ext=".txt")
    return meta


def test_colmap2nerf_writes_jax_transforms(tmp_path):
    """The same model and JPEG frames through JAX's script and the port's
    tool: every field equal but ``sharpness``, which is the variance of
    OpenCV's Laplacian over the port decoder's grayscale."""
    import cv2

    from nerf_replication_tpu_torch.utils.image import read_gray

    d = str(tmp_path / "text")
    meta = _capture_model(d)
    images = os.path.join(CAPTURE, "images")
    outs = {}
    for who, main in (("jax", _jax_script("colmap2nerf").main),
                      ("port", colmap2nerf.main)):
        out = str(tmp_path / f"{who}.json")
        main(["--images", images, "--text", d, "--out", out])
        with open(out) as f:
            outs[who] = json.load(f)
    j, p = outs["jax"], outs["port"]
    assert len(p["frames"]) == len(meta["frames"]) == 16
    for k in j:
        if k != "frames":
            assert p[k] == j[k], k
    for fj, fp in zip(j["frames"], p["frames"]):
        assert fp["file_path"] == fj["file_path"]
        assert fp["transform_matrix"] == fj["transform_matrix"]
        gray = read_gray(os.path.join(images,
                                      os.path.basename(fp["file_path"])))
        ref = float(cv2.Laplacian(gray, cv2.CV_64F).var())
        assert fp["sharpness"] > 0
        assert abs(fp["sharpness"] - ref) <= 1e-9 * abs(ref)
    assert colmap2nerf.sharpness(str(tmp_path / "missing.jpg")) == 0.0


def test_missing_binaries_name_themselves(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit, match="colmap binary not found"):
        colmap2nerf.main(["--images", str(tmp_path), "--run_colmap",
                          "--out", str(tmp_path / "t.json")])
    with pytest.raises(SystemExit, match="ffmpeg binary not found"):
        colmap2nerf.main(["--images", str(tmp_path), "--video_in", "v.mp4",
                          "--out", str(tmp_path / "t.json")])


def test_sweep_records_match_jax(tmp_path):
    """JAX test_aux's recency rows: an accumulation row and an opts row
    are points of their own; both packages resolve and rank them alike."""
    from nerf_replication_tpu.utils import sweeps as js
    from nerf_replication_tpu_torch.utils import sweeps as ps

    rows = [
        {"metric": "train_rays_per_sec", "value": 100.0, "n_rays": 4096,
         "dtype": "bfloat16", "remat": False, "scan_steps": 8,
         "config": "lego.yaml", "ts": 1.0},
        {"metric": "train_rays_per_sec", "value": 250.0, "n_rays": 4096,
         "dtype": "bfloat16", "remat": False, "scan_steps": 8,
         "grad_accum": 4, "config": "lego.yaml", "ts": 2.0},
        {"metric": "train_rays_per_sec", "value": 300.0, "n_rays": 4096,
         "dtype": "bfloat16", "remat": False, "scan_steps": 8,
         "grad_accum": 4, "opts": "network.nerf.fused_trunk true",
         "config": "lego.yaml", "ts": 3.0},
        {"metric": "train_rays_per_sec", "value": None, "n_rays": 4096,
         "dtype": "bfloat16", "remat": False, "scan_steps": 8,
         "config": "lego.yaml", "ts": 0.5},
    ]
    p = tmp_path / "BENCH_SWEEP_T.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows) + "not json\n")
    paths = [str(p), str(tmp_path / "missing.jsonl")]
    assert ps.latest_points(paths) == js.latest_points(paths)
    assert len(ps.latest_points(paths)) == 3
    for config in ("lego.yaml", None, "other.yaml"):
        assert ps.best_point(paths, config) == js.best_point(paths, config)
    assert ps.best_point(paths)["value"] == 300.0
