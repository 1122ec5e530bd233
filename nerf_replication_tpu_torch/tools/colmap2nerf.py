"""Convert a COLMAP reconstruction to a NeRF ``transforms.json`` (the
port's counterpart of ``scripts/colmap2nerf.py``: same flags, same file).

Optionally extract frames from a video (``ffmpeg``) and run COLMAP
(feature extraction, matching, mapping) on an image folder when the
binaries are on ``PATH``, then parse the model — binary
cameras.bin/images.bin or text cameras.txt/images.txt — into camera
intrinsics + camera-to-world poses in the NeRF convention, recentre and
rescale the scene, and write transforms.json with per-frame sharpness
scores. The score is the variance of the 3x3 Laplacian of the frame's
grayscale image as decoded by the port (``utils/image.read_gray``: a
JPEG's luma plane), in numpy: no OpenCV.

    python -m nerf_replication_tpu_torch.tools.colmap2nerf \
        --images data/scene/images [--run_colmap] \
        [--text data/scene/colmap_text] [--aabb_scale 4] \
        [--out data/scene/transforms.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np

from ..utils import colmap as _cm


def _cam_dict(cam) -> dict:
    return {
        "model": cam.model,
        "width": cam.width,
        "height": cam.height,
        "params": [float(p) for p in cam.params],
    }


def _image_tuples(images: dict) -> list:
    return [
        (im.name, im.camera_id, [float(v) for v in im.qvec],
         [float(v) for v in im.tvec])
        for im in images.values()
    ]


qvec2rotmat = _cm.qvec2rotmat


def parse_cameras_txt(path):
    """camera_id → dict(model, width, height, params)."""
    return {
        cid: _cam_dict(cam)
        for cid, cam in _cm.read_cameras_txt(path).items()
    }


def parse_images_txt(path):
    """[(image_name, camera_id, qvec, tvec)] — the converter's pose
    surface; the full reader (incl. the empty-observation-line pairing
    discipline) lives in utils/colmap.read_images_txt."""
    return _image_tuples(_cm.read_images_txt(path, skip_points2D=True))


def parse_cameras_bin(path):
    """camera_id → dict(model, width, height, params), from cameras.bin."""
    return {
        cid: _cam_dict(cam)
        for cid, cam in _cm.read_cameras_bin(path).items()
    }


def parse_images_bin(path):
    """[(image_name, camera_id, qvec, tvec)], from images.bin."""
    return _image_tuples(_cm.read_images_bin(path, skip_points2D=True))


def parse_model(model_dir):
    """(cameras, images) from a COLMAP model dir, binary or text.

    Prefers cameras.bin/images.bin (COLMAP's default export — no
    `colmap model_converter` round-trip needed), falls back to
    cameras.txt/images.txt.
    """
    bin_path = os.path.join(model_dir, "cameras.bin")
    if os.path.exists(bin_path):
        return (
            parse_cameras_bin(bin_path),
            parse_images_bin(os.path.join(model_dir, "images.bin")),
        )
    return (
        parse_cameras_txt(os.path.join(model_dir, "cameras.txt")),
        parse_images_txt(os.path.join(model_dir, "images.txt")),
    )


def intrinsics(cam):
    """(fl_x, fl_y, cx, cy, distortion dict) from a COLMAP camera."""
    p = cam["params"]
    model = cam["model"]
    dist = {"k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0}
    if model == "SIMPLE_PINHOLE":
        fl_x = fl_y = p[0]
        cx, cy = p[1], p[2]
    elif model == "PINHOLE":
        fl_x, fl_y, cx, cy = p[0], p[1], p[2], p[3]
    elif model == "SIMPLE_RADIAL":
        fl_x = fl_y = p[0]
        cx, cy = p[1], p[2]
        dist["k1"] = p[3]
    elif model == "RADIAL":
        fl_x = fl_y = p[0]
        cx, cy = p[1], p[2]
        dist["k1"], dist["k2"] = p[3], p[4]
    elif model == "OPENCV":
        fl_x, fl_y, cx, cy = p[0], p[1], p[2], p[3]
        dist["k1"], dist["k2"], dist["p1"], dist["p2"] = p[4], p[5], p[6], p[7]
    else:
        raise ValueError(f"unsupported COLMAP camera model {model}")
    return fl_x, fl_y, cx, cy, dist


def laplacian_var(gray: np.ndarray) -> float:
    """``cv2.Laplacian(gray, cv2.CV_64F).var()``: the 3x3 kernel
    ``[[0, 1, 0], [1, -4, 1], [0, 1, 0]]`` over edges mirrored without
    repeating the edge sample (OpenCV's ``BORDER_REFLECT_101``), in
    float64."""
    g = np.asarray(gray, np.float64)
    if g.ndim != 2:
        raise ValueError(f"a grayscale image is 2-D, got {g.shape}")
    p = np.pad(g, 1, mode="reflect")
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4.0 * g)
    return float(lap.var())


def sharpness(path) -> float:
    """Variance-of-Laplacian focus score (higher = sharper) of the
    frame's grayscale image; 0.0 for a file that cannot be read (OpenCV's
    ``imread`` returning None). A JPEG the port's decoder does not take
    (progressive, arithmetic-coded, 12-bit, lossless) raises, naming its
    marker."""
    from ..utils.image import read_gray

    try:
        gray = read_gray(path)
    except OSError:
        return 0.0
    return laplacian_var(gray)


def world_to_camera_to_c2w(qvec, tvec):
    """COLMAP stores world→camera; invert and flip into the NeRF/Blender
    convention (x right, y up, camera looks down -z)."""
    R = np.asarray(qvec2rotmat(qvec))
    t = np.asarray(tvec).reshape(3, 1)
    w2c = np.concatenate([np.concatenate([R, t], 1), [[0, 0, 0, 1]]], 0)
    c2w = np.linalg.inv(w2c)
    # COLMAP camera: x right, y DOWN, z forward → negate y and z columns
    c2w[0:3, 1] *= -1
    c2w[0:3, 2] *= -1
    return c2w


def recenter_and_scale(c2ws, target_radius: float = 4.0):
    """Translate the camera centroid to the origin and scale the average
    camera distance to target_radius (the Blender-synthetic shell)."""
    centers = np.stack([m[:3, 3] for m in c2ws], 0)
    centroid = centers.mean(0)
    for m in c2ws:
        m[:3, 3] -= centroid
    dist = np.mean(np.linalg.norm(centers - centroid, axis=-1))
    if dist > 1e-6:
        s = target_radius / dist
        for m in c2ws:
            m[:3, 3] *= s
    return c2ws


def run_ffmpeg(video_in: str, images_dir: str, fps: float,
               time_slice: str = ""):
    """Extract frames from a video into ``images_dir`` (fps sampling +
    an optional t1,t2 time slice); requires `ffmpeg` on PATH."""
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg binary not found on PATH (drop --video_in)")
    os.makedirs(images_dir, exist_ok=True)
    filters = [f"fps={fps}"]
    cmd = ["ffmpeg", "-y", "-i", video_in]
    if time_slice:
        t1, t2 = (float(t) for t in time_slice.split(","))
        cmd += ["-ss", str(t1), "-to", str(t2)]
    cmd += ["-vf", ",".join(filters), "-qscale:v", "2",
            os.path.join(images_dir, "%04d.jpg")]
    subprocess.run(cmd, check=True)
    return images_dir


def run_colmap(images_dir: str, workspace: str):
    """Drive the COLMAP binary (feature extraction → matching → mapping →
    text export); requires `colmap` on PATH."""
    if shutil.which("colmap") is None:
        raise SystemExit("colmap binary not found on PATH (drop --run_colmap)")
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    text = os.path.join(workspace, "text")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(text, exist_ok=True)
    steps = [
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", images_dir, "--ImageReader.camera_model", "OPENCV",
         "--ImageReader.single_camera", "1"],
        ["colmap", "exhaustive_matcher", "--database_path", db],
        ["colmap", "mapper", "--database_path", db, "--image_path", images_dir,
         "--output_path", sparse],
        ["colmap", "model_converter", "--input_path",
         os.path.join(sparse, "0"), "--output_path", text,
         "--output_type", "TXT"],
    ]
    for cmd in steps:
        subprocess.run(cmd, check=True)
    return text


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert a COLMAP model to a NeRF transforms.json")
    parser.add_argument("--images", required=True, help="image folder")
    parser.add_argument("--text", "--model", dest="text", default=None,
                        help="COLMAP model dir — binary (cameras.bin/"
                             "images.bin) or text (cameras.txt/images.txt)")
    parser.add_argument("--run_colmap", action="store_true")
    parser.add_argument("--video_in", default="",
                        help="extract frames from this video into --images "
                             "first (implies a capture workflow: follow "
                             "with --run_colmap)")
    parser.add_argument("--video_fps", type=float, default=2.0)
    parser.add_argument("--time_slice", default="",
                        help="'t1,t2' seconds window of the video to use")
    parser.add_argument("--aabb_scale", type=int, default=4)
    parser.add_argument("--out", default="transforms.json")
    args = parser.parse_args(argv)

    if args.video_in:
        run_ffmpeg(args.video_in, args.images, args.video_fps,
                   args.time_slice)

    text = args.text
    if args.run_colmap:
        text = run_colmap(args.images, os.path.dirname(args.out) or ".")
    if text is None:
        raise SystemExit("need --text (or --run_colmap)")

    cams, images = parse_model(text)
    if not images:
        raise SystemExit("no registered images in the COLMAP model")

    cam = cams[images[0][1]]
    fl_x, fl_y, cx, cy, dist = intrinsics(cam)
    W, H = cam["width"], cam["height"]

    c2ws = [world_to_camera_to_c2w(q, t) for _, _, q, t in images]
    c2ws = recenter_and_scale(c2ws)

    frames = []
    for (name, _, _, _), c2w in zip(images, c2ws):
        rel = os.path.join(os.path.basename(args.images.rstrip("/")), name)
        frames.append(
            {
                "file_path": rel,
                "sharpness": sharpness(os.path.join(args.images, name)),
                "transform_matrix": [[float(v) for v in row] for row in c2w],
            }
        )
    frames.sort(key=lambda f: f["file_path"])

    out = {
        "camera_angle_x": 2.0 * math.atan(0.5 * W / fl_x),
        "camera_angle_y": 2.0 * math.atan(0.5 * H / fl_y),
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
        "w": W, "h": H,
        **dist,
        "aabb_scale": args.aabb_scale,
        "frames": frames,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out} with {len(frames)} frames")


if __name__ == "__main__":
    sys.exit(main())
