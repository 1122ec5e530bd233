"""COLMAP sparse-model I/O: read AND write, binary AND text (a copy of
``nerf_replication_tpu/utils/colmap.py``, numpy and ``struct`` only, so
the port reads and writes the same files without importing the JAX
package; ``tests/test_torch_colmap.py`` holds the two to the same bytes).

An independent implementation of the public COLMAP model format, sized to
what a capture workflow touches: cameras/images/points3D in both
encodings, round-trippable, with the quaternion helpers.

Format (public spec, reimplemented from scratch):

* ``cameras.bin``   — u64 count, then per camera: i32 id, i32 model_id,
  u64 width, u64 height, f64 params[n_params(model)].
* ``images.bin``    — u64 count, then per image: i32 id, f64 qvec[4]
  (w, x, y, z), f64 tvec[3], i32 camera_id, NUL-terminated name,
  u64 n_points2D, then f64 x, f64 y, i64 point3D_id per observation.
* ``points3D.bin``  — u64 count, then per point: i64 id, f64 xyz[3],
  u8 rgb[3], f64 error, u64 track_len, then i32 image_id,
  i32 point2D_idx per track element.
* ``*.txt``         — same fields, ``#`` comments; images.txt uses two
  lines per image (header, then the observation triplets).

Poses are world→camera (COLMAP convention); ``qvec2rotmat`` /
``rotmat2qvec`` convert to/from rotation matrices.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

# model_id -> (name, n_params); public COLMAP camera-model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str  # name, e.g. "PINHOLE"
    width: int
    height: int
    params: np.ndarray  # [n_params] f64


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # [4] f64, (w, x, y, z), world->camera
    tvec: np.ndarray  # [3] f64
    camera_id: int
    name: str
    xys: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float64)
    )
    point3D_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64)
    )


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # [3] f64
    rgb: np.ndarray  # [3] u8
    error: float
    image_ids: np.ndarray  # [track] i32
    point2D_idxs: np.ndarray  # [track] i32


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array(
        [
            [
                1 - 2 * (y * y + z * z),
                2 * (x * y - w * z),
                2 * (x * z + w * y),
            ],
            [
                2 * (x * y + w * z),
                1 - 2 * (x * x + z * z),
                2 * (y * z - w * x),
            ],
            [
                2 * (x * z - w * y),
                2 * (y * z + w * x),
                1 - 2 * (x * x + y * y),
            ],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), w >= 0 (Shepperd's branch pick)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s,
             (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
        )
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        q = np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
             0.25 * s, (R[1, 2] + R[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
        q = np.array(
            [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
        )
    if q[0] < 0:
        q = -q
    return q


# ---------------------------------------------------------------- binary

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path) -> dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, "<iiQQ")
            if mid not in CAMERA_MODELS:
                raise ValueError(f"{path}: unknown camera model id {mid}")
            name, n_p = CAMERA_MODELS[mid]
            params = np.array(_read(f, f"<{n_p}d"))
            out[cid] = Camera(cid, name, int(w), int(h), params)
    return out


def write_cameras_bin(cameras: dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            n_p = CAMERA_MODELS[mid][1]
            if len(cam.params) != n_p:
                raise ValueError(
                    f"camera {cam.id}: {cam.model} wants {n_p} params, "
                    f"got {len(cam.params)}"
                )
            f.write(
                struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height)
            )
            f.write(struct.pack(f"<{n_p}d", *map(float, cam.params)))


def read_images_bin(path, skip_points2D: bool = False) -> dict[int, Image]:
    """``skip_points2D`` seeks past the observation records (a pose-only
    consumer like colmap2nerf avoids materializing ~24 B × n_obs per
    image); the Images then carry empty xys/point3D_ids."""
    out = {}
    empty_xy = np.zeros((0, 2), np.float64)
    empty_id = np.zeros((0,), np.int64)
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            vals = _read(f, "<7d")
            cam_id = _read(f, "<i")[0]
            name = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                if c == b"":
                    raise ValueError(
                        f"{path}: truncated (EOF inside image name)"
                    )
                name += c
            (m,) = _read(f, "<Q")
            if skip_points2D:
                f.seek(24 * m, os.SEEK_CUR)
                xys, p3d = empty_xy, empty_id
            else:
                # each observation is (f64 x, f64 y, i64 point3D_id): read
                # the 24-byte records raw, reinterpret the column groups
                trip = np.frombuffer(
                    f.read(24 * m), np.uint8
                ).reshape(m, 24)
                xys = trip[:, :16].copy().view(np.float64).reshape(m, 2)
                p3d = trip[:, 16:].copy().view(np.int64).reshape(m)
            out[iid] = Image(
                iid, np.array(vals[:4]), np.array(vals[4:]), cam_id,
                name.decode("utf-8"), xys, p3d,
            )
    return out


def write_images_bin(images: dict[int, Image], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<7d", *im.qvec, *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            m = len(im.point3D_ids)
            f.write(struct.pack("<Q", m))
            for k in range(m):
                f.write(
                    struct.pack(
                        "<ddq",
                        float(im.xys[k, 0]),
                        float(im.xys[k, 1]),
                        int(im.point3D_ids[k]),
                    )
                )


def read_points3D_bin(path) -> dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"), np.uint8)
            (err,) = _read(f, "<d")
            (t,) = _read(f, "<Q")
            track = np.array(_read(f, f"<{2 * t}i"), np.int32).reshape(t, 2)
            out[pid] = Point3D(
                pid, xyz, rgb, float(err), track[:, 0].copy(),
                track[:, 1].copy(),
            )
    return out


def write_points3D_bin(points: dict[int, Point3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<q3d3Bd", p.id, *map(float, p.xyz),
                                *map(int, p.rgb), float(p.error)))
            t = len(p.image_ids)
            f.write(struct.pack("<Q", t))
            for k in range(t):
                f.write(struct.pack("<ii", int(p.image_ids[k]),
                                    int(p.point2D_idxs[k])))


# ------------------------------------------------------------------ text

def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_txt(path) -> dict[int, Camera]:
    out = {}
    for line in _data_lines(path):
        parts = line.split()
        cid, model, w, h = (
            int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        )
        out[cid] = Camera(cid, model, w, h,
                          np.array([float(x) for x in parts[4:]]))
    return out


def write_cameras_txt(cameras: dict[int, Camera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cam in cameras.values():
            ps = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {ps}\n")


def read_images_txt(path, skip_points2D: bool = False) -> dict[int, Image]:
    # an image's observation line may be legitimately EMPTY, so blank
    # lines can't be skipped wholesale (that desyncs the 2-line pairing):
    # skip blanks/comments only while LOOKING FOR a header, then consume
    # the immediately following line — whatever it holds — as the
    # observations (same discipline as scripts/colmap2nerf.py)
    out = {}
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        header = line.split(maxsplit=9)
        if len(header) < 10:
            # junk/partial line — not an image header; do NOT consume a
            # partner line (matches COLMAP's own reader tolerance)
            continue
        parts = (
            [] if skip_points2D or i >= len(lines) else lines[i].split()
        )
        i += 1
        iid = int(header[0])
        q = np.array([float(v) for v in header[1:5]])
        t = np.array([float(v) for v in header[5:8]])
        cam_id = int(header[8])
        name = header[9]
        m = len(parts) // 3
        xys = np.array(
            [[float(parts[3 * k]), float(parts[3 * k + 1])]
             for k in range(m)]
        ).reshape(m, 2)
        p3d = np.array([int(parts[3 * k + 2]) for k in range(m)], np.int64)
        out[iid] = Image(iid, q, t, cam_id, name, xys, p3d)
    return out


def write_images_txt(images: dict[int, Image], path) -> None:
    with open(path, "w") as f:
        f.write(
            "# Image list, two lines per image:\n"
            "#   IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n"
            "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
        )
        for im in images.values():
            pose = " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
            f.write(
                " ".join(
                    f"{float(im.xys[k, 0])!r} {float(im.xys[k, 1])!r} "
                    f"{int(im.point3D_ids[k])}"
                    for k in range(len(im.point3D_ids))
                )
                + "\n"
            )


def read_points3D_txt(path) -> dict[int, Point3D]:
    out = {}
    for line in _data_lines(path):
        parts = line.split()
        pid = int(parts[0])
        xyz = np.array([float(v) for v in parts[1:4]])
        rgb = np.array([int(v) for v in parts[4:7]], np.uint8)
        err = float(parts[7])
        track = parts[8:]
        t = len(track) // 2
        out[pid] = Point3D(
            pid, xyz, rgb, err,
            np.array([int(track[2 * k]) for k in range(t)], np.int32),
            np.array([int(track[2 * k + 1]) for k in range(t)], np.int32),
        )
    return out


def write_points3D_txt(points: dict[int, Point3D], path) -> None:
    with open(path, "w") as f:
        f.write(
            "# 3D point list: POINT3D_ID X Y Z R G B ERROR "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            tr = " ".join(
                f"{int(p.image_ids[k])} {int(p.point2D_idxs[k])}"
                for k in range(len(p.image_ids))
            )
            f.write(
                f"{p.id} {xyz} {rgb} {float(p.error)!r} {tr}\n".rstrip()
                + "\n"
            )


# ------------------------------------------------------------- model dir

def detect_model_format(model_dir: str) -> str:
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        return ".bin"
    if os.path.exists(os.path.join(model_dir, "cameras.txt")):
        return ".txt"
    raise FileNotFoundError(
        f"{model_dir}: neither cameras.bin nor cameras.txt"
    )


def read_model(model_dir: str, ext: str = "auto"):
    """(cameras, images, points3D) dicts from a model dir.

    ``ext``: ".bin", ".txt" or "auto". points3D is optional on disk
    (capture pipelines often prune it) — missing file reads as {}.
    """
    if ext == "auto":
        ext = detect_model_format(model_dir)
    rd = {
        ".bin": (read_cameras_bin, read_images_bin, read_points3D_bin),
        ".txt": (read_cameras_txt, read_images_txt, read_points3D_txt),
    }[ext]
    cams = rd[0](os.path.join(model_dir, "cameras" + ext))
    ims = rd[1](os.path.join(model_dir, "images" + ext))
    p3_path = os.path.join(model_dir, "points3D" + ext)
    pts = rd[2](p3_path) if os.path.exists(p3_path) else {}
    return cams, ims, pts


def write_model(cameras, images, points3D, model_dir: str,
                ext: str = ".bin") -> None:
    os.makedirs(model_dir, exist_ok=True)
    wr = {
        ".bin": (write_cameras_bin, write_images_bin, write_points3D_bin),
        ".txt": (write_cameras_txt, write_images_txt, write_points3D_txt),
    }[ext]
    wr[0](cameras, os.path.join(model_dir, "cameras" + ext))
    wr[1](images, os.path.join(model_dir, "images" + ext))
    wr[2](points3D, os.path.join(model_dir, "points3D" + ext))
