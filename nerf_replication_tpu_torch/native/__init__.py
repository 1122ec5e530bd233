"""The native (C++) host builders, bound by ctypes (port of
``nerf_replication_tpu/native/__init__.py``).

``raybank.cpp`` builds the training bank on the host: pinhole rays of every
pixel (``datasets/rays.get_rays_np``) and the RGBA frames composited onto
white, one thread per group of frames. ``jpeg_scan.cpp`` Huffman-decodes a
baseline JPEG scan into coefficient planes (``utils/image.decode_jpeg``).
Each library is compiled with ``g++`` at first use into
``<repo>/build/native/`` (git-ignored), keyed by its source's hash and the
interpreter, so a changed source is never loaded stale. A host without a
compiler takes the numpy ray-bank builder, as the JAX package does, and the
Python scan decoder: this is host data code, not a device kernel, and both
paths give the same results (``tests/test_torch_real.py`` holds the banks
bitwise, ``tests/test_torch_jpeg.py`` the coefficients).
:func:`native_available` says which path this process takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_LOCK = threading.Lock()
_LIBS: dict = {}  # library name -> CDLL, or None after a failed build

_P = ctypes.POINTER
# argtypes of each library's one entry point
_SIGNATURES = {
    "raybank": ("build_ray_bank", [
        _P(ctypes.c_float),   # poses
        _P(ctypes.c_uint8),   # images
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n,H,W,C
        ctypes.c_float,       # focal
        ctypes.c_int,         # n_threads
        _P(ctypes.c_float),   # rays_out
        _P(ctypes.c_float),   # rgbs_out
    ], None),
    "jpeg_scan": ("jpeg_decode_scan", [
        _P(ctypes.c_uint8),   # the intervals, each + 4 zero bytes
        _P(ctypes.c_int64),   # their starts (n_segs + 1)
        ctypes.c_int, ctypes.c_int,  # n_segs, MCUs an interval
        ctypes.c_int, ctypes.c_int,  # MCUs a row, a column
        ctypes.c_int,         # scan components
        _P(ctypes.c_uint16),  # DC tables [n, 65536]
        _P(ctypes.c_uint16),  # AC tables [n, 65536]
        _P(ctypes.c_int32),   # h, v, blocks a row [n, 3]
        _P(ctypes.c_void_p),  # coefficient planes [n]
    ], ctypes.c_int),
}


def _lib_path(name: str) -> str:
    # graftlint: ok(blocking-under-lock: hashes the source under the build lock — one build per source at a time)
    with open(os.path.join(_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    tag = f"cpy{sys.version_info.major}{sys.version_info.minor}-" \
          f"{platform.machine()}"
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}_{digest}.so")


def _compile(name: str, out: str) -> bool:
    """g++ ``<name>.cpp`` into ``out`` (atomically); False without g++ or
    on a failed build."""
    if shutil.which("g++") is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           os.path.join(_DIR, f"{name}.cpp"), "-o", tmp]
    try:
        # graftlint: ok(blocking-under-lock: the build lock is deliberate — one g++ build per source at a time)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib(name: str = "raybank") -> ctypes.CDLL | None:
    """The compiled library ``name``, built on first use; None without a
    compiler."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        out = _lib_path(name)
        lib = None
        if os.path.exists(out) or _compile(name, out):
            lib = ctypes.CDLL(out)
            fn_name, argtypes, restype = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[name] = lib
        return lib


def native_available(name: str = "raybank") -> bool:
    return get_lib(name) is not None


def build_ray_bank(poses: np.ndarray, images: np.ndarray, focal: float,
                   n_threads: int | None = None):
    """(rays [n·H·W, 6] float32, rgbs [n·H·W, 3] float32) from poses [n,
    4, 4] and uint8 frames [n, H, W, 3|4]: the C++ builder when it is
    available, the numpy one otherwise."""
    n, H, W, C = images.shape
    if C not in (3, 4):
        raise ValueError(
            f"build_ray_bank needs RGB or RGBA frames, got {C} channels"
        )
    lib = get_lib()
    if lib is None:
        return _build_ray_bank_numpy(poses, images, focal)
    poses_c = np.ascontiguousarray(poses, np.float32)
    images_c = np.ascontiguousarray(images, np.uint8)
    rays = np.empty((n * H * W, 6), np.float32)
    rgbs = np.empty((n * H * W, 3), np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.build_ray_bank(
        poses_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        images_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, H, W, C, float(focal), int(n_threads),
        rays.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgbs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return rays, rgbs


def _build_ray_bank_numpy(poses, images, focal):
    from ..datasets.rays import get_rays_np

    n, H, W, C = images.shape
    rays_list, rgb_list = [], []
    for f in range(n):
        rays_o, rays_d = get_rays_np(H, W, focal, poses[f])
        rays_list.append(
            np.concatenate([rays_o, rays_d], -1).reshape(-1, 6)
        )
        img = images[f].astype(np.float32) / 255.0
        if C == 4:
            img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        rgb_list.append(img[..., :3].reshape(-1, 3).astype(np.float32))
    return (
        np.concatenate(rays_list, 0).astype(np.float32),
        np.concatenate(rgb_list, 0),
    )


def decode_jpeg_scan(segs, comps, per_seg: int, mcus_x: int,
                     mcus_y: int) -> int | None:
    """Huffman-decode one baseline JPEG scan with ``jpeg_scan.cpp`` into
    its components' coefficient planes; None without a compiler, else the
    decoder's code (0 decoded, 1 a bad Huffman code, 2 data that ends
    early). ``segs``: the unstuffed restart intervals; ``comps``: per scan
    component ``(dc_lut, ac_lut, h, v, bw, coef)`` with uint16 [65536]
    tables and a zeroed int32 [blocks * 64] plane, written in place."""
    lib = get_lib("jpeg_scan")
    if lib is None:
        return None
    data = np.frombuffer(b"".join(s + b"\0\0\0\0" for s in segs), np.uint8)
    starts = np.zeros(len(segs) + 1, np.int64)
    starts[1:] = np.cumsum([len(s) + 4 for s in segs])
    dc = np.ascontiguousarray(np.stack([c[0] for c in comps]), np.uint16)
    ac = np.ascontiguousarray(np.stack([c[1] for c in comps]), np.uint16)
    geom = np.asarray([c[2:5] for c in comps], np.int32)
    planes = [c[5] for c in comps]
    for p in planes:
        assert p.dtype == np.int32 and p.flags.c_contiguous
    ptrs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
    return int(lib.jpeg_decode_scan(
        data.ctypes.data_as(_P(ctypes.c_uint8)),
        starts.ctypes.data_as(_P(ctypes.c_int64)), len(segs), int(per_seg),
        int(mcus_x), int(mcus_y), len(comps),
        dc.ctypes.data_as(_P(ctypes.c_uint16)),
        ac.ctypes.data_as(_P(ctypes.c_uint16)),
        geom.ctypes.data_as(_P(ctypes.c_int32)), ptrs))
